"""The port's tensor-parallel cut (diffusion_rs_tpu_torch/parallel/sharding.py)
against the JAX package's ``shard_params`` on the virtual CPU mesh, in one
process: every rank's planes of every unfused leaf equal the JAX
``addressable_shards`` of that rank's device bit for bit; fused leaves
(``qkv``, ``qkv_mlp``, ``linear2``) are cut segment by segment and their
ranks' planes, put back in segment order, are the whole planes; the JAX
tests of tests/test_parallel.py mirrored one for one; the row-parallel
product's per-rank partials (quantized, LoRA, segment-cut ``linear2``)
summed give the whole linear; the capacity check's tp; the refusals; the
multi-host helpers in a world of one. The multi-rank forwards are in
tests/test_torch_mesh.py's world of 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.ops import Linear as JLinear
from diffusion_rs_tpu.parallel import make_mesh as j_make_mesh
from diffusion_rs_tpu.parallel import shard_params as j_shard_params
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant.qtensor import quantize_q8_0, quantize_q8_tile
from diffusion_rs_tpu.util import capacity as jcap
from diffusion_rs_tpu_torch.bridge import from_numpy_tree
from diffusion_rs_tpu_torch.models.flux import FluxConfig as TFluxConfig
from diffusion_rs_tpu_torch.models.optimize import fuse_flux_qkv, fuse_t5
from diffusion_rs_tpu_torch.models.t5 import T5Config as TT5Config
from diffusion_rs_tpu_torch.ops.linear import Linear, linear
from diffusion_rs_tpu_torch.ops.partitioned import row_parallel_linear
from diffusion_rs_tpu_torch.parallel import (local_batch_to_global, make_multislice_mesh,
                                             shard_params)
from diffusion_rs_tpu_torch.parallel.mesh import AXES, Mesh
from diffusion_rs_tpu_torch.parallel.sharding import shard_flux_t5
from diffusion_rs_tpu_torch.quant.qtensor import QuantizedTensor
from diffusion_rs_tpu_torch.util import capacity as tcap
from diffusion_rs_tpu_torch.util.synthetic import init_flux_params, init_t5_params
from torch_port_util import quantize_tree, to_jax_tree, to_numpy_tree

# tests/test_parallel.py's FLUX (heads divisible by tp 4)
FLUX = dict(in_channels=16, pooled_projection_dim=32, joint_attention_dim=24,
            num_attention_heads=4, num_layers=2, num_single_layers=2,
            guidance_embeds=False, hidden_size=64, axes_dim=(8, 4, 4))
# hidden 512: q8t's K-tiles of 256 rows split at tp 2
FLUX_Q8T = dict(FLUX, hidden_size=512, axes_dim=(32, 48, 48), num_layers=1,
                num_single_layers=1)
T5 = dict(vocab_size=300, d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4)
FUSED = ("qkv", "qkv_mlp", "linear2")


def _rank_mesh(tp: int, rank: int, dp: int = 1) -> Mesh:
    """Rank ``rank``'s view of a (dp, 1, tp) mesh without process groups:
    enough for shard_params, which reads only the coordinates."""
    return Mesh(shape={"dp": dp, "sp": 1, "tp": tp}, coords={"dp": 0, "sp": 0, "tp": rank},
                groups=dict.fromkeys(AXES), device=torch.device("cpu"))


def _quantize_linears(tree, quantize, k_ok):
    def leaf(lin):
        if not isinstance(lin, JLinear):
            return lin
        w = np.asarray(lin.w, np.float32)
        if not k_ok(w.shape[-2]):
            return lin
        if w.ndim == 2:
            return JLinear(w=quantize(w), b=lin.b)
        qts = [quantize(w[i]) for i in range(w.shape[0])]
        return JLinear(w=jax.tree.map(lambda *xs: jnp.stack(xs), *qts), b=lin.b)

    return jax.tree.map(leaf, tree, is_leaf=lambda x: isinstance(x, JLinear))


def _nf4(w):
    return jbnb.quantize_nf4(np.ascontiguousarray(w.T), blocksize=64)


def _jax_tree(kind: str):
    """The JAX trees the plane tests cut, from the port's seeded factories."""
    if kind == "t5_nf4":
        return quantize_tree(to_jax_tree(init_t5_params(1, TT5Config(**T5), torch.float32,
                                                        device="cpu")), _nf4, jnp.float32)
    cfg = FLUX_Q8T if kind == "flux_q8t" else FLUX
    tree = to_jax_tree(init_flux_params(0, TFluxConfig(**cfg), torch.float32, device="cpu"))
    if kind == "flux_q8t":
        return _quantize_linears(tree, quantize_q8_tile, lambda k: k % min(256, k) == 0)
    if kind == "flux_q8_0":
        return _quantize_linears(tree, quantize_q8_0, lambda k: k % 32 == 0)
    return tree


def _paths(tree, path=""):
    """(dotted path, tensor) of every tensor of a port tree, in tree_leaves'
    order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, QuantizedTensor):
        items = [(f, getattr(tree, f)) for f in ("packed", "scale", "bias", "codebook")]
    elif isinstance(tree, Linear):
        items = [("w", tree.w), ("b", tree.b), ("lora", tree.lora)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        items = list(enumerate(tree))
    return [p for k, v in items for p in _paths(v, f"{path}.{k}" if path else str(k))]


@pytest.mark.parametrize("kind", ["flux_dense", "flux_q8_0", "flux_q8t", "t5_nf4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_unfused_planes_equal_jax_shards(kind, tp):
    """Every rank's planes of every leaf that is not segment-cut equal the
    JAX ``shard_params`` shard on the device of that tp index (dp=1 mesh of
    the virtual CPU devices), bit for bit: columns for the column keys, K
    rows (or the whole weight, where the K-slices would cut a group) for
    the row keys, whole leaves elsewhere."""
    jtree = _jax_tree(kind)
    jmesh = j_make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
    sharded = j_shard_params(jtree, jmesh)
    whole = from_numpy_tree(to_numpy_tree(jtree), "cpu")
    devices = list(jmesh.devices.flat)
    for rank in range(tp):
        def shard(a, dev=devices[rank]):
            return {s.device: np.asarray(s.data) for s in a.addressable_shards}[dev]

        # jax.tree.map rebuilds dicts in sorted key order: match by path
        want = dict(_paths(from_numpy_tree(to_numpy_tree(jax.tree.map(shard, sharded)), "cpu")))
        got = dict(_paths(shard_params(whole, _rank_mesh(tp, rank))))
        assert sorted(got) == sorted(want)
        compared = 0
        for path, g in got.items():
            if any(f".{k}." in f".{path}." for k in FUSED):
                continue
            assert g.dtype == want[path].dtype and torch.equal(g, want[path]), path
            compared += 1
        assert compared > 0


@pytest.mark.parametrize("kind", ["flux_dense", "flux_q8t", "t5_nf4"])
def test_fused_planes_concatenate_to_whole(kind):
    """The segment-cut leaves (a double block's fused ``qkv``, a single
    block's ``qkv_mlp`` and ``linear2``, T5's fused ``qkv``): each rank holds
    its share of every segment, and the ranks' shares put back in segment
    order are the whole planes, bit for bit."""
    tp = 2
    whole = from_numpy_tree(to_numpy_tree(_jax_tree(kind)), "cpu")
    if kind == "t5_nf4":
        whole = fuse_t5(whole)
    else:
        whole = fuse_flux_qkv(whole, ("img", "txt", "single"))
    ranks = [shard_params(whole, _rank_mesh(tp, r)) for r in range(tp)]
    checked = 0
    for (path, t), *parts in zip(_paths(whole), *(_paths(r) for r in ranks)):
        key = next((k for k in FUSED if f".{k}." in f".{path}."), None)
        if key is None or path.endswith("codebook"):
            continue
        lin = ranks[0]
        for name in path.split(".")[:-1]:
            lin = lin[name] if isinstance(lin, dict) else getattr(lin, name)
            if isinstance(lin, Linear):
                break
        cut = lin.tp
        col = cut.role == "col"
        if not col and (not cut.sharded or path.endswith(".b")):
            assert all(torch.equal(p, t) for _, p in parts), path
            continue
        dim = -1 if col else -2
        whole_k = sum(cut.segments)
        div = whole_k // t.shape[dim]  # packed 4-bit rows, scale groups
        local = [n // div // tp for n in cut.segments]
        pieces = [torch.split(p, local, dim=dim) for _, p in parts]
        rebuilt = torch.cat([pieces[r][i] for i in range(len(local)) for r in range(tp)], dim=dim)
        assert torch.equal(rebuilt, t), path
        checked += 1
    assert checked > 0


def test_column_row_cuts():
    """tests/test_parallel.py::test_column_row_specs: at tp=8 the q weight
    holds its rank's output columns, proj its input rows, q_norm is whole."""
    whole = from_numpy_tree(to_numpy_tree(_jax_tree("flux_dense")), "cpu")
    local = shard_params(whole, _rank_mesh(8, 3))
    q, proj = local["double"]["img_attn"]["q"], local["double"]["img_attn"]["proj"]
    assert q.tp.role == "col" and q.w.shape[-1] == 64 // 8 and q.w.shape[-2] == 64
    assert proj.tp.role == "row" and proj.tp.sharded and proj.w.shape[-2:] == (64 // 8, 64)
    assert local["double"]["img_attn"]["q_norm"] is whole["double"]["img_attn"]["q_norm"]


def test_quantized_params_cut():
    """tests/test_parallel.py::test_quantized_params_shard: q8_0 planes cut
    along N for a column key and along K for a row key (2048 / 8 = 256 rows
    a rank, whole 32-row groups)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    wr = rng.standard_normal((2048, 128)).astype(np.float32)
    tree = from_numpy_tree(to_numpy_tree({"double": {"img_attn": {
        "q": JLinear(w=quantize_q8_0(w), b=None),
        "proj": JLinear(w=quantize_q8_0(wr), b=None)}}}), "cpu")
    local = shard_params(tree, _rank_mesh(8, 5))["double"]["img_attn"]
    qt = local["q"].w
    assert qt.packed.shape == (256, 16) and qt.scale.shape == (8, 16) and qt.shape == (256, 16)
    rt = local["proj"].w
    assert rt.packed.shape == (2048 // 8, 128) and rt.scale.shape == (8, 128)
    assert torch.equal(rt.packed, tree["double"]["img_attn"]["proj"].w.packed[5 * 256:6 * 256])


def test_quantized_row_parallel_unshardable_stays_whole():
    """tests/test_parallel.py::test_quantized_row_parallel_unshardable_replicates:
    96 rows over tp=8 cut 32-row groups, so the weight stays whole."""
    w = np.random.default_rng(0).standard_normal((96, 128)).astype(np.float32)
    tree = from_numpy_tree(to_numpy_tree(
        {"single": {"linear2": JLinear(w=quantize_q8_0(w), b=None)}}), "cpu")
    lin = shard_params(tree, _rank_mesh(8, 1))["single"]["linear2"]
    assert not lin.tp.sharded and lin.w is tree["single"]["linear2"].w


@pytest.mark.parametrize("kind", ["dense", "q8t", "nf4"])
def test_row_parallel_partials_sum_to_whole(kind):
    """A single block's ``linear2`` (rows attn | mlp, cut segment by segment)
    with a bias and a LoRA term: each rank's partial (row_parallel_linear
    without a group: no all-reduce) on its own input features, summed over
    the ranks, is the whole linear (f32 activations; quantized kernels'
    plain versions on the CPU), and the LoRA term and the bias count once."""
    tp, h, mlp, n_rows = 2, 512, 2048, 6
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((h + mlp, h), generator=gen) * 0.02
    if kind == "dense":
        wq = w
    else:
        jw = quantize_q8_tile(w.numpy()) if kind == "q8t" else _nf4(w.numpy())
        wq = from_numpy_tree(to_numpy_tree({"l": JLinear(w=jw, b=None)}), "cpu")["l"].w
    lora = (torch.randn((h + mlp, 4), generator=gen) * 0.1, torch.randn((4, h), generator=gen))
    b = torch.randn(h, generator=gen)
    whole = {"single": {"linear2": Linear(w=wq, b=b, lora=lora)}}
    x = torch.randn((n_rows, h + mlp), generator=gen)
    ref = linear(x, whole["single"]["linear2"])
    total = torch.zeros_like(ref)
    for r in range(tp):
        lin = shard_params(whole, _rank_mesh(tp, r))["single"]["linear2"]
        assert lin.tp.sharded and lin.w.shape[-2] == (h + mlp) // tp
        part = row_parallel_linear(lin.tp.local_features(x), Linear(w=lin.w, lora=lin.lora,
                                                                    tp=lin.tp))
        total += part
    torch.testing.assert_close(total + b, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["flux_q8t", "t5_nf4"])
def test_whole_tree_bytes_from_a_rank(kind):
    """The capacity check counts the whole tree's bytes from any rank's cut
    tree (util/capacity.whole_tree_bytes), as JAX counts the whole tree."""
    jtree = _jax_tree(kind)
    whole = from_numpy_tree(to_numpy_tree(jtree), "cpu")
    assert tcap.whole_tree_bytes(whole) == jcap.tree_device_bytes(jtree)
    for r in range(2):
        local = shard_params(whole, _rank_mesh(2, r))
        assert tcap.whole_tree_bytes(local) == jcap.tree_device_bytes(jtree)
        assert tcap.tree_device_bytes(local) < tcap.tree_device_bytes(whole)


@pytest.mark.parametrize("budget", ["weights/2", "weights/2+act/2", "weights+act*2"])
def test_denoise_capacity_tp_decides_like_jax(monkeypatch, budget):
    """With DIFFUSION_RS_TPU_HBM_BYTES set, the check at tp=2 on a rank's
    cut tree raises, warns or passes as JAX's check at tp=2 on the whole
    tree (weights / tp)."""
    jtree = _jax_tree("flux_q8t")
    local = shard_params(from_numpy_tree(to_numpy_tree(jtree), "cpu"), _rank_mesh(2, 0))
    w = jcap.tree_device_bytes(jtree) // 2
    act = jcap.estimate_denoise_activation_bytes(1, 64, 16, 512)
    hbm = {"weights/2": w // 2, "weights/2+act/2": w + act // 2,
           "weights+act*2": w + 2 * act}[budget]
    monkeypatch.setenv("DIFFUSION_RS_TPU_HBM_BYTES", str(hbm))
    kw = dict(batch=1, img_tokens=64, txt_tokens=16, hidden=512, tp=2)
    if budget == "weights/2":
        for check in (lambda: jcap.check_denoise_capacity(jtree, **kw),
                      lambda: tcap.check_denoise_capacity(local, device="cpu", **kw)):
            with pytest.raises(ValueError, match="cannot fit"):
                check()
    else:
        j_msg = jcap.check_denoise_capacity(jtree, **kw)
        t_msg = tcap.check_denoise_capacity(local, device="cpu", **kw)
        assert (j_msg is None) == (t_msg is None) == (budget == "weights+act*2")
        assert t_msg is None or "(tp=2)" in t_msg


@pytest.mark.parametrize("which", ["flux_heads", "t5_heads", "t5_d_ff"])
def test_tp_not_dividing_raises(which):
    """A tp that does not divide FLUX's heads or T5's heads or d_ff raises
    ValueError naming the dimension (JAX's GSPMD would pad it): a head count
    before any cut, a width at the leaf whose features it cuts."""
    flux = TFluxConfig(**dict(FLUX, num_attention_heads=3, hidden_size=48,
                              axes_dim=(8, 4, 4))) if which == "flux_heads" else TFluxConfig()
    t5 = TT5Config(**dict(T5, num_heads=6)) if which == "t5_heads" else (
        TT5Config(**dict(T5, d_ff=510)) if which == "t5_d_ff" else TT5Config())
    t5_tree = init_t5_params(1, t5, torch.float32, "cpu") if which == "t5_d_ff" else None
    name = {"flux_heads": "FLUX num_attention_heads = 3", "t5_heads": "T5 num_heads = 6",
            "t5_d_ff": "ff/wi_0: output features \\[510\\]"}[which]
    with pytest.raises(ValueError, match=name + " .*not divisible by tp=4"):
        shard_flux_t5(None, flux, t5_tree, t5, _rank_mesh(4, 0))
    # FLUX.1 and T5-XXL divide 2, 4, 8
    assert shard_flux_t5(None, TFluxConfig(), None, TT5Config(), _rank_mesh(8, 0)) == (None, None)


def test_multihost_helpers_in_a_world_of_one():
    """Without a process group: dp inferred as 1, a world that sp * tp does
    not divide refused; the local batch lands on the mesh's device."""
    mesh = make_multislice_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1}
    with pytest.raises(ValueError, match="not divisible by sp\\*tp=2"):
        make_multislice_mesh(tp=2, device="cpu")
    g = local_batch_to_global(np.ones((2, 3), np.float32), mesh)
    assert isinstance(g, torch.Tensor) and g.shape == (2, 3) and g.device == mesh.device
    with pytest.raises(ValueError, match="outside the mesh"):
        local_batch_to_global(np.ones(2), mesh, ("rows",))

