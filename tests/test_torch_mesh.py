"""The port's (dp, sp, tp) mesh against the JAX package: the tiny FLUX
forward of tests/test_partitioned.py at dp=2 sp=2 (a spawned gloo world of
4), in the default layout and the fused-RoPE one, against JAX's
``flux_forward``; the tiny ``Pipeline(mesh=make_mesh(dp=2, sp=2))`` against
the JAX ``Pipeline`` on a 4-device mesh of the virtual CPU mesh, with
``Offloading.Full`` against itself without it, and its img2img and inpaint
against the port's single-process pipeline; and the
mesh's own rules (world-size checks, ``grouped`` turned off).

Tensor parallelism runs in the same world of 4 (torch_mesh_workers.tp_rank):
the tiny forward at tp=2, dp=2 x tp=2 and sp=2 x tp=2; q8t and q8_0 forwards
whose row-parallel linears are K-cut or kept whole, against JAX's forward
with its kernels interpreted; T5 (nf4) at tp=2, unfused and fused;
``Pipeline(mesh=make_mesh(dp=2, tp=2))`` against the JAX mesh images; the
multi-host helpers.

The last two modules run in the same world too: the training dryrun's
step (diffusion_rs_tpu_torch/dryrun.train_step, torch_mesh_workers.
train_rank) at dp=2 x tp=2 and sp=2 x tp=2 against ``jax.value_and_grad``
of ``__graft_entry__.py``'s loss on one device, every leaf's gradient put
back whole; and ``FluxServer`` on ``Pipeline(mesh=...)`` at dp=2 x tp=2 and
dp=2 x sp=2 (torch_mesh_workers.serve_rank) against the JAX package's
offline images, with its dp-multiple buckets, its failed lanes and the
followers' refusal to take requests.
"""

import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu import DiffusionGenerationParams as JParams
from diffusion_rs_tpu import ModelSource as JSource
from diffusion_rs_tpu import Pipeline as JPipeline
from diffusion_rs_tpu.models import flux as jflux
from diffusion_rs_tpu.models import t5 as jt5
from diffusion_rs_tpu.ops import Linear as JLinear
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant.qtensor import quantize_q8_0, quantize_q8_tile
from diffusion_rs_tpu.parallel import make_mesh as j_make_mesh
from diffusion_rs_tpu.pipelines.sampling import get_noise as j_get_noise
from diffusion_rs_tpu.pipelines.sampling import make_img_ids, make_txt_ids
from diffusion_rs_tpu_torch.bridge import from_numpy_tree
from diffusion_rs_tpu_torch.parallel import make_mesh, spawn
from synth import FLUX_HIDDEN, write_checkpoint
from diffusion_rs_tpu_torch.models.flux import FluxConfig as TFluxConfig
from diffusion_rs_tpu_torch.models.t5 import T5Config as TT5Config
from diffusion_rs_tpu_torch.util.synthetic import init_flux_params, init_t5_params
from torch_mesh_workers import SERVE_PROMPTS, _digest, mesh_rank
from torch_port_util import quantize_tree, summed_rel, to_jax_tree, to_numpy_tree

# tests/test_partitioned.py's FLUX: 60 image + 4 text tokens
FLUX = dict(in_channels=16, pooled_projection_dim=32, joint_attention_dim=24,
            num_attention_heads=4, num_layers=1, num_single_layers=1,
            guidance_embeds=False, hidden_size=64, axes_dim=(8, 4, 4))
# tests/test_pipeline_e2e.py:35-47 and :409-415
GEN = dict(height=64, width=64, num_steps=2, guidance_scale=3.5, seed=42)
PROMPTS = ["a photo", "a dog"]
# Quantized tp forwards (dp=2 x tp=2). q8t at hidden 512: every row-parallel
# linear's K-slices hold whole 256-row K-tiles, so each is K-cut. q8_0 at
# hidden 96: proj (48 rows a rank) and linear2 (48 + 192) break 32-row
# groups and stay whole, the MLP's out (192 a rank) is K-cut.
FLUX_Q = {
    "flux_q8t": (dict(in_channels=16, pooled_projection_dim=32, joint_attention_dim=32,
                      num_attention_heads=4, num_layers=1, num_single_layers=1,
                      guidance_embeds=False, hidden_size=512, axes_dim=(32, 48, 48)),
                 quantize_q8_tile, lambda k: k % min(256, k) == 0),
    "flux_q8_0": (dict(in_channels=16, pooled_projection_dim=32, joint_attention_dim=32,
                       num_attention_heads=2, num_layers=1, num_single_layers=1,
                       guidance_embeds=False, hidden_size=96, axes_dim=(16, 16, 16)),
                  quantize_q8_0, lambda k: k % 32 == 0),
}
# T5 under tp=2 (nf4, tests/test_torch_encoders.py's tiny config): o (128
# rows a rank, split blocks of 256) stays whole, wo (256 a rank) is K-cut
T5_TP = dict(vocab_size=300, d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4)


def _quantized_flux(fcfg, quantize, k_ok):
    """JAX FLUX params (f32, from the port's seeded factory) with every
    Linear whose K the format takes quantized (stacked blocks per layer),
    the rest dense."""
    params = to_jax_tree(init_flux_params(0, TFluxConfig(**fcfg), torch.float32, device="cpu"))

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

    return jax.tree.map(leaf, params, is_leaf=lambda x: isinstance(x, JLinear))


def _tp_references(tmp, rng):
    """The quantized FLUX forwards and the nf4 T5 encode for the tp cases:
    the trees and inputs to ``tmp``, JAX's single-device outputs (Pallas
    kernels interpreted, as its tests run them) returned."""
    jattention = importlib.import_module("diffusion_rs_tpu.ops.attention")
    jlinear = importlib.import_module("diffusion_rs_tpu.ops.linear")

    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DIFFUSION_RS_TPU_QMM", "interpret")
        mp.setenv("DIFFUSION_RS_TPU_FLASH", "interpret")
        jlinear._qmm_mode.cache_clear()
        jattention._flash_mode.cache_clear()
        try:
            for stem, (fcfg, quantize, k_ok) in FLUX_Q.items():
                cfg = jflux.FluxConfig(**fcfg)
                params = _quantized_flux(fcfg, quantize, k_ok)
                b = 2
                inp = dict(img=rng.standard_normal((b, 32, 16)),
                           txt=rng.standard_normal((b, 8, 32)),
                           y=rng.standard_normal((b, 32)), t=np.full((b,), 0.5))
                inp = {k: v.astype(np.float32) for k, v in inp.items()}
                inp["img_ids"] = np.asarray(make_img_ids(b, 4, 8))
                inp["txt_ids"] = np.asarray(make_txt_ids(b, 8))
                refs[stem] = np.asarray(jax.jit(lambda p, i, c=cfg: jflux.flux_forward(
                    p, c, *i[:4], None, i[4], i[5]))(params, tuple(jnp.asarray(inp[k]) for k in (
                        "img", "txt", "t", "y", "txt_ids", "img_ids"))))
                with open(tmp / f"{stem}.pkl", "wb") as f:
                    pickle.dump({"cfg": fcfg, "params": to_numpy_tree(params)}, f)
                np.savez(tmp / f"{stem}_inputs.npz", **inp)
            cfg = jt5.T5Config(**T5_TP)
            t5 = quantize_tree(to_jax_tree(init_t5_params(1, TT5Config(**T5_TP), torch.float32,
                                                          device="cpu")),
                               lambda w: jbnb.quantize_nf4(np.ascontiguousarray(w.T),
                                                           blocksize=64), jnp.float32)
            ids = rng.integers(1, 300, (2, 24)).astype(np.int32)
            refs["t5"] = np.asarray(jax.jit(lambda p, i: jt5.t5_encode(p, cfg, i))(
                t5, jnp.asarray(ids)))
            with open(tmp / "t5.pkl", "wb") as f:
                pickle.dump({"cfg": T5_TP, "params": to_numpy_tree(t5), "ids": ids}, f)
        finally:
            jlinear._qmm_mode.cache_clear()
            jattention._flash_mode.cache_clear()
    return refs


def _flat_numpy_tree(tree, path=""):
    """(path, array) of every array of the bridge's plain form, paths as
    torch_mesh_workers._whole_grads writes them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k not in ("__type__", "lora"):
                yield from _flat_numpy_tree(v, f"{path}.{k}" if path else k)
    elif tree is not None:
        yield path, np.asarray(tree)


def _train_reference(tmp):
    """``jax.value_and_grad`` of __graft_entry__.py's ``loss_fn`` on one
    device: ``_tiny_cfg`` at 4 heads (JAX's rule for 4 devices: tp=2) with
    f32 params from PRNGKey(0) and the dryrun's JAX draws for a batch of 4.
    The params (bridge form) and the inputs go to ``tmp``; returns the loss
    and every leaf's gradient by path."""
    from __graft_entry__ import _tiny_cfg

    cfg = _tiny_cfg(heads=4)
    params = jflux.init_flux_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    b, txt_len, h2, w2 = 4, 16, 8, 8
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    inp = {"img": jax.random.normal(ks[0], (b, h2 * w2, cfg.in_channels), jnp.float32),
           "txt": jax.random.normal(ks[1], (b, txt_len, cfg.joint_attention_dim), jnp.float32),
           "y": jax.random.normal(ks[2], (b, cfg.pooled_projection_dim), jnp.float32),
           "t": jnp.full((b,), 0.7, jnp.float32), "guidance": jnp.full((b,), 3.5, jnp.float32),
           "txt_ids": make_txt_ids(b, txt_len), "img_ids": make_img_ids(b, h2, w2)}
    inp["target"] = jax.random.normal(jax.random.PRNGKey(7), inp["img"].shape, jnp.float32)
    pe = jflux.compute_pe(cfg, inp["txt_ids"], inp["img_ids"])

    def loss_fn(p):
        pred = jflux.flux_forward(p, cfg, inp["img"], inp["txt"], inp["t"], inp["y"],
                                  inp["guidance"], pe=pe)
        return jnp.mean((pred - inp["target"]) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    with open(tmp / "train.pkl", "wb") as f:
        pickle.dump({"heads": 4, "params": to_numpy_tree(params)}, f)
    np.savez(tmp / "train_inputs.npz", **{k: np.asarray(v) for k, v in inp.items()})
    return float(loss), dict(_flat_numpy_tree(to_numpy_tree(grads)))


SERVE_SEEDS = (1, 2, 3, 5, 99)


def _serve_reference(tmp, ckpt):
    """The JAX package's offline images of SERVE_PROMPTS (2 steps, seeds
    1-3) on the world's checkpoint, and its noise draws for the served
    seeds (to ``tmp/serve_noise.npz``)."""
    np.savez(tmp / "serve_noise.npz", **{
        str(s): np.asarray(j_get_noise(jax.random.PRNGKey(s), 1, 64, 64)) for s in SERVE_SEEDS})
    plain = JPipeline(JSource.from_model_id(str(ckpt)), silent=True)._inner
    return np.stack([plain.forward_arrays([p], JParams(height=64, width=64, num_steps=2,
                                                       guidance_scale=3.5, seed=i + 1))[0]
                     for i, p in enumerate(SERVE_PROMPTS)])


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """One spawned world of 4 for both comparisons: the tiny FLUX forward
    (JAX's single-device forward on params from the port's seeded factory,
    carried into the JAX tree and bridged back) and the tiny Pipeline (the
    JAX mesh Pipeline on the same checkpoint and noise)."""
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = jflux.FluxConfig(**FLUX)
    params = to_jax_tree(init_flux_params(0, TFluxConfig(**FLUX), torch.float32, device="cpu"))
    rng = np.random.default_rng(1)
    b = 2
    inp = dict(img=rng.standard_normal((b, 60, 16)), txt=rng.standard_normal((b, 4, 24)),
               y=rng.standard_normal((b, 32)), t=np.full((b,), 0.5))
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    inp["img_ids"] = np.asarray(make_img_ids(b, 6, 10))
    inp["txt_ids"] = np.asarray(make_txt_ids(b, 4))
    ref = np.asarray(jflux.flux_forward(params, cfg, *(jnp.asarray(inp[k]) for k in (
        "img", "txt", "t", "y")), None, jnp.asarray(inp["txt_ids"]), jnp.asarray(inp["img_ids"])))
    tree = to_numpy_tree(params)
    with open(tmp / "flux.pkl", "wb") as f:
        pickle.dump({"cfg": FLUX, "params": tree}, f)
    np.savez(tmp / "flux_inputs.npz", **inp)

    ckpt = write_checkpoint(tmp / "ckpt", seed=0, guidance=True, dynamic_shifting=True)
    mesh = j_make_mesh(dp=2, sp=2, tp=1, devices=jax.devices()[:4])
    jp = JPipeline(JSource.from_model_id(str(ckpt)), silent=True, mesh=mesh)
    images = np.stack([np.asarray(i) for i in jp.forward_images(PROMPTS, JParams(**GEN))])
    latents = jp.forward_latents(PROMPTS, JParams(**GEN))
    digest = _digest(from_numpy_tree(to_numpy_tree(jp._inner.flux_params), "cpu"))
    np.save(tmp / "noise.npy", np.asarray(j_get_noise(jax.random.PRNGKey(GEN["seed"]), 2,
                                                      GEN["height"], GEN["width"])))
    with open(tmp / "gen.pkl", "wb") as f:
        pickle.dump((GEN, PROMPTS), f)
    rng = np.random.default_rng(6)
    mask = np.zeros((8, 8), np.uint8)
    mask[1:5, 2:7] = 255
    np.savez(tmp / "i2i.npz", images=rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             mask=mask)
    tp_refs = _tp_references(tmp, np.random.default_rng(3))
    train_ref = _train_reference(tmp)
    serve_ref = _serve_reference(tmp, ckpt)

    spawn(mesh_rank, 4, "gloo", args=(str(tmp),))
    return {"flux": (ref, _digest(from_numpy_tree(tree, "cpu")),
                     [np.load(tmp / f"flux_{r}.npz") for r in range(4)]),
            "tp": ({"flux": ref, **tp_refs}, [np.load(tmp / f"tp_{r}.npz", allow_pickle=True)
                                               for r in range(4)]),
            "pipeline": (images, latents, digest,
                         [np.load(tmp / f"pipe_{r}.npz") for r in range(4)]),
            "img2img": (tmp, [np.load(tmp / f"i2i_{r}.npz") for r in range(4)]),
            "img2img_tp": [np.load(tmp / f"i2i_tp_{r}.npz") for r in range(4)],
            "train": (train_ref, [np.load(tmp / f"train_{r}.npz") for r in range(4)]),
            "serve": (serve_ref, [np.load(tmp / f"serve_{r}.npz") for r in range(4)])}


@pytest.fixture(scope="module")
def flux_run(mesh_run):
    """JAX's single-device forward and the port's world-4 run on the same
    params (bridged) and inputs (numpy seed)."""
    return mesh_run["flux"]


@pytest.mark.parametrize("layout", ["default", "fused_rope"])
def test_flux_forward_dp2_sp2_matches_jax(flux_run, layout):
    """Each rank's image rows of the forward, gathered over sp and dp, equal
    JAX's single-device forward within rtol/atol 2e-4 on every rank; the
    joint attention of each block ran as a ring (1 double + 1 single block),
    including under the fused-RoPE layout (RoPE outside, then the ring)."""
    ref, _, ranks = flux_run
    for r in ranks:
        np.testing.assert_allclose(r[layout], ref, rtol=2e-4, atol=2e-4)
        assert int(r[f"{layout}_rings"]) == 2


def test_replicated_params_equal_bridged(flux_run):
    """Every rank holds the whole bridged tree (no tp): its checksum equals
    the bridged tree's in the parent."""
    _, digest, ranks = flux_run
    assert all(np.array_equal(r["digest"], digest) for r in ranks)


@pytest.fixture(scope="module")
def pipeline_run(mesh_run):
    """The JAX mesh Pipeline and the port's world-4 Pipeline on the same
    tiny checkpoint and noise."""
    return mesh_run["pipeline"]


def test_pipeline_dp2_sp2_matches_jax_mesh(pipeline_run):
    """Images within tests/test_pipeline_e2e.py's cross-mesh bands (u8 mean
    < 1, max <= 16), latents within rtol/atol 0.05; every rank returns the
    same images; each rank ran its 2 steps x 4 blocks through the ring and
    never fell back; every rank's weights equal the JAX loader's."""
    images, latents, digest, ranks = pipeline_run
    for r in ranks:
        np.testing.assert_array_equal(r["images"], ranks[0]["images"])
        d = np.abs(r["images"].astype(np.float32) - images.astype(np.float32))
        assert d.mean() < 1.0 and d.max() <= 16, (d.mean(), d.max())
        np.testing.assert_allclose(r["latents"], latents, rtol=0.05, atol=0.05)
        assert int(r["rings"]) == 2 * 4 and not bool(r["fallback"])
        assert np.array_equal(r["digest"], digest)


def test_full_offload_under_mesh_equals_resident(pipeline_run):
    """``Offloading.Full`` under the same dp2 x sp2 mesh: every rank's images
    equal the resident mesh pipeline's bit for bit, with every component
    managed by the registry and released after the call."""
    for r in pipeline_run[3]:
        np.testing.assert_array_equal(r["full_images"], r["images"])
        assert bool(r["full_released"])


def test_grouped_turns_off_under_mesh(pipeline_run):
    """``fuse="grouped"`` under a mesh runs the per-stream calls, with the
    JAX loader's warning: no grouped config, no fused img/txt projections."""
    for r in pipeline_run[3]:
        assert not bool(r["grouped_qmm"]) and not bool(r["grouped_fused"])
        assert bool(r["grouped_warned"])


@pytest.fixture(scope="module")
def i2i_single_process(mesh_run):
    """The port's single-process img2img (strength 0.5) and inpaint (0.75)
    latents on the world's checkpoint, init images, mask and noise."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams as TParams
    from diffusion_rs_tpu_torch.pipelines import flux_pipeline
    from diffusion_rs_tpu_torch.pipelines.api import ModelSource, Pipeline

    tmp, _ = mesh_run["img2img"]
    noise = torch.from_numpy(np.load(tmp / "noise.npy"))
    inp = np.load(tmp / "i2i.npz")
    pipe = Pipeline(ModelSource.from_model_id(str(tmp / "ckpt")), silent=True, device="cpu")
    images, params = list(inp["images"]), TParams(**GEN)
    get_noise = flux_pipeline.get_noise
    flux_pipeline.get_noise = lambda seed, n, h, w, device: noise.clone()
    try:
        return {"img2img": pipe._inner.forward_arrays(PROMPTS, params, init_image=images,
                                                      strength=0.5, output_type="latent"),
                "inpaint": pipe._inner.forward_arrays(PROMPTS, params, init_image=images,
                                                      strength=0.75, mask_image=inp["mask"],
                                                      output_type="latent")}
    finally:
        flux_pipeline.get_noise = get_noise


def test_img2img_inpaint_dp2_sp2_match_single_process(mesh_run, i2i_single_process):
    """img2img (strength 0.5) and inpaint (0.75) under dp=2 sp=2: each rank
    prepares and encodes its dp row, keeps its rows of the whole batch's
    encoder sample, and cuts the inpaint planes to its sp rows as it cuts the
    image tokens; every rank's latents equal the port's single-process ones
    within the mesh pipeline's band (rtol/atol 0.05; measured max-abs 1.9e-2
    and 2.2e-2 on latents up to 4.9: bf16, the ring's merges), the same on
    every rank."""
    _, ranks = mesh_run["img2img"]
    for r in ranks:
        for mode, lat in i2i_single_process.items():
            np.testing.assert_array_equal(r[mode], ranks[0][mode])
            np.testing.assert_allclose(r[mode], lat, rtol=0.05, atol=0.05)


def test_img2img_inpaint_dp2_tp2_match_single_process(mesh_run, i2i_single_process):
    """img2img (strength 0.5) and inpaint (0.75) under dp=2 x tp=2, each
    rank holding its cut of FLUX and T5: every rank's latents equal the
    port's single-process ones within the dp2 x sp2 case's band (rtol/atol
    0.05), the same on every rank."""
    ranks = mesh_run["img2img_tp"]
    for r in ranks:
        for mode, lat in i2i_single_process.items():
            np.testing.assert_array_equal(r[mode], ranks[0][mode])
            np.testing.assert_allclose(r[mode], lat, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("dp,sp,tp", [(2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 1, 2)],
                         ids=["2-1", "1-2", "2-2", "tp2"])
def test_make_mesh_world_mismatch_raises(dp, sp, tp):
    """dp * sp * tp must be the world size (one here: no process group)."""
    with pytest.raises(ValueError, match=r"world_size\(1\)"):
        make_mesh(dp=dp, sp=sp, tp=tp, device="cpu")


def test_world_of_one_mesh():
    """Without a process group: a 1x1x1 mesh, no groups, the given device."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1} and mesh.coords == {"dp": 0, "sp": 0, "tp": 0}
    assert mesh.groups == {"dp": None, "sp": None, "tp": None}
    assert mesh.device == torch.device("cpu")


# -- tensor parallelism, in the same world of 4 ---------------------------------------


@pytest.fixture(scope="module")
def tp_run(mesh_run):
    """JAX's single-device outputs and every rank's tp_rank record."""
    return mesh_run["tp"]


@pytest.mark.parametrize("case", ["tp2", "tp2_fused", "dp2_tp2", "sp2_tp2"])
def test_flux_forward_tp_matches_jax(tp_run, case):
    """The tiny forward with the params cut over tp=2 (heads and MLP columns
    per rank, one f32 all-reduce per row-parallel linear), alone (every rank
    the whole batch), with the fused qkv / qkv_mlp projections cut segment
    by segment, with dp=2 and with sp=2 (the ring on each rank's heads):
    every rank's gathered output equals JAX's single-device forward within
    rtol/atol 2e-4."""
    refs, ranks = tp_run
    for r in ranks:
        np.testing.assert_allclose(r[case], refs["flux"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("stem", ["flux_q8t", "flux_q8_0"])
def test_quantized_flux_tp_matches_jax(tp_run, stem):
    """q8t (hidden 512) and q8_0 (hidden 96) forwards at dp=2 x tp=2 against
    JAX's single-device forward with its kernels interpreted, within the
    q8t band 0.02 summed-rel. q8t's row-parallel linears hold their K-slice
    (256 rows of proj, 1024 of the MLP's out, 256 + 1024 of linear2), as
    tests/test_parallel.py asserts of JAX's; q8_0's proj and linear2 stay
    whole (their slices would cut 32-row groups) and gather their input,
    its MLP out is K-cut."""
    refs, ranks = tp_run
    want = {"flux_q8t": {"proj": (1, 256), "mlp_out": (1, 1024), "linear2": (1, 1280)},
            "flux_q8_0": {"proj": (0, 96), "mlp_out": (1, 192), "linear2": (0, 480)}}[stem]
    for r in ranks:
        assert summed_rel(r[stem], refs[stem]) <= 0.02
        assert {str(n): (int(s), int(k)) for n, s, k in r[f"{stem}_cuts"]} == want


@pytest.mark.parametrize("case", ["t5", "t5_fused"])
def test_t5_encode_tp_matches_jax(tp_run, case):
    """T5 with nf4 linears at tp=2 (each rank its heads and their columns of
    the position bias; ``o`` kept whole and ``wo`` K-cut; fused: ``qkv`` cut
    segment by segment and ``wi01`` whole) within tests/test_torch_encoders.py's
    1e-5 summed-rel of JAX's interpreted encode."""
    refs, ranks = tp_run
    for r in ranks:
        assert summed_rel(r[case], refs["t5"]) <= 1e-5


def test_pipeline_dp2_tp2_matches_jax_mesh(pipeline_run):
    """``Pipeline(mesh=make_mesh(dp=2, tp=2))``: each rank holds half of
    every q/k/v projection's columns, and its images and latents are within
    the dp2 x sp2 case's bands of the JAX mesh Pipeline's (same checkpoint
    and noise), the same on every rank."""
    images, latents, _, ranks = pipeline_run
    for r in ranks:
        np.testing.assert_array_equal(r["tp_images"], ranks[0]["tp_images"])
        d = np.abs(r["tp_images"].astype(np.float32) - images.astype(np.float32))
        assert d.mean() < 1.0 and d.max() <= 16, (d.mean(), d.max())
        np.testing.assert_allclose(r["tp_latents"], latents, rtol=0.05, atol=0.05)
        assert tuple(r["tp_cut"])[-2:] == (FLUX_HIDDEN, FLUX_HIDDEN // 2)


def test_full_offload_under_tp_mesh_equals_resident(pipeline_run):
    """``Offloading.Full`` under dp=2 x tp=2: the registry holds each rank's
    own slices (half of q's columns) and the images equal the resident tp
    pipeline's bit for bit."""
    for r in pipeline_run[3]:
        np.testing.assert_array_equal(r["tp_full_images"], r["tp_images"])
        assert tuple(r["tp_full_cut"])[-2:] == (FLUX_HIDDEN, FLUX_HIDDEN // 2)


def test_multislice_mesh_and_local_batch(tp_run):
    """``make_multislice_mesh(sp=1, tp=2)`` in a world of 4 infers dp=2 (dp
    the major axis: ranks 0-1 at dp 0); ``local_batch_to_global`` of each
    rank's rows of tests/test_multihost.py's batch, summed over dp, gives
    its total 8 on every rank."""
    _, ranks = tp_run
    for rank, r in enumerate(ranks):
        assert r["multislice_shape"].tolist() == [2, 1, 2] and int(r["world"]) == 4
        assert r["coords"].tolist() == [rank // 2, 0, rank % 2]
        assert float(r["global_sum"][0]) == 8.0


# -- the training dryrun's step and the server on a mesh, in the same world ----------


@pytest.mark.parametrize("mesh", ["dp2_tp2", "sp2_tp2"])
def test_train_step_matches_jax_value_and_grad(mesh_run, mesh):
    """dryrun.train_step at dp=2 x tp=2 (JAX's rule for 4 devices) and at
    sp=2 x tp=2 against JAX's value_and_grad on one device: the loss within
    1e-5 relative and every leaf's gradient (66 leaves; tp-cut ones gathered
    whole) within 1e-3 summed-rel, on every rank. The backward runs through
    the differentiable collectives: column inputs sum their gradient over
    tp, the row all-reduce passes it back, the QK-norm scales sum theirs over
    tp, the sp XLA path's k/v gather sums over sp and keeps the rank's rows."""
    (loss, grads), ranks = mesh_run["train"]
    for r in ranks:
        assert abs(float(r[f"{mesh}_loss"]) / loss - 1.0) <= 1e-5
        got = {k.split(":", 1)[1] for k in r.files if k.startswith(f"{mesh}:")}
        assert got == set(grads) and len(grads) == 66
        worst = max(summed_rel(r[f"{mesh}:{k}"], g) for k, g in grads.items())
        assert worst <= 1e-3, worst


@pytest.mark.parametrize("mesh", ["dp2_tp2", "dp2_sp2"])
def test_server_on_mesh_matches_jax_offline(mesh_run, mesh):
    """``FluxServer(max_batch=4)`` on ``Pipeline(mesh=...)``, as JAX's
    tests/test_serving.py::test_server_dp_mesh_sharded (three prompts, 2
    steps, seeds 1-3): each served image, and "a cat" served alone
    afterwards, within JAX's band (u8 mean < 1, max <= 16) of the JAX
    package's offline image for the same seed."""
    refs, ranks = mesh_run["serve"]
    images = ranks[0][f"{mesh}_images"]
    for got, want in [*zip(images, refs), (ranks[0][f"{mesh}_alone"], refs[0])]:
        d = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert d.mean() < 1.0 and d.max() <= 16, (d.mean(), d.max())


@pytest.mark.parametrize("mesh", ["dp2_tp2", "dp2_sp2"])
def test_server_on_mesh_buckets_and_failures(mesh_run, mesh):
    """Buckets start at dp and double: the three lanes step twice at bucket
    4 (one padding lane) and the lone one twice at bucket 2 (one). A prompt
    longer than its T5 length fails its lane on every rank, a request whose
    noise fails on the followers only fails on the leader with the first
    failing rank's message; the server goes on (the lone request after them
    completes) and no rank hangs (each rank's watchdog is 120 s). A
    follower's ``submit`` raises."""
    _, ranks = mesh_run["serve"]
    forwards, lane_steps, padded, completed, failed = ranks[0][f"{mesh}_stats"].tolist()
    assert (forwards, lane_steps, padded, completed, failed) == (4, 8, 4, 4, 2)
    long_prompt, follower = (str(e) for e in ranks[0][f"{mesh}_errors"])
    assert "T5 embedding length" in long_prompt
    assert follower == "RuntimeError: rank 1 failed: RuntimeError: injected noise failure"
    for r in ranks[1:]:
        assert "rank 0 only" in str(r[f"{mesh}_refused"])
