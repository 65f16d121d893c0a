"""Ring attention of the port (ops/partitioned.py) in spawned gloo worlds of
2 and 4 processes, against the JAX package's ring on the virtual CPU mesh
and its single-chip kernel (Pallas in interpret mode), at B2 H2 S512 D128 as
tests/test_partitioned.py runs it.

Under the int8 QK^T mode JAX's ring merges chunk log-sum-exps taken over
k centred by each chunk's own mean; when the chunks' means differ along a
direction q shares, its chunks are weighted wrongly. The port adds each
chunk's shift back; on such an input the port's ring equals JAX's
single-chip s8 attention within the int8 band and JAX's own ring does not.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from diffusion_rs_tpu.ops import flash_pallas as jfp
from diffusion_rs_tpu.ops.attention import sdpa_xla
from diffusion_rs_tpu_torch.parallel import spawn
from torch_mesh_workers import ring_rank
from torch_port_util import summed_rel

B, H, S, D = 2, 2, 512, 128
INT8_BAND = 2e-2  # tests/test_ops.py:387
# bf16 mode on f32 inputs: the same online softmax per chunk and JAX's f32
# merge; only summation orders differ (tests/test_partitioned.py's band)
RING_ATOL = 2e-4
UNEVEN = [300, 212]


def _inputs(seed: int, sp: int):
    """``normal``: as tests/test_partitioned.py (v offset by 2). ``offset``:
    q leans along channel 0 and k's chunk c (of the sp-way split) is shifted
    along it by 2c - 2, so the chunks' k means differ where q looks."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))
    out = {"normal_q": q, "normal_k": k, "normal_v": v + 2.0}
    qo, ko = q.copy(), k.copy()
    qo[..., 0] += 3.0
    c = S // sp
    for i in range(sp):
        ko[:, :, i * c:(i + 1) * c, 0] += 2.0 * i - 2.0
    out.update(offset_q=qo, offset_k=ko, offset_v=v)
    return out


def _port(tmp, world, worlds):
    """Spawn one world of ``world`` ranks over every ``(stem, cases, runs,
    lens)`` of ``worlds``; returns each stem's gathered outputs."""
    for stem, cases, runs, lens in worlds:
        extra = {} if lens is None else {"lens": np.array(lens)}
        np.savez(tmp / f"{stem}.npz", runs=np.array(runs), **cases, **extra)
    spawn(ring_rank, world, "gloo", args=(str(tmp), [w[0] for w in worlds]))
    outs = {}
    for stem, _, runs, _ in worlds:
        parts = [np.load(tmp / f"ring_{stem}_{r}.npz") for r in range(world)]
        out = {run: np.concatenate([p[run] for p in parts], axis=1) for run in runs}
        out["warned"] = [bool(p["warned"]) for p in parts]
        outs[stem] = out
    return outs


def _heads(o):
    """[B, S, H*D] -> [B, H, S, D]."""
    return o.reshape(B, S, H, D).transpose(0, 2, 1, 3)


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """The port's rings at sp 2 and 4 over every run, and the gather
    fallback of an uneven split in the world of 2: two spawned worlds."""
    out = {}
    runs = ["normal:bf16", "normal:s8_pv", "offset:s8"]
    uneven = _inputs(5, 2)
    for sp in (2, 4):
        cases = _inputs(sp, sp)
        worlds = [("even", cases, runs, None)]
        if sp == 2:
            worlds.append(("uneven", uneven, ["normal:bf16", "normal:s8_pv"], UNEVEN))
        port = _port(tmp_path_factory.mktemp(f"ring{sp}"), sp, worlds)
        out[sp] = (cases, port["even"])
        if sp == 2:
            out["uneven"] = (uneven, port["uneven"])
    return out


def _jax_ring(sp, q, k, v, **mode):
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    sh = NamedSharding(mesh, P(None, None, "sp", None))
    args = [jax.device_put(jnp.asarray(a), sh) for a in (q, k, v)]
    with jax.sharding.set_mesh(mesh):
        fn = jax.jit(lambda a, b, c: jfp.flash_attention(a, b, c, interpret=True, **mode))
        assert "collective-permute" in fn.lower(*args).compile().as_text()  # JAX's ring
        return np.asarray(fn(*args))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("mode", ["bf16", "s8_pv"])
def test_ring_matches_jax_ring(rings, sp, mode):
    """The port's ring against JAX's ring on the same chunks: bf16 mode
    within 2e-4 max-abs; s8_pv (each chunk's v centred by its own mean, the
    mean added back inside the chunk's output) within the int8 band. No
    rank takes the fallback."""
    cases, port = rings[sp]
    q, k, v = (cases[f"normal_{t}"] for t in "qkv")
    want = _jax_ring(sp, q, k, v, s8_pv=mode == "s8_pv")
    got = _heads(port[f"normal:{mode}"])
    if mode == "bf16":
        assert np.abs(got - want).max() <= RING_ATOL
    else:
        assert summed_rel(got, want) <= INT8_BAND
    assert not any(port["warned"])


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_s8_matches_single_chip(rings, sp):
    """On the offset-k input, the port's s8 ring equals JAX's single-chip s8
    attention within the int8 band; JAX's ring is outside it (its chunks'
    log-sum-exps are those of differently centred k)."""
    cases, port = rings[sp]
    q, k, v = (cases[f"offset_{t}"] for t in "qkv")
    single = np.asarray(jfp.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            interpret=True, s8=True))
    exact = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert summed_rel(single, exact) <= INT8_BAND
    assert summed_rel(_heads(port["offset:s8"]), single) <= INT8_BAND
    assert summed_rel(_jax_ring(sp, q, k, v, s8=True), single) > INT8_BAND


def test_uneven_rows_fall_back_with_warning(rings):
    """Rows split 300 / 212: no ring; k/v are gathered and each rank attends
    its q rows over the whole sequence, with JAX's warning on every rank.
    bf16 mode within 2e-4 of the exact attention; s8_pv equal to JAX's
    single-chip kernel within 1e-5 (the same quantization of the whole k/v)."""
    cases, port = rings["uneven"]
    q, k, v = (cases[f"normal_{t}"] for t in "qkv")
    exact = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert np.abs(_heads(port["normal:bf16"]) - exact).max() <= RING_ATOL
    single = np.asarray(jfp.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            interpret=True, s8_pv=True))
    assert summed_rel(_heads(port["normal:s8_pv"]), single) <= 1e-5
    assert all(port["warned"])


def test_sdpa_merged_sp_needs_the_flash_path(monkeypatch):
    """Under an sp split the XLA path (``impl="xla"``, or
    DIFFUSION_RS_TPU_NO_FLASH) attends this rank's q rows over k/v gathered
    from the group (parallel/mesh.gather_rows, differentiable), as GSPMD
    does for JAX's training step; the flash path keeps the ring. The gather
    is stood in by this rank's rows plus the other rank's, so the result
    equals the whole attention's rows of this rank."""
    import torch

    from diffusion_rs_tpu_torch.ops import attention
    from diffusion_rs_tpu_torch.ops.partitioned import SeqShard

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 8, 128), generator=gen) for _ in range(3))
    seq = SeqShard(group="sp", lens=[4, 4])
    calls = []

    def gather(t, group, sizes, dim):
        calls.append((group, list(sizes), dim))
        whole = {id(k_local): k, id(v_local): v}[id(t)]
        return whole

    k_local, v_local = k[:, :, :4], v[:, :, :4]
    monkeypatch.setattr(attention, "gather_rows", gather)
    out = attention.sdpa_merged(q[:, :, :4], k_local, v_local, impl="xla", seq=seq)
    want = attention.sdpa_xla(q, k, v)[:, :, :4].transpose(1, 2).reshape(1, 4, 256)
    torch.testing.assert_close(out, want)
    assert calls == [("sp", [4, 4], 2)] * 2
