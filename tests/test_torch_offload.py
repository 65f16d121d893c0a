"""Host offload (``Offloading.Full``) and per-block weight streaming
(``Offloading.Stream``) in the port, on the CPU, against the port's resident
pipeline (bit for bit) and against the JAX package.

``HostOffload``'s semantics (``only``, nested refcounts, two threads); the
``Full`` pipeline from a tiny dense checkpoint (tests/synth.py) against the
resident one for txt2img and img2img, and against JAX's ``Full`` pipeline
from the same checkpoint; the block packing round trip over every weight
format and a fused / grouped tree; the streamed denoise on the tiny q8t
FLUX against the resident one at lookahead 1, 2 and 4 and under
DIFFUSION_RS_TPU_FUSED_ROPE=1 (against JAX's ``StreamedFlux.denoise`` in
tests/test_torch_pipeline.py, which holds the case it runs); and the
loader's rules
(mesh and inpainting refused under ``Stream``, the capacity check routed
past). The CUDA cases (pinned copies, the slot ring) are in
tests/test_torch_cuda.py; ``Full`` under a dp2 x sp2 mesh is in
tests/test_torch_mesh.py.
"""

import copy
import dataclasses
import importlib
import sys
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from diffusion_rs_tpu import DiffusionGenerationParams as JParams
from diffusion_rs_tpu import ModelDType as JDType
from diffusion_rs_tpu import ModelSource as JSource
from diffusion_rs_tpu import Offloading as JOffloading
from diffusion_rs_tpu import Pipeline as JPipeline
from diffusion_rs_tpu.pipelines import sampling as jsampling
from diffusion_rs_tpu_torch import FluxPipeline as TFluxPipeline
from diffusion_rs_tpu_torch.models import flux as tflux
from diffusion_rs_tpu_torch.models import flux_streaming as tfs
from diffusion_rs_tpu_torch.models.optimize import fuse_flux_qkv
from diffusion_rs_tpu_torch.parallel import HostOffload
from diffusion_rs_tpu_torch.pipelines import sampling as tsampling
from diffusion_rs_tpu_torch.pipelines.api import ModelDType as TDType
from diffusion_rs_tpu_torch.pipelines.api import ModelSource as TSource
from diffusion_rs_tpu_torch.pipelines.api import Offloading
from diffusion_rs_tpu_torch.pipelines.api import Pipeline as TPipeline
from diffusion_rs_tpu_torch.pipelines.flux_pipeline import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch.pipelines.loader import apply_layout_options, load_pipeline
from diffusion_rs_tpu_torch.pipelines.scheduler import SchedulerConfig
from diffusion_rs_tpu_torch.util import hostmem
from diffusion_rs_tpu_torch.util import synthetic as syn
from diffusion_rs_tpu_torch.util.capacity import tree_device_bytes
from diffusion_rs_tpu_torch.util.tree import take_layer, tree_leaves
from synth import write_checkpoint
from torch_port_util import I2I_FLUX, jax_interpreted_module, summed_rel  # noqa: F401

LATENT_BAND = 2e-5  # tests/test_torch_load_pipeline.py
GEN = dict(height=64, width=64, num_steps=2, guidance_scale=3.5, seed=42)
PROMPTS = ["a photo of a cat", "the dog"]


@pytest.fixture
def same_noise(monkeypatch):
    """The port draws the JAX package's noise for the request's seed."""
    tpl = importlib.import_module("diffusion_rs_tpu_torch.pipelines.flux_pipeline")

    def jax_noise(seed, n, h, w, device):
        return torch.from_numpy(np.array(jsampling.get_noise(jax.random.PRNGKey(seed), n, h, w)))

    monkeypatch.setattr(tpl, "get_noise", jax_noise)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("offload") / "dense", seed=0,
                            guidance=True, dynamic_shifting=True)


def _port(ckpt, offloading=None, **kw):
    return TPipeline(TSource.from_model_id(str(ckpt)), silent=True, dtype=TDType.F32,
                     device="cpu", offloading=offloading, **kw)


@pytest.fixture(scope="module")
def pipes(ckpt):
    """The port's resident, Full and Stream pipelines (f32) on one checkpoint."""
    return {"resident": _port(ckpt), "full": _port(ckpt, Offloading.Full),
            "stream": _port(ckpt, Offloading.Stream)}


def _init_images():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in PROMPTS]


def _extra(mode: str) -> dict:
    return dict(init_image=_init_images(), strength=0.5) if mode == "img2img" else {}


@pytest.fixture(scope="module")
def resident_out(pipes):
    """The resident pipeline's output per (mode, output type), run once."""
    cache = {}

    def get(mode: str, output: str):
        if (mode, output) not in cache:
            cache[mode, output] = pipes["resident"]._inner.forward_arrays(
                PROMPTS, TParams(**GEN), output_type=output, **_extra(mode))
        return cache[mode, output]

    return get


# -- HostOffload ---------------------------------------------------------------


def _tree():
    return {"w": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(3)]}


def test_only_filters_components():
    """``only`` restricts the registry: other names are neither managed nor
    copied, and ``register`` hands their params back as given."""
    off = HostOffload(only=("t5", "clip"))
    tree = _tree()
    assert off.register("flux", tree, device="cpu") is tree
    assert not off.manages("flux")
    host = off.register("t5", tree, device="cpu")
    assert off.manages("t5") and torch.equal(host["w"], tree["w"])
    assert off.resident("t5") is host  # on the CPU the host copy is the resident one
    off.release("t5")
    assert off.ensure_resident() is None


def test_nested_residency_keeps_the_copy_until_zero():
    off = HostOffload()
    off.register("vae", _tree(), device="cpu")
    a = off.resident("vae")
    b = off.ensure_resident("vae")
    assert a is b and off._refs["vae"] == 2
    off.release("vae")
    assert "vae" in off._device and off._refs["vae"] == 1
    off.release("vae")
    assert "vae" not in off._device and "vae" not in off._refs
    off.release("vae")  # an extra release stays a no-op
    assert off.resident("vae") is a
    off.release("vae")


def test_two_threads_acquire_and_release():
    """Two threads acquire and release one component 300 times each; while a
    thread holds it, the copy stays, and the counts end at zero."""
    off = HostOffload()
    off.register("t5", _tree(), device="cpu")
    errors = []
    start = threading.Barrier(2)

    def worker():
        start.wait()
        for _ in range(300):
            tree = off.resident("t5")
            if "t5" not in off._device or off._device["t5"] is not tree:
                errors.append("evicted while held")
            off.release("t5")

    threads = [threading.Thread(target=worker) for _ in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not off._refs and not off._device


# -- Offloading.Full -------------------------------------------------------------


@pytest.mark.parametrize("mode,output", [("txt2img", "latent"), ("txt2img", "np"),
                                         ("img2img", "latent")])
def test_full_equals_resident(pipes, resident_out, mode, output):
    """The Full pipeline equals the resident one bit for bit, and every
    component it manages is released after the call."""
    inner = pipes["full"]._inner
    got = inner.forward_arrays(PROMPTS, TParams(**GEN), output_type=output, **_extra(mode))
    np.testing.assert_array_equal(got, resident_out(mode, output))
    assert all(inner.offload.manages(n) for n in ("t5", "clip", "vae", "flux"))
    assert not inner.offload._refs and not inner.offload._device


def test_full_matches_jax_full(ckpt, pipes, jax_interpreted_module, same_noise):
    """The port's Full f32 latents within LATENT_BAND of JAX's Full pipeline
    on the same checkpoint and noise."""
    jp = JPipeline(JSource.from_model_id(str(ckpt)), silent=True, dtype=JDType.F32,
                   offloading=JOffloading.Full)
    lat_j = jp.forward_latents(PROMPTS, JParams(**GEN))
    lat_t = pipes["full"].forward_latents(PROMPTS, TParams(**GEN))
    assert lat_t.shape == lat_j.shape == (2, 16, 64)
    assert summed_rel(lat_t, lat_j) <= LATENT_BAND


# -- packing -----------------------------------------------------------------------

TINY = tflux.FluxConfig(**I2I_FLUX)


def _flux_tree(kind: str):
    if kind == "dense":
        return syn.init_flux_params(0, TINY, torch.float32, device="cpu")
    if kind == "fused_grouped":
        params = syn.init_flux_params_quantized(0, TINY, kind="q8t", device="cpu")
        return fuse_flux_qkv(params, ("img", "txt", "single"))
    return syn.init_flux_params_quantized(0, TINY, kind=kind, device="cpu")


@pytest.mark.parametrize("kind", ["q8t", "nf4", "q4_0", "q8_0", "dense", "fused_grouped"])
def test_pack_unpack_round_trip(kind):
    """Every block packs into one buffer with each leaf at a 128-byte offset
    and unpacks to views equal to its leaves (dtype, shape, values, and the
    QuantizedTensors' other fields)."""
    params = _flux_tree(kind)
    sf = tfs.StreamedFlux(params, TINY, device="cpu")
    for stacked, bufs, (template, specs) in (
            (params["double"], sf.dbl_bufs, sf.dbl_meta),
            (params["single"], sf.sgl_bufs, sf.sgl_meta)):
        assert all(off % hostmem.ALIGN == 0 for off, *_ in specs)
        ends = [off + np.prod(shape, dtype=np.int64) * dt.itemsize
                for off, shape, dt, _ in specs]
        assert all(e <= nxt for e, (nxt, *_) in zip(ends, specs[1:]))  # no overlap
        for i, buf in enumerate(bufs):
            assert buf.numel() % hostmem.ALIGN == 0
            block = hostmem.unpack_tree(buf, template, specs)
            want = take_layer(stacked, i)
            got_leaves, want_leaves = tree_leaves(block), tree_leaves(want)
            assert len(got_leaves) == len(want_leaves) == len(specs)
            for g, w in zip(got_leaves, want_leaves):
                assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
                assert g.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
            assert (jax.tree.structure(block, is_leaf=lambda x: isinstance(x, torch.Tensor))
                    == jax.tree.structure(want, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert sf.bytes_per_step == sum(b.numel() for b in sf.dbl_bufs + sf.sgl_bufs)


def test_pack_refuses_blocks_that_differ():
    params = _flux_tree("q8t")
    other = _flux_tree("q4_0")
    doubles = [take_layer(params["double"], 0), take_layer(other["double"], 0)]
    singles = [take_layer(params["single"], i) for i in range(TINY.num_single_layers)]
    pre = {k: params[k] for k in tfs._PRE}
    with pytest.raises(ValueError, match="double block 1"):
        tfs.StreamedFlux.from_block_trees(pre, params["final"], doubles, singles, TINY,
                                          device="cpu")


@pytest.mark.parametrize("extra", [-1, 1])
def test_pack_refuses_a_block_count_other_than_the_config(extra):
    """The blocks fill buffers sized from the config's layer counts: one
    block fewer or one more than the config has is refused."""
    params = _flux_tree("q8t")
    n = TINY.num_single_layers + extra
    singles = [take_layer(params["single"], i % TINY.num_single_layers) for i in range(n)]
    doubles = [take_layer(params["double"], i) for i in range(TINY.num_layers)]
    pre = {k: params[k] for k in tfs._PRE}
    with pytest.raises(ValueError, match="single blocks"):
        tfs.StreamedFlux.from_block_trees(pre, params["final"], doubles, singles, TINY,
                                          device="cpu")


# -- Offloading.Stream: the denoise ---------------------------------------------------


@pytest.fixture(scope="module")
def q8t_run():
    """A resident pipeline on the tiny q8t FLUX (the port's seeded factory,
    f32) and seeded inputs of its denoise: text states, pooled vector,
    noise, a 3-step schedule, the guidance."""
    params = syn.init_flux_params_quantized(0, TINY, torch.float32, kind="q8t", device="cpu")
    pipe = TFluxPipeline(flux_params=params, flux_cfg=TINY, t5_params=None, t5_cfg=None,
                         clip_params=None, clip_cfg=None, vae_params=None, vae_cfg=None,
                         scheduler=SchedulerConfig(), t5_tokenizer=None, clip_tokenizer=None,
                         dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(3)
    inp = dict(txt=torch.randn(2, 16, TINY.joint_attention_dim, generator=gen),
               y=torch.randn(2, TINY.pooled_projection_dim, generator=gen),
               sigmas=np.array([1.0, 0.7, 0.35, 0.0], np.float32),
               g=torch.full((2,), 3.5), noise=torch.randn(2, 16, 8, 8, generator=gen))
    return pipe, inp


def _with(pipe, **attrs):
    """A shallow copy of the pipeline with some attributes replaced."""
    out = copy.copy(pipe)
    out.__dict__.update(attrs)
    return out


@pytest.mark.parametrize("case", ["look1", "look2", "look4", "fused_rope"])
def test_streamed_denoise_equals_resident(q8t_run, monkeypatch, case):
    """The streamed denoise (the pipeline's, and StreamedFlux.denoise) equals
    the resident pipeline's bit for bit, at lookahead 1, 2 and 4, and with
    the half-split RoPE layout (DIFFUSION_RS_TPU_FUSED_ROPE=1). The port
    against JAX's StreamedFlux is in tests/test_torch_pipeline.py, on its
    held-equal txt2img case."""
    pipe, inp = q8t_run
    params, cfg = pipe.flux_params, pipe.flux_cfg
    if case == "fused_rope":
        monkeypatch.setenv("DIFFUSION_RS_TPU_FUSED_ROPE", "1")
        params, cfg, _ = apply_layout_options(params, cfg, None)
        assert cfg.rope_fused
    else:
        monkeypatch.setenv("DIFFUSION_RS_TPU_STREAM_LOOKAHEAD", case[4:])
    resident = _with(pipe, flux_params=params, flux_cfg=cfg)
    sf = tfs.StreamedFlux(params, cfg, device="cpu")
    streamed = _with(pipe, flux_params=None, flux_cfg=cfg, streamed=sf)
    args = [inp[k] for k in ("txt", "y", "sigmas", "g", "noise")]
    want = resident._denoise(*args)
    assert torch.equal(streamed._denoise_streamed(*args), want)
    txt, y, sig, g, noise = args
    img = tsampling.pack_latents(noise)
    assert torch.equal(sf.denoise(img, txt, y, g, streamed._pe(txt, noise), sig), want)


def test_overlap_report_keys(q8t_run):
    """overlap_report returns JAX's six keys, positive and finite (the host
    clock on a CPU; the card's numbers come from chip_smoke.py)."""
    pipe, inp = q8t_run
    sf = tfs.StreamedFlux(pipe.flux_params, pipe.flux_cfg, device="cpu")
    txt, noise = inp["txt"], inp["noise"]
    rep = sf.overlap_report(tsampling.pack_latents(noise), txt, inp["y"], inp["g"],
                            pipe._pe(txt, noise), iters=1)
    assert set(rep) == {"h2d_gbps", "h2d_s", "compute_s", "stream_s", "overlap_efficiency",
                        "bytes_per_step_gb"}
    assert all(np.isfinite(v) and v > 0 for v in rep.values())
    assert rep["bytes_per_step_gb"] == sf.bytes_per_step / 2**30


# -- Offloading.Stream: the loader's rules ---------------------------------------------


@pytest.mark.parametrize("mode", ["txt2img", "img2img"])
def test_streamed_pipeline_equals_resident(pipes, resident_out, mode):
    """Pipeline(offloading=Stream) equals the resident pipeline bit for bit;
    img2img streams from its start latent."""
    inner = pipes["stream"]._inner
    assert inner.flux_params is None and isinstance(inner.streamed, tfs.StreamedFlux)
    got = inner.forward_arrays(PROMPTS, TParams(**GEN), output_type="latent", **_extra(mode))
    np.testing.assert_array_equal(got, resident_out(mode, "latent"))


def test_stream_refuses_mesh_and_inpainting(ckpt, pipes):
    src = TSource.from_model_id(str(ckpt))
    with pytest.raises(ValueError, match="mutually exclusive"):
        load_pipeline(src, device="cpu", offloading=Offloading.Stream,
                      mesh=SimpleNamespace(shape={"dp": 1, "sp": 1, "tp": 1}))
    mask = np.full((8, 8), 255, np.uint8)
    with pytest.raises(NotImplementedError, match="inpainting with Offloading.Stream"):
        pipes["stream"].inpaint_images(PROMPTS, TParams(**GEN), _init_images(), mask)


def test_stream_routes_past_the_capacity_check(pipes, monkeypatch):
    """With a device budget below the transformer's bytes the resident
    pipeline raises the routing message, which names Offloading.Stream, and
    the streamed pipeline makes the image."""
    w = tree_device_bytes(pipes["resident"]._inner.flux_params)
    monkeypatch.setenv("DIFFUSION_RS_TPU_HBM_BYTES", str(w - 1))
    with pytest.raises(ValueError, match="Offloading.Stream"):
        pipes["resident"].forward_images(PROMPTS[:1], TParams(**GEN))
    img = pipes["stream"].forward_images(PROMPTS[:1], TParams(**GEN))[0]
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8


def test_offloading_builds_on_the_host(pipes):
    """Under offloading the components are built on the CPU, and the
    streamed blocks are host buffers."""
    full, stream = pipes["full"]._inner, pipes["stream"]._inner
    for tree in (full.t5_params, full.flux_params, stream.vae_params):
        assert all(t.device.type == "cpu" for t in tree_leaves(tree))
    assert all(b.device.type == "cpu" and b.dtype == torch.uint8
               for b in stream.streamed.dbl_bufs + stream.streamed.sgl_bufs)
    assert dataclasses.asdict(stream.flux_cfg) == dataclasses.asdict(stream.streamed.cfg)
