"""The port's utilities: the kernel cache (util/compile_cache.py, the
counterparts of tests/test_compile_cache.py's five cases against
ops/_cuda.BUILD_DIR instead of XLA's cache; nothing is built), the spans
and the profiler context (util/tracing.py), auto-dtype (util/dtype.py,
against the JAX package's choice on the CPU) and progress
(util/progress.py). The spans: ``trace_span`` enters the profiler only
while one records and feeds a ``SpanLog``; the pipeline's per-step host
times; the model step's op-family spans per block."""

import collections
import dataclasses
import json
import logging
import threading

import pytest
import torch

from diffusion_rs_tpu.util.dtype import resolve_auto_dtype as j_resolve_auto_dtype
from diffusion_rs_tpu_torch import DiffusionGenerationParams, FluxPipeline
from diffusion_rs_tpu_torch.models.clip import ClipTextConfig
from diffusion_rs_tpu_torch.models.flux import FluxConfig, compute_pe, flux_forward
from diffusion_rs_tpu_torch.models.optimize import fuse_flux_qkv
from diffusion_rs_tpu_torch.models.t5 import T5Config
from diffusion_rs_tpu_torch.models.vae import VAEConfig
from diffusion_rs_tpu_torch.ops import _cuda
from diffusion_rs_tpu_torch.pipelines import loader as loader_mod
from diffusion_rs_tpu_torch.pipelines.api import ModelDType, ModelSource, Pipeline
from diffusion_rs_tpu_torch.pipelines.sampling import make_img_ids, make_txt_ids
from diffusion_rs_tpu_torch.pipelines.scheduler import SchedulerConfig
from diffusion_rs_tpu_torch.util import compile_cache as cc
from diffusion_rs_tpu_torch.util import synthetic as syn
from diffusion_rs_tpu_torch.util.dtype import resolve_auto_dtype
from diffusion_rs_tpu_torch.util.progress import progress
from diffusion_rs_tpu_torch.util.tracing import SpanLog, maybe_profile, trace_span
from torch_port_util import I2I_CLIP, I2I_FLUX, I2I_T5, I2I_VAE

SPANS = ("generate", "text-encode", "vae-encode", "denoise", "vae-decode")


@pytest.fixture
def reset_cache_config(monkeypatch):
    """The build directory and the first-enable latch are process-global:
    both come back after the test, so no later test builds into a deleted
    directory."""
    monkeypatch.setattr(cc, "_enabled_dir", None)
    monkeypatch.setattr(_cuda, "BUILD_DIR", _cuda.BUILD_DIR)
    monkeypatch.setattr(_cuda, "_LIBS", {})


def test_disabled_without_arg_or_env(monkeypatch, reset_cache_config):
    monkeypatch.delenv("DIFFUSION_RS_TPU_COMPILE_CACHE", raising=False)
    before = _cuda.BUILD_DIR
    assert cc.enable_compile_cache() is None
    assert _cuda.BUILD_DIR == before


def test_enable_points_the_build_dir(tmp_path, reset_cache_config):
    d = cc.enable_compile_cache(str(tmp_path / "cache"))
    assert d == str(tmp_path / "cache")
    assert _cuda.BUILD_DIR == tmp_path / "cache"
    # every library is built into, and loaded from, the directory
    assert all(_cuda._lib_path(name).parent == tmp_path / "cache" for name in _cuda.SOURCES)


def test_first_enable_wins(tmp_path, reset_cache_config, caplog):
    first = cc.enable_compile_cache(str(tmp_path / "a"))
    with caplog.at_level(logging.WARNING, logger="diffusion_rs_tpu_torch"):
        second = cc.enable_compile_cache(str(tmp_path / "b"))
    assert second == first and _cuda.BUILD_DIR == tmp_path / "a"
    assert "already enabled" in caplog.text
    # the same directory again is silent and idempotent
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="diffusion_rs_tpu_torch"):
        assert cc.enable_compile_cache(str(tmp_path / "a")) == first
    assert not caplog.text


def test_env_var_is_the_default(tmp_path, monkeypatch, reset_cache_config):
    monkeypatch.setenv("DIFFUSION_RS_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert cc.enable_compile_cache() == str(tmp_path / "env")
    assert _cuda.BUILD_DIR == tmp_path / "env"


def test_loaded_library_keeps_its_dir(tmp_path, monkeypatch, reset_cache_config, caplog):
    """Once a library is loaded, the build directory stays where it is."""
    before = _cuda.BUILD_DIR
    monkeypatch.setattr(_cuda, "_LIBS", {"qmm_s8": object()})
    with caplog.at_level(logging.WARNING, logger="diffusion_rs_tpu_torch"):
        assert cc.enable_compile_cache(str(tmp_path / "late")) == str(before)
    assert _cuda.BUILD_DIR == before and "already loaded" in caplog.text
    assert cc._enabled_dir is None


@pytest.mark.parametrize("how", ["argument", "env"])
def test_pipeline_plumbs_compile_cache(monkeypatch, tmp_path, how):
    """Pipeline(compile_cache=...) and DIFFUSION_RS_TPU_COMPILE_CACHE reach
    enable_compile_cache before any load work (the load fails after it)."""
    calls = []
    monkeypatch.setattr(cc, "enable_compile_cache", lambda d=None: calls.append(d))
    empty = tmp_path / "empty-model-dir"
    empty.mkdir()
    kw = {}
    if how == "argument":
        kw["compile_cache"] = str(tmp_path / "cc")
    else:
        monkeypatch.setenv("DIFFUSION_RS_TPU_COMPILE_CACHE", str(tmp_path / "cc"))
    with pytest.raises(Exception):
        Pipeline(ModelSource.from_model_id(str(empty)), device="cpu", **kw)
    assert calls == [kw.get("compile_cache")]


def test_mesh_with_tp_still_raises(tmp_path):
    """A mesh whose tp does not divide the model's heads still raises: the
    loader names the dimension (ValueError) before it cuts the weights
    (tests/synth.py's FLUX has 2 heads; tp=4)."""
    from types import SimpleNamespace

    from synth import write_checkpoint

    ckpt = write_checkpoint(tmp_path / "ckpt", seed=0)
    with pytest.raises(ValueError, match="FLUX num_attention_heads = 2 is not divisible by tp=4"):
        loader_mod.load_pipeline(ModelSource.from_model_id(str(ckpt)), device="cpu", silent=True,
                                 mesh=SimpleNamespace(shape={"dp": 1, "sp": 1, "tp": 4}))


def test_trace_span_is_recorded_by_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_span("text-encode"):
            torch.ones(4).add_(1)
    assert "text-encode" in {e.key for e in prof.key_averages()}


def test_trace_span_enters_record_function_only_inside_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with trace_span("outside", nvtx=False) as span:
        torch.ones(4).add_(1)
    assert span is None and entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_span("inside", nvtx=False):
            torch.ones(4).add_(1)
    assert entered == ["inside"]
    assert "inside" in {e.key for e in prof.key_averages()}


def test_trace_span_appends_to_a_bounded_span_log():
    """Each span on its own named thread, with attrs given and added inside
    the block; the log keeps the newest ``capacity`` entries."""
    log = SpanLog(capacity=3)

    def work(i):
        with trace_span("job", log, {"i": i}, nvtx=False) as span:
            span.attrs["twice"] = 2 * i

    for i in range(5):
        t = threading.Thread(target=work, args=(i,), name=f"worker-{i}")
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    got = log.snapshot()
    assert [(s.thread, s.attrs) for s in got] == [
        (f"worker-{i}", {"i": i, "twice": 2 * i}) for i in (2, 3, 4)]
    assert all(s.name == "job" and s.start <= s.end for s in got)
    assert all(a.end <= b.start for a, b in zip(got, got[1:]))


def test_pipeline_step_host_times():
    """One host launch time per step, each within its synced step time; no
    kernel launches on the CPU, so no wrapper time."""
    pipe = _tiny_pipeline()
    params = DiffusionGenerationParams(height=64, width=64, num_steps=3, guidance_scale=3.5,
                                       seed=7, max_sequence_length=64)
    pipe.forward_arrays(["a cat"], params)
    t = pipe.timings
    assert len(t["steps_s"]) == len(t["steps_host_s"]) == 3
    assert all(0 < h <= s for h, s in zip(t["steps_host_s"], t["steps_s"]))
    assert t["launch_wrapper_s"] == 0.0


_MATMULS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::matmul", "aten::linear"}


@pytest.mark.parametrize("path", ["default", "grouped", "rope_fused"])
def test_flux_forward_family_spans_per_block(path):
    """A tiny flux_forward under a CPU profiler records each op-family span
    the expected number of times per block, and no product runs inside a
    ``flux.qk_rope`` or ``flux.gate_act`` span (``flux.norm_mod`` holds the
    modulation's linear)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = FluxConfig(**I2I_FLUX)
    params = syn.init_flux_params(0, cfg, dtype=torch.float32, device="cpu")
    if path == "grouped":
        params = fuse_flux_qkv(params, ("img", "txt"))
        cfg = dataclasses.replace(cfg, grouped_qmm=True)
    elif path == "rope_fused":  # the default bhsd layout rotates inside _joint_attention_sm
        cfg = dataclasses.replace(cfg, rope_fused=True)
    d, s = cfg.num_layers, cfg.num_single_layers
    want = {"flux.norm_mod": 3 * d + s + 1, "flux.qk_rope": d + s, "flux.gate_act": 6 * d + 3 * s}
    if path == "grouped":
        want.update({"flux.norm_mod": 2 * d + s + 1, "flux.gate_act": 3 * d + 3 * s})
    elif path == "rope_fused":
        want["flux.qk_rope"] = 2 * (d + s)
    g = torch.Generator().manual_seed(0)
    img = torch.randn(1, 16, cfg.in_channels, generator=g)
    txt = torch.randn(1, 8, cfg.joint_attention_dim, generator=g)
    y = torch.randn(1, cfg.pooled_projection_dim, generator=g)
    pe = compute_pe(cfg, make_txt_ids(1, 8, "cpu"), make_img_ids(1, 4, 4, "cpu"))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        flux_forward(params, cfg, img, txt, torch.tensor([0.5]), y, torch.tensor([3.5]), pe=pe)
    events = prof.events()
    assert collections.Counter(e.name for e in events if e.name.startswith("flux.")) == want
    spans = [e.time_range for e in events if e.name in ("flux.qk_rope", "flux.gate_act")]
    assert any(e.name in _MATMULS for e in events)
    for e in events:
        if e.name in _MATMULS:
            assert not any(r.start <= e.time_range.start <= r.end for r in spans), e.name


def _tiny_pipeline():
    f32 = dict(dtype=torch.float32, device="cpu")
    cfgs = dict(flux_cfg=FluxConfig(**I2I_FLUX), t5_cfg=T5Config(**I2I_T5),
                clip_cfg=ClipTextConfig(**I2I_CLIP), vae_cfg=VAEConfig(**I2I_VAE))
    return FluxPipeline(
        flux_params=syn.init_flux_params(0, cfgs["flux_cfg"], **f32),
        t5_params=syn.init_t5_params(1, cfgs["t5_cfg"], **f32),
        clip_params=syn.init_clip_params(2, cfgs["clip_cfg"], **f32),
        vae_params={**syn.init_vae_decoder_params(3, cfgs["vae_cfg"], **f32),
                    **syn.init_vae_encoder_params(4, cfgs["vae_cfg"], **f32)},
        scheduler=SchedulerConfig(use_dynamic_shifting=True),
        t5_tokenizer=syn.WordTokenizer(300), clip_tokenizer=syn.WordTokenizer(300),
        dtype=torch.float32, device="cpu", **cfgs)


def test_maybe_profile_traces_the_pipeline_only_when_set(tmp_path, monkeypatch):
    """Unset: no trace. Set: one Chrome trace of forward_arrays naming the
    pipeline's spans (an img2img image runs all five)."""
    import numpy as np

    pipe = _tiny_pipeline()
    params = DiffusionGenerationParams(height=64, width=64, num_steps=1, guidance_scale=3.5,
                                       seed=7, max_sequence_length=64)
    init = np.zeros((64, 64, 3), np.uint8)
    trace_dir = tmp_path / "traces"
    monkeypatch.delenv("DIFFUSION_RS_TPU_TRACE_DIR", raising=False)
    pipe.forward_arrays(["a cat"], params, init_image=init, strength=1.0)
    with maybe_profile("other"):
        pass
    assert not trace_dir.exists()
    monkeypatch.setenv("DIFFUSION_RS_TPU_TRACE_DIR", str(trace_dir))
    pipe.forward_arrays(["a cat"], params, init_image=init, strength=1.0)
    files = list(trace_dir.iterdir())
    assert len(files) == 1 and files[0].name.startswith("generate-")
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert set(SPANS) <= names, set(SPANS) - names


def test_auto_dtype_matches_jax_on_cpu():
    assert resolve_auto_dtype("cpu") == getattr(torch, str(j_resolve_auto_dtype()))


def test_auto_dtype_reaches_the_loader(monkeypatch, tmp_path):
    """ModelDType.Auto resolves through resolve_auto_dtype on the target
    device (the port used to hard-code bf16)."""
    from synth import write_checkpoint

    seen = []
    monkeypatch.setattr(loader_mod, "resolve_auto_dtype",
                        lambda device: seen.append(device) or torch.float32)
    pipe = loader_mod.load_pipeline(
        ModelSource.from_model_id(str(write_checkpoint(tmp_path / "ck", seed=0))),
        dtype=ModelDType.Auto, device="cpu", silent=True)
    assert seen == [torch.device("cpu")] and pipe.dtype == torch.float32


def test_progress_passes_through_off_a_tty(capsys):
    assert list(progress(range(3), desc="load")) == [0, 1, 2]
    assert list(progress(iter("ab"), silent=True)) == ["a", "b"]
    assert capsys.readouterr().err == ""
