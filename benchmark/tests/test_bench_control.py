"""The check has to fail what it exists to catch, at a size a test run holds:
the control (the float32 reference computed one precision step lower, put
in the program's place) and the faults a timed path can have, planted under
a whole tiny run of the harness on the CPU with its look for a card
skipped."""

import json
import time

import pytest
import torch

from benchmark.tests.conftest import HERE

from benchmark.harness import check, main, planes as P, port
from benchmark.harness.requests import Request
from benchmark.reference.common import Precision
from benchmark.reference.pipeline import image


@pytest.mark.parametrize("config", ["tiny-flux-q8t", "tiny-flux-nf4"])
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 3])
def test_control_fails_the_limit(config, seed):
    """The program passes both numbers; the reference with float8 inputs to
    its products, put in the program's place, fails one."""
    cfg = json.loads((HERE / f"{config}.json").read_text())
    pl = P.model_planes(cfg, seed, "cpu")
    pipe = port.build_pipeline(cfg, pl, "cpu")
    tap = port.LatentTap(pipe)
    prog = pipe.forward_arrays(["the control prompt"], port.generation_params(cfg, 64, 64, seed))
    prog_lat = tap.take()
    req = Request(0, "the control prompt", seed, 64, 64)
    ref_lat = image(cfg, pl, req.prompt, seed, 64, 64, "cpu")[0].numpy()
    low_lat, low = image(cfg, pl, req.prompt, seed, 64, 64, "cpu", Precision("fp8_products"))
    lim = cfg["check"]
    got = check.judge(cfg, pl, req, prog_lat, prog[0], ref_lat, "cpu")
    ctl = check.judge(cfg, pl, req, low_lat.numpy(), low, ref_lat, "cpu")
    assert all(got[k] <= lim[k] for k in got)
    assert any(ctl[k] > lim[k] for k in ctl)


@pytest.mark.parametrize("seed", [4, 791221087])
def test_control_fails_against_the_stated_t5(seed):
    """The reference, its T5 in the bfloat16 the configuration states, takes
    the port's T5 output to within a few bfloat16 roundings on the CPU; dev's
    reference with it still fails its float8-products control."""
    from diffusion_rs_tpu_torch.models.t5 import t5_encode
    from benchmark.reference.encoders import t5_encode as ref_t5
    from benchmark.reference.pipeline import token_ids

    cfg = json.loads((HERE / "tiny-flux-q8t.json").read_text())
    pl = P.model_planes(cfg, seed, "cpu")
    pipe = port.build_pipeline(cfg, pl, "cpu")
    prompt = "the stated precision of the text encoder"
    t5_ids, _ = token_ids(cfg, prompt, "cpu")
    with torch.no_grad():
        prog = t5_encode(pipe.t5_params, pipe.t5_cfg, t5_ids).float()
    ref = ref_t5(cfg, pl["t5"], t5_ids, Precision("float32"))
    assert float((prog - ref).norm() / ref.norm()) < 2e-3
    lat = image(cfg, pl, prompt, seed, 64, 64, "cpu")[0].numpy()
    low = image(cfg, pl, prompt, seed, 64, 64, "cpu", Precision("fp8_products"))[0].numpy()
    assert check.latent_rel_err(low, lat) > cfg["check"]["latent_rel_err"]


def _run(tiny, cell, monkeypatch, trace=False, seed=11, all_of_them=True):
    root, man = tiny
    if all_of_them:
        monkeypatch.setattr(check, "sample", lambda done, seed, n, batches=(): list(done))
    return main.run(root, cell, seed, 1.0, trace, time.perf_counter(), device="cpu", man=man)


def test_sound_runs_are_correct(tiny, monkeypatch):
    assert _run(tiny, "t-image", monkeypatch)["correct"]
    assert _run(tiny, "t-serve", monkeypatch, trace=True)["correct"]


def test_step_returning_its_state_unchanged(tiny, monkeypatch):
    import torch
    from diffusion_rs_tpu_torch.pipelines import flux_pipeline
    from diffusion_rs_tpu_torch import serving

    def still(params, cfg, img, *a, **k):
        return torch.zeros(img.shape[:-1] + (cfg.in_channels,), dtype=img.dtype)

    monkeypatch.setattr(flux_pipeline, "flux_forward", still)
    monkeypatch.setattr(serving, "flux_forward", still)
    assert not _run(tiny, "t-image", monkeypatch)["correct"]
    assert not _run(tiny, "t-serve", monkeypatch)["correct"]


@pytest.mark.parametrize("seed", [11, 12, 2 ** 31 + 5])
def test_half_the_batch_left_out(tiny, monkeypatch, seed):
    """The server's batched step leaves the second half of each forward's
    lanes where they were; the check judges the configuration's own number
    of samples, drawn as a run draws them."""
    from diffusion_rs_tpu_torch import serving

    real = serving.FluxServer._cb_step
    batched = []

    def half(self, flux_params, latents, txts, ys, ts, dts, gs, pe):
        b = dts.shape[0]
        batched.append(b)
        dts = dts.clone()
        dts[(b + 1) // 2:] = 0.0
        return real(self, flux_params, latents, txts, ys, ts, dts, gs, pe)

    monkeypatch.setattr(serving.FluxServer, "_cb_step", half)
    out = _run(tiny, "t-serve", monkeypatch, seed=seed, all_of_them=False)
    assert max(batched) > 1  # the fault had lanes to leave out
    assert not out["correct"]


def test_answer_altered_where_produced(tiny, monkeypatch):
    """The u8 conversion brightens one corner of every image by 24 levels."""
    from diffusion_rs_tpu_torch.pipelines.flux_pipeline import FluxPipeline

    real = FluxPipeline._to_u8

    def altered(img):
        out = real(img).clone()
        h, w = out.shape[1] // 2, out.shape[2] // 2
        out[:, :h, :w] = (out[:, :h, :w].int() + 24).clamp(0, 255).to(out.dtype)
        return out

    monkeypatch.setattr(FluxPipeline, "_to_u8", staticmethod(altered))
    assert not _run(tiny, "t-image", monkeypatch)["correct"]
    assert not _run(tiny, "t-serve", monkeypatch)["correct"]
