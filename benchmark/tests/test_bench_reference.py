"""The float32 reference against the port at a tiny size on the CPU: the
FLUX forward in float32 almost exactly; the encoders and the VAE (which the
port runs in their bfloat16 weights' dtype) and the whole image within
bfloat16's reach; the planes' dequantization exactly."""

import copy
import json

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import HERE

from benchmark.harness import planes as P, port
from benchmark.reference import common as C, encoders as E, flux as F, pipeline as R


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(scope="module", params=["tiny-flux-q8t", "tiny-flux-nf4"])
def built(request):
    torch.manual_seed(0)
    cfg = json.loads((HERE / f"{request.param}.json").read_text())
    cfg32 = copy.deepcopy(cfg)
    cfg32["formats"]["activations"] = "float32"
    pl = P.model_planes(cfg, 5, "cpu")
    return cfg, cfg32, pl


def test_dequant_matches_port(built):
    from diffusion_rs_tpu_torch.quant.qtensor import dequantize

    _, _, pl = built
    lin = pl["flux"]["double"]["img_mlp"]["out"]
    ported = port._wrap(lin).w
    assert torch.equal(C.dequant(lin.w, 1), dequantize(ported, torch.float32)[1])


def test_flux_forward_float32(built):
    from diffusion_rs_tpu_torch.models.flux import compute_pe, flux_forward
    from diffusion_rs_tpu_torch.pipelines.sampling import make_img_ids, make_txt_ids

    cfg, cfg32, pl = built
    if cfg["formats"]["flux_linears"] == "q8t":
        pytest.skip("q8t's linears quantize their activations to int8 in the port")
    pipe = port.build_pipeline(cfg32, pl, "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 12, 64, generator=g)
    txt = torch.randn(1, 32, cfg["joint_attention_dim"], generator=g)
    y = torch.randn(1, cfg["pooled_projection_dim"], generator=g)
    t = torch.tensor([0.7])
    with torch.no_grad():
        pe = compute_pe(pipe.flux_cfg, make_txt_ids(1, 32, "cpu"), make_img_ids(1, 4, 3, "cpu"))
        vp = flux_forward(pipe.flux_params, pipe.flux_cfg, x, txt, t, y, None, pe=pe)
        ids = torch.cat([torch.zeros(1, 32, 3), F.img_ids(4, 3, "cpu")], 1)
        cos, sin = F.rope_tables(ids, cfg["axes_dims_rope"])
        vr = F.Flux(cfg, pl["flux"], C.Precision()).forward(x, txt, t, y, None, cos, sin)
    assert rel(pe[0], cos) < 1e-6 and rel(pe[1], sin) < 1e-6
    assert rel(vp, vr) < 1e-4


def test_encoders(built):
    cfg, cfg32, pl = built
    pipe = port.build_pipeline(cfg32, pl, "cpu")
    t5i, cli = R.token_ids(cfg, "a photo of the benchmark", "cpu")
    with torch.no_grad():
        txt, y = pipe._encode(t5i, cli)
        assert rel(txt, E.t5_encode(cfg, pl["t5"], t5i, C.Precision())) < 3e-2
        assert rel(y, E.clip_pooled(cfg, pl["clip"], cli, C.Precision())) < 3e-2


def test_sigmas_match_port(built):
    cfg, cfg32, pl = built
    pipe = port.build_pipeline(cfg32, pl, "cpu")
    for h, w in ((64, 48), (1024, 1024)):
        gp = port.generation_params(cfg, h, w, 1, num_steps=7)
        np.testing.assert_array_equal(pipe._sigmas(gp), R.sigmas(cfg, h, w, 7))


def test_image_against_port(built):
    cfg, _, pl = built
    pipe = port.build_pipeline(cfg, pl, "cpu")
    gp = port.generation_params(cfg, 64, 48, 11)
    with torch.no_grad():
        lat = pipe.forward_arrays(["a b c d e"], gp, output_type="latent")
        img = pipe.forward_arrays(["a b c d e"], gp)[0]
    rl = R.latent(cfg, pl, "a b c d e", 11, 64, 48, "cpu")
    ri = R.decode_u8(cfg, pl, torch.from_numpy(lat), 64, 48)
    assert img.shape == ri.shape == (64, 48, 3) and img.dtype == ri.dtype == np.uint8
    from benchmark.harness.check import latent_rel_err, rel_err

    assert latent_rel_err(lat, rl.numpy()) < 0.03
    assert rel_err(img, ri) < cfg["check"]["decode_rel_err"]
