"""The port's (dp, sp, tp) mesh against the JAX package: the tiny FLUX
forward of tests/test_partitioned.py at dp=2 sp=2 (a spawned gloo world of
4), in the default layout and the fused-RoPE one, against JAX's
``flux_forward``; the tiny ``Pipeline(mesh=make_mesh(dp=2, sp=2))`` against
the JAX ``Pipeline`` on a 4-device mesh of the virtual CPU mesh, with
``Offloading.Full`` against itself without it, and its img2img and inpaint
against the port's single-process pipeline; and the
mesh's own rules (tp and world-size checks, ``grouped`` turned off).
"""

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
from diffusion_rs_tpu.parallel import make_mesh as j_make_mesh
from diffusion_rs_tpu.pipelines.sampling import get_noise as j_get_noise
from diffusion_rs_tpu.pipelines.sampling import make_img_ids, make_txt_ids
from diffusion_rs_tpu_torch.bridge import from_numpy_tree
from diffusion_rs_tpu_torch.parallel import make_mesh, spawn
from synth import write_checkpoint
from diffusion_rs_tpu_torch.models.flux import FluxConfig as TFluxConfig
from diffusion_rs_tpu_torch.util.synthetic import init_flux_params
from torch_mesh_workers import _digest, mesh_rank
from torch_port_util import to_jax_tree, to_numpy_tree

# tests/test_partitioned.py's FLUX: 60 image + 4 text tokens
FLUX = dict(in_channels=16, pooled_projection_dim=32, joint_attention_dim=24,
            num_attention_heads=4, num_layers=1, num_single_layers=1,
            guidance_embeds=False, hidden_size=64, axes_dim=(8, 4, 4))
# tests/test_pipeline_e2e.py:35-47 and :409-415
GEN = dict(height=64, width=64, num_steps=2, guidance_scale=3.5, seed=42)
PROMPTS = ["a photo", "a dog"]


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

    spawn(mesh_rank, 4, "gloo", args=(str(tmp),))
    return {"flux": (ref, _digest(from_numpy_tree(tree, "cpu")),
                     [np.load(tmp / f"flux_{r}.npz") for r in range(4)]),
            "pipeline": (images, latents, digest,
                         [np.load(tmp / f"pipe_{r}.npz") for r in range(4)]),
            "img2img": (tmp, [np.load(tmp / f"i2i_{r}.npz") for r in range(4)])}


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


def test_img2img_inpaint_dp2_sp2_match_single_process(mesh_run, monkeypatch):
    """img2img (strength 0.5) and inpaint (0.75) under dp=2 sp=2: each rank
    prepares and encodes its dp row, keeps its rows of the whole batch's
    encoder sample, and cuts the inpaint planes to its sp rows as it cuts the
    image tokens; every rank's latents equal the port's single-process ones
    within the mesh pipeline's band (rtol/atol 0.05; measured max-abs 1.9e-2
    and 2.2e-2 on latents up to 4.9: bf16, the ring's merges), the same on
    every rank."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams as TParams
    from diffusion_rs_tpu_torch.pipelines import flux_pipeline
    from diffusion_rs_tpu_torch.pipelines.api import ModelSource, Pipeline

    tmp, ranks = mesh_run["img2img"]
    noise = torch.from_numpy(np.load(tmp / "noise.npy"))
    monkeypatch.setattr(flux_pipeline, "get_noise", lambda seed, n, h, w, device: noise.clone())
    inp = np.load(tmp / "i2i.npz")
    pipe = Pipeline(ModelSource.from_model_id(str(tmp / "ckpt")), silent=True, device="cpu")
    images, params = list(inp["images"]), TParams(**GEN)
    want = {"img2img": pipe._inner.forward_arrays(PROMPTS, params, init_image=images,
                                                  strength=0.5, output_type="latent"),
            "inpaint": pipe._inner.forward_arrays(PROMPTS, params, init_image=images,
                                                  strength=0.75, mask_image=inp["mask"],
                                                  output_type="latent")}
    for r in ranks:
        for mode, lat in want.items():
            np.testing.assert_array_equal(r[mode], ranks[0][mode])
            np.testing.assert_allclose(r[mode], lat, rtol=0.05, atol=0.05)


def test_make_mesh_tp_raises():
    """tp > 1 is not ported: the error names its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        make_mesh(tp=2, device="cpu")


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2)])
def test_make_mesh_world_mismatch_raises(dp, sp):
    """dp * sp * tp must be the world size (one here: no process group)."""
    with pytest.raises(ValueError, match=r"world_size\(1\)"):
        make_mesh(dp=dp, sp=sp, tp=1, device="cpu")


def test_world_of_one_mesh():
    """Without a process group: a 1x1x1 mesh, no groups, the given device."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1} and mesh.coords == {"dp": 0, "sp": 0, "tp": 0}
    assert mesh.groups == {"dp": None, "sp": None, "tp": None}
    assert mesh.device == torch.device("cpu")
