"""Guards on the PyTorch port's boundaries: it imports neither jax nor the
JAX package, its default-device entry points refuse to run without CUDA
instead of moving to the CPU, and its kernel wrappers import (and run their
plain versions on CPU tensors) without nvcc."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "diffusion_rs_tpu_torch"


def _port_modules():
    return sorted(p for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "diffusion_rs_tpu"
            or name.startswith("diffusion_rs_tpu."))


@pytest.mark.parametrize("path", _port_modules(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_workers.py"],
                         ids=lambda p: p.name)
def test_card_scripts_import_no_jax(path):
    """The smoke run and the spawned ranks' module run on the card host,
    which has no JAX: neither imports jax or the JAX package."""
    test_port_module_imports_no_jax(path)


def test_port_import_leaves_jax_unloaded():
    """Every module of the package, imported in a fresh interpreter, loads
    neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusion_rs_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'diffusion_rs_tpu' or m.startswith('diffusion_rs_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('diffusion_rs_tpu_torch')]))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    # the walk reached every module, the loaders and the GGUF code included
    assert int(r.stdout.split()[-1]) == len(_port_modules())


def test_loader_import_loads_no_jax_or_ml_dtypes():
    """The load path (loader, builders, GGUF/safetensors readers) imported
    in a fresh interpreter loads neither jax, the JAX package, nor
    ml_dtypes (bf16 is read through torch)."""
    code = (
        "import sys\n"
        "import diffusion_rs_tpu_torch.pipelines.loader\n"
        "import diffusion_rs_tpu_torch.pipelines.api\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'diffusion_rs_tpu', 'ml_dtypes')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the guard is for CUDA-less hosts")
    from diffusion_rs_tpu_torch import FluxPipeline
    from diffusion_rs_tpu_torch.bridge import from_numpy_tree
    from diffusion_rs_tpu_torch.models.clip import ClipTextConfig
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.models.vae import VAEConfig
    from diffusion_rs_tpu_torch.io.varstore import VarStore
    from diffusion_rs_tpu_torch.parallel import make_mesh
    from diffusion_rs_tpu_torch.pipelines.api import ModelSource, Pipeline
    from diffusion_rs_tpu_torch.pipelines.loader import load_flux_transformer, load_pipeline
    from diffusion_rs_tpu_torch.util import synthetic as syn

    gen = torch.Generator()
    calls = [
        lambda: syn.random_qtensor(gen, 256, 128),
        lambda: syn.random_qtensor(gen, 256, 128, kind="q4_0"),
        lambda: syn.init_flux_params_quantized(0, FluxConfig(), kind="q8_0", layout="bfl"),
        lambda: syn.init_flux_params_quantized(0, FluxConfig()),
        lambda: syn.init_t5_params_quantized(0, T5Config()),
        lambda: syn.init_clip_params(0, ClipTextConfig()),
        lambda: syn.init_vae_decoder_params(0, VAEConfig()),
        lambda: syn.init_flux_params(0, FluxConfig()),
        lambda: syn.init_t5_params(0, T5Config()),
        lambda: from_numpy_tree({"w": np.zeros((2, 2), np.float32)}),
        lambda: FluxPipeline(flux_params=None, flux_cfg=FluxConfig(), t5_params=None,
                             t5_cfg=T5Config(), clip_params=None,
                             clip_cfg=ClipTextConfig(), vae_params=None,
                             vae_cfg=VAEConfig(), scheduler=None, t5_tokenizer=None,
                             clip_tokenizer=None),
        lambda: VarStore(),
        lambda: load_pipeline(ModelSource.from_model_id(str(ROOT / "no-such-model"))),
        lambda: Pipeline(ModelSource.from_model_id(str(ROOT / "no-such-model"))),
        lambda: load_flux_transformer(ROOT / "no-such-file.gguf"),
        lambda: make_mesh(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_kernel_wrappers_work_without_nvcc(tmp_path):
    """No nvcc on PATH or under CUDA_HOME: the wrappers import, run their
    plain versions on CPU tensors, and build nothing; only an attempt to
    build says that nvcc is missing."""
    code = (
        "import torch\n"
        "from diffusion_rs_tpu_torch.ops import _cuda, flash, qmatmul\n"
        "from diffusion_rs_tpu_torch.util.synthetic import random_qtensor\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x = torch.randn(3, 256, generator=g)\n"
        "for kind in ('q8t', 'nf4', 'q4_0', 'q8_0'):\n"
        "    qmatmul.quantized_matmul(x, random_qtensor(g, 256, 128, kind=kind, device='cpu'))\n"
        "    qmatmul.quantized_matmul(x.bfloat16(), random_qtensor(g, 256, 128, kind=kind,\n"
        "                                                          device='cpu'))\n"
        "    qmatmul.quantized_matmul(x.bfloat16(), random_qtensor(g, 256, 128, kind=kind,\n"
        "                                                          device='cpu'), torch.float32)\n"
        "    qts = [random_qtensor(g, 256, 128, kind=kind, device='cpu') for _ in range(2)]\n"
        "    qmatmul.quantized_matmul_grouped([x, x[:1]], qts)\n"
        "q = torch.randn(1, 1, 5, 128, generator=g)\n"
        "flash.flash_attention(q, q, q, out_seqmajor=True)\n"
        "for s8, s8_pv in ((True, False), (False, True), (True, True)):\n"
        "    flash.flash_attention(q, q, q, out_seqmajor=True, s8=s8, s8_pv=s8_pv)\n"
        "    flash.flash_attention(q, q, q, s8=s8, s8_pv=s8_pv, save_lse=True)\n"
        "flash.flash_attention(q, q, q, save_lse=True)\n"
        "flash.quantize_kv(q, q, 128)\n"
        "qs = torch.randn(1, 5, 256, generator=g)\n"
        "ce = torch.ones(1, 5, 128)\n"
        "for inkernel in (False, True):\n"
        "    flash.flash_attention_fused(qs, qs, qs, ce, ce, 128, rope_in_kernel=inkernel)\n"
        "from diffusion_rs_tpu_torch.ops.rope import qk_norm_rope\n"
        "w = torch.ones(128, dtype=torch.bfloat16)\n"
        "qb = qs.bfloat16()\n"
        "qk_norm_rope([(qb, qb, qb, w, w)], ce[..., :64], ce[..., :64], 2)\n"
        "assert not _cuda.BUILD_DIR.exists(), _cuda.BUILD_DIR\n"
        "assert _cuda.launch_counts() == dict.fromkeys(_cuda.KERNELS, 0)\n"
        "assert set(_cuda.KERNELS) == {'qmm_s8', 'qmm_grouped_s8', 'qmm_nf4',\n"
        "                              'qmm_grouped_nf4', 'qmm_nf4_fast16', 'qmm_affine',\n"
        "                              'qmm_grouped_affine', 'qmm_affine_fast16',\n"
        "                              'flash_fwd', 'flash_sm', 'flash_rope', 'flash_s8',\n"
        "                              'flash_s8pv', 'flash_s8_s8pv', 'flash_fwd_lse',\n"
        "                              'flash_s8_lse', 'flash_s8pv_lse', 'flash_s8_s8pv_lse',\n"
        "                              'rope_qk', 'flash_quant', 'qmm_s8_f32', 'qmm_nf4_f32',\n"
        "                              'qmm_nf4_fast16_f32', 'qmm_affine_f32',\n"
        "                              'qmm_affine_fast16_f32', 'qk_norm_rope'}\n"
        "try:\n"
        "    _cuda.build_all()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('build_all ran without nvcc')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               DIFFUSION_RS_TORCH_BUILD=str(tmp_path / "build"),
               DIFFUSION_RS_TPU_QMM_FAST16="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cuda_path_has_no_fallback():
    """A wrapper given a tensor that is not on the CPU launches or raises:
    the dispatch never sends a CUDA tensor to a plain version. Checked on
    the 'meta' device, which is not the CPU."""
    from diffusion_rs_tpu_torch.ops import flash, qmatmul
    from diffusion_rs_tpu_torch.quant.qtensor import QuantizedTensor

    qt = QuantizedTensor(packed=torch.zeros((256, 128), dtype=torch.int8),
                         scale=torch.ones((1, 128)), bias=None, codebook=None,
                         kind="q8t", bits=8, group=256, split=256, shape=(256, 128),
                         out_dtype="bfloat16")
    x = torch.zeros((4, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul.qmm_s8(x, qt, torch.bfloat16)
    q = torch.zeros((1, 1, 8, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, q, q, out_seqmajor=True)
    # the int8 modes (K9, K10, both)
    for s8, s8_pv in ((True, False), (False, True), (True, True)):
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_attention(q, q, q, out_seqmajor=True, s8=s8, s8_pv=s8_pv)
    # K14, bf16 and the int8 modes
    for s8, s8_pv in ((False, False), (True, False), (False, True), (True, True)):
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_attention(q, q, q, s8=s8, s8_pv=s8_pv, save_lse=True)
    # the int8 modes' prepass kernel, for k, v or both
    for k, v in ((q, None), (None, q), (q, q)):
        with pytest.raises(ValueError, match="CUDA"):
            flash.quantize_kv(k, v, 128)
    # the seq-major kernels (K6, K7) under both RoPE placements
    qs = torch.zeros((1, 8, 256), dtype=torch.bfloat16, device="meta")
    ce = torch.zeros((1, 8, 128), device="meta")
    for inkernel in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_attention_fused(qs, qs, qs, ce, ce, 128, rope_in_kernel=inkernel)
    # an affine format (GGUF q4_0) takes K4, whose wrapper raises off the card
    q4 = dataclasses.replace(qt, packed=torch.zeros((128, 128), dtype=torch.uint8),
                             bias=torch.zeros((1, 128)), kind="q4_0", bits=4)
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul.quantized_matmul(x, q4)
    # grouped nf4 takes K11, whose wrapper raises off the card
    nf4 = dataclasses.replace(qt, packed=torch.zeros((128, 128), dtype=torch.uint8),
                              scale=torch.ones((4, 128)), codebook=torch.zeros(16),
                              kind="nf4", bits=4, group=64)
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul.quantized_matmul_grouped([x, x], [nf4, nf4])
