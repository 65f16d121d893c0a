"""Parity of the port's load path with the JAX package, below the pipeline:
the param trees that io/builders.py makes from the same checkpoint files
(diffusers names with GGUF q4_0 linears; a BFL-named single-file GGUF), the
config derived from BFL keys, and the fused ``qkv`` / ``qkv_mlp`` FLUX
forward at slice 1's tiny config (hidden 256, 2 heads of 128, so every
fused linear takes K4's full-size dispatch; JAX Pallas in interpret mode,
the port's plain versions on the CPU).
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.io import builders as jb
from diffusion_rs_tpu.io.gguf import GgufFile as JGgufFile, write_gguf as j_write_gguf
from diffusion_rs_tpu.io.safetensors import SafeTensors as JSafeTensors
from diffusion_rs_tpu.io.varstore import VarStore as JVarStore
from diffusion_rs_tpu.models import flux as jflux
from diffusion_rs_tpu.models.optimize import fuse_flux_qkv
from diffusion_rs_tpu.quant.gguf_quants import ENCODERS
from diffusion_rs_tpu.quant.qtensor import quantize_q4_0
from diffusion_rs_tpu_torch.io import builders as tb
from diffusion_rs_tpu_torch.io.gguf import GgufFile as TGgufFile
from diffusion_rs_tpu_torch.io.varstore import VarStore as TVarStore
from diffusion_rs_tpu_torch.models import flux as tflux
from diffusion_rs_tpu_torch.ops import _cuda
from diffusion_rs_tpu_torch.ops.conv import Conv
from diffusion_rs_tpu_torch.ops.linear import Linear
from diffusion_rs_tpu_torch.pipelines.loader import load_flux_transformer
from diffusion_rs_tpu_torch.quant.qtensor import QuantizedTensor
from synth import write_checkpoint
from torch_port_util import (  # noqa: F401
    jax_kernels_interpreted, port_params, quantize_tree, summed_rel, to_np)


def assert_trees_equal(a, b, path="root"):
    """Two port trees: same structure, meta and exactly equal tensors."""
    assert type(a) is type(b), f"{path}: {type(a)} vs {type(b)}"
    if a is None:
        return
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape), path
        assert torch.equal(a, b), path
    elif isinstance(a, QuantizedTensor):
        for f in dataclasses.fields(a):
            assert_trees_equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (Linear, Conv)):
        for f in dataclasses.fields(a):
            assert_trees_equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _diffusers_to_bfl(st) -> dict:
    """Rename a tiny synth transformer's tensors to the original BFL layout
    (fused qkv / linear1, swapped final-AdaLN halves): what city96-style
    single-file FLUX GGUFs contain. A copy of tests/test_pipeline_e2e.py's
    helper."""
    t = {n: np.asarray(st.numpy(n)) for n in st.keys()}
    out = {}

    def mv(src, dst):
        for s in (".weight", ".bias"):
            if src + s in t:
                out[dst + s] = t[src + s]

    def fuse(srcs, dst):
        out[dst + ".weight"] = np.concatenate([t[s + ".weight"] for s in srcs], axis=0)
        out[dst + ".bias"] = np.concatenate([t[s + ".bias"] for s in srcs])

    mv("x_embedder", "img_in")
    mv("context_embedder", "txt_in")
    mv("time_text_embed.timestep_embedder.linear_1", "time_in.in_layer")
    mv("time_text_embed.timestep_embedder.linear_2", "time_in.out_layer")
    mv("time_text_embed.text_embedder.linear_1", "vector_in.in_layer")
    mv("time_text_embed.text_embedder.linear_2", "vector_in.out_layer")
    mv("time_text_embed.guidance_embedder.linear_1", "guidance_in.in_layer")
    mv("time_text_embed.guidance_embedder.linear_2", "guidance_in.out_layer")
    mv("proj_out", "final_layer.linear")
    w = t["norm_out.linear.weight"]
    h = w.shape[0] // 2
    out["final_layer.adaLN_modulation.1.weight"] = np.concatenate([w[h:], w[:h]], axis=0)
    b = t["norm_out.linear.bias"]
    out["final_layer.adaLN_modulation.1.bias"] = np.concatenate([b[h:], b[:h]])
    i = 0
    while f"transformer_blocks.{i}.norm1.linear.weight" in t:
        p, q = f"transformer_blocks.{i}", f"double_blocks.{i}"
        mv(f"{p}.norm1.linear", f"{q}.img_mod.lin")
        mv(f"{p}.norm1_context.linear", f"{q}.txt_mod.lin")
        fuse([f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v"], f"{q}.img_attn.qkv")
        fuse([f"{p}.attn.add_q_proj", f"{p}.attn.add_k_proj", f"{p}.attn.add_v_proj"],
             f"{q}.txt_attn.qkv")
        mv(f"{p}.attn.to_out.0", f"{q}.img_attn.proj")
        mv(f"{p}.attn.to_add_out", f"{q}.txt_attn.proj")
        mv(f"{p}.ff.net.0.proj", f"{q}.img_mlp.0")
        mv(f"{p}.ff.net.2", f"{q}.img_mlp.2")
        mv(f"{p}.ff_context.net.0.proj", f"{q}.txt_mlp.0")
        mv(f"{p}.ff_context.net.2", f"{q}.txt_mlp.2")
        out[f"{q}.img_attn.norm.query_norm.scale"] = t[f"{p}.attn.norm_q.weight"]
        out[f"{q}.img_attn.norm.key_norm.scale"] = t[f"{p}.attn.norm_k.weight"]
        out[f"{q}.txt_attn.norm.query_norm.scale"] = t[f"{p}.attn.norm_added_q.weight"]
        out[f"{q}.txt_attn.norm.key_norm.scale"] = t[f"{p}.attn.norm_added_k.weight"]
        i += 1
    i = 0
    while f"single_transformer_blocks.{i}.proj_out.weight" in t:
        p, q = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        fuse([f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v", f"{p}.proj_mlp"],
             f"{q}.linear1")
        mv(f"{p}.proj_out", f"{q}.linear2")
        mv(f"{p}.norm.linear", f"{q}.modulation.lin")
        out[f"{q}.norm.query_norm.scale"] = t[f"{p}.attn.norm_q.weight"]
        out[f"{q}.norm.key_norm.scale"] = t[f"{p}.attn.norm_k.weight"]
        i += 1
    return out


def write_bfl_gguf(base_dir, path, quant: str = "q4_0"):
    """The base checkpoint's transformer as a BFL-named single-file GGUF:
    every linear whose K divides by 32 in ``quant``, the rest (and biases,
    norm scales) f32 (tests/synth.py:165-187's rule)."""
    st = JSafeTensors.from_file(str(base_dir / "transformer" / "diffusion_pytorch_model.safetensors"))
    tensors = {}
    for name, a in _diffusers_to_bfl(st).items():
        a = np.ascontiguousarray(a, np.float32)
        if name.endswith(".weight") and a.ndim == 2 and a.shape[1] % 32 == 0 \
                and "norm" not in name:
            tensors[name] = (quant, a.shape, ENCODERS[quant](a))
        else:
            tensors[name] = ("f32", a.shape, a.tobytes())
    j_write_gguf(str(path), tensors, metadata={"general.name": f"flux-tiny-bfl-{quant}"})
    return path


@pytest.fixture(scope="module")
def dev_ckpt(tmp_path_factory):
    """A dev-style (guidance embedder, dynamic shift) dense synth checkpoint."""
    return write_checkpoint(tmp_path_factory.mktemp("dev"), seed=0, guidance=True,
                            dynamic_shifting=True)


def test_build_flux_params_diffusers_gguf_q4_0_matches_jax(tmp_path):
    """A diffusers-named transformer with GGUF q4_0 linears: the port's tree
    equals the JAX tree carried over by the bridge, tensor for tensor."""
    root = write_checkpoint(tmp_path / "g", seed=0, quant="gguf_q4_0", guidance=True)
    path = root / "transformer" / "diffusion_pytorch_model.gguf"
    cfg_json = json.loads((root / "transformer" / "config.json").read_text())
    js = JVarStore(default_dtype=jnp.bfloat16)
    js.add_gguf(JGgufFile(str(path)))
    ts = TVarStore(default_dtype=torch.bfloat16, device="cpu")
    ts.add_gguf(TGgufFile(str(path)))
    jt = jb.build_flux_params(js, jflux.FluxConfig.from_json(cfg_json))
    tt = tb.build_flux_params(ts, tflux.FluxConfig.from_json(cfg_json))
    assert not tb.is_bfl_naming(ts)
    assert tt["double"]["img_attn"]["q"].w.kind == "q4_0"
    assert_trees_equal(tt, port_params(jt))


@pytest.mark.parametrize("quant", ["q4_0", "q8_0"])
def test_bfl_single_file_matches_jax(dev_ckpt, tmp_path, quant):
    """A BFL-named single-file GGUF: the same derived config, and the same
    fused tree (qkv, qkv_mlp, final-AdaLN halves swapped back)."""
    path = write_bfl_gguf(dev_ckpt, tmp_path / f"flux-{quant}.gguf", quant)
    base_json = json.loads((dev_ckpt / "transformer" / "config.json").read_text())
    js = JVarStore(default_dtype=jnp.bfloat16)
    js.add_gguf(JGgufFile(str(path)))
    jcfg = jb.flux_config_from_bfl(js, base=jflux.FluxConfig.from_json(base_json))
    jt = jb.build_flux_params(js, jcfg)
    tt, tcfg = load_flux_transformer(path, tflux.FluxConfig.from_json(base_json),
                                     device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.num_layers == 2 and tcfg.num_single_layers == 2 and tcfg.guidance_embeds
    assert tt["double"]["img_attn"]["qkv"].w.kind == quant
    assert "qkv_mlp" in tt["single"] and "q" not in tt["single"]
    assert_trees_equal(tt, port_params(jt))


TINY = dict(in_channels=64, pooled_projection_dim=64, joint_attention_dim=128,
            num_attention_heads=2, num_layers=1, num_single_layers=2,
            guidance_embeds=True, hidden_size=256, axes_dim=(16, 56, 56))


def _fused_inputs(rng):
    h2 = w2 = 4
    rows, cols = np.meshgrid(np.arange(h2), np.arange(w2), indexing="ij")
    img_ids = np.stack([np.zeros_like(rows), rows, cols], -1).reshape(1, -1, 3)
    return dict(img=rng.standard_normal((1, h2 * w2, 64)).astype(np.float32),
                txt=rng.standard_normal((1, 8, 128)).astype(np.float32),
                t=np.array([0.7], np.float32),
                y=rng.standard_normal((1, 64)).astype(np.float32),
                g=np.array([3.5], np.float32),
                txt_ids=np.zeros((1, 8, 3), np.float32),
                img_ids=img_ids.astype(np.float32))


def _fused_pair(dtype, inp):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jflux.FluxConfig(**TINY)
    jp = quantize_tree(jflux.init_flux_params(jax.random.PRNGKey(0), jcfg),
                       quantize_q4_0, jd)
    jp = fuse_flux_qkv(jp, ("img", "txt", "single"))
    tp = port_params(jp)
    assert tp["double"]["img_attn"]["qkv"].w.shape == (256, 768)
    assert tp["single"]["qkv_mlp"].w.shape == (256, 3 * 256 + 1024)
    out_j = jflux.flux_forward(
        jp, jcfg, jnp.asarray(inp["img"], jd), jnp.asarray(inp["txt"], jd),
        jnp.asarray(inp["t"]), jnp.asarray(inp["y"], jd), jnp.asarray(inp["g"]),
        txt_ids=jnp.asarray(inp["txt_ids"]), img_ids=jnp.asarray(inp["img_ids"]))
    out_t = tflux.flux_forward(
        tp, tflux.FluxConfig(**TINY), torch.from_numpy(inp["img"]).to(td),
        torch.from_numpy(inp["txt"]).to(td), torch.from_numpy(inp["t"]),
        torch.from_numpy(inp["y"]).to(td), torch.from_numpy(inp["g"]),
        txt_ids=torch.from_numpy(inp["txt_ids"]), img_ids=torch.from_numpy(inp["img_ids"]))
    assert tuple(out_t.shape) == (1, 16, 64) and out_t.dtype == td
    return np.asarray(out_j, np.float32), to_np(out_t)


def test_fused_flux_forward_f32_matches_jax(rng, jax_kernels_interpreted, monkeypatch):
    """The fused q4_0 tree in f32, every linear but final.proj (N=64) through
    K4's dispatch: within the near-exact qmm band 1e-5 of the JAX forward."""
    tlinear_mod = importlib.import_module("diffusion_rs_tpu_torch.ops.linear")
    calls = []
    real = tlinear_mod.quantized_matmul

    def spy(x, qt, *a):
        calls.append(qt.kind)
        return real(x, qt, *a)

    monkeypatch.setattr(tlinear_mod, "quantized_matmul", spy)
    out_j, out_t = _fused_pair("float32", _fused_inputs(rng))
    # 8 embedders + 10 per double block + 3 per single block + final.mod
    assert calls == ["q4_0"] * (8 + 10 * 1 + 3 * 2 + 1)
    assert summed_rel(out_t, out_j) <= 1e-5
    assert _cuda.launch_counts()["qmm_affine"] == 0  # plain versions on the CPU


def test_fused_flux_forward_bf16_as_close_as_jax(rng, jax_kernels_interpreted):
    """bf16, the working dtype, with the band of tests/test_torch_models.py:
    the port no further from the f32 result than JAX's own bf16 run (+25%),
    and within 3e-2 of it."""
    inp = _fused_inputs(rng)
    ref, _ = _fused_pair("float32", inp)
    out_j, out_t = _fused_pair("bfloat16", inp)
    assert summed_rel(out_t, ref) <= 1.25 * summed_rel(out_j, ref)
    assert summed_rel(out_t, out_j) <= 3e-2
