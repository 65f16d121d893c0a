"""The training dryrun of the port (diffusion_rs_tpu_torch/dryrun.py) and the
pieces it rests on, in one process on the CPU: ``entry()``'s step against
``__graft_entry__.entry()``'s on the same bf16 params and inputs, the mesh
rule of ``dryrun_multichip``, a world-of-one dryrun, the
DIFFUSION_RS_TPU_NO_FLASH knob (``sdpa``, ``sdpa_merged`` and the fused-RoPE
layouts), and the hand kernels' grad guard (which
raises before any CUDA call, so it is held here too). The dp / sp / tp
training step against ``jax.value_and_grad`` runs in tests/test_torch_mesh.py's
world of 4.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu_torch import dryrun
from diffusion_rs_tpu_torch.ops import _cuda, attention
from torch_port_util import port_params, summed_rel, to_np

OPS = Path(dryrun.__file__).resolve().parent / "ops"


def _jax_entry():
    from __graft_entry__ import entry

    return entry()


def test_entry_step_matches_jax_entry():
    """The port's ``entry()`` step on JAX's ``entry()`` args (bf16 params
    bridged, the same inputs): both return f32 ``img + pred * dt``. bf16
    rounds at other points in the two packages (tests/test_torch_models.py's
    bf16 band): the port's output is no further from JAX's f32 run of the
    same step than JAX's own bf16 run (+25%), and within 3e-2 of it."""
    import jax

    fn_j, args_j = _jax_entry()
    fn_j = jax.jit(fn_j)
    out_j = np.asarray(fn_j(*args_j), np.float32)
    ref = np.asarray(fn_j(*_f32_args(args_j)), np.float32)
    fn_t, _ = dryrun.entry(device="cpu")
    params = port_params(args_j[0])
    ins = [torch.from_numpy(np.asarray(a, np.float32)) for a in args_j[1:]]
    img, txt, y = (t.bfloat16() for t in ins[:3])
    out_t = to_np(fn_t(params, img, txt, y, *ins[3:]))
    assert out_t.shape == out_j.shape == (1, 256, 64)
    assert summed_rel(out_t, ref) <= 1.25 * summed_rel(out_j, ref)
    assert summed_rel(out_t, out_j) <= 3e-2


def _f32_args(args):
    import jax

    return [jax.tree.map(lambda x: x.astype(jnp.float32)
                         if jnp.issubdtype(x.dtype, jnp.floating) else x, a) for a in args]


@pytest.mark.parametrize("n,want", [(1, (1, 1, 1, 2)), (2, (1, 1, 2, 4)), (4, (2, 1, 2, 4)),
                                    (8, (2, 2, 2, 4))])
def test_mesh_rule_matches_jax(n, want):
    """__graft_entry__.py:128-137: dp = sp = 2 when 8 divides n, dp = 2 when
    4 does, tp the rest; heads tp x 2 (tp <= 4)."""
    assert dryrun.mesh_axes(n) == want


def test_dryrun_world_of_one(capsys):
    """``dryrun_multichip(1, "cpu")``: both phases on one rank, JAX's two
    lines printed, a finite loss, no kernel launched, no ring."""
    rec = dryrun.dryrun_multichip(1, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("dryrun_multichip OK: mesh dp=1 sp=1 tp=1, batch 2, loss ")
    assert lines[1].startswith("dryrun_multichip quantized+sp OK: q8t packed plane")
    assert np.isfinite(rec["loss"]) and rec["train_launches"] == {}
    assert rec["ring_hops"] == 0 and rec["out_block"] == (2, 64, 64)


def test_entry_points_default_to_the_card():
    """Without CUDA the dryrun's entry points raise instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        dryrun.entry()
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(8)


@pytest.mark.parametrize("knob", ["", "1"])
def test_no_flash_routes_sdpa_to_xla(monkeypatch, knob):
    """DIFFUSION_RS_TPU_NO_FLASH set: ``sdpa`` and ``sdpa_merged`` take
    ``sdpa_xla`` (read once, ``_no_flash.cache_clear()`` re-reads it); unset,
    the flash path (its plain version on the CPU)."""
    calls = []
    flash = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append("flash") or flash(*a, **kw))
    xla = attention.sdpa_xla
    monkeypatch.setattr(attention, "sdpa_xla",
                        lambda *a, **kw: calls.append("xla") or xla(*a, **kw))
    monkeypatch.setenv("DIFFUSION_RS_TPU_NO_FLASH", knob)
    attention._no_flash.cache_clear()
    try:
        q, k, v = torch.randn(3, 1, 2, 8, 128).unbind(0)
        merged = attention.sdpa_merged(q, k, v)
        plain = attention.sdpa(q, k, v)
    finally:
        monkeypatch.undo()
        attention._no_flash.cache_clear()
    assert calls == (["xla", "xla"] if knob else ["flash", "flash"])
    want = xla(q, k, v)
    torch.testing.assert_close(plain, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(merged, want.transpose(1, 2).reshape(1, 8, 256),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["seqmajor", "inkernel"])
def test_no_flash_routes_fused_rope_layouts_to_xla(monkeypatch, layout):
    """Under DIFFUSION_RS_TPU_NO_FLASH the fused-RoPE layouts skip their
    fused kernels (K6, K7), as JAX's skip them without its flash mode: q/k
    rotate outside and attention takes ``sdpa_xla``, equal to the fused
    kernel's plain version."""
    from diffusion_rs_tpu_torch.models import flux
    from diffusion_rs_tpu_torch.ops import flash
    from diffusion_rs_tpu_torch.ops.rope import expand_rope_tables, rope_tables

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 256), generator=gen) for _ in range(3))
    ids = torch.stack([torch.zeros(8), torch.arange(8.0), torch.zeros(8)], -1)[None]
    ce, se = expand_rope_tables(*rope_tables(ids, (16, 56, 56), 10000))
    want = flash.flash_rope_plain(q, k, v, ce, se, ce, se, 128, 128 ** -0.5)
    calls = []
    xla = attention.sdpa_xla
    monkeypatch.setattr(attention, "sdpa_xla",
                        lambda *a, **kw: calls.append("xla") or xla(*a, **kw))
    monkeypatch.setattr(flux, "flash_attention_fused", None)  # must not be reached
    monkeypatch.setenv("DIFFUSION_RS_TPU_ATTN_LAYOUT", layout)
    monkeypatch.setenv("DIFFUSION_RS_TPU_NO_FLASH", "1")
    attention._no_flash.cache_clear()
    try:
        out = flux._joint_attention_sm(q, k, v, ce, se, head_dim=128)
    finally:
        monkeypatch.undo()
        attention._no_flash.cache_clear()
    assert calls == ["xla"]
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_launch_refuses_inputs_that_require_grad():
    """``_cuda.launch`` checks its operands before any CUDA call: under grad
    mode an operand that requires grad raises ``RuntimeError`` naming the
    wrapper and the knob (the kernel's output would be a constant to
    autograd); under ``no_grad``, or without such an operand, the check
    passes."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="qmm_s8.*no backward.*DIFFUSION_RS_TPU_NO_FLASH"):
        _cuda.launch("qmm_s8", device="cuda", inputs=(torch.zeros(2), x))
    with torch.no_grad():
        _cuda.check_no_grad("qmm_s8", (x,))
    _cuda.check_no_grad("qmm_s8", (torch.zeros(2), None))


@pytest.mark.parametrize("source", ["qmatmul.py", "flash.py"])
def test_every_wrapper_hands_launch_its_operands(source):
    """Every ``_cuda.launch`` call of the kernel wrappers passes
    ``inputs=``, so no wrapper escapes the grad guard."""
    tree = ast.parse((OPS / source).read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "launch"]
    assert len(calls) == {"qmatmul.py": 8, "flash.py": 7}[source]
    assert all(any(kw.arg == "inputs" for kw in c.keywords) for c in calls)
