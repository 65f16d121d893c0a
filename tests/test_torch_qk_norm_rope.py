"""ops/rope.qk_norm_rope, a FLUX block's attention prologue in the default
layout: its plain route against the composition the blocks ran before it
(per stream the head split and QK-RMSNorm, the joint cat, RoPE, contiguous
operands) bit for bit; the kernel wrapper's launch arguments and what it
refuses before any launch (another head dim, dtype or alignment, an operand
that requires grad); and the blocks' explicit choice of the plain
composition (DIFFUSION_RS_TPU_NO_FLASH, head dims other than 128). The
kernel itself is held to the plain route on the card
(tests/test_torch_cuda.py, ``-k qk_norm_rope``)."""

import pytest
import torch

from diffusion_rs_tpu_torch.dryrun import tiny_cfg, xla_attention
from diffusion_rs_tpu_torch.models import flux
from diffusion_rs_tpu_torch.ops import _cuda, apply_rope, rms_norm, rope_tables
from diffusion_rs_tpu_torch.ops import rope

S_TXT, S_IMG, MLP = 8, 24, 256


def _composition(streams, cos, sin, n_heads):
    """models/flux.py's prologue before the op: ``_qkv`` per stream, the
    joint ``torch.cat`` of a double block, then ``_rope_qk``."""
    def split(t):
        b, s, _ = t.shape
        return t.reshape(b, s, n_heads, -1).transpose(1, 2)

    normed = [(rms_norm(split(qc), qn), rms_norm(split(kc), kn), split(vc))
              for qc, kc, vc, qn, kn in streams]
    if len(normed) == 2:
        (tq, tk, tv), (iq, ik, iv) = normed
        q, k, v = (torch.cat([tq, iq], dim=2), torch.cat([tk, ik], dim=2),
                   torch.cat([tv, iv], dim=2))
    else:
        q, k, v = normed[0]
    return (apply_rope(q, cos, sin).contiguous(), apply_rope(k, cos, sin).contiguous(),
            v.contiguous())


def _columns(g, b, s, n, strided, single):
    """q, k, v columns [b, s, n] bf16: three linear outputs, or column
    slices of a fused qkv (double) / qkv_mlp (single) projection."""
    if not strided:
        return tuple(torch.randn((b, s, n), generator=g).bfloat16() for _ in range(3))
    fused = torch.randn((b, s, 3 * n + (MLP if single else 0)), generator=g).bfloat16()
    return fused[..., :n], fused[..., n:2 * n], fused[..., 2 * n:3 * n]


def _scales(g):
    return tuple((0.5 + torch.rand(rope.HEAD_DIM, generator=g)).bfloat16() for _ in range(2))


def _tables(g, b, s):
    ids = torch.randint(0, 64, (b, s, 3), generator=g)
    return rope_tables(ids, (16, 56, 56))


def _launch_args(monkeypatch, streams, cos, sin, heads):
    """The arguments :func:`rope.qk_norm_rope_cuda` hands ``_cuda.launch``
    for these operands, without a build or a launch."""
    seen = []
    monkeypatch.setattr(rope._cuda, "launch", lambda name, *a, **kw: seen.append((name, a)))
    rope.qk_norm_rope_cuda(streams, cos, sin, heads)
    (name, args), = seen
    assert name == "qk_norm_rope"
    return args


def _streams(g, kind, b, n, strided):
    rows = (S_TXT, S_IMG) if kind == "double" else (S_TXT + S_IMG,)
    return [(*_columns(g, b, s, n, strided, kind == "single"), *_scales(g)) for s in rows]


@pytest.mark.parametrize("tables", ["shared", "per_sample"])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("heads", [24, 12])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("kind", ["double", "single"])
def test_plain_route_equals_the_blocks_composition(monkeypatch, kind, b, heads, strided,
                                                  tables):
    """Double (txt then img) and single blocks, batch 1 and 2, FLUX.1-dev's
    heads and a tp rank's, linear outputs and fused-projection column views,
    tables shared over the batch or per sample, non-unit QK-norm scales:
    the op on the CPU equals the old composition bit for bit, as contiguous
    [B, H, S, 128] tensors, and the kernel wrapper takes these operands,
    with one argument for each of the entry's C parameters but the
    stream."""
    g = torch.Generator().manual_seed(1000 * b + heads + strided)
    streams = _streams(g, kind, b, heads * rope.HEAD_DIM, strided)
    cos, sin = _tables(g, 1 if tables == "shared" else b, S_TXT + S_IMG)
    before = _cuda.launch_counts()
    got = rope.qk_norm_rope(streams, cos, sin, heads)
    assert _cuda.launch_counts() == before
    want = _composition(streams, cos, sin, heads)
    for x, y in zip(got, want):
        assert x.shape == (b, heads, S_TXT + S_IMG, rope.HEAD_DIM) and x.is_contiguous()
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
    args = _launch_args(monkeypatch, streams, cos, sin, heads)
    assert len(args) == len(_cuda.KERNELS["qk_norm_rope"][1]) - 1


def test_grad_mode_plain_on_the_cpu_refused_by_the_kernel():
    """Under grad mode with an operand that requires grad: on the CPU the op
    is the plain composition, differentiable (no launch; the gradient
    reaches the projection columns and the scales); the kernel wrapper
    raises (it has no backward) before any launch, and runs the same
    operands under no_grad."""
    g = torch.Generator().manual_seed(7)
    streams = _streams(g, "double", 1, 2 * rope.HEAD_DIM, False)
    cos, sin = _tables(g, 1, S_TXT + S_IMG)
    leaves = [t.detach().requires_grad_() for t in streams[1]]
    streams = [streams[0], tuple(leaves)]
    before = _cuda.launch_counts()
    q, k, v = rope.qk_norm_rope(streams, cos, sin, 2)
    with pytest.raises(RuntimeError, match="qk_norm_rope.*no backward"):
        rope.qk_norm_rope_cuda(streams, cos, sin, 2)
    assert _cuda.launch_counts() == before
    (q.float().sum() + k.float().sum() + v.float().sum()).backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)
    with torch.no_grad():
        want = _composition(streams, cos, sin, 2)
    assert all(torch.equal(x.detach(), y) for x, y in zip((q, k, v), want))


@pytest.mark.parametrize("head_dim,dtype,error", [(64, torch.bfloat16, NotImplementedError),
                                                  (256, torch.bfloat16, NotImplementedError),
                                                  (128, torch.float32, ValueError)])
def test_other_head_dims_and_dtypes(head_dim, dtype, error):
    """A head dim other than 128, or f32 operands: the op on the CPU is the
    old composition; the kernel wrapper refuses them before any launch
    (NotImplementedError for the head dim, as the flash kernels raise it,
    ValueError for the dtype)."""
    g = torch.Generator().manual_seed(head_dim)
    heads = 3
    streams = [tuple(t.to(dtype) for t in stream)
               for stream in _streams(g, "double", 2, heads * head_dim, True)]
    streams = [(*stream[:3], *(torch.rand(head_dim, generator=g).to(dtype) + 0.5
                               for _ in range(2))) for stream in streams]
    ids = torch.randint(0, 64, (2, S_TXT + S_IMG, 3), generator=g)
    cos, sin = rope_tables(ids, (head_dim // 4, head_dim // 4, head_dim // 2))
    before = _cuda.launch_counts()
    got = rope.qk_norm_rope(streams, cos, sin, heads)
    with pytest.raises(error, match="qk_norm_rope"):
        rope.qk_norm_rope_cuda(streams, cos, sin, heads)
    assert _cuda.launch_counts() == before
    want = _composition(streams, cos, sin, heads)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("case", ["kernel", "no_flash", "head_dim_32"])
def test_blocks_choose_the_plain_prologue_explicitly(monkeypatch, case):
    """models/flux.py's default-layout blocks take the op (the kernel on the
    card) unless attention runs without the flash kernels
    (DIFFUSION_RS_TPU_NO_FLASH, as the training step sets it) or the head
    dim is not 128; then they call the plain composition themselves."""
    called = []
    monkeypatch.setattr(flux, "qk_norm_rope", lambda *a: called.append("op"))
    monkeypatch.setattr(flux, "qk_norm_rope_plain", lambda *a: called.append("plain"))
    cfg = tiny_cfg() if case == "head_dim_32" else flux.FluxConfig()
    assert (cfg.head_dim == rope.HEAD_DIM) == (case != "head_dim_32")
    if case == "no_flash":
        with xla_attention():
            flux._qk_prologue([], None, None, 24, cfg)
    else:
        flux._qk_prologue([], None, None, 24, cfg)
    assert called == ["op" if case == "kernel" else "plain"]


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """The launch wrapper checks its operands before any launch (so no
    build): a misaligned column view, tables of the wrong length, scales of
    another dtype, and scales or tables whose contiguous view starts off
    16-byte alignment (the kernel reads them 16 bytes at a time)."""
    g = torch.Generator().manual_seed(3)
    streams = _streams(g, "single", 1, 2 * rope.HEAD_DIM, False)
    cos, sin = _tables(g, 1, S_TXT + S_IMG)
    qc, kc, vc, qn, kn = streams[0]
    wide = torch.randn((1, S_TXT + S_IMG, 2 * rope.HEAD_DIM + 4), generator=g).bfloat16()
    shifted = torch.empty(rope.HEAD_DIM + 1, dtype=torch.bfloat16)[1:]  # 2 bytes in
    shifted.copy_(qn)
    cases = [
        [(wide[..., 4:], kc, vc, qn, kn)],
        [(qc, kc, vc, qn.float(), kn)],
        [(qc, kc, vc, shifted, kn)],
    ]
    before = _cuda.launch_counts()
    for bad in cases:
        with pytest.raises(ValueError, match="qk_norm_rope"):
            rope.qk_norm_rope_cuda(bad, cos, sin, 2)
    with pytest.raises(ValueError, match="cos / sin"):
        rope.qk_norm_rope_cuda(streams, cos[:, 1:], sin[:, 1:], 2)
    flat = torch.empty(cos.numel() + 1)[1:]  # contiguous, 4 bytes in
    cos_off = flat.view(cos.shape).copy_(cos)
    assert cos_off.is_contiguous() and cos_off.data_ptr() % 16
    with pytest.raises(ValueError, match="cos / sin need 16-byte aligned"):
        rope.qk_norm_rope_cuda(streams, cos_off, sin, 2)
    assert _cuda.launch_counts() == before
