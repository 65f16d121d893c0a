"""The int8 flash body's launch plan and the arithmetic its kernels rest on.

``ops/flash.int8_flash_plan`` is what the K9 / K10 / combined / K14-int8
wrappers check their operands with: the blocks, the kv tile and ring, the
shared memory and the rank-3 TMA maps ``csrc/flash_fwd.cu`` encodes. The
other tests emulate in numpy what the CUDA code does where it departs from
the plain versions' formulas: the int8 P fragments packed from the QK^T
accumulator against the permuted v^T, pass 0's row max taken on the raw
scores, the exact int-to-float and truncation on the FMA pipe, and the
prepass kernel's (``csrc/flash_quant.cu``) block max from column minima and
maxima, summed in f64. Host code only: no card, no kernel build.
"""

import numpy as np
import pytest
import torch

from diffusion_rs_tpu_torch.ops import flash, qmatmul

H = 24
MODES = [(True, False), (False, True), (True, True)]
MODE_IDS = ["s8", "s8_pv", "s8+s8_pv"]


@pytest.mark.parametrize("s8,s8_pv", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("qb", [128, 1536])
@pytest.mark.parametrize("s", [300, 1600, 4608, 4112])
def test_int8_plan_tiles(s, qb, s8, s8_pv):
    """Under s8_pv the 128-row kv tile divides the quantization block (so
    the block's int32 sums and row max do not depend on it); under s8 alone
    it is the plain versions' 64-column softmax block; the shared memory
    fits one H100 block; the maps read int8 k rows of 128 bytes and v^T rows
    of Skv_p bytes, one 128 x 128-byte box per tile."""
    p = flash.int8_flash_plan(1, H, s, s, qb, s8, s8_pv)
    if s8_pv:
        assert p.block_kv == 128 and qb % p.block_kv == 0 and p.steps == 2 * p.kv_tiles
    else:
        assert p.block_kv == flash.BLOCK_K and p.steps == p.kv_tiles
    assert p.smem_bytes <= 232448 and (p.block_q, p.threads) == (128, 384)
    skv_p = -(-s // qb) * qb
    assert p.skv_p == skv_p and p.grid == (-(-s // 128), H)
    assert p.maps["q"].dims == (128, s, H) and p.maps["q"].box == (128, 64)
    k, v = p.maps["k"], p.maps["v"]
    tile = p.block_kv
    if s8:
        assert (k.dims, k.strides, k.box) == ((128, skv_p, H), (128, skv_p * 128), (tile, 128))
    else:
        assert (k.dims, k.strides, k.box) == ((128, s, H), (256, s * 256), (tile, 64))
    if s8_pv:
        assert (v.dims, v.strides, v.box) == ((skv_p, 128, H), (skv_p, 128 * skv_p), (128, 128))
    else:
        assert v == flash.TmaMap((128, s, H), (256, s * 256), (64, 64))
    for m in p.maps.values():  # TMA: 16-byte aligned strides
        assert all(st % 16 == 0 for st in m.strides)


def test_int8_plan_numbers_at_the_main_path_shape():
    """The numbers the source and PERF.md quote at B1 H24 S4608 (QB 1536):
    36 q blocks of each of 24 heads; 72 kv tiles of 64 (s8 alone) or 36 of
    128, each twice (s8_pv); the shared memory of each mode: 1 KB of
    alignment, the 32 KB bf16 q tile, the 16.5 KB int8 q and its scales
    (s8), the ring (six stages of 8 + 16 KB; three of 16 + 16 KB; two of
    32 + 16 KB), the 64 KB f32 output (s8_pv) and the barriers."""
    plans = {(s8, s8_pv): flash.int8_flash_plan(1, H, 4608, 4608, flash.quant_block(4608),
                                                s8, s8_pv) for s8, s8_pv in MODES}
    assert all(p.grid == (36, 24) and p.qb == 1536 for p in plans.values())
    assert {m: (p.kv_tiles, p.steps, p.stages) for m, p in plans.items()} == {
        (True, False): (72, 72, 6), (False, True): (36, 72, 2), (True, True): (36, 72, 3)}
    assert {m: p.smem_bytes for m, p in plans.items()} == {
        (True, False): 1024 + 32768 + 16896 + 6 * 24576 + 19 * 8,
        (False, True): 1024 + 32768 + 2 * 49152 + 65536 + 7 * 8,
        (True, True): 1024 + 32768 + 16896 + 3 * 32768 + 65536 + 10 * 8}


def test_int8_plan_refusals():
    """No int8 mode, a block that is not a positive multiple of 128, no
    rows, a head dim other than 128 and a base off 16-byte alignment are
    refused; so is an operand TMA cannot read."""
    with pytest.raises(ValueError, match="s8 or s8_pv"):
        flash.int8_flash_plan(1, 2, 64, 64, 128, False, False)
    for qb in (0, 64, 192):
        with pytest.raises(ValueError, match="multiple of 128"):
            flash.int8_flash_plan(1, 2, 64, 64, qb, True, True)
    with pytest.raises(ValueError, match="rows"):
        flash.int8_flash_plan(1, 2, 64, 0, 128, True, False)
    with pytest.raises(NotImplementedError):
        flash.int8_flash_plan(1, 2, 64, 64, 128, True, False, d=64)
    with pytest.raises(ValueError, match="aligned"):
        flash.int8_flash_plan(1, 2, 64, 64, 128, True, True, bases={"q": 0, "k": 8, "v": 0})
    buf = torch.zeros(4 * 128 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        qmatmul.check_tma_operand("k", buf[1:].view(1, 1, 4, 128))


def test_pq_fragments_times_permuted_vt_equal_pq_v():
    """One consumer warpgroup's P.V over a 128-row kv tile, emulated: each
    thread's pq codes sit in the QK^T accumulator's layout (d[4j + 2h + e]
    is row 16w + g + 8h, column 8j + 2t + e), the kernel packs them as int8
    A fragments (a_i: row g + 8 (i & 1), bytes 16 (i >> 1) + 4t.. of the
    k32 slice), and the product with v_kernel_layout's permuted v^T equals
    pq @ vq exactly."""
    rng = np.random.default_rng(0)
    pq = rng.integers(0, 128, size=(64, 128), dtype=np.int64)  # a warpgroup's 64 rows x 128 kv
    vq = rng.integers(-127, 128, size=(128, 128), dtype=np.int64)
    vt = flash.v_kernel_layout(torch.from_numpy(vq)[None, None]).numpy()[0, 0]  # [128, 128]
    a = np.zeros((64, 128), dtype=np.int64)  # A as the wgmma reads it: [row][k]
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            d = np.zeros(64, dtype=np.int64)
            for j in range(16):
                for hh in range(2):
                    for e in range(2):
                        d[4 * j + 2 * hh + e] = pq[16 * w + g + 8 * hh, 8 * j + 2 * t + e]
            for kc in range(4):
                for i in range(4):
                    c0 = 16 * kc + 8 * (i >> 1) + 2 * (i & 1)
                    word = [d[c0], d[c0 + 1], d[c0 + 4], d[c0 + 5]]
                    for byte, val in enumerate(word):
                        a[16 * w + g + 8 * (i & 1), 32 * kc + 16 * (i >> 1) + 4 * t + byte] = val
    np.testing.assert_array_equal(a @ vt.T, pq @ vq)


def test_pass0_row_max_on_raw_scores():
    """Pass 0 takes the block's row max on the raw scores: with s =
    fmul(i2f(s_i), fac) and fac > 0, fmul(i2f(max s_i), fac) equals the max
    of the scaled scores over the unmasked columns, bit for bit (both
    roundings are monotone); likewise for K10's f32 scores times scale."""
    rng = np.random.default_rng(1)
    lim = 127 * 127 * 128
    for _ in range(200):
        si = rng.integers(-lim, lim + 1, size=64).astype(np.int32)
        mask = rng.random(64) < rng.random()
        mask[rng.integers(64)] = False  # a visited tile has a real column
        fac = np.float32(10.0 ** rng.uniform(-9, 2))
        s = si.astype(np.float32) * fac
        want = s[~mask].max()
        got = np.float32(si[~mask].max()).astype(np.float32) * fac
        assert got.view(np.int32) == want.view(np.int32)
        raw = (rng.standard_normal(64) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
        scale = np.float32(128 ** -0.5)
        assert (raw[~mask].max() * scale).view(np.int32) == (raw * scale)[~mask].max().view(np.int32)


def test_int_to_float_on_the_fma_pipe_is_exact():
    """s_i + 0x4B400000 read as a float, less 1.5 * 2^23, is s_i exactly for
    every |s_i| < 2^22 (QK^T's int8 sums stay within 127 * 127 * 128)."""
    v = np.arange(-(2 ** 22), 2 ** 22, dtype=np.int32)
    f = (v + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
    np.testing.assert_array_equal(f, v.astype(np.float32))
    assert 127 * 127 * 128 < 2 ** 22


def _add_rz(t: np.ndarray, c: float) -> np.ndarray:
    """t + c in f32 rounded toward zero (t, c >= 0): the f64 sum is exact,
    its f32 rounding to nearest stepped down where it rounded up."""
    exact = t.astype(np.float64) + c
    rn = exact.astype(np.float32)
    return np.where(rn.astype(np.float64) > exact, np.nextafter(rn, np.float32(0)), rn)


def test_truncation_on_the_fma_pipe():
    """pq = trunc(p + 0.5) as the kernel takes it: t = p + 0.5 rounded to
    nearest, then t + 2^23 rounded toward zero is 2^23 + trunc(t), whose low
    byte is the code and whose bits less 0x4B000000 are its value: at every
    float within 2000 ulps of each integer and half-integer of [0, 127.5],
    and at 10^6 random p in [0, 127]."""
    near = []
    for x in np.arange(0, 128.5, 0.5, dtype=np.float32):
        bits = x.view(np.int32) + np.arange(-2000, 2001, dtype=np.int32)
        near.append(bits[bits >= 0].view(np.float32))
    t = np.concatenate(near)
    t = t[(t >= 0) & (t <= 127.5)]
    p = np.random.default_rng(2).uniform(0, 127, 10 ** 6).astype(np.float32)
    t = np.concatenate([t, p + np.float32(0.5)])
    y = _add_rz(t, 2.0 ** 23).view(np.int32)
    want = np.trunc(t).astype(np.int32)
    np.testing.assert_array_equal(y - 0x4B000000, want)
    np.testing.assert_array_equal(y & 0xFF, want)


def test_prepass_block_max_from_column_min_max():
    """max |fl(x - m)| over a column equals max(fl(max x - m), fl(m - min
    x)), bit for bit, whatever side of the mean the column lies."""
    rng = np.random.default_rng(3)
    for _ in range(100):
        x = (rng.standard_normal((rng.integers(1, 300), 16)) * rng.uniform(0.01, 5)
             + rng.uniform(-3, 3)).astype(np.float32)
        m = (x.mean(axis=0) + rng.standard_normal(16) * rng.uniform(0, 3)).astype(np.float32)
        want = np.abs(x - m).max(axis=0)
        got = np.maximum(x.max(axis=0) - m, m - x.min(axis=0))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _permuted(r: np.ndarray) -> np.ndarray:
    """The position of chunk row r in v_kernel_layout's order (csrc/flash_quant.cu
    writes the codes of rows r, r + 1, r + 8, r + 9 to four consecutive ones)."""
    a = (r >> 3) & 3
    return (r & ~31) + 16 * (a >> 1) + 4 * ((r >> 1) & 3) + 2 * (a & 1) + (r & 1)


def _prepass_emulated(x: np.ndarray, block: int, transposed: bool):
    """csrc/flash_quant.cu in numpy: f64 column sums in the kernel's order
    (per 8-block cluster rank over its 128-row chunks, then the ranks in
    order), the block max from chunk column minima and maxima, IEEE
    quotients, codes rounded half to even, v's codes at _permuted rows."""
    b, h, s, d = x.shape
    s_p = -(-s // block) * block
    n_chunks = s_p // 128
    codes = np.zeros((b, h, s_p, d), np.int8)
    scales = np.zeros((b, h, s_p // block), np.float32)
    means = np.zeros((b, h, d), np.float32)
    for bi in range(b):
        for hi in range(h):
            xs = x[bi, hi]
            total = np.zeros(d)
            for r in range(8):
                for c in range(r, n_chunks, 8):
                    total = total + xs[c * 128:c * 128 + 128].astype(np.float64).sum(axis=0)
            m = (total.astype(np.float32) / np.float32(s)).astype(np.float32)
            means[bi, hi] = m
            for q in range(s_p // block):
                rows = xs[q * block:min(q * block + block, s)]
                a = np.float32(0.0)
                if len(rows):
                    a = np.maximum(rows.max(axis=0) - m, m - rows.min(axis=0)).max()
                    a = max(a, np.float32(0.0))
                sc = np.float32(1.0) if a == 0 else np.float32(a / np.float32(127.0))
                scales[bi, hi, q] = sc
                if len(rows):
                    codes[bi, hi, q * block:q * block + len(rows)] = np.rint(
                        (rows - m) / sc).astype(np.int8)
    if transposed:
        pos = _permuted(np.arange(s_p))
        codes_t = np.zeros((b, h, d, s_p), np.int8)
        codes_t[:, :, :, pos] = codes.transpose(0, 1, 3, 2)
        codes = codes_t
    return codes, scales, means


@pytest.mark.parametrize("s,block", [(300, 128), (130, 128), (1600, 1536)])
def test_prepass_kernel_algorithm_matches_plain(rng, s, block):
    """The prepass kernel's algorithm, emulated, against quantize_k /
    quantize_v + v_kernel_layout in test_quantize_prepasses_match_jax's
    bands (mean rtol 1e-6, scales within one ulp, codes off by one on at
    most 1e-3 of entries, zero padding); the transposed layout at the
    kernel's _permuted positions is v_kernel_layout's."""
    x = (rng.standard_normal((1, 2, s, 128)) * 0.3 + 0.1).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()  # the kernel reads bf16
    for which in ("k", "v"):
        codes, scales, means = _prepass_emulated(x, block, transposed=which == "v")
        if which == "k":
            rc, rs, rm = (t.numpy() for t in flash.quantize_k(torch.from_numpy(x), block))
        else:
            vq, rs, rm = flash.quantize_v(torch.from_numpy(x), block)
            rc, rs, rm = flash.v_kernel_layout(vq).numpy(), rs.numpy(), rm.numpy()
        np.testing.assert_allclose(means, rm, rtol=1e-6, atol=1e-7)
        assert np.abs(scales.view(np.int32) - rs.view(np.int32)).max() <= 1
        diff = np.abs(codes.astype(np.int32) - rc.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        rows = np.arange(codes.shape[2 if which == "k" else 3])
        if which == "v":  # the source row of each position
            rows = flash.v_kernel_layout(torch.from_numpy(rows)[None, None, :, None]).numpy()[0, 0, 0]
            assert not codes[..., rows >= s].any()
        else:
            assert not codes[:, :, rows >= s].any()


def test_quantize_kv_on_the_cpu_is_the_plain_prepass(rng):
    """On CPU tensors quantize_kv returns the plain versions' planes, v's in
    v_kernel_layout's order; a missing tensor gives Nones; no launch."""
    from diffusion_rs_tpu_torch.ops import _cuda

    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 200, 128)).astype(np.float32))
            for _ in range(2))
    (kq, sk, km), (vt, sv, vm) = flash.quantize_kv(k, v, 128)
    ref_k = flash.quantize_k(k, 128)
    vq, rsv, rvm = flash.quantize_v(v, 128)
    assert all(torch.equal(a, b) for a, b in zip((kq, sk, km), ref_k))
    assert all(torch.equal(a, b) for a, b in zip((vt, sv, vm),
                                                  (flash.v_kernel_layout(vq), rsv, rvm)))
    assert flash.quantize_kv(None, v, 128)[0] == (None, None, None)
    assert flash.quantize_kv(k, None, 128)[1] == (None, None, None)
    assert _cuda.launch_counts() == dict.fromkeys(_cuda.KERNELS, 0)


def _rn32(x) -> float:
    """The float32 nearest to the rational x (ties to even), for normal
    results: exact arithmetic, one rounding."""
    from fractions import Fraction

    x = Fraction(x)
    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length() - 24
    while x / Fraction(2) ** e >= 2 ** 24:
        e += 1
    while x / Fraction(2) ** e < 2 ** 23:
        e -= 1
    m = x / Fraction(2) ** e
    n = m.numerator // m.denominator
    rem = m - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    return float(sign * n * Fraction(2) ** e)


def _quotient(a, b) -> float:
    """quotient(a, divisor(b)) of csrc/common.cuh in exact rationals: below
    2^-64 a and b are first scaled by 2^100 (exact); then q = RN(a * rb)
    with rb = RN(1 / b), and RN(q + RN(a - q * b) * rb) through two FMAs
    (Markstein)."""
    from fractions import Fraction

    fa, fb = Fraction(float(a)), Fraction(float(b))
    if b < 2.0 ** -64:
        fa, fb = fa * 2 ** 100, fb * 2 ** 100
    rb = _rn32(1 / fb)
    q = _rn32(fa * Fraction(rb))
    res = _rn32(fa - Fraction(q) * fb)
    return _rn32(Fraction(res) * Fraction(rb) + Fraction(q))


def test_prepass_quotient_is_the_ieee_quotient():
    """quotient() of csrc/common.cuh, with which the prepass divides by a
    chunk's scale and the int8 body by a q row's scale b: the correctly
    rounded a / b, checked with exact rationals for random scales and values
    in the prepass's range, values at and beside the half-integer quotients
    where the code's rounding turns, scales whose significand is all ones,
    scales just above 2^-64, and scales below it down to subnormals, where
    1 / b overflows f32 unless b is scaled."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    bs = [np.float32(x) for x in 10.0 ** rng.uniform(-4, 0, 150)]
    bs += [np.float32((2 ** 24 - 1) * 2.0 ** -k) for k in range(24, 40)]
    bs += [np.float32(x) for x in 2.0 ** rng.uniform(-64, -50, 10)] + [np.float32(2.0 ** -64)]
    bs += [np.float32(x) for x in (2.0 ** -64 * (1 - 2.0 ** -24), 2.0 ** -100, 1e-38, 1e-40,
                                   1e-45)]
    assert all(_rn32(1 / Fraction(float(b))) > float(np.finfo(np.float32).max)
               for b in bs[-2:])
    for b in bs:
        cands = list(rng.uniform(-127.5, 127.5, 12) * b)
        for n in rng.integers(-127, 127, 4):  # quotients n + 1/2 and their neighbours
            a = np.float32((n + 0.5) * b)
            cands += [a, np.nextafter(a, np.float32(np.inf)), np.nextafter(a, np.float32(-np.inf))]
        for a in (np.float32(x) for x in cands):
            got = _quotient(a, b)
            assert got == _rn32(Fraction(float(a)) / Fraction(float(b))), (float(a), float(b))
            assert got == float(np.float32(a) / np.float32(b))  # numpy's IEEE quotient
