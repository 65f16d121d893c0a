// The attention prologue of a FLUX block in the default (interleaved-RoPE)
// layout, in one launch: the per-head split of the q/k/v projection columns,
// QK-RMSNorm with the q_norm / k_norm scales, a double block's joint [txt;
// img] concatenation, interleaved RoPE on q and k, and the write of q, k and
// v as the contiguous [B, H, S, 128] operands of the bf16 flash kernel (K3).
//
// qk_norm_rope: replaces no pallas_call. The JAX package writes these steps
// as plain jnp code (models/flux.py _qkv, the joint jnp.concatenate,
// _rope_qk) that XLA fuses; the port ran them as about 61 (double block) /
// 39 (single block) eager PyTorch launches. Plain version:
// ops/rope.qk_norm_rope_plain, the one reference of the tests.
//
// Arithmetic, as ops/norms.rms_norm then ops/rope.apply_rope compute it,
// each step rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, no FMA
// contraction): var = (sum of x^2 in f32) / 128; r = 1 / sqrt(var + eps)
// (IEEE sqrt, then IEEE reciprocal: the plain 1.0 / torch.sqrt); n = bf16(x
// * r); y = bf16(n * w) (the exact product of two bf16, rounded once); per
// pair (2i, 2i + 1) of y: bf16(c y0 - s y1), bf16(s y0 + c y1). v is copied.
// Only the order of the 128-term sum of squares differs from torch's
// reduction: where that moves r by an f32 ulp, bf16(x * r) can flip by one
// ulp, which the scale's rounding and the rotation carry on (a few ulps of
// the rotated pair's norm), in a few elements per million; v is equal bit
// for bit.
//
// Bound on the H100: bytes. q, k and v are read once and written once (6 x
// 4608 x 3072 x 2 B = 170 MB at B1 S4608 H24, plus 2.4 MB of cos/sin
// tables): 51 us at 3.35 TB/s. Design: 16 lanes own one 128-wide (token,
// head) row, 8 bf16 a lane, one 16-byte load and one 16-byte store per row
// and tensor; the sum of squares is reduced by shuffles inside those 16
// lanes. A block of 256 threads owns TOKENS consecutive tokens; the 8 row
// groups of a token load its cos/sin once (4 pairs a lane) and keep them,
// and the stream's two scales, in registers across all their heads. A group
// loads up to HEADS_IN_FLIGHT heads' q, k and v (9 independent 16-byte
// loads) before it computes, so enough bytes are in flight to cover the
// memory latency. Sources are strided (a contiguous linear output, or a
// column slice of a fused qkv / qkv_mlp projection); each output row is 256
// contiguous bytes, and a warp's two groups write adjacent rows.
#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int LANES = 16;                     // lanes per (token, head) row: 8 bf16 each
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / LANES;       // row groups per block
constexpr int TOKENS = 2;                     // tokens per block
constexpr int GROUPS_PER_TOKEN = GROUPS / TOKENS;
constexpr int HEADS_IN_FLIGHT = 3;            // heads a group loads before it computes

// One stream of q/k/v columns [B, rows, H * 128] bf16 with its scales.
struct Stream {
  const __nv_bfloat16* x[3];  // q, k, v
  const __nv_bfloat16* w[2];  // q_norm, k_norm [128]
  long long sb[3], sr[3];     // batch and row strides of q, k, v (elements)
  int rows;
};

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// RMSNorm of one row over its 16 lanes (mask: the group's lanes), the scale,
// then the rotation of this lane's 4 pairs; returns the 8 bf16 outputs.
__device__ __forceinline__ uint4 norm_rope(const uint4& raw, const float (&w)[8],
                                           const float (&c)[4], const float (&s)[4],
                                           unsigned mask, float eps) {
  float x[8];
  unpack8(raw, x);
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss = __fadd_rn(ss, __fmul_rn(x[e], x[e]));
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2)
    ss = __fadd_rn(ss, __shfl_xor_sync(mask, ss, off, LANES));
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(ss, 1.0f / D), eps)));
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float y0 = round_bf16(__fmul_rn(round_bf16(__fmul_rn(x[2 * i], r)), w[2 * i]));
    const float y1 =
        round_bf16(__fmul_rn(round_bf16(__fmul_rn(x[2 * i + 1], r)), w[2 * i + 1]));
    out[i] = pack_bf16x2(__fsub_rn(__fmul_rn(c[i], y0), __fmul_rn(s[i], y1)),
                         __fadd_rn(__fmul_rn(s[i], y0), __fmul_rn(c[i], y1)));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__global__ void __launch_bounds__(THREADS)
qk_norm_rope_kernel(Stream s0, Stream s1, const float* __restrict__ cosines,
                    const float* __restrict__ sines, long long t_sb,
                    __nv_bfloat16* __restrict__ qo, __nv_bfloat16* __restrict__ ko,
                    __nv_bfloat16* __restrict__ vo, int B, int H, float eps) {
  const int S = s0.rows + s1.rows;
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  const long long tok = (long long)blockIdx.x * TOKENS + grp % TOKENS;  // b * S + s
  // a group is wholly in or out of range, so the shuffles name its lanes only
  if (tok >= (long long)B * S) return;
  const unsigned mask = 0xFFFFu << (threadIdx.x & 16);
  const int b = (int)(tok / S), s = (int)(tok % S);
  const bool first = s < s0.rows;
  const int r = first ? s : s - s0.rows;
  const __nv_bfloat16* src[3];
#pragma unroll
  for (int t = 0; t < 3; ++t)
    src[t] = (first ? s0.x[t] : s1.x[t]) + b * (first ? s0.sb[t] : s1.sb[t]) +
             r * (first ? s0.sr[t] : s1.sr[t]) + lane * 8;
  float wq[8], wk[8];
  unpack8(*reinterpret_cast<const uint4*>((first ? s0.w[0] : s1.w[0]) + lane * 8), wq);
  unpack8(*reinterpret_cast<const uint4*>((first ? s0.w[1] : s1.w[1]) + lane * 8), wk);
  const long long trow = b * t_sb + (long long)s * (D / 2) + lane * 4;
  const float4 c4 = *reinterpret_cast<const float4*>(cosines + trow);
  const float4 s4 = *reinterpret_cast<const float4*>(sines + trow);
  const float c[4] = {c4.x, c4.y, c4.z, c4.w};
  const float sn[4] = {s4.x, s4.y, s4.z, s4.w};
  for (int h0 = grp / TOKENS; h0 < H; h0 += GROUPS_PER_TOKEN * HEADS_IN_FLIGHT) {
    uint4 x[HEADS_IN_FLIGHT][3];
#pragma unroll
    for (int j = 0; j < HEADS_IN_FLIGHT; ++j) {
      const int h = h0 + j * GROUPS_PER_TOKEN;
      if (h < H) {
#pragma unroll
        for (int t = 0; t < 3; ++t) x[j][t] = *reinterpret_cast<const uint4*>(src[t] + h * D);
      }
    }
#pragma unroll
    for (int j = 0; j < HEADS_IN_FLIGHT; ++j) {
      const int h = h0 + j * GROUPS_PER_TOKEN;
      if (h < H) {
        const size_t o = (((size_t)b * H + h) * S + s) * D + lane * 8;
        *reinterpret_cast<uint4*>(qo + o) = norm_rope(x[j][0], wq, c, sn, mask, eps);
        *reinterpret_cast<uint4*>(ko + o) = norm_rope(x[j][1], wk, c, sn, mask, eps);
        *reinterpret_cast<uint4*>(vo + o) = x[j][2];
      }
    }
  }
}

Stream make_stream(const void* q, const void* k, const void* v, const void* qw, const void* kw,
                   int rows, long long q_sb, long long q_sr, long long k_sb, long long k_sr,
                   long long v_sb, long long v_sr) {
  using bf16 = __nv_bfloat16;
  Stream st;
  st.x[0] = static_cast<const bf16*>(q);
  st.x[1] = static_cast<const bf16*>(k);
  st.x[2] = static_cast<const bf16*>(v);
  st.w[0] = static_cast<const bf16*>(qw);
  st.w[1] = static_cast<const bf16*>(kw);
  st.sb[0] = q_sb;
  st.sb[1] = k_sb;
  st.sb[2] = v_sb;
  st.sr[0] = q_sr;
  st.sr[1] = k_sr;
  st.sr[2] = v_sr;
  st.rows = rows;
  return st;
}

}  // namespace

// Stream 0 (a double block's txt, or a single block's one stream) of S0 rows
// and stream 1 (a double block's img; S1 = 0 for a single block) of S1 rows:
// q, k, v bf16 [B, S_x, H * 128] with unit column stride and the given batch
// and row strides (elements, multiples of 8; 16-byte aligned bases), their
// q_norm / k_norm scales bf16 [128]. cos / sin f32 [B or 1, S0 + S1, 64]
// contiguous with batch stride t_sb (0 where the tables are shared). qo, ko,
// vo bf16 [B, H, S0 + S1, 128] contiguous, stream 0's rows first. Returns
// cudaGetLastError().
extern "C" int qk_norm_rope(const void* q0, const void* k0, const void* v0, const void* qw0,
                            const void* kw0, const void* q1, const void* k1, const void* v1,
                            const void* qw1, const void* kw1, const void* cosines, const void* sines,
                            void* qo, void* ko, void* vo, int B, int H, int S0, int S1,
                            long long q0_sb, long long q0_sr, long long k0_sb, long long k0_sr,
                            long long v0_sb, long long v0_sr, long long q1_sb, long long q1_sr,
                            long long k1_sb, long long k1_sr, long long v1_sb, long long v1_sr,
                            long long t_sb, float eps, void* stream) {
  const long long tokens = (long long)B * (S0 + S1);
  if (B < 0 || H < 0 || S0 < 0 || S1 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tokens == 0 || H == 0) return 0;
  const long long blocks = (tokens + TOKENS - 1) / TOKENS;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Stream s0 = make_stream(q0, k0, v0, qw0, kw0, S0, q0_sb, q0_sr, k0_sb, k0_sr, v0_sb, v0_sr);
  const Stream s1 = make_stream(q1, k1, v1, qw1, kw1, S1, q1_sb, q1_sr, k1_sb, k1_sr, v1_sb, v1_sr);
  using bf16 = __nv_bfloat16;
  qk_norm_rope_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      s0, s1, static_cast<const float*>(cosines), static_cast<const float*>(sines), t_sb,
      static_cast<bf16*>(qo), static_cast<bf16*>(ko), static_cast<bf16*>(vo), B, H, eps);
  return static_cast<int>(cudaGetLastError());
}
