// Flash attention forward, head_dim 128, output head-merged [B, Sq, H * 128].
// Two kernel bodies of one Hopper design (TMA, mbarrier ring, warp-
// specialised wgmma): the bf16 one below with five entry points and the
// half-split RoPE pass, and the int8 one further down with six:
//
// K3 flash_fwd: replaces diffusion_rs_tpu/ops/flash_pallas.py:_flash_kernel
//   in bf16 mode with seq_out=True and no lse (:50-216), reached through
//   _flash_call -> pl.pallas_call (:396) from flash_attention(out_seqmajor=
//   True). q/k/v [B, H, S, 128] contiguous.
// K6 flash_sm: replaces _flash_sm_kernel (:561), reached through
//   _flash_sm_call -> pl.pallas_call (:636). q/k/v seq-major [B, S, H * 128]:
//   head h is columns h*128 .. h*128+127 of each row, and rows may lie
//   further apart than H * 128 (a column slice of a wider projection).
// K7 flash_rope: replaces _flash_rope_kernel (:429), reached through
//   _flash_rope_call -> pl.pallas_call (:523): the rotation pass rope_qk
//   (below), which rotates q and k once into scratch tensors, then K6's
//   body on them (the flash_rope entry point launches the same kernel as
//   flash_sm; the two count apart).
// K9 flash_s8, K10 flash_s8pv and flash_s8_s8pv (both): replace the int8
//   modes of _flash_kernel, s8 (:67-99) and s8_pv (:123-176, :200-204),
//   reached through _flash_call -> pl.pallas_call (:396). A second body,
//   flash_int8_body, described at its definition.
// K14 flash_fwd_lse, flash_s8_lse, flash_s8pv_lse, flash_s8_s8pv_lse:
//   replace _flash_kernel's save_lse output (_finalize, :213-216; sliced to
//   one lane at :420), which ring attention merges chunks with: K3's and the
//   int8 body's output plus lse = m + log(l_safe) in f32 [B, H, Sq], written
//   once per row by the thread of its quad with t == 0 (all four hold the
//   row's reduced m and l). Under s8_pv, l is the quantized sum(pq) * beta /
//   127, m the running max, so lse is in JAX's units; under s8 the scores
//   are those of the mean-centred k, as in JAX (the ring adds scale * q . km
//   back). The lse is a template flag of both bodies (LSE), compiled out of
//   K3 / K9 / K10; the output stays seq-major [B, Sq, H * 128]. Its bound is
//   K3's: the lse is Sq * 4 bytes per head.
//
// Math of the bf16 body (the Pallas kernels'): s = (q . k^T) * scale in f32;
// kv columns past kv_len masked to -1e30; running max m (starts at -1e30,
// natural-log units) and sum l in f32, over kv tiles of 64 rows
// (ops/flash.py BLOCK_K, which the plain versions use too, so the two take
// the same block maxima); p = exp(s - m_new); l = l * alpha + rowsum(p) over
// the f32 p, while P.V uses p rounded to bf16; acc = acc * alpha + P.V; o =
// acc * (1 / l) with l == 0 -> 1; each head's rows are written to its column
// slice of out[B, Sq, H * 128]. log2(e) is folded into the scale: p =
// exp2(qk * (scale * log2 e) - m * log2 e) on MUFU.EX2 (and alpha likewise),
// which differs from expf(s - m) by a few f32 ulps: inside the bands the
// tests hold K3 / K6 / K14 to against their plain versions.
//
// Bound on the H100: at FLUX joint attention (B1 H24 S4608 D128) the bf16
// tensor-core rate bounds K3, K6 and K14 (4*S*S*D operations per head
// against S*D*8 bytes). Design, for Hopper (the pattern of qmm_s8.cu /
// qmm_nf4.cu):
// * a block owns 128 query rows of one (batch, head), 64 for each of two
//   consumer warpgroups; a producer warp streams K and V tiles of 64 kv
//   rows through a 4-stage TMA ring (128-byte swizzle, each 64 x 128 tile
//   as two boxes of 64 columns), K and V on barriers of their own so that
//   QK^T starts before V lands. 64-row kv tiles keep the plain versions'
//   blocks (which the CPU tests hold to the JAX package);
// * the tensor maps are rank 3: (128, S, B*H) for K3/K14 and (H*128, S, B)
//   with the operand's row and batch strides for K6's seq-major column
//   slices (a slice's column offset lies in its base pointer), so a box
//   never reads into the next head and ragged rows come back zero-filled;
// * each consumer warpgroup loads its 64 q rows from the TMA'd tile (once
//   per block) into registers for each kv tile (32 a thread: the wgmma A
//   fragments of 8 k16 slices, conflict-free 4-byte loads), so both
//   products take A from registers: S = Q K^T (wgmma m64n64k16, B the K
//   tile, K-major as stored) and O += P V (m64n128k16, A the bf16 P
//   re-packed from S's accumulator, B the V tile, [kv][d] = MN-major: the
//   transpose bit and wgmma_desc_mn); the softmax state m and l stays in f32
//   registers, and O is rescaled only when a row's max moved;
// * setmaxnreg gives the consumers the producer's registers; the two
//   consumer warpgroups' softmax and MMAs interleave on the SM.
// Ragged q rows are not written; ragged kv columns are masked.
//
// RoPE (K7's rope_qk): rot(x)_j = ce_j x_j + se_j x_{(j+64) mod 128} with
// the expanded tables ce = [cos | cos], se = [-sin | sin] (ops/rope.py
// expand_rope_tables), so the pass reads cos from ce[0:64] and sin from
// se[64:128]: lo_j = cos_j x_j - sin_j x_{j+64} and hi_j = cos_j x_{j+64} +
// sin_j x_j in f32, each product and the sum rounded on its own
// (__fmul_rn / __fsub_rn / __fadd_rn, no FMA contraction), then rounded to
// bf16: apply_rope_halfsplit's output bit for bit, so K7 equals K6 run on
// plain-rotated q/k bit for bit. One launch rotates q and k (8 threads per
// row and head, 8 pairs each) into contiguous [B, S, H * 128] scratch; it
// moves q and k in and out and reads the table halves (about 118 MB at B1
// S4608 H24: bytes bound it).
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int HALF = D / 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on MUFU.EX2 (relative error ~2^-22; 0 for x below -126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The bf16 body (K3, K6, K14-bf16; K7's attention)
// ---------------------------------------------------------------------------

constexpr int WQ = 128;                 // q rows per block: 64 per consumer warpgroup
constexpr int WKV = 64;                 // kv rows per ring stage
constexpr int WTHREADS = 384;           // producer warpgroup + two consumer warpgroups
constexpr int WSTAGES = 4;
constexpr int CONSUMER_WARPS = 8;       // each releases a stage once its P.V is done
constexpr int QBOX = WQ * 128;          // bytes of one q box: 128 rows x 64 bf16 columns
constexpr int KVBOX = WKV * 128;        // bytes of one k or v box: 64 rows x 64 columns
constexpr int KV_TILE = 2 * KVBOX;      // a 64 x 128 k or v tile as two column halves
constexpr int K_OFF = 2 * QBOX;         // after the q tile
constexpr int V_OFF = K_OFF + WSTAGES * KV_TILE;
constexpr int BAR_OFF = V_OFF + WSTAGES * KV_TILE;
constexpr size_t WSMEM_BYTES = 1024 + BAR_OFF + (1 + 3 * WSTAGES) * sizeof(uint64_t);

// Rank-3 maps of q, k and v (boxes of 128 q rows or 64 kv rows by 64
// columns, 128-byte swizzle).
struct Maps {
  CUtensorMap q, k, v;
};

// DENSE (K3, K14): the maps are over (128, S, B*H) and a head is plane bh;
// otherwise (K6, K7) over (H*128, S, B), a head is columns h*128.. of plane b.
template <bool DENSE, bool LSE>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wg_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int H, int Sq, int Skv, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + WSTAGES;
  uint64_t* empty = full_v + WSTAGES;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * WQ;
  const int c0 = DENSE ? 0 : h * D;  // the head's first column in its map
  const int z = DENSE ? bh : b;      // and its plane
  const int nkv = (Skv + WKV - 1) / WKV;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread loads q once and keeps the ring full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * QBOX);
      tma_load_3d(sm, &maps.q, c0, q0, z, bar_q);
      tma_load_3d(sm + QBOX, &maps.q, c0 + HALF, q0, z, bar_q);
      for (int j = 0; j < nkv; ++j) {
        const int buf = j % WSTAGES;
        if (j >= WSTAGES) mbar_wait(&empty[buf], ((j / WSTAGES) + 1) & 1);
        uint8_t* kt = sm + K_OFF + buf * KV_TILE;
        uint8_t* vt = sm + V_OFF + buf * KV_TILE;
        mbar_expect_tx(&full_k[buf], KV_TILE);
        tma_load_3d(kt, &maps.k, c0, j * WKV, z, &full_k[buf]);
        tma_load_3d(kt + KVBOX, &maps.k, c0 + HALF, j * WKV, z, &full_k[buf]);
        mbar_expect_tx(&full_v[buf], KV_TILE);
        tma_load_3d(vt, &maps.v, c0, j * WKV, z, &full_v[buf]);
        tma_load_3d(vt + KVBOX, &maps.v, c0 + HALF, j * WKV, z, &full_v[buf]);
      }
    }
    return;
  }

  // Consumer warpgroups: rows 64 cw .. 64 cw + 63 of the block.
  setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;
  const int w = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 64 * cw + 16 * w + g;  // block row of the fragments' first row; + 8 the second

  // Q fragments of the 8 k16 slices: a0 / a2 row r0, a1 / a3 row r0 + 8,
  // columns 16kk + 2t (+ 8 for a2 / a3); under the 128-byte swizzle the
  // 16-byte chunk c of row r lies at chunk c ^ (r & 7), and the eight g of
  // a warp hit eight chunks. They are loaded again for every kv tile: A
  // registers that a wgmma read are not kept across the loop (ptxas
  // reallocated them to the softmax when they were, and QK^T of the second
  // tile read P).
  auto load_q = [&](uint32_t (&qa)[D / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint8_t* box = sm + (kk >> 2) * QBOX;
      const int c = 2 * (kk & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 8 * (i & 1);
        qa[kk][i] = *reinterpret_cast<const uint32_t*>(
            box + r * 128 + (((c + (i >> 1)) ^ (r & 7)) << 4) + 4 * t);
      }
    }
  };
  mbar_wait(bar_q, 0);

  // o[4j + 2h + e]: row r0 + 8h, column 8j + 2t + e (wgmma's D layout).
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = __fmul_rn(scale, LOG2E);

  for (int j = 0; j < nkv; ++j) {
    const int buf = j % WSTAGES;
    const uint32_t parity = (j / WSTAGES) & 1;
    const uint8_t* kt = sm + K_OFF + buf * KV_TILE;
    const uint8_t* vt = sm + V_OFF + buf * KV_TILE;

    // S = Q K^T for this warpgroup's 64 rows x 64 kv columns.
    uint32_t qa[D / 16][4];
    load_q(qa);
    float s[WKV / 2];
#pragma unroll
    for (int i = 0; i < WKV / 2; ++i) s[i] = 0.f;
    mbar_wait(&full_k[buf], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      WgmmaBf16<WKV, 0>::run(s, qa[kk], wgmma_desc(kt + (kk >> 2) * KVBOX + 32 * (kk & 3), 1024, 1),
                             1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < WKV / 2; ++i) reg_fence(s[i]);

    // Mask the ragged kv tail (the last tile only), online softmax over rows
    // r0 and r0 + 8. The row max is taken on the raw scores (scale > 0),
    // then scaled: m stays in natural-log units, as the lse needs.
    if ((j + 1) * WKV > Skv) {
#pragma unroll
      for (int i = 0; i < WKV / 2; ++i)
        if (j * WKV + (i >> 2) * 8 + 2 * t + (i & 1) >= Skv) s[i] = NEG_INF;
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < WKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mb[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] == NEG_INF ? NEG_INF : __fmul_rn(mx[r], scale));
      alpha[r] = ex2(__fmul_rn(m_run[r] - m_new, LOG2E));
      mb[r] = __fmul_rn(m_new, LOG2E);
      m_run[r] = m_new;
    }
    // p = exp(s * scale - m) as 2^(s * (scale * log2 e) - m * log2 e): one
    // FFMA and one MUFU.EX2 per score (masked scores give 2^-inf = 0).
#pragma unroll
    for (int i = 0; i < WKV / 2; ++i) {
      const float p = ex2(fmaf(s[i], scale_log2, -mb[(i >> 1) & 1]));
      s[i] = p;
      ls[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      l_run[r] = l_run[r] * alpha[r] + ls[r];
    }
    // alpha is 1 for every row once the running max stops moving
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }

    // O += P V, with P re-packed from the S accumulator as bf16 A fragments:
    // kv slice kk is S columns 16kk.. (s[8kk..8kk+3]) and 16kk + 8..
    // (s[8kk+4..8kk+7]).
    uint32_t pa[WKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < WKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    mbar_wait(&full_v[buf], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WKV / 16; ++kk)
      WgmmaBf16<D, 1>::run(o, pa[kk], wgmma_desc_mn(vt + kk * 16 * 128, KVBOX, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) reg_fence(o[i]);
    if (lane == 0) mbar_arrive(&empty[buf]);
  }

  const int HD = H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Sq) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    const float inv = __frcp_rn(l);
    __nv_bfloat16* orow = out + ((size_t)b * Sq + row) * HD + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(orow + i * 8 + 2 * t) =
          pack_bf16x2(__fmul_rn(o[4 * i + 2 * r], inv), __fmul_rn(o[4 * i + 2 * r + 1], inv));
    }
    if constexpr (LSE) {
      if (t == 0) lse[(size_t)bh * Sq + row] = __fadd_rn(m_run[r], logf(l));
    }
  }
}

// Encodes the three maps and launches the body. Strides in elements (the
// seq-major forms'; DENSE takes q/k/v [B, H, S, 128] contiguous).
template <bool DENSE, bool LSE>
int launch_wg(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
              int Sq, int Skv, long long q_sb, long long q_sr, long long k_sb, long long k_sr,
              long long v_sb, long long v_sr, float scale, void* stream) {
  static size_t raised[MAX_DEVICES] = {};
  const int attr_err = raise_smem_limit(reinterpret_cast<const void*>(flash_wg_kernel<DENSE, LSE>),
                                        WSMEM_BYTES, raised);
  if (attr_err != 0) return attr_err;
  Maps maps;
  const void* base[3] = {q, k, v};
  const long long sb[3] = {q_sb, k_sb, v_sb}, sr[3] = {q_sr, k_sr, v_sr};
  CUtensorMap* dst[3] = {&maps.q, &maps.k, &maps.v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t S = i == 0 ? Sq : Skv;
    const uint64_t dims[3] = {DENSE ? (uint64_t)D : (uint64_t)H * D, S,
                              DENSE ? (uint64_t)B * H : (uint64_t)B};
    const uint64_t row = DENSE ? D * 2 : (uint64_t)sr[i] * 2;
    const uint64_t plane = DENSE ? S * D * 2 : B > 1 ? (uint64_t)sb[i] * 2 : S * row;
    const int err = encode_tensor_map_3d(dst[i], base[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dims,
                                         row, plane, i == 0 ? WQ : WKV, HALF,
                                         CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) return err;
  }
  dim3 grid((Sq + WQ - 1) / WQ, B * H);
  flash_wg_kernel<DENSE, LSE><<<grid, WTHREADS, WSMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Sq, Skv, scale);
  return static_cast<int>(cudaGetLastError());
}

// K7's rotation pass: one thread per 8 pairs (j..j+7, j+64..j+71) of one row
// and head, 16-byte loads and stores; threads 0..nq-1 rotate q, the rest k.
// Sources strided as K6's operands, destinations contiguous [B, S, H * 128].
__global__ void __launch_bounds__(256)
rope_qk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const float* __restrict__ ce_q, const float* __restrict__ se_q,
               const float* __restrict__ ce_k, const float* __restrict__ se_k,
               __nv_bfloat16* __restrict__ qr, __nv_bfloat16* __restrict__ kr, int B, int H,
               int Sq, int Skv, long long q_sb, long long q_sr, long long k_sb, long long k_sr) {
  const int nq = B * Sq * H * 8;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq + B * Skv * H * 8) return;
  const bool is_q = i < nq;
  if (!is_q) i -= nq;
  const int S = is_q ? Sq : Skv;
  const int j = (i & 7) * 8;
  const int hh = (i >> 3) % H;
  const int bs = (i >> 3) / H;  // b * S + s
  const int b = bs / S, s = bs % S;
  const __nv_bfloat16* x = (is_q ? q + b * q_sb + s * q_sr : k + b * k_sb + s * k_sr) + hh * D + j;
  const float* c = (is_q ? ce_q : ce_k) + (size_t)bs * D + j;
  const float* sn = (is_q ? se_q : se_k) + (size_t)bs * D + HALF + j;
  __nv_bfloat16* y = (is_q ? qr : kr) + ((size_t)bs * H + hh) * D + j;
  const uint4 lo_raw = *reinterpret_cast<const uint4*>(x);
  const uint4 hi_raw = *reinterpret_cast<const uint4*>(x + HALF);
  const float4 c0 = *reinterpret_cast<const float4*>(c);
  const float4 c1 = *reinterpret_cast<const float4*>(c + 4);
  const float4 s0 = *reinterpret_cast<const float4*>(sn);
  const float4 s1 = *reinterpret_cast<const float4*>(sn + 4);
  const __nv_bfloat162* lo2 = reinterpret_cast<const __nv_bfloat162*>(&lo_raw);
  const __nv_bfloat162* hi2 = reinterpret_cast<const __nv_bfloat162*>(&hi_raw);
  const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint32_t lo_out[4], hi_out[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xl = __bfloat1622float2(lo2[e]);
    const float2 xh = __bfloat1622float2(hi2[e]);
    const float ca = cv[2 * e], cb = cv[2 * e + 1];
    const float sa = sv[2 * e], sb = sv[2 * e + 1];
    lo_out[e] = pack_bf16x2(__fsub_rn(__fmul_rn(ca, xl.x), __fmul_rn(sa, xh.x)),
                            __fsub_rn(__fmul_rn(cb, xl.y), __fmul_rn(sb, xh.y)));
    hi_out[e] = pack_bf16x2(__fadd_rn(__fmul_rn(ca, xh.x), __fmul_rn(sa, xl.x)),
                            __fadd_rn(__fmul_rn(cb, xh.y), __fmul_rn(sb, xl.y)));
  }
  *reinterpret_cast<uint4*>(y) = make_uint4(lo_out[0], lo_out[1], lo_out[2], lo_out[3]);
  *reinterpret_cast<uint4*>(y + HALF) = make_uint4(hi_out[0], hi_out[1], hi_out[2], hi_out[3]);
}

// ---------------------------------------------------------------------------
// The int8 body (K9, K10, both; K14's int8 entries)
// ---------------------------------------------------------------------------

// q bf16 [B, H, Sq, 128]; the prepass (csrc/flash_quant.cu, or the plain
// ops/flash.py quantize_k / quantize_v on the CPU) gives k and v int8 with
// one f32 scale per quantization block of QB kv rows (QB = JAX's kv block, a
// multiple of 128; Skv_p = Skv rounded up to QB, zero rows).
//
// S8_QK (K9): k int8 [B, H, Skv_p, 128], sk f32 [B, H, Skv_p / QB]. Each
//   consumer warpgroup quantizes its 64 q rows once per block, per row: sq =
//   max|q| / 127 (IEEE quotient; 1 for a zero row), qq = round-half-even(q /
//   sq). QK^T runs on wgmma s8 -> s32 (exact), and s = f32(s_i) * (sq * (sk
//   * scale)), each product rounded on its own, as the Pallas kernel orders
//   it (s_i converts exactly by the 2^23 trick: |s_i| <= 127 * 127 * 128 <
//   2^22). Row maxima are taken on the raw s_i: f32 conversion and products
//   by positive factors are monotone, so max(f(x)) = f(max x) bit for bit.
//   Without S8_PV the online softmax and the bf16 P.V run over K3's
//   64-column blocks, the exps as expf (below).
// S8_PV (K10): v int8, centred on its per-(b, h) channel mean vm f32
//   [B, H, 128], scale sv f32 [B, H, Skv_p / QB], laid out [B, H, 128,
//   Skv_p] (kv contiguous: int8 wgmma takes only K-major operands) with the
//   rows of each 32-row chunk permuted (ops/flash.py v_kernel_layout) so
//   that a thread's p values, held in the QK^T accumulator's layout, are its
//   int8 A fragment as they stand. p is referenced to the row max of the
//   whole quantization block, as in JAX, so each block takes two passes over
//   its k tiles: the first computes QK^T for the block's row max m_blk (on
//   the raw scores: under S8_QK integer wgmma and IMNMX alone); the second
//   computes QK^T again, p = exp(s - (m_blk - ln 127)) in [0, 127], pq =
//   trunc(p + 0.5), and accumulates P.V and sum(pq) in int32 across the
//   block's tiles (1536 * 127 * 127 < 2^31), which is JAX's one int32 dot per
//   block. Once per block: m_next = max(m, m_blk), alpha = exp(m - m_next),
//   beta = exp(m_blk - m_next), acc = acc * alpha + f32(pv) * (beta * (sv /
//   127)), l = l * alpha + (f32(sum pq) * (1/127)) * beta. The output is acc
//   * (1 / l) + vm. The second QK^T pass is this design's own cost (the
//   Pallas kernel holds a whole block in VMEM; a 64 x 1536 f32 score block
//   per warpgroup does not fit in shared memory).
// Every exp is expf of a difference rounded on its own (s - ref, m - m_next,
// s - m_new), each score s = f32(s_i) * fac rounded before it, so that pq =
// trunc(p + 0.5) is the plain version's bit for bit (no log2(e) folded into
// an FFMA and MUFU.EX2, as K3 does: that moves p by a few ulps, and pq
// where p lies that close to k + 0.5). trunc(p + 0.5) is taken on the FMA
// pipe: for t in [0, 2^23), t + 2^23 rounded toward zero is 2^23 + trunc(t)
// exactly, and its low byte is the code; sum(pq) takes four codes per
// IDP4A.
// Ragged kv: columns at or past Skv are masked (p = 0, pq = 0; the padded k
// and v rows are zero); tiles past the last real row are not visited.
// Padded q rows are zero (sq = 1) and not written.
//
// Bound on the H100: the tensor-core rate (4 B H S^2 D operations, the int8
// halves at the int8 rate), plus under S8_PV the second QK^T; under S8_PV
// pass 1's expf (one MUFU.EX2 at 16 a clock per SM, and its range reduction
// on the FMA pipe, per score) takes longer than the products. Design, the bf16 body's: a block owns 128 q rows of one (batch,
// head), 64 for each of two consumer warpgroups (setmaxnreg 24 / 240 gives
// them the producer's registers); one producer thread streams k tiles (int8:
// one box of KV rows x 128 bytes; bf16: two 64-column boxes) and v tiles
// (int8 v^T: one box of 128 channels x 128 kv bytes; bf16: two boxes)
// through a TMA ring, k and v on barriers of their own (pass 0 loads no v:
// the producer arrives on its barrier without bytes, so both barriers keep
// one phase per step). QK^T is wgmma m64nKVk32 s8 (q's int8 fragments
// reloaded from shared memory as 16-byte loads in fragment order) or
// m64nKVk16 bf16 (the TMA'd q tile); P.V is m64n128k32 s8 (pq packed from
// S's accumulator, B the v^T tile) or m64n128k16 bf16 (B MN-major). The two
// warpgroups take turns on the tensor cores (see the loop), so one's
// softmax runs under the other's products; the k scale of the next tile is
// loaded a turn ahead.
constexpr float LOG127 = 4.844187086458591f;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);

// One block's tiles and shared memory. kv tiles of KV rows: 128 under S8_PV
// (any tile that divides the quantization block gives the block the same
// int32 sums and row max), else the 64-column softmax blocks of K3 and the
// plain versions. After the bf16 q tile (2 * QBOX): the int8 q in fragment
// order (S8_QK), the k and v rings of STAGES stages, each thread's f32 O
// (S8_PV: it is touched twice per block, scaled by alpha after pass 0 and
// folded after pass 1, so it waits in shared memory and its registers hold
// the block's int32 P.V sums), the q row scales (S8_QK) and the barriers.
template <bool S8_QK, bool S8_PV>
struct Int8Layout {
  static constexpr int KV = S8_PV ? 128 : 64;
  static constexpr int STAGES = !S8_PV ? 6 : S8_QK ? 3 : 2;
  static constexpr int KBOX = KV * 128;                   // an int8 k tile or a 64-column bf16 box
  static constexpr int KT = S8_QK ? KBOX : 2 * KBOX;      // one k tile
  static constexpr int VT = S8_PV ? D * KV : 2 * KBOX;    // one v tile (v^T when int8)
  static constexpr int QQ_OFF = 2 * QBOX;
  static constexpr int K_OFF = QQ_OFF + (S8_QK ? WQ * D : 0);
  static constexpr int V_OFF = K_OFF + STAGES * KT;
  static constexpr int O_OFF = V_OFF + STAGES * VT;
  static constexpr int SQ_OFF = O_OFF + (S8_PV ? WQ * D * 4 : 0);
  static constexpr int BAR_OFF = SQ_OFF + (S8_QK ? WQ * 4 : 0);
  static constexpr size_t BYTES = 1024 + BAR_OFF + (1 + 3 * STAGES) * sizeof(uint64_t);
};

__device__ __forceinline__ float absmax8(uint4 raw) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float ax = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ax = fmaxf(ax, fabsf(__bfloat162float(x[e])));
  return ax;
}

// Exact float of an s32 with |v| < 2^22: v + 1.5 * 2^23 lies in [2^23,
// 2^24), where every integer is a float (qmm_s8.cu's fold).
__device__ __forceinline__ float small_int_to_float(int32_t v) {
  return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.0f);
}

template <bool S8_QK, bool S8_PV, bool LSE>
__device__ __forceinline__ void flash_int8_body(const Maps& maps, const float* __restrict__ sk,
                                                const float* __restrict__ sv,
                                                const float* __restrict__ vm,
                                                __nv_bfloat16* __restrict__ out,
                                                float* __restrict__ lse, int H, int Sq, int Skv,
                                                int QB, float scale) {
  using L = Int8Layout<S8_QK, S8_PV>;
  constexpr int KV = L::KV;
  constexpr int STAGES = L::STAGES;
  using Acc = std::conditional_t<S8_QK, int32_t, float>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  float* sq_s = reinterpret_cast<float*>(sm + L::SQ_OFF);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * WQ;
  const int nblk = (Skv + QB - 1) / QB;
  const int nkv = (Skv + KV - 1) / KV;  // k tiles with a real row
  const int tpb = QB / KV;               // k tiles per quantization block

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread loads q once and keeps the ring full.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * QBOX);
      tma_load_3d(sm, &maps.q, 0, q0, bh, bar_q);
      tma_load_3d(sm + QBOX, &maps.q, HALF, q0, bh, bar_q);
      // ring steps in the consumers' order: with S8_PV each quantization
      // block's tiles twice, k alone (pass 0: the row max) then k and v
      int s = 0;
      auto load = [&](int j, bool with_v) {
        const int buf = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[buf], ((s / STAGES) + 1) & 1);
        ++s;
        uint8_t* kt = sm + L::K_OFF + buf * L::KT;
        mbar_expect_tx(&full_k[buf], L::KT);
        tma_load_3d(kt, &maps.k, 0, j * KV, bh, &full_k[buf]);
        if constexpr (!S8_QK) tma_load_3d(kt + L::KBOX, &maps.k, HALF, j * KV, bh, &full_k[buf]);
        if (!with_v) {  // complete the v barrier's phase without bytes
          mbar_arrive(&full_v[buf]);
          return;
        }
        uint8_t* vt = sm + L::V_OFF + buf * L::VT;
        mbar_expect_tx(&full_v[buf], L::VT);
        if constexpr (S8_PV) {
          tma_load_3d(vt, &maps.v, j * KV, 0, bh, &full_v[buf]);
        } else {
          tma_load_3d(vt, &maps.v, 0, j * KV, bh, &full_v[buf]);
          tma_load_3d(vt + L::KBOX, &maps.v, HALF, j * KV, bh, &full_v[buf]);
        }
      };
      if constexpr (S8_PV) {
        for (int base = 0; base < nkv; base += tpb) {
          const int c = min(tpb, nkv - base);
          for (int jj = 0; jj < c; ++jj) load(base + jj, false);
          for (int jj = 0; jj < c; ++jj) load(base + jj, true);
        }
      } else {
        for (int j = 0; j < nkv; ++j) load(j, true);
      }
    }
    return;
  }

  // Consumer warpgroups: rows 64 cw .. 64 cw + 63 of the block.
  setmaxnreg_inc<240>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;
  const int w = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 64 * cw + 16 * w + g;  // block row of the fragments' first row; + 8 the second
  mbar_wait(bar_q, 0);

  // int8 q in fragment order: word i of lane l of warp w's k32 slice kk
  // (rows 16w + g + 8 (i & 1), bytes 32kk + 16 (i >> 1) + 4t..) at word
  // (((4 cw + w) * 4 + kk) * 32 + l) * 4 + i, so a thread's 16 words are four
  // 16-byte loads.
  uint8_t* qq_s = sm + L::QQ_OFF;
  if constexpr (S8_QK) {
    // two threads per row, one 64-column box each (128-byte swizzle: chunk
    // c of row r at chunk c ^ (r & 7))
    const int lt = ct & 127;
    const int r = 64 * cw + (lt >> 1);
    const int half = lt & 1;
    const uint8_t* row = sm + half * QBOX + r * 128;
    uint4 raw[8];
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      raw[c] = *reinterpret_cast<const uint4*>(row + ((c ^ (r & 7)) << 4));
      amax = fmaxf(amax, absmax8(raw[c]));
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    const float sqr = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
    const Divisor dq = divisor(sqr);
    const int rw = (r >> 4) & 3, rg = r & 7, rh = (r >> 3) & 1;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw[c]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 64 * half + 8 * c + 4 * u;  // four columns col..col+3
        int qi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qi[e] = __float2int_rn(quotient(__bfloat162float(x[4 * u + e]), dq));
        const int word = ((((4 * cw + rw) * 4 + (col >> 5)) * 32 + 4 * rg + ((col >> 2) & 3)) * 4 +
                          2 * ((col >> 4) & 1) + rh);
        reinterpret_cast<uint32_t*>(qq_s)[word] =
            low_bytes((uint32_t)qi[0], (uint32_t)qi[1], (uint32_t)qi[2], (uint32_t)qi[3]);
      }
    }
    if (half == 0) sq_s[r] = sqr;
    named_barrier(1 + cw, 128);
  }

  // bf16 q fragments of the 8 k16 slices (the bf16 body's load_q); int8 q
  // fragments of the 4 k32 slices. Both are loaded again for every kv tile:
  // wgmma A registers are not kept across the loop (see load_q in the bf16
  // body).
  auto load_q16 = [&](uint32_t (&qa)[D / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint8_t* box = sm + (kk >> 2) * QBOX;
      const int c = 2 * (kk & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 8 * (i & 1);
        qa[kk][i] = *reinterpret_cast<const uint32_t*>(
            box + r * 128 + (((c + (i >> 1)) ^ (r & 7)) << 4) + 4 * t);
      }
    }
  };
  auto load_q8 = [&](uint32_t (&qa)[D / 32][4]) {
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const uint4 v4 = *reinterpret_cast<const uint4*>(
          qq_s + (((4 * cw + w) * 4 + kk) * 32 + lane) * 16);
      qa[kk][0] = v4.x;
      qa[kk][1] = v4.y;
      qa[kk][2] = v4.z;
      qa[kk][3] = v4.w;
    }
  };

  // o[4j + 2h + e]: row r0 + 8h, column 8j + 2t + e (wgmma's D layout); the
  // same for S (sc, columns of the kv tile) and P.V's int32 sums (pv).
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // S8_PV: O in shared memory, o[4q..4q+3] of this thread at o_s()[32q]
  auto o_s = [&]() {
    return reinterpret_cast<float4*>(sm + L::O_OFF) + (4 * cw + w) * (D / 8) * 32 + lane;
  };
  if constexpr (S8_PV) {
#pragma unroll
    for (int q4 = 0; q4 < D / 8; ++q4) o_s()[32 * q4] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  Acc sc[KV / 2];
#pragma unroll
  for (int i = 0; i < KV / 2; ++i) sc[i] = 0;
  int32_t pv[S8_PV ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (S8_PV ? D / 2 : 1); ++i) pv[i] = 0;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  // S8_PV: the block's raw row max so far (int32 under S8_QK), its factors,
  // and this thread's part of the block's sum(pq)
  int32_t mxi[2] = {INT_MIN, INT_MIN};
  float mxf[2] = {NEG_INF, NEG_INF};
  float beta[2] = {1.f, 1.f}, ref[2] = {0.f, 0.f};
  uint32_t lq[2] = {0u, 0u};
  // P of the step whose P.V is issued in the next turn (int8 codes or bf16)
  uint32_t pa[S8_PV ? KV / 32 : KV / 16][4];

  // The two consumer warpgroups take turns on the tensor cores (named
  // barriers 3 and 4, warpgroup 0 first): in its turn a warpgroup issues the
  // previous step's P.V and this step's QK^T and hands the turn over; it
  // then waits for them and runs its softmax while the other warpgroup's
  // products run. Every turn is straight-line code (no wgmma under a
  // branch, which ptxas would serialize): the first turn of a run of tiles
  // issues QK^T alone, the last P.V alone. Both warpgroups take the same
  // turns; warpgroup 1 hands over the last one to nobody.
  const int my_turn = 3 + cw, other_turn = 4 - cw;
  if (cw == 1) named_barrier_arrive(3, 256);
  int s_ = 0;  // ring steps consumed, in the producer's order
  auto turn_end = [&](bool final) {
    wgmma_commit();
    if (cw == 0 || !final) named_barrier_arrive(other_turn, 256);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) reg_fence(sc[i]);
    if constexpr (S8_PV) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(pv[i]);
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(o[i]);
    }
  };
  // S = Q K^T of the ring's next step
  auto issue_qk = [&]() {
    const int buf = s_ % STAGES;
    const uint32_t parity = (s_ / STAGES) & 1;
    const uint8_t* kt = sm + L::K_OFF + buf * L::KT;
    if constexpr (S8_QK) {
      uint32_t qa[D / 32][4];
      load_q8(qa);
      mbar_wait(&full_k[buf], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        if constexpr (KV == 128) {
          wgmma_s8_m64n128k32(sc, qa[kk], wgmma_desc(kt + 32 * kk, 1024, 1), kk > 0);
        } else {
          wgmma_s8_m64n64k32(sc, qa[kk], wgmma_desc(kt + 32 * kk, 1024, 1), kk > 0);
        }
      }
    } else {
      uint32_t qa[D / 16][4];
      load_q16(qa);
      mbar_wait(&full_k[buf], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaBf16<KV, 0>::run(
            sc, qa[kk], wgmma_desc(kt + (kk >> 2) * L::KBOX + 32 * (kk & 3), 1024, 1), kk > 0);
    }
  };
  // O (or the block's int32 sums, restarted when `first`) += P V of the
  // step `ps` whose P is in pa
  auto issue_pv = [&](int ps, bool first) {
    const int buf = ps % STAGES;
    const uint8_t* vt = sm + L::V_OFF + buf * L::VT;
    mbar_wait(&full_v[buf], (ps / STAGES) & 1);
    wgmma_fence();
    if constexpr (S8_PV) {
#pragma unroll
      for (int kc = 0; kc < KV / 32; ++kc)
        wgmma_s8_m64n128k32(pv, pa[kc], wgmma_desc(vt + 32 * kc, 1024, 1),
                            (kc > 0 || !first) ? 1 : 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < KV / 16; ++kk)
        WgmmaBf16<D, 1>::run(o, pa[kk], wgmma_desc_mn(vt + kk * 16 * 128, L::KBOX, 1024), 1);
    }
  };
  auto release = [&](int ps) {
    if (lane == 0) mbar_arrive(&empty[ps % STAGES]);
  };

  // Entry i of kv tile j's sc lies at or past Skv; the max of raw scores;
  // the factors fac[row] that scale them (s = raw * fac, natural-log units).
  auto masked = [&](int j, int i) { return j * KV + (i >> 2) * 8 + 2 * t + (i & 1) >= Skv; };
  Acc lowest;
  if constexpr (S8_QK) lowest = INT_MIN;
  else lowest = NEG_INF;
  auto amax = [](Acc a, Acc b) {
    if constexpr (S8_QK) return max(a, b);
    else return fmaxf(a, b);
  };
  auto factors = [&](float skb, float (&fac)[2]) {  // skb: the tile's block's k scale
    fac[0] = fac[1] = scale;
    if constexpr (S8_QK) {
      const float skj = __fmul_rn(skb, scale);
      fac[0] = __fmul_rn(sq_s[r0], skj);  // the rows' q scales, kept in shared memory
      fac[1] = __fmul_rn(sq_s[r0 + 8], skj);
    }
  };
  // The k scale of tile j's block, loaded a turn before it is needed: the
  // load's latency then lies under the turn (named_barrier's "memory"
  // clobber keeps it in place).
  auto k_scale = [&](int j) { return S8_QK ? sk[(size_t)bh * nblk + (j * KV) / QB] : 0.f; };

  if constexpr (S8_PV) {
    for (int base = 0; base < nkv; base += tpb) {
      const int c = min(tpb, nkv - base);
      const int blk = base / tpb;
      const float sk_blk = k_scale(base);
      // pass 0: the block's row max on the raw scores
      for (int jj = 0; jj < c; ++jj) {
        named_barrier(my_turn, 256);
        issue_qk();
        turn_end(false);
        release(s_++);
        const int j = base + jj;
        // eight partial maxima: entries i & 7 in {0, 1, 4, 5} are row r0,
        // {2, 3, 6, 7} row r0 + 8
        Acc pm[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) pm[u] = lowest;
        if ((j + 1) * KV > Skv) {
#pragma unroll
          for (int i = 0; i < KV / 2; ++i)
            if (!masked(j, i)) pm[i & 7] = amax(pm[i & 7], sc[i]);
        } else {
#pragma unroll
          for (int i = 0; i < KV / 2; ++i) pm[i & 7] = amax(pm[i & 7], sc[i]);
        }
        if constexpr (S8_QK) {
          mxi[0] = max(mxi[0], max(max(pm[0], pm[1]), max(pm[4], pm[5])));
          mxi[1] = max(mxi[1], max(max(pm[2], pm[3]), max(pm[6], pm[7])));
        } else {
          mxf[0] = fmaxf(mxf[0], fmaxf(fmaxf(pm[0], pm[1]), fmaxf(pm[4], pm[5])));
          mxf[1] = fmaxf(mxf[1], fmaxf(fmaxf(pm[2], pm[3]), fmaxf(pm[6], pm[7])));
        }
      }
      float fac[2], alpha[2];
      factors(sk_blk, fac);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m_blk;
        if constexpr (S8_QK) {
          mxi[r] = max(mxi[r], __shfl_xor_sync(0xffffffffu, mxi[r], 1));
          mxi[r] = max(mxi[r], __shfl_xor_sync(0xffffffffu, mxi[r], 2));
          m_blk = __fmul_rn(__int2float_rn(mxi[r]), fac[r]);
        } else {
          mxf[r] = fmaxf(mxf[r], __shfl_xor_sync(0xffffffffu, mxf[r], 1));
          mxf[r] = fmaxf(mxf[r], __shfl_xor_sync(0xffffffffu, mxf[r], 2));
          m_blk = __fmul_rn(mxf[r], scale);
        }
        const float m_next = fmaxf(m_run[r], m_blk);
        alpha[r] = expf(__fsub_rn(m_run[r], m_next));
        beta[r] = expf(__fsub_rn(m_blk, m_next));
        ref[r] = __fsub_rn(m_blk, LOG127);
        m_run[r] = m_next;
        mxi[r] = INT_MIN;
        mxf[r] = NEG_INF;
        l_run[r] = __fmul_rn(l_run[r], alpha[r]);  // the fold adds the block's share
      }
      // acc * alpha now (the same product the fold would take), so alpha is
      // not kept through pass 1
#pragma unroll
      for (int q4 = 0; q4 < D / 8; ++q4) {
        float4 v4 = o_s()[32 * q4];
        v4.x = __fmul_rn(v4.x, alpha[0]);
        v4.y = __fmul_rn(v4.y, alpha[0]);
        v4.z = __fmul_rn(v4.z, alpha[1]);
        v4.w = __fmul_rn(v4.w, alpha[1]);
        o_s()[32 * q4] = v4;
      }
      // pass 1: s = f32(s_i) * fac, pq = trunc(expf(s - (m_blk - ln 127)) +
      // 0.5) as its bits' low byte; P.V (in the next turn) and sum(pq) in
      // int32 over the block
      auto quantize_p = [&](int j) {
        const bool ragged = (j + 1) * KV > Skv;
        // kv slice kc is S columns 32kc.. : accumulator entries 16kc.. (rows
        // g: +0, +1, +4, +5; g + 8: +2, +3, +6, +7; then the same + 8 for
        // columns 32kc + 16..), v_kernel_layout's order of the v^T columns
#pragma unroll
        for (int kc = 0; kc < KV / 32; ++kc) {
          uint32_t code[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int i = 16 * kc + u;
            float raw;
            if constexpr (S8_QK) {
              raw = small_int_to_float(sc[i]);
            } else {
              raw = sc[i];
            }
            const float sf = __fmul_rn(raw, fac[(u >> 1) & 1]);
            const float p = expf(__fsub_rn(sf, ref[(u >> 1) & 1]));
            code[u] = __float_as_uint(__fadd_rz(__fadd_rn(p, 0.5f), 8388608.f));
          }
          if (ragged) {  // the padded columns' codes are 0 (their p is not)
#pragma unroll
            for (int u = 0; u < 16; ++u)
              if (masked(j, 16 * kc + u)) code[u] = 0u;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c0 = 8 * (i >> 1) + 2 * (i & 1);
            pa[kc][i] = low_bytes(code[c0], code[c0 + 1], code[c0 + 4], code[c0 + 5]);
            lq[i & 1] = __dp4a(pa[kc][i], 0x01010101u, lq[i & 1]);  // sum(pq), four at a time
          }
        }
      };
      named_barrier(my_turn, 256);
      issue_qk();
      turn_end(false);
      quantize_p(base);
      ++s_;
      for (int jj = 1; jj < c; ++jj, ++s_) {
        named_barrier(my_turn, 256);
        issue_pv(s_ - 1, jj == 1);
        issue_qk();
        turn_end(false);
        release(s_ - 1);
        quantize_p(base + jj);
      }
      const float sv_blk = sv[(size_t)bh * nblk + blk];  // for the fold, under the turn
      named_barrier(my_turn, 256);
      issue_pv(s_ - 1, c == 1);
      turn_end(base + tpb >= nkv);
      release(s_ - 1);
      // fold the block into acc and l
      const float svq = __fdiv_rn(sv_blk, 127.f);
      float svs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int lsum = static_cast<int>(lq[r]);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
        const float l_q = __fmul_rn(__int2float_rn(lsum), INV127);
        l_run[r] = __fadd_rn(l_run[r], __fmul_rn(l_q, beta[r]));
        svs[r] = __fmul_rn(beta[r], svq);
        lq[r] = 0u;
      }
      auto fold1 = [&](float acc, int32_t sum, int r) {
        return __fadd_rn(acc, __fmul_rn(__int2float_rn(sum), svs[r]));
      };
#pragma unroll
      for (int q4 = 0; q4 < D / 8; ++q4) {
        float4 v4 = o_s()[32 * q4];
        v4.x = fold1(v4.x, pv[4 * q4], 0);
        v4.y = fold1(v4.y, pv[4 * q4 + 1], 0);
        v4.z = fold1(v4.z, pv[4 * q4 + 2], 1);
        v4.w = fold1(v4.w, pv[4 * q4 + 3], 1);
        o_s()[32 * q4] = v4;
      }
    }
#pragma unroll
    for (int q4 = 0; q4 < D / 8; ++q4) {
      const float4 v4 = o_s()[32 * q4];
      o[4 * q4] = v4.x;
      o[4 * q4 + 1] = v4.y;
      o[4 * q4 + 2] = v4.z;
      o[4 * q4 + 3] = v4.w;
    }
  } else {
    // The online softmax over each 64-column tile, bf16 P.V (the bf16
    // body's). The tile's row max is taken on the raw int32 scores (monotone,
    // as in pass 0); s = f32(s_i) * fac, alpha = expf(m - m_new), p =
    // expf(s - m_new). softmax() leaves p in s and alpha in al; O is rescaled
    // and P packed only once the previous tile's P.V, which runs under
    // softmax(), has finished (rescale_pack()).
    float s[KV / 2], al[2];
    auto softmax = [&](int j, float skj) {
      float fac[2];
      factors(skj, fac);
      const bool ragged = (j + 1) * KV > Skv;
      // partial maxima and sums of entries i & 7: {0, 1, 4, 5} row r0,
      // {2, 3, 6, 7} row r0 + 8
      Acc pm[8];
      float ps[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        pm[u] = lowest;
        ps[u] = 0.f;
      }
      if (ragged) {
#pragma unroll
        for (int i = 0; i < KV / 2; ++i)
          if (!masked(j, i)) pm[i & 7] = amax(pm[i & 7], sc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < KV / 2; ++i) pm[i & 7] = amax(pm[i & 7], sc[i]);
      }
      Acc mr[2] = {amax(amax(pm[0], pm[1]), amax(pm[4], pm[5])),
                   amax(amax(pm[2], pm[3]), amax(pm[6], pm[7]))};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mr[r] = amax(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 1));
        mr[r] = amax(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 2));
        const float m_new = fmaxf(m_run[r], __fmul_rn(__int2float_rn(mr[r]), fac[r]));
        al[r] = expf(__fsub_rn(m_run[r], m_new));
        m_run[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < KV / 2; ++i)
        s[i] = __fmul_rn(small_int_to_float(sc[i]), fac[(i >> 1) & 1]);
      if (ragged) {
#pragma unroll
        for (int i = 0; i < KV / 2; ++i)
          if (masked(j, i)) s[i] = NEG_INF;
      }
#pragma unroll
      for (int i = 0; i < KV / 2; ++i) {
        const float p = expf(__fsub_rn(s[i], m_run[(i >> 1) & 1]));
        s[i] = p;
        ps[i & 7] += p;
      }
      float ls[2] = {(ps[0] + ps[1]) + (ps[4] + ps[5]), (ps[2] + ps[3]) + (ps[6] + ps[7])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
        l_run[r] = l_run[r] * al[r] + ls[r];
      }
    };
    auto rescale_pack = [&]() {
      if (!__all_sync(0xffffffffu, al[0] == 1.f && al[1] == 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= al[(i >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < KV / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    };
    float skj = k_scale(0);
    named_barrier(my_turn, 256);
    issue_qk();
    turn_end(false);
    softmax(0, skj);
    rescale_pack();
    for (s_ = 1; s_ < nkv; ++s_) {
      skj = k_scale(s_);
      // the turn: this tile's QK^T, then the previous tile's P.V, as two
      // groups, so that the softmax starts when QK^T is done
      named_barrier(my_turn, 256);
      issue_qk();
      wgmma_commit();
      issue_pv(s_ - 1, false);
      wgmma_commit();
      named_barrier_arrive(other_turn, 256);
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < KV / 2; ++i) reg_fence(sc[i]);
      softmax(s_, skj);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(o[i]);
      release(s_ - 1);
      rescale_pack();
    }
    named_barrier(my_turn, 256);
    issue_pv(s_ - 1, false);
    turn_end(true);
    release(s_ - 1);
  }

  const int HD = H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Sq) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    const float inv = __frcp_rn(l);
    __nv_bfloat16* orow = out + ((size_t)b * Sq + row) * HD + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + 2 * t;
      float v0 = __fmul_rn(o[4 * i + 2 * r], inv);
      float v1 = __fmul_rn(o[4 * i + 2 * r + 1], inv);
      if constexpr (S8_PV) {
        v0 = __fadd_rn(v0, vm[(size_t)bh * D + col]);
        v1 = __fadd_rn(v1, vm[(size_t)bh * D + col + 1]);
      }
      *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16x2(v0, v1);
    }
    if constexpr (LSE) {
      if (t == 0) lse[(size_t)bh * Sq + row] = __fadd_rn(m_run[r], logf(l));
    }
  }
}

template <bool S8_QK, bool S8_PV>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_int8_kernel(const __grid_constant__ Maps maps, const float* __restrict__ sk,
                  const float* __restrict__ sv, const float* __restrict__ vm,
                  __nv_bfloat16* __restrict__ out, int H, int Sq, int Skv, int QB, float scale) {
  flash_int8_body<S8_QK, S8_PV, false>(maps, sk, sv, vm, out, nullptr, H, Sq, Skv, QB, scale);
}

// K14, int8 modes: K9 / K10 / both plus lse f32 [B, H, Sq].
template <bool S8_QK, bool S8_PV>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_int8_lse_kernel(const __grid_constant__ Maps maps, const float* __restrict__ sk,
                      const float* __restrict__ sv, const float* __restrict__ vm,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                      int Skv, int QB, float scale) {
  flash_int8_body<S8_QK, S8_PV, true>(maps, sk, sv, vm, out, lse, H, Sq, Skv, QB, scale);
}
}  // namespace

// K3. q, k, v bf16 [B, H, S, 128] contiguous, 16-byte aligned; out bf16
// [B, Sq, H * 128]. Returns cudaGetLastError() or the tensor-map encoder's
// refusal.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, int B,
                         int H, int Sq, int Skv, float scale, void* stream) {
  return launch_wg<true, false>(q, k, v, out, nullptr, B, H, Sq, Skv, 0, 0, 0, 0, 0, 0, scale,
                                stream);
}

// K14, bf16: as flash_fwd, plus lse f32 [B, H, Sq] contiguous.
extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int H, int Sq, int Skv, float scale, void* stream) {
  return launch_wg<true, true>(q, k, v, out, lse, B, H, Sq, Skv, 0, 0, 0, 0, 0, 0, scale,
                               stream);
}

// K6. q bf16 [B, Sq, H * 128], k and v bf16 [B, Skv, H * 128], each with
// unit column stride and the given batch and row strides (elements, each a
// multiple of 8, the batch stride unused at B = 1; 16-byte aligned base:
// ops/flash.py flash_plan); out bf16
// [B, Sq, H * 128] contiguous. Returns as flash_fwd.
extern "C" int flash_sm(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int Sq, int Skv, long long q_sb, long long q_sr, long long k_sb,
                        long long k_sr, long long v_sb, long long v_sr, float scale,
                        void* stream) {
  return launch_wg<false, false>(q, k, v, out, nullptr, B, H, Sq, Skv, q_sb, q_sr, k_sb, k_sr,
                                 v_sb, v_sr, scale, stream);
}

// K7's attention: K6's kernel on the rotated q and k that rope_qk wrote;
// the same arguments as flash_sm.
extern "C" int flash_rope(const void* q, const void* k, const void* v, void* out, int B, int H,
                          int Sq, int Skv, long long q_sb, long long q_sr, long long k_sb,
                          long long k_sr, long long v_sb, long long v_sr, float scale,
                          void* stream) {
  return launch_wg<false, false>(q, k, v, out, nullptr, B, H, Sq, Skv, q_sb, q_sr, k_sb, k_sr,
                                 v_sb, v_sr, scale, stream);
}

// K7's rotation pass. q [B, Sq, H * 128] and k [B, Skv, H * 128] bf16 with
// unit column stride and the given batch and row strides (elements, each a
// multiple of 8, 16-byte aligned base); the expanded tables ce/se f32 [B,
// Sq, 128] (q) and [B, Skv, 128] (k), contiguous; qr / kr bf16 [B, S,
// H * 128] contiguous. Needs B * (Sq + Skv) * H * 8 < 2^31. Returns
// cudaGetLastError().
extern "C" int rope_qk(const void* q, const void* k, const void* ce_q, const void* se_q,
                       const void* ce_k, const void* se_k, void* qr, void* kr, int B, int H,
                       int Sq, int Skv, long long q_sb, long long q_sr, long long k_sb,
                       long long k_sr, void* stream) {
  const long long threads = (long long)B * (Sq + Skv) * H * 8;
  if (threads >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  rope_qk_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const float*>(ce_q),
      static_cast<const float*>(se_q), static_cast<const float*>(ce_k),
      static_cast<const float*>(se_k), static_cast<bf16*>(qr), static_cast<bf16*>(kr), B, H, Sq,
      Skv, q_sb, q_sr, k_sb, k_sr);
  return static_cast<int>(cudaGetLastError());
}

// K9 / K10 / both. q bf16 [B, H, Sq, 128] contiguous. k: int8 [B, H, Skv_p,
// 128] with sk f32 [B, H, Skv_p / QB] (S8_QK), else bf16 [B, H, Skv, 128]
// and sk unused. v: int8 [B, H, 128, Skv_p] in v_kernel_layout order with sv
// f32 [B, H, Skv_p / QB] and vm f32 [B, H, 128] (S8_PV), else bf16 [B, H,
// Skv, 128]. Skv_p = Skv rounded up to QB, a multiple of 128. Every operand
// 16-byte aligned (ops/flash.py int8_flash_plan). out bf16 [B, Sq, H * 128];
// the K14 forms also lse f32 [B, H, Sq]. Returns cudaGetLastError(), the
// tensor-map encoder's refusal, or cudaErrorInvalidValue for a bad QB.
template <bool S8_QK, bool S8_PV, bool LSE>
int launch_int8(const void* q, const void* k, const void* sk, const void* v,
                const void* sv, const void* vm, void* out, void* lse, int B, int H, int Sq,
                int Skv, int QB, float scale, void* stream) {
  if (QB <= 0 || QB % 128) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = Int8Layout<S8_QK, S8_PV>::BYTES;
  constexpr int KV = Int8Layout<S8_QK, S8_PV>::KV;
  {
    static size_t raised[MAX_DEVICES] = {};  // one per instance of the template
    const void* fn = LSE ? reinterpret_cast<const void*>(flash_int8_lse_kernel<S8_QK, S8_PV>)
                         : reinterpret_cast<const void*>(flash_int8_kernel<S8_QK, S8_PV>);
    const int err = raise_smem_limit(fn, smem, raised);
    if (err != 0) return err;
  }
  const uint64_t bh = (uint64_t)B * H;
  const uint64_t skv_p = (uint64_t)(Skv + QB - 1) / QB * QB;
  Maps maps;
  // q: (128, Sq, B*H), boxes of 128 rows x 64 columns
  const uint64_t qd[3] = {D, (uint64_t)Sq, bh};
  int err = encode_tensor_map_3d(&maps.q, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qd, D * 2,
                                 (uint64_t)Sq * D * 2, WQ, HALF, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) {
    if (S8_QK) {  // int8 k: (128, Skv_p, B*H), one box of 64 rows x 128 bytes
      const uint64_t kd[3] = {D, skv_p, bh};
      err = encode_tensor_map_3d(&maps.k, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, kd, D, skv_p * D, KV, D,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    } else {  // bf16 k: (128, Skv, B*H), boxes of 64 rows x 64 columns
      const uint64_t kd[3] = {D, (uint64_t)Skv, bh};
      err = encode_tensor_map_3d(&maps.k, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kd, D * 2,
                                 (uint64_t)Skv * D * 2, KV, HALF, CU_TENSOR_MAP_SWIZZLE_128B);
    }
  }
  if (err == 0) {
    if (S8_PV) {  // int8 v^T: (Skv_p, 128, B*H), one box of 128 rows x 128 bytes
      const uint64_t vd[3] = {skv_p, D, bh};
      err = encode_tensor_map_3d(&maps.v, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, vd, skv_p, D * skv_p,
                                 D, KV, CU_TENSOR_MAP_SWIZZLE_128B);
    } else {
      const uint64_t vd[3] = {D, (uint64_t)Skv, bh};
      err = encode_tensor_map_3d(&maps.v, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, vd, D * 2,
                                 (uint64_t)Skv * D * 2, KV, HALF, CU_TENSOR_MAP_SWIZZLE_128B);
    }
  }
  if (err != 0) return err;
  const dim3 grid((Sq + WQ - 1) / WQ, B * H);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* skf = static_cast<const float*>(sk);
  const auto* svf = static_cast<const float*>(sv);
  const auto* vmf = static_cast<const float*>(vm);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if constexpr (LSE) {
    flash_int8_lse_kernel<S8_QK, S8_PV><<<grid, WTHREADS, smem, st>>>(
        maps, skf, svf, vmf, o, static_cast<float*>(lse), H, Sq, Skv, QB, scale);
  } else {
    flash_int8_kernel<S8_QK, S8_PV><<<grid, WTHREADS, smem, st>>>(maps, skf, svf, vmf, o, H, Sq,
                                                                  Skv, QB, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_s8(const void* q, const void* k, const void* sk, const void* v,
                        const void* sv, const void* vm, void* out, int B, int H, int Sq,
                        int Skv, int QB, float scale, void* stream) {
  return launch_int8<true, false, false>(q, k, sk, v, sv, vm, out, nullptr, B, H, Sq, Skv,
                                         QB, scale, stream);
}

extern "C" int flash_s8pv(const void* q, const void* k, const void* sk, const void* v,
                          const void* sv, const void* vm, void* out, int B, int H, int Sq,
                          int Skv, int QB, float scale, void* stream) {
  return launch_int8<false, true, false>(q, k, sk, v, sv, vm, out, nullptr, B, H, Sq, Skv,
                                         QB, scale, stream);
}

extern "C" int flash_s8_s8pv(const void* q, const void* k, const void* sk, const void* v,
                             const void* sv, const void* vm, void* out, int B, int H, int Sq,
                             int Skv, int QB, float scale, void* stream) {
  return launch_int8<true, true, false>(q, k, sk, v, sv, vm, out, nullptr, B, H, Sq, Skv,
                                        QB, scale, stream);
}

// K14, int8 modes: as flash_s8 / flash_s8pv / flash_s8_s8pv, plus lse f32
// [B, H, Sq] contiguous (after out in the argument list).
#define FLASH_INT8_LSE(NAME, S8_QK, S8_PV)                                                     \
  extern "C" int NAME(const void* q, const void* k, const void* sk, const void* v,            \
                      const void* sv, const void* vm, void* out, void* lse, int B, int H,     \
                      int Sq, int Skv, int QB, float scale, void* stream) {                   \
    return launch_int8<S8_QK, S8_PV, true>(q, k, sk, v, sv, vm, out, lse, B, H, Sq, Skv, QB, \
                                           scale, stream);                                     \
  }
FLASH_INT8_LSE(flash_s8_lse, true, false)
FLASH_INT8_LSE(flash_s8pv_lse, false, true)
FLASH_INT8_LSE(flash_s8_s8pv_lse, true, true)
#undef FLASH_INT8_LSE

// The int8 body's tiling for a mode, as compiled: kv rows per tile, ring
// stages and dynamic shared-memory bytes (ops/flash.py int8_flash_plan holds
// the same numbers and its wrapper checks them against these). Launches
// nothing. Returns 0, or cudaErrorInvalidValue for no int8 mode.
extern "C" int flash_int8_layout(int s8_qk, int s8_pv, int* kv, int* stages, long long* smem) {
  auto get = [&](auto layout) {
    using L = decltype(layout);
    *kv = L::KV;
    *stages = L::STAGES;
    *smem = static_cast<long long>(L::BYTES);
    return 0;
  };
  if (s8_qk && s8_pv) return get(Int8Layout<true, true>{});
  if (s8_qk) return get(Int8Layout<true, false>{});
  if (s8_pv) return get(Int8Layout<false, true>{});
  return static_cast<int>(cudaErrorInvalidValue);
}
