// Flash attention forward, head_dim 128, output head-merged [B, Sq, H * 128].
// Two kernel bodies: the bf16 one below (a Hopper design: TMA, mbarrier
// ring, warp-specialised wgmma) with five entry points and the half-split
// RoPE pass, and the int8 one further down (mma.sync, cp.async) with six:
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
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wg_kernel<DENSE, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WSMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
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
// The int8 modes (K9, K10, both), mma.sync + cp.async: 64 q rows per block
// of four warps, kv tiles of 64 rows.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;        // 4 warps x 16 query rows
constexpr int STRIDE = D + 8;       // bf16: 272-byte rows, conflict-free ldmatrix
constexpr int TILE = BKV * STRIDE;  // elements per K or V tile

// q bf16 [B, H, Sq, 128]; the prepasses
// (ops/flash.py quantize_k / quantize_v, plain PyTorch) give k and v int8
// with one f32 scale per quantization block of QB kv rows (QB = JAX's kv
// block, a multiple of 128; Skv_p = Skv rounded up to QB, zero rows).
//
// S8_QK (K9): k int8 [B, H, Skv_p, 128], sk f32 [B, H, Skv_p / QB]. The q
//   tile is quantized once per block, per row: sq = max|q| / 127 (IEEE
//   quotient; 1 for a zero row), qq = round-half-even(q / sq). QK^T runs on
//   mma.sync m16n8k32 s8 -> s32 (exact), and s = f32(s_i) * (sq * (sk *
//   scale)), each product rounded on its own, as the Pallas kernel orders
//   it. Without S8_PV the softmax and the bf16 P.V are K3's.
// S8_PV (K10): v int8, centred on its per-(b, h) channel mean vm f32
//   [B, H, 128], scale sv f32 [B, H, Skv_p / QB], laid out [B, H, 128,
//   Skv_p] (kv contiguous, the int8 MMA's B operand) with the rows of each
//   32-row chunk permuted (ops/flash.py v_kernel_layout) so that a thread's
//   p values, held in the QK^T accumulator's layout, are its int8 A
//   fragment as they stand. p is referenced to the row max of the whole
//   quantization block, as in JAX, so each block takes two passes over its
//   64-row k tiles: the first computes QK^T for the block's row max m_blk;
//   the second computes QK^T again, p = exp(s - (m_blk - ln 127)) in
//   [0, 127], pq = trunc(p + 0.5), and accumulates P.V and sum(pq) in int32
//   across the block's tiles (1536 * 127 * 127 < 2^31), which is JAX's one
//   int32 dot per block. Once per block: m_next = max(m, m_blk), alpha =
//   exp(m - m_next), beta = exp(m_blk - m_next), acc = acc * alpha +
//   f32(pv) * (beta * (sv / 127)), l = l * alpha + (f32(sum pq) * (1/127)) *
//   beta. The output is acc * (1 / l) + vm. The second QK^T pass is this
//   design's own cost (the Pallas kernel holds a whole block in VMEM).
// Ragged kv: columns at or past Skv are masked to -1e30 (p = 0; the padded
// k and v rows are zero); tiles past the last real row are not visited.
// Padded q rows are zero (sq = 1) and not written.
constexpr int I8_STRIDE = D + 16;    // int8 q / k rows: 144 bytes, conflict-free ldmatrix
constexpr int VT_STRIDE = BKV + 16;  // int8 v^T rows, one per channel: 80 bytes
constexpr float LOG127 = 4.844187086458591f;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);

template <bool S8_QK, bool S8_PV>
struct Int8Smem {
  static constexpr int Q = BQ * STRIDE * 2;                       // bf16 q tile
  static constexpr int QQ = S8_QK ? BQ * I8_STRIDE : 0;           // int8 q tile
  static constexpr int SQ = S8_QK ? BQ * 4 : 0;                   // q row scales
  static constexpr int KT = S8_QK ? BKV * I8_STRIDE : TILE * 2;   // one k tile
  static constexpr int VT = S8_PV ? D * VT_STRIDE : TILE * 2;     // one v tile
  static constexpr size_t BYTES = (size_t)Q + QQ + SQ + 2 * KT + 2 * VT;
};

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8) | ((uint32_t)(c & 0xFF) << 16) |
         ((uint32_t)(d & 0xFF) << 24);
}

template <bool S8_QK, bool S8_PV, bool LSE = false>
__device__ __forceinline__ void flash_int8_body(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_,
    const float* __restrict__ sk, const void* __restrict__ v_, const float* __restrict__ sv,
    const float* __restrict__ vm, __nv_bfloat16* __restrict__ out, int H, int Sq, int Skv,
    int QB, float scale, float* __restrict__ lse = nullptr) {
  using L = Int8Smem<S8_QK, S8_PV>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);        // [BQ][STRIDE]
  int8_t* Qq = reinterpret_cast<int8_t*>(smem + L::Q);               // [BQ][I8_STRIDE]
  float* Sqs = reinterpret_cast<float*>(smem + L::Q + L::QQ);        // [BQ]
  unsigned char* Kb = smem + L::Q + L::QQ + L::SQ;                   // [2][k tile]
  unsigned char* Vb = Kb + 2 * L::KT;                                // [2][v tile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int nblk = (Skv + QB - 1) / QB;
  const int skv_p = nblk * QB;
  const int nkv = (Skv + BKV - 1) / BKV;  // k tiles with a real row
  const int tpb = QB / BKV;               // k tiles per quantization block
  const int nsteps = S8_PV ? 2 * nkv : nkv;
  const __nv_bfloat16* qg = q + (size_t)bh * Sq * D;
  const int8_t* kq = static_cast<const int8_t*>(k_) + (size_t)bh * skv_p * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(k_) + (size_t)bh * Skv * D;
  const int8_t* vt = static_cast<const int8_t*>(v_) + (size_t)bh * D * skv_p;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(v_) + (size_t)bh * Skv * D;

  // Step s -> (k tile j, pass, last tile of j's quantization block). With
  // S8_PV each block's tiles come twice: pass 0 (row max), then pass 1.
  auto step = [&](int s, int& j, int& pass, int& last) {
    if constexpr (S8_PV) {
      const int base = (s / (2 * tpb)) * tpb;
      const int c = min(tpb, nkv - base);
      const int local = s - 2 * base;
      pass = local >= c;
      j = base + (pass ? local - c : local);
      last = base + c - 1;
    } else {
      j = last = s;
      pass = 1;
    }
  };

  // Q tile: 64 rows x 16 chunks of 16 bytes.
  for (int c = tid; c < BQ * (D / 8); c += THREADS) {
    const int r = c >> 4;
    const int ch = c & 15;
    const int gr = q0 + r;
    cp_async16(Qs + r * STRIDE + ch * 8, qg + (size_t)(gr < Sq ? gr : 0) * D + ch * 8,
               gr < Sq ? 16 : 0);
  }
  cp_async_commit();

  auto load_step = [&](int s, int buf) {
    int j, pass, last;
    step(s, j, pass, last);
    unsigned char* kd = Kb + buf * L::KT;
    for (int c = tid; c < BKV * (D / 16 * (S8_QK ? 1 : 2)); c += THREADS) {
      if constexpr (S8_QK) {  // rows < Skv_p always: padded rows are zero
        const int r = c >> 3;
        const int ch = c & 7;
        cp_async16(kd + r * I8_STRIDE + ch * 16, kq + (size_t)(j * BKV + r) * D + ch * 16, 16);
      } else {
        const int r = c >> 4;
        const int ch = c & 15;
        const int gr = j * BKV + r;
        cp_async16(kd + (r * STRIDE + ch * 8) * 2, kg + (size_t)(gr < Skv ? gr : 0) * D + ch * 8,
                   gr < Skv ? 16 : 0);
      }
    }
    if (pass) {
      unsigned char* vd = Vb + buf * L::VT;
      if constexpr (S8_PV) {  // 128 channel rows x 64 kv bytes of v^T
        for (int c = tid; c < D * (BKV / 16); c += THREADS) {
          const int r = c >> 2;
          const int ch = c & 3;
          cp_async16(vd + r * VT_STRIDE + ch * 16, vt + (size_t)r * skv_p + j * BKV + ch * 16, 16);
        }
      } else {
        for (int c = tid; c < BKV * (D / 8); c += THREADS) {
          const int r = c >> 4;
          const int ch = c & 15;
          const int gr = j * BKV + r;
          cp_async16(vd + (r * STRIDE + ch * 8) * 2, vg + (size_t)(gr < Skv ? gr : 0) * D + ch * 8,
                     gr < Skv ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  load_step(0, 0);
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  if constexpr (S8_QK) {  // quantize the q tile: two threads per row, 64 columns each
    const int r = tid >> 1;
    const int c0 = (tid & 1) * 64;
    const __nv_bfloat16* row = Qs + r * STRIDE + c0;
    float amax = 0.f;
#pragma unroll 8
    for (int c = 0; c < 64; ++c) amax = fmaxf(amax, fabsf(__bfloat162float(row[c])));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    const float sqr = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
#pragma unroll 4
    for (int c = 0; c < 64; c += 4) {
      int qi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) qi[e] = __float2int_rn(__fdiv_rn(__bfloat162float(row[c + e]), sqr));
      *reinterpret_cast<uint32_t*>(Qq + r * I8_STRIDE + c0 + c) = pack_s8x4(qi[0], qi[1], qi[2], qi[3]);
    }
    if ((tid & 1) == 0) Sqs[r] = sqr;
    __syncthreads();
  }

  // q fragments: int8 (4 k-chunks of 32) or bf16 (8 k-chunks of 16).
  uint32_t qf[S8_QK ? D / 32 : D / 16][4];
  if constexpr (S8_QK) {
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      ldmatrix_x4(qf[kk], Qq + (warp * 16 + (lane & 15)) * I8_STRIDE + kk * 32 + (lane >> 4) * 16);
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * STRIDE + kk * 16 + (lane >> 4) * 8);
  }
  const float sq_row[2] = {S8_QK ? Sqs[warp * 16 + g] : 1.f, S8_QK ? Sqs[warp * 16 + g + 8] : 1.f};

  float o[D / 8][4];
  int32_t pvi[S8_PV ? D / 8 : 1][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < (S8_PV ? D / 8 : 1); ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pvi[i][e] = 0;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  float mx[2] = {NEG_INF, NEG_INF};          // S8_PV: the block's row max so far
  float alpha[2], beta[2], ref[2];           // S8_PV: this block's factors
  int lq[2] = {0, 0};                        // S8_PV: sum of pq over the block

  for (int s_ = 0; s_ < nsteps; ++s_) {
    const int buf = s_ & 1;
    if (s_ + 1 < nsteps) {
      load_step(s_ + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int j, pass, last;
    step(s_, j, pass, last);
    const unsigned char* kt = Kb + buf * L::KT;
    const unsigned char* vtile = Vb + buf * L::VT;

    // s = scaled QK^T for this warp's 16 rows x 64 kv columns, masked.
    float s[BKV / 8][4];
    if constexpr (S8_QK) {
      int32_t si[BKV / 8][4];
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) si[i][e] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) {
          uint32_t r4[4];
          ldmatrix_x4(r4, kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * I8_STRIDE + kk * 32 +
                              ((lane >> 3) & 1) * 16);
          const uint32_t b0[2] = {r4[0], r4[1]};
          const uint32_t b1[2] = {r4[2], r4[3]};
          mma_s8_16832(si[2 * jj], qf[kk], b0);
          mma_s8_16832(si[2 * jj + 1], qf[kk], b1);
        }
      }
      const float skj = __fmul_rn(sk[(size_t)bh * nblk + (j * BKV) / QB], scale);
      const float fac[2] = {__fmul_rn(sq_row[0], skj), __fmul_rn(sq_row[1], skj)};
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * BKV + i * 8 + 2 * t + (e & 1);
          s[i][e] = col < Skv ? __fmul_rn(__int2float_rn(si[i][e]), fac[e >> 1]) : NEG_INF;
        }
    } else {
      const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(kt);
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) {
          uint32_t r4[4];
          ldmatrix_x4(r4, ks + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * STRIDE + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          const uint32_t b0[2] = {r4[0], r4[1]};
          const uint32_t b1[2] = {r4[2], r4[3]};
          mma_bf16_16816(s[2 * jj], qf[kk], b0);
          mma_bf16_16816(s[2 * jj + 1], qf[kk], b1);
        }
      }
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * BKV + i * 8 + 2 * t + (e & 1);
          s[i][e] = col < Skv ? __fmul_rn(s[i][e], scale) : NEG_INF;
        }
    }

    if constexpr (S8_PV) {
      if (!pass) {  // pass 0: the block's row max
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
        if (j == last) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_next = fmaxf(m_run[r], mx[r]);
            alpha[r] = expf(__fsub_rn(m_run[r], m_next));
            beta[r] = expf(__fsub_rn(mx[r], m_next));
            ref[r] = __fsub_rn(mx[r], LOG127);
            m_run[r] = m_next;
            mx[r] = NEG_INF;
          }
        }
      } else {  // pass 1: int8 p, P.V and sum(pq) in int32
        int pq[BKV / 8][4];
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pq[i][e] = __float2int_rz(__fadd_rn(expf(__fsub_rn(s[i][e], ref[e >> 1])), 0.5f));
            lq[e >> 1] += pq[i][e];
          }
#pragma unroll
        for (int kc = 0; kc < BKV / 32; ++kc) {
          const int i0 = 4 * kc;
          const uint32_t pa[4] = {
              pack_s8x4(pq[i0][0], pq[i0][1], pq[i0 + 1][0], pq[i0 + 1][1]),
              pack_s8x4(pq[i0][2], pq[i0][3], pq[i0 + 1][2], pq[i0 + 1][3]),
              pack_s8x4(pq[i0 + 2][0], pq[i0 + 2][1], pq[i0 + 3][0], pq[i0 + 3][1]),
              pack_s8x4(pq[i0 + 2][2], pq[i0 + 2][3], pq[i0 + 3][2], pq[i0 + 3][3])};
#pragma unroll
          for (int dn = 0; dn < D / 16; ++dn) {
            uint32_t r4[4];
            ldmatrix_x4(r4, vtile + (dn * 16 + (lane & 7) + ((lane >> 4) << 3)) * VT_STRIDE +
                                kc * 32 + ((lane >> 3) & 1) * 16);
            const uint32_t b0[2] = {r4[0], r4[1]};
            const uint32_t b1[2] = {r4[2], r4[3]};
            mma_s8_16832(pvi[2 * dn], pa, b0);
            mma_s8_16832(pvi[2 * dn + 1], pa, b1);
          }
        }
        if (j == last) {  // fold the block into acc and l
          const float svq = __fdiv_rn(sv[(size_t)bh * nblk + (j * BKV) / QB], 127.f);
          float svs[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            lq[r] += __shfl_xor_sync(0xffffffffu, lq[r], 1);
            lq[r] += __shfl_xor_sync(0xffffffffu, lq[r], 2);
            const float l_q = __fmul_rn(__int2float_rn(lq[r]), INV127);
            l_run[r] = __fadd_rn(__fmul_rn(l_run[r], alpha[r]), __fmul_rn(l_q, beta[r]));
            svs[r] = __fmul_rn(beta[r], svq);
            lq[r] = 0;
          }
#pragma unroll
          for (int i = 0; i < D / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[i][e] = __fadd_rn(__fmul_rn(o[i][e], alpha[e >> 1]),
                                  __fmul_rn(__int2float_rn(pvi[i][e]), svs[e >> 1]));
              pvi[i][e] = 0;
            }
        }
      }
    } else {  // K3's online softmax over the tile, bf16 P.V
      float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[i][e]);
      float al[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m_run[r], mt[r]);
        al[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[i][e] - m_run[e >> 1]);
          s[i][e] = p;
          ls[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
        l_run[r] = l_run[r] * al[r] + ls[r];
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= al[e >> 1];
      const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(vtile);
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        uint32_t pa[4];
        pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
        pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
        pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t r4[4];
          ldmatrix_x4_trans(r4, vs + (kc * 16 + (lane & 15)) * STRIDE + dn * 16 + (lane >> 4) * 8);
          const uint32_t b0[2] = {r4[0], r4[1]};
          const uint32_t b1[2] = {r4[2], r4[3]};
          mma_bf16_16816(o[2 * dn], pa, b0);
          mma_bf16_16816(o[2 * dn + 1], pa, b1);
        }
      }
    }
    __syncthreads();
  }

  const int HD = H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    const float inv = __frcp_rn(l);
    __nv_bfloat16* orow = out + ((size_t)b * Sq + row) * HD + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + 2 * t;
      float v0 = __fmul_rn(o[i][2 * r], inv);
      float v1 = __fmul_rn(o[i][2 * r + 1], inv);
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
__global__ void __launch_bounds__(THREADS)
flash_int8_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                  const float* __restrict__ sk, const void* __restrict__ v,
                  const float* __restrict__ sv, const float* __restrict__ vm,
                  __nv_bfloat16* __restrict__ out, int H, int Sq, int Skv, int QB, float scale) {
  flash_int8_body<S8_QK, S8_PV>(q, k, sk, v, sv, vm, out, H, Sq, Skv, QB, scale);
}

// K14, int8 modes: K9 / K10 / both plus lse f32 [B, H, Sq].
template <bool S8_QK, bool S8_PV>
__global__ void __launch_bounds__(THREADS)
flash_int8_lse_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                      const float* __restrict__ sk, const void* __restrict__ v,
                      const float* __restrict__ sv, const float* __restrict__ vm,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                      int Skv, int QB, float scale) {
  flash_int8_body<S8_QK, S8_PV, true>(q, k, sk, v, sv, vm, out, H, Sq, Skv, QB, scale, lse);
}

// Sets the kernel's shared-memory limit once, then launches it.
template <class Kernel, class... Args>
int launch(Kernel kernel, size_t smem, bool& attr_set, int B, int H, int Sq, void* stream,
           Args... args) {
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
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
// Skv, 128]. Skv_p = Skv rounded up to QB, a multiple of 128. out bf16
// [B, Sq, H * 128]; the K14 forms also lse f32 [B, H, Sq]. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a bad QB.
template <bool S8_QK, bool S8_PV, bool LSE>
int launch_int8(bool& attr_set, const void* q, const void* k, const void* sk, const void* v,
                const void* sv, const void* vm, void* out, void* lse, int B, int H, int Sq,
                int Skv, int QB, float scale, void* stream) {
  if (QB <= 0 || QB % 128) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* skf = static_cast<const float*>(sk);
  const auto* svf = static_cast<const float*>(sv);
  const auto* vmf = static_cast<const float*>(vm);
  auto* o = static_cast<__nv_bfloat16*>(out);
  constexpr size_t smem = Int8Smem<S8_QK, S8_PV>::BYTES;
  if constexpr (LSE) {
    return launch(flash_int8_lse_kernel<S8_QK, S8_PV>, smem, attr_set, B, H, Sq, stream, qb, k,
                  skf, v, svf, vmf, o, static_cast<float*>(lse), H, Sq, Skv, QB, scale);
  } else {
    return launch(flash_int8_kernel<S8_QK, S8_PV>, smem, attr_set, B, H, Sq, stream, qb, k, skf,
                  v, svf, vmf, o, H, Sq, Skv, QB, scale);
  }
}

extern "C" int flash_s8(const void* q, const void* k, const void* sk, const void* v,
                        const void* sv, const void* vm, void* out, int B, int H, int Sq,
                        int Skv, int QB, float scale, void* stream) {
  static bool attr_set = false;
  return launch_int8<true, false, false>(attr_set, q, k, sk, v, sv, vm, out, nullptr, B, H, Sq,
                                         Skv, QB, scale, stream);
}

extern "C" int flash_s8pv(const void* q, const void* k, const void* sk, const void* v,
                          const void* sv, const void* vm, void* out, int B, int H, int Sq,
                          int Skv, int QB, float scale, void* stream) {
  static bool attr_set = false;
  return launch_int8<false, true, false>(attr_set, q, k, sk, v, sv, vm, out, nullptr, B, H, Sq,
                                         Skv, QB, scale, stream);
}

extern "C" int flash_s8_s8pv(const void* q, const void* k, const void* sk, const void* v,
                             const void* sv, const void* vm, void* out, int B, int H, int Sq,
                             int Skv, int QB, float scale, void* stream) {
  static bool attr_set = false;
  return launch_int8<true, true, false>(attr_set, q, k, sk, v, sv, vm, out, nullptr, B, H, Sq,
                                        Skv, QB, scale, stream);
}

// K14, int8 modes: as flash_s8 / flash_s8pv / flash_s8_s8pv, plus lse f32
// [B, H, Sq] contiguous (after out in the argument list).
#define FLASH_INT8_LSE(NAME, S8_QK, S8_PV)                                                     \
  extern "C" int NAME(const void* q, const void* k, const void* sk, const void* v,            \
                      const void* sv, const void* vm, void* out, void* lse, int B, int H,     \
                      int Sq, int Skv, int QB, float scale, void* stream) {                   \
    static bool attr_set = false;                                                              \
    return launch_int8<S8_QK, S8_PV, true>(attr_set, q, k, sk, v, sv, vm, out, lse, B, H, Sq, \
                                           Skv, QB, scale, stream);                            \
  }
FLASH_INT8_LSE(flash_s8_lse, true, false)
FLASH_INT8_LSE(flash_s8pv_lse, false, true)
FLASH_INT8_LSE(flash_s8_s8pv_lse, true, true)
#undef FLASH_INT8_LSE
