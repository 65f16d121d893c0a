// Flash attention forward, bf16, head_dim 128, output head-merged
// [B, Sq, H * 128]. One kernel body, three entry points:
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
//   _flash_rope_call -> pl.pallas_call (:523). K6 plus the half-split RoPE
//   of q and k inside the kernel.
//
// Math (the Pallas kernels'): s = (q . k^T) * scale in f32; kv columns past
// kv_len masked to -1e30; running max m (starts at -1e30) and sum l in f32;
// p = exp(s - m_new); l = l * alpha + rowsum(p) over the f32 p, while P.V
// uses p rounded to bf16; acc = acc * alpha + P.V; o = acc * (1 / l) with
// l == 0 -> 1; each head's rows are written to its column slice of
// out[B, Sq, H * 128]. The three entry points differ only in where a head's
// rows are read from (element strides between batches, heads and rows).
//
// RoPE (K7): rot(x)_j = ce_j x_j + se_j x_{(j+64) mod 128} with the expanded
// tables ce = [cos | cos], se = [-sin | sin] (ops/rope.py
// expand_rope_tables), so the kernel reads cos from ce[0:64] and sin from
// se[64:128]: lo_j = cos_j x_j - sin_j x_{j+64} and hi_j = cos_j x_{j+64} +
// sin_j x_j in f32, each product and the sum rounded on its own
// (__fmul_rn / __fsub_rn / __fadd_rn, no FMA contraction), then rounded to
// bf16. The rotated tile is apply_rope_halfsplit's output bit for bit, so K7
// equals K6 run on plain-rotated q/k bit for bit. The q tile is rotated once
// in shared memory when the block starts (the Pallas kernel's qrot_scratch);
// each k tile is rotated in place after it lands, from cos/sin rows that a
// cp.async prefetch brought into shared memory during the previous tile.
//
// Bound on the H100: at FLUX joint attention (B1 H24 S4608 D128) the bf16
// tensor-core rate bounds all three (4*S*S*D operations per head against
// S*D*8 bytes). K7 also reads table rows: every block re-reads the cos/sin
// halves of the whole kv sequence (512 bytes per kv row, 32 KB per k tile),
// which the 50 MB L2 serves after the first block of a batch (the tables of
// S = 4608 are 2.4 MB each); the prefetch overlaps those reads with the
// previous tile's MMAs, and the rotation adds one barrier per k tile.
// Design, FlashAttention-2 style: a block owns 64 query rows of one
// (batch, head), four warps own 16 rows each and keep their Q
// fragments, the f32 output accumulator and the softmax state in
// registers; K and V tiles of 64 rows stream through a two-stage cp.async
// ring in shared memory. QK^T and P.V run on mma.sync m16n8k16; the S
// accumulator is re-packed in registers as the A operand of P.V (no
// shared-memory trip), and V reaches the MMA through ldmatrix.trans. Ragged
// q rows are zero-filled and not written; ragged kv rows are zero-filled
// and masked (and not rotated). wgmma/TMA and warp specialization are left
// for later work.
#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int HALF = D / 2;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;        // 4 warps x 16 query rows
constexpr int STRIDE = D + 8;       // bf16: 272-byte rows, conflict-free ldmatrix
constexpr int TILE = BKV * STRIDE;  // elements per K or V tile
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_BYTES = (size_t)(BQ * STRIDE + 4 * TILE) * sizeof(__nv_bfloat16);
// K7 prefetches the next k tile's cos and sin rows ([64][64] f32 each): the
// cos half reuses the q tile's buffer (dead once the q fragments are in
// registers), the sin half follows the V ring. Two blocks still fit an SM.
constexpr int TABLE = BKV * HALF;  // floats per cos or sin tile
constexpr size_t SMEM_ROPE_BYTES = SMEM_BYTES + TABLE * sizeof(float);
static_assert(TABLE * sizeof(float) <= BQ * STRIDE * sizeof(__nv_bfloat16),
              "the cos tile fits the q tile's buffer");
static_assert(BQ == BKV, "rope_tile rotates q and k tiles alike");


// Half-split RoPE of pairs (j..j+3, j+64..j+67) of one row at x in shared
// memory, in place, with cos_j.. in c and sin_j.. in sn.
__device__ __forceinline__ void rope4(__nv_bfloat16* x, const float4 c, const float4 sn) {
  const uint2 lo_raw = *reinterpret_cast<const uint2*>(x);
  const uint2 hi_raw = *reinterpret_cast<const uint2*>(x + HALF);
  const __nv_bfloat162* lo2 = reinterpret_cast<const __nv_bfloat162*>(&lo_raw);
  const __nv_bfloat162* hi2 = reinterpret_cast<const __nv_bfloat162*>(&hi_raw);
  const float cv[4] = {c.x, c.y, c.z, c.w};
  const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
  uint32_t lo_out[2], hi_out[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float2 xl = __bfloat1622float2(lo2[e]);
    const float2 xh = __bfloat1622float2(hi2[e]);
    const float ca = cv[2 * e], cb = cv[2 * e + 1];
    const float sa = sv[2 * e], sb = sv[2 * e + 1];
    lo_out[e] = pack_bf16x2(__fsub_rn(__fmul_rn(ca, xl.x), __fmul_rn(sa, xh.x)),
                            __fsub_rn(__fmul_rn(cb, xl.y), __fmul_rn(sb, xh.y)));
    hi_out[e] = pack_bf16x2(__fadd_rn(__fmul_rn(ca, xh.x), __fmul_rn(sa, xl.x)),
                            __fadd_rn(__fmul_rn(cb, xh.y), __fmul_rn(sb, xl.y)));
  }
  *reinterpret_cast<uint2*>(x) = make_uint2(lo_out[0], lo_out[1]);
  *reinterpret_cast<uint2*>(x + HALF) = make_uint2(hi_out[0], hi_out[1]);
}

// Half-split RoPE of a [64][STRIDE] tile in shared memory, in place. Row r
// holds sequence position s0 + r; rows at or past S are padding and stay as
// they are. cos(r) and sin(r) point at the row's 64 cosines and sines
// (global or shared memory). Sixteen threads per row, four pairs each.
template <class CosRow, class SinRow>
__device__ __forceinline__ void rope_tile(__nv_bfloat16* tile, int s0, int S, CosRow cos_row,
                                          SinRow sin_row) {
  const int j = (threadIdx.x & 15) * 4;
#pragma unroll
  for (int pass = 0; pass < BQ / (THREADS / 16); ++pass) {
    const int r = pass * (THREADS / 16) + (threadIdx.x >> 4);
    if (s0 + r < S) {
      rope4(tile + r * STRIDE + j, *reinterpret_cast<const float4*>(cos_row(r) + j),
            *reinterpret_cast<const float4*>(sin_row(r) + j));
    }
  }
}

// Seq-major operands (K6, K7): a head's rows start at p + b * sb + h * D
// and lie sr elements apart (row offsets fit in 32 bits: the wrappers check
// it).
struct Rows {
  const __nv_bfloat16* p;
  long long sb, sr;
};

// The kernel body. DENSE (K3): q/k/v [B, H, S, 128] contiguous, row stride a
// compile-time D; q/k/v point at the tensors. Otherwise (K6, K7) the rows
// are described by qs/ks/vs. ce/se (K7 only): the expanded tables
// [B, Sq, 128] for q and [B, Skv, 128] for k.
template <bool ROPE, bool DENSE>
__device__ __forceinline__ void flash_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Rows qs, const Rows ks, const Rows vs,
    __nv_bfloat16* __restrict__ out, const float* __restrict__ ce_q,
    const float* __restrict__ se_q, const float* __restrict__ ce_k,
    const float* __restrict__ se_k, int H, int Sq, int Skv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][STRIDE]
  __nv_bfloat16* Ks = Qs + BQ * STRIDE;                        // [2][BKV][STRIDE]
  __nv_bfloat16* Vs = Ks + 2 * TILE;                           // [2][BKV][STRIDE]
  float* Tc = reinterpret_cast<float*>(smem);                  // K7: [BKV][HALF] cos
  float* Ts = reinterpret_cast<float*>(Vs + 2 * TILE);         // K7: [BKV][HALF] sin

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = DENSE ? q + (size_t)bh * Sq * D : qs.p + b * qs.sb + h * D;
  const __nv_bfloat16* kb = DENSE ? k + (size_t)bh * Skv * D : ks.p + b * ks.sb + h * D;
  const __nv_bfloat16* vb = DENSE ? v + (size_t)bh * Skv * D : vs.p + b * vs.sb + h * D;
  const int q_sr = DENSE ? D : static_cast<int>(qs.sr);
  const int k_sr = DENSE ? D : static_cast<int>(ks.sr);
  const int v_sr = DENSE ? D : static_cast<int>(vs.sr);
  const int nkv = (Skv + BKV - 1) / BKV;

  // Q tile: 64 rows x 16 chunks of 16 bytes.
  for (int c = tid; c < BQ * (D / 8); c += THREADS) {
    const int r = c >> 4;
    const int ch = c & 15;
    const int gr = q0 + r;
    cp_async16(Qs + r * STRIDE + ch * 8, qb + (size_t)(gr < Sq ? gr : 0) * q_sr + ch * 8,
               gr < Sq ? 16 : 0);
  }
  cp_async_commit();

  auto load_kv = [&](int j, int buf) {
    __nv_bfloat16* kd = Ks + buf * TILE;
    __nv_bfloat16* vd = Vs + buf * TILE;
    for (int c = tid; c < BKV * (D / 8); c += THREADS) {
      const int r = c >> 4;
      const int ch = c & 15;
      const int gr = j * BKV + r;
      const size_t row = gr < Skv ? gr : 0;
      const int bytes = gr < Skv ? 16 : 0;
      cp_async16(kd + r * STRIDE + ch * 8, kb + row * k_sr + ch * 8, bytes);
      cp_async16(vd + r * STRIDE + ch * 8, vb + row * v_sr + ch * 8, bytes);
    }
    cp_async_commit();
  };

  // K7: the cos and sin rows of k tile j into Tc / Ts.
  auto load_tables = [&](int j) {
    for (int c = tid; c < BKV * 2 * (HALF / 4); c += THREADS) {
      const int r = c >> 5;
      const int sin_half = (c >> 4) & 1;
      const int ch = c & 15;
      const int gr = j * BKV + r;
      const size_t row = ((size_t)b * Skv + (gr < Skv ? gr : 0)) * D;
      cp_async16((sin_half ? Ts : Tc) + r * HALF + ch * 4,
                 sin_half ? se_k + row + HALF + ch * 4 : ce_k + row + ch * 4,
                 gr < Skv ? 16 : 0);
    }
    cp_async_commit();
  };

  load_kv(0, 0);
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  if (ROPE) {
    const size_t row0 = (size_t)b * Sq + q0;
    rope_tile(
        Qs, q0, Sq, [&](int r) { return ce_q + (row0 + r) * D; },
        [&](int r) { return se_q + (row0 + r) * D + HALF; });
    __syncthreads();
  }

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * STRIDE + kk * 16 + (lane >> 4) * 8);
  }
  if (ROPE) {
    __syncthreads();  // every warp has its q fragments: Qs becomes Tc
    load_tables(0);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < nkv; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkv) {
      load_kv(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ROPE) {
      rope_tile(
          Ks + buf * TILE, j * BKV, Skv, [&](int r) { return Tc + r * HALF; },
          [&](int r) { return Ts + r * HALF; });
      __syncthreads();
      if (j + 1 < nkv) load_tables(j + 1);  // lands while this tile's MMAs run
    }
    const __nv_bfloat16* ks = Ks + buf * TILE;
    const __nv_bfloat16* vs = Vs + buf * TILE;

    // S = Q K^T for this warp's 16 rows x 64 kv columns.
    float s[BKV / 8][4];
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

    // Scale, mask the ragged kv tail, online softmax over rows g and g + 8.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BKV + i * 8 + 2 * t + (e & 1);
        const float val = col < Skv ? __fmul_rn(s[i][e], scale) : NEG_INF;
        s[i][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
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
      l_run[r] = l_run[r] * alpha[r] + ls[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];

    // O += P V, with P re-packed from the S accumulator as bf16 A fragments.
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
      *reinterpret_cast<uint32_t*>(orow + i * 8 + 2 * t) =
          pack_bf16x2(__fmul_rn(o[i][2 * r], inv), __fmul_rn(o[i][2 * r + 1], inv));
    }
  }
}

// K3: q/k/v [B, H, S, 128] contiguous.
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int H, int Sq, int Skv, float scale) {
  const Rows none{};
  flash_body<false, true>(q, k, v, none, none, none, out, nullptr, nullptr, nullptr, nullptr,
                          H, Sq, Skv, scale);
}

// K6: seq-major q/k/v.
__global__ void __launch_bounds__(THREADS)
flash_sm_kernel(const Rows q, const Rows k, const Rows v, __nv_bfloat16* __restrict__ out,
                int H, int Sq, int Skv, float scale) {
  flash_body<false, false>(nullptr, nullptr, nullptr, q, k, v, out, nullptr, nullptr, nullptr,
                           nullptr, H, Sq, Skv, scale);
}

// K7: seq-major q/k/v and the expanded tables.
__global__ void __launch_bounds__(THREADS)
flash_rope_kernel(const Rows q, const Rows k, const Rows v, __nv_bfloat16* __restrict__ out,
                  const float* __restrict__ ce_q, const float* __restrict__ se_q,
                  const float* __restrict__ ce_k, const float* __restrict__ se_k, int H,
                  int Sq, int Skv, float scale) {
  flash_body<true, false>(nullptr, nullptr, nullptr, q, k, v, out, ce_q, se_q, ce_k, se_k, H,
                          Sq, Skv, scale);
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

Rows rows(const void* p, long long sb, long long sr) {
  return {static_cast<const __nv_bfloat16*>(p), sb, sr};
}

}  // namespace

// K3. q, k, v bf16 [B, H, S, 128] contiguous; out bf16 [B, Sq, H * 128].
// Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, int B,
                         int H, int Sq, int Skv, float scale, void* stream) {
  static bool attr_set = false;
  using bf16 = __nv_bfloat16;
  return launch(flash_fwd_kernel, SMEM_BYTES, attr_set, B, H, Sq, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(out), H, Sq, Skv, scale);
}

// K6. q bf16 [B, Sq, H * 128], k and v bf16 [B, Skv, H * 128], each with
// unit column stride and the given batch and row strides (elements, each a
// multiple of 8; 16-byte aligned base; (S - 1) * row stride + H * 128 below
// 2^31); out bf16 [B, Sq, H * 128] contiguous. Returns cudaGetLastError().
extern "C" int flash_sm(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int Sq, int Skv, long long q_sb, long long q_sr, long long k_sb,
                        long long k_sr, long long v_sb, long long v_sr, float scale,
                        void* stream) {
  static bool attr_set = false;
  return launch(flash_sm_kernel, SMEM_BYTES, attr_set, B, H, Sq, stream,
                rows(q, q_sb, q_sr), rows(k, k_sb, k_sr), rows(v, v_sb, v_sr),
                static_cast<__nv_bfloat16*>(out), H, Sq, Skv, scale);
}

// K7. As flash_sm, plus the expanded RoPE tables ce/se f32 [B, Sq, 128] for
// q and [B, Skv, 128] for k, contiguous. Returns cudaGetLastError().
extern "C" int flash_rope(const void* q, const void* k, const void* v, const void* ce_q,
                          const void* se_q, const void* ce_k, const void* se_k, void* out,
                          int B, int H, int Sq, int Skv, long long q_sb, long long q_sr,
                          long long k_sb, long long k_sr, long long v_sb, long long v_sr,
                          float scale, void* stream) {
  static bool attr_set = false;
  return launch(flash_rope_kernel, SMEM_ROPE_BYTES, attr_set, B, H, Sq, stream,
                rows(q, q_sb, q_sr), rows(k, k_sb, k_sr), rows(v, v_sb, v_sr),
                static_cast<__nv_bfloat16*>(out),
                static_cast<const float*>(ce_q), static_cast<const float*>(se_q),
                static_cast<const float*>(ce_k), static_cast<const float*>(se_k), H, Sq, Skv,
                scale);
}
