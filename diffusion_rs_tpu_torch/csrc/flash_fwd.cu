// Flash attention forward, bf16, head_dim 128, output head-merged.
//
// Replaces diffusion_rs_tpu/ops/flash_pallas.py:_flash_kernel in bf16 mode
// with seq_out=True and no lse (:50-216), reached through _flash_call ->
// pl.pallas_call (:396) from flash_attention(out_seqmajor=True).
//
// Math (the Pallas kernel's): s = (q . k^T) * scale in f32; kv columns past
// kv_len masked to -1e30; running max m (starts at -1e30) and sum l in f32;
// p = exp(s - m_new); l = l * alpha + rowsum(p) over the f32 p, while P.V
// uses p rounded to bf16; acc = acc * alpha + P.V; o = acc * (1 / l) with
// l == 0 -> 1; each head's rows are written to its column slice of
// out[B, Sq, H * 128].
//
// Bound on the H100: at FLUX joint attention (B1 H24 S4608 D128) the bf16
// tensor-core rate bounds it (4*S*S*D operations per head against S*D*8
// bytes). Design, FlashAttention-2 style: a block owns 64 query rows of one
// (batch, head), four warps own 16 rows each and keep their Q fragments,
// the f32 output accumulator and the softmax state in registers; K and V
// tiles of 64 rows stream through a two-stage cp.async ring in shared
// memory. QK^T and P.V run on mma.sync m16n8k16; the S accumulator is
// re-packed in registers as the A operand of P.V (no shared-memory trip),
// and V reaches the MMA through ldmatrix.trans. Ragged q rows are
// zero-filled and not written; ragged kv rows are zero-filled and masked.
// wgmma/TMA and warp specialization are left for later work.
#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;        // 4 warps x 16 query rows
constexpr int STRIDE = D + 8;       // bf16: 272-byte rows, conflict-free ldmatrix
constexpr int TILE = BKV * STRIDE;  // elements per K or V tile
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_BYTES = (size_t)(BQ * STRIDE + 4 * TILE) * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int H, int Sq, int Skv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][STRIDE]
  __nv_bfloat16* Ks = Qs + BQ * STRIDE;                        // [2][BKV][STRIDE]
  __nv_bfloat16* Vs = Ks + 2 * TILE;                           // [2][BKV][STRIDE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Skv * D;
  const int nkv = (Skv + BKV - 1) / BKV;

  // Q tile: 64 rows x 16 chunks of 16 bytes.
  for (int c = tid; c < BQ * (D / 8); c += THREADS) {
    const int r = c >> 4;
    const int ch = c & 15;
    const int gr = q0 + r;
    cp_async16(Qs + r * STRIDE + ch * 8, qb + (size_t)(gr < Sq ? gr : 0) * D + ch * 8,
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
      const size_t off = (size_t)(gr < Skv ? gr : 0) * D + ch * 8;
      const int bytes = gr < Skv ? 16 : 0;
      cp_async16(kd + r * STRIDE + ch * 8, kb + off, bytes);
      cp_async16(vd + r * STRIDE + ch * 8, vb + off, bytes);
    }
    cp_async_commit();
  };

  load_kv(0, 0);
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * STRIDE + kk * 16 + (lane >> 4) * 8);
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
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, vs + (kc * 16 + (lane & 15)) * STRIDE + dn * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r4[0], r4[1]};
        const uint32_t b1[2] = {r4[2], r4[3]};
        mma_bf16_16816(o[2 * dn], a, b0);
        mma_bf16_16816(o[2 * dn + 1], a, b1);
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

}  // namespace

// q, k, v bf16 [B, H, S, 128] contiguous; out bf16 [B, Sq, H * 128].
// Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, int B,
                         int H, int Sq, int Skv, float scale, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Sq, Skv,
      scale);
  return static_cast<int>(cudaGetLastError());
}
