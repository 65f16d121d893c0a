// 4-bit codebook quantized matmul (nf4/fp4): y[M, N] = x[M, K] @ deq(W)[K, N].
//
// Replaces diffusion_rs_tpu/ops/qmatmul_pallas.py:_qmm_kernel, 4-bit
// codebook branch: _dequant_tile (:57-120) with _codebook_select (:34),
// reached through _qmm_call -> pl.pallas_call (:378).
//
// Math: the packed plane is u8 [K/2, N] in split-block order: inside each
// `split`-row run, packed row r holds k-row r in its low nibble and k-row
// r + split/2 in its high nibble. Each code is looked up in the 16-entry f32
// codebook, multiplied by its per-group f32 scale, rounded to bf16, and the
// product runs bf16 x bf16 with f32 accumulation; one cast to bf16 at the end.
//
// Bound on the H100: at the T5-XXL encode shapes (M = 512, K x N of
// 4096 x 4096 up to 4096 x 10240) the bf16 tensor-core rate bounds it
// (2*M*K*N operations against K*N/2 weight bytes). Design: a stage takes 32
// packed rows, which decode into 64 k-rows (32 low-nibble rows and the 32
// high-nibble rows split/2 further on), together with the matching two
// 32-column slices of x. cp.async double-buffers the packed bytes and the x
// tile; the block decodes the stage into a bf16 shared tile once (one
// codebook lookup and one multiply per weight) and eight warps run
// mma.sync m16n8k16 on it through ldmatrix (.trans for the K-major weight).
// 128x128 output tiles, 64x32 per warp. wgmma/TMA are left for later work.
#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int PK = 32;              // packed rows per stage
constexpr int KS = 2 * PK;          // k values per stage
constexpr int THREADS = 256;
constexpr int A_STRIDE = KS + 8;    // bf16: 144-byte rows, conflict-free ldmatrix
constexpr int W_STRIDE = BN + 8;    // bf16: 272-byte rows, conflict-free ldmatrix
constexpr int A_ELEMS = BM * A_STRIDE;
constexpr int P_BYTES = PK * BN;
constexpr int W_ELEMS = KS * W_STRIDE;
constexpr size_t SMEM_BYTES =
    2 * A_ELEMS * sizeof(__nv_bfloat16) + 2 * P_BYTES + W_ELEMS * sizeof(__nv_bfloat16) +
    16 * sizeof(float);

__global__ void __launch_bounds__(THREADS)
qmm_nf4_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scale, const float* __restrict__ codebook,
               __nv_bfloat16* __restrict__ out, int M, int K, int N, int split,
               int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);            // [2][BM][A_STRIDE]
  uint8_t* Ps = smem + 2 * A_ELEMS * sizeof(__nv_bfloat16);                // [2][PK][BN]
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(Ps + 2 * P_BYTES);  // [KS][W_STRIDE]
  float* cb = reinterpret_cast<float*>(Ws + W_ELEMS);                      // [16]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int half = split / 2;
  const int stages_per_run = half / PK;
  const int nstages = (K / 2) / PK;

  if (tid < 16) cb[tid] = codebook[tid];

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Stage s: packed rows run*half + r0 .. +PK, i.e. k_lo .. k_lo+PK (low
  // nibbles) and k_lo+half .. +PK (high nibbles).
  auto k_lo_of = [&](int s) {
    return (s / stages_per_run) * split + (s % stages_per_run) * PK;
  };
  auto load_stage = [&](int s, int buf) {
    const int k_lo = k_lo_of(s);
    const int prow = (s / stages_per_run) * half + (s % stages_per_run) * PK;
    __nv_bfloat16* a = As + buf * A_ELEMS;
    // x: BM rows x (32 low + 32 high) bf16 = 8 chunks of 16 bytes per row
#pragma unroll
    for (int c = tid; c < BM * 8; c += THREADS) {
      const int r = c >> 3;
      const int ch = c & 7;
      const int kg = (ch < 4) ? k_lo + ch * 8 : k_lo + half + (ch - 4) * 8;
      const int gr = m0 + r;
      cp_async16(a + r * A_STRIDE + ch * 8, x + (size_t)(gr < M ? gr : 0) * K + kg,
                 gr < M ? 16 : 0);
    }
    uint8_t* p = Ps + buf * P_BYTES;
    for (int c = tid; c < PK * BN / 16; c += THREADS) {
      const int r = c >> 3;
      const int ch = c & 7;
      cp_async16(p + r * BN + ch * 16, packed + (size_t)(prow + r) * N + n0 + ch * 16, 16);
    }
    cp_async_commit();
  };

  load_stage(0, 0);
  for (int s = 0; s < nstages; ++s) {
    const int buf = s & 1;
    if (s + 1 < nstages) {
      load_stage(s + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Decode: 32 x 128 packed bytes -> 64 x 128 bf16 (f32 math, then round).
    {
      const int k_lo = k_lo_of(s);
      const float* s_lo = scale + (size_t)(k_lo / group) * N + n0;
      const float* s_hi = scale + (size_t)((k_lo + half) / group) * N + n0;
      const uint8_t* p = Ps + buf * P_BYTES;
#pragma unroll
      for (int q = 0; q < (PK * BN / 4) / THREADS; ++q) {
        const int wi = tid + q * THREADS;
        const int r = wi / (BN / 4);
        const int c4 = (wi % (BN / 4)) * 4;
        const uint32_t word = *reinterpret_cast<const uint32_t*>(p + r * BN + c4);
        const float4 sl = *reinterpret_cast<const float4*>(s_lo + c4);
        const float4 sh = *reinterpret_cast<const float4*>(s_hi + c4);
        const float slv[4] = {sl.x, sl.y, sl.z, sl.w};
        const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
        float lo[4], hi[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (word >> (8 * b)) & 0xFFu;
          lo[b] = __fmul_rn(cb[byte & 0xFu], slv[b]);
          hi[b] = __fmul_rn(cb[byte >> 4], shv[b]);
        }
        *reinterpret_cast<uint2*>(Ws + r * W_STRIDE + c4) =
            make_uint2(pack_bf16x2(lo[0], lo[1]), pack_bf16x2(lo[2], lo[3]));
        *reinterpret_cast<uint2*>(Ws + (PK + r) * W_STRIDE + c4) =
            make_uint2(pack_bf16x2(hi[0], hi[1]), pack_bf16x2(hi[2], hi[3]));
      }
    }
    __syncthreads();

    const __nv_bfloat16* a_s = As + buf * A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(a[i], a_s + (wm * 64 + i * 16 + (lane & 15)) * A_STRIDE + kk + (lane >> 4) * 8);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, Ws + (kk + (lane & 15)) * W_STRIDE + wn * 32 + jj * 16 + (lane >> 4) * 8);
        b[2 * jj][0] = r4[0];
        b[2 * jj][1] = r4[1];
        b[2 * jj + 1][0] = r4[2];
        b[2 * jj + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 64 + i * 16 + g + hr * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            pack_bf16x2(acc[i][j][hr * 2], acc[i][j][hr * 2 + 1]);
      }
    }
  }
}

}  // namespace

// x bf16 [M, K]; packed u8 [K/2, N]; scale f32 [K/group, N]; codebook f32
// [16]; out bf16 [M, N]. Needs split % 64 == 0, K % split == 0,
// group % 32 == 0, N % 128 == 0. Returns cudaGetLastError().
extern "C" int qmm_nf4(const void* x, const void* packed, const void* scale,
                       const void* codebook, void* out, int M, int K, int N,
                       int split, int group, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_nf4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  qmm_nf4_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(codebook),
      static_cast<__nv_bfloat16*>(out), M, K, N, split, group);
  return static_cast<int>(cudaGetLastError());
}
