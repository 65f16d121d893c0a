// 4-bit codebook quantized matmul (nf4/fp4): y[M, N] = x[M, K] @ deq(W)[K, N].
//
// Replaces diffusion_rs_tpu/ops/qmatmul_pallas.py:_qmm_kernel, 4-bit
// codebook branch: _dequant_tile (:57-120) with _codebook_select (:34),
// reached through _qmm_call -> pl.pallas_call (:378).
// K11 qmm_grouped_nf4: replaces the codebook branch of _qmm_grouped_kernel
// (:539-554), reached through _qmm_grouped_call -> pl.pallas_call (:630): up
// to eight products of one [K, N] nf4/fp4 format in one launch. As K8 in
// qmm_s8.cu and qmm_affine.cu, the kernel takes a group table by value {x,
// packed, scale, codebook, out, m, tile0}; the grid runs over the sum of the
// groups' m-tiles, a block finds its group from the tile offsets, and each
// group's m-tiles start at its own row 0, so a group's output is K2's output
// for that group bit for bit. K2 is the table of one group. Nothing is
// stacked or copied per call. No fast16 mode: JAX passes fast16=False to
// every grouped call (:726).
// K12 qmm_nf4_fast16: replaces the same branch with fast16=True, the opt-in
// 16-bit decode of _dequant_tile (:45-54 with val_dtype bf16, :100-120):
// each codebook entry rounded to bf16, times the group scale rounded to
// bf16, the product rounded to bf16. It is K2's kernel with FAST16 = true:
// only the per-stage decode into the bf16 shared tile changes. The codebook
// sits in shared memory as bf16 bits; two weights pair into one
// fma.rn.bf16x2 (a * s + -0: one rounding), half the decode's multiplies
// of K2's f32 path. The decoded weight equals the plain version's
// (ops/qmatmul.dequantize_fast16) bit for bit; only the f32 summation order
// of the product differs. FAST16 = false is K2's code as it was.
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
constexpr int MAX_GROUPS = 8;

// One product of a call: x [m, K], the planes of its [K, N] weight and its
// codebook, output [m, N]; tile0 is where its m-tiles start in the grid.
struct Group {
  const __nv_bfloat16* x;
  const uint8_t* packed;
  const float* scale;
  const float* codebook;
  __nv_bfloat16* out;
  int m, tile0;
};

struct Table {
  Group g[MAX_GROUPS];
  int count;
};

template <bool FAST16>
__global__ void __launch_bounds__(THREADS)
qmm_nf4_kernel(const Table tab, int K, int N, int split, int group) {
  // This block's group: the last one whose m-tiles start at or before it.
  const int tile = blockIdx.y;
  Group G = tab.g[0];
#pragma unroll
  for (int i = 1; i < MAX_GROUPS; ++i)
    if (i < tab.count && tile >= tab.g[i].tile0) G = tab.g[i];
  const __nv_bfloat16* __restrict__ x = G.x;
  const uint8_t* __restrict__ packed = G.packed;
  const float* __restrict__ scale = G.scale;
  const float* __restrict__ codebook = G.codebook;
  __nv_bfloat16* __restrict__ out = G.out;
  const int M = G.m;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);            // [2][BM][A_STRIDE]
  uint8_t* Ps = smem + 2 * A_ELEMS * sizeof(__nv_bfloat16);                // [2][PK][BN]
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(Ps + 2 * P_BYTES);  // [KS][W_STRIDE]
  float* cb = reinterpret_cast<float*>(Ws + W_ELEMS);                      // [16]
  uint16_t* cbh = reinterpret_cast<uint16_t*>(cb);  // FAST16: [16] bf16 bits

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (tile - G.tile0) * BM;
  const int n0 = blockIdx.x * BN;
  const int half = split / 2;
  const int stages_per_run = half / PK;
  const int nstages = (K / 2) / PK;

  if (tid < 16) {
    if constexpr (FAST16) {
      cbh[tid] = bf16_bits(codebook[tid]);
    } else {
      cb[tid] = codebook[tid];
    }
  }

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
        if constexpr (FAST16) {
          // pairs of bf16 entries times pairs of bf16 scales, one rounding
          uint32_t lo[2], hi[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t b0 = (word >> (16 * h)) & 0xFFu;
            const uint32_t b1 = (word >> (16 * h + 8)) & 0xFFu;
            lo[h] = cbh[b0 & 0xFu] | (static_cast<uint32_t>(cbh[b1 & 0xFu]) << 16);
            hi[h] = cbh[b0 >> 4] | (static_cast<uint32_t>(cbh[b1 >> 4]) << 16);
          }
          *reinterpret_cast<uint2*>(Ws + r * W_STRIDE + c4) =
              make_uint2(bf16x2_mul(lo[0], pack_bf16x2(sl.x, sl.y)),
                         bf16x2_mul(lo[1], pack_bf16x2(sl.z, sl.w)));
          *reinterpret_cast<uint2*>(Ws + (PK + r) * W_STRIDE + c4) =
              make_uint2(bf16x2_mul(hi[0], pack_bf16x2(sh.x, sh.y)),
                         bf16x2_mul(hi[1], pack_bf16x2(sh.z, sh.w)));
          continue;
        }
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

// Fills the tile offsets and launches the kernel for the table.
template <bool FAST16>
int run(Table& tab, int K, int N, int split, int group, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_nf4_kernel<FAST16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  int tiles = 0;
  for (int i = 0; i < tab.count; ++i) {
    tab.g[i].tile0 = tiles;
    tiles += (tab.g[i].m + BM - 1) / BM;
  }
  if (tiles == 0) return 0;
  dim3 grid(N / BN, tiles);
  qmm_nf4_kernel<FAST16><<<grid, THREADS, SMEM_BYTES, stream>>>(tab, K, N, split, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. x bf16 [M, K]; packed u8 [K/2, N]; scale f32 [K/group, N]; codebook f32
// [16]; out bf16 [M, N]. Needs split % 64 == 0, K % split == 0,
// group % 32 == 0, N % 128 == 0. Returns cudaGetLastError().
extern "C" int qmm_nf4(const void* x, const void* packed, const void* scale,
                       const void* codebook, void* out, int M, int K, int N,
                       int split, int group, void* stream) {
  Table tab{};
  tab.count = 1;
  tab.g[0] = {static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
              static_cast<const float*>(scale), static_cast<const float*>(codebook),
              static_cast<__nv_bfloat16*>(out), M, 0};
  return run<false>(tab, K, N, split, group, static_cast<cudaStream_t>(stream));
}

// K12: K2 with the fast16 decode; the same arguments.
extern "C" int qmm_nf4_fast16(const void* x, const void* packed, const void* scale,
                              const void* codebook, void* out, int M, int K, int N,
                              int split, int group, void* stream) {
  Table tab{};
  tab.count = 1;
  tab.g[0] = {static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
              static_cast<const float*>(scale), static_cast<const float*>(codebook),
              static_cast<__nv_bfloat16*>(out), M, 0};
  return run<true>(tab, K, N, split, group, static_cast<cudaStream_t>(stream));
}

// K11. table: G rows of 6 int64 {x, packed, scale, codebook, out, m}, each
// group as K2's arguments, all of one K, N, split and group. 1 <= G <= 8.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad G.
extern "C" int qmm_grouped_nf4(const long long* table, int G, int K, int N, int split,
                               int group, void* stream) {
  if (G < 1 || G > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  tab.count = G;
  for (int i = 0; i < G; ++i) {
    const long long* r = table + 6 * i;
    tab.g[i] = {reinterpret_cast<const __nv_bfloat16*>(r[0]),
                reinterpret_cast<const uint8_t*>(r[1]), reinterpret_cast<const float*>(r[2]),
                reinterpret_cast<const float*>(r[3]), reinterpret_cast<__nv_bfloat16*>(r[4]),
                static_cast<int>(r[5]), 0};
  }
  return run<false>(tab, K, N, split, group, static_cast<cudaStream_t>(stream));
}
