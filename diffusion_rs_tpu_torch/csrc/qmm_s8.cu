// q8t quantized matmul: y[M, N] = x[M, K] @ deq(W)[K, N], bf16 in and out.
//
// K1 qmm_s8: replaces diffusion_rs_tpu/ops/qmatmul_pallas.py:_qmm_kernel,
// s8 branch (:134-151), reached through _qmm_call -> pl.pallas_call (:378).
// K8 qmm_grouped_s8: replaces the s8 branch of _qmm_grouped_kernel (:515),
// reached through _qmm_grouped_call -> pl.pallas_call (:630): up to eight
// products of one [K, N] q8t format (each group its own x, weight planes
// and output) in one launch of each pass. Both passes take a group table by
// value; a block (or a quantize warp) finds its group from the table's
// prefix sums of rows and m-tiles, and each group's m-tiles start at its own
// row 0, so a group's output is K1's output for that group bit for bit. K1
// is the table of one group. Nothing is stacked or copied per call (the
// Pallas call's jnp.stack of the weights and concatenation of padded
// activations are TPU artefacts).
//
// Math (the Pallas kernel's, bit for bit): per row and per K-tile of
// bk = min(256, K) columns, sx = max|x| / 127 (1 where the row is all zero),
// xq = round_half_even(x / sx) as int8, an s8 x s8 -> s32 dot with the int8
// weight plane, then acc += float(i32) * (sx * scale[kt, n]) in f32, K-tiles
// summed in order, and one cast to bf16 at the end. The division and the
// rounding are IEEE (no fast math); the epilogue uses __fmul_rn/__fadd_rn so
// the compiler cannot contract it into an FMA.
//
// Bound on the H100: at the FLUX image/joint shapes (M = 4096/4608, K and N
// in the thousands) the int8 tensor-core rate bounds it (2*M*K*N operations
// vs ~1 byte of weight per M operations); at M = 1 (the modulation linears)
// reading the weight plane bounds it. Design: pass 1 quantizes x once into
// an int8 copy plus per-(row, K-tile) scales, so the product kernel never
// redoes that work per N-tile. Pass 2 is a 128x128x64 tile GEMM on
// mma.sync m16n8k32 (int8 tensor cores) with a two-stage cp.async ring; the
// int32 partial of each K-tile is folded into the f32 accumulator in
// registers. The weight plane is N-contiguous ([K, N]) while the MMA wants
// K-contiguous B fragments, so each thread reads 4x4 byte blocks and
// transposes them in registers with __byte_perm: the warp's four n8 tiles
// are interleaved column by column, and the epilogue undoes that mapping
// (each thread then owns 8 consecutive output columns per row, one 16-byte
// store). wgmma/TMA and a split-K path for M = 1 are left for later work.
#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;               // int8 elements (bytes) per stage
constexpr int THREADS = 256;         // 8 warps: 2 (M) x 4 (N), 64x32 each
constexpr int A_STRIDE = BK + 16;    // 80-byte rows: conflict-free ldmatrix
constexpr int B_STRIDE = BN + 16;    // 144-byte rows, 16-byte aligned

constexpr int MAX_GROUPS = 8;

// One product of a call: activations x [m, K], their int8 copy xq and
// scales sx (scratch), weight planes w [K, N] and scale [K/bk, N], output
// [m, N]; row0 and tile0 are where its rows and m-tiles start in the call.
struct Group {
  const __nv_bfloat16* x;
  int8_t* xq;
  float* sx;
  const int8_t* w;
  const float* scale;
  __nv_bfloat16* out;
  int m, row0, tile0;
};

struct Table {
  Group g[MAX_GROUPS];
  int count;
};

// One warp per (row, K-tile) over all groups' rows: sx and the int8 row
// segment.
__global__ void quantize_rows_kernel(const Table tab, int rows, int K, int bk) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int kts = K / bk;
  if (warp >= rows * kts) return;
  const int grow = warp / kts;
  Group G = tab.g[0];
#pragma unroll
  for (int i = 1; i < MAX_GROUPS; ++i)
    if (i < tab.count && grow >= tab.g[i].row0) G = tab.g[i];
  const int row = grow - G.row0;
  const int kt = warp % kts;
  const size_t off = (size_t)row * K + (size_t)kt * bk;
  const __nv_bfloat16* xr = G.x + off;
  int8_t* xq = G.xq;
  float* sx = G.sx;
  float ax = 0.f;
  for (int i = lane; i < bk; i += 32) ax = fmaxf(ax, fabsf(__bfloat162float(xr[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ax = fmaxf(ax, __shfl_xor_sync(0xffffffffu, ax, o));
  const float s = (ax == 0.f) ? 1.f : ax / 127.f;
  int8_t* qr = xq + off;
  for (int i = lane; i < bk; i += 32) {
    qr[i] = static_cast<int8_t>(__float2int_rn(__bfloat162float(xr[i]) / s));
  }
  if (lane == 0) sx[(size_t)row * kts + kt] = s;
}

// 4x4 byte transpose: out[j] = {w0.byte j, w1.byte j, w2.byte j, w3.byte j}.
__device__ __forceinline__ void transpose4x4(const uint32_t* w, uint32_t* out) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__global__ void __launch_bounds__(THREADS)
qmm_s8_kernel(const Table tab, int K, int N, int bk) {
  __shared__ __align__(16) int8_t As[2][BM * A_STRIDE];
  __shared__ __align__(16) int8_t Bs[2][BK * B_STRIDE];

  // This block's group: the last one whose m-tiles start at or before it.
  const int tile = blockIdx.y;
  Group G = tab.g[0];
#pragma unroll
  for (int i = 1; i < MAX_GROUPS; ++i)
    if (i < tab.count && tile >= tab.g[i].tile0) G = tab.g[i];
  const int8_t* __restrict__ xq = G.xq;
  const float* __restrict__ sx = G.sx;
  const int8_t* __restrict__ w = G.w;
  const float* __restrict__ scale = G.scale;
  __nv_bfloat16* __restrict__ out = G.out;
  const int M = G.m;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 64-row slab
  const int wn = warp & 3;   // 32-column slab
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (tile - G.tile0) * BM;
  const int n0 = blockIdx.x * BN;
  const int kts = K / bk;
  const int stages_per_tile = bk / BK;
  const int nstages = K / BK;

  float accf[4][4][4];
  int32_t acci[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accf[i][j][e] = 0.f;
        acci[i][j][e] = 0;
      }

  auto load_stage = [&](int s, int buf) {
    const int k0 = s * BK;
#pragma unroll
    for (int c = tid; c < BM * BK / 16; c += THREADS) {
      const int r = c >> 2;
      const int cc = (c & 3) * 16;
      const int gr = m0 + r;
      const int8_t* src = xq + (size_t)(gr < M ? gr : 0) * K + k0 + cc;
      cp_async16(&As[buf][r * A_STRIDE + cc], src, gr < M ? 16 : 0);
    }
#pragma unroll
    for (int c = tid; c < BK * BN / 16; c += THREADS) {
      const int r = c >> 3;
      const int cc = (c & 7) * 16;
      cp_async16(&Bs[buf][r * B_STRIDE + cc], w + (size_t)(k0 + r) * N + n0 + cc, 16);
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

    const int8_t* as = As[buf];
    const int8_t* bs = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(a[i], as + (wm * 64 + i * 16 + (lane & 15)) * A_STRIDE + kk + (lane >> 4) * 16);
      }
      // b[j][h]: n8 tile j holds physical columns wn*32 + 4*col + j.
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w4[4], bt[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          w4[r] = *reinterpret_cast<const uint32_t*>(
              bs + (kk + h * 16 + t * 4 + r) * B_STRIDE + wn * 32 + g * 4);
        }
        transpose4x4(w4, bt);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j][h] = bt[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acci[i][j], a[i], b[j]);
    }

    if ((s + 1) % stages_per_tile == 0) {
      // K-tile epilogue: acc += float(i32) * (sx * scale), in the Pallas order.
      const int kt = s / stages_per_tile;
      const float* sc_row = scale + (size_t)kt * N + n0 + wn * 32 + 8 * t;
      float sc[8];
      const float4 s_lo = *reinterpret_cast<const float4*>(sc_row);
      const float4 s_hi = *reinterpret_cast<const float4*>(sc_row + 4);
      sc[0] = s_lo.x; sc[1] = s_lo.y; sc[2] = s_lo.z; sc[3] = s_lo.w;
      sc[4] = s_hi.x; sc[5] = s_hi.y; sc[6] = s_hi.z; sc[7] = s_hi.w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r0 = m0 + wm * 64 + i * 16 + g;
        const float sx0 = r0 < M ? sx[(size_t)r0 * kts + kt] : 0.f;
        const float sx1 = r0 + 8 < M ? sx[(size_t)(r0 + 8) * kts + kt] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // c-fragment column 2t + (e & 1) of tile j -> physical 8t + 4(e&1) + j
            const float f = __fmul_rn(e < 2 ? sx0 : sx1, sc[4 * (e & 1) + j]);
            accf[i][j][e] = __fadd_rn(accf[i][j][e],
                                      __fmul_rn(static_cast<float>(acci[i][j][e]), f));
            acci[i][j][e] = 0;
          }
      }
    }
    __syncthreads();
  }

  // Each thread owns columns n0 + wn*32 + 8t .. +7 of rows r0 and r0 + 8.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 64 + i * 16 + g + hr * 8;
      if (row >= M) continue;
      uint32_t pk[4];
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        // column offset c -> (e & 1) = c >> 2, j = c & 3
        const float lo = accf[i][c & 3][hr * 2 + (c >> 2)];
        const float hi = accf[i][(c + 1) & 3][hr * 2 + ((c + 1) >> 2)];
        pk[c >> 1] = pack_bf16x2(lo, hi);
      }
      *reinterpret_cast<uint4*>(out + (size_t)row * N + n0 + wn * 32 + 8 * t) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
  }
}

// Both passes over a table whose row0/tile0 are filled in.
int run(Table& tab, int K, int N, int bk, cudaStream_t st) {
  int rows = 0, tiles = 0;
  for (int i = 0; i < tab.count; ++i) {
    tab.g[i].row0 = rows;
    tab.g[i].tile0 = tiles;
    rows += tab.g[i].m;
    tiles += (tab.g[i].m + BM - 1) / BM;
  }
  if (rows == 0) return 0;
  const int warps = rows * (K / bk);
  quantize_rows_kernel<<<(warps + 7) / 8, 256, 0, st>>>(tab, rows, K, bk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / BN, tiles);
  qmm_s8_kernel<<<grid, THREADS, 0, st>>>(tab, K, N, bk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. x bf16 [M, K]; xq int8 [M, K] and sx f32 [M, K/bk] are scratch; w
// int8 [K, N]; scale f32 [K/bk, N]; out bf16 [M, N]. Needs K, bk % 64 == 0,
// K % bk == 0, N % 128 == 0. Returns cudaGetLastError().
extern "C" int qmm_s8(const void* x, void* xq, void* sx, const void* w,
                      const void* scale, void* out, int M, int K, int N, int bk,
                      void* stream) {
  Table tab{};
  tab.count = 1;
  tab.g[0] = {static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
              static_cast<float*>(sx), static_cast<const int8_t*>(w),
              static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, 0, 0};
  return run(tab, K, N, bk, static_cast<cudaStream_t>(stream));
}

// K8, s8 branch. table: G rows of 7 int64 {x, xq, sx, w, scale, out, m},
// each group as K1's arguments, all of one K, N and bk. 1 <= G <= 8.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad G.
extern "C" int qmm_grouped_s8(const long long* table, int G, int K, int N, int bk,
                              void* stream) {
  if (G < 1 || G > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  tab.count = G;
  for (int i = 0; i < G; ++i) {
    const long long* r = table + 7 * i;
    tab.g[i] = {reinterpret_cast<const __nv_bfloat16*>(r[0]), reinterpret_cast<int8_t*>(r[1]),
                reinterpret_cast<float*>(r[2]), reinterpret_cast<const int8_t*>(r[3]),
                reinterpret_cast<const float*>(r[4]), reinterpret_cast<__nv_bfloat16*>(r[5]),
                static_cast<int>(r[6]), 0, 0};
  }
  return run(tab, K, N, bk, static_cast<cudaStream_t>(stream));
}
