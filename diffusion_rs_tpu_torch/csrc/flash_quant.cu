// The int8 attention modes' quantize prepass: k for s8 (K9), v for s8_pv
// (K10), in one launch for both.
//
// flash_quant: replaces the XLA prepasses _quantize_k / _quantize_v of
// diffusion_rs_tpu/ops/flash_pallas.py (:223-265), whose outputs the int8
// modes of _flash_kernel read through _flash_call -> pl.pallas_call (:396);
// the port's plain versions are ops/flash.py quantize_k / quantize_v and
// v_kernel_layout. Per (batch, head) of x bf16 [B, H, Skv, 128]:
// * mean m f32 [128]: the column sums over the Skv real rows, divided by
//   Skv (IEEE quotient); the sums run in f64 in a fixed order (see below),
//   so they are the same on every run, not the plain version's f32 order;
// * per quantization block of QB rows (QB a multiple of 128; Skv_p = Skv
//   rounded up to QB, zero rows): a = max |x - m| over the block, scale =
//   a / 127 (IEEE quotient; 1 where a = 0), codes round-half-even((x - m) /
//   scale), each step rounded as the plain version does;
// * k's codes [B, H, Skv_p, 128]; v's transposed to [B, H, 128, Skv_p] with
//   the rows of each 32-row chunk permuted as v_kernel_layout permutes them
//   (position 16a + 4t + 2j + e holds row 8(2a + j) + 2t + e).
// The block max needs no pass over x - m: x - m rounded is monotone in x,
// so max |x - m| over a column of the block is max(fl(colmax - m), fl(m -
// colmin)), bit for bit; the first read keeps the column minima and maxima
// of each quantization block.
//
// Bound on the H100: bytes (x read, codes written: ~42 MB per tensor at B1
// H24 S4608). Design: a cluster of 8 blocks per (batch, head, tensor);
// block r owns the 128-row chunks r, r + 8, ..., and keeps the next chunk's
// loads in flight while it works on one. Read 1: column sums (f64, per
// thread over its rows, then over the 16 row lanes, then over the 8 blocks
// in rank order through distributed shared memory) and, per quantization
// block, the column min and max over its own chunks. After a cluster barrier
// every block combines its peers' sums into the mean and their minima and
// maxima into every block's scale. Read 2 (mostly from L2) quantizes the
// owned chunks; v's codes go through shared memory to leave as rows of v^T.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;
constexpr int CLUSTER = 8;
constexpr int THREADS = 256;
constexpr int CHUNK = 128;               // rows per chunk; QB is a multiple
constexpr int LANES = THREADS / 16;      // row lanes: 16 threads of 8 columns cover a row
constexpr int RPL = CHUNK / LANES;       // rows per lane and chunk
constexpr int SCRATCH = LANES * D * 8;   // row-lane partials (16 KB), or v's code tile
constexpr float INF = __builtin_huge_valf();

struct Operand {
  const __nv_bfloat16* x;  // [B*H, Skv, 128]
  int8_t* q;               // [B*H, Skv_p, 128], or v^T [B*H, 128, Skv_p]
  float* scale;            // [B*H, Skv_p / QB]
  float* mean;             // [B*H, 128]
  int transposed;
};

struct Operands {
  Operand op[2];
};

// Shared memory: scratch, the f64 column sums, the mean, 8 warp maxima, then
// per quantization block its column (min, max) over this block's chunks and
// its scale.
size_t smem_bytes(int nblk) {
  return SCRATCH + D * 8 + D * 4 + 8 * 4 + (size_t)nblk * (D * 8 + 4);
}

__device__ __forceinline__ void unpack8(uint4 raw, float (&f)[8]) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(x[e]);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 2)
flash_quant_kernel(const __grid_constant__ Operands ops, int Skv, int QB) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* scratch = smem;
  double* csum = reinterpret_cast<double*>(smem + SCRATCH);
  float* mean = reinterpret_cast<float*>(csum + D);
  float* wmax = mean + D;
  float2* bmm = reinterpret_cast<float2*>(wmax + 8);  // [nblk][D]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.y;
  const Operand op = ops.op[blockIdx.z];
  const int skv_p = (Skv + QB - 1) / QB * QB;
  const int nchunks = skv_p / CHUNK;
  const int nblk = skv_p / QB;
  float* bscale = reinterpret_cast<float*>(bmm + (size_t)nblk * D);
  const int cpb = QB / CHUNK;  // chunks per quantization block
  const int tid = threadIdx.x;
  const int c8 = (tid & 15) * 8;  // read 1 and k's codes: columns c8 .. c8 + 7
  const int rl = tid >> 4;        // of rows rl, rl + 16, ... of a chunk
  const __nv_bfloat16* x = op.x + (size_t)bh * Skv * D;

  // The 8 rows x 8 columns of a chunk a thread reads: row lane rl's rows, or
  // for v's codes two row quads (r, r + 1, r + 8, r + 9) of 8 columns.
  const bool vq = op.transposed;
  auto row_of = [&](int pass, int i) {
    if (pass == 1 || !vq) return rl + LANES * i;
    const int quad = (tid + THREADS * (i >> 2)) & 31;
    const int r = (quad >> 3) * 32 + 16 * ((quad >> 2) & 1) + 2 * (quad & 3);
    return r + (i & 1) + 8 * ((i >> 1) & 1);
  };
  auto col_of = [&](int pass, int i) {
    return pass == 1 || !vq ? c8 : ((tid + THREADS * (i >> 2)) >> 5) * 8;
  };
  auto load = [&](int pass, int c, uint4 (&raw)[RPL]) {
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int row = c * CHUNK + row_of(pass, i);
      raw[i] = row < Skv ? *reinterpret_cast<const uint4*>(x + (size_t)row * D + col_of(pass, i))
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  if (tid < D) {
    for (int q = 0; q < nblk; ++q) bmm[q * D + tid] = make_float2(INF, -INF);
  }
  // Read 1, the next owned chunk's loads in flight while one is reduced.
  double sum[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum[e] = 0.0;
  float* lmin = reinterpret_cast<float*>(scratch);  // [LANES][D]
  float* lmax = lmin + LANES * D;                   // [LANES][D]
  uint4 raw[RPL], nxt[RPL];
  if (rank < nchunks) load(1, rank, raw);
  for (int c = rank; c < nchunks; c += CLUSTER) {
    if (c + CLUSTER < nchunks) load(1, c + CLUSTER, nxt);
    float mn[8], mx[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mn[e] = INF;
      mx[e] = -INF;
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      if (c * CHUNK + rl + LANES * i >= Skv) break;
      float f[8];
      unpack8(raw[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sum[e] += f[e];
        mn[e] = fminf(mn[e], f[e]);
        mx[e] = fmaxf(mx[e], f[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      lmin[rl * D + c8 + e] = mn[e];
      lmax[rl * D + c8 + e] = mx[e];
    }
    __syncthreads();
    if (tid < D) {
      float2 m = bmm[(c / cpb) * D + tid];
      for (int l = 0; l < LANES; ++l) {
        m.x = fminf(m.x, lmin[l * D + tid]);
        m.y = fmaxf(m.y, lmax[l * D + tid]);
      }
      bmm[(c / cpb) * D + tid] = m;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPL; ++i) raw[i] = nxt[i];
  }
  double* lsum = reinterpret_cast<double*>(scratch);  // [LANES][D]
#pragma unroll
  for (int e = 0; e < 8; ++e) lsum[rl * D + c8 + e] = sum[e];
  __syncthreads();
  if (tid < D) {
    double s = 0.0;
    for (int l = 0; l < LANES; ++l) s += lsum[l * D + tid];
    csum[tid] = s;
  }
  cluster.sync();

  // The mean: the blocks' sums in rank order.
  if (tid < D) {
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) s += *cluster.map_shared_rank(csum + tid, r);
    mean[tid] = __fdiv_rn(__double2float_rn(s), static_cast<float>(Skv));
    if (rank == 0) op.mean[(size_t)bh * D + tid] = mean[tid];
  }
  // Every quantization block's scale, from the blocks' column minima and
  // maxima over their chunks of it.
  for (int q = 0; q < nblk; ++q) {
    float a = 0.f;
    if (tid < D) {
      float2 m = make_float2(INF, -INF);
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) {
        const float2 v = *cluster.map_shared_rank(bmm + q * D + tid, r);
        m.x = fminf(m.x, v.x);
        m.y = fmaxf(m.y, v.y);
      }
      const float mu = mean[tid];
      a = fmaxf(0.f, fmaxf(__fsub_rn(m.y, mu), __fsub_rn(mu, m.x)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if ((tid & 31) == 0) wmax[tid >> 5] = a;
    __syncthreads();
    if (tid == 0) {
      for (int i = 1; i < THREADS / 32; ++i) a = fmaxf(a, wmax[i]);
      const float sc = a == 0.f ? 1.f : __fdiv_rn(a, 127.f);
      bscale[q] = sc;
      if (rank == 0) op.scale[(size_t)bh * nblk + q] = sc;
    }
    __syncthreads();
  }
  cluster.sync();  // no block reads another's shared memory after this

  // Read 2: the codes of the owned chunks, again with the next chunk's loads
  // in flight. k: each thread's 8 rows x 8 columns, 8-byte stores. v: rows
  // r, r + 1, r + 8, r + 9 (r = 32A + 16a + 2T), whose codes are consecutive
  // in v_kernel_layout's order (position 32A + 16a + 4T..): one 4-byte word
  // per channel into a [128 channels][128 positions] tile, the 32 row quads
  // of a warp on 32 banks; the tile leaves as rows of v^T.
  uint8_t* tile = scratch;
  if (rank < nchunks) load(2, rank, raw);
  for (int c = rank; c < nchunks; c += CLUSTER) {
    if (c + CLUSTER < nchunks) load(2, c + CLUSTER, nxt);
    const float sc = bscale[c / cpb];
    const Divisor dc = divisor(sc);  // one IEEE reciprocal a chunk, then quotient()
    auto codes8 = [&](int i, int (&code)[8]) {
      const int col = col_of(2, i);
      const bool real = c * CHUNK + row_of(2, i) < Skv;
      float f[8];
      unpack8(raw[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        code[e] = real ? __float2int_rn(quotient(__fsub_rn(f[e], mean[col + e]), dc)) : 0;
    };
    if (!vq) {
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        int code[8];
        codes8(i, code);
        const int row = c * CHUNK + row_of(2, i);
        *reinterpret_cast<uint2*>(op.q + ((size_t)bh * skv_p + row) * D + c8) =
            make_uint2(low_bytes(code[0], code[1], code[2], code[3]),
                       low_bytes(code[4], code[5], code[6], code[7]));
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // two row quads
        int code[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) codes8(4 * h + u, code[u]);
        const int col = col_of(2, 4 * h);
        const int pos = row_of(2, 4 * h) + 2 * (tid & 3);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          *reinterpret_cast<uint32_t*>(tile + (col + e) * CHUNK + pos) =
              low_bytes(code[0][e], code[1][e], code[2][e], code[3][e]);
      }
      __syncthreads();
      // 128 rows of v^T x 128 bytes, 16 bytes a thread per pass
#pragma unroll
      for (int it = 0; it < D * CHUNK / 16 / THREADS; ++it) {
        const int idx = tid + THREADS * it;
        const int ch = idx >> 3;
        const int piece = (idx & 7) * 16;
        *reinterpret_cast<uint4*>(op.q + ((size_t)bh * D + ch) * skv_p + c * CHUNK + piece) =
            *reinterpret_cast<const uint4*>(tile + ch * CHUNK + piece);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i) raw[i] = nxt[i];
  }
}

}  // namespace

// The prepass of one call. k, v bf16 [B, H, Skv, 128] contiguous, either
// null (its outputs unused); kq int8 [B, H, Skv_p, 128], sk f32 [B, H,
// Skv_p / QB], km f32 [B, H, 128]; vq int8 [B, H, 128, Skv_p] (v_kernel_layout
// order), sv, vm likewise. Skv_p = Skv rounded up to QB, a multiple of 128.
// 16-byte aligned. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a bad QB or Skv.
extern "C" int flash_quant(const void* k, void* kq, void* sk, void* km, const void* v, void* vq,
                           void* sv, void* vm, int B, int H, int Skv, int QB, void* stream) {
  if (QB <= 0 || QB % CHUNK || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Operands ops{};
  int n = 0;
  if (k != nullptr)
    ops.op[n++] = {static_cast<const __nv_bfloat16*>(k), static_cast<int8_t*>(kq),
                   static_cast<float*>(sk), static_cast<float*>(km), 0};
  if (v != nullptr)
    ops.op[n++] = {static_cast<const __nv_bfloat16*>(v), static_cast<int8_t*>(vq),
                   static_cast<float*>(sv), static_cast<float*>(vm), 1};
  if (n == 0) return 0;
  const int nblk = (Skv + QB - 1) / QB;
  const size_t smem = smem_bytes(nblk);
  static size_t raised[MAX_DEVICES] = {};
  if (smem > 48 * 1024) {
    const int err =
        raise_smem_limit(reinterpret_cast<const void*>(flash_quant_kernel), smem, raised);
    if (err != 0) return err;
  }
  const dim3 grid(CLUSTER, B * H, n);
  flash_quant_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(ops, Skv, QB);
  return static_cast<int>(cudaGetLastError());
}
