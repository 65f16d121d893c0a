// q8t quantized matmul: y[M, N] = x[M, K] @ deq(W)[K, N], bf16 in, bf16 or f32 out.
//
// K1 qmm_s8: replaces diffusion_rs_tpu/ops/qmatmul_pallas.py:_qmm_kernel,
// s8 branch (:134-151), reached through _qmm_call -> pl.pallas_call (:378).
// K8 qmm_grouped_s8: replaces the s8 branch of _qmm_grouped_kernel (:515),
// reached through _qmm_grouped_call -> pl.pallas_call (:630): up to eight
// products of one [K, N] q8t format (each group its own x, weight planes
// and output) in one launch of each pass. Both passes take a group table by
// value; an output tile (or a quantize warp) finds its group from the
// table's prefix sums of rows and m-tiles, and each group's m-tiles start at
// its own row 0, so a group's output is K1's output for that group bit for
// bit. K1 is the table of one group. Nothing is stacked or copied per call (the
// Pallas call's jnp.stack of the weights and concatenation of padded
// activations are TPU artefacts).
//
// Math (the Pallas kernel's, bit for bit): per row and per K-tile of
// bk = min(256, K) columns, sx = max|x| / 127 (1 where the row is all zero),
// xq = round_half_even(x / sx) as int8, an s8 x s8 -> s32 dot with the int8
// weight plane, then acc += float(i32) * (sx * scale[kt, n]) in f32, K-tiles
// summed in order, and one cast to bf16 at the end (none for the f32-output
// entry, qmm_s8_f32: a row-parallel linear's partial). The division and the
// rounding are IEEE (no fast math); the fold uses __fmul_rn/__fadd_rn so the
// compiler cannot contract it into an FMA. A finer fold would change the f32
// roundings, so the s32 sum spans exactly one K-tile.
//
// Bound on the H100: at the FLUX image/joint shapes (M = 4096/4608, K and N
// in the thousands) the int8 tensor-core rate (2*M*K*N operations); at M = 1
// (the modulation linears) reading the weight plane. With A from registers
// a warpgroup's wgmma reads its B tile once per 64 A rows, so at the int8
// rate the B reads, TMA's writes of the stages and the loads that build A
// ask more of shared memory's 128 bytes a clock than it has: shared memory
// bandwidth, then the exact per-K-tile fold, hold the kernel back.
//
// Pass 1 quantizes x once into an int8 copy and per-(K-tile, row) scales
// (one warp per row and four K-tiles, 16 bytes per lane and tile), so the
// product kernel never redoes that work per N-tile. Pass 2 is warp-specialised for Hopper.
// It computes the tile of y^T = W^T x^T, so that the planes keep the [K, N]
// layout every loader hands over:
// * a producer warp feeds a ring of mbarrier stages with TMA: per stage the
//   BK x 128 W tile (128-byte swizzle), the 128 x BK xq tile (BK-byte
//   swizzle: wgmma's K-major B operand as it is) and, on the last stage of a
//   K-tile, that tile's weight-scale and sx rows (two 512-byte bulk copies);
//   BK is 128 (6 stages) where the K-tile allows, else 64 (8 stages);
// * two consumer warpgroups (setmaxnreg gives them the producer's
//   registers) each own 64 output columns x all 128 rows, one
//   wgmma.m64n128k32 s8 product per 32 k with A, the W^T tile, in
//   registers. int8 wgmma takes only K-major operands and W is N-major, so
//   each thread loads its two columns of four k-rows as 16-bit words and
//   transposes them with four __byte_perm; the lanes of a quad read their
//   rows in a rotated order, so the loads are free of bank conflicts. One
//   stage's wgmmas stay in flight while the next stage's A is built;
// * the s32 accumulators span one K-tile (the first wgmma of a tile writes
//   with scale-d = 0); after wgmma.wait_group the fold converts each s32
//   exactly by adding 1.5 * 2^23 (|dot| < 2^22 for K-tiles up to 256; an
//   I2F beyond), and the epilogue stores two consecutive columns per row;
// * the kernel is persistent: at most one block per SM, each walking the
//   output tiles through one ring, so the next tile's loads overlap the
//   last tile's fold and stores.
#include "common.cuh"

namespace {

constexpr int BN = 128;             // output columns per tile: 64 per consumer warpgroup
constexpr int BM = 128;             // rows per tile (wgmma N)
constexpr int SC_FLOATS = BN + BM;  // a K-tile's weight-scale row, then its sx row
constexpr int THREADS = 384;        // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;   // each releases a stage once its wgmmas are done
constexpr int MAX_GROUPS = 8;

// A ring stage of BK k (64, or 128 when the K-tile allows): the W tile
// [BK k][128 n] (128-byte swizzle), the xq tile [128 m][BK k] (BK-byte
// swizzle, wgmma's K-major B operand) and the fold's scales.
template <int BK>
struct Ring {
  static constexpr int STAGES = BK == 128 ? 6 : 8;
  static constexpr int W_TILE = BK * BN;
  static constexpr int X_TILE = BM * BK;
  static constexpr size_t SMEM_BYTES =
      1024 + STAGES * (W_TILE + X_TILE + SC_FLOATS * sizeof(float)) + 2 * STAGES * sizeof(uint64_t);
};

// Pass 1, one product: x [m, K], its int8 copy xq [m, K] and scales sx
// [K/bk, m_pad] (scratch); row0 is where its rows start in the call.
struct QuantGroup {
  const __nv_bfloat16* x;
  int8_t* xq;
  float* sx;
  int m, m_pad, row0;
};

struct QuantTable {
  QuantGroup g[MAX_GROUPS];
  int count;
};

// Pass 2, one product: maps of xq (box 128 x BK) and of the weight plane w
// [K, N] (box BK x 128), the scale planes, the output [m, N]; tile0 is where
// its m-tiles start among the call's.
struct Group {
  CUtensorMap xmap;
  CUtensorMap wmap;
  const float* sx;
  const float* scale;
  void* out;  // bf16, or f32 where out_f32
  int m, m_pad, tile0, out_f32;
};

struct Table {
  Group g[MAX_GROUPS];
  int count;
};

__device__ __forceinline__ float absmax8(uint4 raw) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float ax = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ax = fmaxf(ax, fabsf(__bfloat162float(h[e])));
  return ax;
}

// round_half_even(x / s) of 8 bf16 as 8 int8 (IEEE quotient).
__device__ __forceinline__ uint2 quantize8(uint4 raw, float s) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
  uint32_t q[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int v = __float2int_rn(__bfloat162float(h[e]) / s);
    q[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(v))) << (8 * (e & 3));
  }
  return make_uint2(q[0], q[1]);
}

// One warp per row and QT K-tiles over all groups' rows: the lanes' 16-byte
// loads of all QT tiles go out together and stay in registers (a K-tile
// wider than 256 reads its rest twice); per tile sx by a shuffle max, 8
// codes per lane in one 8-byte store. sx goes to [kt, row] so that pass 2
// reads a K-tile's 128 row scales in one copy.
constexpr int QT = 4;

__global__ void quantize_rows_kernel(const QuantTable tab, int rows, int K, int bk) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int kts = K / bk;
  const int per_row = (kts + QT - 1) / QT;
  if (warp >= rows * per_row) return;
  const int grow = warp / per_row;
  QuantGroup G = tab.g[0];
#pragma unroll
  for (int i = 1; i < MAX_GROUPS; ++i)
    if (i < tab.count && grow >= tab.g[i].row0) G = tab.g[i];
  const int row = grow - G.row0;
  const int kt0 = (warp % per_row) * QT;
  const __nv_bfloat16* xr = G.x + (size_t)row * K;
  int8_t* qr = G.xq + (size_t)row * K;
  const bool on = lane * 8 < bk;
  uint4 raw[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j)
    raw[j] = on && kt0 + j < kts
                 ? *reinterpret_cast<const uint4*>(xr + (size_t)(kt0 + j) * bk + lane * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int kt = kt0 + j;
    if (kt >= kts) break;
    const __nv_bfloat16* xt = xr + (size_t)kt * bk;
    int8_t* qt = qr + (size_t)kt * bk;
    float ax = absmax8(raw[j]);
    for (int c = lane * 8 + 256; c < bk; c += 256)
      ax = fmaxf(ax, absmax8(*reinterpret_cast<const uint4*>(xt + c)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ax = fmaxf(ax, __shfl_xor_sync(0xffffffffu, ax, o));
    const float s = (ax == 0.f) ? 1.f : ax / 127.f;
    if (on) *reinterpret_cast<uint2*>(qt + lane * 8) = quantize8(raw[j], s);
    for (int c = lane * 8 + 256; c < bk; c += 256)
      *reinterpret_cast<uint2*>(qt + c) = quantize8(*reinterpret_cast<const uint4*>(xt + c), s);
    if (lane == 0) G.sx[(size_t)kt * G.m_pad + row] = s;
  }
}

// Exact float of an s32 with |v| < 2^22: v + 1.5 * 2^23 lies in
// [2^23, 2^24), where every integer is a float. Two full-rate ops, not I2F.
__device__ __forceinline__ float small_int_to_float(int32_t v) {
  return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.0f);
}

// Output tile t of a call: m-tile t / n_tiles (of the groups' m-tiles, in
// order), n-tile t % n_tiles; consecutive tiles share their xq rows.
struct TileAt {
  const Group* G;
  int m0, n0;
};

__device__ __forceinline__ TileAt tile_at(const Table& tab, int t, int n_tiles) {
  const int mt = t / n_tiles;
  int gi = 0;
#pragma unroll
  for (int i = 1; i < MAX_GROUPS; ++i)
    if (i < tab.count && mt >= tab.g[i].tile0) gi = i;
  return {&tab.g[gi], (mt - tab.g[gi].tile0) * BM, (t % n_tiles) * BN};
}

// Persistent: each block walks tiles blockIdx.x, + gridDim.x, ... through
// one ring, so the producer loads the next tile while the consumers fold
// and store the last one.
template <int BK>
__global__ void __launch_bounds__(THREADS, 1)
qmm_s8_kernel(const __grid_constant__ Table tab, int tiles, int K, int N, int bk) {
  using R = Ring<BK>;
  constexpr int STAGES = R::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* w_tiles = smem;                                      // [STAGES][W_TILE]
  uint8_t* x_tiles = w_tiles + STAGES * R::W_TILE;              // [STAGES][X_TILE]
  float* sc_tiles = reinterpret_cast<float*>(x_tiles + STAGES * R::X_TILE);  // [STAGES][SC_FLOATS]
  uint64_t* full = reinterpret_cast<uint64_t*>(sc_tiles + STAGES * SC_FLOATS);
  uint64_t* empty = full + STAGES;

  const int n_tiles = N / BN;
  const int nstages = K / BK;  // per tile
  const int spt = bk / BK;     // stages per K-tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;  // stages issued so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileAt T = tile_at(tab, t, n_tiles);
        const Group& G = *T.G;
        for (int st = 0; st < nstages; ++st, ++s) {
          const int buf = s % STAGES;
          if (s >= STAGES) mbar_wait(&empty[buf], ((s / STAGES) + 1) & 1);
          const bool fold = st % spt == spt - 1;
          mbar_expect_tx(&full[buf],
                         R::W_TILE + R::X_TILE + (fold ? SC_FLOATS * sizeof(float) : 0));
          tma_load_2d(w_tiles + buf * R::W_TILE, &G.wmap, T.n0, st * BK, &full[buf]);
          tma_load_2d(x_tiles + buf * R::X_TILE, &G.xmap, st * BK, T.m0, &full[buf]);
          if (fold) {
            const int kt = st / spt;
            float* sc = sc_tiles + buf * SC_FLOATS;
            bulk_load(sc, G.scale + (size_t)kt * N + T.n0, BN * sizeof(float), &full[buf]);
            bulk_load(sc + BN, G.sx + (size_t)kt * G.m_pad + T.m0, BM * sizeof(float),
                      &full[buf]);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroups.
  setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;  // block columns 64 cw ..
  const int w = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // A rows 16w + g and 16w + g + 8 of the warpgroup hold block columns nb and
  // nb + 1: one 16-bit load per k-row gives both. The quad's k-rows of a
  // 16-row half are 4t + r; load j reads r = (j + 2 (t >> 1)) & 3, since the
  // 128-byte swizzle XORs the 16-byte chunk with (row & 7) and rows 4t and
  // 4t + 8 would otherwise share banks.
  const int nb = 64 * cw + 16 * w + 2 * g;
  uint32_t a_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * t4 + ((j + 2 * (t4 >> 1)) & 3);
    a_off[j] = r * 128 + (((nb >> 4) ^ (r & 7)) << 4) + (nb & 15);
  }
  // the byte transpose's last step, with the rotated rows put back in order
  const uint32_t sel_lo = t4 < 2 ? 0x5410u : 0x1054u;
  const uint32_t sel_hi = t4 < 2 ? 0x7632u : 0x3276u;
  // k-rows krow0 + 4t .. +3 of columns nb (c0) and nb + 1 (c1)
  auto load_rows = [&](const uint8_t* wt, int krow0, uint32_t& c0, uint32_t& c1) {
    uint32_t L[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      L[j] = *reinterpret_cast<const uint16_t*>(wt + krow0 * 128 + a_off[j]);
    const uint32_t t01 = __byte_perm(L[0], L[1], 0x5140);
    const uint32_t t23 = __byte_perm(L[2], L[3], 0x5140);
    c0 = __byte_perm(t01, t23, sel_lo);
    c1 = __byte_perm(t01, t23, sel_hi);
  };
  const bool exact_small = bk <= 256;

  int s = 0;  // stages consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt T = tile_at(tab, t, n_tiles);
    int32_t acc[64];
    float accf[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      acc[r] = 0;
      accf[r] = 0.f;
    }
    // A stage is released once its wgmmas are done: one stage's group stays
    // in flight while the next stage's fragments are built, except at a
    // K-tile's fold, which needs the K-tile's sums.
    int pending = -1;
    for (int st = 0; st < nstages; ++st, ++s) {
      const int buf = s % STAGES;
      mbar_wait(&full[buf], (s / STAGES) & 1);
      const uint8_t* wt = w_tiles + buf * R::W_TILE;
      const uint8_t* xt = x_tiles + buf * R::X_TILE;
      uint32_t a[BK / 32][4];
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        load_rows(wt, kk * 32, a[kk][0], a[kk][1]);
        load_rows(wt, kk * 32 + 16, a[kk][2], a[kk][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t desc = BK == 128 ? wgmma_desc(xt + kk * 32, 1024, 1)
                                        : wgmma_desc(xt + kk * 32, 512, 2);
        wgmma_s8_m64n128k32(acc, a[kk], desc, (st % spt == 0 && kk == 0) ? 0 : 1);
      }
      wgmma_commit();
      if (st % spt != spt - 1) {
        wgmma_wait<1>();
        if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);
        pending = buf;
        continue;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 64; ++r) reg_fence(acc[r]);
      // K-tile fold: acc += float(i32) * (sx * scale), in the Pallas order.
      // acc[4j + 2h + e] is column nb + h, row m0 + 8j + 2t + e.
      const float* sc = sc_tiles + buf * SC_FLOATS;
      const float2 wsc = *reinterpret_cast<const float2*>(sc + nb);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 sx2 = *reinterpret_cast<const float2*>(sc + BN + 8 * j + 2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * j + 2 * h + e;
            const float f = __fmul_rn(e ? sx2.y : sx2.x, h ? wsc.y : wsc.x);
            const float v = exact_small ? small_int_to_float(acc[r]) : __int2float_rn(acc[r]);
            accf[r] = __fadd_rn(accf[r], __fmul_rn(v, f));
          }
      }
      // lane 0 of each warp releases the stages
      if (lane == 0) {
        if (pending >= 0) mbar_arrive(&empty[pending]);
        mbar_arrive(&empty[buf]);
      }
      pending = -1;
    }

    // Row m0 + 8j + 2t + e: block columns nb, nb + 1 in one 4-byte store.
    const Group& G = *T.G;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = T.m0 + 8 * j + 2 * t4 + e;
        if (row < G.m) store_pair(G.out, G.out_f32, (size_t)row * N + T.n0 + nb,
                                  accf[4 * j + e], accf[4 * j + 2 + e]);
      }
  }
}

// One product's arguments, as the entry points take them.
struct Args {
  const void* x;
  void* xq;
  void* sx;
  const void* w;
  const void* scale;
  void* out;
  int m;
};

// The product over m_tiles x N/128 output tiles, one block per SM at most.
template <int BK>
cudaError_t launch_product(const Table& tab, int m_tiles, int K, int N, int bk, cudaStream_t st) {
  static size_t raised[MAX_DEVICES] = {};
  static int sm_counts[MAX_DEVICES] = {};
  const size_t smem = Ring<BK>::SMEM_BYTES;
  int sms = 0;
  int err = raise_smem_limit(reinterpret_cast<const void*>(qmm_s8_kernel<BK>), smem, raised);
  if (err == 0) err = device_sm_count(&sms, sm_counts);
  if (err != 0) return static_cast<cudaError_t>(err);
  const int tiles = m_tiles * (N / BN);
  qmm_s8_kernel<BK><<<tiles < sms ? tiles : sms, THREADS, smem, st>>>(tab, tiles, K, N, bk);
  return cudaGetLastError();
}

// Both passes over 1..8 products of one K, N and bk, with 128-k ring stages
// when bk allows, else 64-k. Returns a cudaError_t.
int run(const Args* args, int count, int K, int N, int bk, bool out_f32, cudaStream_t st) {
  if (bk % 64 != 0 || K % bk != 0 || N % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int BK = bk % 128 == 0 ? 128 : 64;
  QuantTable qtab{};
  Table tab{};
  qtab.count = tab.count = count;
  int rows = 0, tiles = 0;
  for (int i = 0; i < count; ++i) {
    const Args& a = args[i];
    const int m_pad = (a.m + BM - 1) / BM * BM;
    qtab.g[i] = {static_cast<const __nv_bfloat16*>(a.x), static_cast<int8_t*>(a.xq),
                 static_cast<float*>(a.sx), a.m, m_pad, rows};
    Group& g = tab.g[i];
    g.sx = static_cast<const float*>(a.sx);
    g.scale = static_cast<const float*>(a.scale);
    g.out = a.out;
    g.out_f32 = out_f32 ? 1 : 0;
    g.m = a.m;
    g.m_pad = m_pad;
    g.tile0 = tiles;
    if (a.m > 0) {
      int err = encode_tensor_map_2d(
          &g.xmap, a.xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.m, K, BM, BK,
          BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
      if (err == 0)
        err = encode_tensor_map_2d(&g.wmap, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, BK, BN,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != 0) return err;
    }
    rows += a.m;
    tiles += m_pad / BM;
  }
  if (rows == 0) return 0;
  const int warps = rows * ((K / bk + QT - 1) / QT);
  quantize_rows_kernel<<<(warps + 7) / 8, 256, 0, st>>>(qtab, rows, K, bk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = BK == 128 ? launch_product<128>(tab, tiles, K, N, bk, st)
                  : launch_product<64>(tab, tiles, K, N, bk, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. x bf16 [M, K]; xq int8 [M, K] and sx f32 [K/bk, M rounded up to 128]
// are scratch; w int8 [K, N]; scale f32 [K/bk, N]; out bf16 [M, N]. Needs
// K, bk % 64 == 0, K % bk == 0, N % 128 == 0, and 16-byte aligned x, xq, w,
// scale and sx. Returns cudaGetLastError(), or the tensor-map encoder's
// refusal.
extern "C" int qmm_s8(const void* x, void* xq, void* sx, const void* w,
                      const void* scale, void* out, int M, int K, int N, int bk,
                      void* stream) {
  const Args a{x, xq, sx, w, scale, out, M};
  return run(&a, 1, K, N, bk, false, static_cast<cudaStream_t>(stream));
}

// K1 storing f32 (out f32 [M, N], 8-byte aligned); the same arguments.
extern "C" int qmm_s8_f32(const void* x, void* xq, void* sx, const void* w,
                          const void* scale, void* out, int M, int K, int N, int bk,
                          void* stream) {
  const Args a{x, xq, sx, w, scale, out, M};
  return run(&a, 1, K, N, bk, true, static_cast<cudaStream_t>(stream));
}

// K8, s8 branch. table: G rows of 7 int64 {x, xq, sx, w, scale, out, m},
// each group as K1's arguments, all of one K, N and bk. 1 <= G <= 8.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad G.
extern "C" int qmm_grouped_s8(const long long* table, int G, int K, int N, int bk,
                              void* stream) {
  if (G < 1 || G > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  Args args[MAX_GROUPS];
  for (int i = 0; i < G; ++i) {
    const long long* r = table + 7 * i;
    args[i] = {reinterpret_cast<const void*>(r[0]), reinterpret_cast<void*>(r[1]),
               reinterpret_cast<void*>(r[2]), reinterpret_cast<const void*>(r[3]),
               reinterpret_cast<const void*>(r[4]), reinterpret_cast<void*>(r[5]),
               static_cast<int>(r[6])};
  }
  return run(args, G, K, N, bk, false, static_cast<cudaStream_t>(stream));
}
