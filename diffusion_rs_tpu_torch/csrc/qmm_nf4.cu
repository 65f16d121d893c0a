// 4-bit codebook quantized matmul (nf4/fp4): y[M, N] = x[M, K] @ deq(W)[K, N].
//
// Replaces diffusion_rs_tpu/ops/qmatmul_pallas.py:_qmm_kernel, 4-bit
// codebook branch: _dequant_tile (:57-120) with _codebook_select (:34),
// reached through _qmm_call -> pl.pallas_call (:378).
// K11 qmm_grouped_nf4: replaces the codebook branch of _qmm_grouped_kernel
// (:539-554), reached through _qmm_grouped_call -> pl.pallas_call (:630): up
// to eight products of one [K, N] nf4/fp4 format in one launch. As K8 in
// qmm_s8.cu and qmm_affine.cu, the kernel takes a group table by value; the
// output tiles run over the sum of the groups' m-tiles, a tile's group comes
// from the tile offsets, and each group's m-tiles start at its own row 0, so
// a group's output is K2's output for that group bit for bit. K2 is the
// table of one group. Nothing is stacked or copied per call. No fast16
// mode: JAX passes fast16=False to every grouped call (:726).
// K12 qmm_nf4_fast16: replaces the same branch with fast16=True, the opt-in
// 16-bit decode of _dequant_tile (:45-54 with val_dtype bf16, :100-120):
// each codebook entry rounded to bf16, times the group scale rounded to
// bf16, the product rounded to bf16. It is K2's kernel with FAST16 = true:
// only the decode changes. The codebook sits in shared memory as bf16 bits;
// the two weights of an A register pair into one fma.rn.bf16x2 (a * s + -0:
// one rounding).
//
// Math: the packed plane is u8 [K/2, N] in split-block order: inside each
// `split`-row run, packed row r holds k-row r in its low nibble and k-row
// r + split/2 in its high nibble. Each code is looked up in the 16-entry f32
// codebook, multiplied by its per-group f32 scale, rounded to bf16, and the
// product runs bf16 x bf16 with f32 accumulation; one cast to bf16 at the
// end. So the decoded weight equals dequantize(qt, f32).to(bf16) (K12:
// dequantize_fast16) bit for bit; only the f32 summation order differs.
//
// Bound on the H100: at the T5-XXL encode shapes (M = 512, K x N of
// 4096 x 4096 up to 10240 x 4096) and FLUX's nf4 linears (M = 4608) the
// bf16 tensor-core rate (2*M*K*N operations against K*N/2 weight bytes); a
// mixed-input kernel is held back further by the decode's instructions and
// its codebook lookups in shared memory. The kernel is warp-specialised for
// Hopper and computes the tile of y^T = W^T x^T, so the decoded tile never
// goes through shared memory and the planes keep their [K, N] layout:
// * a producer warp feeds an mbarrier ring with TMA: per stage 64 packed
//   rows x 128 columns (128-byte swizzle) and, for each half of them (32
//   rows, inside one split-block run), the two BM x 32 slices of x they pair
//   with (wgmma's K-major B operand, 64-byte swizzle: k_lo.. and
//   k_lo + split/2..) and the scale row of each slice (512-byte bulk copies);
// * two consumer warpgroups (setmaxnreg gives them the producer's
//   registers), 64 output columns each over all BM rows: per 16 packed rows
//   a thread loads two bytes (its two columns) of four rows, decodes them
//   into the A fragments of two wgmma.m64nBMk16 products (one packed byte
//   feeds k and k + split/2), and issues them while it decodes the next;
// * shared memory bandwidth bounds the consumers: wgmma reads x once per
//   64 A rows, and the decode reads the codebook once per weight, whose
//   value then serves BM rows. Where the grid still fills the card four
//   times over, BM is 256 (ops/qmatmul.py qmm_plan), halving the lookups
//   per product;
// * the kernel is persistent (at most one block per SM walks the output
//   tiles through one ring), and each group's codebook sits in shared
//   memory, since a block's tiles may belong to several groups.
#include "common.cuh"

namespace {

constexpr int BN = 128;                    // output columns per tile: 64 per consumer warpgroup
constexpr int PK = 64;                     // packed rows per ring stage: 128 k positions
constexpr int P_BOX = PK * BN;             // packed [64][128 columns], 128-byte swizzle
constexpr int S_ROW = BN * 4;              // one scale row of the block's columns
constexpr int THREADS = 384;               // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;          // each releases a stage once its wgmmas are done
constexpr int MAX_GROUPS = 8;

// A ring stage for tiles of BM rows (128 or 256; a multiple of 1024 bytes):
// 4 x slices [BM m][32 k] bf16 (64-byte swizzle), the packed box, 4 scale rows.
template <int BM>
struct Ring {
  static constexpr int STAGES = BM == 256 ? 3 : 4;
  static constexpr int X_BOX = BM * 32 * 2;
  static constexpr int P_OFF = 4 * X_BOX;
  static constexpr int S_OFF = P_OFF + P_BOX;
  static constexpr int STAGE_BYTES = S_OFF + 4 * S_ROW;
  static constexpr size_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
};

// One product of a call: maps of x [m, K] (box BM x 32 bf16) and of the
// packed plane [K/2, N] (box 64 x 128), the scale plane [K/group, N], the
// codebook [16] and the output [m, N]; tile0 is where its m-tiles start
// among the call's.
struct Group {
  CUtensorMap xmap;
  CUtensorMap pmap;
  const float* scale;
  const float* codebook;
  void* out;  // bf16, or f32 where out_f32
  int m, tile0, out_f32;
};

struct Table {
  Group g[MAX_GROUPS];
  int count;
};

// First k of the low nibbles of packed rows p.. (p % 32 == 0; the 32 rows
// lie in one run since split % 64 == 0); their high nibbles start split/2
// further on.
__device__ __forceinline__ int slice_k(int p, int split) {
  const int half = split / 2;
  return (p / half) * split + p % half;
}

// Output tile t of a call: m-tile t / n_tiles (of the groups' m-tiles, in
// order), n-tile t % n_tiles; consecutive tiles share their x rows.
struct TileAt {
  int gi, m0, n0;
};

template <int BM>
__device__ __forceinline__ TileAt tile_at(const Table& tab, int t, int n_tiles) {
  const int mt = t / n_tiles;
  int gi = 0;
#pragma unroll
  for (int i = 1; i < MAX_GROUPS; ++i)
    if (i < tab.count && mt >= tab.g[i].tile0) gi = i;
  return {gi, (mt - tab.g[gi].tile0) * BM, (t % n_tiles) * BN};
}

// Persistent: each block walks tiles blockIdx.x, + gridDim.x, ... through
// one ring, so the producer loads the next tile while the consumers store
// the last one.
template <bool FAST16, int BM>
__global__ void __launch_bounds__(THREADS, 1)
qmm_nf4_kernel(const __grid_constant__ Table tab, int tiles, int K, int N, int split,
               int group) {
  using R = Ring<BM>;
  constexpr int STAGES = R::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float cb[MAX_GROUPS][16];
  __shared__ uint16_t cbh[MAX_GROUPS][16];  // FAST16: bf16 bits
  uint8_t* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * R::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_tiles = N / BN;
  const int prows = K / 2;
  const int nstages = (prows + PK - 1) / PK;  // per tile

  if (threadIdx.x < 16 * MAX_GROUPS && threadIdx.x / 16 < tab.count) {
    const int gc = threadIdx.x / 16, e = threadIdx.x % 16;
    if constexpr (FAST16) {
      cbh[gc][e] = bf16_bits(tab.g[gc].codebook[e]);
    } else {
      cb[gc][e] = tab.g[gc].codebook[e];
    }
  }
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
        const TileAt T = tile_at<BM>(tab, t, n_tiles);
        const Group& G = tab.g[T.gi];
        for (int sp = 0; sp < nstages; ++sp, ++s) {
          const int buf = s % STAGES;
          if (s >= STAGES) mbar_wait(&empty[buf], ((s / STAGES) + 1) & 1);
          uint8_t* st = stages + buf * R::STAGE_BYTES;
          // a last stage of 32 rows (K/2 % 64 == 32) loads one half
          const int halves = prows - sp * PK > 32 ? 2 : 1;
          mbar_expect_tx(&full[buf], P_BOX + halves * 2 * (R::X_BOX + S_ROW));
          tma_load_2d(st + R::P_OFF, &G.pmap, T.n0, sp * PK, &full[buf]);
          for (int hs = 0; hs < halves; ++hs) {
            const int k_lo = slice_k(sp * PK + 32 * hs, split);
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              // slice 2hs + b: k_lo (b = 0) or k_lo + split/2; a 32-aligned
              // slice lies in one scale group (group % 32 == 0)
              const int k = k_lo + b * (split / 2);
              tma_load_2d(st + (2 * hs + b) * R::X_BOX, &G.xmap, k, T.m0, &full[buf]);
              bulk_load(st + R::S_OFF + (2 * hs + b) * S_ROW,
                        G.scale + (size_t)(k / group) * N + T.n0, S_ROW, &full[buf]);
            }
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroups.
  setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;
  const int w = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // A rows 16w + g and 16w + g + 8 of the warpgroup hold block columns nb
  // and nb + 1: one 16-bit load per packed row gives both. Its packed rows
  // 2t + {0, 1, 8, 9} of a 16-row block: k 2t, 2t + 1 (a0, a1) and 2t + 8,
  // 2t + 9 (a2, a3); the swizzle puts the four t on four 16-byte chunks.
  const int nb = 64 * cw + 16 * w + 2 * g;
  uint32_t p_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 2 * t4 + (j & 1) + 8 * (j >> 1);
    p_off[j] = r * BN + (((nb >> 4) ^ (r & 7)) << 4) + (nb & 15);
  }

  int s = 0;  // stages consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt T = tile_at<BM>(tab, t, n_tiles);
    const float* cbg = cb[T.gi];
    const uint16_t* cbhg = cbh[T.gi];
    // two codes (k, k + 1 of one column) times that column's scale -> one A register
    auto decode2 = [&](uint32_t c0, uint32_t c1, float sc) -> uint32_t {
      if constexpr (FAST16) {
        const uint32_t e = static_cast<uint32_t>(cbhg[c0]) | (static_cast<uint32_t>(cbhg[c1]) << 16);
        return bf16x2_mul(e, pack_bf16x2(sc, sc));
      } else {
        return pack_bf16x2(__fmul_rn(cbg[c0], sc), __fmul_rn(cbg[c1], sc));
      }
    };
    float acc[BM / 2];
#pragma unroll
    for (int r = 0; r < BM / 2; ++r) acc[r] = 0.f;

    // A stage is released once its wgmmas are done: one stage's group stays
    // in flight while the next stage decodes.
    int pending = -1;
    for (int sp = 0; sp < nstages; ++sp, ++s) {
      const int buf = s % STAGES;
      mbar_wait(&full[buf], (s / STAGES) & 1);
      const uint8_t* st = stages + buf * R::STAGE_BYTES;
      const int blocks = min(PK, prows - sp * PK) / 16;
#pragma unroll
      for (int i = 0; i < PK / 16; ++i) {
        if (i < blocks) {
          // packed rows 16i..16i+15: low nibbles in slice 2(i/2), high
          // nibbles in slice 2(i/2) + 1, 16 k (32 bytes) into each
          const int b_lo = 2 * (i >> 1), b_hi = b_lo + 1;
          const int k_off = 32 * (i & 1);
          const float2 s_lo =
              *reinterpret_cast<const float2*>(st + R::S_OFF + b_lo * S_ROW + nb * 4);
          const float2 s_hi =
              *reinterpret_cast<const float2*>(st + R::S_OFF + b_hi * S_ROW + nb * 4);
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = *reinterpret_cast<const uint16_t*>(st + R::P_OFF + 16 * i * BN + p_off[j]);
          // byte 0: column nb (rows g: a0, a2), byte 1: nb + 1 (rows g + 8: a1, a3)
          uint32_t a_lo[4], a_hi[4];
          a_lo[0] = decode2(v[0] & 15u, v[1] & 15u, s_lo.x);
          a_lo[1] = decode2((v[0] >> 8) & 15u, (v[1] >> 8) & 15u, s_lo.y);
          a_lo[2] = decode2(v[2] & 15u, v[3] & 15u, s_lo.x);
          a_lo[3] = decode2((v[2] >> 8) & 15u, (v[3] >> 8) & 15u, s_lo.y);
          a_hi[0] = decode2((v[0] >> 4) & 15u, (v[1] >> 4) & 15u, s_hi.x);
          a_hi[1] = decode2(v[0] >> 12, v[1] >> 12, s_hi.y);
          a_hi[2] = decode2((v[2] >> 4) & 15u, (v[3] >> 4) & 15u, s_hi.x);
          a_hi[3] = decode2(v[2] >> 12, v[3] >> 12, s_hi.y);
          wgmma_fence();
          WgmmaBf16<BM, 0>::run(acc, a_lo, wgmma_desc(st + b_lo * R::X_BOX + k_off, 512, 2), 1);
          WgmmaBf16<BM, 0>::run(acc, a_hi, wgmma_desc(st + b_hi * R::X_BOX + k_off, 512, 2), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);
      pending = buf;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[pending]);
#pragma unroll
    for (int r = 0; r < BM / 2; ++r) reg_fence(acc[r]);

    // acc[4j + 2h + e]: row m0 + 8j + 2t + e, block column nb + h.
    const Group& G = tab.g[T.gi];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = T.m0 + 8 * j + 2 * t4 + e;
        if (row < G.m) store_pair(G.out, G.out_f32, (size_t)row * N + T.n0 + nb,
                                  acc[4 * j + e], acc[4 * j + 2 + e]);
      }
  }
}

// One product's arguments, as the entry points take them.
struct Args {
  const void* x;
  const void* packed;
  const void* scale;
  const void* codebook;
  void* out;
  int m;
};

// The kernel over m_tiles x N/128 output tiles, one block per SM at most.
template <bool FAST16, int BM>
cudaError_t launch(const Table& tab, int m_tiles, int K, int N, int split, int group,
                   cudaStream_t stream) {
  static size_t raised[MAX_DEVICES] = {};
  static int sm_counts[MAX_DEVICES] = {};
  const size_t smem = Ring<BM>::SMEM_BYTES;
  int sms = 0;
  int err =
      raise_smem_limit(reinterpret_cast<const void*>(qmm_nf4_kernel<FAST16, BM>), smem, raised);
  if (err == 0) err = device_sm_count(&sms, sm_counts);
  if (err != 0) return static_cast<cudaError_t>(err);
  const int tiles = m_tiles * (N / BN);
  qmm_nf4_kernel<FAST16, BM><<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(
      tab, tiles, K, N, split, group);
  return cudaGetLastError();
}

// Encodes the groups' maps and launches the kernel with blocks of bm rows
// (128 or 256). Returns a cudaError_t.
template <bool FAST16>
int run(const Args* args, int count, int K, int N, int split, int group, int bm,
        bool out_f32, cudaStream_t stream) {
  if (split % 64 != 0 || K % split != 0 || group % 32 != 0 || K % group != 0 || N % BN != 0 ||
      (bm != 128 && bm != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  tab.count = count;
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    const Args& a = args[i];
    Group& g = tab.g[i];
    g.scale = static_cast<const float*>(a.scale);
    g.codebook = static_cast<const float*>(a.codebook);
    g.out = a.out;
    g.out_f32 = out_f32 ? 1 : 0;
    g.m = a.m;
    g.tile0 = tiles;
    if (a.m > 0) {
      int err = encode_tensor_map_2d(&g.xmap, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.m, K,
                                     bm, 32, CU_TENSOR_MAP_SWIZZLE_64B);
      if (err == 0)
        err = encode_tensor_map_2d(&g.pmap, a.packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, N,
                                   PK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != 0) return err;
    }
    tiles += (a.m + bm - 1) / bm;
  }
  if (tiles == 0) return 0;
  const cudaError_t err = bm == 256 ? launch<FAST16, 256>(tab, tiles, K, N, split, group, stream)
                                    : launch<FAST16, 128>(tab, tiles, K, N, split, group, stream);
  return static_cast<int>(err);
}

}  // namespace

// K2. x bf16 [M, K]; packed u8 [K/2, N]; scale f32 [K/group, N]; codebook f32
// [16]; out bf16 [M, N]; blocks of block_m rows, 128 or 256 (ops/qmatmul.py
// qmm_plan). Needs split % 64 == 0, K % split == 0, group % 32 == 0,
// N % 128 == 0, and 16-byte aligned x, packed and scale. Returns
// cudaGetLastError(), or the tensor-map encoder's refusal.
extern "C" int qmm_nf4(const void* x, const void* packed, const void* scale,
                       const void* codebook, void* out, int M, int K, int N,
                       int split, int group, int block_m, void* stream) {
  const Args a{x, packed, scale, codebook, out, M};
  return run<false>(&a, 1, K, N, split, group, block_m, false,
                    static_cast<cudaStream_t>(stream));
}

// K12: K2 with the fast16 decode; the same arguments.
extern "C" int qmm_nf4_fast16(const void* x, const void* packed, const void* scale,
                              const void* codebook, void* out, int M, int K, int N,
                              int split, int group, int block_m, void* stream) {
  const Args a{x, packed, scale, codebook, out, M};
  return run<true>(&a, 1, K, N, split, group, block_m, false,
                   static_cast<cudaStream_t>(stream));
}

// K2 and K12 storing f32 (out f32 [M, N], 8-byte aligned; a row-parallel
// linear's partial); the same arguments.
extern "C" int qmm_nf4_f32(const void* x, const void* packed, const void* scale,
                           const void* codebook, void* out, int M, int K, int N,
                           int split, int group, int block_m, void* stream) {
  const Args a{x, packed, scale, codebook, out, M};
  return run<false>(&a, 1, K, N, split, group, block_m, true,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int qmm_nf4_fast16_f32(const void* x, const void* packed, const void* scale,
                                  const void* codebook, void* out, int M, int K, int N,
                                  int split, int group, int block_m, void* stream) {
  const Args a{x, packed, scale, codebook, out, M};
  return run<true>(&a, 1, K, N, split, group, block_m, true,
                   static_cast<cudaStream_t>(stream));
}

// K11. table: G rows of 6 int64 {x, packed, scale, codebook, out, m}, each
// group as K2's arguments, all of one K, N, split and group. 1 <= G <= 8.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad G.
extern "C" int qmm_grouped_nf4(const long long* table, int G, int K, int N, int split,
                               int group, int block_m, void* stream) {
  if (G < 1 || G > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  Args args[MAX_GROUPS];
  for (int i = 0; i < G; ++i) {
    const long long* r = table + 6 * i;
    args[i] = {reinterpret_cast<const void*>(r[0]), reinterpret_cast<const void*>(r[1]),
               reinterpret_cast<const void*>(r[2]), reinterpret_cast<const void*>(r[3]),
               reinterpret_cast<void*>(r[4]), static_cast<int>(r[5])};
  }
  return run<false>(args, G, K, N, split, group, block_m, false,
                    static_cast<cudaStream_t>(stream));
}
