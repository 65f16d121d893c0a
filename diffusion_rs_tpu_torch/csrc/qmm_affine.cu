// Affine quantized matmul: y[M, N] = x[M, K] @ deq(W)[K, N] with
// deq(W)[k, n] = q[k, n] * scale[k / group, n] + bias[k / group, n].
//
// K4 qmm_affine: replaces diffusion_rs_tpu/ops/qmatmul_pallas.py:_qmm_kernel,
// affine branches: _dequant_tile with codebook=None and the f32 decode
// (:72-79, :100-120), the scale planes of _tile_scale_plane (:180-187),
// reached through _qmm_call -> pl.pallas_call (:378). Every GGUF format and
// bnb int8 land here: 4-bit carriers (Q4_0/Q4_1/Q2_K/Q3_K/Q4_K, unsigned
// codes 0..15 in split-block nibbles, any offset folded into the bias) and
// int8 carriers (Q5_x/Q6_K/Q8_0/Q8_K, bnb int8 with group = K).
// K8 qmm_grouped_affine: replaces the dequantizing branch of
// _qmm_grouped_kernel (:515) for these formats, reached through
// _qmm_grouped_call -> pl.pallas_call (:630): up to eight products of one
// [K, N] format in one launch. As K11 in qmm_nf4.cu, the kernel takes a
// group table by value; the output tiles run over the sum of the groups'
// m-tiles, and each group's m-tiles start at its own row 0, so a group's
// output is K4's output for that group bit for bit (a row's sums do not
// depend on the tile height: see the CUDA tests). K4 is the table of one
// group. Nothing is stacked or copied per call.
// K13 qmm_affine_fast16: replaces the affine branches with fast16=True, the
// opt-in 16-bit decode of _dequant_tile (:80-120): the code in bf16 (exact),
// then the centred form w = ((q + off) * s) + b' with off = b / s and b' = 0
// where s != 0, off = 0 and b' = b where s == 0 (K-quant groups whose f16 d
// underflowed), each op rounded to bf16 (fma.rn.bf16x2). Without a bias
// plane off = b' = -0, so the same three ops give q * s exactly. off comes
// from __fdiv_rn in f32, computed once per plane row and column of a stage
// by the warpgroup that owns the column, into shared memory; the decoded
// weight equals the plain version's (ops/qmatmul.dequantize_fast16) bit for
// bit. It is K4's kernel with FAST16 = true: only the decode changes.
//
// Math, bit for bit the plain version's decoded weight: w = q * s in f32
// (__fmul_rn), then w + b (__fadd_rn; two roundings, as in _dequant_tile's
// `w * scale; w + bias`; without a bias plane b = -0, which adds nothing),
// rounded to bf16 (RNE); bf16 x bf16 products with f32 accumulation and one
// cast to bf16 at the end. Only the f32 summation order differs from the
// plain version.
//
// Bound on the H100: operations at M >= 512 (2*M*K*N bf16 tensor-core work
// against ~K*N/2 or K*N weight bytes), bytes at M = 1 (the codes plus the
// f32 scale and bias planes: for Q4_0 at K3072 N18432, 28.3 MB of codes and
// 2 x 7.1 MB of planes). The design is K2's (qmm_nf4.cu) with the codebook
// lookup replaced by the affine decode. The kernel computes the tile of
// y^T = W^T x^T, so the decoded weight never goes through shared memory and
// the planes keep their [K, N] layout:
// * a producer warp feeds an mbarrier ring with TMA: per stage a box of 64
//   code rows x 128 columns (128-byte swizzle; 4-bit: 64 packed rows, 128 k
//   in K2's split-block pairing, each half of 32 rows inside one run; int8:
//   64 k rows), the BM x 32 slices of x they pair with (wgmma's K-major B,
//   64-byte swizzle: four for 4-bit, two for int8) and, for each slice, the
//   scale (and bias) row of its group as 512-byte bulk copies on the same
//   mbarrier: one row per slice, or one per 16 k where the group is not a
//   multiple of 32 (Q2_K, Q3_K, Q6_K: groups of 16);
// * two consumer warpgroups (setmaxnreg gives them the producer's
//   registers), 64 output columns each over all BM rows: per 16 code rows a
//   thread loads two bytes (its two columns) of four rows, decodes them into
//   the A fragments of one (int8) or two (4-bit: one packed byte feeds k and
//   k + split/2) wgmma.m64nBMk16 products, and issues them while it decodes
//   the next;
// * the tile height BM is the plan's (ops/qmatmul.py qmm_plan "affine"):
//   where the grid still fills the card twice over, 256 for int8 codes and
//   192 for 4-bit ones (at 256 their four x slices leave room for two
//   stages, which exposes the TMA latency; 192 keeps three), else 128, and
//   at M <= 64 the M rows rounded up to 8, so that the M1 modulation
//   products issue m64n8k16 and are bound by their bytes; the ring holds as
//   many stages as 192 KB allow (3 to 4 at the large tiles, up to 8 at
//   small BM);
// * the kernel is persistent (at most one block per SM walks the output
//   tiles through one ring).
#include "common.cuh"

namespace {

constexpr int BN = 128;                     // output columns per tile: 64 per consumer warpgroup
constexpr int PK = 64;                      // code rows per ring stage
constexpr int P_BOX = PK * BN;              // codes [64][128 columns], 128-byte swizzle
constexpr int S_ROW = BN * 4;               // one f32 plane row of the block's columns
constexpr int SLOTS = 8;                    // plane rows per stage: at most one per k16 block
constexpr int PLANE_BYTES = 2 * SLOTS * S_ROW;  // scale rows, then bias rows
constexpr int THREADS = 384;                // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;           // each releases a stage once its wgmmas are done
constexpr int MAX_GROUPS = 8;
constexpr int HALF_N = BN / 2;              // columns of one consumer warpgroup
// FAST16: bf16 s, off and b' [3][SLOTS][64] per warpgroup, two buffers each
constexpr int P16_ELEMS = 3 * SLOTS * HALF_N;
constexpr int P16_BYTES = 2 * 2 * P16_ELEMS * 2;
constexpr uint16_t BF16_NEG_ZERO = 0x8000u;

// A ring stage for BITS-bit codes and tiles of BM rows (a multiple of 8):
// NX slices [BM m][32 k] bf16 (64-byte swizzle), the code box, the plane
// rows. Every part is a multiple of 1024 bytes.
template <int BITS, int BM, bool FAST16>
struct Ring {
  static constexpr int NX = BITS == 4 ? 4 : 2;
  static constexpr int X_BOX = BM * 32 * 2;
  static constexpr int P_OFF = NX * X_BOX;
  static constexpr int PL_OFF = P_OFF + P_BOX;
  static constexpr int STAGE_BYTES = PL_OFF + PLANE_BYTES;
  static constexpr int FIT = 196608 / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr size_t SMEM_BYTES =
      1024 + (size_t)STAGES * STAGE_BYTES + (FAST16 ? P16_BYTES : 0) + 2 * STAGES * sizeof(uint64_t);
  static_assert(STAGES >= 2 && P_OFF % 1024 == 0, "ring layout");
};

// One product of a call: maps of x [m, K] (box BM x 32 bf16) and of the
// codes [K/2 or K, N] (box 64 x 128 u8), the f32 planes [K/group, N] (bias
// null when no group has one), the output [m, N]; tile0 is where its
// m-tiles start among the call's.
struct Group {
  CUtensorMap xmap;
  CUtensorMap pmap;
  const float* scale;
  const float* bias;
  void* out;  // bf16, or f32 where out_f32
  int m, tile0, out_f32;
};

struct Table {
  Group g[MAX_GROUPS];
  int count;
};

// First k of x slice sl (0..NX-1) of stage sp. 4-bit: slices 2hs and
// 2hs + 1 hold the low and high nibbles of packed rows 64sp + 32hs.. (one
// split-block run since split % 64 == 0); int8: k rows 64sp + 32sl..
template <int BITS>
__device__ __forceinline__ int slice_k(int sp, int sl, int split) {
  if constexpr (BITS == 4) {
    const int half = split / 2;
    const int p = sp * PK + 32 * (sl >> 1);
    return (p / half) * split + p % half + (sl & 1) * half;
  } else {
    return sp * PK + 32 * sl;
  }
}

// Exact f32 of a 4-bit code (0..15) and of an int8 code held as a byte.
__device__ __forceinline__ float u4f(uint32_t c) {
  return __int_as_float(0x4B000000 | c) - 8388608.f;
}
__device__ __forceinline__ float s8f(uint32_t byte) {
  return __int_as_float(0x4B000000 | (byte ^ 0x80u)) - 8388736.f;
}

// K4's decode of one weight: q * s, then + b (b = -0 without a bias plane).
__device__ __forceinline__ float affine(float q, float s, float b) {
  return __fadd_rn(__fmul_rn(q, s), b);
}

// K13's decode of a pair of one column: ((q + off) * s) + b', bf16 pairs.
__device__ __forceinline__ uint32_t affine16(float q0, float q1, uint32_t s2, uint32_t o2,
                                             uint32_t b2) {
  return bf16x2_add(bf16x2_mul(bf16x2_add(pack_bf16x2(q0, q1), o2), s2), b2);
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
template <int BITS, int BM, bool FAST16>
__global__ void __launch_bounds__(THREADS, 1)
qmm_affine_kernel(const __grid_constant__ Table tab, int tiles, int K, int N, int split,
                  int group, int has_bias) {
  using R = Ring<BITS, BM, FAST16>;
  constexpr int STAGES = R::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint16_t* p16 = reinterpret_cast<uint16_t*>(stages + STAGES * R::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * R::STAGE_BYTES +
                                               (FAST16 ? P16_BYTES : 0));
  uint64_t* empty = full + STAGES;

  const int n_tiles = N / BN;
  const int crows = BITS == 4 ? K / 2 : K;
  const int nstages = (crows + PK - 1) / PK;  // per tile
  const bool two = group % 32 != 0;            // a plane row per 16 k, not per 32

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: its first warp keeps the ring full. Lane 0 waits
    // for a free stage and arms its barrier; then each lane issues one of
    // the stage's copies (the code box, the x slices, the plane rows), so
    // that up to 1 + 4 + 16 copies leave at once.
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int rows = two ? 2 : 1;
      const int planes = has_bias ? 2 : 1;
      int s = 0;  // stages issued so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileAt T = tile_at<BM>(tab, t, n_tiles);
        const Group& G = tab.g[T.gi];
        for (int sp = 0; sp < nstages; ++sp, ++s) {
          const int buf = s % STAGES;
          uint8_t* st = stages + buf * R::STAGE_BYTES;
          // a last 4-bit stage of 32 packed rows (K/2 % 64 == 32) has two slices
          const int nsl = BITS == 4 && crows - sp * PK <= 32 ? 2 : R::NX;
          if (lane == 0) {
            if (s >= STAGES) mbar_wait(&empty[buf], ((s / STAGES) + 1) & 1);
            mbar_expect_tx(&full[buf], P_BOX + nsl * (R::X_BOX + rows * planes * S_ROW));
          }
          __syncwarp();
          if (lane == 0) {
            tma_load_2d(st + R::P_OFF, &G.pmap, T.n0, sp * PK, &full[buf]);
          } else if (lane <= nsl) {
            const int sl = lane - 1;
            tma_load_2d(st + sl * R::X_BOX, &G.xmap, slice_k<BITS>(sp, sl, split), T.m0,
                        &full[buf]);
          } else if (lane <= nsl + nsl * rows * planes) {
            // plane row h of slice sl, scale (pl 0) or bias (pl 1)
            const int i = lane - 1 - nsl;
            const int pl = i / (nsl * rows), sl = (i % (nsl * rows)) / rows, h = i % rows;
            const int k = slice_k<BITS>(sp, sl, split) + 16 * h;
            const size_t row = (size_t)(k / group) * N + T.n0;
            bulk_load(st + R::PL_OFF + (pl * SLOTS + 2 * sl + h) * S_ROW,
                      (pl ? G.bias : G.scale) + row, S_ROW, &full[buf]);
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
  // and nb + 1: one 16-bit load per code row gives both. Its code rows
  // 2t + {0, 1, 8, 9} of a 16-row block: k 2t, 2t + 1 (a0, a1) and 2t + 8,
  // 2t + 9 (a2, a3); the swizzle puts the four t on four 16-byte chunks.
  const int nb = HALF_N * cw + 16 * w + 2 * g;
  uint32_t p_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 2 * t4 + (j & 1) + 8 * (j >> 1);
    p_off[j] = r * BN + (((nb >> 4) ^ (r & 7)) << 4) + (nb & 15);
  }
  // plane slot of the k16 block at 16 * hh into x slice sl
  auto slot = [&](int sl, int hh) { return 2 * sl + (two ? hh : 0); };

  int s = 0;  // stages consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt T = tile_at<BM>(tab, t, n_tiles);
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
      const int nsl = BITS == 4 && crows - sp * PK <= 32 ? 2 : R::NX;
      uint16_t* cv = p16 + (2 * cw + (s & 1)) * P16_ELEMS;  // FAST16: [3][SLOTS][64]
      if constexpr (FAST16) {
        // this warpgroup's columns of the stage's plane rows in bf16: s, off
        // and b' (off = b' = -0 without a bias plane); the buffer's last
        // readers passed the barrier of the stage before
        for (int i = ct & 127; i < SLOTS * HALF_N; i += 128) {
          const int sl = i / HALF_N, c = i % HALF_N;
          if ((sl >> 1) < nsl && (two || (sl & 1) == 0)) {
            const float sv = *reinterpret_cast<const float*>(st + R::PL_OFF + sl * S_ROW +
                                                             (HALF_N * cw + c) * 4);
            uint16_t ob = BF16_NEG_ZERO, bb = BF16_NEG_ZERO;
            if (has_bias) {
              const float bv = *reinterpret_cast<const float*>(
                  st + R::PL_OFF + (SLOTS + sl) * S_ROW + (HALF_N * cw + c) * 4);
              const bool z = sv == 0.f;
              ob = bf16_bits(z ? 0.f : __fdiv_rn(bv, sv));
              bb = bf16_bits(z ? bv : 0.f);
            }
            cv[sl * HALF_N + c] = bf16_bits(sv);
            cv[(SLOTS + sl) * HALF_N + c] = ob;
            cv[(2 * SLOTS + sl) * HALF_N + c] = bb;
          }
        }
        named_barrier(1 + cw, 128);
      }
      const int blocks = BITS == 4 ? nsl : 4;  // 16-row code blocks in the stage
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < blocks) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = *reinterpret_cast<const uint16_t*>(st + R::P_OFF + 16 * i * BN + p_off[j]);
          const int hh = i & 1;
          // BITS 4: low nibbles in slice 2(i/2), high in 2(i/2) + 1; int8:
          // slice i/2. 16 k (32 bytes) into the slice for odd i.
          constexpr int PARTS = BITS == 4 ? 2 : 1;
#pragma unroll
          for (int part = 0; part < PARTS; ++part) {
            const int sl = BITS == 4 ? 2 * (i >> 1) + part : i >> 1;
            const int q = slot(sl, hh);
            // codes of column nb (byte 0) and nb + 1 (byte 1) of rows
            // 2t, 2t + 1, 2t + 8, 2t + 9
            float c[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const uint32_t byte = (v[j] >> (8 * e)) & 0xFFu;
                c[j][e] = BITS == 4 ? u4f(part ? byte >> 4 : byte & 15u) : s8f(byte);
              }
            uint32_t a[4];
            if constexpr (FAST16) {
              // bf16 (s, off, b') of columns nb, nb + 1, each duplicated into a pair
              auto pair = [&](int plane) {
                return *reinterpret_cast<const uint32_t*>(cv + (plane * SLOTS + q) * HALF_N +
                                                          nb - HALF_N * cw);
              };
              const uint32_t sp2 = pair(0), op2 = pair(1), bp2 = pair(2);
              const uint32_t s_lo = __byte_perm(sp2, 0, 0x1010), s_hi = __byte_perm(sp2, 0, 0x3232);
              const uint32_t o_lo = __byte_perm(op2, 0, 0x1010), o_hi = __byte_perm(op2, 0, 0x3232);
              const uint32_t b_lo = __byte_perm(bp2, 0, 0x1010), b_hi = __byte_perm(bp2, 0, 0x3232);
              a[0] = affine16(c[0][0], c[1][0], s_lo, o_lo, b_lo);
              a[1] = affine16(c[0][1], c[1][1], s_hi, o_hi, b_hi);
              a[2] = affine16(c[2][0], c[3][0], s_lo, o_lo, b_lo);
              a[3] = affine16(c[2][1], c[3][1], s_hi, o_hi, b_hi);
            } else {
              // f32 (s, b) of columns nb, nb + 1 (b = -0 without a bias plane)
              const float2 sv =
                  *reinterpret_cast<const float2*>(st + R::PL_OFF + q * S_ROW + nb * 4);
              const float2 bv =
                  has_bias ? *reinterpret_cast<const float2*>(st + R::PL_OFF +
                                                               (SLOTS + q) * S_ROW + nb * 4)
                           : make_float2(-0.f, -0.f);
              a[0] = pack_bf16x2(affine(c[0][0], sv.x, bv.x), affine(c[1][0], sv.x, bv.x));
              a[1] = pack_bf16x2(affine(c[0][1], sv.y, bv.y), affine(c[1][1], sv.y, bv.y));
              a[2] = pack_bf16x2(affine(c[2][0], sv.x, bv.x), affine(c[3][0], sv.x, bv.x));
              a[3] = pack_bf16x2(affine(c[2][1], sv.y, bv.y), affine(c[3][1], sv.y, bv.y));
            }
            wgmma_fence();
            WgmmaBf16<BM, 0>::run(acc, a, wgmma_desc(st + sl * R::X_BOX + 32 * hh, 512, 2), 1);
          }
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
  const void* bias;
  void* out;
  int m;
};

// The kernel over m_tiles x N/128 output tiles, one block per SM at most.
template <int BITS, int BM, bool FAST16>
cudaError_t launch(const Table& tab, int m_tiles, int K, int N, int split, int group,
                   int has_bias, cudaStream_t stream) {
  static size_t raised[MAX_DEVICES] = {};
  static int sm_counts[MAX_DEVICES] = {};
  const size_t smem = Ring<BITS, BM, FAST16>::SMEM_BYTES;
  int sms = 0;
  int err = raise_smem_limit(reinterpret_cast<const void*>(qmm_affine_kernel<BITS, BM, FAST16>),
                             smem, raised);
  if (err == 0) err = device_sm_count(&sms, sm_counts);
  if (err != 0) return static_cast<cudaError_t>(err);
  const int tiles = m_tiles * (N / BN);
  qmm_affine_kernel<BITS, BM, FAST16><<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(
      tab, tiles, K, N, split, group, has_bias);
  return cudaGetLastError();
}

// The instantiation for a tile height of bm rows.
template <int BITS, bool FAST16>
cudaError_t launch_bm(int bm, const Table& tab, int m_tiles, int K, int N, int split,
                      int group, int has_bias, cudaStream_t st) {
#define QMM_AFFINE_BM(B) \
  case B:                \
    return launch<BITS, B, FAST16>(tab, m_tiles, K, N, split, group, has_bias, st);
  switch (bm) {
    QMM_AFFINE_BM(8)
    QMM_AFFINE_BM(16)
    QMM_AFFINE_BM(24)
    QMM_AFFINE_BM(32)
    QMM_AFFINE_BM(40)
    QMM_AFFINE_BM(48)
    QMM_AFFINE_BM(56)
    QMM_AFFINE_BM(64)
    QMM_AFFINE_BM(128)
    QMM_AFFINE_BM(192)
    QMM_AFFINE_BM(256)
  }
#undef QMM_AFFINE_BM
  return cudaErrorInvalidValue;
}

bool valid_bm(int bm) {
  return (bm >= 8 && bm <= 64 && bm % 8 == 0) || bm == 128 || bm == 192 || bm == 256;
}

// Encodes the groups' maps and launches the kernel with tiles of bm rows.
// Returns a cudaError_t.
template <bool FAST16>
int run(const Args* args, int count, int K, int N, int bits, int split, int group,
        bool has_bias, int bm, bool out_f32, cudaStream_t stream) {
  if ((bits != 4 && bits != 8) || K % 64 != 0 || N % BN != 0 || group % 16 != 0 ||
      K % group != 0 || (bits == 4 && (split % 64 != 0 || K % split != 0)) || !valid_bm(bm))
    return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  tab.count = count;
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    const Args& a = args[i];
    Group& g = tab.g[i];
    g.scale = static_cast<const float*>(a.scale);
    g.bias = has_bias ? static_cast<const float*>(a.bias) : nullptr;
    g.out = a.out;
    g.out_f32 = out_f32 ? 1 : 0;
    g.m = a.m;
    g.tile0 = tiles;
    if (has_bias && a.bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (a.m > 0) {
      int err = encode_tensor_map_2d(&g.xmap, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.m, K,
                                     bm, 32, CU_TENSOR_MAP_SWIZZLE_64B);
      if (err == 0)
        err = encode_tensor_map_2d(&g.pmap, a.packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                   bits == 4 ? K / 2 : K, N, PK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != 0) return err;
    }
    tiles += (a.m + bm - 1) / bm;
  }
  if (tiles == 0) return 0;
  const int hb = has_bias ? 1 : 0;
  const cudaError_t err =
      bits == 4 ? launch_bm<4, FAST16>(bm, tab, tiles, K, N, split, group, hb, stream)
                : launch_bm<8, FAST16>(bm, tab, tiles, K, N, split, group, hb, stream);
  return static_cast<int>(err);
}

}  // namespace

// K4. x bf16 [M, K]; packed u8 [K/2, N] (bits 4, split-block nibbles) or
// int8 [K, N] (bits 8); scale f32 [K/group, N]; bias f32 [K/group, N] or
// null; out bf16 [M, N]; tiles of block_m rows (ops/qmatmul.py qmm_plan
// "affine": 8..64 in steps of 8, 128, 192 or 256). Needs K % 64 == 0,
// N % 128 == 0, group % 16 == 0, K % group == 0, for bits 4 split % 64 == 0
// and K % split == 0, and 16-byte aligned x, packed, scale and bias.
// Returns cudaGetLastError(), the tensor-map encoder's refusal, or
// cudaErrorInvalidValue for arguments outside these.
extern "C" int qmm_affine(const void* x, const void* packed, const void* scale,
                          const void* bias, void* out, int M, int K, int N, int bits,
                          int split, int group, int block_m, void* stream) {
  const Args a{x, packed, scale, bias, out, M};
  return run<false>(&a, 1, K, N, bits, split, group, bias != nullptr, block_m, false,
                    static_cast<cudaStream_t>(stream));
}

// K13: K4 with the fast16 decode; the same arguments.
extern "C" int qmm_affine_fast16(const void* x, const void* packed, const void* scale,
                                 const void* bias, void* out, int M, int K, int N, int bits,
                                 int split, int group, int block_m, void* stream) {
  const Args a{x, packed, scale, bias, out, M};
  return run<true>(&a, 1, K, N, bits, split, group, bias != nullptr, block_m, false,
                   static_cast<cudaStream_t>(stream));
}

// K4 and K13 storing f32 (out f32 [M, N], 8-byte aligned; a row-parallel
// linear's partial); the same arguments.
extern "C" int qmm_affine_f32(const void* x, const void* packed, const void* scale,
                              const void* bias, void* out, int M, int K, int N, int bits,
                              int split, int group, int block_m, void* stream) {
  const Args a{x, packed, scale, bias, out, M};
  return run<false>(&a, 1, K, N, bits, split, group, bias != nullptr, block_m, true,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int qmm_affine_fast16_f32(const void* x, const void* packed, const void* scale,
                                     const void* bias, void* out, int M, int K, int N,
                                     int bits, int split, int group, int block_m,
                                     void* stream) {
  const Args a{x, packed, scale, bias, out, M};
  return run<true>(&a, 1, K, N, bits, split, group, bias != nullptr, block_m, true,
                   static_cast<cudaStream_t>(stream));
}

// K8, affine branch. table: G rows of 6 int64 {x, packed, scale, bias, out,
// m}, each group as K4's arguments, all of one K, N, bits, split and group,
// with a bias plane in every group (has_bias 1) or in none (0; bias 0).
// 1 <= G <= 8. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// bad G or argument.
extern "C" int qmm_grouped_affine(const long long* table, int G, int K, int N, int bits,
                                  int split, int group, int has_bias, int block_m,
                                  void* stream) {
  if (G < 1 || G > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  Args args[MAX_GROUPS];
  for (int i = 0; i < G; ++i) {
    const long long* r = table + 6 * i;
    args[i] = {reinterpret_cast<const void*>(r[0]), reinterpret_cast<const void*>(r[1]),
               reinterpret_cast<const void*>(r[2]), reinterpret_cast<const void*>(r[3]),
               reinterpret_cast<void*>(r[4]), static_cast<int>(r[5])};
  }
  return run<false>(args, G, K, N, bits, split, group, has_bias != 0, block_m, false,
                    static_cast<cudaStream_t>(stream));
}
