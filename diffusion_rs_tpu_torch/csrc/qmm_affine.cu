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
// [K, N] format in one launch. The kernel takes a group table by value
// {x, packed, scale, bias, out, m, tile0}; the grid runs over the sum of the
// groups' m-tiles, a block finds its group from the tile prefix sums, and
// each group's m-tiles start at its own row 0, so a group's output is K4's
// output for that group bit for bit. K4 is the table of one group. Nothing
// is stacked or copied per call.
// K13 qmm_affine_fast16: replaces the affine branches with fast16=True, the
// opt-in 16-bit decode of _dequant_tile (:80-120): the code in bf16 (exact),
// then, with a bias plane, the centred form w = ((q + off) * s) + b' with
// off = b / s and b' = 0 where s != 0, off = 0 and b' = b where s == 0
// (K-quant groups whose f16 d underflowed), each op rounded to bf16;
// without one, w = q * s in bf16. It is K4's kernel with FAST16 = true:
// the scale and bias rows of the stage's four 16-row chunks (every group
// spans whole chunks: group % 16 == 0) ride in the stage's cp.async group,
// and before the stage's decode the threads that copied them turn them into
// bf16 s, off and b' in shared memory, off by __fdiv_rn in f32, inside the
// kernel (no extra launch); the decode then runs on fma.rn.bf16x2 pairs. The
// decoded weight equals the plain version's (ops/qmatmul.dequantize_fast16)
// bit for bit; only the f32 summation order of the product differs.
// FAST16 = false is K4's code as it was.
//
// Math, bit for bit the plain version's decoded weight: w = q * s in f32
// (__fmul_rn), then w + b (__fadd_rn; the two stay separate roundings, as in
// _dequant_tile's `w * scale; w + bias`, and nvcc may not contract them into
// an FMA), rounded to bf16 (RNE); bf16 x bf16 products with f32 accumulation
// and one cast to bf16 at the end. Only the f32 summation order differs from
// the plain version.
//
// Bound on the H100: operations at M >= 512 (2*M*K*N bf16 tensor-core work
// against ~K*N/2 or K*N weight bytes), bytes at M = 1 (the codes plus the
// f32 scale and bias planes: for Q4_0 at K3072 N18432, 28.3 MB of codes and
// 2 x 7.1 MB of planes). Design, kept simple (a later PR brings wgmma/TMA
// and a small-M path): 128x128 output tiles, eight warps of 64x32, a K-stage
// of 64 k-rows. cp.async double-buffers the packed bytes (32 rows of byte
// pairs for 4-bit, 64 int8 rows) and the matching 64 columns of x; the block
// decodes the stage once into a bf16 shared tile, reading each k-row's scale
// and bias row k / group straight from the planes (so groups of 16 or 32
// inside a stage and group = K all work), and the warps run mma.sync
// m16n8k16 on it through ldmatrix (.trans for the K-major weight). Ragged M
// is zero-filled on load and masked on store.
#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int KS = 64;              // k-rows per stage
constexpr int THREADS = 256;
constexpr int A_STRIDE = KS + 8;    // bf16: 144-byte rows, conflict-free ldmatrix
constexpr int W_STRIDE = BN + 8;    // bf16: 272-byte rows, conflict-free ldmatrix
constexpr int A_ELEMS = BM * A_STRIDE;
constexpr int W_ELEMS = KS * W_STRIDE;

constexpr int CHUNKS = KS / 16;  // 16-row plane chunks per stage (K13)

constexpr int PLANE_ELEMS = 2 * CHUNKS * BN;  // K13: f32 scale and bias rows of a stage
constexpr int PLANE_THREADS = CHUNKS * BN / 4;  // K13: threads that copy and convert them

template <int BITS, bool FAST16>
struct Layout {
  static constexpr int P_ROWS = BITS == 4 ? KS / 2 : KS;  // packed rows per stage
  static constexpr int P_BYTES = P_ROWS * BN;
  // K13: the stage's f32 plane rows, double-buffered, and their bf16 s, off
  // and b' of each chunk and column
  static constexpr size_t PLANE16_BYTES =
      FAST16 ? 2 * PLANE_ELEMS * sizeof(float) + 3 * CHUNKS * BN * sizeof(uint16_t) : 0;
  static constexpr size_t SMEM_BYTES = 2 * A_ELEMS * sizeof(__nv_bfloat16) + 2 * P_BYTES +
                                       W_ELEMS * sizeof(__nv_bfloat16) + PLANE16_BYTES;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Decode four weights of one k-row: codes q[0..3], the row's scale and bias.
template <bool HAS_BIAS>
__device__ __forceinline__ uint2 decode4(const float* q, const float4 s, const float4 b) {
  float w[4] = {__fmul_rn(q[0], s.x), __fmul_rn(q[1], s.y), __fmul_rn(q[2], s.z),
                __fmul_rn(q[3], s.w)};
  if (HAS_BIAS) {
    w[0] = __fadd_rn(w[0], b.x);
    w[1] = __fadd_rn(w[1], b.y);
    w[2] = __fadd_rn(w[2], b.z);
    w[3] = __fadd_rn(w[3], b.w);
  }
  return make_uint2(pack_bf16x2(w[0], w[1]), pack_bf16x2(w[2], w[3]));
}

// K13: four weights of one k-row, codes as bf16 pairs (q01, q23), against
// chunk j of the stage's bf16 planes [3][CHUNKS][BN] (s, off, b').
template <bool HAS_BIAS>
__device__ __forceinline__ uint2 decode4_fast16(uint32_t q01, uint32_t q23,
                                                const uint16_t* planes, int j, int c4) {
  const uint2 s = *reinterpret_cast<const uint2*>(planes + j * BN + c4);
  if (!HAS_BIAS) return make_uint2(bf16x2_mul(q01, s.x), bf16x2_mul(q23, s.y));
  const uint2 o = *reinterpret_cast<const uint2*>(planes + (CHUNKS + j) * BN + c4);
  const uint2 b = *reinterpret_cast<const uint2*>(planes + (2 * CHUNKS + j) * BN + c4);
  return make_uint2(bf16x2_add(bf16x2_mul(bf16x2_add(q01, o.x), s.x), b.x),
                    bf16x2_add(bf16x2_mul(bf16x2_add(q23, o.y), s.y), b.y));
}

constexpr int MAX_GROUPS = 8;

// One product of a call: x [m, K], the planes of its [K, N] weight, output
// [m, N]; tile0 is where its m-tiles start in the call's grid.
struct Group {
  const __nv_bfloat16* x;
  const uint8_t* packed;
  const float* scale;
  const float* bias;
  __nv_bfloat16* out;
  int m, tile0;
};

struct Table {
  Group g[MAX_GROUPS];
  int count;
};

template <int BITS, bool HAS_BIAS, bool FAST16>
__global__ void __launch_bounds__(THREADS)
qmm_affine_kernel(const Table tab, int K, int N, int split, int group) {
  using L = Layout<BITS, FAST16>;
  // This block's group: the last one whose m-tiles start at or before it.
  const int tile = blockIdx.y;
  Group G = tab.g[0];
#pragma unroll
  for (int i = 1; i < MAX_GROUPS; ++i)
    if (i < tab.count && tile >= tab.g[i].tile0) G = tab.g[i];
  const __nv_bfloat16* __restrict__ x = G.x;
  const uint8_t* __restrict__ packed = G.packed;
  const float* __restrict__ scale = G.scale;
  const float* __restrict__ bias = G.bias;
  __nv_bfloat16* __restrict__ out = G.out;
  const int M = G.m;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);               // [2][BM][A_STRIDE]
  uint8_t* Ps = smem + 2 * A_ELEMS * sizeof(__nv_bfloat16);                   // [2][P_ROWS][BN]
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(Ps + 2 * L::P_BYTES);  // [KS][W_STRIDE]
  float* Pf = reinterpret_cast<float*>(Ws + W_ELEMS);             // K13: [2][2][CHUNKS][BN]
  uint16_t* P16 = reinterpret_cast<uint16_t*>(Pf + 2 * PLANE_ELEMS);  // K13: [3][CHUNKS][BN]
  // K13: the chunk and four columns this thread copies and converts
  const int pj = threadIdx.x / (BN / 4);
  const int pc4 = (threadIdx.x % (BN / 4)) * 4;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (tile - G.tile0) * BM;
  const int n0 = blockIdx.x * BN;
  // 4-bit: a stage is 32 packed rows = k-rows k_lo..k_lo+31 (low nibbles)
  // and k_lo+half..k_lo+half+31 (high nibbles) of one split-block run.
  const int half = split / 2;
  const int stages_per_run = BITS == 4 ? half / (KS / 2) : 1;
  const int nstages = K / KS;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // First k-row of stage s (the low-nibble rows for 4-bit).
  auto k_lo_of = [&](int s) {
    return BITS == 4 ? (s / stages_per_run) * split + (s % stages_per_run) * (KS / 2)
                     : s * KS;
  };
  // k of column c (0..63) of the stage's x tile and row c of its weight tile.
  auto k_of = [&](int k_lo, int c) {
    return BITS == 4 ? (c < KS / 2 ? k_lo + c : k_lo + half + c - KS / 2) : k_lo + c;
  };

  auto load_stage = [&](int s, int buf) {
    const int k_lo = k_lo_of(s);
    __nv_bfloat16* a = As + buf * A_ELEMS;
    // x: BM rows x 64 bf16 = 8 chunks of 16 bytes per row
#pragma unroll
    for (int c = tid; c < BM * 8; c += THREADS) {
      const int r = c >> 3;
      const int ch = c & 7;
      const int gr = m0 + r;
      cp_async16(a + r * A_STRIDE + ch * 8,
                 x + (size_t)(gr < M ? gr : 0) * K + k_of(k_lo, ch * 8), gr < M ? 16 : 0);
    }
    const int prow = BITS == 4 ? (s / stages_per_run) * half + (s % stages_per_run) * (KS / 2)
                               : k_lo;
    uint8_t* p = Ps + buf * L::P_BYTES;
#pragma unroll
    for (int c = tid; c < L::P_ROWS * BN / 16; c += THREADS) {
      const int r = c >> 3;
      const int ch = c & 7;
      cp_async16(p + r * BN + ch * 16, packed + (size_t)(prow + r) * N + n0 + ch * 16, 16);
    }
    if constexpr (FAST16) {
      if (tid < PLANE_THREADS) {
        const size_t o = (size_t)(k_of(k_lo, 16 * pj) / group) * N + n0 + pc4;
        float* pf = Pf + buf * PLANE_ELEMS;
        cp_async16(pf + pj * BN + pc4, scale + o, 16);
        if (HAS_BIAS) cp_async16(pf + (CHUNKS + pj) * BN + pc4, bias + o, 16);
      }
    }
    cp_async_commit();
  };

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  load_stage(0, 0);
  for (int s = 0; s < nstages; ++s) {
    const int buf = s & 1;
    if (s + 1 < nstages) {
      load_stage(s + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (FAST16) {
      // the plane rows this thread copied for the stage (its own cp.async
      // group is complete) in bf16; the previous stage's decode is done, the
      // loop's last barrier came after it
      if (tid < PLANE_THREADS) {
        const float* pf = Pf + buf * PLANE_ELEMS;
        const float4 sv = *reinterpret_cast<const float4*>(pf + pj * BN + pc4);
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
        uint16_t sb[4], ob[4], bb[4];
        float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (HAS_BIAS) bv = *reinterpret_cast<const float4*>(pf + (CHUNKS + pj) * BN + pc4);
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool z = sa[e] == 0.f;
          sb[e] = bf16_bits(sa[e]);
          ob[e] = bf16_bits(z ? 0.f : __fdiv_rn(ba[e], sa[e]));
          bb[e] = bf16_bits(z ? ba[e] : 0.f);
        }
        auto pack = [](const uint16_t* v) {
          return make_uint2(v[0] | (static_cast<uint32_t>(v[1]) << 16),
                            v[2] | (static_cast<uint32_t>(v[3]) << 16));
        };
        *reinterpret_cast<uint2*>(P16 + pj * BN + pc4) = pack(sb);
        if (HAS_BIAS) {
          *reinterpret_cast<uint2*>(P16 + (CHUNKS + pj) * BN + pc4) = pack(ob);
          *reinterpret_cast<uint2*>(P16 + (2 * CHUNKS + pj) * BN + pc4) = pack(bb);
        }
      }
    }
    __syncthreads();

    // Decode the stage into Ws [64 k-rows][128 columns] (f32 math, then bf16;
    // K13: bf16 math).
    {
      const int k_lo = k_lo_of(s);
      const uint8_t* p = Ps + buf * L::P_BYTES;
#pragma unroll
      for (int q4 = 0; q4 < (L::P_ROWS * BN / 4) / THREADS; ++q4) {
        const int wi = tid + q4 * THREADS;
        const int r = wi / (BN / 4);
        const int c4 = (wi % (BN / 4)) * 4;
        const uint32_t word = *reinterpret_cast<const uint32_t*>(p + r * BN + c4);
        if constexpr (FAST16) {
          // codes -> exact bf16 pairs; chunk of row r (and of its high-nibble
          // partner KS / 2 + r)
          if (BITS == 4) {
            const float l0 = word & 0xFu, h0 = (word >> 4) & 0xFu;
            const float l1 = (word >> 8) & 0xFu, h1 = (word >> 12) & 0xFu;
            const float l2 = (word >> 16) & 0xFu, h2 = (word >> 20) & 0xFu;
            const float l3 = (word >> 24) & 0xFu, h3 = word >> 28;
            *reinterpret_cast<uint2*>(Ws + r * W_STRIDE + c4) = decode4_fast16<HAS_BIAS>(
                pack_bf16x2(l0, l1), pack_bf16x2(l2, l3), P16, r / 16, c4);
            *reinterpret_cast<uint2*>(Ws + (KS / 2 + r) * W_STRIDE + c4) =
                decode4_fast16<HAS_BIAS>(pack_bf16x2(h0, h1), pack_bf16x2(h2, h3), P16,
                                         CHUNKS / 2 + r / 16, c4);
          } else {
            float q[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              q[b] = static_cast<float>(static_cast<int8_t>((word >> (8 * b)) & 0xFFu));
            }
            *reinterpret_cast<uint2*>(Ws + r * W_STRIDE + c4) = decode4_fast16<HAS_BIAS>(
                pack_bf16x2(q[0], q[1]), pack_bf16x2(q[2], q[3]), P16, r / 16, c4);
          }
          continue;
        }
        if (BITS == 4) {
          const size_t o_lo = (size_t)((k_lo + r) / group) * N + n0 + c4;
          const size_t o_hi = (size_t)((k_lo + half + r) / group) * N + n0 + c4;
          float lo[4], hi[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t byte = (word >> (8 * b)) & 0xFFu;
            lo[b] = static_cast<float>(byte & 0xFu);
            hi[b] = static_cast<float>(byte >> 4);
          }
          *reinterpret_cast<uint2*>(Ws + r * W_STRIDE + c4) = decode4<HAS_BIAS>(
              lo, ldg4(scale + o_lo), HAS_BIAS ? ldg4(bias + o_lo) : zero4);
          *reinterpret_cast<uint2*>(Ws + (KS / 2 + r) * W_STRIDE + c4) = decode4<HAS_BIAS>(
              hi, ldg4(scale + o_hi), HAS_BIAS ? ldg4(bias + o_hi) : zero4);
        } else {
          const size_t o = (size_t)((k_lo + r) / group) * N + n0 + c4;
          float q[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            q[b] = static_cast<float>(static_cast<int8_t>((word >> (8 * b)) & 0xFFu));
          }
          *reinterpret_cast<uint2*>(Ws + r * W_STRIDE + c4) = decode4<HAS_BIAS>(
              q, ldg4(scale + o), HAS_BIAS ? ldg4(bias + o) : zero4);
        }
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

template <int BITS, bool HAS_BIAS, bool FAST16>
int launch(const Table& tab, int tiles, int K, int N, int split, int group,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<BITS, FAST16>::SMEM_BYTES;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(qmm_affine_kernel<BITS, HAS_BIAS, FAST16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid(N / BN, tiles);
  qmm_affine_kernel<BITS, HAS_BIAS, FAST16><<<grid, THREADS, smem, stream>>>(tab, K, N, split,
                                                                             group);
  return static_cast<int>(cudaGetLastError());
}

// Fills the tile offsets and launches the instantiation for (bits, bias).
template <bool FAST16>
int run(Table& tab, int K, int N, int bits, int split, int group, bool has_bias,
        cudaStream_t st) {
  int tiles = 0;
  for (int i = 0; i < tab.count; ++i) {
    tab.g[i].tile0 = tiles;
    tiles += (tab.g[i].m + BM - 1) / BM;
  }
  if (tiles == 0) return 0;
  if (bits == 4) {
    return has_bias ? launch<4, true, FAST16>(tab, tiles, K, N, split, group, st)
                    : launch<4, false, FAST16>(tab, tiles, K, N, split, group, st);
  }
  if (bits == 8) {
    return has_bias ? launch<8, true, FAST16>(tab, tiles, K, N, split, group, st)
                    : launch<8, false, FAST16>(tab, tiles, K, N, split, group, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K4. x bf16 [M, K]; packed u8 [K/2, N] (bits 4, split-block nibbles) or
// int8 [K, N] (bits 8); scale f32 [K/group, N]; bias f32 [K/group, N] or
// null; out bf16 [M, N]. Needs K % 64 == 0, N % 128 == 0, K % group == 0
// and, for bits 4, split % 64 == 0 and K % split == 0. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a bits value other than
// 4 or 8.
extern "C" int qmm_affine(const void* x, const void* packed, const void* scale,
                          const void* bias, void* out, int M, int K, int N, int bits,
                          int split, int group, void* stream) {
  Table tab{};
  tab.count = 1;
  tab.g[0] = {static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
              static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<__nv_bfloat16*>(out), M, 0};
  return run<false>(tab, K, N, bits, split, group, bias != nullptr,
                    static_cast<cudaStream_t>(stream));
}

// K13: K4 with the fast16 decode; the same arguments, and group % 16 == 0.
// Returns cudaErrorInvalidValue for another group.
extern "C" int qmm_affine_fast16(const void* x, const void* packed, const void* scale,
                                 const void* bias, void* out, int M, int K, int N, int bits,
                                 int split, int group, void* stream) {
  if (group % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  tab.count = 1;
  tab.g[0] = {static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
              static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<__nv_bfloat16*>(out), M, 0};
  return run<true>(tab, K, N, bits, split, group, bias != nullptr,
                   static_cast<cudaStream_t>(stream));
}

// K8, affine branch. table: G rows of 6 int64 {x, packed, scale, bias, out,
// m}, each group as K4's arguments, all of one K, N, bits, split and group,
// with a bias plane in every group (has_bias 1) or in none (0; bias 0).
// 1 <= G <= 8. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// bad G or bits value.
extern "C" int qmm_grouped_affine(const long long* table, int G, int K, int N, int bits,
                                  int split, int group, int has_bias, void* stream) {
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
  return run<false>(tab, K, N, bits, split, group, has_bias != 0,
                    static_cast<cudaStream_t>(stream));
}
