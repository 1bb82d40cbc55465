// Dequantize-matmul and fused quantized SwiGLU for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces three TPU kernels of mlx_audio_tpu/ops/pallas/quant_matmul.py:
// - `_qmm_kernel` (body `_qmm_body`, entry `quantized_matmul`, 4/8-bit) and
//   `_qmm6_kernel` (entry `_quantized_matmul6`, MLX's 6-bit stream):
//   y = x . dequant(W)^T over MLX-affine weights, w[n, k] = q[n, k] *
//   s[n, k / g] + b[n, k / g], x (M, K) f32 or bf16, y (M, N) in x's dtype,
//   accumulated in float32;
// - `_qmlp_kernel` (entry `quantized_mlp`, 4/8-bit): the SwiGLU MLP
//   y = (silu(x Wg^T) * (x Wu^T)) Wd^T in one launch, over the row-stacked
//   gate;up weight (gate rows first) and the down weight.
//
// Packing. 4/8-bit rows are uint32 words of 32/bits values, value j of word
// p at bits [bits*j, bits*(j+1)) (element k = p*per + j). 6-bit rows are
// MLX's byte stream: value k in bytes 3*(k/4) .. +2 at bit 6*(k%4); read as
// little-endian words, 16 values fill 3 words and value j of such a chunk
// sits at stream bit 6*j (j = 5 and j = 10 straddle two words).
//
// What bounds them on this card: on the decode path (M = 1 or 2) the work
// is ~2 FLOP per weight, so the packed weight read sets the time: the
// talker's fused q/k/v int4 (N 4096, K 1024) is 2.1 MB of words plus 0.5 MB
// of scales and biases, 0.8 us at 3.35 TB/s (at 6 bits 3.1 MB and 0.5 MB,
// 1.1 us); one talker MLP reads ~5.9 MB, 1.8 us. A launch costs more than
// that, so at these shapes launch latency and the loop around them set the
// time, not this kernel's inner loop.
//
// What the design does about it:
// - qmm at M <= 4, 4, 6 and 8 bits (the decode path: 55,000 of a 256-frame
//   Qwen3-TTS int4 synthesis's 55,705 launches, 13,800 of a 32-frame 6-bit
//   one's 14,011) is a GEMV, `qmm_gemv`, built for latency: each lane reads
//   units of 16 values (int4 and 6-bit; 8 at int8), one scale and bias a
//   unit, of four rows, all sent before any arithmetic and the next step's
//   before this one's FMAs; x is read from L1, not staged, so no barrier
//   precedes the weight loads; the warps of a block split K so that a lane
//   holds one unit a row (two warps at the q/k/v's K 1024, four at
//   o_proj's 2048) and add their partial sums in shared memory in a fixed
//   order. Its dequantization and dot product are qmlp's (`unit_dot`), and
//   at 6 bits `unit_dot6`, which keeps it exact where values straddle words.
// - qmm at M > 4 (the talker's 32-row prefill, the 336-row text
//   projection, the codec decoder), 4, 6 and 8 bits, is a GEMM on the
//   tensor cores, `qmm_mma`. At the prefill's fused q/k/v (N 4096, K 1024)
//   the 6-bit weights and scales bound it (3.6 MB, 1.1 us), at the text
//   projection its operations (2.8 GFLOP, 2.8 us at the bf16 peak); in
//   practice the latency of each block's chain of stages sets the time
//   (see the section's note). mma.sync m16n8k16 takes the integer codes as
//   its B operand (exact in bf16) and each group's sum is scaled once; a
//   block owns 32 or 64 rows of x and 64 or 128 weight rows, and a
//   cp.async ring brings the next stage in under the products.
// - qmm otherwise (rows or pointers that allow neither: x at an address
//   the 16-byte copies cannot take, groups not a multiple of 16, packed
//   rows not a multiple of 16 bytes), `qmm_kernel`: one warp owns one weight
//   row; a block of 8 warps owns 8 rows and a tile of up to BM = 8 rows of
//   x, staged as float32 in shared memory 1024 columns at a time. Each
//   weight chunk is unpacked once into
//   registers (w = q*s + b, one FMA per value) and serves every x row of
//   the tile. Lanes walk consecutive chunks, so a warp's word loads are
//   coalesced. M is tiled as well as N; the ragged N edge is masked per
//   warp.
// - qmlp is one cooperative launch, bound by latency more than by its
//   bytes: phase A writes h = silu(g)*u (float32, M*I*4 bytes) to a scratch
//   in L2, a grid barrier hands it over (the TPU kernel relies on its
//   sequential grid for that), phase B contracts h with the down weight.
//   Each lane reads 16 bytes of a row at a time (32 int4 or 16 int8
//   values) and a warp keeps four rows in flight, gate and up of two
//   pairs, sent before x is staged; gate and up share one pass over x,
//   staged once per block; phase B's rows are asked of L2 as the kernel
//   starts, split into (row, segment) tasks over every warp of every block,
//   their units loaded while the barrier waits, and the segments' partial
//   sums added in a fixed order in shared memory (the same codes on every
//   run). The barrier resets itself (a generation and two counts), so a
//   call launches one kernel and no memset, and its launch plan is cached.
// CUDA graphs around the decode loop are what the launch-bound shapes need
// next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <mutex>

namespace {

constexpr int WARPS = 8;  // weight rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int KT = 1024;  // columns of x staged per tile

template <int BITS>
struct Chunk;  // V values in WORDS uint32 words
template <>
struct Chunk<4> {
  static constexpr int V = 8, WORDS = 1;
};
template <>
struct Chunk<8> {
  static constexpr int V = 4, WORDS = 1;
};
template <>
struct Chunk<6> {
  static constexpr int V = 16, WORDS = 3;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x element, through L2 only when it was written by another block of this
// launch (the fused MLP's h)
template <typename T, bool CG>
__device__ __forceinline__ float load_x(const T* p) {
  if constexpr (CG) {
    return __ldcg(p);
  } else {
    return to_float(*p);
  }
}

template <int BITS>
__device__ __forceinline__ void unpack(const uint32_t* wp, float* q) {
  if constexpr (BITS == 6) {
    const uint32_t w[3] = {wp[0], wp[1], wp[2]};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int bit = 6 * j, wi = bit >> 5, sh = bit & 31;
      uint32_t v = w[wi] >> sh;
      if (sh > 26) v |= w[wi + 1] << (32 - sh);
      q[j] = static_cast<float>(v & 63u);
    }
  } else {
    const uint32_t w = wp[0];
#pragma unroll
    for (int j = 0; j < Chunk<BITS>::V; ++j)
      q[j] = static_cast<float>((w >> (BITS * j)) & ((1u << BITS) - 1u));
  }
}

struct Rows {
  const uint8_t* w;   // packed rows
  long long row_bytes;
  const float* s;     // (rows, G)
  const float* b;
  int G, group_size;
};

// acc[m] = sum_k x[m0 + m, k] * w[n, k] for the calling warp's row n, summed
// over the warp (every lane gets the sum). Every thread of the block calls
// it, whatever its row: it stages x and holds the block's barriers.
template <int BITS, int BM, typename TX, bool CG>
__device__ void row_dot(const TX* x, long long ldx, int M, int K, int m0,
                        const Rows& r, int n, bool row_ok, float* xs,
                        float (&acc)[BM]) {
  constexpr int V = Chunk<BITS>::V;
  constexpr int WORDS = Chunk<BITS>::WORDS;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;
  const uint32_t* wrow = reinterpret_cast<const uint32_t*>(r.w + n * r.row_bytes);
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    for (int i = threadIdx.x; i < BM * kt; i += THREADS) {
      const int m = i / kt, k = i - m * kt;
      xs[m * KT + k] = (m0 + m < M) ? load_x<TX, CG>(x + (m0 + m) * ldx + k0 + k) : 0.f;
    }
    __syncthreads();
    if (row_ok) {
      for (int c = lane; c < kt / V; c += 32) {
        const int kc = k0 + c * V;  // first element of the chunk
        const int g = kc / r.group_size;
        const float s = r.s[n * r.G + g], b = r.b[n * r.G + g];
        float w[V];
        unpack<BITS>(wrow + (kc / V) * WORDS, w);
#pragma unroll
        for (int j = 0; j < V; ++j) w[j] = fmaf(w[j], s, b);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float4* xv = reinterpret_cast<const float4*>(xs + m * KT + c * V);
          float a = acc[m];
#pragma unroll
          for (int j = 0; j < V / 4; ++j) {
            const float4 t = xv[j];
            a = fmaf(w[4 * j], t.x, a);
            a = fmaf(w[4 * j + 1], t.y, a);
            a = fmaf(w[4 * j + 2], t.z, a);
            a = fmaf(w[4 * j + 3], t.w, a);
          }
          acc[m] = a;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    float a = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    acc[m] = a;
  }
}

struct QmmParams {
  const void* x;
  Rows w;
  void* y;
  int M, N, K;
  long long ldx, ldy;
  int splits;  // qmm_mma: splits of K, the blocks of a cluster
};

template <int BITS, int BM, typename TX>
__global__ void __launch_bounds__(THREADS) qmm_kernel(QmmParams p) {
  extern __shared__ float4 smem_f4[];
  float* xs = reinterpret_cast<float*>(smem_f4);
  const int groups = (p.N + WARPS - 1) / WARPS;
  const int rg = blockIdx.x % groups, mt = blockIdx.x / groups;
  const int n = rg * WARPS + (threadIdx.x >> 5), m0 = mt * BM;
  float acc[BM];
  row_dot<BITS, BM, TX, false>(static_cast<const TX*>(p.x), p.ldx, p.M, p.K, m0,
                               p.w, n, n < p.N, xs, acc);
  if ((threadIdx.x & 31) == 0 && n < p.N) {
    TX* y = static_cast<TX*>(p.y);
#pragma unroll
    for (int m = 0; m < BM; ++m)
      if (m0 + m < p.M) y[(m0 + m) * p.ldy + n] = from_float<TX>(acc[m]);
  }
}

// ---------------------------------------------------------------------------
// fused quantized SwiGLU
// ---------------------------------------------------------------------------

// The block of a fused-MLP kernel serving BM rows of x: one block a SM of
// 16 warps for the decode path's single row; for more rows, whose
// accumulators need twice the registers, two blocks a SM of 8 warps.
template <int BM>
struct QmlpBlock {
  static constexpr int WARPS = BM == 1 ? 16 : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int PER_SM = BM == 1 ? 1 : 2;
};

// A lane's unit of a packed row: VEC words (16 bytes when VEC = 4), V values.
template <int BITS, int VEC>
struct Lane {
  static constexpr int V = VEC * 32 / BITS;
};

// Where x is staged (the fused MLP), a unit's x values sit in shared memory
// as V floats and 4 of padding, so that the 8 lanes of a 16-byte shared
// load hit 8 distinct bank groups.
template <int BITS, int VEC>
struct Staged : Lane<BITS, VEC> {
  static constexpr int XS = Lane<BITS, VEC>::V + 4;
};

template <int VEC>
struct Words {
  uint32_t w[VEC];
};

template <int VEC>
__device__ __forceinline__ Words<VEC> load_words(const uint8_t* row, int c) {
  Words<VEC> r;
  if constexpr (VEC == 4) {
    // read once: through the non-coherent path, without taking L1 lines
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
                 : "l"(reinterpret_cast<const uint4*>(row) + c));
  } else if constexpr (VEC == 2) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(r.w[0]), "=r"(r.w[1])
                 : "l"(reinterpret_cast<const uint2*>(row) + c));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const uint32_t*>(row) + c);
  }
  return r;
}

// four x values as floats: float32 from shared or global memory; bfloat16
// (8 bytes, through the read-only path) from global memory only
__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// acc[r][m] += sum_j x[m, j] * (q[r]_j * s[r] + b[r]) over one lane unit of
// the first R rows; xc points at the unit's x values of row 0 (in shared
// memory, or x itself in global memory), rows xs_row elements apart, each
// read once for all R rows.
//
// A value's bits are or-ed under the float32 exponent of 2^23 where they lie
// in the word, at bit 4j (or 8j), so that f - 2^23 = q 16^j (or q 256^j)
// exactly, and fmaf(q 16^j, s 16^-j, b) rounds the same exact q s + b as
// fmaf(q, s, b): one LOP3 and one FADD a value, no conversion. The bits
// must stay below bit 20: values 5-7 of a 4-bit word (2-3 of an 8-bit one)
// are read from the word shifted right by 12 (16), one shift a word.
template <int BITS, int VEC, int BM, int R, int RA, typename XT = float>
__device__ __forceinline__ void unit_dot(const Words<VEC>* q, const float* s, const float* b,
                                         const XT* xc, int xs_row, float (&acc)[RA][BM]) {
  static_assert(R <= RA, "more rows than accumulators");
  constexpr int VPW = 32 / BITS;
  constexpr int LOW = BITS == 4 ? 5 : 2;   // values read from the word as it is
  constexpr int SHIFT = BITS == 4 ? 12 : 16;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  // s / 2^(BITS j) for the positions the values take
  float sj[R][LOW];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sj[r][0] = s[r];
#pragma unroll
    for (int j = 1; j < LOW; ++j) sj[r][j] = sj[r][j - 1] * (1.f / (1u << BITS));
  }
#pragma unroll
  for (int wi = 0; wi < VEC; ++wi) {
    float w[R][VPW];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t lo = q[r].w[wi], hi = lo >> SHIFT;
#pragma unroll
      for (int j = 0; j < VPW; ++j) {
        const int pos = j < LOW ? j : j - SHIFT / BITS;  // value position in lo or hi
        const uint32_t bits = (j < LOW ? lo : hi) & (MASK << (BITS * pos));
        w[r][j] = fmaf(__uint_as_float(0x4B000000u | bits) - 8388608.f, sj[r][pos], b[r]);
      }
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const XT* xv = xc + m * xs_row + wi * VPW;
#pragma unroll
      for (int j = 0; j < VPW / 4; ++j) {
        const float4 t = load_x4(xv + 4 * j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float a = acc[r][m];
          a = fmaf(w[r][4 * j], t.x, a);
          a = fmaf(w[r][4 * j + 1], t.y, a);
          a = fmaf(w[r][4 * j + 2], t.z, a);
          a = fmaf(w[r][4 * j + 3], t.w, a);
          acc[r][m] = a;
        }
      }
    }
  }
}

template <int BM>
__device__ __forceinline__ void warp_sum(float (&acc)[BM]) {
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    float a = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    acc[m] = a;
  }
}

// ---------------------------------------------------------------------------
// qmm, decode path: the dequant-GEMV for M <= 4 at 4, 6 and 8 bits
// ---------------------------------------------------------------------------

// 6-bit dequantization, exact as `unit_dot`'s. Value j of a 16-value chunk
// (words w0, w1, w2) sits at bit 6 j of its 96 bits. Each is brought to bit
// 0, 6 or 12 of a 32-bit source: a word, a word shifted right (w0 >> 18,
// w1 >> 4, w1 >> 22, w2 >> 2, w2 >> 20), or for j = 5 and j = 10, which
// straddle a word boundary, two words funnel-shifted into one. Or-ed under
// the exponent of 2^23 there, its top bit is at most bit 17, inside the
// mantissa: f - 2^23 = q 64^k exactly, and fmaf(q 64^k, s 64^-k, b) rounds
// the same q s + b as fmaf(q, s, b). Seven shifts a chunk, then one LOP3,
// FADD and FFMA a value, no conversion.
__device__ __forceinline__ int q6_pos(int j) {  // k: the value sits at bit 6 k
  return j < 3 ? j : j < 5 ? j - 3 : j < 6 ? 0 : j < 9 ? j - 6 : j < 11 ? 0 : j < 14 ? j - 11 : j - 14;
}

__device__ __forceinline__ uint32_t q6_bits(uint32_t w0, uint32_t w1, uint32_t w2, int j) {
  uint32_t src;
  if (j < 3) src = w0;
  else if (j < 5) src = w0 >> 18;
  else if (j == 5) src = __funnelshift_r(w0, w1, 30);
  else if (j < 9) src = w1 >> 4;
  else if (j == 9) src = w1 >> 22;
  else if (j == 10) src = __funnelshift_r(w1, w2, 28);
  else if (j < 14) src = w2 >> 2;
  else src = w2 >> 20;
  return src & (63u << (6 * q6_pos(j)));
}

// acc[r][m] += sum_j x[m, j] * (q[r]_j * s[r] + b[r]) over the 16 values of
// chunk `ch` (words 3 ch .. 3 ch + 2) of R rows' units; xc points at the
// chunk's x values of row 0, rows xs_row elements apart, each read once for
// all R rows.
template <int BM, int R, int W, typename XT>
__device__ __forceinline__ void unit_dot6(const Words<W>* q, int ch, const float* s,
                                          const float* b, const XT* xc, int xs_row,
                                          float (&acc)[R][BM]) {
  float sk[R][3];  // s / 64^k
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sk[r][0] = s[r];
    sk[r][1] = s[r] * (1.f / 64.f);
    sk[r][2] = s[r] * (1.f / 4096.f);
  }
#pragma unroll
  for (int jq = 0; jq < 4; ++jq) {
    float w[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * jq + t;
        const uint32_t bits = q6_bits(q[r].w[3 * ch], q[r].w[3 * ch + 1], q[r].w[3 * ch + 2], j);
        w[r][t] = fmaf(__uint_as_float(0x4B000000u | bits) - 8388608.f, sk[r][q6_pos(j)], b[r]);
      }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float4 t = load_x4(xc + m * xs_row + 4 * jq);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = acc[r][m];
        a = fmaf(w[r][0], t.x, a);
        a = fmaf(w[r][1], t.y, a);
        a = fmaf(w[r][2], t.z, a);
        a = fmaf(w[r][3], t.w, a);
        acc[r][m] = a;
      }
    }
  }
}

// A warp owns GEMV_R consecutive weight rows and one of `split` contiguous
// segments of their lane units; a block is GEMV_RW such row groups times
// `split` segments. A lane unit holds 16 values (int4, 6-bit) or 8 (int8)
// inside one group: 8 bytes at 4 and 8 bits, one 12-byte chunk at 6. Each
// lane sends the units of its R rows, and their scales and biases, before
// any arithmetic, and the next step's units before it computes this one's.
// Past the load latency the time goes to each warp's chain of unpacking,
// FMAs and its shuffle sums: 8-byte units with K split so that a lane holds
// one unit a row give more, shorter chains than 16-byte units (3.53 against
// 3.69 us at the talker's q/k/v on an H100). 16-value 6-bit units keep that
// rule: a row of K = 1024 is 64 units, as at int4. Splitting stops at about
// 16 warps a SM in all (GEMV_MAX_WARPS): past that more segments only add
// blocks (the 6-bit gate/up, N = 6144: 4.88 us whole, 6.02 us in two
// segments). x (M rows of K) is read straight from global memory through
// L1, four values at a time, inside `unit_dot`: nothing is staged, so no
// barrier stands before the weight loads. The segments' partial sums meet
// in shared memory and are added in segment order (the same result on
// every run). The launch bounds' floor of one block a SM lets ptxas take
// the registers it needs: without it, ptxas held qmm_gemv<8, 2, bf16> to 64
// registers and spilled 8 bytes.
constexpr int GEMV_VEC = 2;  // words a lane unit at 4 and 8 bits: 8 bytes
constexpr int GEMV_R = 4;
constexpr int GEMV_RW = 2;
constexpr int GEMV_MAX_SPLIT = 8;
constexpr int GEMV_MAX_WARPS = 2048;

template <int BITS>
struct GemvUnit {
  static constexpr int WORDS = BITS == 6 ? 3 : GEMV_VEC;
  static constexpr int V = WORDS * 32 / BITS;
  // the alignment, in bytes, that its loads need of a row and of the weight
  static constexpr int ALIGN = BITS != 6 ? 4 * GEMV_VEC : 4;
};

// A 6-bit unit c: 12 bytes at 12 c, which are only 4-byte aligned, read as
// three 4-byte loads through L1, where the three loads of a warp share their
// sectors (4.03-4.09 us at the talker's q/k/v against 4.17 for an 8-byte
// load where the unit's parity puts an 8-byte boundary and a 4-byte one,
// 4.29 for the three kept out of L1, and 6.11 for 48-byte units of a whole
// group, which spill).
template <int BITS>
__device__ __forceinline__ Words<GemvUnit<BITS>::WORDS> load_unit(const uint8_t* row, int c) {
  if constexpr (BITS != 6) {
    return load_words<GEMV_VEC>(row, c);
  } else {
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(row) + 3 * c;
    Words<3> r;
    r.w[0] = __ldg(wp);
    r.w[1] = __ldg(wp + 1);
    r.w[2] = __ldg(wp + 2);
    return r;
  }
}

// one lane unit of R rows against x: `unit_dot` at 4 and 8 bits, `unit_dot6`
// at 6
template <int BITS, int BM, int R, typename TX>
__device__ __forceinline__ void gemv_dot(const Words<GemvUnit<BITS>::WORDS>* w, const float* s,
                                         const float* b, const TX* xc, int ldx,
                                         float (&acc)[R][BM]) {
  if constexpr (BITS == 6) {
    unit_dot6<BM, R>(w, 0, s, b, xc, ldx, acc);
  } else {
    unit_dot<BITS, GEMV_VEC, BM, R, R, TX>(w, s, b, xc, ldx, acc);
  }
}

template <int BITS, int BM, typename TX>
__global__ void __launch_bounds__(32 * GEMV_RW * GEMV_MAX_SPLIT, 1)
    qmm_gemv(QmmParams p, int split) {
  using U = GemvUnit<BITS>;
  using W = Words<U::WORDS>;
  constexpr int R = GEMV_R;
  __shared__ float part[GEMV_MAX_SPLIT][GEMV_RW * R][BM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sg = warp % split, rw = warp / split;
  const int n0 = (blockIdx.x * GEMV_RW + rw) * R;
  const int units = p.K / U::V;
  const int c1 = (sg + 1) * units / split;
  // rows past N read row N - 1 and are not stored
  const uint8_t* rows[R];
  int srow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = min(n0 + r, p.N - 1);
    rows[r] = p.w.w + n * p.w.row_bytes;
    srow[r] = n * p.w.G;
  }
  auto load = [&](int c, W(&w)[R], float(&s)[R], float(&b)[R]) {
    const int grp = c * U::V / p.w.group_size;
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = load_unit<BITS>(rows[r], c);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = __ldg(p.w.s + srow[r] + grp);
      b[r] = __ldg(p.w.b + srow[r] + grp);
    }
  };

  float acc[R][BM];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < BM; ++m) acc[r][m] = 0.f;
  W w[R];
  float s[R], b[R];
  int c = sg * units / split + lane;
  if (c < c1) load(c, w, s, b);
  const TX* x = static_cast<const TX*>(p.x);
  while (c < c1) {
    W wn[R];
    float sn[R], bn[R];
    if (c + 32 < c1) load(c + 32, wn, sn, bn);
    gemv_dot<BITS, BM, R, TX>(w, s, b, x + c * U::V, static_cast<int>(p.ldx), acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      w[r] = wn[r];
      s[r] = sn[r];
      b[r] = bn[r];
    }
    c += 32;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) warp_sum(acc[r]);

  TX* y = static_cast<TX*>(p.y);
  if (split == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < BM; ++m)
        if (lane == r * BM + m && n0 + r < p.N) y[m * p.ldy + n0 + r] = from_float<TX>(acc[r][m]);
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < BM; ++m) part[sg][rw * R + r][m] = acc[r][m];
  }
  __syncthreads();
  const int nb = blockIdx.x * GEMV_RW * R;
  for (int i = threadIdx.x; i < GEMV_RW * R * BM; i += blockDim.x) {
    const int row = i / BM, m = i % BM;
    if (nb + row >= p.N) continue;
    float sum = 0.f;
    for (int t = 0; t < split; ++t) sum += part[t][row][m];
    y[m * p.ldy + nb + row] = from_float<TX>(sum);
  }
}

// ---------------------------------------------------------------------------
// qmm, M > 4: the dequant-GEMM on the tensor cores
// ---------------------------------------------------------------------------

// Every 4-, 6- and 8-bit code (0..255) is exact in bf16, so the B operand of
// the products is the integer codes q themselves, never w rounded to bf16:
// mma.sync m16n8k16 (bf16 in, float32 accumulators) sums x q over one
// group into `gacc`, and at the group's end the fold adds s[n, g] gacc +
// b[n, g] sum_g x into the output's accumulators, the TPU body's split of
// the sum (sum x q s, plus the per-group sums of x times the biases). For
// bf16 x every product is exact and only the order of the float32 sums
// differs from the plain version. float32 x is split into three bf16 parts,
// hi + mid + lo = x (exact for |x| >= 2^-110; below, the parts lose what
// lies under bf16's smallest step, 2^-133), and the three products run
// against the same codes.
//
// A block owns BM = 64 rows of x (32 where M <= 32) and BN = 32 WN weight
// rows, so each weight row is read and unpacked once per 64 rows of x, not
// once per 8. K
// goes in stages of 64 values through a ring of MMA_STAGES: x, the packed
// words, and the scales and biases of the groups the stage touches, all
// brought in by cp.async while the products of the stage before run. Each
// stage's words are unpacked once per block into a bf16 tile of codes (and
// float32 x into its three bf16 tiles), in the row layout ldmatrix reads,
// double-buffered, so one block barrier a stage separates the unpacking of
// stage k + 1 from the products of stage k. The block's warps are KG
// groups of WM x WN warps of 32 x 32 outputs, each group taking every
// KG-th mma step of a stage (two groups for float32 x, one for bf16): at
// the prefill's 32 rows the time is the
// latency of each stage's chain of instructions, not the tensor cores, so
// more warps on shorter chains. The sums of x come from the tensor cores
// too, as products with a B operand of ones. Where a few rows of x meet a
// narrow weight (o_proj and down at the 32-row prefill: 16 tiles) K is
// split over up to 8 blocks that form a cluster; each adds its share of
// the tile's rows over the splits' tiles through distributed shared memory,
// in split order. The ragged M, N and K edges are zero-filled and the
// stores masked.
constexpr int MMA_MT = 2;        // m16 tiles a warp
constexpr int MMA_BK = 64;       // values of K a stage
constexpr int MMA_STAGES = 3;
constexpr int MMA_XS = MMA_BK + 8;  // padded row of a bf16 tile: 144 bytes
constexpr int MMA_XF = MMA_BK + 8;  // padded row of the float32 x tile
constexpr int MMA_KC = MMA_BK / 16;  // mma steps of 16 values a stage
constexpr int MMA_GPS = MMA_KC;  // groups a stage can touch (group_size >= 16)
constexpr int MMA_MAX_SPLITS = 8;  // splits of K: blocks of a cluster

// WM warps of MMA_MT m16 tiles along M (BM rows of x), WN warps of 32
// weight rows along N
template <int BITS, int WM, int WN, typename TX>
struct MmaTile {
  static constexpr int BM = 16 * MMA_MT * WM;
  static constexpr int BN = 32 * WN;
  // groups of warps that share a stage's mma steps: two for float32 x,
  // whose steps are three products each
  static constexpr int KG = sizeof(TX) == 4 ? 2 : 1;
  static constexpr int THREADS = 32 * KG * WM * WN;
  static constexpr int NSPLIT = sizeof(TX) == 4 ? 3 : 1;
  static constexpr int RB = MMA_BK * BITS / 8;  // packed bytes of a row a stage
  static constexpr int XROW = sizeof(TX) == 4 ? 4 * MMA_XF : 2 * MMA_XS;  // bytes
  static constexpr int X_BYTES = BM * XROW;
  static constexpr int W_BYTES = BN * RB;
  static constexpr int SB_BYTES = 2 * MMA_GPS * BN * 4;  // scales, biases [2][GPS][BN]
  static constexpr int STAGE = X_BYTES + W_BYTES + SB_BYTES;
  static constexpr int Q_BYTES = BN * MMA_XS * 2;  // the codes
  static constexpr int A_BYTES = NSPLIT == 3 ? 3 * BM * MMA_XS * 2 : 0;  // x's parts
  static constexpr int BUF = Q_BYTES + A_BYTES;
  static constexpr int PS = BN + 8;  // padded row of the output tile (floats)
  static constexpr int OUT_BYTES = BM * PS * 4;  // in the ring, after the loop
  static constexpr int SMEM = (MMA_STAGES * STAGE > OUT_BYTES ? MMA_STAGES * STAGE : OUT_BYTES) +
                              2 * BUF;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16 x 16, row-major bf16) b (16 x 8, column-major bf16), float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two codes (lo, hi < 2^BITS) as a bf16 pair, exactly. Below 128 they are
// or-ed under the bf16 exponent of 128 (0x4300: 128 + q, mantissa step 1)
// and 128 taken off; 8-bit codes go through float32. `s` and `b` are the
// group's scale and bias, which the codes do not use.
template <int BITS>
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t lo, uint32_t hi, float s, float b) {
  if constexpr (BITS == 8) {
    __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    const uint32_t u = lo | (hi << 16) | 0x43004300u, c = 0x43004300u;
    __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u),
                               *reinterpret_cast<const __nv_bfloat162*>(&c));
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// the end of a group: acc += s gacc + b xg (xg: the group's sum of x over
// the accumulator's row), gacc = 0
__device__ __forceinline__ void mma_fold(float& acc, float& gacc, float s, float b, float xg) {
  acc = fmaf(s, gacc, fmaf(b, xg, acc));
  gacc = 0.f;
}

// (a, b) = hi + mid + lo, three pairs of bf16 parts, each a bf16x2 word
__device__ __forceinline__ void split3(float a, float b, uint32_t (&w)[3]) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  float2 f = __bfloat1622float2(h);
  w[0] = *reinterpret_cast<uint32_t*>(&h);
  a -= f.x;
  b -= f.y;
  h = __floats2bfloat162_rn(a, b);
  f = __bfloat1622float2(h);
  w[1] = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(a - f.x, b - f.y);
  w[2] = *reinterpret_cast<uint32_t*>(&h);
}

template <int BITS, int WM, int WN, typename TX>
__global__ void __launch_bounds__(MmaTile<BITS, WM, WN, TX>::THREADS, sizeof(TX) == 2 ? 2 : 1)
    qmm_mma(QmmParams p) {
  using T = MmaTile<BITS, WM, WN, TX>;
  constexpr int BM = T::BM, BN = T::BN, NTH = T::THREADS, NSPLIT = T::NSPLIT, KG = T::KG;
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM % WN, kg = warp / (WM * WN);
  const int gq = lane >> 2, tq = lane & 3;  // the mma fragments' row and column pair
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int rows = min(BM, p.M - m0);       // rows of x this block holds
  const bool live = wm * 16 * MMA_MT < rows;  // this warp's rows hold any of x
  const int gs = p.w.group_size, G = p.w.G;
  // k / gs by a shift where the group is a power of two, as it is in practice
  const bool gpow2 = (gs & (gs - 1)) == 0;
  const int gshift = __ffs(gs) - 1;
  auto gdiv = [&](int k) { return gpow2 ? k >> gshift : k / gs; };
  // this block's split of K: stages kb .. ke - 1, values up to k_end
  const int nk = (p.K + MMA_BK - 1) / MMA_BK;
  const int kb = static_cast<int>(static_cast<long long>(blockIdx.z) * nk / p.splits);
  const int ke = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * nk / p.splits);
  const int k_end = min(ke * MMA_BK, p.K);
  const TX* x = static_cast<const TX*>(p.x);

  auto stage_ptr = [&](int kt) { return smem + ((kt - kb) % MMA_STAGES) * T::STAGE; };
  auto buf_ptr = [&](int kt) {
    return smem + MMA_STAGES * T::STAGE + ((kt - kb) & 1) * T::BUF;
  };

  auto load_stage = [&](int kt) {
    uint8_t* st = stage_ptr(kt);
    const int k0 = kt * MMA_BK;
    constexpr int XV = 16 / sizeof(TX), XP = MMA_BK / XV;  // values a piece, pieces a row
    constexpr int XN = BM * XP;
#pragma unroll
    for (int it = 0; it < (XN + NTH - 1) / NTH; ++it) {
      const int i = tid + it * NTH, r = i / XP, c = i % XP, k = k0 + c * XV;
      const bool ok = r < rows && k < p.K;
      if (XN % NTH == 0 || i < XN)
        cp_async16(st + r * T::XROW + c * 16, ok ? x + (m0 + r) * p.ldx + k : x, ok);
    }
    constexpr int WP = T::RB / 16;
    const long long byte0 = static_cast<long long>(k0) * BITS / 8;
    uint8_t* wt = st + T::X_BYTES;
#pragma unroll
    for (int it = 0; it < (BN * WP + NTH - 1) / NTH; ++it) {
      const int i = tid + it * NTH, r = i / WP, c = i % WP;
      const long long off = byte0 + c * 16;
      const bool ok = n0 + r < p.N && off < p.w.row_bytes;
      if (i < BN * WP)
        cp_async16(wt + r * T::RB + c * 16,
                   ok ? p.w.w + (n0 + r) * p.w.row_bytes + off : p.w.w, ok);
    }
    const int g0 = gdiv(k0), ng = gdiv(min(k0 + MMA_BK, p.K) - 1) - g0 + 1;
    float* sb = reinterpret_cast<float*>(wt + T::W_BYTES);
    for (int r = tid; r < BN; r += NTH) {
      const bool ok = n0 + r < p.N;
      const long long row = ok ? static_cast<long long>(n0 + r) * G + g0 : 0;
      for (int j = 0; j < ng; ++j) {
        cp_async4(sb + j * BN + r, p.w.s + row + j, ok);
        cp_async4(sb + (MMA_GPS + j) * BN + r, p.w.b + row + j, ok);
      }
    }
  };

  // stage kt's codes into its buffer's bf16 tile, and for float32 x its
  // three bf16 parts
  auto unpack = [&](int kt) {
    const uint8_t* st = stage_ptr(kt);
    uint8_t* bf = buf_ptr(kt);
    const uint8_t* wt = st + T::X_BYTES;
    const float* sb = reinterpret_cast<const float*>(wt + T::W_BYTES);
    const int k0 = kt * MMA_BK, g0 = gdiv(k0);
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bf);
    // a unit: one word (4/8-bit) or a 16-value chunk of three (6-bit)
    constexpr int UV = BITS == 6 ? 16 : 32 / BITS, UNITS = MMA_BK / UV;
    constexpr int UN = BN * UNITS;
#pragma unroll
    for (int it = 0; it < (UN + NTH - 1) / NTH; ++it) {
      const int i = tid + it * NTH, r = i / UNITS, u = i % UNITS;
      if (UN % NTH != 0 && i >= UN) break;
      const int jg = gdiv(k0 + u * UV) - g0;
      const float s = sb[jg * BN + r], b = sb[(MMA_GPS + jg) * BN + r];
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(wt + r * T::RB);
      uint32_t out[UV / 2];
      if constexpr (BITS == 6) {
        const uint32_t w0 = wp[3 * u], w1 = wp[3 * u + 1], w2 = wp[3 * u + 2];
#pragma unroll
        for (int j = 0; j < 16; j += 2)
          out[j / 2] = codes_bf16x2<6>(q6_bits(w0, w1, w2, j) >> (6 * q6_pos(j)),
                                       q6_bits(w0, w1, w2, j + 1) >> (6 * q6_pos(j + 1)), s, b);
      } else {
        const uint32_t w = wp[u];
        constexpr uint32_t MASK = (1u << BITS) - 1u;
#pragma unroll
        for (int j = 0; j < UV; j += 2)
          out[j / 2] = codes_bf16x2<BITS>((w >> (BITS * j)) & MASK,
                                          (w >> (BITS * (j + 1))) & MASK, s, b);
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(qs + r * MMA_XS + u * UV);
      if constexpr (UV / 2 == 2) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
      } else {
#pragma unroll
        for (int j = 0; j < UV / 2; j += 4)
          *reinterpret_cast<uint4*>(dst + j) = make_uint4(out[j], out[j + 1], out[j + 2], out[j + 3]);
      }
    }
    if constexpr (NSPLIT == 3) {
      __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(bf + T::Q_BYTES);
      constexpr int XN = BM * MMA_KC;
#pragma unroll
      for (int it = 0; it < (XN + NTH - 1) / NTH; ++it) {
        const int i = tid + it * NTH, r = i / MMA_KC, c = i % MMA_KC;
        // rows past M stay as they are: an mma row meets only its own row
        // of the output, which is not stored
        if ((XN % NTH != 0 && i >= XN) || r >= rows) break;
        const float4* xr = reinterpret_cast<const float4*>(st + r * T::XROW + 64 * c);
        uint32_t part[3][8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = xr[q];
          uint32_t lo[3], hi[3];
          split3(v.x, v.y, lo);
          split3(v.z, v.w, hi);
#pragma unroll
          for (int sp = 0; sp < 3; ++sp) {
            part[sp][2 * q] = lo[sp];
            part[sp][2 * q + 1] = hi[sp];
          }
        }
#pragma unroll
        for (int sp = 0; sp < 3; ++sp) {
          uint4* dst = reinterpret_cast<uint4*>(at + (sp * BM + r) * MMA_XS + 16 * c);
          dst[0] = make_uint4(part[sp][0], part[sp][1], part[sp][2], part[sp][3]);
          dst[1] = make_uint4(part[sp][4], part[sp][5], part[sp][6], part[sp][7]);
        }
      }
    }
  };

  // gacc: the open group's sums of x q; xacc: its sums of x (a product with
  // a B operand of ones, every column the same), both folded into acc when
  // the group or the split ends
  float acc[MMA_MT][4][4], gacc[MMA_MT][4][4], xacc[MMA_MT][4];
#pragma unroll
  for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xacc[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][e] = gacc[i][j][e] = 0.f;
    }
  constexpr uint32_t ONES = 0x3F803F80u;  // two bf16 1.0
  // k-group kg takes the mma steps kg, kg + KG, ... of every stage; its
  // share of a group ends where its next step lies in another group or
  // past this split
  const int gc = gs / 16;  // mma steps a group
  const bool cpow2 = (gc & (gc - 1)) == 0;
  const int cshift = __ffs(gc) - 1;
  auto cgroup = [&](int step) { return cpow2 ? step >> cshift : step / gc; };
  const int step_end = k_end / 16;

  auto compute = [&](int kt) {
    const uint8_t* st = stage_ptr(kt);
    const uint8_t* bf = buf_ptr(kt);
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(bf);
    const __nv_bfloat16* at = NSPLIT == 3
                                  ? reinterpret_cast<const __nv_bfloat16*>(bf + T::Q_BYTES)
                                  : reinterpret_cast<const __nv_bfloat16*>(st);
    const float* sb = reinterpret_cast<const float*>(st + T::X_BYTES + T::W_BYTES);
    const int g0 = gdiv(kt * MMA_BK);
#pragma unroll
    for (int c0 = 0; c0 < MMA_KC; c0 += KG) {
      const int c = c0 + kg, step = kt * MMA_KC + c;
      if (step >= step_end) break;
      if (live) {
        uint32_t bq[4][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t r[4];
          ldmatrix_x4(r, qs + (wn * 32 + jj * 16 + (lane >> 4) * 8 + (lane & 7)) * MMA_XS +
                             16 * c + ((lane >> 3) & 1) * 8);
          bq[2 * jj][0] = r[0];
          bq[2 * jj][1] = r[1];
          bq[2 * jj + 1][0] = r[2];
          bq[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int sp = 0; sp < NSPLIT; ++sp) {
          uint32_t af[MMA_MT][4];
#pragma unroll
          for (int i = 0; i < MMA_MT; ++i)
            ldmatrix_x4(af[i], at + (sp * BM + wm * 16 * MMA_MT + i * 16 + (lane & 15)) *
                                        MMA_XS + 16 * c + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MMA_MT; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(gacc[i][j], af[i], bq[j][0], bq[j][1]);
            mma_bf16(xacc[i], af[i], ONES, ONES);
          }
        }
      }
      // this k-group's share of the group ends: fold (s gacc and b xg are
      // linear in the sums, so the shares and splits of a group add up)
      const int grp = cgroup(step);
      if (step + KG >= step_end || cgroup(step + KG) != grp) {
        const int jg = grp - g0;
        if (live) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = wn * 32 + j * 8 + 2 * tq;
            const float s0 = sb[jg * BN + n], s1 = sb[jg * BN + n + 1];
            const float b0 = sb[(MMA_GPS + jg) * BN + n], b1 = sb[(MMA_GPS + jg) * BN + n + 1];
#pragma unroll
            for (int i = 0; i < MMA_MT; ++i) {
              mma_fold(acc[i][j][0], gacc[i][j][0], s0, b0, xacc[i][0]);
              mma_fold(acc[i][j][1], gacc[i][j][1], s1, b1, xacc[i][0]);
              mma_fold(acc[i][j][2], gacc[i][j][2], s0, b0, xacc[i][2]);
              mma_fold(acc[i][j][3], gacc[i][j][3], s1, b1, xacc[i][2]);
            }
          }
#pragma unroll
          for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) xacc[i][e] = 0.f;
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (kb + s < ke) load_stage(kb + s);
    cp_async_commit();
  }
  cp_async_wait<MMA_STAGES - 2>();  // stage kb
  __syncthreads();
  unpack(kb);
  for (int kt = kb; kt < ke; ++kt) {
    cp_async_wait<MMA_STAGES - 3>();  // stage kt + 1
    // stage kt + 1 and buffer kt are ready for every thread; ring slot
    // kt - 1 and buffer kt + 1 are free
    __syncthreads();
    if (kt + MMA_STAGES - 1 < ke) load_stage(kt + MMA_STAGES - 1);
    cp_async_commit();
    if (kt + 1 < ke) unpack(kt + 1);
    compute(kt);
  }

  // The block's sums into an output tile in shared memory (the ring's
  // space, now free), the k-groups added in order; then each block of the
  // cluster (the splits of K of this tile) adds up its share of the rows
  // over every split's tile, in split order, and stores them: the same sums
  // on every run, and y written once, four columns a thread.
  cp_async_wait<0>();
  __syncthreads();
  float* out = reinterpret_cast<float*>(smem);
  constexpr int PS = T::PS;
#pragma unroll
  for (int g = KG - 1; g >= 0; --g) {
    if (kg == g && live) {
#pragma unroll
      for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 16 * MMA_MT + i * 16 + gq + 8 * h;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float2* o = reinterpret_cast<float2*>(out + r * PS + wn * 32 + j * 8 + 2 * tq);
            float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            if (g < KG - 1) {
              const float2 u = *o;
              v = make_float2(v.x + u.x, v.y + u.y);
            }
            *o = v;
          }
        }
    }
    __syncthreads();
  }
  namespace cgr = cooperative_groups;
  const int S = p.splits;
  int r0 = 0, r1 = rows;
  if (S > 1) {
    cgr::this_cluster().sync();  // every split's tile is written
    const int rank = static_cast<int>(cgr::this_cluster().block_rank());
    r0 = rank * rows / S;
    r1 = (rank + 1) * rows / S;
  }
  TX* y = static_cast<TX*>(p.y);
  const bool vec = (p.N & 3) == 0 && (p.ldy & 3) == 0;
  for (int i = tid; i < (r1 - r0) * (BN / 4); i += NTH) {
    const int r = r0 + i / (BN / 4), c = i % (BN / 4) * 4, n = n0 + c;
    if (n >= p.N) continue;
    const float4* src = reinterpret_cast<const float4*>(out + r * PS + c);
    float4 v = S > 1 ? *cgr::this_cluster().map_shared_rank(src, 0) : *src;
    for (int z = 1; z < S; ++z) {
      const float4 u = *cgr::this_cluster().map_shared_rank(src, z);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    TX* yp = y + (m0 + r) * p.ldy + n;
    if (vec) {
      if constexpr (sizeof(TX) == 4) {
        *reinterpret_cast<float4*>(yp) = v;
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(yp) = make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                                                   *reinterpret_cast<uint32_t*>(&hi));
      }
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n + q < p.N) yp[q] = from_float<TX>(e[q]);
    }
  }
  if (S > 1) cgr::this_cluster().sync();  // no block leaves while another reads it
}

// Rows m0 .. m0 + BM - 1 of x (K columns, row stride ldx) into the padded
// lane-unit layout, columns from k_begin on; rows past M are zeros. Each
// thread sends its loads in batches of U before it stores any, so staging
// costs a round trip to memory a batch, not one per element. With U = 4,
// `x_load` and `x_store` split the first batch (columns below 4 NT),
// so that other loads can be sent while its own are in flight.
template <int BM, int U>
struct XBatch {
  float v[BM][U];
};

template <int BM, int NT, int U, typename T, bool CG>
__device__ __forceinline__ void x_load(XBatch<BM, U>& r, const T* x, long long ldx, int M,
                                       int m0, int K, int k0) {
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * NT;
      r.v[m][u] = m0 + m < M && k < K ? load_x<T, CG>(x + (m0 + m) * ldx + k) : 0.f;
    }
}

template <int BITS, int VEC, int BM, int NT, int U>
__device__ __forceinline__ void x_store(float* xs, const XBatch<BM, U>& r, int K, int k0) {
  using L = Staged<BITS, VEC>;
  const int xs_row = K / L::V * L::XS;
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * NT;
      if (k < K) xs[m * xs_row + k / L::V * L::XS + k % L::V] = r.v[m][u];
    }
}

template <int BITS, int VEC, int BM, int NT, typename T, bool CG>
__device__ void stage_x(float* xs, const T* x, long long ldx, int M, int m0, int K,
                        int k_begin) {
  constexpr int U = 16 / BM;
  for (int k0 = k_begin + threadIdx.x; k0 < K; k0 += U * NT) {
    XBatch<BM, U> r;
    x_load<BM, NT, U, T, CG>(r, x, ldx, M, m0, K, k0);
    x_store<BITS, VEC, BM, NT, U>(xs, r, K, k0);
  }
}

struct QmlpParams {
  const void* x;
  Rows gu;  // 2I rows: gate then up
  Rows d;   // N rows over I
  void* y;
  float* h;            // (M, I) scratch
  unsigned int* bar;   // grid barrier state, 64 words, zeroed once
  int M, K, I, N;
  long long ldx;
  int part_stride;     // floats per x row of the down product's partial sums
};

// The grid barrier; all blocks are resident (cooperative launch). Its state
// is a generation (word 0) and two arrival counts on another 128-byte line
// (words 32 and 33). A call reads the generation g as it starts and counts
// its arrivals in count[g & 1]; the last block to arrive bumps the
// generation, which releases the others. Block 0 zeroes the other count
// for the next call, which no block of this call touches, so the state
// needs no memset. Calls on one stream run one after another and share it.
// Arrival and wait are split so that a block can send loads between them:
// sent before the arrival's release, they would hold it up, and through it
// every block.
__device__ __forceinline__ bool grid_arrive(unsigned int* bar, unsigned int gen) {
  __syncthreads();  // every h store of the block, before it arrives
  bool last = false;
  if (threadIdx.x == 0) {
    // a release at GPU scope publishes the block's h stores with the arrival
    unsigned int old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(bar + 32 + (gen & 1)) : "memory");
    last = old == gridDim.x - 1;
    if (last) asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar) : "memory");
  }
  return last;
}

__device__ __forceinline__ void grid_wait(unsigned int* bar, unsigned int gen, bool last) {
  if (threadIdx.x == 0 && !last) {
    unsigned int g = gen;
    while (g == gen) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(g) : "l"(bar) : "memory");
      if (g == gen) __nanosleep(32);
    }
  }
  __syncthreads();  // the acquire, passed on to the block
}

// asks L2 for the lines of [ptr, ptr + bytes), spread over the block
template <int NT>
__device__ __forceinline__ void prefetch_l2(const void* ptr, long long bytes) {
  const uintptr_t end = reinterpret_cast<uintptr_t>(ptr) + bytes;
  for (uintptr_t a = (reinterpret_cast<uintptr_t>(ptr) & ~uintptr_t(127)) + threadIdx.x * 128;
       a < end; a += NT * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a));
}

// a lane's unit of one down-product task (row n0 + t / segs, segment
// t % segs of 32 units), loaded ahead of its use
template <int VEC>
struct DownLoad {
  Words<VEC> w;
  float s, b;
  int c;
  bool ok;
};

template <int BITS, int VEC>
__device__ __forceinline__ void load_down(const QmlpParams& p, int n0, int tasks, int segs, int t,
                                          DownLoad<VEC>& r) {
  using L = Lane<BITS, VEC>;
  const int n = n0 + t / segs;
  r.c = (t % segs) * 32 + (threadIdx.x & 31);
  r.ok = t < tasks && r.c < p.I / L::V;
  if (r.ok) {
    const int grp = r.c * L::V / p.d.group_size;
    r.w = load_words<VEC>(p.d.w + n * p.d.row_bytes, r.c);
    r.s = __ldg(p.d.s + n * p.d.G + grp);
    r.b = __ldg(p.d.b + n * p.d.G + grp);
  }
}

// the lane unit c of gate and up rows i0 and, if it is this block's,
// i0 + warps: four 16-byte loads a lane in flight
template <int VEC>
struct GateUp {
  Words<VEC> w[4];
  float s[4], b[4];
};

template <int BITS, int VEC, int NW>
__device__ __forceinline__ void load_gate_up(const QmlpParams& p, int i0, int a1, int c,
                                             GateUp<VEC>& r) {
  using L = Lane<BITS, VEC>;
  if (i0 >= a1 || c >= p.K / L::V) return;
  const int i1 = i0 + NW < a1 ? i0 + NW : i0;
  const int rows[4] = {i0, p.I + i0, i1, p.I + i1};
  const int grp = c * L::V / p.gu.group_size;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r.w[q] = load_words<VEC>(p.gu.w + rows[q] * p.gu.row_bytes, c);
    r.s[q] = __ldg(p.gu.s + rows[q] * p.gu.G + grp);
    r.b[q] = __ldg(p.gu.b + rows[q] * p.gu.G + grp);
  }
}

// Phase A: block b owns gate/up pairs [b I / grid, (b + 1) I / grid); each
// warp takes two pairs at a time, four rows' 16-byte units in flight a lane
// (the first sent while x is staged), and x is staged once per block.
// Phase B: block b owns down rows [b N / grid, (b + 1) N / grid), each cut
// into segments of 32 lane units, its bytes sent toward L2 as the kernel
// starts; warps take (row, segment) tasks two at a time, loading their
// first two while the grid barrier waits, and the segments' partial sums
// are added in segment order in shared memory.
template <int BITS, int BM, int VEC, typename TX>
__global__ void __launch_bounds__(QmlpBlock<BM>::THREADS) qmlp_kernel(QmlpParams p) {
  using L = Staged<BITS, VEC>;
  constexpr int QWARPS = QmlpBlock<BM>::WARPS, QTHREADS = QmlpBlock<BM>::THREADS;
  extern __shared__ float4 smem_f4[];
  float* xs = reinterpret_cast<float*>(smem_f4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncK = p.K / L::V, ncI = p.I / L::V;
  const int xs_k = ncK * L::XS, xs_i = ncI * L::XS;
  float* part = xs + BM * max(xs_k, xs_i);
  const int mtiles = (p.M + BM - 1) / BM;
  const long long grid = gridDim.x;
  unsigned int gen = 0;
  if (threadIdx.x == 0) {
    gen = *reinterpret_cast<volatile unsigned int*>(p.bar);
    if (blockIdx.x == 0) p.bar[32 + ((gen + 1) & 1)] = 0u;
  }

  // phase B's rows of the down weight, with their scales and biases, go
  // toward L2 now: their DRAM traffic overlaps phase A, and phase B's loads
  // after the barrier find them there
  const int n0 = static_cast<int>(blockIdx.x * static_cast<long long>(p.N) / grid);
  const int n1 = static_cast<int>((blockIdx.x + 1) * static_cast<long long>(p.N) / grid);
  prefetch_l2<QTHREADS>(p.d.w + n0 * p.d.row_bytes, (n1 - n0) * p.d.row_bytes);
  prefetch_l2<QTHREADS>(p.d.s + n0 * p.d.G, (n1 - n0) * p.d.G * 4LL);
  prefetch_l2<QTHREADS>(p.d.b + n0 * p.d.G, (n1 - n0) * p.d.G * 4LL);

  // phase A: h[m, i] = silu(x . gate_i) * (x . up_i)
  const int a0 = static_cast<int>(blockIdx.x * static_cast<long long>(p.I) / grid);
  const int a1 = static_cast<int>((blockIdx.x + 1) * static_cast<long long>(p.I) / grid);
  for (int mt = 0; mt < mtiles; ++mt) {
    const int m0 = mt * BM;
    // x's first loads, then the first weight units', then x's stores
    const TX* x = static_cast<const TX*>(p.x);
    XBatch<BM, 4> xb;
    x_load<BM, QTHREADS, 4, TX, false>(xb, x, p.ldx, p.M, m0, p.K, threadIdx.x);
    GateUp<VEC> gl;
    load_gate_up<BITS, VEC, QWARPS>(p, a0 + warp, a1, lane, gl);
    if (mt) __syncthreads();
    x_store<BITS, VEC, BM, QTHREADS, 4>(xs, xb, p.K, threadIdx.x);
    stage_x<BITS, VEC, BM, QTHREADS, TX, false>(xs, x, p.ldx, p.M, m0, p.K, 4 * QTHREADS);
    __syncthreads();
    for (int i0 = a0 + warp; i0 < a1; i0 += 2 * QWARPS) {
      const int i1 = i0 + QWARPS;
      const bool two = i1 < a1;
      float acc[4][BM];  // gate and up of pair i0, then of pair i1
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[r][m] = 0.f;
      for (int c = lane; c < ncK; c += 32) {
        if (i0 != a0 + warp || c != lane) load_gate_up<BITS, VEC, QWARPS>(p, i0, a1, c, gl);
        const float* xc = xs + c * L::XS;
        if (two)
          unit_dot<BITS, VEC, BM, 4>(gl.w, gl.s, gl.b, xc, xs_k, acc);
        else
          unit_dot<BITS, VEC, BM, 2>(gl.w, gl.s, gl.b, xc, xs_k, acc);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) warp_sum(acc[r]);
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          if (m0 + m >= p.M) break;
          const float g0 = acc[0][m], g1 = acc[2][m];
          p.h[(m0 + m) * p.I + i0] = g0 / (1.f + expf(-g0)) * acc[1][m];
          if (two) p.h[(m0 + m) * p.I + i1] = g1 / (1.f + expf(-g1)) * acc[3][m];
        }
      }
    }
  }

  // phase B: y = h . down^T
  const int segs = (ncI + 31) / 32, tasks = (n1 - n0) * segs;
  const bool last = grid_arrive(p.bar, gen);
  DownLoad<VEC> dl[2];
  load_down<BITS, VEC>(p, n0, tasks, segs, warp, dl[0]);
  load_down<BITS, VEC>(p, n0, tasks, segs, warp + QWARPS, dl[1]);
  grid_wait(p.bar, gen, last);

  for (int mt = 0; mt < mtiles; ++mt) {
    const int m0 = mt * BM;
    if (mt) __syncthreads();
    stage_x<BITS, VEC, BM, QTHREADS, float, true>(xs, p.h, p.I, p.M, m0, p.I, 0);
    __syncthreads();
    for (int t0 = warp; t0 < tasks; t0 += 2 * QWARPS) {
      if (mt > 0 || t0 != warp) {
        load_down<BITS, VEC>(p, n0, tasks, segs, t0, dl[0]);
        load_down<BITS, VEC>(p, n0, tasks, segs, t0 + QWARPS, dl[1]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = t0 + q * QWARPS;
        if (t >= tasks) break;
        float acc[1][BM];
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[0][m] = 0.f;
        if (dl[q].ok)
          unit_dot<BITS, VEC, BM, 1>(&dl[q].w, &dl[q].s, &dl[q].b, xs + dl[q].c * L::XS, xs_i,
                                     acc);
        warp_sum(acc[0]);
        if (lane == 0) {
#pragma unroll
          for (int m = 0; m < BM; ++m) part[m * p.part_stride + t] = acc[0][m];
        }
      }
    }
    __syncthreads();
    TX* y = static_cast<TX*>(p.y);
    for (int i = threadIdx.x; i < (n1 - n0) * BM; i += QTHREADS) {
      const int r = i / BM, m = i % BM;
      if (m0 + m >= p.M) continue;
      float sum = 0.f;
      for (int sg = 0; sg < segs; ++sg) sum += part[m * p.part_stride + r * segs + sg];
      y[(m0 + m) * p.N + n0 + r] = from_float<TX>(sum);
    }
  }
}

constexpr size_t smem_bytes(int bm) { return sizeof(float) * bm * KT; }

template <int BITS, int BM, typename TX>
int launch_qmm(const QmmParams& p, cudaStream_t st) {
  const long long groups = (p.N + WARPS - 1) / WARPS;
  const long long blocks = groups * ((p.M + BM - 1) / BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  qmm_kernel<BITS, BM, TX><<<static_cast<unsigned>(blocks), THREADS, smem_bytes(BM), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the GEMV takes M <= 4 where rows, groups and pointers allow its weight
// units (a 6-bit row of 16-value chunks is always a multiple of 4 bytes)
// and 16-byte (f32) or 8-byte (bf16) x reads
template <int BITS, typename TX>
bool gemv_fits(const QmmParams& p) {
  using U = GemvUnit<BITS>;
  constexpr uintptr_t XALIGN = 4 * sizeof(TX);
  return p.M <= 4 && p.K % U::V == 0 && p.w.group_size % U::V == 0 &&
         p.w.row_bytes % U::ALIGN == 0 && reinterpret_cast<uintptr_t>(p.w.w) % U::ALIGN == 0 &&
         reinterpret_cast<uintptr_t>(p.x) % XALIGN == 0 &&
         (p.M == 1 || (p.ldx % 4 == 0 && p.ldx <= 0x7fffffffLL));
}

template <int BITS, int BM, typename TX>
int launch_gemv(QmmParams p, cudaStream_t st) {
  // enough segments that a lane holds one unit of each row where K allows,
  // up to GEMV_MAX_WARPS warps in all
  const int units = p.K / GemvUnit<BITS>::V;
  const int split = max(1, min(min(GEMV_MAX_SPLIT, (units + 31) / 32),
                               GEMV_MAX_WARPS * GEMV_R / max(p.N, 1)));
  const long long blocks = (p.N + GEMV_RW * GEMV_R - 1) / (GEMV_RW * GEMV_R);
  if (p.M == 1) p.ldx = 0;
  qmm_gemv<BITS, BM, TX><<<static_cast<unsigned>(blocks), 32 * GEMV_RW * split, 0, st>>>(p, split);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core GEMM takes M > 4 where its 16-byte copies can: x 16-byte
// aligned with rows a multiple of 16 bytes apart, packed rows a multiple of
// 16 bytes long (K a multiple of 32 at int4, 64 at 6 bits, 16 at int8) from
// a 16-byte aligned weight, and groups of a multiple of 16 values (an mma
// step of 16 values lies in one group).
template <int BITS, typename TX>
bool mma_fits(const QmmParams& p) {
  return p.M > 4 && p.w.group_size % 16 == 0 && p.w.row_bytes % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.w.w) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
         (p.ldx * static_cast<long long>(sizeof(TX))) % 16 == 0 && p.ldx <= 0x7fffffffLL;
}

template <int BITS, int WM, int WN, typename TX>
int launch_mma(QmmParams p, int sms, cudaStream_t st) {
  using T = MmaTile<BITS, WM, WN, TX>;
  auto kernel = qmm_mma<BITS, WM, WN, TX>;
  // the attributes are set, and the blocks a SM holds read, once per device
  // this process launches on (a race only repeats the same work)
  static int per_sm[64];  // 0 = not read yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    // all of the SM's unified memory as shared memory, so that as many
    // blocks as the registers allow fit beside each other
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, T::THREADS, T::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    per_sm[dev] = max(n, 1);
  }
  const long long nt = (p.N + T::BN - 1) / T::BN, mt = (p.M + T::BM - 1) / T::BM;
  if (mt > 65535 || nt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // K is split (in powers of two, at least four stages a split, at most
  // MMA_MAX_SPLITS, the blocks of a cluster) while the grid stays within
  // the blocks the card holds at once: a few rows of x over a narrow weight
  // (o_proj, down at a 32-row prefill) make 16 tiles. Splits of two stages
  // cost more in their sums than they save.
  const int nk = (p.K + MMA_BK - 1) / MMA_BK;
  p.splits = 1;
  while (nt * mt * 2 * p.splits <= static_cast<long long>(per_sm[dev]) * sms &&
         2 * p.splits <= MMA_MAX_SPLITS && 8 * p.splits <= nk)
    p.splits *= 2;
  const dim3 grid(static_cast<unsigned>(nt), static_cast<unsigned>(mt),
                  static_cast<unsigned>(p.splits));
  if (p.splits == 1) {
    kernel<<<grid, T::THREADS, T::SMEM, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  // the splits of a tile form a cluster, so they can add their tiles
  // through each other's shared memory
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(p.splits);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Which kernel qmm_fwd launches (its `kernel` out-parameter): the one rule
// of the three routes.
enum QmmRoute { QMM_TILED = 0, QMM_GEMV = 1, QMM_MMA = 2 };

template <int BITS, typename TX>
int qmm_bm(const QmmParams& p, int sms, cudaStream_t st, int* route) {
  if (gemv_fits<BITS, TX>(p)) {
    *route = QMM_GEMV;
    switch (p.M) {
      case 1: return launch_gemv<BITS, 1, TX>(p, st);
      case 2: return launch_gemv<BITS, 2, TX>(p, st);
      case 3: return launch_gemv<BITS, 3, TX>(p, st);
      default: return launch_gemv<BITS, 4, TX>(p, st);
    }
  }
  if (mma_fits<BITS, TX>(p)) {
    *route = QMM_MMA;
    // A block of 32 rows of x and 128 weight rows up to 32 rows (the
    // talker's prefill) where the weight is wide enough for a block a SM
    // with K split up to MMA_MAX_SPLITS ways; else 64 rows and 128 weight
    // rows where that gives two blocks a SM unsplit, or 64 (more, smaller
    // blocks).
    const long long wide = (p.N + 127) / 128;
    if (p.M <= 32 && wide * MMA_MAX_SPLITS >= sms) return launch_mma<BITS, 1, 4, TX>(p, sms, st);
    // float32 x at up to 32 rows: 32 rows a block whatever the width (its
    // two groups of warps keep a block of 64 x 32 at four warps)
    if (sizeof(TX) == 4 && p.M <= 32) return launch_mma<BITS, 1, 2, TX>(p, sms, st);
    return p.M > 32 && wide * ((p.M + 63) / 64) >= 2LL * sms
               ? launch_mma<BITS, 2, 4, TX>(p, sms, st)
               : launch_mma<BITS, 2, 2, TX>(p, sms, st);
  }
  *route = QMM_TILED;
  if (p.M == 1) return launch_qmm<BITS, 1, TX>(p, st);
  if (p.M == 2) return launch_qmm<BITS, 2, TX>(p, st);
  if (p.M <= 4) return launch_qmm<BITS, 4, TX>(p, st);
  return launch_qmm<BITS, 8, TX>(p, st);
}

template <typename TX>
int qmm_bits(const QmmParams& p, int bits, int sms, cudaStream_t st, int* route) {
  if (bits == 4) return qmm_bm<4, TX>(p, sms, st, route);
  if (bits == 8) return qmm_bm<8, TX>(p, sms, st, route);
  if (bits == 6) return qmm_bm<6, TX>(p, sms, st, route);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch plans of the fused MLP, cached per (kernel, device, shared memory)
// so that a call makes no attribute or occupancy query once its shape has
// been seen: the grid is every block the card holds at once, up to the
// kernel's QmlpBlock::PER_SM a SM.
struct QmlpPlan {
  const void* fn;
  int dev;
  size_t smem;
  int grid;
};
std::mutex qmlp_mu;
QmlpPlan qmlp_plans[64];
int qmlp_nplans = 0;
int sm_count[64];  // 0 = not read yet

int qmlp_sms(int dev, int* sms) {
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(qmlp_mu);
  if (sm_count[dev] == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *sms = sm_count[dev];
  return 0;
}

int qmlp_plan(const void* fn, int dev, size_t smem, int sms, int threads, int cap, int* grid) {
  std::lock_guard<std::mutex> lock(qmlp_mu);
  for (int i = 0; i < qmlp_nplans; ++i) {
    const QmlpPlan& pl = qmlp_plans[i];
    if (pl.fn == fn && pl.dev == dev && pl.smem == smem) {
      *grid = pl.grid;
      return 0;
    }
  }
  int optin = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && smem > static_cast<size_t>(optin)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *grid = sms * min(per_sm, cap);
  if (qmlp_nplans < 64) qmlp_plans[qmlp_nplans++] = {fn, dev, smem, *grid};
  return 0;
}

// shared memory of one block: the staged x (or h) rows, then the down
// product's partial sums for at most `rows` rows of `segs` segments
template <int BITS, int VEC>
size_t qmlp_smem(int bm, int K, int I, int rows, int segs) {
  using L = Staged<BITS, VEC>;
  const size_t staged = static_cast<size_t>(bm) * max(K, I) / L::V * L::XS;
  return sizeof(float) * (staged + static_cast<size_t>(bm) * rows * segs);
}

template <int BITS, int BM, int VEC, typename TX>
int launch_qmlp(QmlpParams p, int dev, int sms, cudaStream_t st) {
  auto kernel = qmlp_kernel<BITS, BM, VEC, TX>;
  // the grid is at least min(sms, N) blocks, so no block owns more rows
  const int rows = (p.N + min(sms, p.N) - 1) / min(sms, p.N);
  const int segs = (p.I / Lane<BITS, VEC>::V + 31) / 32;
  p.part_stride = rows * segs;
  const size_t smem = qmlp_smem<BITS, VEC>(BM, p.K, p.I, rows, segs);
  int grid = 0;
  using Blk = QmlpBlock<BM>;
  int e = qmlp_plan(reinterpret_cast<const void*>(kernel), dev, smem, sms, Blk::THREADS,
                    Blk::PER_SM, &grid);
  if (e != 0) return e;
  grid = min(grid, max(p.I, p.N));
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                                dim3(Blk::THREADS), args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// rows of x a pass over the weights serves: 1, 2 or 4 (M = 1 and 2 are the
// decode path's), fewer if the staged rows would pass ~112 KB (two blocks a
// SM). More rows a pass spill the unrolled lane units out of registers.
template <int BITS, int VEC>
int qmlp_rows(int M, int K, int I) {
  int bm = VEC == 1 || M > 2 ? 4 : M;
  while (bm > 1 && qmlp_smem<BITS, VEC>(bm, K, I, 0, 0) > 112 * 1024) bm /= 2;
  return bm;
}

template <int BITS, typename TX>
int qmlp_launch(const QmlpParams& p, bool vec4, int dev, int sms, cudaStream_t st) {
  if (!vec4) {
    return qmlp_rows<BITS, 1>(p.M, p.K, p.I) == 4 ? launch_qmlp<BITS, 4, 1, TX>(p, dev, sms, st)
                                                  : launch_qmlp<BITS, 1, 1, TX>(p, dev, sms, st);
  }
  switch (qmlp_rows<BITS, 4>(p.M, p.K, p.I)) {
    case 1: return launch_qmlp<BITS, 1, 4, TX>(p, dev, sms, st);
    case 2: return launch_qmlp<BITS, 2, 4, TX>(p, dev, sms, st);
    default: return launch_qmlp<BITS, 4, 4, TX>(p, dev, sms, st);
  }
}

template <typename TX>
int qmlp_bits(const QmlpParams& p, int bits, bool vec4, int dev, int sms, cudaStream_t st) {
  if (bits == 4) return qmlp_launch<4, TX>(p, vec4, dev, sms, st);
  if (bits == 8) return qmlp_launch<8, TX>(p, vec4, dev, sms, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// y (M, N) = x (M, K; row stride ldx) . dequant(w)^T. bits 4, 8 (int32 words)
// or 6 (uint8 stream); dtype 0 = float32, 1 = bfloat16 (x and y). Scales and
// biases are float32 (N, K / group_size). `device` is the current device.
// `kernel` receives the kernel launched (QmmRoute: 0 the tiled qmm_kernel,
// 1 qmm_gemv, 2 qmm_mma; -1 for none). Returns a cudaError_t (0 = launched).
extern "C" int qmm_fwd(const void* x, const void* w, const float* s, const float* b, void* y,
                       int M, int N, int K, int group_size, int bits, int dtype,
                       long long ldx, int device, int* kernel, void* stream) {
  *kernel = -1;
  if (M < 0 || N < 0 || K <= 0 || group_size <= 0 || K % group_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return 0;
  const long long row_bytes = static_cast<long long>(K) * bits / 8;
  QmmParams p{x, {static_cast<const uint8_t*>(w), row_bytes, s, b, K / group_size, group_size},
              y, M, N, K, ldx, N};
  int sms = 0;
  if (M > 4) {
    const int e = qmlp_sms(device, &sms);
    if (e != 0) return e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return qmm_bits<float>(p, bits, sms, st, kernel);
  if (dtype == 1) return qmm_bits<__nv_bfloat16>(p, bits, sms, st, kernel);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y (M, N) = (silu(x . gate^T) * (x . up^T)) . down^T; w_gu holds 2I rows of
// K (gate first), w_d N rows of I; bits 4 or 8. h is an (M, I) float32
// scratch and `bar` the grid barrier's 64 unsigned ints (see grid_arrive),
// both on `device`, which must be the current device; `bar` starts zeroed
// and every call leaves it ready for the next, so one serves every call on
// one stream (calls on other streams need their own).
extern "C" int qmlp_fwd(const void* x, const void* w_gu, const float* s_gu, const float* b_gu,
                        const void* w_d, const float* s_d, const float* b_d, void* y,
                        float* h, unsigned int* bar, int M, int K, int I, int N,
                        int group_size, int bits, int dtype, int device, long long ldx,
                        void* stream) {
  if (M < 0 || K <= 0 || I <= 0 || N < 0 || group_size <= 0 || K % group_size ||
      I % group_size || (bits != 4 && bits != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return 0;
  QmlpParams p{x,
               {static_cast<const uint8_t*>(w_gu), static_cast<long long>(K) * bits / 8, s_gu,
                b_gu, K / group_size, group_size},
               {static_cast<const uint8_t*>(w_d), static_cast<long long>(I) * bits / 8, s_d,
                b_d, I / group_size, group_size},
               y, h, bar, M, K, I, N, ldx, 0};
  // 16-byte lane units where rows, groups and pointers allow, else words
  const int v4 = 4 * 32 / bits;
  const bool vec4 = K % v4 == 0 && I % v4 == 0 && group_size % v4 == 0 &&
                    reinterpret_cast<uintptr_t>(w_gu) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w_d) % 16 == 0;
  int sms = 0;
  const int e = qmlp_sms(device, &sms);
  if (e != 0) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return qmlp_bits<float>(p, bits, vec4, device, sms, st);
  if (dtype == 1) return qmlp_bits<__nv_bfloat16>(p, bits, vec4, device, sms, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
