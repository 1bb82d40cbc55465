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
// of scales and biases, 0.8 us at 3.35 TB/s; one talker MLP reads ~5.9 MB,
// 1.8 us. A launch costs more than that, so at these shapes launch latency
// and the loop around them set the time, not this kernel's inner loop.
//
// What the design does about it (a simple, correct first version):
// - One warp owns one weight row; a block of 8 warps owns 8 rows and a tile
//   of up to BM = 8 rows of x, staged as float32 in shared memory 1024
//   columns at a time. Each weight chunk is unpacked once into registers
//   (w = q*s + b, one FMA per value) and serves every x row of the tile.
//   Lanes walk consecutive chunks, so a warp's word loads are coalesced.
// - M is tiled as well as N: the codec decoder routes M up to several
//   hundred rows. The ragged N edge is masked per warp.
// - The fused MLP runs as one cooperative launch: phase A writes
//   h = silu(g)*u (float32, M*I*4 bytes, <= 196 KB at M = 16, I = 3072) to a
//   scratch the wrapper allocates, which stays in L2; a grid-wide barrier
//   (all blocks are co-resident, which the cooperative launch guarantees);
//   phase B contracts h with the down weight, reading it through L2. The TPU
//   kernel relies on its sequential grid for the same hand-over.
// Later versions can load 16 bytes a lane, hold several rows per warp, and
// keep the staged tile free of bank conflicts; CUDA graphs around the decode
// loop are what the launch-bound shapes need first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

struct QmlpParams {
  const void* x;
  Rows gu;  // 2I rows: gate then up
  Rows d;   // N rows over I
  void* y;
  float* h;                // (M, I) scratch
  unsigned int* arrived;   // zeroed before the launch
  int M, K, I, N;
  long long ldx;
};

__device__ void grid_barrier(unsigned int* arrived) {
  __threadfence();  // each thread's h stores, before the block arrives
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(arrived) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

template <int BITS, int BM, typename TX>
__global__ void __launch_bounds__(THREADS) qmlp_kernel(QmlpParams p) {
  extern __shared__ float4 smem_f4[];
  float* xs = reinterpret_cast<float*>(smem_f4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mtiles = (p.M + BM - 1) / BM;

  // phase A: h[m, i] = silu(x . gate_i) * (x . up_i)
  const int groups_a = (p.I + WARPS - 1) / WARPS;
  for (int t = blockIdx.x; t < groups_a * mtiles; t += gridDim.x) {
    const int i = (t % groups_a) * WARPS + warp, m0 = (t / groups_a) * BM;
    float g[BM], u[BM];
    row_dot<BITS, BM, TX, false>(static_cast<const TX*>(p.x), p.ldx, p.M, p.K, m0,
                                 p.gu, i, i < p.I, xs, g);
    row_dot<BITS, BM, TX, false>(static_cast<const TX*>(p.x), p.ldx, p.M, p.K, m0,
                                 p.gu, p.I + i, i < p.I, xs, u);
    if (lane == 0 && i < p.I) {
#pragma unroll
      for (int m = 0; m < BM; ++m)
        if (m0 + m < p.M) p.h[(m0 + m) * p.I + i] = g[m] / (1.f + expf(-g[m])) * u[m];
    }
  }

  grid_barrier(p.arrived);

  // phase B: y = h . down^T
  const int groups_b = (p.N + WARPS - 1) / WARPS;
  for (int t = blockIdx.x; t < groups_b * mtiles; t += gridDim.x) {
    const int n = (t % groups_b) * WARPS + warp, m0 = (t / groups_b) * BM;
    float acc[BM];
    row_dot<BITS, BM, float, true>(p.h, p.I, p.M, p.I, m0, p.d, n, n < p.N, xs, acc);
    if (lane == 0 && n < p.N) {
      TX* y = static_cast<TX*>(p.y);
#pragma unroll
      for (int m = 0; m < BM; ++m)
        if (m0 + m < p.M) y[(m0 + m) * p.N + n] = from_float<TX>(acc[m]);
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

template <int BITS, typename TX>
int qmm_bm(const QmmParams& p, cudaStream_t st) {
  if (p.M == 1) return launch_qmm<BITS, 1, TX>(p, st);
  if (p.M == 2) return launch_qmm<BITS, 2, TX>(p, st);
  if (p.M <= 4) return launch_qmm<BITS, 4, TX>(p, st);
  return launch_qmm<BITS, 8, TX>(p, st);
}

template <typename TX>
int qmm_bits(const QmmParams& p, int bits, cudaStream_t st) {
  if (bits == 4) return qmm_bm<4, TX>(p, st);
  if (bits == 8) return qmm_bm<8, TX>(p, st);
  if (bits == 6) return qmm_bm<6, TX>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BITS, int BM, typename TX>
int launch_qmlp(QmlpParams p, cudaStream_t st) {
  auto kernel = qmlp_kernel<BITS, BM, TX>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem_bytes(BM));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int mtiles = (p.M + BM - 1) / BM;
  const int tasks = max((p.I + WARPS - 1) / WARPS, (p.N + WARPS - 1) / WARPS) * mtiles;
  // every block must be resident at once for the barrier: at most what the
  // card holds, and no more than there are tasks
  const int grid = min(per_sm * sms, tasks);
  e = cudaMemsetAsync(p.arrived, 0, sizeof(unsigned int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS),
                                  args, smem_bytes(BM), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename TX>
int qmlp_bm(const QmlpParams& p, cudaStream_t st) {
  if (p.M == 1) return launch_qmlp<BITS, 1, TX>(p, st);
  if (p.M == 2) return launch_qmlp<BITS, 2, TX>(p, st);
  if (p.M <= 4) return launch_qmlp<BITS, 4, TX>(p, st);
  return launch_qmlp<BITS, 8, TX>(p, st);
}

template <typename TX>
int qmlp_bits(const QmlpParams& p, int bits, cudaStream_t st) {
  if (bits == 4) return qmlp_bm<4, TX>(p, st);
  if (bits == 8) return qmlp_bm<8, TX>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// y (M, N) = x (M, K; row stride ldx) . dequant(w)^T. bits 4, 8 (int32 words)
// or 6 (uint8 stream); dtype 0 = float32, 1 = bfloat16 (x and y). Scales and
// biases are float32 (N, K / group_size). Returns a cudaError_t (0 = launched).
extern "C" int qmm_fwd(const void* x, const void* w, const float* s, const float* b, void* y,
                       int M, int N, int K, int group_size, int bits, int dtype,
                       long long ldx, void* stream) {
  if (M < 0 || N < 0 || K <= 0 || group_size <= 0 || K % group_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return 0;
  const long long row_bytes = static_cast<long long>(K) * bits / 8;
  QmmParams p{x, {static_cast<const uint8_t*>(w), row_bytes, s, b, K / group_size, group_size},
              y, M, N, K, ldx, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return qmm_bits<float>(p, bits, st);
  if (dtype == 1) return qmm_bits<__nv_bfloat16>(p, bits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y (M, N) = (silu(x . gate^T) * (x . up^T)) . down^T; w_gu holds 2I rows of
// K (gate first), w_d N rows of I; bits 4 or 8. h is an (M, I) float32
// scratch and `arrived` one unsigned int, both on the device; the call
// zeroes `arrived` on the stream before the launch.
extern "C" int qmlp_fwd(const void* x, const void* w_gu, const float* s_gu, const float* b_gu,
                        const void* w_d, const float* s_d, const float* b_d, void* y,
                        float* h, unsigned int* arrived, int M, int K, int I, int N,
                        int group_size, int bits, int dtype, long long ldx, void* stream) {
  if (M < 0 || K <= 0 || I <= 0 || N < 0 || group_size <= 0 || K % group_size ||
      I % group_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return 0;
  QmlpParams p{x,
               {static_cast<const uint8_t*>(w_gu), static_cast<long long>(K) * bits / 8, s_gu,
                b_gu, K / group_size, group_size},
               {static_cast<const uint8_t*>(w_d), static_cast<long long>(I) * bits / 8, s_d,
                b_d, I / group_size, group_size},
               y, h, arrived, M, K, I, N, ldx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return qmlp_bits<float>(p, bits, st);
  if (dtype == 1) return qmlp_bits<__nv_bfloat16>(p, bits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
