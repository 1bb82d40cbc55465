// An alternative float32 ReLU² attention kernel, kept only to be timed
// beside the committed one by scripts/torch_kernel_variants.py; the port
// does not build it.
//
// One launch: a block of 128 threads owns 64 queries, computes their
// weights relu(q k^T / group_size)^2 against every key once into shared
// memory (64 x np floats, np = N rounded up to 64; N <= 256 here, 68 KB
// with padding), then sweeps CT column tiles of 128 with the same 8 x 8 register-blocked
// PV product as the committed PV pass, V staged through a ring of three
// cp.async stages. E is split over the grid in ranges of CT tiles, CT
// chosen so that the grid still gives two blocks a SM where it can: the
// weights are recomputed once per range instead of once per column tile.
// Same C interface as csrc/relu2_attention.cu (the scratch is not used);
// float32 only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;      // queries per block
constexpr int KT = 64;      // keys per score tile
constexpr int CN = 128;     // columns per tile of the sweep
constexpr int PK = 16;      // keys per PV stage
constexpr int STAGES = 3;
constexpr int NMAX = 256;   // keys held in shared memory
constexpr int DMAX = 128;
constexpr int DP = DMAX + 4;
constexpr int PSR = QT + 4;  // padded row of Ps

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int G, N, D, E, ct;
  long long sq[3], sk[3], sv[3], so[3];
  float group_size;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(128) relu2_p_in_smem(Params p) {
  extern __shared__ float4 smem_f4[];
  float* Ps = reinterpret_cast<float*>(smem_f4);  // [NMAX][PSR]: keys by queries
  float* Qs = Ps + NMAX * PSR;                     // [QT][DP]
  float* Ks = Qs + QT * DP;                       // [KT][DP]
  float* Bs = Ks + KT * DP;                       // [STAGES][PK][CN]
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * QT;
  const int b = blockIdx.z / p.G, g = blockIdx.z % p.G;
  const float* qg = p.q + b * p.sq[0] + g * p.sq[1];
  const float* kg = p.k + b * p.sk[0] + g * p.sk[1];
  const int np = (p.N + KT - 1) / KT * KT;

  for (int idx = tid; idx < QT * DMAX / 4; idx += 128) {
    const int r = idx / (DMAX / 4), c = (idx % (DMAX / 4)) * 4;
    const bool ok = q0 + r < p.N && c < p.D;
    cp_async16(Qs + r * DP + c, ok ? qg + (q0 + r) * p.sq[2] + c : qg, ok);
  }
  // the weights: queries sy + 16 i, keys sx + 8 j of each tile of 64 keys
  const int sx = tid % 8, sy = tid / 8;
  for (int k0 = 0; k0 < np; k0 += KT) {
    if (k0) __syncthreads();  // every thread is done with the last Ks
    for (int idx = tid; idx < KT * DMAX / 4; idx += 128) {
      const int r = idx / (DMAX / 4), c = (idx % (DMAX / 4)) * 4;
      const bool ok = k0 + r < p.N && c < p.D;
      cp_async16(Ks + r * DP + c, ok ? kg + (k0 + r) * p.sk[2] + c : kg, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][8] = {};
    for (int d = 0; d < DMAX; d += 4) {
      float4 qa[4], ka[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (sy + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (sx + 8 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + sx + 8 * j;
        const float r = fmaxf(s[i][j] / p.group_size, 0.f);
        Ps[key * PSR + sy + 16 * i] = key < p.N ? r * r : 0.f;
      }
  }
  __syncthreads();

  // the column sweep
  const int tx = tid % 16, ty = tid / 16;
  const int nk = np / PK;
  const float* vb = p.v + b * p.sv[0] + g * p.sv[1];
  float* ob = p.o + b * p.so[0] + g * p.so[1];
  for (int t = 0; t < p.ct; ++t) {
    const int e0 = (blockIdx.x * p.ct + t) * CN;
    if (e0 >= p.E) break;
    const int ne = min(CN, p.E - e0);
    auto load = [&](int kt) {
      const int k0 = kt * PK;
      float* bs = Bs + (kt % STAGES) * PK * CN;
#pragma unroll
      for (int i = 0; i < PK * CN / 4 / 128; ++i) {
        const int idx = tid + 128 * i, r = idx / (CN / 4), c = (idx % (CN / 4)) * 4;
        const bool ok = k0 + r < p.N && c < ne;
        cp_async16(bs + r * CN + c, ok ? vb + (k0 + r) * p.sv[2] + e0 + c : vb, ok);
      }
    };
    float acc[8][8] = {};
    __syncthreads();  // the last tile's readers of Bs are done
#pragma unroll
    for (int kt = 0; kt < STAGES - 1; ++kt) {
      if (kt < nk) load(kt);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
      cp_async_commit();
      const float* bs = Bs + (kt % STAGES) * PK * CN;
      const float* as = Ps + kt * PK * PSR;
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + kk * PSR + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(as + kk * PSR + 32 + 4 * ty);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * CN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * CN + 64 + 4 * tx);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float w[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qr = q0 + (i < 4 ? 4 * ty + i : 32 + 4 * ty + i - 4);
      if (qr >= p.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 64 * h + 4 * tx;
        if (c < ne)
          *reinterpret_cast<float4*>(ob + qr * p.so[2] + e0 + c) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
}

}  // namespace

extern "C" int relu2_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* scratch,
    int B, int G, int N, int D, int E,
    long long sqb, long long sqg, long long sqn,
    long long skb, long long skg, long long skn,
    long long svb, long long svg, long long svn,
    long long sob, long long sog, long long son,
    float group_size, int dtype, void* stream) {
  (void)scratch;
  if (dtype != 0 || N > NMAX || D > DMAX || B * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || E == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (E + CN - 1) / CN, qtiles = (N + QT - 1) / QT;
  const int ct = max(1, tiles * qtiles * B * G / (2 * sms));
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o), G, N, D, E, ct,
           {sqb, sqg, sqn}, {skb, skg, skn}, {svb, svg, svn}, {sob, sog, son}, group_size};
  const size_t smem = sizeof(float) * (NMAX * PSR + (QT + KT) * DP + STAGES * PK * CN);
  cudaError_t err = cudaFuncSetAttribute(relu2_p_in_smem,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  relu2_p_in_smem<<<dim3((tiles + ct - 1) / ct, qtiles, B * G), 128, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
