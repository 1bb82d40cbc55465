// The earlier ReLU² attention kernel (one launch, E tiled over the grid,
// scores recomputed per column tile), kept only as a baseline for
// scripts/torch_kernel_variants.py; the port does not build it. Its C
// interface has no scratch argument.
//
// ReLU² attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_relu2_kernel` in
// mlx_audio_tpu/ops/pallas/relu2_attention.py (entry `relu2_attention`),
// MossFormer2's quadratic branch:
//   out[b,g] = cast_v(relu(q[b,g] k[b,g]^T / group_size)^2) v[b,g]
// over q/k (B,G,N,D) and v (B,G,N,E). The scores and the PV sums are
// float32; the weights are rounded to v's dtype before the PV product; the
// output is in v's dtype.
//
// What bounds it on this card: at MossFormer2-SE's 20 s shape (B = 1,
// G = 10, N = 256, D = 128, E = 1024) the work is 2*B*G*N*N*(D+E) =
// 1.51 GFLOP against 23.6 MB of q, k, v and out in float32. At the H100
// SXM data sheet's peaks that is 22.5 us of CUDA-core FMAs (67 TFLOP/s)
// against 7.0 us of memory (3.35 TB/s), so float32 is bound by operations;
// bf16 (11.8 MB, 3.5 us; 1.5 us on the tensor cores) by bytes.
//
// What the design does about it:
// - The TPU kernel holds the whole (N, N) float32 score tile in VMEM; at
//   N = 256 that is 256 KB, more than an SM's shared memory. This kernel
//   streams key tiles of 64. With no softmax the partial products of the
//   tiles simply add up: no running max, no rescale, no final divide.
// - E = 1024 float32 accumulators for a block of queries do not fit in
//   registers, so E is tiled over the grid: a block owns 64 queries and 128
//   output columns and recomputes the 64 x N scores for its columns. That
//   costs E/128 = 8 score passes (QK^T is 1/9 of the work, so the total is
//   16/9 of it), but it gives every (batch, group) 32 blocks: MossFormer2's
//   4 s chunks have only two groups, and holding p in shared memory for all
//   of E would leave them 8 blocks for 132 SMs.
// - bf16 runs both products on the tensor cores with mma.sync m16n8k16
//   (float32 accumulators); the weights go from the score accumulators
//   straight into the A operand of the PV product. float32 runs on CUDA
//   cores (TF32 would break float32 parity) on 64 x 64 score tiles staged
//   through shared memory.
// - The ragged edges (query, key >= N; columns >= E) are zero-filled and
//   masked in the kernel, so every N is taken.
// A later version can hold p across several column tiles, overlap loads
// with compute (cp.async, TMA) and move to wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int BE = 128;  // output columns per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int G, N, D, E;
  long long sq[3], sk[3], sv[3], so[3];  // batch, group, row strides (elements)
  float group_size;
};

// relu(s / group_size)^2, zero for a key past the ragged edge
__device__ __forceinline__ float relu2(float s, const Params& p, int key) {
  const float r = fmaxf(s / p.group_size, 0.f);
  return key < p.N ? r * r : 0.f;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int DMAX>
__global__ void __launch_bounds__(256) relu2_fwd_f32(Params p) {
  constexpr int DP = DMAX + 4;  // padded smem row of Qs/Ks (floats)
  constexpr int PP = BK + 4;    // padded smem row of Ps
  constexpr int NG = BE / 64;   // float4 output column groups per thread
  constexpr int VPR = DMAX / 4; // float4 vectors per q/k row
  constexpr int EPR = BE / 4;   // float4 vectors per v row
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [BQ][DP]
  float* Ks = Qs + BQ * DP;                       // [BK][DP]
  float* Vs = Ks + BK * DP;                       // [BK][BE]
  float* Ps = Vs + BK * BE;                       // [BQ][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int e0 = blockIdx.x * BE;
  const int q0 = blockIdx.y * BQ;
  const int b = blockIdx.z / p.G, g = blockIdx.z % p.G;
  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + g * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + g * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + g * p.sv[1] + e0;
  float* og = static_cast<float*>(p.o) + b * p.so[0] + g * p.so[1] + e0;
  const int ne = min(BE, p.E - e0);  // this block's columns, a multiple of 4

  for (int idx = tid; idx < BQ * VPR; idx += 256) {
    const int r = idx / VPR, c = (idx % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.N && c < p.D)
      val = *reinterpret_cast<const float4*>(qg + (q0 + r) * p.sq[2] + c);
    *reinterpret_cast<float4*>(Qs + r * DP + c) = val;
  }

  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int gr = 0; gr < NG; ++gr)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][gr][c] = 0.f;

  const int nkb = (p.N + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * VPR; idx += 256) {
      const int r = idx / VPR, c = (idx % VPR) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < p.N && c < p.D)
        kv = *reinterpret_cast<const float4*>(kg + (k0 + r) * p.sk[2] + c);
      *reinterpret_cast<float4*>(Ks + r * DP + c) = kv;
    }
    for (int idx = tid; idx < BK * EPR; idx += 256) {
      const int r = idx / EPR, c = (idx % EPR) * 4;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < p.N && c < ne)
        vv = *reinterpret_cast<const float4*>(vg + (k0 + r) * p.sv[2] + c);
      *reinterpret_cast<float4*>(Vs + r * BE + c) = vv;
    }
    __syncthreads();

    // scores for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = relu2(s[i][j], p, k0 + tx + 16 * j);
    __syncthreads();

    // acc[rows ty + 16 i][cols gr*64 + tx*4 + c] += P V
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PP + kk);
#pragma unroll
      for (int gr = 0; gr < NG; ++gr) {
        float4 vr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vr[u] = *reinterpret_cast<const float4*>(Vs + (kk + u) * BE + gr * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pw[4] = {pr[i].x, pr[i].y, pr[i].z, pr[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i][gr][0] = fmaf(pw[u], vr[u].x, acc[i][gr][0]);
            acc[i][gr][1] = fmaf(pw[u], vr[u].y, acc[i][gr][1]);
            acc[i][gr][2] = fmaf(pw[u], vr[u].z, acc[i][gr][2]);
            acc[i][gr][3] = fmaf(pw[u], vr[u].w, acc[i][gr][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= p.N) continue;
#pragma unroll
    for (int gr = 0; gr < NG; ++gr) {
      const int c = gr * 64 + tx * 4;
      if (c < ne)
        *reinterpret_cast<float4*>(og + qrow * p.so[2] + c) = make_float4(
            acc[i][gr][0], acc[i][gr][1], acc[i][gr][2], acc[i][gr][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16 row-major bf16) * b (16x8 col-major bf16), float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DMAX>
__global__ void __launch_bounds__(128) relu2_fwd_bf16(Params p) {
  constexpr int RS = DMAX + 8;   // padded smem row of Qs/Ks (bf16)
  constexpr int VS = BK + 8;     // padded smem row of Vt (bf16)
  constexpr int KC = DMAX / 16;  // k-chunks of the QK^T product
  constexpr int NO = BE / 8;     // n-tiles of the output
  constexpr int VPR = DMAX / 8;  // 16-byte vectors per q/k row
  constexpr int EPR = BE / 8;    // 16-byte vectors per v row
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [BQ][RS]
  __nv_bfloat16* Ks = Qs + BQ * RS;                               // [BK][RS]
  __nv_bfloat16* Vt = Ks + BK * RS;                               // [BE][VS], V transposed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = blockIdx.x * BE;
  const int q0 = blockIdx.y * BQ;
  const int b = blockIdx.z / p.G, grp = blockIdx.z % p.G;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.sq[0] + grp * p.sq[1];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.sk[0] + grp * p.sk[1];
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.sv[0] + grp * p.sv[1] + e0;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] + grp * p.so[1] + e0;
  const int ne = min(BE, p.E - e0);  // this block's columns, a multiple of 8

  for (int idx = tid; idx < BQ * VPR; idx += 128) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.N && c < p.D)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.sq[2] + c);
    *reinterpret_cast<uint4*>(Qs + r * RS + c) = val;
  }
  __syncthreads();

  const int qr = warp * 16 + g;  // this thread's rows in the tile: qr, qr + 8
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qf[kc][0] = ld32(Qs + qr * RS + kc * 16 + t * 2);
    qf[kc][1] = ld32(Qs + (qr + 8) * RS + kc * 16 + t * 2);
    qf[kc][2] = ld32(Qs + qr * RS + kc * 16 + 8 + t * 2);
    qf[kc][3] = ld32(Qs + (qr + 8) * RS + kc * 16 + 8 + t * 2);
  }

  float o[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  const int nkb = (p.N + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // every warp is done with the previous Ks / Vt
    for (int idx = tid; idx < BK * VPR; idx += 128) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.N && c < p.D)
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.sk[2] + c);
      *reinterpret_cast<uint4*>(Ks + r * RS + c) = kv;
    }
    for (int idx = tid; idx < BK * EPR; idx += 128) {
      const int r = idx / EPR, c = (idx % EPR) * 8;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.N && c < ne)
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.sv[2] + c);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * VS + r] = ve[e];
    }
    __syncthreads();

    // s[nt]: rows (qr, qr, qr+8, qr+8), keys k0 + nt*8 + t*2 + (0, 1, 0, 1)
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16(s[nt], qf[kc], ld32(Ks + (nt * 8 + g) * RS + kc * 16 + t * 2),
                 ld32(Ks + (nt * 8 + g) * RS + kc * 16 + 8 + t * 2));
    }

    // the weights in the A-operand layout of the PV product: chunk kc covers
    // key n-tiles 2kc (registers 0, 1) and 2kc + 1 (registers 2, 3)
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const int key = k0 + nt * 8 + t * 2;
      pf[nt >> 1][(nt & 1) * 2 + 0] =
          pack_bf16(relu2(s[nt][0], p, key), relu2(s[nt][1], p, key + 1));
      pf[nt >> 1][(nt & 1) * 2 + 1] =
          pack_bf16(relu2(s[nt][2], p, key), relu2(s[nt][3], p, key + 1));
    }

#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        mma_bf16(o[dn], pf[kc], ld32(Vt + (dn * 8 + g) * VS + kc * 16 + t * 2),
                 ld32(Vt + (dn * 8 + g) * VS + kc * 16 + 8 + t * 2));
  }

  const int qrow0 = q0 + qr, qrow1 = qrow0 + 8;
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) {
    const int c = dn * 8 + t * 2;
    if (c >= ne) continue;
    if (qrow0 < p.N)
      *reinterpret_cast<__nv_bfloat162*>(og + qrow0 * p.so[2] + c) =
          __floats2bfloat162_rn(o[dn][0], o[dn][1]);
    if (qrow1 < p.N)
      *reinterpret_cast<__nv_bfloat162*>(og + qrow1 * p.so[2] + c) =
          __floats2bfloat162_rn(o[dn][2], o[dn][3]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int BG, int threads, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.E + BE - 1) / BE, (p.N + BQ - 1) / BQ, BG);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
size_t smem_f32() {
  return sizeof(float) * ((BQ + BK) * (DMAX + 4) + BK * BE + BQ * (BK + 4));
}

template <int DMAX>
size_t smem_bf16() {
  return sizeof(__nv_bfloat16) * ((BQ + BK) * (DMAX + 8) + BE * (BK + 8));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int relu2_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int G, int N, int D, int E,
    long long sqb, long long sqg, long long sqn,
    long long skb, long long skg, long long skn,
    long long svb, long long svg, long long svn,
    long long sob, long long sog, long long son,
    float group_size, int dtype, void* stream) {
  Params p{q, k, v, o, G, N, D, E,
           {sqb, sqg, sqn}, {skb, skg, skn}, {svb, svg, svn}, {sob, sog, son},
           group_size};
  if (D < 1 || D > 128 || B < 0 || G < 1 || N < 0 || E < 0 || B * G > 65535 ||
      (N + BQ - 1) / BQ > 65535 || !(group_size > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch(relu2_fwd_f32<64>, p, B * G, 256, smem_f32<64>(), st)
                   : launch(relu2_fwd_f32<128>, p, B * G, 256, smem_f32<128>(), st);
  if (dtype == 1)
    return D <= 64 ? launch(relu2_fwd_bf16<64>, p, B * G, 128, smem_bf16<64>(), st)
                   : launch(relu2_fwd_bf16<128>, p, B * G, 128, smem_bf16<128>(), st);
  return static_cast<int>(cudaErrorInvalidValue);
}
