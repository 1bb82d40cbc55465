// The ReLU² attention source as it stood before the bf16 path was redesigned
// (float32: score pass + PV pass; bf16: one mma.sync launch, E tiled over the
// grid, scores recomputed per column tile, V transposed by scalar shared
// stores), kept only as the bf16 baseline for
// scripts/torch_kernel_variants.py; the port does not build it. Its C
// interface is the current one; its bf16 path reads no scratch.
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
// What bounds it on this card: MossFormer2-SE calls it once per FLASH layer
// on v;u together (E = 2 x 1024). At the 20 s shape (B = 1, G = 10,
// N = 256, D = 128, E = 2048) the work is 2*B*G*N*N*(D+E) = 2.85 GFLOP
// against 44.6 MB of q, k, v and out in float32. At the H100 SXM data
// sheet's peaks that is 42.6 us of CUDA-core FMAs (67 TFLOP/s) against
// 13.3 us of memory (3.35 TB/s), so float32 is bound by operations; bf16
// (22.3 MB, 6.7 us; 2.9 us on the tensor cores) by bytes.
//
// What the design does about it:
// - The TPU kernel holds the whole (N, N) float32 score tile in VMEM; at
//   N = 256 that is 256 KB, more than an SM's shared memory.
// - float32 runs on CUDA cores (TF32 would break float32 parity) in two
//   launches. The score pass computes each weight once, 32 x 32 tiles of
//   relu(q k^T / g)^2, into a scratch (B*G*np*np floats, np = N rounded up
//   to 64: 2.6 MB at G = 10) that stays in L2, transposed so the next pass
//   reads it in 16-byte pieces. The PV pass is a register-blocked GEMM:
//   8 x 8 outputs a thread (four 16-byte shared loads per 64 FMAs), 64
//   queries by 64 columns a block of 64 threads (G = 2 and E = 2048: 256
//   blocks; G = 10: 1,280, several a SM), with keys staged 16 at a time
//   through a ring of three by cp.async under the FMAs. One launch that
//   tiles E over the grid recomputes the scores for every column tile: at
//   E = 1024 it spends as many FMAs on scores as on PV.
// - bf16 runs both products on the tensor cores with mma.sync m16n8k16
//   (float32 accumulators) in one launch: a block owns 64 queries and 128
//   output columns, streams key tiles of 64 and recomputes its scores per
//   column tile; the weights go from the score accumulators straight into
//   the A operand of the PV product. With no softmax the partial products
//   of the key tiles simply add up: no running max, no rescale.
// - The ragged edges (query, key >= N; columns >= E) are zero-filled and
//   masked in the kernels, so every N is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // bf16: queries per block
constexpr int BK = 64;   // bf16: keys per tile
constexpr int BE = 128;  // bf16: output columns per block

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
// float32: CUDA cores, a score pass and a PV pass
// ---------------------------------------------------------------------------

constexpr int NPAD = 64;     // the scratch pads N to a multiple of this
constexpr int ST = 32;       // queries and keys per score block
constexpr int SI = 4;        // queries per score thread
constexpr int SJ = 2;        // keys per score thread
constexpr int PM = 64;       // queries per PV block
constexpr int PN = 64;       // output columns per PV block, one thread each
constexpr int PK = 16;       // keys per PV stage
constexpr int PSTAGES = 3;   // the PV block's ring of (P, V) stages

// 16 bytes global -> shared without registers; with ok false it writes
// zeros and reads nothing (src must still be a valid address)
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

// Pass 1: the weights relu(q k^T / group_size)^2 of one (batch, group), ST
// queries by ST keys a block, SI x SJ a thread, written transposed,
// pt[key][query] with rows of np floats, so that the PV pass reads them in
// 16-byte pieces. Keys past N get weight 0; queries past N read zero q rows.
template <int DMAX>
__global__ void __launch_bounds__(ST * ST / (SI * SJ))
    relu2_scores_f32(Params p, float* pt, int np) {
  constexpr int NT = ST * ST / (SI * SJ);  // threads
  constexpr int TI = ST / SI, TJ = ST / SJ;  // threads along the queries, the keys
  constexpr int DP = DMAX + 4;      // padded smem row of Qs/Ks (floats)
  constexpr int TP = ST + 4;        // padded smem row of Ts
  constexpr int VPR = DMAX / 4;     // float4 vectors per q/k row
  static_assert(TP <= DP, "Ts reuses Ks");
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [ST][DP]
  float* Ks = Qs + ST * DP;                       // [ST][DP]
  float* Ts = Ks;                                 // [ST][TP], the tile transposed

  const int tid = threadIdx.x, tx = tid % TJ, ty = tid / TJ;
  const int q0 = blockIdx.x * ST, k0 = blockIdx.y * ST;
  const int b = blockIdx.z / p.G, g = blockIdx.z % p.G;
  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + g * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + g * p.sk[1];

  for (int idx = tid; idx < ST * VPR; idx += NT) {
    const int r = idx / VPR, c = (idx % VPR) * 4;
    const bool okq = q0 + r < p.N && c < p.D, okk = k0 + r < p.N && c < p.D;
    cp_async16(Qs + r * DP + c, okq ? qg + (q0 + r) * p.sq[2] + c : qg, okq);
    cp_async16(Ks + r * DP + c, okk ? kg + (k0 + r) * p.sk[2] + c : kg, okk);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // scores for queries ty + TI i, keys tx + TJ j
  float s[SI][SJ];
#pragma unroll
  for (int i = 0; i < SI; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DMAX; d += 4) {
    float4 qa[SI], ka[SJ];
#pragma unroll
    for (int i = 0; i < SI; ++i)
      qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + TI * i) * DP + d);
#pragma unroll
    for (int j = 0; j < SJ; ++j)
      ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + TJ * j) * DP + d);
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
        s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
        s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
        s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
      }
  }
  __syncthreads();  // every thread is done with Ks, which Ts reuses
#pragma unroll
  for (int i = 0; i < SI; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j)
      Ts[(tx + TJ * j) * TP + ty + TI * i] = relu2(s[i][j], p, k0 + tx + TJ * j);
  __syncthreads();
  float* out = pt + static_cast<long long>(blockIdx.z) * np * np;
  for (int idx = tid; idx < ST * ST / 4; idx += NT) {
    const int r = idx / (ST / 4), c = (idx % (ST / 4)) * 4;
    *reinterpret_cast<float4*>(out + static_cast<long long>(k0 + r) * np + q0 + c) =
        *reinterpret_cast<const float4*>(Ts + r * TP + c);
  }
}

// Pass 2: out = P V for one (batch, group), a register-blocked GEMM: a block
// of PN threads owns PM = 64 queries by PN columns, each thread 8 by 8 (rows
// 4 ty .. +3 and 32 + 4 ty .. +3, columns 4 tx .. +3 and PN / 2 + 4 tx ..
// +3), so that a key costs a thread four 16-byte shared loads for 64 FMAs.
// Keys come in stages of 16 through a ring of three, copied with cp.async
// while the FMAs of the stage before run. V rows past N and columns past E
// are zero-filled; each output sums its keys in order.
__global__ void __launch_bounds__(PN) relu2_pv_f32(Params p, const float* pt, int np) {
  constexpr int TX = PN / 8;  // threads along the columns
  __shared__ __align__(16) float As[PSTAGES][PK][PM];  // P^T stage: keys by queries
  __shared__ __align__(16) float Bs[PSTAGES][PK][PN];  // V stage: keys by columns
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int e0 = blockIdx.x * PN, q0 = blockIdx.y * PM;
  const int b = blockIdx.z / p.G, g = blockIdx.z % p.G;
  const float* at = pt + static_cast<long long>(blockIdx.z) * np * np + q0;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + g * p.sv[1] + e0;
  float* og = static_cast<float*>(p.o) + b * p.so[0] + g * p.so[1] + e0;
  const int ne = min(PN, p.E - e0);  // this block's columns, a multiple of 4
  const int nk = np / PK;

  auto load = [&](int kt) {
    const int k0 = kt * PK, st = kt % PSTAGES;
#pragma unroll
    for (int i = 0; i < PK * PM / 4 / PN; ++i) {
      const int idx = tid + PN * i, r = idx / (PM / 4), c = (idx % (PM / 4)) * 4;
      cp_async16(&As[st][r][c], at + static_cast<long long>(k0 + r) * np + c, true);
    }
#pragma unroll
    for (int i = 0; i < PK / 4; ++i) {
      const int idx = tid + PN * i, r = idx / (PN / 4), c = (idx % (PN / 4)) * 4;
      const bool ok = k0 + r < p.N && c < ne;
      cp_async16(&Bs[st][r][c], ok ? vg + (k0 + r) * p.sv[2] + c : vg, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int kt = 0; kt < PSTAGES - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<PSTAGES - 2>();  // stage kt has landed
    __syncthreads();               // for every thread; stage kt - 1 is free
    if (kt + PSTAGES - 1 < nk) load(kt + PSTAGES - 1);
    cp_async_commit();
    const int st = kt % PSTAGES;
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[st][kk][32 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[st][kk][PN / 2 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + (i < 4 ? 4 * ty + i : 32 + 4 * ty + i - 4);
    if (q >= p.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = PN / 2 * h + 4 * tx;
      if (c < ne)
        *reinterpret_cast<float4*>(og + q * p.so[2] + c) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
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
size_t smem_scores() {
  return sizeof(float) * 2 * ST * (DMAX + 4);
}

template <int DMAX>
size_t smem_bf16() {
  return sizeof(__nv_bfloat16) * ((BQ + BK) * (DMAX + 8) + BE * (BK + 8));
}

// the score pass, then the PV pass, on one stream; pt holds the weights
template <int DMAX>
int launch_f32(const Params& p, int BG, float* pt, cudaStream_t stream) {
  const int np = (p.N + NPAD - 1) / NPAD * NPAD;
  const size_t smem = smem_scores<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(relu2_scores_f32<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  relu2_scores_f32<DMAX><<<dim3(np / ST, np / ST, BG), ST * ST / (SI * SJ), smem, stream>>>(
      p, pt, np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  relu2_pv_f32<<<dim3((p.E + PN - 1) / PN, np / PM, BG), PN, 0, stream>>>(p, pt, np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. float32 needs `scratch`, room for
// B*G*np*np floats with np = N rounded up to a multiple of 64 (the weights
// between the two passes); bfloat16 takes none. Returns a cudaError_t
// (0 = launched).
extern "C" int relu2_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* scratch,
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
      (N + ST - 1) / ST > 65535 || !(group_size > 0.f) || (dtype == 0 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch_f32<64>(p, B * G, scratch, st)
                   : launch_f32<128>(p, B * G, scratch, st);
  if (dtype == 1)
    return D <= 64 ? launch(relu2_fwd_bf16<64>, p, B * G, 128, smem_bf16<64>(), st)
                   : launch(relu2_fwd_bf16<128>, p, B * G, 128, smem_bf16<128>(), st);
  return static_cast<int>(cudaErrorInvalidValue);
}
