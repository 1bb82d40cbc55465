// Flash attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` in
// mlx_audio_tpu/ops/pallas/flash_attention.py (entry `flash_attention`):
// o = softmax(scale * q k^T [masked]) v over q (B,H,T,D), k/v (B,H,S,D),
// full, or causal when T == S, streaming over key tiles so the (T, S) score
// matrix never reaches device memory.
//
// What bounds it on this card: at the Whisper encoder's shape (B = 4
// windows, H = 20, T = S = 1500, D = 64, bf16) the work is 4*B*H*T*S*D =
// 4.6e10 FLOP (47 us at 989 TFLOP/s) against 61 MB of q, k, v and o (18 us
// at 3.35 TB/s), so it is bound by compute: by the tensor cores for bf16,
// by the CUDA cores (67 TFLOP/s) for float32.
//
// What the design does about it:
// - bf16 runs both products on the tensor cores with mma.sync m16n8k16
//   (float32 accumulators). A block of 4 warps owns 64 queries, each warp
//   16 rows; q fragments stay in registers for the whole key loop, and the
//   probabilities go from the score accumulators straight into the A
//   operand of the PV product without touching shared memory.
// - float32 uses CUDA-core FMAs on 64 x 64 tiles staged in shared memory,
//   each thread a 4 x 4 block of scores and a 4 x (D/16) block of the
//   output.
// - Both walk the keys in tiles of 64 with a float32 running max, sum and
//   accumulator, mask the ragged edge (key >= S) inside the kernel, and in
//   the causal case stop at the diagonal tile.
// A later version can overlap loads with compute (TMA, cp.async) and move
// to wgmma; this one is the simple, correct baseline.
//
// Semantics that match the TPU kernel exactly: q is multiplied by `scale`
// in the input dtype before the first product; masked scores are -1e30, not
// -inf; p is rounded to v's dtype before the PV product while the row sum
// uses the unrounded p; the output is acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per tile
constexpr float MASKED = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, T, S, D;
  long long sq[3], sk[3], sv[3], so[3];  // batch, head, row strides (elements)
  float scale;
  int causal;
};

__device__ __forceinline__ int num_key_tiles(const Params& p, int q0) {
  int n = (p.S + BK - 1) / BK;
  if (p.causal) n = min(n, (q0 + BQ - 1) / BK + 1);
  return n;
}

__device__ __forceinline__ bool masked(const Params& p, int qrow, int kcol) {
  return kcol >= p.S || (p.causal && kcol > qrow);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int DMAX>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int DP = DMAX + 4;  // padded smem row of Qs/Ks (floats)
  constexpr int PP = BK + 4;    // padded smem row of Ps
  constexpr int NG = DMAX / 64; // float4 output column groups per thread
  constexpr int VPR = DMAX / 4; // float4 vectors per row
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [BQ][DP]
  float* Ks = Qs + BQ * DP;                       // [BK][DP]
  float* Vs = Ks + BK * DP;                       // [BK][DMAX]
  float* Ps = Vs + BK * DMAX;                     // [BQ][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[1];
  float* og = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1];

  for (int idx = tid; idx < BQ * VPR; idx += 256) {
    const int r = idx / VPR, c = (idx % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.T && c < p.D) {
      val = *reinterpret_cast<const float4*>(qg + (q0 + r) * p.sq[2] + c);
      val.x *= p.scale; val.y *= p.scale; val.z *= p.scale; val.w *= p.scale;
    }
    *reinterpret_cast<float4*>(Qs + r * DP + c) = val;
  }

  float m_i[4], l_i[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = MASKED;
    l_i[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  const int nkb = num_key_tiles(p, q0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * VPR; idx += 256) {
      const int r = idx / VPR, c = (idx % VPR) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.S && c < p.D) {
        kv = *reinterpret_cast<const float4*>(kg + (k0 + r) * p.sk[2] + c);
        vv = *reinterpret_cast<const float4*>(vg + (k0 + r) * p.sv[2] + c);
      }
      *reinterpret_cast<float4*>(Ks + r * DP + c) = kv;
      *reinterpret_cast<float4*>(Vs + r * DMAX + c) = vv;
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

    // online softmax; a row's 64 scores live in the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty + 16 * i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (masked(p, qrow, k0 + tx + 16 * j)) s[i][j] = MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_new);
        rs += pj;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
    }
    __syncthreads();

    // acc[rows ty + 16 i][cols g*64 + tx*4 + c] += P V
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PP + kk);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float4 vr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vr[u] = *reinterpret_cast<const float4*>(Vs + (kk + u) * DMAX + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pw[4] = {pr[i].x, pr[i].y, pr[i].z, pr[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i][g][0] = fmaf(pw[u], vr[u].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pw[u], vr[u].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pw[u], vr[u].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pw[u], vr[u].w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= p.T) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = g * 64 + tx * 4;
      if (d < p.D)
        *reinterpret_cast<float4*>(og + qrow * p.so[2] + d) = make_float4(
            acc[i][g][0] / l, acc[i][g][1] / l, acc[i][g][2] / l, acc[i][g][3] / l);
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
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int RS = DMAX + 8;   // padded smem row of Qs/Ks (bf16)
  constexpr int VS = BK + 8;     // padded smem row of Vt (bf16)
  constexpr int KC = DMAX / 16;  // k-chunks of the QK^T product
  constexpr int NO = DMAX / 8;   // n-tiles of the output
  constexpr int VPR = DMAX / 8;  // 16-byte vectors per row
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [BQ][RS]
  __nv_bfloat16* Ks = Qs + BQ * RS;                               // [BK][RS]
  __nv_bfloat16* Vt = Ks + BK * RS;                               // [DMAX][VS], V transposed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.sv[0] + h * p.sv[1];
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] + h * p.so[1];

  // q * scale, rounded to bf16 as the input-dtype multiply does
  for (int idx = tid; idx < BQ * VPR; idx += 128) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.T && c < p.D) {
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.sq[2] + c);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        h2[e] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
      }
    }
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
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  const int qrow0 = q0 + qr, qrow1 = qrow0 + 8;

  const int nkb = num_key_tiles(p, q0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // every warp is done with the previous Ks / Vt
    for (int idx = tid; idx < BK * VPR; idx += 128) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.S && c < p.D) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.sk[2] + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.sv[2] + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * RS + c) = kv;
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

    float mx0 = MASKED, mx1 = MASKED;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (masked(p, e < 2 ? qrow0 : qrow1, k0 + nt * 8 + t * 2 + (e & 1)))
          s[nt][e] = MASKED;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // a row's scores live in the 4 lanes sharing g
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);

    // p in the A-operand layout of the PV product: chunk kc covers key
    // n-tiles 2kc (registers 0, 1) and 2kc + 1 (registers 2, 3)
    uint32_t pf[BK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = expf(s[nt][0] - mn0), p1 = expf(s[nt][1] - mn0);
      const float p2 = expf(s[nt][2] - mn1), p3 = expf(s[nt][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;

#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      o[dn][0] *= a0; o[dn][1] *= a0;
      o[dn][2] *= a1; o[dn][3] *= a1;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        mma_bf16(o[dn], pf[kc], ld32(Vt + (dn * 8 + g) * VS + kc * 16 + t * 2),
                 ld32(Vt + (dn * 8 + g) * VS + kc * 16 + 8 + t * 2));
    }
  }

  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) {
    const int d = dn * 8 + t * 2;
    if (d >= p.D) continue;
    if (qrow0 < p.T)
      *reinterpret_cast<__nv_bfloat162*>(og + qrow0 * p.so[2] + d) =
          __floats2bfloat162_rn(o[dn][0] / L0, o[dn][1] / L0);
    if (qrow1 < p.T)
      *reinterpret_cast<__nv_bfloat162*>(og + qrow1 * p.so[2] + d) =
          __floats2bfloat162_rn(o[dn][2] / L1, o[dn][3] / L1);
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
size_t smem_f32() {
  return sizeof(float) * (2 * BQ * (DMAX + 4) + BK * DMAX + BQ * (BK + 4));
}

template <int DMAX>
size_t smem_bf16() {
  return sizeof(__nv_bfloat16) * (2 * BQ * (DMAX + 8) + DMAX * (BK + 8));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int T, int S, int D,
    long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt,
    long long sob, long long soh, long long sot,
    float scale, int causal, int dtype, void* stream) {
  Params p{q, k, v, o, B, H, T, S, D,
           {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt}, {sob, soh, sot},
           scale, causal};
  if (D < 1 || D > 128 || B * H > 65535 || B < 0 || H < 0 || T < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * H == 0 || T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch(flash_fwd_f32<64>, p, 256, smem_f32<64>(), st)
                   : launch(flash_fwd_f32<128>, p, 256, smem_f32<128>(), st);
  if (dtype == 1)
    return D <= 64 ? launch(flash_fwd_bf16<64>, p, 128, smem_bf16<64>(), st)
                   : launch(flash_fwd_bf16<128>, p, 128, smem_bf16<128>(), st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
