// The earlier flash attention source, whose float32 kernel (4 x 4 scores a
// thread on 64 x 64 tiles, K and V staged through registers, P through
// shared memory behind block barriers, an accurate expf a score) the port
// no longer builds. Kept only as a baseline for
// scripts/torch_kernel_variants.py (--flash32); its C interface is the
// port's.
//
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
// by the CUDA cores (67 TFLOP/s) for float32. At D = 64 the exponentials
// weigh as much as the products: the card's 16 ex2 a clock per SM match its
// tensor cores' 16 scores a clock (4*D FLOP each).
//
// What the design does about it:
// - bf16 (`flash_fwd_bf16`): a block of one producer warpgroup and NC
//   consumer warpgroups of 64 queries each: NC = 3 (192 queries) for
//   D <= 64, 2 for D <= 128, where the output needs twice the registers.
//   One producer thread keeps TMA loads in flight: the Q tile once, then
//   the K and V tiles of 128 keys through a ring of 4 (D <= 64) or 3
//   (D <= 128) slots guarded by mbarriers, each tile in 64-column boxes with
//   128-byte swizzle, read straight from the (B, H, L, D) view through a 4-d
//   tensor map (any strides; rows past L and columns past D arrive as
//   zeros). The consumers run S = Q K^T on wgmma m64n128k16 from shared
//   memory and the online softmax in registers with ex2; p, rounded to
//   bf16, stays in registers as the A operand of the PV wgmma, whose B
//   operand is the V tile read transposed by the descriptor, so nothing is
//   transposed by hand. Tile j's scores are computed while tile j - 1's PV
//   product runs, and the warpgroups take turns on the tensor cores (one's
//   products under another's softmax). setmaxnreg moves registers from the
//   producer to the consumers. Only the tiles at the end are masked: the
//   ragged edge of S, and past the diagonal when causal (the causal case
//   stops at the diagonal). At the Whisper shape 192-query blocks make 640
//   blocks, 4.8 waves of 132.
// - float32 (`flash_fwd_f32`) uses CUDA-core FMAs on 64 x 64 tiles staged
//   in shared memory, each thread a 4 x 4 block of scores and a 4 x (D/16)
//   block of the output; it masks the ragged edge per element.
//
// Semantics that match the TPU kernel: q is multiplied by `scale` in the
// input dtype before the first product; masked scores are -1e30, not -inf
// (TMA's zero fill of the ragged key tile is masked like any key >= S); p
// is rounded to v's dtype before the PV product while the row sum uses the
// unrounded p; the output is acc / max(l, 1e-30).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // float32: queries per block
constexpr int BK = 64;  // float32: keys per tile
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
// bf16: TMA, mbarriers and wgmma, one producer warp and two consumer
// warpgroups
// ---------------------------------------------------------------------------

constexpr int FA_WG = 128;       // threads of a warpgroup
constexpr int FA_BN = 128;       // keys per tile
constexpr int FA_ROW = 128;      // bytes of one 64-column row of a tile box
constexpr float LOG2E = 1.4426950408889634f;

// A block of NC consumer warpgroups (64 queries each) and one producer
// warpgroup. Its shared memory: the Q tile, then STAGES ring slots of a K
// and a V tile, then the barriers. Every tile is stored as DMAX / 64 boxes
// of 64 columns (128 bytes a row, 128-byte swizzle), each box 1024-byte
// aligned. Registers a thread: 40 or 32 for the producer, 232 or 160 for
// the consumers (NC = 2 or 3), 64K in all.
template <int DMAX>
struct Fa {
  static constexpr int NC = DMAX == 64 ? 3 : 2;
  static constexpr int BM = 64 * NC;  // queries per block
  static constexpr int THREADS = FA_WG * (NC + 1);
  static constexpr int PRODUCER_REGS = NC == 2 ? 40 : 32;
  static constexpr int CONSUMER_REGS = NC == 2 ? 232 : 160;
  static constexpr int BOXES = DMAX / 64;
  static constexpr int STAGES = DMAX == 64 ? 4 : 3;
  static constexpr int Q_BYTES = BM * DMAX * 2;
  static constexpr int KV_BYTES = FA_BN * DMAX * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  // 1024 bytes of slack to align the base; full[STAGES], empty[STAGES], q
  static constexpr size_t SMEM = 1024 + BAR_OFFSET + 8 * (2 * STAGES + 1);
};

struct FaOut {
  void* o;
  long long so[3];  // batch, head, row strides (elements)
  int H, T, S, D;
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a (D, L, H, B) tensor map into shared memory; rows past L and
// columns past D arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) = A (64 x 16) * B (16 x 128) [+ d if accumulate]; A and B are
// K-major tiles in shared memory (128-byte swizzle), read through descriptors
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64); B is an
// MN-major tile in shared memory (128-byte swizzle), read transposed
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128); B is an
// MN-major tile in shared memory (128-byte swizzle), read transposed
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DMAX>
__device__ __forceinline__ void wgmma_pv(float (&o)[DMAX / 2], const uint32_t* a, uint64_t db) {
  if constexpr (DMAX == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(Fa<DMAX>::THREADS, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const FaOut p) {
  using C = Fa<DMAX>;
  extern __shared__ uint8_t fa_raw[];
  uint8_t* smem = fa_raw + ((1024u - (smem_addr(fa_raw) & 1023u)) & 1023u);
  const uint32_t sq = smem_addr(smem), skv = sq + C::Q_BYTES, bars = sq + C::BAR_OFFSET;
  const uint32_t qbar = bars + 16 * C::STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };

  const int q0 = blockIdx.x * C::BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  int n_tiles = (p.S + FA_BN - 1) / FA_BN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + C::BM - 1) / FA_BN + 1);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * C::NC);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / FA_WG;
  if (wg == 0) {
    // producer: one thread keeps the ring of K/V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::BOXES; ++c)
        tma_load(sq + c * C::BM * FA_ROW, &tq, qbar, c * 64, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::STAGES;
        mbar_wait(empty(s), ((j / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), C::STAGE_BYTES);
        const uint32_t kdst = skv + s * C::STAGE_BYTES, vdst = kdst + C::KV_BYTES;
#pragma unroll
        for (int c = 0; c < C::BOXES; ++c) {
          tma_load(kdst + c * FA_BN * FA_ROW, &tk, full(s), c * 64, j * FA_BN, h, b);
          tma_load(vdst + c * FA_BN * FA_ROW, &tv, full(s), c * 64, j * FA_BN, h, b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int cw = wg - 1, t = threadIdx.x % FA_WG, lane = t & 31;
    const int g = lane >> 2, tq4 = lane & 3;
    const int r0 = q0 + cw * 64 + (t >> 5) * 16 + g, r1 = r0 + 8;  // this thread's rows
    const uint32_t sq_wg = sq + cw * 64 * FA_ROW;

    // q * scale, rounded to bf16 as the input-dtype multiply does, in place
    mbar_wait(qbar, 0);
    for (int i = t; i < C::BOXES * 512; i += FA_WG) {
      uint4* ptr = reinterpret_cast<uint4*>(smem + (i >> 9) * C::BM * FA_ROW + cw * 64 * FA_ROW +
                                            (i & 511) * 16);
      uint4 val = *ptr;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        h2[e] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
      }
      *ptr = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + cw), "n"(FA_WG) : "memory");

    float o[DMAX / 2], s[FA_BN / 2];
    uint32_t pr[FA_BN / 4];  // p as the A operand of the PV product
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.f;
    float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f, a0 = 1.f, a1 = 1.f;

    // s = (q * scale) k^T over the tile in ring slot `slot`
    auto qk = [&](int slot) {
      const uint32_t kt = skv + slot * C::STAGE_BYTES;
#pragma unroll
      for (int kc = 0; kc < DMAX / 16; ++kc) {
        const uint32_t col = (kc & 3) * 32;  // 16 columns of a 128-byte row
        wgmma_ss_n128(s, gmma_desc(sq_wg + (kc >> 2) * C::BM * FA_ROW + col, 16, 1024),
                      gmma_desc(kt + (kc >> 2) * FA_BN * FA_ROW + col, 16, 1024), kc > 0);
      }
    };
    // o += p v over the tile in ring slot `slot`; v is read transposed
    auto pv = [&](int slot) {
      const uint32_t vt = skv + slot * C::STAGE_BYTES + C::KV_BYTES;
#pragma unroll
      for (int kc = 0; kc < FA_BN / 16; ++kc)
        wgmma_pv<DMAX>(o, pr + 4 * kc, gmma_desc(vt + kc * 16 * FA_ROW, FA_BN * FA_ROW, 1024));
    };
    // online softmax of s in place: s becomes p (float32), the running max
    // and sum move on, and a0/a1 say how much the old accumulator shrinks.
    // Only the tiles at the end can hold masked keys: the ragged edge of S,
    // and in the causal case those past this warpgroup's first row.
    auto softmax = [&](int k0) {
      if (k0 + FA_BN > p.S || (p.causal && k0 + FA_BN - 1 > q0 + 64 * cw)) {
#pragma unroll
        for (int e = 0; e < FA_BN / 2; ++e) {
          const int key = k0 + (e >> 2) * 8 + tq4 * 2 + (e & 1);
          const int row = (e & 2) ? r1 : r0;
          if (key >= p.S || (p.causal && key > row)) s[e] = MASKED;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < FA_BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      // a row's scores live in the 4 lanes sharing g
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      a0 = ex2((m0 - mx0) * LOG2E);
      a1 = ex2((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
      const float b0 = mx0 * LOG2E, b1 = mx1 * LOG2E;
      float rs0 = 0.f, rs1 = 0.f;  // this thread's share of the row sums
#pragma unroll
      for (int j = 0; j < FA_BN / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], LOG2E, -b0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], LOG2E, -b0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], LOG2E, -b1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], LOG2E, -b1));
        rs0 += s[4 * j] + s[4 * j + 1];
        rs1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
    };
    // p rounded to bf16: the accumulator layout of s is the A-fragment
    // layout of the PV product, two keys a register
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < FA_BN / 4; ++i) pr[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(slot));
    };
    // The warpgroups take turns issuing their products, in a ring (named
    // barriers 4 ..), so that one's products run while another's softmax
    // does: left alone they fall into step and wait on the tensor cores
    // together. Warpgroup 0 goes first; each hands the turn on after
    // issuing, except the last warpgroup after its last products, whose
    // turn nobody takes.
    const int next = cw + 1 == C::NC ? 0 : cw + 1;
    auto turn_begin = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(4 + cw), "n"(2 * FA_WG)); };
    auto turn_end = [&](bool last) {
      if (next != 0 || !last) asm volatile("bar.arrive %0, %1;\n" ::"r"(4 + next), "n"(2 * FA_WG));
    };
    if (next == 0) asm volatile("bar.arrive %0, %1;\n" ::"r"(4), "n"(2 * FA_WG));

    mbar_wait(full(0), 0);
    turn_begin();
    wgmma_fence();
    qk(0);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    pack();
    // tile j's scores are computed while tile j - 1's PV product runs
    for (int j = 1; j < n_tiles; ++j) {
      const int slot = j % C::STAGES, prev = (j - 1) % C::STAGES;
      mbar_wait(full(slot), (j / C::STAGES) & 1);
      fence_regs(o);
      turn_begin();
      wgmma_fence();
      qk(slot);
      wgmma_commit();
      pv(prev);
      wgmma_commit();
      turn_end(false);
      wgmma_wait<1>();
      fence_regs(s);
      softmax(j * FA_BN);
      wgmma_wait<0>();
      fence_regs(o);
      release(prev);
#pragma unroll
      for (int j2 = 0; j2 < DMAX / 8; ++j2) {
        o[4 * j2] *= a0;
        o[4 * j2 + 1] *= a0;
        o[4 * j2 + 2] *= a1;
        o[4 * j2 + 3] *= a1;
      }
      pack();
    }
    fence_regs(o);
    turn_begin();
    wgmma_fence();
    pv((n_tiles - 1) % C::STAGES);
    wgmma_commit();
    turn_end(true);
    wgmma_wait<0>();
    fence_regs(o);
    release((n_tiles - 1) % C::STAGES);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] + h * p.so[1];
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int d = j * 8 + tq4 * 2;
      if (d >= p.D) continue;
      if (r0 < p.T)
        *reinterpret_cast<__nv_bfloat162*>(og + r0 * p.so[2] + d) =
            __floats2bfloat162_rn(o[4 * j] / L0, o[4 * j + 1] / L0);
      if (r1 < p.T)
        *reinterpret_cast<__nv_bfloat162*>(og + r1 * p.so[2] + d) =
            __floats2bfloat162_rn(o[4 * j + 2] / L1, o[4 * j + 3] / L1);
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API function, fetched through the
// runtime so that the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// (B, H, L, D) bf16 with element strides st[0..2] as a (D, L, H, B) map read
// in boxes of 64 columns x `rows` rows, 128-byte swizzle
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H, int L, int D,
            const long long (&st)[3], int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  // a dim of size 1 is never stepped over; give it a stride TMA accepts
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(L > 1 ? st[2] * 2 : 16),
                                 static_cast<cuuint64_t>(H > 1 ? st[1] * 2 : 16),
                                 static_cast<cuuint64_t>(B > 1 ? st[0] * 2 : 16)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DMAX>
int launch_bf16(const Params& p, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!encode(enc, &tq, p.q, p.B, p.H, p.T, p.D, p.sq, Fa<DMAX>::BM) ||
      !encode(enc, &tk, p.k, p.B, p.H, p.S, p.D, p.sk, FA_BN) ||
      !encode(enc, &tv, p.v, p.B, p.H, p.S, p.D, p.sv, FA_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Fa<DMAX>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const FaOut out{p.o, {p.so[0], p.so[1], p.so[2]}, p.H, p.T, p.S, p.D, p.scale, p.causal};
  const dim3 grid((p.T + Fa<DMAX>::BM - 1) / Fa<DMAX>::BM, p.B * p.H);
  flash_fwd_bf16<DMAX><<<grid, Fa<DMAX>::THREADS, smem, stream>>>(tq, tk, tv, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Params& p, cudaStream_t stream) {
  auto kernel = p.D <= 64 ? flash_fwd_f32<64> : flash_fwd_f32<128>;
  const int dmax = p.D <= 64 ? 64 : 128;
  const size_t smem = sizeof(float) * (2 * BQ * (dmax + 4) + BK * dmax + BQ * (BK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, 256, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 0) return launch_f32(p, st);
  if (dtype == 1) return D <= 64 ? launch_bf16<64>(p, st) : launch_bf16<128>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
