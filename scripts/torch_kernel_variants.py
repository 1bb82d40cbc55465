#!/usr/bin/env python3
"""Time edited copies of the port's redesigned kernels on one H100.

    python3 scripts/torch_kernel_variants.py [--flash] [--flash32] [--qmlp] [--qmm]
                                             [--qmm6] [--qmm_tiled] [--relu2]

Each variant is the kernel's source with a few lines replaced: a part of
the kernel taken out (its output is then wrong, and only its time counts)
or a design choice undone; or, for relu2 and flash32, the earlier kernel
kept in `scripts/baselines/`. Every variant is built with nvcc into its own
library under `build/variants/` (the ptxas registers and spills of the
kernel timed are printed, one line a variant) and timed beside the
unchanged source on the same inputs, in two rounds taken in turns (no
flag: all seven):

- flash: B=4 H=20 T=S=1500 D=64 bf16 from (B, T, H, D) views, CUDA events
  over 50 launches, with F.scaled_dot_product_attention as the yardstick;
- flash32: the same shape in float32, CUDA events over 20 launches, beside
  F.scaled_dot_product_attention in float32 and the earlier 4 x 4 kernel;
- qmlp: M=1 K=1024 I=3072 N=1024 int4 with f32 x, device time per call
  from torch.profiler with the weights cycled past L2, and once with one
  weight set every call (L2-hot);
- qmm: the GEMV at M=1 N=4096 K=1024 (the talker's q/k/v), M=1 N=1024
  K=2048 (o_proj) and M=2 N=4096 K=1024 (the code predictor's seed), int4
  with f32 x, device time per call with the weights cycled past L2; the
  tiled kernel, which served M <= 4 before the GEMV, is one variant;
- qmm6: the 6-bit GEMV at M=1 at the talker's four shapes (q/k/v N=4096
  K=1024, o_proj N=1024 K=2048, gate/up N=6144 K=1024, down N=1024
  K=3072), f32 x, as qmm; the tiled kernel, which served every 6-bit call
  before, is one variant (it stays in the source for M > 4);
- qmm_tiled: the tensor-core GEMM (M > 4) at the talker's four
  projections at the 32-row prefill bucket and the text projection at
  M=336, int4 and 6-bit, bf16 x (and f32 x at the 6-bit q/k/v and
  o_proj), device time per call with the weights
  cycled past L2; the tiled CUDA-core kernel (BM = 8), which served
  M > 4 before, is one variant;
- relu2: float32 and bf16, B=1 N=256 D=128 E=2048 at G=10 (a 20 s request)
  and G=2 (a 4 s chunk), device time per call (both launches), beside the
  plain version (two cuBLAS matmuls) and the earlier kernels (float32: the
  one-launch kernel; bf16: the one-launch kernel that tiles E).

It needs the card, nvcc and the checkout's `mlx_audio_tpu_torch/`.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from mlx_audio_tpu_torch.ops.cuda import _build  # noqa: E402
from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention_reference  # noqa: E402
from mlx_audio_tpu_torch.ops.cuda.quant_matmul import (  # noqa: E402
    quantized_matmul_reference, quantized_mlp_reference)
from mlx_audio_tpu_torch.ops.cuda.relu2_attention import (  # noqa: E402
    relu2_attention_reference, scratch_elems)

CSRC = REPO / "mlx_audio_tpu_torch" / "csrc"
BASELINES = REPO / "scripts" / "baselines"
OUT = REPO / "build" / "variants"

FLASH = {
    "as committed": [],
    "no ex2 (an FFMA)": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                          "  y = fmaf(x, 1e-3f, 0.5f);")],
    "no PV product": [("        wgmma_pv<DMAX>(o, pr + 4 * kc, gmma_desc(vt + kc * 16 * FA_ROW, "
                       "FA_BN * FA_ROW, 1024));", "        (void)vt;")],
    "K/V loaded once": [
        ("        mbar_expect_tx(full(s), C::STAGE_BYTES);",
         "        mbar_expect_tx(full(s), j < C::STAGES ? C::STAGE_BYTES : 0);"),
        ("        for (int c = 0; c < C::BOXES; ++c) {\n          tma_load(kdst",
         "        for (int c = 0; c < (j < C::STAGES ? C::BOXES : 0); ++c) {\n          tma_load(kdst")],
    "no turns": [
        ('auto turn_begin = [&]() { asm volatile("bar.sync %0, %1;\\n" ::"r"(4 + cw), '
         '"n"(2 * FA_WG)); };', "auto turn_begin = [&]() {};"),
        ('if (next != 0 || !last) asm volatile("bar.arrive %0, %1;\\n" ::"r"(4 + next), '
         '"n"(2 * FA_WG));', "(void)last;"),
        ('if (next == 0) asm volatile("bar.arrive %0, %1;\\n" ::"r"(4), "n"(2 * FA_WG));', "")],
    "2 ring slots": [("static constexpr int STAGES = DMAX == 64 ? 4 : 3;",
                      "static constexpr int STAGES = 2;")],
    "2 consumer warpgroups": [("static constexpr int NC = DMAX == 64 ? 3 : 2;",
                               "static constexpr int NC = 2;")],
}

QMLP = {
    "as committed": [],
    "phase A only": [("  // phase B: y = h . down^T\n", "  if (p.M > 0) return;\n")],
    "no barrier wait": [("  grid_wait(p.bar, gen, last);\n", "  __syncthreads();\n")],
    "no L2 prefetch": [
        ("  prefetch_l2<QTHREADS>(p.d.w + n0 * p.d.row_bytes, (n1 - n0) * p.d.row_bytes);\n", "")],
    "8 warps, 2 blocks a SM": [
        ("static constexpr int WARPS = BM == 1 ? 16 : 8;", "static constexpr int WARPS = 8;"),
        ("static constexpr int PER_SM = BM == 1 ? 1 : 2;", "static constexpr int PER_SM = 2;")],
}


# edits of the GEMV shared by the int4 and 6-bit sets
GEMV_DOT = ("    gemv_dot<BITS, BM, R, TX>(w, s, b, x + c * U::V, static_cast<int>(p.ldx), acc);")
X_STAGED = [
    ("  int c = sg * units / split + lane;\n  if (c < c1) load(c, w, s, b);\n"
     "  const TX* x = static_cast<const TX*>(p.x);\n",
     "  __shared__ __align__(16) float xsm[4 * 2048];\n"
     "  for (int i = threadIdx.x; i < BM * p.K; i += blockDim.x)\n"
     "    xsm[i] = to_float(static_cast<const TX*>(p.x)[(i / p.K) * p.ldx + i % p.K]);\n"
     "  __syncthreads();\n  const float* x = xsm;\n"
     "  int c = sg * units / split + lane;\n  if (c < c1) load(c, w, s, b);\n"),
    (GEMV_DOT, "    gemv_dot<BITS, BM, R, float>(w, s, b, x + c * U::V, p.K, acc);")]
SPLIT = ("  const int split = max(1, min(min(GEMV_MAX_SPLIT, (units + 31) / 32),\n"
         "                               GEMV_MAX_WARPS * GEMV_R / max(p.N, 1)));")
NO_SPLIT = [(SPLIT, "  const int split = 1;")]
SPLIT_ALWAYS = [(SPLIT, "  const int split = min(GEMV_MAX_SPLIT, (units + 31) / 32);")]
DEFAULT_BOUNDS = [("__global__ void __launch_bounds__(32 * GEMV_RW * GEMV_MAX_SPLIT, 1)\n",
                   "__global__ void __launch_bounds__(32 * GEMV_RW * GEMV_MAX_SPLIT)\n")]
EMPTY_GEMV = [("  using W = Words<U::WORDS>;\n", "  using W = Words<U::WORDS>;\n  if (p.N > 0) return;\n")]

QMM = {
    "as committed": [],
    "tiled kernel at M <= 4": [("  if (gemv_fits<BITS, TX>(p)) {",
                                "  if (false && gemv_fits<BITS, TX>(p)) {")],
    "4-byte loads": [("constexpr int GEMV_VEC = 2;", "constexpr int GEMV_VEC = 1;")],
    "16-byte loads": [("constexpr int GEMV_VEC = 2;", "constexpr int GEMV_VEC = 4;")],
    "x staged in shared memory first": X_STAGED,
    "no split-K": NO_SPLIT,
    "R = 1": [("constexpr int GEMV_R = 4;", "constexpr int GEMV_R = 1;")],
    "R = 2": [("constexpr int GEMV_R = 4;", "constexpr int GEMV_R = 2;")],
    "4 row-warps a block": [("constexpr int GEMV_RW = 2;", "constexpr int GEMV_RW = 4;")],
    "1 row-warp a block": [("constexpr int GEMV_RW = 2;", "constexpr int GEMV_RW = 1;")],
    "empty kernel": EMPTY_GEMV,
    "launch bounds without the floor of one block a SM": DEFAULT_BOUNDS,
    "no FMAs": [(GEMV_DOT,
                 "    acc[0][0] += __uint_as_float(w[0].w[0] ^ w[R - 1].w[U::WORDS - 1]) + s[0] "
                 "+ b[R - 1] + static_cast<float>(x[c]);")],
    "no weight loads": [("    for (int r = 0; r < R; ++r) w[r] = load_unit<BITS>(rows[r], c);",
                         "    for (int r = 0; r < R; ++r) w[r] = W{};")],
}

QMM6 = {
    "as committed": [],
    "tiled kernel at M <= 4": [("  if (gemv_fits<BITS, TX>(p)) {",
                             "  if (BITS != 6 && gemv_fits<BITS, TX>(p)) {")],
    "8 + 4 bytes by the unit's parity": [
        ("    r.w[0] = __ldg(wp);\n    r.w[1] = __ldg(wp + 1);\n    r.w[2] = __ldg(wp + 2);\n",
         "    const int odd = c & 1;\n"
         "    const uint2 pair = __ldg(reinterpret_cast<const uint2*>(wp + odd));\n"
         "    const uint32_t one = __ldg(wp + (odd ? 0 : 2));\n"
         "    r.w[0] = odd ? one : pair.x;\n    r.w[1] = odd ? pair.x : pair.y;\n"
         "    r.w[2] = odd ? pair.y : one;\n"),
        ("static constexpr int ALIGN = BITS != 6 ? 4 * GEMV_VEC : 4;",
         "static constexpr int ALIGN = BITS != 6 ? 4 * GEMV_VEC : 8;")],
    "three 4-byte loads kept out of L1": [
        ("    r.w[0] = __ldg(wp);\n    r.w[1] = __ldg(wp + 1);\n    r.w[2] = __ldg(wp + 2);\n",
         "".join(f'    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r.w[{i}]) '
                 f': "l"(wp + {i}));\n' for i in range(3)))],
    "48-byte units (a group of 64)": [
        ("static constexpr int WORDS = BITS == 6 ? 3 : GEMV_VEC;",
         "static constexpr int WORDS = BITS == 6 ? 12 : GEMV_VEC;"),
        ("static constexpr int ALIGN = BITS != 6 ? 4 * GEMV_VEC : 4;",
         "static constexpr int ALIGN = BITS != 6 ? 4 * GEMV_VEC : 16;"),
        ("    const uint32_t* wp = reinterpret_cast<const uint32_t*>(row) + 3 * c;\n"
         "    Words<3> r;\n"
         "    r.w[0] = __ldg(wp);\n    r.w[1] = __ldg(wp + 1);\n    r.w[2] = __ldg(wp + 2);\n",
         "    const uint4* vp = reinterpret_cast<const uint4*>(row) + 3 * c;\n"
         "    Words<12> r;\n"
         "    for (int i = 0; i < 3; ++i) {\n"
         "      const uint4 t = __ldg(vp + i);\n"
         "      r.w[4 * i] = t.x; r.w[4 * i + 1] = t.y; r.w[4 * i + 2] = t.z; r.w[4 * i + 3] = t.w;\n"
         "    }\n"),
        ("    unit_dot6<BM, R>(w, 0, s, b, xc, ldx, acc);",
         "    for (int ch = 0; ch < 4; ++ch) unit_dot6<BM, R>(w, ch, s, b, xc + 16 * ch, ldx, acc);")],
    "no split-K": NO_SPLIT,
    "split-K at every N": SPLIT_ALWAYS,
    "x staged in shared memory first": X_STAGED,
    "launch bounds without the floor of one block a SM": DEFAULT_BOUNDS,
    "empty kernel": EMPTY_GEMV,
}

FLASH32_SKIP = "    if (wr0 >= p.T || (p.causal && k0 > wr0 + C::WR - 1)) continue;\n"
FLASH32 = {
    "as committed": [],
    "earlier kernel (4 x 4, expf, block barriers)": BASELINES / "flash_attention_f32_4x4.cu",
    "4 x 4 register blocks": [
        ("static constexpr int RI = DMAX == 64 ? 8 : 4;", "static constexpr int RI = 4;"),
        ("static constexpr int KJ = 8; ", "static constexpr int KJ = 4; ")],
    "no copy under the FMAs": [
        ("    if (kt + 1 < n_tiles) load_kv(kt + 1);\n    cp_async_commit();\n",
         "    if (kt + 1 < n_tiles) load_kv(kt + 1);\n    cp_async_commit();\n"
         "    cp_async_wait<0>();\n")],
    "block barriers for P, not __syncwarp": [
        (FLASH32_SKIP, ""),
        ("    __syncwarp();\n#pragma unroll\n    for (int j = 0; j < KJ; ++j)",
         "    __syncthreads();\n#pragma unroll\n    for (int j = 0; j < KJ; ++j)"),
        ("    __syncwarp();\n\n    // o = alpha o", "    __syncthreads();\n\n    // o = alpha o")],
    "accurate exp2f for ex2.approx": [
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "  y = exp2f(x);")],
    "no ex2 (an FFMA)": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                          "  y = fmaf(x, 1e-3f, 0.5f);")],
    "no S product": [("    for (int d = 0; d < DMAX; d += 4) {",
                      "    for (int d = 0; d < (p.S < 0 ? DMAX : 0); d += 4) {")],
    "S: K read a key at a time": [(
        "      float4 qa[RI], ka[KJ];\n"
        "#pragma unroll\n"
        "      for (int i = 0; i < RI; ++i) qa[i] = *reinterpret_cast<const float4*>(qs + i * DP + d);\n"
        "#pragma unroll\n"
        "      for (int j = 0; j < KJ; ++j)\n"
        "        ka[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * DP + d);\n"
        "#pragma unroll\n"
        "      for (int i = 0; i < RI; ++i)\n"
        "#pragma unroll\n"
        "        for (int j = 0; j < KJ; ++j) {\n"
        "          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);\n"
        "          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);\n"
        "          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);\n"
        "          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);\n"
        "        }\n",
        "      float4 qa[RI];\n"
        "#pragma unroll\n"
        "      for (int i = 0; i < RI; ++i) qa[i] = *reinterpret_cast<const float4*>(qs + i * DP + d);\n"
        "#pragma unroll\n"
        "      for (int j = 0; j < KJ; ++j) {\n"
        "        const float4 kj = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * DP + d);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < RI; ++i) {\n"
        "          s[i][j] = fmaf(qa[i].x, kj.x, s[i][j]);\n"
        "          s[i][j] = fmaf(qa[i].y, kj.y, s[i][j]);\n"
        "          s[i][j] = fmaf(qa[i].z, kj.z, s[i][j]);\n"
        "          s[i][j] = fmaf(qa[i].w, kj.w, s[i][j]);\n"
        "        }\n"
        "      }\n")],
    "PV loop unrolled 4": [("#pragma unroll 8\n    for (int kk = 0; kk < BK; ++kk) {",
                            "#pragma unroll 4\n    for (int kk = 0; kk < BK; ++kk) {")],
    "no PV product": [("    for (int kk = 0; kk < BK; ++kk) {",
                       "    for (int kk = 0; kk < (p.S < 0 ? BK : 0); ++kk) {")],
    "6 warps a block (192 queries)": [("static constexpr int WARPS = DMAX == 64 ? 8 : 4;",
                                       "static constexpr int WARPS = DMAX == 64 ? 6 : 4;")],
    "4 warps a block (128 queries)": [("static constexpr int WARPS = DMAX == 64 ? 8 : 4;",
                                       "static constexpr int WARPS = 4;")],
}

RELU2 = {
    "as committed": [],
    "earlier kernel (E tiled, scores per column tile)": BASELINES / "relu2_attention_tiled_e.cu",
    "one launch, P of 64 queries in shared memory": BASELINES / "relu2_attention_p_in_smem.cu",
    "no copy under the FMAs": [("    cp_async_commit();\n    const int st = kt % PSTAGES;",
                                "    cp_async_commit();\n    cp_async_wait<0>();\n"
                                "    const int st = kt % PSTAGES;")],
    "2 stages": [("constexpr int PSTAGES = 3;", "constexpr int PSTAGES = 2;")],
    "64 x 64 score tiles": [("constexpr int ST = 32;", "constexpr int ST = 64;")],
    "4 x 4 scores a thread": [("constexpr int SJ = 2;", "constexpr int SJ = 4;")],
    "2 x 2 scores a thread": [("constexpr int SI = 4;", "constexpr int SI = 2;")],
    "PV 128 columns a block": [("constexpr int PN = 64;", "constexpr int PN = 128;")],
    "PV 32 keys a stage": [("constexpr int PK = 16;", "constexpr int PK = 32;")],
    "score pass only": [("  relu2_pv_f32<<<", "  if (p.N < 0) relu2_pv_f32<<<")],
}
MMA_LOOP_COMMIT = ("    if (kt + MMA_STAGES - 1 < ke) load_stage(kt + MMA_STAGES - 1);\n"
                   "    cp_async_commit();\n")
QMM_TILED = {
    "as committed": [],
    "the tiled CUDA-core kernel (qmm_kernel, BM = 8)": [("  if (mma_fits<BITS, TX>(p)) {",
                                                  "  if (false && mma_fits<BITS, TX>(p)) {")],
    "codes rounded as w = q s + b": [
        ("__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t lo, uint32_t hi, float s, "
         "float b) {\n",
         "__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t lo, uint32_t hi, float s, "
         "float b) {\n  if (s == s) {\n    __nv_bfloat162 w = __floats2bfloat162_rn("
         "fmaf(static_cast<float>(lo), s, b), fmaf(static_cast<float>(hi), s, b));\n"
         "    return *reinterpret_cast<uint32_t*>(&w);\n  }\n"),
        ("  acc = fmaf(s, gacc, fmaf(b, xg, acc));", "  acc += gacc;")],
    "64 rows of x a block at M <= 32": [
        ("    if (p.M <= 32 && wide * MMA_MAX_SPLITS >= sms) return launch_mma<BITS, 1, 4, TX>",
         "    if (p.M <= 32 && wide * MMA_MAX_SPLITS >= sms) return launch_mma<BITS, 2, 4, TX>")],
    "no copy in flight under the products": [
        (MMA_LOOP_COMMIT, MMA_LOOP_COMMIT + "    cp_async_wait<0>();\n")],
    "4 ring stages": [("constexpr int MMA_STAGES = 3;", "constexpr int MMA_STAGES = 4;")],
    "no products": [
        ("            for (int j = 0; j < 4; ++j) mma_bf16(gacc[i][j], af[i], bq[j][0], bq[j][1]);\n"
         "            mma_bf16(xacc[i], af[i], ONES, ONES);",
         "            gacc[i][0][0] += __uint_as_float((af[i][0] ^ af[i][3]) & 0x3f800000u) "
         "+ __uint_as_float((bq[0][0] ^ bq[3][1]) & 0x3f800000u);")],
    "one group of warps a stage for float32 x": [
        ("  static constexpr int KG = sizeof(TX) == 4 ? 2 : 1;", "  static constexpr int KG = 1;")],
    "two groups of warps a stage for bf16 x": [
        ("  static constexpr int KG = sizeof(TX) == 4 ? 2 : 1;", "  static constexpr int KG = 2;")],
    "shared memory carveout left at its default": [
        ("    if (e == cudaSuccess)\n      e = cudaFuncSetAttribute(kernel, "
         "cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n", "")],
    "no unpacking of the codes": [
        ("    for (int it = 0; it < (UN + NTH - 1) / NTH; ++it) {",
         "    for (int it = 0; it < (p.M < 0 ? (UN + NTH - 1) / NTH : 0); ++it) {")],
    "no copies after the first stage": [
        ("    uint8_t* st = stage_ptr(kt);\n    const int k0 = kt * MMA_BK;\n",
         "    uint8_t* st = stage_ptr(kt);\n    const int k0 = kt * MMA_BK;\n"
         "    if (kt > kb) return;\n")],
    "at most 4 splits": [("constexpr int MMA_MAX_SPLITS = 8;", "constexpr int MMA_MAX_SPLITS = 4;")],
    "no split over K": [("  p.splits = 1;\n  while (", "  p.splits = 1;\n  while (false && ")],
    "64 weight rows a block always": [
        ("    if (p.M <= 32 && wide * MMA_MAX_SPLITS >= sms) return", "    if (false) return"),
        ("    return p.M > 32 && wide * ((p.M + 63) / 64) >= 2LL * sms", "    return false")],
    "128 weight rows a block always": [
        ("    return p.M > 32 && wide * ((p.M + 63) / 64) >= 2LL * sms", "    return true")],
    "K split while the grid stays within two blocks a SM": [
        ("  while (nt * mt * 2 * p.splits <= static_cast<long long>(per_sm[dev]) * sms &&",
         "  while (nt * mt * 2 * p.splits <= 2LL * sms &&")],
    "splits of two stages allowed": [
        ("         2 * p.splits <= MMA_MAX_SPLITS && 8 * p.splits <= nk)",
         "         2 * p.splits <= MMA_MAX_SPLITS && 4 * p.splits <= nk)")],
    "empty kernel": [("  constexpr int BM = T::BM, BN = T::BN, NTH = T::THREADS, NSPLIT = T::NSPLIT, KG = T::KG;\n",
                      "  constexpr int BM = T::BM, BN = T::BN, NTH = T::THREADS, NSPLIT = T::NSPLIT, KG = T::KG;\n"
                      "  if (p.N > 0) return;\n")],
}

PV16_LOOP_COMMIT = ("    if (kt + B16_STAGES - 1 < nk) load(kt + B16_STAGES - 1);\n"
                    "    cp_async_commit();\n")
RELU2_BF16 = {
    "as committed": [],
    "earlier kernel (one launch, E tiled, scores per column tile)":
        BASELINES / "relu2_attention_bf16_tiled_e.cu",
    "PV 64 columns a block always": [("  return wide >= 264 ? launch_pv_bf16<128>",
                                      "  return false ? launch_pv_bf16<128>")],
    "PV 128 columns a block always": [("  return wide >= 264 ? launch_pv_bf16<128>",
                                       "  return true ? launch_pv_bf16<128>")],
    "PV: no copy in flight under the products": [
        (PV16_LOOP_COMMIT, PV16_LOOP_COMMIT + "    cp_async_wait<0>();\n")],
    "PV 2 stages": [("constexpr int B16_STAGES = 3;", "constexpr int B16_STAGES = 2;")],
    "PV 128 queries a block (8 warps)": [("constexpr int B16_BQ = 64; ", "constexpr int B16_BQ = 128; ")],
    "PV 4 stages": [("constexpr int B16_STAGES = 3;", "constexpr int B16_STAGES = 4;")],
    "shared memory carveout left at its default": [
        ("  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);",
         "  return err;")],
    "score pass only": [("  return wide >= 264 ? launch_pv_bf16<128>",
                         "  if (wide > 0) return 0;\n  return wide >= 264 ? launch_pv_bf16<128>")],
}
# the earlier relu2 kernel's C interface: no scratch
RELU2_EARLIER_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def edited_sources(kind: str, variants: dict) -> dict:
    """name -> the variant's source text; raises if an edit does not apply."""
    src = (CSRC / kind).read_text()
    texts = {}
    for name, edits in variants.items():
        text = src
        if isinstance(edits, Path):
            text, edits = edits.read_text(), []
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in {kind}")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def ptxas_lines(log: str, kernel: str) -> list:
    """ptxas's registers and spills of the entries whose name holds `kernel`."""
    lines, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif kernel in entry and ("registers" in line or ("spill" in line and
                                  "0 bytes spill stores, 0 bytes spill loads" not in line)):
            lines.append(f"{entry[:80]}: {line.split(':', 1)[-1].strip()}")
    return lines


def build(kind: str, variants: dict, tag: str, kernel: str = "") -> dict:
    """Compile every variant of csrc/<kind> at once; name -> CDLL. A variant
    is a list of (old, new) edits of the source, or the path of another
    source with the same C interface names. `tag` names the set in the
    library paths (dlopen hands back a library already loaded from the same
    path). With `kernel`, ptxas's report on the kernels of that name is
    printed for each variant."""
    texts = edited_sources(kind, variants)  # every edit checked before any build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        path = OUT / f"{Path(kind).stem}_{tag}_{i}.cu"
        path.write_text(text)
        procs[name] = (path.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(path.with_suffix(".so")),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{log[-4000:]}")
        for line in ptxas_lines(log, kernel) if kernel else []:
            print(f"[ptxas] {name}: {line}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in _build.SIGNATURES.items():
            if hasattr(libs[name], fn):
                getattr(libs[name], fn).restype = restype
                getattr(libs[name], fn).argtypes = argtypes
    return libs


class QmmCaller:
    """qmm_fwd of one variant's library."""

    def __init__(self, lib):
        self.lib = lib
        self.route = ctypes.c_int(-1)

    def __call__(self, x, w, y, bits):
        M, K = x.shape
        err = self.lib.qmm_fwd(
            x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(), y.data_ptr(), M,
            w[0].shape[0], K, cs.GROUP, bits, 1 if x.dtype == torch.bfloat16 else 0,
            x.stride(0), x.device.index, ctypes.addressof(self.route),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"qmm launch failed: {err}")


def device_us(fns, iters: int) -> str:
    """chip_smoke's device time per call in microseconds, or "not measured"
    where the profiler saw no device time."""
    try:
        return f"{cs.device_ms(fns, iters)[0] * 1e3:.2f} us"
    except SystemExit:
        return "not measured"


def time_flash() -> None:
    libs = build("flash_attention.cu", FLASH, "flash")
    B, H, T, S, D = 4, 20, 1500, 1500, 64
    q, k, v = cs.attention_inputs(B, H, T, S, D, torch.bfloat16, seed=100)
    ref = flash_attention_reference(q, k, v)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, T, S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            ctypes.c_float(D ** -0.5), 0, 1, stream)
        if err:
            raise SystemExit(f"flash launch failed: {err}")

    for rnd in range(2):
        sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
        print(f"[flash] round {rnd}: F.sdpa {sdpa:.4f} ms", flush=True)
        for name, lib in libs.items():
            o.fill_(float("nan"))  # no output left over from the last variant
            call(lib)
            torch.cuda.synchronize()
            ok = cs.compare(o, ref, torch.bfloat16)[0]
            ms = cs.time_ms(lambda: call(lib), iters=50)
            print(f"[flash] round {rnd}: {name:24s} {ms:.4f} ms  output "
                  f"{'within its bar' if ok else 'wrong (timing only)'}", flush=True)


def time_flash32() -> None:
    libs = build("flash_attention.cu", FLASH32, "flash32", "flash_fwd_f32")
    B, H, T, S, D = 4, 20, 1500, 1500, 64
    q, k, v = cs.attention_inputs(B, H, T, S, D, torch.float32, seed=100)
    ref = flash_attention_reference(q, k, v)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    bound, _ = cs.attention_bound_ms(B, H, T, S, D, torch.float32, False)
    print(f"[flash32] B={B} H={H} T=S={T} D={D}: the f32 bound is {bound:.4f} ms", flush=True)

    def call(lib):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, T, S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            ctypes.c_float(D ** -0.5), 0, 0, stream)
        if err:
            raise SystemExit(f"flash launch failed: {err}")

    for rnd in range(2):
        sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        print(f"[flash32] round {rnd}: {'F.sdpa, float32':46s} {sdpa:.4f} ms", flush=True)
        for name, lib in libs.items():
            o.fill_(float("nan"))  # no output left over from the last variant
            call(lib)
            torch.cuda.synchronize()
            ok = cs.compare(o, ref, torch.float32)[0]
            ms = cs.time_ms(lambda: call(lib))
            print(f"[flash32] round {rnd}: {name:46s} {ms:.4f} ms ({100 * bound / ms:.1f}% of "
                  f"bound)  output {'within its bar' if ok else 'wrong (timing only)'}",
                  flush=True)


def time_qmlp() -> None:
    libs = build("quant_matmul.cu", QMLP, "qmlp")
    M, K, I, N = 1, 1024, 3072, 1024
    g = torch.Generator(device="cuda").manual_seed(500)
    sets = [(cs.quant_weights(2 * I, K, 4, g), cs.quant_weights(N, I, 4, g))]
    wbytes = cs.weight_bytes(*sets[0][0]) + cs.weight_bytes(*sets[0][1])
    sets += [tuple(tuple(t.clone() for t in part) for part in sets[0])
             for _ in range(int(2 * cs.L2_BYTES // wbytes))]
    x = torch.randn(M, K, generator=g, device="cuda")
    ref = quantized_mlp_reference(x, *sets[0][0], *sets[0][1])
    y = torch.empty(M, N, device="cuda")
    h = torch.empty(M * I, device="cuda")
    bars = {name: torch.zeros(64, dtype=torch.int32, device="cuda") for name in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, w):
        (wg, sg, bg), (wd, sd, bd) = w
        err = libs[name].qmlp_fwd(
            x.data_ptr(), wg.data_ptr(), sg.data_ptr(), bg.data_ptr(), wd.data_ptr(),
            sd.data_ptr(), bd.data_ptr(), y.data_ptr(), h.data_ptr(), bars[name].data_ptr(),
            M, K, I, N, cs.GROUP, 4, 0, x.device.index, K, stream)
        if err:
            raise SystemExit(f"qmlp launch failed: {err}")

    for rnd in range(2):
        for name in libs:
            y.fill_(float("nan"))  # no output left over from the last variant
            call(name, sets[0])
            torch.cuda.synchronize()
            ok = cs.compare_q(y, ref)[0]
            ms, _ = cs.device_ms([lambda w=w: call(name, w) for w in sets], 400)
            line = (f"[qmlp] round {rnd}: {name:24s} {ms * 1e3:.2f} us  output "
                    f"{'within its bar' if ok else 'wrong (timing only)'}")
            if rnd == 0:
                hot, _ = cs.device_ms([lambda: call(name, sets[0])], 400)
                line += f"; L2-hot {hot * 1e3:.2f} us"
            print(line, flush=True)


def time_qmm() -> None:
    libs = build("quant_matmul.cu", QMM, "qmm", "qmm_gemv")
    calls = {name: QmmCaller(lib) for name, lib in libs.items()}
    for M, N, K, what in ((1, 4096, 1024, "q/k/v"), (1, 1024, 2048, "o_proj"),
                          (2, 4096, 1024, "code predictor seed")):
        g = torch.Generator(device="cuda").manual_seed(404)
        sets = [cs.quant_weights(N, K, 4, g)]
        sets += [tuple(t.clone() for t in sets[0])
                 for _ in range(int(2 * cs.L2_BYTES // cs.weight_bytes(*sets[0])))]
        x = torch.randn(M, K, generator=g, device="cuda")
        ref = quantized_matmul_reference(x, *sets[0])
        y = torch.empty(M, N, device="cuda")

        def call(name, w):
            calls[name](x, w, y, 4)

        for rnd in range(2):
            for name in libs:
                y.fill_(float("nan"))
                call(name, sets[0])
                torch.cuda.synchronize()
                ok = cs.compare_q(y, ref)[0]
                us = device_us([lambda w=w: call(name, w) for w in sets], 400)
                print(f"[qmm] {what} M={M} N={N} K={K} round {rnd}: {name:34s} {us}  output "
                      f"{'within its bar' if ok else 'wrong (timing only)'}", flush=True)


def time_qmm6() -> None:
    libs = build("quant_matmul.cu", QMM6, "qmm6", "qmm_gemv")
    calls = {name: QmmCaller(lib) for name, lib in libs.items()}
    for M, N, K, what in ((1, 4096, 1024, "q/k/v"), (1, 1024, 2048, "o_proj"),
                          (1, 6144, 1024, "gate/up"), (1, 1024, 3072, "down")):
        g = torch.Generator(device="cuda").manual_seed(406)
        sets = [cs.quant_weights(N, K, 6, g)]
        wbytes = cs.weight_bytes(*sets[0])
        sets += [tuple(t.clone() for t in sets[0]) for _ in range(int(2 * cs.L2_BYTES // wbytes))]
        x = torch.randn(M, K, generator=g, device="cuda")
        ref = quantized_matmul_reference(x, *sets[0], bits=6)
        y = torch.empty(M, N, device="cuda")
        bound, _ = cs.quant_bound_ms(wbytes, M, K, N, torch.float32, 2.0 * M * N * K)
        print(f"[qmm6] {what} M={M} N={N} K={K}: the bytes bound is {bound * 1e3:.2f} us",
              flush=True)

        def call(name, w):
            calls[name](x, w, y, 6)

        for rnd in range(2):
            for name in libs:
                y.fill_(float("nan"))
                call(name, sets[0])
                torch.cuda.synchronize()
                ok = cs.compare_q(y, ref)[0]
                us = device_us([lambda w=w: call(name, w) for w in sets], 400)
                print(f"[qmm6] {what} M={M} N={N} K={K} round {rnd}: {name:34s} {us}  output "
                      f"{'within its bar' if ok else 'wrong (timing only)'}", flush=True)


def time_qmm_tiled() -> None:
    libs = build("quant_matmul.cu", QMM_TILED, "qmm_tiled", "qmm_mma")
    calls = {name: QmmCaller(lib) for name, lib in libs.items()}
    # bf16 x at every shape; f32 x (the talker's prefill) at 6-bit q/k/v and
    # o_proj
    cases = [(bits, shape, M, N, K, torch.bfloat16) for bits in (4, 6)
             for shape, M, N, K in cs.QMM_PREFILL]
    cases += [(6, shape, M, N, K, torch.float32) for shape, M, N, K in cs.QMM_PREFILL[:2]]
    for bits, shape, M, N, K, dtype in cases:
        g = torch.Generator(device="cuda").manual_seed(450 + bits)
        sets = [cs.quant_weights(N, K, bits, g)]
        wbytes = cs.weight_bytes(*sets[0])
        sets += [tuple(t.clone() for t in sets[0])
                 for _ in range(int(2 * cs.L2_BYTES // wbytes))]
        x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
        ref = quantized_matmul_reference(x, *sets[0], bits=bits)
        y = torch.empty(M, N, dtype=dtype, device="cuda")
        elem, split = x.element_size(), 3 if dtype == torch.float32 else 1
        t_ops, t_bytes = split * 2.0 * M * N * K / cs.PEAK_BF16_FLOPS, (
            wbytes + elem * M * (K + N)) / cs.PEAK_BYTES
        what = f"{bits}-bit {shape} M={M} N={N} K={K} {str(dtype)[6:]}"
        print(f"[qmm_tiled] {what}: the bound is {max(t_ops, t_bytes) * 1e3:.2f} us "
              f"({'operations' if t_ops >= t_bytes else 'bytes'})", flush=True)
        for rnd in range(2):
            for name, call in calls.items():
                y.fill_(float("nan"))
                call(x, sets[0], y, bits)
                torch.cuda.synchronize()
                ok = cs.compare_q(y, ref)[0]
                us = device_us([lambda w=w: call(x, w, y, bits) for w in sets], 200)
                print(f"[qmm_tiled] {what} round {rnd}: {name:42s} {us}  output "
                      f"{'within its bar' if ok else 'wrong (timing only)'}", flush=True)
        del sets
        torch.cuda.empty_cache()


def time_relu2_bf16() -> None:
    libs = build("relu2_attention.cu", RELU2_BF16, "relu2b", "bf16")
    stream = torch.cuda.current_stream().cuda_stream
    for G in (10, 2):
        B, N, D, E = 1, 256, 128, 2048
        q, k, v = cs.relu2_inputs(B, G, N, D, E, torch.bfloat16, False, seed=700)
        ref = relu2_attention_reference(q, k, v, N)
        o = torch.empty_like(v)
        scratch = torch.empty(scratch_elems(B, G, N), dtype=torch.bfloat16, device="cuda")
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])

        def call(name):
            err = libs[name].relu2_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), scratch.data_ptr(),
                B, G, N, D, E, *strides, ctypes.c_float(N), 1, stream)
            if err:
                raise SystemExit(f"relu2 launch failed: {err}")

        bound, _ = cs.relu2_bound_ms(B, G, N, D, E, torch.bfloat16)
        print(f"[relu2-bf16] G={G} E={E}: the bf16 bound is {bound * 1e3:.2f} us", flush=True)
        for rnd in range(2):
            plain = device_us([lambda: relu2_attention_reference(q, k, v, N)], 50)
            print(f"[relu2-bf16] G={G} E={E} round {rnd}: {'plain (two cuBLAS matmuls)':60s} "
                  f"{plain}", flush=True)
            for name in libs:
                o.fill_(float("nan"))
                call(name)
                torch.cuda.synchronize()
                ok = cs.compare_q(o, ref, cs.R2_BF16_ULPS)[0]
                us = device_us([lambda: call(name)], 200)
                print(f"[relu2-bf16] G={G} E={E} round {rnd}: {name:60s} {us}  output "
                      f"{'within its bar' if ok else 'wrong (timing only)'}", flush=True)


def time_relu2() -> None:
    libs = build("relu2_attention.cu", RELU2, "relu2")
    name0 = "earlier kernel (E tiled, scores per column tile)"
    libs[name0].relu2_attention_fwd.argtypes = RELU2_EARLIER_ARGS
    stream = torch.cuda.current_stream().cuda_stream
    for G in (10, 2):
        B, N, D, E = 1, 256, 128, 2048
        q, k, v = cs.relu2_inputs(B, G, N, D, E, torch.float32, False, seed=700)
        ref = relu2_attention_reference(q, k, v, N)
        o = torch.empty_like(v)
        scratch = torch.empty(scratch_elems(B, G, N), device="cuda")
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])

        def call(name):
            lead = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
            if name != name0:
                lead += (scratch.data_ptr(),)
            err = libs[name].relu2_attention_fwd(*lead, B, G, N, D, E, *strides,
                                                 ctypes.c_float(N), 0, stream)
            if err:
                raise SystemExit(f"relu2 launch failed: {err}")

        bound, _ = cs.relu2_bound_ms(B, G, N, D, E, torch.float32)
        print(f"[relu2] G={G} E={E}: the f32 bound is {bound * 1e3:.2f} us", flush=True)
        for rnd in range(2):
            plain = device_us([lambda: relu2_attention_reference(q, k, v, N)], 50)
            print(f"[relu2] G={G} E={E} round {rnd}: {'plain (two cuBLAS matmuls)':50s} "
                  f"{plain}", flush=True)
            for name in libs:
                o.fill_(float("nan"))
                call(name)
                torch.cuda.synchronize()
                ok = cs.compare_q(o, ref)[0]
                us = device_us([lambda: call(name)], 200)
                print(f"[relu2] G={G} E={E} round {rnd}: {name:50s} {us}  output "
                      f"{'within its bar' if ok else 'wrong (timing only)'}", flush=True)
    time_relu2_bf16()


def main():
    ap = argparse.ArgumentParser()
    kinds = ("flash", "flash32", "qmlp", "qmm", "qmm6", "qmm_tiled", "relu2")
    for kind in kinds:
        ap.add_argument(f"--{kind}", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    chosen = [kind for kind in kinds if getattr(args, kind)] or list(kinds)
    for kind in chosen:
        globals()[f"time_{kind}"]()


if __name__ == "__main__":
    main()
