#!/usr/bin/env python3
"""Time edited copies of the port's redesigned kernels on one H100.

    python3 scripts/torch_kernel_variants.py [--flash] [--qmlp]

Each variant is the kernel's source with a few lines replaced: a part of
the kernel taken out (its output is then wrong, and only its time counts)
or a design choice undone. Every variant is built with nvcc into its own
library under `build/variants/` and timed beside the unchanged source on
the same inputs, in two rounds taken in turns:

- flash: B=4 H=20 T=S=1500 D=64 bf16 from (B, T, H, D) views, CUDA events
  over 50 launches, with F.scaled_dot_product_attention as the yardstick;
- qmlp: M=1 K=1024 I=3072 N=1024 int4 with f32 x, device time per call
  from torch.profiler with the weights cycled past L2, and once with one
  weight set every call (L2-hot).

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
from mlx_audio_tpu_torch.ops.cuda.quant_matmul import quantized_mlp_reference  # noqa: E402

CSRC = REPO / "mlx_audio_tpu_torch" / "csrc"
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


def build(kind: str, variants: dict) -> dict:
    """Compile every variant of csrc/<kind> at once; name -> CDLL."""
    src = (CSRC / kind).read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in {kind}")
            text = text.replace(old, new)
        path = OUT / f"{Path(kind).stem}_{i}.cu"
        path.write_text(text)
        procs[name] = (path.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(path.with_suffix(".so")),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in _build.SIGNATURES.items():
            if hasattr(libs[name], fn):
                getattr(libs[name], fn).restype = restype
                getattr(libs[name], fn).argtypes = argtypes
    return libs


def time_flash() -> None:
    libs = build("flash_attention.cu", FLASH)
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


def time_qmlp() -> None:
    libs = build("quant_matmul.cu", QMLP)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--qmlp", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.flash or not args.qmlp:
        time_flash()
    if args.qmlp or not args.flash:
        time_qmlp()


if __name__ == "__main__":
    main()
