#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mlx_audio_tpu_torch) on one H100.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: card name and power limit, capability (9, 0), kernel build;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and a few edge cases, then timed beside its bound,
     its plain version and one PyTorch library call;
  3. the card against the CPU on a two-layer Whisper at full width (f32);
  4. Whisper-large-v3-turbo at full width (bf16, seeded random weights):
     chunked transcription of 120 s of seeded noise through the port's
     entry point, with launch counts read around the run.
The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. It
needs one CUDA card and the checkout's `mlx_audio_tpu_torch/` package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense peaks at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12

TURBO = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
             n_audio_layer=32, n_vocab=51866, n_text_ctx=448, n_text_state=1280,
             n_text_head=20, n_text_layer=4)
F32_ATOL = 2e-4  # the Pallas kernel's own bar against the einsum path
# bf16: each case is held to its own output's scale: max|d| within
# BF16_ULPS bf16 ulps of its max|ref| (and never over BF16_ATOL), and
# ||d|| / ||ref|| within BF16_REL. The plain version rounds p to bf16
# against the row's final max; the kernel rounds it against the running max
# of its 64-key tiles, so the kernel differs by rel ~2.3e-3 (1.4e-3
# causal) on an H100. A kernel that drops the ragged-key mask at S = 1500
# scales every output by ~0.986, rel ~1.45e-2; `planted_mask_check` shows
# the bar rejects it.
BF16_ATOL = 2e-2
BF16_ULPS = 2
BF16_REL = 5e-3
# float32 on both sides, TF32 off; measured ~5e-6 on O(1) activations. A
# card path that ran its matmuls in TF32 (~1e-3 relative) fails it.
CARD_VS_CPU_ATOL = 1e-4
WARMUP_RUNS, TIMED_RUNS = 3, 7


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(B, H, T, S, D, dtype, seed):
    """q, k, v as the encoder hands them over: (B, L, H, D) projections
    viewed as (B, H, L, D)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
    return q, k, v


def compare(out, ref, dtype) -> tuple:
    """(passes, max|d|, description) of a kernel output against its plain
    version, at the bar for its dtype (see the constants above)."""
    d = out.float() - ref.float()
    err = d.abs().max().item()
    rel = (d.norm() / ref.float().norm()).item()
    if dtype == torch.float32:
        ok = err <= F32_ATOL  # False on NaN
        return ok, err, f"max|d|={err:.3e} (atol {F32_ATOL:g}), rel={rel:.3e}"
    peak = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(peak)) - 7)  # bf16 spacing at max|ref|
    tol = min(BF16_ATOL, BF16_ULPS * ulp)
    ok = err <= tol and rel <= BF16_REL
    return ok, err, (f"max|d|={err:.3e} (atol {tol:.3e} = {BF16_ULPS} ulp at "
                     f"max|ref| {peak:.3f}), rel={rel:.3e} (bar {BF16_REL:g})")


def planted_mask_check(q, k, v, flash_attention_reference) -> None:
    """What a kernel without the ragged-key mask returns: every key tile of
    64 read in full, the 36 keys past S = 1500 zero. The bf16 bar must
    reject it, or it could not catch such a kernel."""
    pad = -k.shape[-2] % 64
    assert pad, "the planted check needs S that is not a multiple of 64"
    kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
    planted = flash_attention_reference(q, kp, vp)
    ok, _, desc = compare(planted, flash_attention_reference(q, k, v), q.dtype)
    log(f"[kernel] planted fault (no ragged-key mask, {pad} zero keys): {desc} -> "
        f"{'passes: the bar is too loose' if ok else 'rejected'}")
    if ok:
        raise SystemExit("chip_smoke: the bf16 bar accepts a kernel without the key mask")


def attention_bound_ms(B, H, T, S, D, dtype, causal) -> tuple:
    pairs = T * (T + 1) / 2 if causal else T * S
    flops = 4.0 * B * H * pairs * D
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * B * H * D * (2 * T + 2 * S)  # q, o read/written; k, v read
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; it needs a CUDA card")
    if not (REPO / "mlx_audio_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: mlx_audio_tpu_torch/ is missing; run it from the repo checkout")
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cap} count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: capability {cap}, the kernels are built for sm_90a")

    from mlx_audio_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc {_build.last_build['seconds']:.1f} s, "
        f"cached={_build.last_build['cached']}) -> {_build.last_build['path']}")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")
    return smi


def phase_kernels():
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, H, T, S, D, dtype, causal
        ("whisper_bf16", 4, 20, 1500, 1500, 64, bf16, False),
        ("whisper_f32", 4, 20, 1500, 1500, 64, f32, False),
        ("ragged_bf16", 2, 20, 700, 1500, 64, bf16, False),
        ("ragged_f32", 1, 4, 700, 1500, 64, f32, False),
        ("causal_bf16", 2, 20, 1500, 1500, 64, bf16, True),
        ("causal_f32", 1, 4, 1500, 1500, 64, f32, True),
        ("d128_bf16", 2, 8, 1500, 1500, 128, bf16, False),
        ("d128_f32", 1, 8, 1300, 1333, 128, f32, False),
        ("d80_bf16", 1, 4, 1400, 1400, 80, bf16, False),
    ]
    errs = {}
    for i, (name, B, H, T, S, D, dtype, causal) in enumerate(cases):
        q, k, v = attention_inputs(B, H, T, S, D, dtype, seed=i)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, causal=causal)
        ok, err, desc = compare(out, ref, dtype)
        log(f"[kernel] flash_attention {name} B={B} H={H} T={T} S={S} D={D} "
            f"causal={causal}: {desc}")
        if not ok:
            raise SystemExit(f"chip_smoke: flash_attention {name} over its bar: {desc}")
        errs[name] = err
        if name == "whisper_bf16":
            planted_mask_check(q, k, v, flash_attention_reference)

    timing = {}
    for name, dtype in (("whisper_bf16", bf16), ("whisper_f32", f32)):
        B, H, T, S, D = 4, 20, 1500, 1500, 64
        q, k, v = attention_inputs(B, H, T, S, D, dtype, seed=100)
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain = time_ms(lambda: flash_attention_reference(q, k, v), iters=5)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound, by = attention_bound_ms(B, H, T, S, D, dtype, False)
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                            bound_by=by)
        log(f"[time] flash_attention {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"F.sdpa {lib:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"kernel at {100 * bound / ms:.1f}% of bound")
    return errs, timing


def phase_card_vs_cpu():
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    dims = ModelDimensions(**{**TURBO, "n_audio_layer": 2, "n_text_layer": 2})
    cpu = Model(dims, device="cpu", seed=1)
    card = Model(dims, device="cuda", seed=2)
    card.load_state_dict(cpu.state_dict())
    audio = (np.random.default_rng(1).standard_normal(16000 * 30) * 0.05).astype(np.float32)
    mel, _ = cpu._mel_chunks_device(audio)
    mel_card, _ = card._mel_chunks_device(audio)
    mel_err = (mel_card.cpu() - mel).abs().max().item()
    xa_c, kv_c = cpu._encode(mel[:1])
    xa_g, kv_g = card._encode(mel[:1].cuda())
    prompt = torch.tensor([[50258, 50259, 50360, 50364]])
    with torch.inference_mode():
        lg_c = Model._decoder_step(cpu, prompt, 0, cpu._make_caches(1, 64), kv_c)[0]
        lg_g = Model._decoder_step(card, prompt.cuda(), 0, card._make_caches(1, 64), kv_g)[0]
    enc_err = (xa_g.cpu() - xa_c).abs().max().item()
    lg_err = (lg_g.cpu() - lg_c).abs().max().item()
    log(f"[card-vs-cpu] 2+2-layer Whisper at full width, f32: mel max|d|={mel_err:.3e}, "
        f"encoder max|d|={enc_err:.3e}, prefill logits max|d|={lg_err:.3e} "
        f"(atol {CARD_VS_CPU_ATOL:g})")
    for what, err in (("mel", mel_err), ("encoder", enc_err), ("logits", lg_err)):
        if not err <= CARD_VS_CPU_ATOL:
            raise SystemExit(f"chip_smoke: card vs CPU {what} max|d| {err}")
    del cpu, card
    torch.cuda.empty_cache()


def phase_slice():
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

    seconds, sample_len = 120.0, 96
    t0 = time.perf_counter()
    model = Model(ModelDimensions(**TURBO), dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] whisper-large-v3-turbo dims, bf16, {n_params / 1e6:.1f} M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    tok = DummyTokenizer(n_vocab=TURBO["n_vocab"])
    audio = (np.random.default_rng(0).standard_normal(int(16000 * seconds)) * 0.05
             ).astype(np.float32)

    def run():
        out = model.generate_chunked(
            audio, language="en", temperature=0.0, tokenizer=tok,
            without_timestamps=True, sample_len=sample_len)
        torch.cuda.synchronize()
        return out

    warm = []
    for _ in range(WARMUP_RUNS):
        t0 = time.perf_counter()
        run()
        warm.append(time.perf_counter() - t0)
    log(f"[slice] warm-up walls {', '.join(f'{w:.4f}' for w in warm)} s")

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    first = run()
    walls = [time.perf_counter() - t0]
    launches = flash_attention.launches
    outs = [first]
    for _ in range(TIMED_RUNS - 1):
        t0 = time.perf_counter()
        outs.append(run())
        walls.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    segs = first.segments
    n_tok = [len(s["tokens"]) for s in segs]
    log(f"[slice] {len(segs)} windows, tokens per window {n_tok}, "
        f"flash_attention launches in one transcription: {launches}")
    if launches <= 0:
        raise SystemExit("chip_smoke: the main path launched no flash_attention kernel")
    if len(segs) != 4 or not all(0 < n <= sample_len for n in n_tok):
        raise SystemExit(f"chip_smoke: unexpected segments {n_tok}")
    for s in segs:
        if not (np.isfinite(s["avg_logprob"]) and 0.0 <= s["no_speech_prob"] <= 1.0):
            raise SystemExit(f"chip_smoke: non-finite scores in {s}")
        if not all(0 <= t < TURBO["n_vocab"] for t in s["tokens"]):
            raise SystemExit("chip_smoke: token id out of range")
    if any([s["tokens"] for s in o.segments] != [s["tokens"] for s in segs] for o in outs):
        raise SystemExit("chip_smoke: repeated runs disagree")

    med = statistics.median(walls)
    log(f"[slice] 120 s audio, {TIMED_RUNS} runs after {WARMUP_RUNS} warm-up: walls "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; median {med:.4f} s = "
        f"{seconds / med:.1f}x real time (all runs {seconds * len(walls) / sum(walls):.1f}x, "
        f"best {seconds / min(walls):.1f}x); peak memory {peak_gb:.2f} GB")
    profile_one_run(run)
    return launches


def profile_one_run(run) -> None:
    """Device busy time and the top kernels of one transcription, from
    torch.profiler (CUPTI). Prints "not measured" if it sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log("[profile] device time: not measured (the profiler saw no CUDA kernels)")
        return
    log(f"[profile] one transcription (profiled): wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {100 * (1 - busy_us / wall_us):.1f}%, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x  {e.key[:90]}")


def main():
    smi = phase_device()
    errs, timing = phase_kernels()
    phase_card_vs_cpu()
    launches = phase_slice()
    t = timing["whisper_bf16"]
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "mlx_audio_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mlx_audio_tpu/ops/pallas/flash_attention.py:22",
        "launches": launches, "max_abs_err": errs["whisper_bf16"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }]}
    log(f"[device] {smi}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
