#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mlx_audio_tpu_torch) on one H100.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: card name and power limit, capability (9, 0), kernel build;
  2. every kernel against its plain PyTorch version on the card, at the
     main paths' shapes and a few edge cases, then timed beside its bound,
     its plain version and one PyTorch library call (or, for the quantized
     kernels, a bf16 yardstick); the dequant-matmul's three routes (the
     GEMV at M <= 4, the tensor-core GEMM above, the tiled CUDA-core kernel for
     what neither takes) each held to the kernel the route names, and the
     GEMM timed at the prefill shapes beside the tiled kernel;
  3. the card against the CPU on a two-layer Whisper and on a shallow
     Qwen3-TTS int4, both at full width (f32);
  4. Whisper-large-v3-turbo at full width (seeded random weights):
     chunked transcription of 120 s of seeded noise through the port's
     entry point in bf16, with launch counts read around the run, then
     once in float32 (the model's default dtype), profiled, with the f32
     flash kernel's launches held to one per encoder layer;
  5. Qwen3-TTS 0.6B int4 at full width (bf16, seeded random weights):
     QWEN_FRAMES (32) frames of synthesis through `Model.generate` (a
     warm-up and one counted run), with launch counts
     read around each run and held to the routing table's, the qmm
     launches split by kernel;
  6. the same model at 6 bits, 16 frames (32 until phase 13 came), then a
     profiled 16-frame run:
     device time per frame, the 6-bit GEMV's time per launch and the M > 4
     kernel's device time;
  7. MossFormer2-SE 48 kHz at full width (f32, 24 blocks, seeded random
     weights): 20 s in one shot, 30 s segmented and 90 s chunked through
     `Model.enhance`, with the ReLU² kernel's launches held to 1 per FLASH
     layer per chunk (v and u in one call);
  8. Kokoro-82M at bench.py's widths: the card against the CPU in float32
     on ~40 phonemes (identical durations, audio within a stated bar),
     then bf16 on bench.py's 508 phonemes through `Model.__call__` (RTF
     over 5 runs, identical audio across runs, peak memory), one profiled
     run (device time, launches, idle share, the LSTMs' share), and
     `Model.generate` with a seeded voice pack. No kernel of the port is on
     this path;
  9. the rest of Whisper on the phase 4 model in bf16: the seek loop
     (`generate`) on 120 s at bench.py's serving settings and on 30 s at its
     defaults, conditioned long-form on 600 s at bench.py's settings, beam
     search (K = 5), word timing through `generate_chunked` and `generate`,
     AlignAtt streaming in 1 s chunks, and the five writers; every step's
     flash launches held to a count derived from the code;
 10. the three models loaded from checkpoint directories written in the run
     (into a temporary directory, removed after): Whisper-large-v3-turbo in
     bf16 through `stt.generate.generate_transcription(model_path=...)` on a
     120 s 44.1 kHz stereo wav (the tokens of the same model in memory, 32
     flash launches, the five writers); Qwen3-TTS 0.6B converted to int4 by
     `convert` through `tts.generate.generate_audio(model_path=...)` (the
     codes of the in-memory model quantized alike, the wav equal to its
     int16 samples, the quantized launches equal to the routing table's);
     Kokoro-82M in the upstream torch layout with a voices/ pack (within one
     int16 step of the in-memory model); the safetensors reader round-trips
     every dtype;
 11. serving, on the models of phases 5, 7, 8 and 9 (kept, not rebuilt):
     `bench_whisper_serving` (8 x 30 s through `WhisperBatcher`, window 50
     ms, sequential then 1 concurrent trial, where bench.py takes the
     median of 3; each trial's flash launches held to 32 per batched encode,
     each stream's tokens to its sequential tokens or a stated near-tie);
     `bench_qwen3_serving`'s shape cut in depth on the unquantized bf16
     model (8 sampled streams x 8 frames, where bench.py decodes 64, tick
     8, 1 trial where it takes 3; every request's codes equal to its
     one-slot codes); the int4 model
     through the same batcher (8 x 16 frames, every quantized launch held to
     the routing table at the pool's shapes, the one-slot gate, and greedy
     codes against `_run_codes`); MossFormer2-SE's 90 s request through a
     `StackBatcher` (relu2 launches one per FLASH layer per dispatch, the
     output at phase 3's bar of the unbatched route); Kokoro-82M, 4
     concurrent `generate` calls through `KokoroBatcher`, in float32 (each
     within one int16 step of its sequential call) and in bf16 (each
     correlated with its sequential call at the JAX package's bar);
 12. the server (`server.serve_stdlib`, in process on a free port) on the
     directories phase 10 wrote, each with a tokenizer.json the script
     writes (read by the port's own reader: the card has no `tokenizers`),
     models loaded through POST /v1/models and their batchers warmed:
     Whisper-large-v3-turbo (bf16) transcribing a 15 s 44.1 kHz stereo
     upload (the text and tokens of the in-memory phase 4 model, flash
     launches 32 per batched encode), 2 concurrent requests, the first as
     NDJSON, each its own seeded upload of 8-8.5 s (each transcription
     the in-memory model's sequential one of the same upload, or a stated
     near-tie at the decode where the two part), and the realtime WebSocket route (its
     final = `generate` on the same buffer); int4
     Qwen3-TTS served as CustomVoice, each request capped at
     HTTP_QWEN_FRAMES (16; its text's 128 until phase 16 came, 32 until
     phase 18, 24 until phase 19) (greedy,
     streamed wav: time to first byte; then a wave of four texts in the
     server's four-slot pool, the
     WebSocket route, the model's `generate` in process and two HTTP
     requests, each equal to its own text's one-slot samples, their
     quantized launches held to the routing table);
     Kokoro-82M in float32 (within one int16 step of the in-memory model;
     the same request again inside `profiling.trace` and
     `annotate('request')`, the trace naming the span and device kernels);
     an int4 Whisper converted from the bf16 directory (its quantized
     launches held to the code's count, q/k/v one launch a layer a step as
     the wrapper counts them by shape,
     and its decode equal to the same checkpoint without the row-stack);
     every model unloaded by DELETE, which ends its batcher's thread;
 13. Orpheus-3B int4 (Llama-3.2-3B's widths, llama3 rope, the 156940-token
     audio vocabulary; every Linear int4 g64, the embedding bf16) written
     to a checkpoint directory with a Llama-3 style tokenizer.json and
     loaded by `utils.load_model`, with seeded weights that plant a greedy
     path (each embedding row the lm_head row of its planted successor:
     END_OF_HUMAN, START_OF_AI, START_OF_SPEECH, 23 frames of valid SNAC
     codes, END_OF_SPEECH), and SNAC 24 kHz at its published widths:
     `Model.generate` end to end at the greedy defaults (a warm-up and
     ORPHEUS_TIMED runs, each run's quantized launches held to the count
     from the code, the planted codes decoded), one profiled run of 44
     tokens, the same streamed (time to first audio; each chunk equal to
     one decode of its planted frames past its context); a two-layer copy
     in float32, where the logits resolve what the layers add: card against
     CPU, every call's logits (the prompt's and each decode step's) and the
     greedy tokens, then a batched wave with each slot's logits at set
     decode steps held to its sequential run, both with planted faults (an
     off-by-one cache position, two slots reading each other's caches) that
     the bars must reject; four prompts through `make_batcher` (an
     LMContinuousBatcher at bench_snac_lm_continuous's 4 slots, 16-step
     ticks, cut to 32 tokens where it takes 128), each equal to its sequential greedy tokens, with
     launches held to the code's count; one request served over HTTP,
     equal to the in-memory samples; SNAC alone card against CPU and its
     decode_stream; Qwen3-TTS Base's x-vector card against CPU in float32,
     then a 16-frame int4 synthesis with `ref_audio` and no `ref_text`;
 14. Sesame/CSM-1B (Llama-3.2-1B's 16 x 2048 backbone, the 4 x 1024 depth
     decoder, 32 codebooks of 2051) in bf16 and the Mimi codec at
     `mimi_202407(32)`, seeded, written to a checkpoint directory in the
     upstream key layout (Mimi's safetensors in kyutai's, in mimi/, and a
     Llama-3 style tokenizer.json) and loaded by `utils.load_model` and
     `Mimi.from_pretrained`: a two-layer float32 copy card against CPU (every
     logits row of four greedy frames held to both bars, the frames
     identical, a planted off-by-one codebook offset rejected); Mimi's decode
     of 64 frames card against CPU and its streaming decode against offline
     (keys written one ring slot on rejected); `generate` with a 5 s
     reference and its text, greedy at 32 frames and sampled at 16 (wall,
     frames/s, RTF), profiled, streamed at 0.5 s to 16 frames (each chunk's
     frames the monolithic decode's, time to first audio), the watermark found on the
     output and not on unmarked audio; `bench_sesame_serving` at bench.py's
     streams, pool and prompts, cut to 8 x 4 frames (bench.py decodes 64)
     with its tick cut from bench.py's 8 to 4, one trial; greedy batched
     frames equal to sequential); `convert(quantize=True)` to int4, loaded,
     with the direct loop's quantized launches held to the code's count; one
     streamed request served over HTTP, equal to the in-memory model's
     samples; Qwen3-TTS ICL on phase 13's int4 Base model with a
     speech-tokenizer encoder at its published widths (reference codes card
     against CPU, then 16 frames);
 15. the DAC codec and its two families. DAC at 44.1 kHz (descript's
     published widths, 9 codebooks) in float32: `decode_codes` of 86 frames
     card against CPU, a reference's codes card against CPU, a code of 1024
     decoded as the last bin. Dia-1.6B (`DiaConfig()`: encoder 12 x 1024,
     decoder 18 x 2048) in bf16, seeded (channel 0's EOS column zeroed, so a
     run takes its cap), written in the JAX package's layout with that DAC
     in dac/ and loaded by `utils.load_model`: a two-layer float32 copy card
     against CPU (every decoder call's logits over a prompt and 8 steps at
     both bars, the greedy frames identical, [uncond, cond] swapped
     rejected); `generate` of a two-speaker text, greedy at 128 frames and
     sampled (1.3, cfg 3.0, top-k 35) at 64, profiled at 32 frames, a voice clone
     from 5 s (DAC encode, then the prefill); `DiaBatcher` at 4 slots x 32
     frames, batched equal to alone. Llama-OuteTTS-1.0-1B (Llama-3.2-1B's
     16 x 2048, tied embeddings over Llama-3's vocabulary and OuteTTS's added
     tokens) in bf16 with a planted greedy path of 50 c1/c2 pairs
     (`plant_outetts`), a tokenizer.json with those tokens and the 24 kHz
     DAC (2 codebooks) in dac/: `generate` greedy and sampled, profiled,
     streamed at 0.5 s, with a speaker made by `create_speaker` from 5 s;
     `LMContinuousBatcher` with 4 prompts, each equal to its sequential
     tokens; int4 by `convert`, 16 tokens with the quantized launches held
     to the code's count; a two-layer float32 copy card against CPU. Neither
     bf16 path launches a kernel of the port, and the script holds them to
     none;
 16. EnCodec and Bark-small. EnCodec at `EncodecConfig()` (facebook/
     encodec_24khz: 32 filters, ratios [8, 5, 4, 2], a 2-layer LSTM of 512,
     32 codebooks of 1024 x 128) in float32, seeded: a 5 s reference encoded
     at 6 kbps (8 codebooks) card against CPU with the codes identical,
     their decode within 1e-5 of the peak, a code of 1024 decoded as the
     last bin. Bark-small (suno/bark-small's widths: three GPTs of 12 x 768;
     semantic 129,600 tokens in, 10,048 out; coarse 12,096; fine 1,056 over
     8 codebooks) in float32, seeded, the semantic stop planted after 150
     tokens (`plant_bark_stop`: 450 coarse steps in 8 windows, 225 frames,
     3.0 s), written in the JAX package's layout with a WordPiece
     tokenizer.json of 119,547 entries and that EnCodec in encodec/, loaded
     by `utils.load_model`: a two-layer float32 copy card against CPU (the
     teacher-forced logits of all three stages at both bars, an off-by-one
     decode position rejected); `generate` sampled twice (median wall,
     RTF, the four stages' split), no kernel of the port launched; 32
     semantic steps profiled; the semantic stage run to its 768-step cap
     (its last step reads position 1024: no device assert); `BarkBatcher`
     with 4 requests, each one's codes equal to its run alone through the
     pool; one request served over HTTP after the batcher's warm-up;
     int4 by `convert` (16 semantic steps, a coarse window, a fine chunk:
     the quantized launches held to the code's count, the logits to the
     float32 model on the dequantized weights).
 17. Vocos, Soprano, Spark-TTS and Wav2Vec2. vocos-mel-24khz (100 mels,
     backbone 512/1536 x 8) on 5 s and vocos-encodec-24khz (384/1152 x 8,
     adanorm over 4 bandwidths) on phase 16's EnCodec codes of the same 5 s
     at 6 kbps, card against CPU in float32, with decode ms. Soprano-1.1
     (decoder 768/2304 x 8, n_fft 2048, hop 512) with a Qwen3 stand-in LM of
     ~80M parameters in float32, the path planted (100 tokens, then [STOP]),
     written with a tokenizer.json and loaded by `utils.load_model`: a
     two-layer copy card against CPU (hidden states and waveform), greedy
     `generate` (wall, RTF, no kernel of the port, a profiled step),
     `SopranoBatcher` with 4 requests each equal to its run alone, one served
     request. Spark-TTS-0.5B (the LLM at Qwen2.5-0.5B's widths in bf16 with
     a planted path: 32 global, 75 semantic tokens, eos; BiCodec at the
     published widths and Wav2Vec2-XLSR-53 in float32, seeded) loaded with
     BiCodec/ and wav2vec2-large-xlsr-53/ in its directory: the control
     route, the clone route from 6 s through XLSR-53 and the speaker encoder,
     BiCodec tokenize and detokenize ms, `LMContinuousBatcher` with 4 prompts
     each equal to its sequential tokens, XLSR-53 and the base CTC model on
     30 s (flash_fwd_f32 held to one launch a layer, 24 and 12), one served
     request, int4 by `convert` (the quantized launches held to the code's
     count, the logits of the prompt and 16 greedy steps to the float32
     model on the dequantized weights, the tokens to the planted path, the
     tied head's ms) and a two-layer float32 copy card against CPU.
 18. IndexTTS, on `lm/gpt2.py` and BigVGAN: `GPTConfig()` (1024 x 20, 16
     heads, 8,194 mel codes, 12,000 text tokens), `ConformerArgs()` (256 x 6)
     with the perceiver's 32 latents, and the ECAPA-conditioned BigVGAN at
     INDEXTTS_BIGVGAN (1536 channels, rates [4, 4, 4, 4, 2, 2]), in float32,
     seeded, the stop planted at step 70 (`plant_indextts_stop`: 71 latents,
     72,704 samples, 3.03 s), written to a checkpoint directory: `generate`
     from a 6 s reference through a seeded stand-in tokenizer (wall, RTF, the
     conditioning, decode and BigVGAN split, a profiled prefill and 32
     steps, the vocoder's device time; no kernel of the port launches);
     `IndexTTSBatcher` with 4 requests at top-k 1, each equal to its run
     alone (speedup); a two-layer float32 copy card against CPU (the prompt
     embedding, 24 steps' logits and latents, BigVGAN over them); int4 by
     `convert`, loaded by `utils.load_model`, 16 steps with the quantized
     launches held to the code's count, its embedding, latents and logits to
     the float32 port on the dequantized weights.
 19. S3Tokenizer, S3Gen and Chatterbox: T3 at `T3Config.english_only()` on
     Llama-520M (1024 x 30, 16 heads of 64, MLP 4096, 704 text and 8,194
     speech tokens, the perceiver and emotion_adv on), `S3Token2Wav()` (the
     conformer 512 x (6 + 4), the estimator 256 channels x 12 mid blocks,
     10 CFG Euler steps at 0.7, HiFT at [8, 5, 3], CAM++), `VoiceEncoder()`
     and S3TokenizerV2 at `ModelConfig()` (128 mels, 1280 x 6, 20 heads),
     in float32, seeded, the stop planted after 75 speech tokens
     (`plant_chatterbox`: 150 mel frames, 72,000 samples, 3.0 s), written
     in the release's layout (ve/t3_cfg/s3gen.safetensors, a stand-in
     tokenizer.json of Chatterbox's assumed components, s3tokenizer/):
     `generate` from a seeded 10 s reference at the defaults (wall, RTF,
     the conditioning, T3, flow and HiFT split, a profiled T3 step, the
     flow's and HiFT's device time; no kernel of the port launches);
     `T3Batcher` with 4 requests at temperature 0, each equal to its decode
     alone (speedup), and `generate` through the installed batcher equal to
     the direct route; a copy at full width cut in depth (T3 2 layers,
     S3Tokenizer 1, the conformer 1 + 1, the estimator 1 mid block, HiFT
     on 1 s) card against CPU; int4 by `chatterbox.convert --quantize`,
     loaded by `tts.load_model` and run by `generate_audio` for 16 steps,
     the quantized launches held to the code's count, the logits to the
     float32 port on the dequantized weights.
 20. CosyVoice2 at `CosyVoice2Config()` (Qwen2-0.5B: 896 x 24, 14 heads,
     2 kv heads, MLP 4864; the conformer 512 x (6 + 4), the U-Net 256
     channels x 12 mid blocks under 10 CFG Euler steps, HiFT at [8, 5, 3]
     with the interpolating source), S3TokenizerV2 and CAM++, float32,
     seeded, written as a consolidated checkpoint (the LM under its
     upstream names, `campplus.*`, a Qwen2-style tokenizer.json,
     s3tokenizer/): a zero-shot `generate` from a seeded 10 s reference,
     its 4-token text capping the decode at 80 steps (wall, RTF, the
     reference, LM, flow and vocoder split, a profiled LM step; no kernel
     of the port launches); one voice conversion; `RASBatcher` with 4
     requests at the argmax settings (the head scaled by 1e4), each equal
     to its decode alone, and `generate` through the installed batcher
     equal to the direct route; a copy at full width cut in depth (the LM
     2 layers, the conformer 1 + 1, the U-Net 1 mid block) card against
     CPU; int4 by `convert --quantize`, loaded by `tts.load_model` and run
     by `generate_audio`, then the LM decode alone with its quantized
     launches held to the code's count and its logits to the float32 port
     on the dequantized weights.
 21. CosyVoice3 at `CosyVoice3Config()` (the Qwen2-0.5B LM over 6,761
     speech rows; the DiT 1024 x 22, 16 heads of 64; the causal HiFT),
     S3TokenizerV3 (12 layers) and CAM++, float32, seeded, the LM head's
     rows past the speech tokens zero (the decode runs to its cap): a
     zero-shot `generate` from the 10 s reference (80 tokens; timed and
     split as phase 20); `tokens_to_mel` and `mel_to_audio` on the
     reference's 250 prompt tokens and 400 seeded ones (N = 1300 frames),
     where the DiT's unmasked attention launches `flash_fwd_f32` once a
     block an Euler step, 220 times, counted through the wrapper; a copy
     cut in depth (the LM 2 layers, the DiT 2 blocks) card against CPU.
 22. Chatterbox-Turbo: T3Turbo on GPT-2 medium (1024 x 24, 16 heads) and
     the meanflow S3Gen (two steps), `VoiceEncoder()`, S3TokenizerV2,
     float32, seeded, the stop's head row zero (top-k 1000 never keeps it:
     the decode runs to `max_gen_len`): `generate` from a seeded 10 s
     reference (loudness-normalised) to 75 tokens (wall, RTF, the
     conditioning, T3, flow and HiFT split, a profiled T3 step; no kernel
     of the port launches); `TurboBatcher` with 4 requests at temperature
     0, each equal to its decode alone, and `generate` through the
     installed batcher equal to the direct route; a copy cut in depth
     (GPT-2 2 layers, S3Tokenizer 1, the conformer 1 + 1, the estimator 1
     mid block) card against CPU.
Phase 2 also holds the ReLU² attention kernel to its plain version and
flash at B = 1, and the serving shapes: flash bf16 at B = 8, `qmm_mma` and
the fused MLP at M = 8 (the batcher's tick), ReLU² f32 at B = 8, G = 2;
phase 3 a one-block MossFormer2-SE on the card to the CPU, and Whisper's
score pass, seek loop and beam search card against CPU.
Phase 5 ends with the unquantized bf16 Qwen3-TTS (bench.py's
`bench_qwen3_tts()`). Phase 2 also holds the Orpheus-3B shapes (the GEMV
at M = 1 and 4 on q/k/v, o_proj and the 156940-row lm_head, the fused MLP,
the tensor-core GEMM at M = 32) and times them, and CSM-1B int4's (float32
x: the GEMV at M = 1 and 2 on both stacks' q/k/v and o_proj, the
projection and the 2051-row codebook0_head, the tensor-core GEMM at the
batcher's M = 8 and 16 and a 64-row prompt, the fused MLP at K = 2048 and
1024, I = 8192), and Spark-TTS int4's (float32 x: the GEMV at a decode
step's four shapes, K = 896 and 4864, the tensor-core GEMM at the same four
at its 20-token prompt) and flash f32 at Wav2Vec2's 30 s (B = 1, T = S = 1499, H = 12 and
16), and IndexTTS int4's (float32 x: the GEMV at a decode step's four
GPT-2 shapes and the 8,194-row mel head, M = 1 and 4, the tensor-core GEMM at
its 44-row prompt and at the conformer's and perceiver's shapes), and
Chatterbox T3 int4's (float32 x: the GEMV and the fused MLP at the CFG
pair's M = 2, the tensor-core GEMM at the pair's 57-row prompt, M = 114,
and the batcher's M = 8), and the CosyVoice shapes: flash at the DiT's
CFG pair (B = 2, H = 16, D = 64, T = S = 1300 and 1500, f32 and bf16)
beside `F.sdpa`, and int4 CosyVoice2's qmm (the GEMV at the 6,564-row LM
head, the tensor-core GEMM at its 257-row prompt and at the flow's
linears). The lines
before the last
hold phase 8's numbers ({"kokoro": ...}), the bf16 Qwen3-TTS step's
({"qwen3_bf16": ...}), phase 9's ({"whisper_rest": ...}), phase 10's
({"loaded": ...}), phase 11's ({"serving": ...}), phase 12's ({"server":
...}), phase 13's ({"orpheus": ...}), phase 14's ({"csm": ...}), phase
15's ({"dia_outetts": ...}), phase 16's ({"bark": ...}), phase 17's
({"spark_soprano": ...}), phase 18's ({"indextts": ...}), phase 19's
({"chatterbox": ...}), phase 20's ({"cosyvoice2": ...}), phase 21's
({"cosyvoice3": ...}), phase 22's ({"chatterbox_turbo": ...}) and the
kernels' JSON record, in that order;
the last line is {"ok": true, "device": {...}}. Any failure raises and exits non-zero. It
needs one CUDA card and the checkout's `mlx_audio_tpu_torch/` package.
`--phases 1,2` runs a subset (a first check of new kernels), `--phases
1,12` the server (with phase 10 before it), `--phases 1,13` Orpheus,
`--phases 1,14` CSM-1B and Mimi, `--phases 1,15` DAC, Dia and OuteTTS,
`--phases 1,16` EnCodec and Bark, `--phases 1,17` Vocos, Soprano, Spark-TTS
and Wav2Vec2, `--phases 1,18` IndexTTS, `--phases 1,19` S3Tokenizer, S3Gen
and Chatterbox, `--phases 1,20,21,22` CosyVoice2, CosyVoice3 and
Chatterbox-Turbo; the default runs all of them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense peaks at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def ops_s(flops, dtype) -> float:
    """The least time of `flops` on `dtype` operands: the bf16 tensor-core
    peak; float32 operands as three bf16 products each (the split that
    keeps float32's accuracy, faster than the CUDA cores' 67 TFLOP/s)."""
    return flops * (1 if dtype == torch.bfloat16 else 3) / PEAK_BF16_FLOPS


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
# Tokens of a card and a CPU decode may part only at a near-tie: two runs
# whose logits each lie within CARD_VS_CPU_ATOL of the exact ones can swap
# two candidates closer than twice that, and no others.
TOKEN_TIE_BAR = 2 * CARD_VS_CPU_ATOL
WARMUP_RUNS, TIMED_RUNS = 3, 7

# Quantized kernels against their plain versions. Both sum in float32 in
# other orders, and the kernel dequantizes with one fused multiply-add
# (q*s + b) where the plain version follows the TPU formula (sum x*q*s plus
# per-group sums of x times b): float32 outputs differ by ~1e-7 relative.
# bf16 outputs round that float32 once on both sides, so they agree except
# where it straddles a rounding boundary: one ulp. A kernel that drops the
# bias term or reads the scales of the neighbouring group is off by O(1)
# relative; `planted_quant_check` shows each bar rejects both.
Q_F32_PEAK_REL = 1e-4  # max|d| <= this * max|ref|
Q_F32_REL = 1e-5       # ||d|| / ||ref||
Q_BF16_ULPS = 1        # max|d| <= 1 bf16 ulp at max|ref|
Q_BF16_REL = 1e-3
GROUP = 64
L2_BYTES = 50e6  # the H100's L2: timed weights cycle through twice this

# Qwen3-TTS: bench.py's text, with a copy of its deterministic tokenizer
QWEN_TEXT = ("The quick brown fox jumps over the lazy dog while the "
             "synthesis model turns text into speech. " * 3).strip()
# 32 frames (256 until phase 12 came, 64 until phase 13 came) and one
# counted run after the warm-up (two until phase 11 came): the run keeps its
# wall under ~1000 s on a slow host
QWEN_FRAMES, QWEN_FRAMES_6BIT, QWEN_PROFILE_FRAMES = 32, 16, 16
QWEN_WARMUP, QWEN_TIMED = 1, 1
# card (kernels) against CPU (dequantize + matmul), float32, TF32 off
QWEN_CARD_VS_CPU_ATOL = 1e-4

# ReLU² attention against its plain version (cuBLAS, TF32 off), with the
# quantized kernels' bars (compare_q): float32 max|d| <= 1e-4 max|ref| and
# ||d||/||ref|| <= 1e-5, since both sum the same float32 products in other
# orders (~1e-6 relative); bf16 within R2_BF16_ULPS ulp at max|ref| and
# rel 1e-3: both round the weights to bf16 from float32 scores that differ
# only in summation order, and the float32 sums once, so a weight that
# rounds the other way can add a second ulp to one output. A kernel that
# squares negative scores, or skips the last, ragged key tile, is off by
# rel >= 1e-2; `planted_relu2_check` shows the bars reject both.
R2_BF16_ULPS = 2
R2_CASES = [  # name, B, G, N, D, E, dtype, v a split half (row stride 2E)
    ("chunk20s_f32", 1, 10, 256, 128, 1024, torch.float32, True),
    ("chunk20s_bf16", 1, 10, 256, 128, 1024, torch.bfloat16, True),
    ("chunk4s_f32", 1, 2, 256, 128, 1024, torch.float32, True),
    ("chunk4s_bf16", 1, 2, 256, 128, 1024, torch.bfloat16, True),
    ("contiguous_v_f32", 1, 2, 256, 128, 1024, torch.float32, False),
    # MossFormer2's one call per FLASH layer: v;u whole (E = 2 x 1024)
    ("merged20s_f32", 1, 10, 256, 128, 2048, torch.float32, False),
    ("merged20s_bf16", 1, 10, 256, 128, 2048, torch.bfloat16, False),
    ("merged4s_f32", 1, 2, 256, 128, 2048, torch.float32, False),
    ("merged4s_bf16", 1, 2, 256, 128, 2048, torch.bfloat16, False),
    # the serving batcher: eight 4 s chunks stacked into one forward
    ("merged4s_b8_f32", 8, 2, 256, 128, 2048, torch.float32, False),
    ("ragged200_f32", 2, 3, 200, 128, 64, torch.float32, False),
    ("ragged200_bf16", 2, 3, 200, 128, 64, torch.bfloat16, True),
    ("ragged13_d64_f32", 1, 4, 13, 64, 40, torch.float32, False),
    ("ragged13_d64_bf16", 1, 4, 13, 64, 40, torch.bfloat16, True),
    ("n2500_f32", 1, 1, 2500, 128, 200, torch.float32, True),
    ("n2500_bf16", 1, 1, 2500, 128, 200, torch.bfloat16, False),
]
# MossFormer2-SE, card against CPU: one block at full width, f32, TF32 off,
# the same dither draw on both. Mask and waveform within this share of their
# peak: cuFFT against pocketfft and other summation orders leave ~1e-6.
MOSS_CARD_VS_CPU_REL = 1e-4
# seconds, route, chunks: up to 20 s in one shot; to 60 s, 4 s windows at a
# 3 s stride over the audio padded to whole strides (30 s → 31 s, 10
# windows); from 60 s, 4 s chunks at a 3 s stride, the tail its own chunk
# (90 s: 29 chunks and a 3 s one)
MOSS_REQUESTS = [(20.0, "one shot", 1), (30.0, "segmented", 10), (90.0, "chunked", 30)]
MOSS_WARMUP, MOSS_TIMED = 1, 3

# Kokoro-82M: bench.py's configuration, vocabulary and phonemes (copied:
# bench.py imports jax)
KOKORO_82M_CONFIG = dict(
    istftnet=dict(resblock_kernel_sizes=[3, 7, 11], upsample_rates=[10, 6],
                  upsample_initial_channel=512,
                  resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                  upsample_kernel_sizes=[20, 12], gen_istft_n_fft=20, gen_istft_hop_size=5),
    dim_in=64, dropout=0.2, hidden_dim=512, max_conv_dim=512, max_dur=50, multispeaker=True,
    n_layer=3, n_mels=80, n_token=178, style_dim=128, text_encoder_kernel_size=5,
    plbert=dict(hidden_size=768, num_attention_heads=12, intermediate_size=2048,
                max_position_embeddings=512, num_hidden_layers=12, embedding_size=128,
                dropout=0.1))
KOKORO_VOCAB_CHARS = "abcdefghijklmnopqrstuvwxyzæɑɔɛɪʊʌəɹŋθðʃʒʧʤˈˌAIOWY ɡɜɾ.,!?;:\"'()…—"
KOKORO_PHONEMES = ("ðə kwˈɪk bɹˈWn fˈɑks ʤˈʌmps ˈOvəɹ ðə lˈAzi dˈɔɡ, "
                   "ænd ðə sˈɪnθəsɪs mˈɑdəl tˈɜɹnz tˈɛkst ˈɪntu spˈiʧ. ") * 5
KOKORO_TIMED = 5
# Card against CPU, float32 and TF32 off on both, the same noise draw: the
# activations agree to float32 rounding, and the int16 output may round one
# step (3.05e-5) either way; measured: one step on an H100 80GB HBM3 at
# 700 W. The bar is phase 3's 1e-4 of the peak. (A voiced sine source
# would need more: its phase is a float32 cumulative sum reaching 1e5 rad
# over 25 s, summed in another order on the card; the port's generator
# against the JAX package's needs 5e-3 for that in tests/test_torch_kokoro.py.)
KOKORO_CARD_VS_CPU_REL = 1e-4


class AsciiTok:
    """Minimal deterministic text tokenizer (a copy of bench.py's)."""

    def encode(self, text, **kw):
        return [(ord(c) % 997) + 3 for c in text]


# tokenizer.json files the run writes into its checkpoint directories (the
# card has no `tokenizers` to train one): the 256 byte-level symbols, merges
# learned from a seeded text, unique filler tokens up to the base
# vocabulary, and the added tokens at the ids the models use, by name. The
# tests hold the port's reader to `tokenizers` on this generator's output.
TOKENIZER_MERGES = 300
TOKENIZER_WORDS = ("assistant", "user", "the", "quick", "brown", "fox", "jumps", "over",
                   "lazy", "dog", "while", "synthesis", "model", "turns", "text", "into",
                   "speech", "concurrent", "stream", "number", "hello", "world")
WHISPER_TIMESTAMPS = 1501  # <|0.00|> .. <|30.00|>


def whisper_added_tokens(n_vocab: int = TURBO["n_vocab"]):
    """(base vocabulary size, [(content, id, special)]) in Whisper's order:
    <|endoftext|>, <|startoftranscript|>, the languages, the task and
    control tokens, then the timestamps, ending at n_vocab."""
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import LANGUAGES

    names = (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{c}|>" for c in LANGUAGES]
             + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                "<|nospeech|>", "<|notimestamps|>"])
    base = n_vocab - WHISPER_TIMESTAMPS - len(names)
    added = [(n, base + i, True) for i, n in enumerate(names)]
    added += [(f"<|{i * 0.02:.2f}|>", base + len(names) + i, False)
              for i in range(WHISPER_TIMESTAMPS)]
    return base, added


def qwen_added_tokens():
    """(base vocabulary size, [(content, id, special)]): Qwen2's special
    tokens from <|endoftext|> on, ids contiguous as `tokenizers` assigns
    them, up to the three text-side ids Qwen3-TTS's config names."""
    names = (["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
              "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
              "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
              "<|image_pad|>", "<|video_pad|>"]
             + [(n, False) for n in ("<tool_call>", "</tool_call>", "<|fim_prefix|>",
                                     "<|fim_middle|>", "<|fim_suffix|>", "<|fim_pad|>",
                                     "<|repo_name|>", "<|file_sep|>", "<tool_response>",
                                     "</tool_response>", "<think>", "</think>")]
             + ["<|reserved_0|>", "<|reserved_1|>", "<tts_pad>", "<tts_text_bos>",
                "<tts_text_eod>"])
    base = 151643
    return base, [(n, base + i, True) if isinstance(n, str) else (n[0], base + i, n[1])
                  for i, n in enumerate(names)]


def llama3_added_tokens():
    """(base vocabulary size, [(content, id, special)]): Llama-3.2's 256
    special tokens from <|begin_of_text|> (128000) on; <|eot_id|> is 128009,
    Orpheus's END_OF_TEXT."""
    names = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
             "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
             "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
             "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
    names += [f"<|reserved_special_token_{k}|>" for k in range(3, 3 + 256 - len(names))]
    base = 128000
    return base, [(n, base + i, True) for i, n in enumerate(names)]


# OuteTTS-1.0's added tokens after Llama-3's 128,256, in the formats of
# tts/models/outetts/tokens.py: its 16 markers, <|c1_0|> .. <|c1_1024|> and
# <|c2_0|> .. <|c2_1024|> (prompt_processor.py's 1025 codes a codebook), the
# word times <|t_0.00|> .. <|t_10.00|>, and energy, spectral centroid and
# pitch at 0 .. 100 each
OUTETTS_TIMES = 1001


def outetts_added_tokens():
    """(base vocabulary size, [(content, id, special)]): Llama-3's, then
    OuteTTS's tokens from 128256 on, 3370 of them."""
    from mlx_audio_tpu_torch.tts.models.outetts.tokens import SpecialTokens

    base, added = llama3_added_tokens()
    st = SpecialTokens()
    names = [st.bos, st.eos, st.text_start, st.text_end, st.voice_characteristic_start,
             st.voice_characteristic_end, st.emotion_start, st.emotion_end, st.audio_start,
             st.audio_end, st.code, st.word_start, st.word_end, st.features,
             st.global_features_start, st.global_features_end]
    names += [st.c1.format(i) for i in range(1025)] + [st.c2.format(i) for i in range(1025)]
    names += [st.time.format(i / 100) for i in range(OUTETTS_TIMES)]
    for fmt in (st.energy, st.spectral_centroid, st.pitch):
        names += [fmt.format(i) for i in range(101)]
    first = base + len(added)
    return base, added + [(n, first + i, False) for i, n in enumerate(names)]


# Soprano's tokenizer: a byte-level BPE vocabulary with its three markers
# and an end-of-text token as added tokens
SOPRANO_ADDED = ("<|endoftext|>", "[STOP]", "[TEXT]", "[START]")


def soprano_added_tokens(base: int = 16380):
    """(base vocabulary size, [(content, id, special)]): Soprano's markers
    after a `base`-token vocabulary, <|endoftext|> special (its eos)."""
    return base, [(n, base + i, i == 0) for i, n in enumerate(SOPRANO_ADDED)]


# Spark-TTS's added tokens after Qwen2.5's, in the formats spark.py and
# token_parser.py render: the task and section markers, the attribute
# labels, <|bicodec_global_0|> .. and <|bicodec_semantic_0|> ..
SPARK_MARKERS = ("<|start_content|>", "<|end_content|>", "<|start_style_label|>",
                 "<|end_style_label|>", "<|start_global_token|>", "<|end_global_token|>",
                 "<|start_semantic_token|>", "<|end_semantic_token|>")


def spark_added_tokens(base: int = 151643, n_global: int = 4096, n_semantic: int = 8192):
    """(base vocabulary size, [(content, id, special)]): Qwen2.5's 22
    special tokens after a `base`-token vocabulary, then Spark-TTS's."""
    from mlx_audio_tpu_torch.tts.models.spark.token_parser import (AGE_MAP, EMO_MAP,
                                                                   TASK_TOKEN_MAP)

    _, qwen = qwen_added_tokens()
    added = [(c, base + i, sp) for i, (c, _, sp) in enumerate(qwen[:22])]
    names = list(TASK_TOKEN_MAP.values()) + list(SPARK_MARKERS)
    names += [f"<|gender_{i}|>" for i in range(2)] + [f"<|age_{i}|>" for i in AGE_MAP.values()]
    names += [f"<|emotion_{i}|>" for i in EMO_MAP.values()]
    for label in ("pitch_label", "pitch_var_label", "loudness_label", "speed_label"):
        names += [f"<|{label}_{i}|>" for i in range(5)]
    names += [f"<|bicodec_global_{i}|>" for i in range(n_global)]
    names += [f"<|bicodec_semantic_{i}|>" for i in range(n_semantic)]
    first = base + len(added)
    return base, added + [(n, first + i, False) for i, n in enumerate(names)]


def train_merges(n_merges: int, seed: int) -> list:
    """Byte-level BPE merges learned from a seeded text: the most frequent
    adjacent pair first, ties to the larger pair; words both bare and after
    a space, as the pre-tokenizers cut them."""
    from collections import Counter

    from mlx_audio_tpu_torch.tokenizer_json import bytes_to_unicode

    b2u = bytes_to_unicode()
    rng = np.random.default_rng(seed)
    syll = ["ka", "to", "ri", "en", "st", "an", "qu", "er", "ing", "th", "ou", "ch"]
    words = [w for w in TOKENIZER_WORDS for _ in range(8)]
    words += ["".join(rng.choice(syll, rng.integers(1, 4))) for _ in range(400)]
    counts = Counter()
    for w in words:
        for form in (w, " " + w):
            counts[tuple(b2u[b] for b in form.encode())] += 1
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in counts.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        merged = Counter()
        for w, c in counts.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        counts = merged
    return merges


def write_tokenizer_json(path, style: str, seed: int = 0,
                         n_merges: int = TOKENIZER_MERGES, **sizes) -> Path:
    """A byte-level BPE tokenizer.json: style "whisper" (GPT-2's ByteLevel
    pre-tokenizer, merges as "a b" strings, Whisper-large-v3's added tokens),
    "qwen2" (NFC, Qwen2's Split pattern, merges as pairs, the chat tokens)
    or "llama3" (Llama-3's Split pattern, merges as pairs, its special
    tokens, and a post-processor that puts <|begin_of_text|> first), or
    "outetts" (llama3 with OuteTTS's added tokens after Llama-3's), or
    "soprano" and "spark" (qwen2's pre-tokenizer with their own added
    tokens; `sizes` passes the vocabulary's sizes to their
    `*_added_tokens`)."""
    from mlx_audio_tpu_torch.tokenizer_json import (LLAMA3_PATTERN, QWEN2_PATTERN,
                                                    bytes_to_unicode)

    base, added = {"whisper": whisper_added_tokens, "qwen2": qwen_added_tokens,
                   "llama3": llama3_added_tokens, "outetts": outetts_added_tokens,
                   "soprano": soprano_added_tokens,
                   "spark": spark_added_tokens}[style](**sizes)
    vocab = {c: b for b, c in bytes_to_unicode().items()}
    merges = train_merges(n_merges, seed)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    for k in range(base - len(vocab)):
        vocab[f"<|fill{k}|>"] = len(vocab)
    assert len(vocab) == base
    byte_level = dict(type="ByteLevel", add_prefix_space=False, trim_offsets=True,
                      use_regex=True)
    if style == "whisper":
        normalizer, pre = None, byte_level
        merges = [f"{a} {b}" for a, b in merges]
    else:
        normalizer = {"type": "NFC"} if style in ("qwen2", "soprano", "spark") else None
        pre = {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "behavior": "Isolated", "invert": False, "pattern": {
                "Regex": LLAMA3_PATTERN if style in ("llama3", "outetts")
                else QWEN2_PATTERN}},
            dict(byte_level, use_regex=False, trim_offsets=False)]}
        merges = [[a, b] for a, b in merges]
    post = dict(byte_level, trim_offsets=False)
    if style in ("llama3", "outetts"):
        bos = "<|begin_of_text|>"
        post = {"type": "Sequence", "processors": [
            dict(byte_level, add_prefix_space=True, trim_offsets=False), {
                "type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}}],
                "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                         {"Sequence": {"id": "A", "type_id": 0}},
                         {"SpecialToken": {"id": bos, "type_id": 1}},
                         {"Sequence": {"id": "B", "type_id": 1}}],
                "special_tokens": {bos: {"id": bos, "ids": [base], "tokens": [bos]}}}]}
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                              "rstrip": False, "normalized": False, "special": sp}
                             for c, i, sp in added],
            "normalizer": normalizer, "pre_tokenizer": pre,
            "post_processor": post,
            "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}
    path = Path(path)
    if path.suffix != ".json":
        path = path / "tokenizer.json"
    path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    return path


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
    64 read in full, the 36 keys past S = 1500 zero. The bar of q's dtype
    must reject it, or it could not catch such a kernel."""
    pad = -k.shape[-2] % 64
    assert pad, "the planted check needs S that is not a multiple of 64"
    kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
    planted = flash_attention_reference(q, kp, vp)
    ok, _, desc = compare(planted, flash_attention_reference(q, k, v), q.dtype)
    log(f"[kernel] planted fault (no ragged-key mask, {pad} zero keys): {desc} -> "
        f"{'passes: the bar is too loose' if ok else 'rejected'}")
    if ok:
        raise SystemExit(f"chip_smoke: the {q.dtype} bar accepts a kernel without the key mask")


def attention_bound_ms(B, H, T, S, D, dtype, causal) -> tuple:
    pairs = T * (T + 1) / 2 if causal else T * S
    flops = 4.0 * B * H * pairs * D
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * B * H * D * (2 * T + 2 * S)  # q, o read/written; k, v read
    t_ops, t_bytes = ops_s(flops, dtype), nbytes / PEAK_BYTES
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
    # float32 means float32 in every phase: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mlx_audio_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.load_library()
    wall = time.perf_counter() - t0
    entry = "?"
    for line in _build.last_build["log"].splitlines():  # one line per kernel
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif "registers" in line:
            log(f"[ptxas] {entry}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            log(f"[ptxas] {entry}: {line.strip()}")
        elif "warning" in line:  # e.g. wgmma serialised, setmaxnreg ignored
            log(f"[ptxas] {line.strip()}")
    log(f"[build] {wall:.1f} s (nvcc {_build.last_build['seconds']:.1f} s, "
        f"cached={_build.last_build['cached']}) -> {_build.last_build['path']}")
    return smi


def phase_kernels():
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_reference)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, H, T, S, D, dtype, causal
        ("whisper_bf16", 4, 20, 1500, 1500, 64, bf16, False),
        ("whisper_f32", 4, 20, 1500, 1500, 64, f32, False),
        # B = 1: one 30 s window, as the seek loop, streaming and word timing
        # encode it
        ("whisper_b1_bf16", 1, 20, 1500, 1500, 64, bf16, False),
        ("whisper_b1_f32", 1, 20, 1500, 1500, 64, f32, False),
        # B = 8: eight 30 s windows in one encode, the serving batcher's
        ("whisper_b8_bf16", 8, 20, 1500, 1500, 64, bf16, False),
        ("ragged_bf16", 2, 20, 700, 1500, 64, bf16, False),
        ("ragged_f32", 1, 4, 700, 1500, 64, f32, False),
        ("causal_bf16", 2, 20, 1500, 1500, 64, bf16, True),
        ("causal_f32", 1, 4, 1500, 1500, 64, f32, True),
        ("d128_bf16", 2, 8, 1500, 1500, 128, bf16, False),
        ("d128_f32", 1, 8, 1300, 1333, 128, f32, False),
        ("d80_bf16", 1, 4, 1400, 1400, 80, bf16, False),
        # the bf16 kernel's edges: fewer keys than one 128-key tile; a ragged
        # diagonal tile; D = 128 at the Whisper shape; T not a multiple of
        # the 128-query block; D below one 64-column box
        ("s40_bf16", 2, 4, 300, 40, 64, bf16, False),
        ("causal1300_bf16", 2, 8, 1300, 1300, 64, bf16, True),
        ("d128_whisper_bf16", 4, 20, 1500, 1500, 128, bf16, False),
        ("t777_bf16", 2, 6, 777, 1500, 64, bf16, False),
        ("d40_bf16", 1, 4, 1300, 1333, 40, bf16, False),
        # Wav2Vec2 on 30 s (1,499 frames), float32: the base CTC model's 12
        # heads and XLSR-53's 16
        ("w2v_base_f32", 1, 12, 1499, 1499, 64, f32, False),
        ("w2v_xlsr_f32", 1, 16, 1499, 1499, 64, f32, False),
        # CosyVoice3's DiT: the CFG pair, 16 heads of 64, unmasked, at the long
        # flow call's N = 1300 (phase 21) and at 1500
        ("cv3_dit1300_f32", 2, 16, 1300, 1300, 64, f32, False),
        ("cv3_dit1300_bf16", 2, 16, 1300, 1300, 64, bf16, False),
        ("cv3_dit1500_f32", 2, 16, 1500, 1500, 64, f32, False),
        ("cv3_dit1500_bf16", 2, 16, 1500, 1500, 64, bf16, False),
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
        if name in ("whisper_bf16", "whisper_f32"):
            planted_mask_check(q, k, v, flash_attention_reference)

    timing = {}
    for name, B, dtype, H, T in (("whisper_bf16", 4, bf16, 20, 1500),
                                 ("whisper_f32", 4, f32, 20, 1500),
                                 ("whisper_b1_bf16", 1, bf16, 20, 1500),
                                 ("whisper_b1_f32", 1, f32, 20, 1500),
                                 ("whisper_b8_bf16", 8, bf16, 20, 1500),
                                 ("w2v_base_f32", 1, f32, 12, 1499),
                                 ("w2v_xlsr_f32", 1, f32, 16, 1499),
                                 ("cv3_dit1300_f32", 2, f32, 16, 1300),
                                 ("cv3_dit1300_bf16", 2, bf16, 16, 1300),
                                 ("cv3_dit1500_f32", 2, f32, 16, 1500),
                                 ("cv3_dit1500_bf16", 2, bf16, 16, 1500)):
        S, D = T, 64
        q, k, v = attention_inputs(B, H, T, S, D, dtype, seed=100)
        # device time: at B = 1 the kernel is shorter than a Python launch
        # (ctypes and the per-call tensor maps), which CUDA events around a
        # loop of launches would measure instead
        bound, by = attention_bound_ms(B, H, T, S, D, dtype, False)
        ms, loop = device_ms([lambda: flash_attention(q, k, v)], 40)
        ms = not_below_bound(f"flash {name}", ms, loop, bound)
        plain = time_ms(lambda: flash_attention_reference(q, k, v), iters=5)
        lib, lib_loop = device_ms([lambda: F.scaled_dot_product_attention(q, k, v)], 40)
        lib = not_below_bound(f"F.sdpa {name}", lib, lib_loop, bound)
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                            bound_by=by, host_loop_ms=loop)
        log(f"[time] flash_attention {name} B={B} H={H} T=S={T}, device time per call: kernel "
            f"{ms:.4f} ms, "
            f"plain {plain:.4f} ms, F.sdpa {lib:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"kernel at {100 * bound / ms:.1f}% of bound, "
            f"{'faster' if ms < lib else 'slower'} than F.sdpa; a Python loop of launches "
            f"takes {loop:.4f} ms a call")
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
    xa_c, kv_c = cpu._encode(mel[:1])  # the seek loop's first window
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
    # the score-capturing pass word timing reads (B = 1, one flash per layer)
    text = torch.tensor([[50258, 50259, 50360, 50364] + list(range(1000, 1040, 3))])
    qlg_c, qks_c = cpu.forward_with_cross_qk(mel[:1], text)
    qlg_g, qks_g = card.forward_with_cross_qk(mel[:1].cuda(), text.cuda())
    qlg_err = (qlg_g.cpu() - qlg_c).abs().max().item()
    qk_err = max((g.cpu() - c).abs().max().item() for g, c in zip(qks_g, qks_c))
    log(f"[card-vs-cpu] forward_with_cross_qk over {text.shape[1]} tokens: logits "
        f"max|d|={qlg_err:.3e}, cross-attention scores max|d|={qk_err:.3e} "
        f"(atol {CARD_VS_CPU_ATOL:g})")
    for what, err in (("mel", mel_err), ("encoder", enc_err), ("logits", lg_err),
                      ("cross-qk logits", qlg_err), ("cross-qk scores", qk_err)):
        if not err <= CARD_VS_CPU_ATOL:
            raise SystemExit(f"chip_smoke: card vs CPU {what} max|d| {err}")
    whisper_tokens_card_vs_cpu(cpu, card, audio, kv_c)
    del cpu, card
    torch.cuda.empty_cache()


def whisper_tokens_card_vs_cpu(cpu, card, audio, kv_c) -> None:
    """The seek loop (greedy) and beam search (K = 3) on one 30 s window at
    sample_len=16, card against CPU. Where the tokens part, the CPU model's
    logits after the common prefix show whether it was a near-tie: the
    logits of the two tokens chosen must lie within TOKEN_TIE_BAR (beam
    search: the two winners' summed log-probs)."""
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

    tok = DummyTokenizer(n_vocab=TURBO["n_vocab"])
    kw = dict(language="en", temperature=0.0, sample_len=16, without_timestamps=True,
              tokenizer=tok)
    prompt = list(tok.sot_sequence_including_notimestamps)
    for label, run in (
            ("seek loop", lambda m: m.generate(audio, condition_on_previous_text=False, **kw)),
            ("beam K=3", lambda m: m.generate_chunked(audio, beam_size=3, **kw))):
        got, ref = run(card).segments, run(cpu).segments
        a, b = got[0]["tokens"], ref[0]["tokens"]
        if len(got) != 1 or len(ref) != 1 or len(b) != 16:
            raise SystemExit(f"chip_smoke: {label} gave {len(got)} and {len(ref)} windows")
        if a == b:
            log(f"[card-vs-cpu] {label}: 16 tokens identical on the card and the CPU")
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        with torch.inference_mode():
            lg = cpu.decoder(torch.tensor([prompt + b[:i]]), 0, None, kv_c)[0][0, -1].float()
        top = lg.topk(2).values
        margin = (top[0] - top[1]).item()
        if label == "seek loop":
            gap = abs(lg[a[i]] - lg[b[i]]).item() if i < min(len(a), len(b)) else float("inf")
        else:
            gap = abs(got[0]["avg_logprob"] * (len(a) + 1) - ref[0]["avg_logprob"] * (len(b) + 1))
        log(f"[card-vs-cpu] {label}: the card and the CPU part at step {i} (card {a[i:i + 3]}, "
            f"CPU {b[i:i + 3]}); top-2 logit margin there {margin:.3e}, gap between the "
            f"two choices {gap:.3e} (bar {TOKEN_TIE_BAR:g})")
        if not gap <= TOKEN_TIE_BAR:
            raise SystemExit(f"chip_smoke: {label} tokens part at step {i} with a gap of "
                             f"{gap}, not a near-tie")


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

    n_tok = check_transcript(first, outs, sample_len)
    log(f"[slice] {len(first.segments)} windows, tokens per window {n_tok}, "
        f"flash_attention launches in one transcription: {launches}")
    if launches <= 0:
        raise SystemExit("chip_smoke: the main path launched no flash_attention kernel")

    med = statistics.median(walls)
    log(f"[slice] 120 s audio, {TIMED_RUNS} runs after {WARMUP_RUNS} warm-up: walls "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; median {med:.4f} s = "
        f"{seconds / med:.1f}x real time (all runs {seconds * len(walls) / sum(walls):.1f}x, "
        f"best {seconds / min(walls):.1f}x); peak memory {peak_gb:.2f} GB")
    _, seen = profile_one_run(run)
    flash = {k: n for k, (n, _) in seen.items() if "flash_fwd_bf16" in k}
    if seen and list(flash.values()) != [launches]:
        raise SystemExit(f"chip_smoke: the profile shows flash kernels {flash}, not one kernel "
                         f"launched {launches} times")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, whisper_f32(audio, tok, sample_len)


def check_transcript(first, outs, sample_len) -> list:
    """Four windows of 1 .. sample_len in-range tokens with finite scores,
    the same tokens in every run; returns the tokens per window."""
    segs = first.segments
    n_tok = [len(s["tokens"]) for s in segs]
    if len(segs) != 4 or not all(0 < n <= sample_len for n in n_tok):
        raise SystemExit(f"chip_smoke: unexpected segments {n_tok}")
    for s in segs:
        if not (np.isfinite(s["avg_logprob"]) and 0.0 <= s["no_speech_prob"] <= 1.0):
            raise SystemExit(f"chip_smoke: non-finite scores in {s}")
        if not all(0 <= t < TURBO["n_vocab"] for t in s["tokens"]):
            raise SystemExit("chip_smoke: token id out of range")
    if any([s["tokens"] for s in o.segments] != [s["tokens"] for s in segs] for o in outs):
        raise SystemExit("chip_smoke: repeated runs disagree")
    return n_tok


def whisper_f32(audio, tok, sample_len) -> int:
    """The same 120 s transcription in float32, the Whisper model's default
    dtype: the encoder's self-attention takes the f32 flash kernel, one
    launch per encoder layer for the four windows together. A warm-up, a
    counted run and a profiled run; tokens equal across the first two."""
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    model = Model(ModelDimensions(**TURBO), seed=0)
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise SystemExit("chip_smoke: the default Whisper model is not float32")

    def run():
        out = model.generate_chunked(
            audio, language="en", temperature=0.0, tokenizer=tok,
            without_timestamps=True, sample_len=sample_len)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    warm = run()
    warm_s = time.perf_counter() - t0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    launches, predicted = flash_attention.launches, TURBO["n_audio_layer"]
    n_tok = check_transcript(out, [warm], sample_len)
    log(f"[slice-f32] whisper-large-v3-turbo dims, float32: warm-up wall {warm_s:.4f} s, "
        f"counted wall {wall:.4f} s ({120.0 / wall:.1f}x real time), tokens per window "
        f"{n_tok}, flash_attention launches {launches} (predicted {predicted}, one per "
        f"encoder layer)")
    if launches != predicted:
        raise SystemExit(f"chip_smoke: the f32 transcription launched flash {launches} times, "
                         f"predicted {predicted}")
    _, seen = profile_one_run(run, "one f32 transcription")
    flash = {k: n for k, (n, _) in seen.items() if "flash_fwd" in k}
    if seen and (len(flash) != 1 or "flash_fwd_f32" not in next(iter(flash))
                 or sum(flash.values()) != launches):
        raise SystemExit(f"chip_smoke: the f32 profile shows flash kernels {flash}, not "
                         f"flash_fwd_f32 launched {launches} times")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the port's kernels, which every profile lists whether or not they rank
# among the top eight
PORT_KERNELS = ("flash_fwd", "qmm_kernel", "qmm_gemv", "qmm_mma", "qmlp_kernel", "relu2_")


def device_kernels(prof) -> dict:
    """{name: (launches, device us)} of the kernels, copies and memsets a
    torch.profiler session recorded on the card, read from its raw events
    (`key_averages()` first builds a Python record of every event: seconds
    a profile at ~75,000 launches)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        n, us = out.get(e.name(), (0, 0.0))
        out[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return out


def profile_one_run(run, what: str = "one transcription") -> tuple:
    """Device busy time and the top kernels of one run, from torch.profiler
    (CUPTI), with the port's own kernels listed too. Prints "not measured"
    if it sees no device time. Returns the busy time (us) and {kernel name:
    (launches, device us)} of the port's kernels; `profile_one_run.last`
    keeps the run's wall, busy time, idle share and launches."""
    from torch.profiler import ProfilerActivity, profile

    # device activity only: recording every host-side op as well took tens of
    # seconds a profile to collect, and slowed the run it measures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    busy_us = sum(us for _, us in kernels.values())
    launches = sum(n for n, _ in kernels.values())
    profile_one_run.last = {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
                            "idle_share": 1 - busy_us / wall_us, "launches": launches}
    if busy_us <= 0:
        log("[profile] device time: not measured (the profiler saw no CUDA kernels)")
        return 0.0, {}
    log(f"[profile] {what} (profiled): wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {100 * (1 - busy_us / wall_us):.1f}%, "
        f"{launches} kernel launches")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    for i, (name, (n, us)) in enumerate(ranked):
        if i < 8 or any(k in name for k in PORT_KERNELS):
            log(f"[profile]   {f'#{i + 1}':>4} {us / 1e3:8.2f} ms {n:6d}x  {name[:90]}")
    return busy_us, {name: nu for name, nu in kernels.items()
                     if any(k in name for k in PORT_KERNELS)}


def compare_q(out, ref, bf16_ulps: int = Q_BF16_ULPS) -> tuple:
    """(passes, max|d|, description) of a quantized kernel's output against
    its plain version, at the bars stated with the Q_* constants."""
    d = out.float() - ref.float()
    err = d.abs().max().item()
    rel = (d.norm() / ref.float().norm()).item()
    peak = ref.float().abs().max().item()
    if ref.dtype == torch.float32:
        tol = Q_F32_PEAK_REL * peak
        ok = err <= tol and rel <= Q_F32_REL
        return ok, err, (f"max|d|={err:.3e} (bar {tol:.3e} = {Q_F32_PEAK_REL:g} max|ref| "
                         f"{peak:.3f}), rel={rel:.3e} (bar {Q_F32_REL:g})")
    tol = bf16_ulps * 2.0 ** (math.floor(math.log2(peak)) - 7)
    ok = err <= tol and rel <= Q_BF16_REL
    return ok, err, (f"max|d|={err:.3e} (bar {tol:.3e} = {bf16_ulps} ulp at max|ref| "
                     f"{peak:.3f}), rel={rel:.3e} (bar {Q_BF16_REL:g})")


def quant_weights(N, K, bits, g, group=GROUP):
    from mlx_audio_tpu_torch.nn.quantized import quantize_arrays

    w = torch.randn(N, K, generator=g, device="cuda") * K ** -0.5
    return quantize_arrays(w, group, bits)


def random_quant_weights(N, K, g, scale=None, group=GROUP):
    """An int4 weight drawn on the card as it is stored: uniform random codes,
    per-group scales around `scale` (by default 2 K^-1/2 / 15: the codes span
    a K^-1/2 spread) and biases that centre the codes, give or take a little
    (a 156940-row matrix quantized on the host would take seconds)."""
    words = torch.randint(-2 ** 31, 2 ** 31, (N, K // 8), generator=g, device="cuda",
                          dtype=torch.int64).to(torch.int32)
    if scale is None:
        scale = 2 * K ** -0.5 / 15
    scales = (0.5 + torch.rand(N, K // group, generator=g, device="cuda")) * scale
    biases = -7.5 * scales + 0.75 * scale * torch.randn(N, K // group, generator=g,
                                                        device="cuda")
    return words, scales, biases


def weight_bytes(packed, scales, biases) -> int:
    return sum(t.numel() * t.element_size() for t in (packed, scales, biases))


def planted_quant_check(name, ref_fn, args, bias_idx, scale_idx) -> None:
    """What a kernel that drops the bias term, or reads the scales of the
    neighbouring group, returns; the bar must reject both."""
    ref = ref_fn(*args)
    for fault, idx, fn in (("bias term dropped", bias_idx, torch.zeros_like),
                           ("scales shifted by one group", scale_idx,
                            lambda t: t.roll(1, dims=1))):
        bad = list(args)
        for i in idx:
            bad[i] = fn(bad[i])
        ok, _, desc = compare_q(ref_fn(*bad), ref)
        log(f"[kernel] planted fault in {name} ({fault}): {desc} -> "
            f"{'passes: the bar is too loose' if ok else 'rejected'}")
        if ok:
            raise SystemExit(f"chip_smoke: the bar accepts a kernel with the {fault}")


def device_ms(fns, iters: int) -> tuple:
    """(device ms per call, host-loop ms per call) over `iters` calls cycling
    through `fns`. The device time is the sum of every kernel and memset the
    calls ran, from torch.profiler (CUPTI), divided by the calls; the
    host-loop time is CUDA events around the loop, which a launch-bound call
    sets by its host cost."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    loop_ms = start.elapsed_time(end) / iters
    for _ in range(3):  # a session now and then records no kernel: profile it again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        busy_us = sum(us for _, us in device_kernels(prof).values())
        if busy_us > 0:
            break
    if busy_us <= 0:
        log(f"[time] the profiler recorded no kernel in three sessions: the CUDA events' "
            f"loop time {loop_ms:.4f} ms a call, an upper bound, stands for the device time")
        return loop_ms, loop_ms
    return busy_us / iters / 1e3, loop_ms


def not_below_bound(label, device, loop, bound) -> float:
    """A profiler device time below the bound (no card does the work faster)
    means records were lost; the CUDA events' loop time, an upper bound,
    stands in for it, and the line says so."""
    if device >= bound:
        return device
    log(f"[time] {label}: the profiler's {device:.4f} ms a call is below the {bound:.4f} ms "
        f"bound (records lost); taking the CUDA events' loop time {loop:.4f} ms")
    return loop


def quant_bound_ms(wbytes, M, K, N, dtype, flops) -> tuple:
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = wbytes + elem * M * (K + N)  # weights, x read once; y written once
    t_ops, t_bytes = ops_s(flops, dtype), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# phase 20's int4 CosyVoice2 decode prompt: sos, the 4 text ids, task and
# the 10 s reference's 251 speech tokens
COSY2_PROMPT_ROWS = 257
QMM_CASES = [  # name, bits, M, N, K, dtype: the routed shapes of phases 5 and 6
    ("qkv_m1_f32", 4, 1, 4096, 1024, torch.float32),
    ("qkv_m1_bf16", 4, 1, 4096, 1024, torch.bfloat16),
    ("oproj_m2_f32", 4, 2, 1024, 2048, torch.float32),
    # the GEMV (M <= 4, 4/8-bit): o_proj (K split over two warps), the codec
    # head, the code predictor's two-token seed, M = 3 and 4, int8 (K split
    # over two and four warps), a K of 96 units (three uneven segments),
    # the ragged N edge; x at a 4-byte offset takes the tiled kernel
    ("oproj_m1_f32", 4, 1, 1024, 2048, torch.float32),
    ("oproj_m1_bf16", 4, 1, 1024, 2048, torch.bfloat16),
    ("codec_head_m1_f32", 4, 1, 3072, 1024, torch.float32),
    ("qkv_m2_f32", 4, 2, 4096, 1024, torch.float32),
    ("qkv_m2_bf16", 4, 2, 4096, 1024, torch.bfloat16),
    ("qkv_m3_f32", 4, 3, 4096, 1024, torch.float32),
    ("oproj_m4_bf16", 4, 4, 1024, 2048, torch.bfloat16),
    ("int8_m1_f32", 8, 1, 4096, 1024, torch.float32),
    ("int8_oproj_m1_bf16", 8, 1, 1024, 2048, torch.bfloat16),
    ("k3072_m1_f32", 4, 1, 1024, 3072, torch.float32),
    ("ragged_n1000_m1_f32", 4, 1, 1000, 1024, torch.float32),
    ("offset_x_m2_f32", 4, 2, 1024, 2048, torch.float32),
    ("codec_head_m16_bf16", 4, 16, 3072, 1024, torch.bfloat16),
    ("down_prefill_m32_f32", 4, 32, 1024, 3072, torch.float32),
    ("text_proj_m336_bf16", 4, 336, 2048, 2048, torch.bfloat16),
    ("codec_qkv_m300_bf16", 4, 300, 3072, 512, torch.bfloat16),
    ("convnext_m512_bf16", 4, 512, 4096, 1024, torch.bfloat16),
    ("ragged_n1000_m2_bf16", 4, 2, 1000, 1024, torch.bfloat16),
    ("int8_m2_bf16", 8, 2, 4096, 1024, torch.bfloat16),
    # 6 bits: the GEMV at the talker's four shapes (q/k/v, o_proj, the
    # fused gate/up in one segment, down; M = 1 and 2), M = 3 and 4, bf16 x,
    # the ragged N edge, rows of 780 bytes (K = 1040 in groups of 16: 65
    # units in three uneven segments); x at a 4-byte offset takes the tiled
    # kernel, as does M > 4
    ("q6_qkv_m1_f32", 6, 1, 4096, 1024, torch.float32),
    ("q6_qkv_m1_bf16", 6, 1, 4096, 1024, torch.bfloat16),
    ("q6_oproj_m1_f32", 6, 1, 1024, 2048, torch.float32),
    ("q6_gateup_m1_f32", 6, 1, 6144, 1024, torch.float32),
    ("q6_down_m1_f32", 6, 1, 1024, 3072, torch.float32),
    ("q6_oproj_m2_f32", 6, 2, 1024, 2048, torch.float32),
    ("q6_qkv_m2_bf16", 6, 2, 4096, 1024, torch.bfloat16),
    ("q6_down_m2_bf16", 6, 2, 1024, 3072, torch.bfloat16),
    ("q6_qkv_m3_f32", 6, 3, 4096, 1024, torch.float32),
    ("q6_oproj_m4_bf16", 6, 4, 1024, 2048, torch.bfloat16),
    ("q6_ragged_n1000_m1_f32", 6, 1, 1000, 1024, torch.float32),
    ("q6_k1040_m1_f32", 6, 1, 1024, 1040, torch.float32),
    ("q6_offset_x_m2_f32", 6, 2, 1024, 2048, torch.float32),
    ("q6_down_prefill_m32_f32", 6, 32, 1024, 3072, torch.float32),
    ("q6_codec_qkv_m300_bf16", 6, 300, 3072, 512, torch.bfloat16),
    ("q6_ragged_n1000_m16_bf16", 6, 16, 1000, 1024, torch.bfloat16),
    # the tensor-core GEMM (M > 4): the talker's four projections at the
    # prefill bucket TP, int4 and 6-bit, bf16 and f32 x; ragged M (37) and N
    # (1000); groups of 32, 128 and 16; int8; K = 1056 in groups of 32 (a
    # last stage of 32 values); groups of 8 and x at an offset take the
    # tiled kernel
    ("qkv_prefill_bf16", 4, 32, 4096, 1024, torch.bfloat16),
    ("oproj_prefill_bf16", 4, 32, 1024, 2048, torch.bfloat16),
    ("gateup_prefill_bf16", 4, 32, 6144, 1024, torch.bfloat16),
    ("down_prefill_bf16", 4, 32, 1024, 3072, torch.bfloat16),
    ("qkv_prefill_f32", 4, 32, 4096, 1024, torch.float32),
    ("down_prefill_f32", 4, 32, 1024, 3072, torch.float32),
    ("q6_qkv_prefill_bf16", 6, 32, 4096, 1024, torch.bfloat16),
    ("q6_oproj_prefill_bf16", 6, 32, 1024, 2048, torch.bfloat16),
    ("q6_gateup_prefill_bf16", 6, 32, 6144, 1024, torch.bfloat16),
    ("q6_down_prefill_bf16", 6, 32, 1024, 3072, torch.bfloat16),
    ("q6_qkv_prefill_f32", 6, 32, 4096, 1024, torch.float32),
    ("q6_oproj_prefill_f32", 6, 32, 1024, 2048, torch.float32),
    ("ragged_m37_bf16", 4, 37, 4096, 1024, torch.bfloat16),
    ("q6_ragged_m37_f32", 6, 37, 4096, 1024, torch.float32),
    ("ragged_n1000_m336_bf16", 4, 336, 1000, 1024, torch.bfloat16),
    ("q6_ragged_n1000_m37_f32", 6, 37, 1000, 2048, torch.float32),
    ("g32_m64_bf16", 4, 64, 2048, 1024, torch.bfloat16),
    ("q6_g128_m96_f32", 6, 96, 1024, 2048, torch.float32),
    ("g128_m200_bf16", 4, 200, 3072, 1024, torch.bfloat16),
    ("q6_g16_m20_bf16", 6, 20, 1024, 1024, torch.bfloat16),
    ("int8_m40_bf16", 8, 40, 1024, 1024, torch.bfloat16),
    ("int8_g128_m300_f32", 8, 300, 2048, 1024, torch.float32),
    ("k1056_g32_m48_f32", 4, 48, 512, 1056, torch.float32),
    ("g8_m24_f32", 4, 24, 512, 512, torch.float32),
    ("q6_offset_x_m40_bf16", 6, 40, 1024, 2048, torch.bfloat16),
    # M = 8: the serving batcher's eight slots in one talker step (f32 x
    # after the first rope, bf16 x into layer 0's q/k/v) and the code
    # predictor's two-token seed at M = 16
    ("qkv_m8_f32", 4, 8, 4096, 1024, torch.float32),
    ("qkv_m8_bf16", 4, 8, 4096, 1024, torch.bfloat16),
    ("oproj_m8_f32", 4, 8, 1024, 2048, torch.float32),
    ("codec_head_m8_f32", 4, 8, 3072, 1024, torch.float32),
    ("qkv_m16_f32", 4, 16, 4096, 1024, torch.float32),
    # a quantized Whisper-large-v3-turbo's fused self-attention q/k/v (N =
    # 3 x 1280) in bf16: a decoder step (M = 1), the 3- and 4-token prompts,
    # and eight batched windows' step (M = 8)
    ("whisper_qkv_m1_bf16", 4, 1, 3840, 1280, torch.bfloat16),
    ("whisper_qkv_m3_bf16", 4, 3, 3840, 1280, torch.bfloat16),
    ("whisper_qkv_m4_bf16", 4, 4, 3840, 1280, torch.bfloat16),
    ("whisper_qkv_m8_bf16", 4, 8, 3840, 1280, torch.bfloat16),
    # Orpheus-3B int4 (phase 13), bf16 x: the decode step's fused q/k/v (N =
    # 3072 + 2 x 1024), o_proj and the 156940-row lm_head (a ragged last
    # block) at M = 1 and at the batcher's four slots; at the 32-row prefill
    # bucket the tensor-core GEMM on gate/up (N = 2 x 8192), down (K = 8192)
    # and the lm_head
    ("orpheus_qkv_m1_bf16", 4, 1, 5120, 3072, torch.bfloat16),
    ("orpheus_oproj_m1_bf16", 4, 1, 3072, 3072, torch.bfloat16),
    ("orpheus_lm_head_m1_bf16", 4, 1, 156940, 3072, torch.bfloat16),
    ("orpheus_qkv_m4_bf16", 4, 4, 5120, 3072, torch.bfloat16),
    ("orpheus_oproj_m4_bf16", 4, 4, 3072, 3072, torch.bfloat16),
    ("orpheus_lm_head_m4_bf16", 4, 4, 156940, 3072, torch.bfloat16),
    ("orpheus_gateup_m32_bf16", 4, 32, 16384, 3072, torch.bfloat16),
    ("orpheus_down_m32_bf16", 4, 32, 3072, 8192, torch.bfloat16),
    ("orpheus_lm_head_m32_bf16", 4, 32, 156940, 3072, torch.bfloat16),
    # CSM-1B int4 (phase 14): the residual stream is float32 (the quantized
    # embeddings dequantize to float32, as in the JAX package). The backbone's
    # fused q/k/v (N = 2048 + 2 x 512) and o_proj, codebook0_head (N = 2051:
    # a ragged last block), the projection at the depth decoder's two-token
    # seed, the decoder's q/k/v (N = 1024 + 2 x 256) and o_proj, at M = 1;
    # the batcher's eight slots (M = 8, the decoder's seed M = 16) and a
    # 64-row prompt bucket on the tensor-core GEMM; bf16 x for the M = 1
    # GEMV too
    ("csm_qkv_m1_f32", 4, 1, 3072, 2048, torch.float32),
    ("csm_oproj_m1_f32", 4, 1, 2048, 2048, torch.float32),
    ("csm_cb0_head_m1_f32", 4, 1, 2051, 2048, torch.float32),
    ("csm_cb0_head_m1_bf16", 4, 1, 2051, 2048, torch.bfloat16),
    ("csm_proj_m2_f32", 4, 2, 1024, 2048, torch.float32),
    ("csm_dec_qkv_m1_f32", 4, 1, 1536, 1024, torch.float32),
    ("csm_dec_qkv_m2_f32", 4, 2, 1536, 1024, torch.float32),
    ("csm_dec_oproj_m1_f32", 4, 1, 1024, 1024, torch.float32),
    ("csm_qkv_m1_bf16", 4, 1, 3072, 2048, torch.bfloat16),
    ("csm_qkv_m8_f32", 4, 8, 3072, 2048, torch.float32),
    ("csm_cb0_head_m8_f32", 4, 8, 2051, 2048, torch.float32),
    ("csm_dec_qkv_m16_f32", 4, 16, 1536, 1024, torch.float32),
    ("csm_qkv_m64_f32", 4, 64, 3072, 2048, torch.float32),
    ("csm_down_m64_f32", 4, 64, 2048, 8192, torch.float32),
    # Llama-OuteTTS-1.0-1B int4's 19-token prompt (phase 15; its decode
    # steps are CSM's backbone shapes at M = 1, float32 x)
    ("outetts_qkv_m19_f32", 4, 19, 3072, 2048, torch.float32),
    ("outetts_oproj_m19_f32", 4, 19, 2048, 2048, torch.float32),
    ("outetts_gate_up_m19_f32", 4, 19, 16384, 2048, torch.float32),
    ("outetts_down_m19_f32", 4, 19, 2048, 8192, torch.float32),
    # Bark-small int4 (phase 16), float32 x: a decode step's att_proj (N =
    # 3 x 768), out_proj, the MLP's in_proj and out_proj (K = 3072) and the
    # semantic and coarse heads at M = 1 and at the batcher's four rows; the
    # semantic prefill (257 rows), the coarse prefill (317) and the fine
    # stack's 512-frame chunk with its heads (N = 1056) on the tensor-core
    # GEMM
    ("bark_att_proj_m1_f32", 4, 1, 2304, 768, torch.float32),
    ("bark_out_proj_m1_f32", 4, 1, 768, 768, torch.float32),
    ("bark_in_proj_m1_f32", 4, 1, 3072, 768, torch.float32),
    ("bark_mlp_out_m1_f32", 4, 1, 768, 3072, torch.float32),
    ("bark_sem_head_m1_f32", 4, 1, 10048, 768, torch.float32),
    ("bark_coarse_head_m1_f32", 4, 1, 12096, 768, torch.float32),
    ("bark_att_proj_m4_f32", 4, 4, 2304, 768, torch.float32),
    ("bark_sem_head_m4_f32", 4, 4, 10048, 768, torch.float32),
    ("bark_att_proj_m257_f32", 4, 257, 2304, 768, torch.float32),
    ("bark_mlp_out_m257_f32", 4, 257, 768, 3072, torch.float32),
    ("bark_in_proj_m317_f32", 4, 317, 3072, 768, torch.float32),
    ("bark_att_proj_m512_f32", 4, 512, 2304, 768, torch.float32),
    ("bark_fine_head_m512_f32", 4, 512, 1056, 768, torch.float32),
    # Spark-TTS-0.5B int4 (float32 x): a decode step's fused q/k/v, o_proj,
    # fused gate/up and down at M = 1 (K = 896 is 14 groups of 64), and the
    # same four at the 20-token control prompt on the tensor-core GEMM
    ("spark_qkv_m1_f32", 4, 1, 1152, 896, torch.float32),
    ("spark_o_proj_m1_f32", 4, 1, 896, 896, torch.float32),
    ("spark_gate_up_m1_f32", 4, 1, 9728, 896, torch.float32),
    ("spark_down_m1_f32", 4, 1, 896, 4864, torch.float32),
    ("spark_qkv_m20_f32", 4, 20, 1152, 896, torch.float32),
    ("spark_o_proj_m20_f32", 4, 20, 896, 896, torch.float32),
    ("spark_gate_up_m20_f32", 4, 20, 9728, 896, torch.float32),
    ("spark_down_m20_f32", 4, 20, 896, 4864, torch.float32),
    # IndexTTS int4 (float32 x): a decode step's GPT-2 c_attn, attention
    # c_proj, c_fc and MLP c_proj and the 8,194-row mel head at M = 1, the
    # batcher's four slots, the 44-row prompt, the conformer's
    # feed-forward and conv2d-front projection at its 140 rows (6 s), the
    # perceiver's gated feed-forward at its 32 latents and its keys at 172
    ("indextts_c_attn_m1_f32", 4, 1, 3072, 1024, torch.float32),
    ("indextts_c_proj_m1_f32", 4, 1, 1024, 1024, torch.float32),
    ("indextts_c_fc_m1_f32", 4, 1, 4096, 1024, torch.float32),
    ("indextts_mlp_proj_m1_f32", 4, 1, 1024, 4096, torch.float32),
    ("indextts_mel_head_m1_f32", 4, 1, 8194, 1024, torch.float32),
    ("indextts_c_attn_m4_f32", 4, 4, 3072, 1024, torch.float32),
    ("indextts_mel_head_m4_f32", 4, 4, 8194, 1024, torch.float32),
    ("indextts_c_attn_m44_f32", 4, 44, 3072, 1024, torch.float32),
    ("indextts_c_fc_m44_f32", 4, 44, 4096, 1024, torch.float32),
    ("indextts_mlp_proj_m44_f32", 4, 44, 1024, 4096, torch.float32),
    ("indextts_ff_m140_f32", 4, 140, 2048, 256, torch.float32),
    ("indextts_embed_out_m140_f32", 4, 140, 256, 6144, torch.float32),
    ("indextts_w1_m32_f32", 4, 32, 2730, 1024, torch.float32),
    ("indextts_kv_m172_f32", 4, 172, 256, 1024, torch.float32),
    # Chatterbox T3 int4 (phase 19), float32 x: a CFG decode step (the
    # cond/uncond pair, M = 2) on the fused q/k/v and o_proj, the batcher's
    # four pairs (M = 8), and the pair's 57-row prompt (M = 114) on all four
    # projections (the fused MLP's guard refuses M > 16)
    ("chatterbox_qkv_m2_f32", 4, 2, 3072, 1024, torch.float32),
    ("chatterbox_o_proj_m2_f32", 4, 2, 1024, 1024, torch.float32),
    ("chatterbox_qkv_m8_f32", 4, 8, 3072, 1024, torch.float32),
    ("chatterbox_qkv_m114_f32", 4, 114, 3072, 1024, torch.float32),
    ("chatterbox_o_proj_m114_f32", 4, 114, 1024, 1024, torch.float32),
    ("chatterbox_gate_up_m114_f32", 4, 114, 8192, 1024, torch.float32),
    ("chatterbox_down_m114_f32", 4, 114, 1024, 4096, torch.float32),
    # CosyVoice2 int4 (phase 20), float32 x: the LM head (6,564 rows) at a
    # decode step, the 257-row prompt's (COSY2_PROMPT_ROWS) fused q/k/v and
    # down (the rest of the LM's shapes are Spark's, above), and the flow's
    # linears at its rows: the conformer's feed-forward at 350 tokens, the
    # upsampled stack's attention at 700 frames, the U-Net's attention and
    # feed-forward at the CFG pair's 1400 rows
    ("cv2_llm_decoder_m1_f32", 4, 1, 6564, 896, torch.float32),
    ("cv2_qkv_prompt_f32", 4, COSY2_PROMPT_ROWS, 1152, 896, torch.float32),
    ("cv2_down_prompt_f32", 4, COSY2_PROMPT_ROWS, 896, 4864, torch.float32),
    ("cv2_enc_ff_m350_f32", 4, 350, 2048, 512, torch.float32),
    ("cv2_up_attn_m700_f32", 4, 700, 512, 512, torch.float32),
    ("cv2_est_attn_m1400_f32", 4, 1400, 512, 256, torch.float32),
    ("cv2_est_ff_m1400_f32", 4, 1400, 1024, 256, torch.float32),
]
# groups other than 64: K = 1040 is 65 groups of 16
QMM_GROUP = {"q6_k1040_m1_f32": 16, "g32_m64_bf16": 32, "q6_g128_m96_f32": 128,
             "g128_m200_bf16": 128, "q6_g16_m20_bf16": 16, "int8_g128_m300_f32": 128,
             "k1056_g32_m48_f32": 32, "g8_m24_f32": 8}
# the planted faults run on these (each dtype and bits of the GEMV, and an
# int4 and a 6-bit case of the tensor-core GEMM)
QMM_PLANTED = ("qkv_m1_f32", "qkv_m1_bf16", "q6_qkv_m1_f32", "q6_qkv_m1_bf16",
               "qkv_prefill_bf16", "q6_qkv_prefill_f32", "whisper_qkv_m1_bf16",
               "orpheus_lm_head_m1_bf16", "orpheus_lm_head_m32_bf16",
               "csm_cb0_head_m1_f32", "csm_cb0_head_m1_bf16", "csm_cb0_head_m8_f32",
               "bark_sem_head_m1_f32", "bark_att_proj_m512_f32", "spark_qkv_m1_f32",
               "spark_down_m20_f32", "indextts_mel_head_m1_f32", "indextts_c_fc_m44_f32")
# The talker's prefill bucket: bench.py's text gives the talker an
# 8-position prompt (the text itself streams in a token a frame), which
# `_prefill` pads to 32 rows; `phase_qwen_slice` checks it. The text
# projection runs over the whole 336-token chat prompt.
TP = 32
TEXT_M = 336
# timed, int4 and 6-bit: the talker's four projections at M = TP in bf16 x
# and in f32 x (the talker's prefill runs f32: its residual stream is f32
# after the first rope, as in the JAX package), and the text projection at
# M = 336 in bf16
QMM_PREFILL = [("qkv", TP, 4096, 1024), ("o_proj", TP, 1024, 2048),
               ("gate_up", TP, 6144, 1024), ("down", TP, 1024, 3072),
               ("text_proj", TEXT_M, 2048, 2048)]
# the serving batcher's talker step: eight slots, int4, q/k/v and o_proj, in
# f32 x (the residual stream after the first rope) and bf16 x (layer 0)
SERVE_M = 8
QMM_SERVE = [("qkv", SERVE_M, 4096, 1024), ("o_proj", SERVE_M, 1024, 2048)]
# timed: name, bits, M, N, K (f32 x): the talker's fused q/k/v and o_proj
# at M = 1, the code predictor's two-token seed; at 6 bits the talker's four
# shapes, which each take about a quarter of the 6-bit path's launches
QMM_TIMED = [("qmm", 4, 1, 4096, 1024), ("qmm_oproj", 4, 1, 1024, 2048),
             ("qmm_m2", 4, 2, 4096, 1024), ("qmm6", 6, 1, 4096, 1024),
             ("qmm6_oproj", 6, 1, 1024, 2048), ("qmm6_gateup", 6, 1, 6144, 1024),
             ("qmm6_down", 6, 1, 1024, 3072),
             # the int4 Whisper decoder step's fused q/k/v, bf16 x
             ("qmm_whisper_qkv", 4, 1, 3840, 1280, torch.bfloat16)]
QMLP_CASES = [  # name, bits, M, K, I, N, dtype
    ("mlp_m1_f32", 4, 1, 1024, 3072, 1024, torch.float32),
    ("mlp_m1_bf16", 4, 1, 1024, 3072, 1024, torch.bfloat16),
    ("mlp_m2_f32", 4, 2, 1024, 3072, 1024, torch.float32),
    ("mlp_m16_bf16", 4, 16, 1024, 3072, 1024, torch.bfloat16),
    ("mlp_ragged_n1000_m2_f32", 4, 2, 1024, 3072, 1000, torch.float32),
    ("mlp_int8_m2_bf16", 8, 2, 1024, 3072, 1024, torch.bfloat16),
    # a third x row (one 4-row pass), and a K of 34 16-byte units a row:
    # a second, partial step of the 32 lanes
    ("mlp_m3_f32", 4, 3, 1024, 3072, 1024, torch.float32),
    ("mlp_k1088_m1_f32", 4, 1, 1088, 3072, 1024, torch.float32),
    ("mlp_k1088_m2_bf16", 4, 2, 1088, 3072, 1024, torch.bfloat16),
    # the serving tick's eight slots, and the code predictor's seed at 16
    ("mlp_m8_f32", 4, 8, 1024, 3072, 1024, torch.float32),
    ("mlp_m8_bf16", 4, 8, 1024, 3072, 1024, torch.bfloat16),
    ("mlp_m16_f32", 4, 16, 1024, 3072, 1024, torch.float32),
    # Orpheus-3B (phase 13), bf16 x: the decode step, the batcher's four
    # slots and a 16-token prefill
    ("orpheus_mlp_m1_bf16", 4, 1, 3072, 8192, 3072, torch.bfloat16),
    ("orpheus_mlp_m4_bf16", 4, 4, 3072, 8192, 3072, torch.bfloat16),
    ("orpheus_mlp_m16_bf16", 4, 16, 3072, 8192, 3072, torch.bfloat16),
    # Chatterbox T3 int4 (phase 19), float32 x: the CFG pair's decode step
    # and the batcher's four pairs
    ("chatterbox_mlp_m2_f32", 4, 2, 1024, 4096, 1024, torch.float32),
    ("chatterbox_mlp_m8_f32", 4, 8, 1024, 4096, 1024, torch.float32),
    # CSM-1B int4 (phase 14), float32 x: the backbone's step and the
    # batcher's eight slots; the depth decoder's step, its two-token seed
    # and the batcher's seed (M = 16)
    ("csm_mlp_m1_f32", 4, 1, 2048, 8192, 2048, torch.float32),
    ("csm_mlp_m8_f32", 4, 8, 2048, 8192, 2048, torch.float32),
    ("csm_dec_mlp_m1_f32", 4, 1, 1024, 8192, 1024, torch.float32),
    ("csm_dec_mlp_m2_f32", 4, 2, 1024, 8192, 1024, torch.float32),
    ("csm_dec_mlp_m16_f32", 4, 16, 1024, 8192, 1024, torch.float32),
]
# Orpheus-3B's shapes, timed (phase 2) beside their bound, plain version and
# bf16 `F.linear`: name, M, N, K (bf16 x); and the fused MLP at M = 1 and 4
ORPHEUS_GEMV = [("qkv", 1, 5120, 3072), ("o_proj", 1, 3072, 3072),
                ("lm_head", 1, 156940, 3072), ("qkv", 4, 5120, 3072),
                ("o_proj", 4, 3072, 3072), ("lm_head", 4, 156940, 3072)]
ORPHEUS_MMA = [("gate_up", 32, 16384, 3072), ("down", 32, 3072, 8192),
               ("lm_head", 32, 156940, 3072), ("qkv", 32, 5120, 3072),
               ("o_proj", 32, 3072, 3072)]
# CSM-1B int4's shapes, timed (phase 2) in float32 x, the path's: name, M,
# N, K; the GEMV at M = 1 (M = 2 at the seed's projection), the tensor-core
# GEMM at the batcher's eight slots (16 rows at the decoder's seed) and the
# 64-row prompt bucket; and the fused MLP's (M, K, I)
CSM_QMM = [("qkv", 1, 3072, 2048), ("o_proj", 1, 2048, 2048), ("cb0_head", 1, 2051, 2048),
           ("proj", 2, 1024, 2048), ("dec_qkv", 1, 1536, 1024), ("dec_o_proj", 1, 1024, 1024),
           ("qkv", 8, 3072, 2048), ("cb0_head", 8, 2051, 2048), ("dec_qkv", 16, 1536, 1024),
           ("qkv", 64, 3072, 2048)]
CSM_QMLP = [("mlp", 1, 2048, 8192), ("mlp", 8, 2048, 8192), ("dec_mlp", 1, 1024, 8192),
            ("dec_mlp", 16, 1024, 8192)]
# Llama-OuteTTS-1.0-1B int4's 19-token prompt, float32 x (its decode steps
# are CSM_QMM's and CSM_QMLP's backbone shapes at M = 1)
OUTETTS_QMM = [("qkv", 19, 3072, 2048), ("o_proj", 19, 2048, 2048),
               ("gate_up", 19, 16384, 2048), ("down", 19, 2048, 8192)]
# Bark-small int4's shapes, timed (phase 2) in float32 x: the GEMV at a
# decode step (M = 1), the tensor-core GEMM at the semantic prefill and the
# fine chunk
BARK_QMM = [("att_proj", 1, 2304, 768), ("out_proj", 1, 768, 768), ("mlp_out", 1, 768, 3072),
            ("sem_head", 1, 10048, 768), ("att_proj", 257, 2304, 768),
            ("fine_head", 512, 1056, 768)]
# Spark-TTS-0.5B int4's shapes, timed in float32 x: a decode step (M = 1) and
# the control prompt (M = 20); its MLP takes qmm (the fused kernel's guard
# refuses I = 4864)
SPARK_QMM = [("qkv", 1, 1152, 896), ("o_proj", 1, 896, 896), ("gate_up", 1, 9728, 896),
             ("down", 1, 896, 4864), ("qkv", 20, 1152, 896), ("o_proj", 20, 896, 896),
             ("gate_up", 20, 9728, 896), ("down", 20, 896, 4864)]
# IndexTTS int4's shapes, timed in float32 x: a decode step's four GPT-2
# projections and the mel head (M = 1), the mel head and c_attn at the
# batcher's four slots, and two at the 44-row prompt (the conformer's and
# the perceiver's shapes are checked, not timed)
INDEXTTS_QMM = [("c_attn", 1, 3072, 1024), ("c_proj", 1, 1024, 1024), ("c_fc", 1, 4096, 1024),
                ("mlp_proj", 1, 1024, 4096), ("mel_head", 1, 8194, 1024),
                ("mel_head", 4, 8194, 1024), ("c_attn", 44, 3072, 1024),
                ("mlp_proj", 44, 1024, 4096)]
# CosyVoice2 int4's shapes, timed in float32 x: the LM head at a decode step
# and the int4 decode's prompt's four projections; a decode step's four are
# Spark's (timed above)
COSY2_QMM = [("llm_decoder", 1, 6564, 896), ("qkv", COSY2_PROMPT_ROWS, 1152, 896),
             ("o_proj", COSY2_PROMPT_ROWS, 896, 896), ("gate_up", COSY2_PROMPT_ROWS, 9728, 896),
             ("down", COSY2_PROMPT_ROWS, 896, 4864)]
# Chatterbox T3 int4's shapes (Llama-520M: 1024 wide, 16 heads of 64, MLP
# 4096), timed in float32 x: a CFG decode step (M = 2) and the pair's 57-row
# prompt (M = 114; CHATTERBOX_PROMPT_ROWS), and the fused MLP at M = 2 and 8
CHATTERBOX_PROMPT_ROWS = 57  # 34 conditioning rows, 22 text ids, the bos
CHATTERBOX_QMM = [("qkv", 2, 3072, 1024), ("o_proj", 2, 1024, 1024),
                  ("qkv", 2 * CHATTERBOX_PROMPT_ROWS, 3072, 1024),
                  ("o_proj", 2 * CHATTERBOX_PROMPT_ROWS, 1024, 1024),
                  ("gate_up", 2 * CHATTERBOX_PROMPT_ROWS, 8192, 1024),
                  ("down", 2 * CHATTERBOX_PROMPT_ROWS, 1024, 4096)]
CHATTERBOX_QMLP = [("mlp", 2, 1024, 4096), ("mlp", 8, 1024, 4096)]
ORPHEUS_MLP = dict(K=3072, I=8192, N=3072)


def qmm_route(name, M, bits, K, group) -> str:
    """The kernel a call must take, the rule of `qmm_bm` in
    csrc/quant_matmul.cu: x at an offset (the "offset_x" cases) takes the
    tiled kernel; else the GEMV at M <= 4, and at M > 4 the tensor-core GEMM
    where the groups are a multiple of 16 values and the packed rows of 16
    bytes, else the tiled kernel."""
    if "offset_x" in name:
        return "qmm_kernel"
    if M <= 4:
        return "qmm_gemv"
    return "qmm_mma" if group % 16 == 0 and K * bits // 8 % 16 == 0 else "qmm_kernel"


def launched_kernels(fn, calls: int = 3, sessions: int = 3) -> list:
    """The port's kernels that `calls` calls of fn launch, from
    torch.profiler, which can drop the record of a launch now and then (and
    once in a while records no kernel in a whole session: then the calls
    are profiled again, up to `sessions` times; [] if none recorded one)."""
    from torch.profiler import ProfilerActivity, profile

    keys = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        keys = [name for name in device_kernels(prof)
                if any(k in name for k in PORT_KERNELS)]
        if keys:
            return keys
    return keys


def qmm_taken(call, bits: int) -> tuple:
    """The qmm kernels that calls of `call` launch: (the routes qmm_fwd
    handed back to the wrapper's counter, exact; the port's kernels in the
    profile of the same calls, which can be empty when the profiler
    recorded nothing)."""
    from mlx_audio_tpu_torch.ops.cuda.quant_matmul import quantized_matmul, quantized_matmul6

    wrapper = quantized_matmul6 if bits == 6 else quantized_matmul
    before = dict(wrapper.kernels)
    seen = launched_kernels(call)
    counted = sorted(k for k, n in wrapper.kernels.items() if n != before[k])
    return counted, seen


def qmm_route_fault(counted, seen, route: str, bits: int):
    """Why the launches of one qmm case are not `route` at `bits` bits, or
    None: the counter must show that kernel alone, and a profile that
    recorded kernels must show it alone too, at these bits."""
    if counted != [route]:
        return f"the wrapper counted {counted}"
    if seen and (len(seen) != 1 or route not in seen[0] or f"<{bits}," not in seen[0]):
        return f"the profile shows {seen}"
    return None


def phase_quant_kernels():
    """qmm, qmm6 and qmlp against their plain versions, then timed at the
    decode path's M = 1 shapes in float32 (the talker's residual stream is
    float32 after its first rope, as in the JAX package)."""
    from mlx_audio_tpu_torch.ops.cuda.quant_matmul import (
        quantized_matmul, quantized_matmul_reference, quantized_mlp,
        quantized_mlp_reference)

    errs = {}
    for i, (name, bits, M, N, K, dtype) in enumerate(QMM_CASES):
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        group = QMM_GROUP.get(name, GROUP)
        packed, scales, biases = (random_quant_weights(N, K, g) if N * K > 1 << 27
                                  else quant_weights(N, K, bits, g, group))
        x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
        if "offset_x" in name:  # rows 4 bytes past a 16-byte boundary
            x = torch.cat([x[:, :1], x], dim=1)[:, 1:]
        out = quantized_matmul(x, packed, scales, biases, bits=bits, group_size=group)
        torch.cuda.synchronize()
        ref = quantized_matmul_reference(x, packed, scales, biases, bits=bits,
                                         group_size=group)
        ok, err, desc = compare_q(out, ref)
        route = qmm_route(name, M, bits, K, group)
        counted, took = qmm_taken(lambda: quantized_matmul(
            x, packed, scales, biases, bits=bits, group_size=group), bits)
        log(f"[kernel] {'qmm6' if bits == 6 else 'qmm'} {name} bits={bits} M={M} N={N} "
            f"K={K} group {group}: {desc}; took {', '.join(counted)} by the counter, "
            f"{', '.join(re.sub(r'\(.*', '', k.split('::', 1)[-1]) for k in took) or 'no record'}"
            f" in the profile")
        if not ok:
            raise SystemExit(f"chip_smoke: quantized_matmul {name} over its bar: {desc}")
        fault = qmm_route_fault(counted, took, route, bits)
        if fault:
            raise SystemExit(f"chip_smoke: quantized_matmul {name} did not launch one "
                             f"{route}<{bits}, ...>: {fault}")
        errs[name] = err
        if name in QMM_PLANTED:
            planted_quant_check(
                name, lambda *a: quantized_matmul_reference(*a, bits=bits, group_size=group),
                (x, packed, scales, biases), (3,), (2,))
    for i, (name, bits, M, K, I, N, dtype) in enumerate(QMLP_CASES):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        gu = quant_weights(2 * I, K, bits, g)
        down = quant_weights(N, I, bits, g)
        x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
        out = quantized_mlp(x, *gu, *down, bits=bits, group_size=GROUP)
        torch.cuda.synchronize()
        ref = quantized_mlp_reference(x, *gu, *down, bits=bits, group_size=GROUP)
        ok, err, desc = compare_q(out, ref)
        log(f"[kernel] qmlp {name} bits={bits} M={M} K={K} I={I} N={N}: {desc}")
        if not ok:
            raise SystemExit(f"chip_smoke: quantized_mlp {name} over its bar: {desc}")
        errs[name] = err
        if name in ("mlp_m1_f32", "mlp_m1_bf16"):
            planted_quant_check(
                name, lambda *a: quantized_mlp_reference(*a, bits=bits, group_size=GROUP),
                (x, *gu, *down), (3, 6), (2, 5))

    timing = {}
    for kname, bits, M, N, K, *xdt in QMM_TIMED:
        xdt = xdt[0] if xdt else torch.float32
        g = torch.Generator(device="cuda").manual_seed(400 + bits)
        sets = [quant_weights(N, K, bits, g)]
        wbytes = weight_bytes(*sets[0])
        sets += [tuple(t.clone() for t in sets[0]) for _ in range(int(2 * L2_BYTES // wbytes))]
        x = torch.randn(M, K, generator=g, device="cuda").to(xdt)
        dense = [(x.bfloat16(), (quantized_matmul_reference(
            torch.eye(K, device="cuda"), *sets[0], bits=bits, group_size=GROUP).T.contiguous()
            .bfloat16()))]
        dense += [(dense[0][0], dense[0][1].clone())
                  for _ in range(int(2 * L2_BYTES // (2 * N * K)))]
        ms, loop = device_ms([lambda w=w: quantized_matmul(x, *w, bits=bits,
                                                          group_size=GROUP)
                              for w in sets], 400)
        plain, _ = device_ms([lambda w=w: quantized_matmul_reference(x, *w, bits=bits,
                                                                     group_size=GROUP)
                              for w in sets], 40)
        yard, _ = device_ms([lambda d=d: F.linear(d[0], d[1]) for d in dense], 400)
        bound, by = quant_bound_ms(wbytes, M, K, N, xdt, 2.0 * M * N * K)
        timing[kname] = dict(ms=ms, plain_ms=plain, library_ms=None, yardstick_ms=yard,
                             bound_ms=bound, bound_by=by, host_loop_ms=loop)
        log(f"[time] {kname} int{bits} M={M} N={N} K={K} {str(xdt)[6:]} x (weights cycled "
            f"past L2), device "
            f"time per call: kernel {ms:.4f} ms, plain {plain:.4f} ms, yardstick F.linear on "
            f"the bf16 dequantized weight {yard:.4f} ms, bound {bound:.4f} ms ({by}, "
            f"{wbytes / 1e6:.3f} MB of weights, scales and biases); kernel at "
            f"{100 * bound / ms:.1f}% of bound; a Python loop of launches takes {loop:.4f} ms "
            f"a call")
    timing.update(time_prefill())
    timing.update(time_prefill([(4, shape, M, N, K, dtype)
                                for dtype in (torch.float32, torch.bfloat16)
                                for shape, M, N, K in QMM_SERVE]))
    # eight batched Whisper windows' decoder step, fused q/k/v
    timing.update(time_prefill([(4, "whisper_qkv", SERVE_M, 3840, 1280, torch.bfloat16)]))
    timing["qmlp"] = time_qmlp(1)
    timing["qmlp_m8"] = time_qmlp(SERVE_M)
    timing.update(time_orpheus())
    timing.update(time_csm())
    timing.update(time_csm(OUTETTS_QMM, "outetts", ()))
    timing.update(time_csm(BARK_QMM, "bark", ()))
    timing.update(time_csm(SPARK_QMM, "spark", ()))
    timing.update(time_csm(INDEXTTS_QMM, "indextts", ()))
    timing.update(time_csm(CHATTERBOX_QMM, "chatterbox", CHATTERBOX_QMLP))
    timing.update(time_csm(COSY2_QMM, "cosyvoice2", ()))
    return errs, timing


def time_csm(cases=CSM_QMM, prefix: str = "csm", mlp_cases=CSM_QMLP) -> dict:
    """CSM-1B int4's shapes in float32 x (CSM_QMM, CSM_QMLP), or another
    family's `cases` under its `prefix`, each beside its bound, plain
    version and bf16 `F.linear` on the dequantized weight."""
    from mlx_audio_tpu_torch.ops.cuda.quant_matmul import (quantized_matmul,
                                                           quantized_matmul_reference)

    timing = {}
    f32 = torch.float32
    for shape, M, N, K in cases:
        key = f"{prefix}_{shape}_m{M}"
        g = torch.Generator(device="cuda").manual_seed(480 + M)
        sets = [quant_weights(N, K, 4, g)]
        wbytes = weight_bytes(*sets[0])
        sets += [tuple(t.clone() for t in sets[0]) for _ in range(int(2 * L2_BYTES // wbytes))]
        x = torch.randn(M, K, generator=g, device="cuda")
        w_dense = quantized_matmul_reference(torch.eye(K, device="cuda"), *sets[0],
                                             group_size=GROUP).T.contiguous().bfloat16()
        dense = [w_dense] + [w_dense.clone() for _ in range(int(2 * L2_BYTES // (2 * N * K)))]
        xb = x.bfloat16()
        ms, loop = device_ms([lambda w=w: quantized_matmul(x, *w, group_size=GROUP)
                              for w in sets], 200)
        plain, _ = device_ms([lambda w=w: quantized_matmul_reference(x, *w, group_size=GROUP)
                              for w in sets], 20)
        yard, _ = device_ms([lambda d=d: F.linear(xb, d) for d in dense], 200)
        route = "qmm_gemv" if M <= 4 else "qmm_mma"
        bound, by = quant_bound_ms(wbytes, M, K, N, f32, 2.0 * M * N * K)
        ms = not_below_bound(key, ms, loop, bound)
        timing[key] = dict(kernel=route, ms=ms, plain_ms=plain, library_ms=None,
                           yardstick_ms=yard, bound_ms=bound, bound_by=by, host_loop_ms=loop)
        log(f"[time] {key}: {route} int4 M={M} N={N} K={K} float32 x, device time per call "
            f"{ms:.4f} ms, plain {plain:.4f} ms, yardstick F.linear on the bf16 dequantized "
            f"weight {yard:.4f} ms, bound {bound:.4f} ms ({by}, {wbytes / 1e6:.2f} MB of "
            f"weights, scales and biases); at {100 * bound / ms:.1f}% of bound")
        del sets, dense, w_dense
    for shape, M, K, I in mlp_cases:
        timing[f"{prefix}_{shape}_m{M}"] = time_qmlp(M, K=K, I=I, N=K)
    torch.cuda.empty_cache()
    return timing


def time_orpheus() -> dict:
    """Orpheus-3B int4's shapes, bf16 x: the GEMV at M = 1 and 4, the
    tensor-core GEMM at the 32-row prefill bucket, the fused MLP at M = 1 and
    4, each beside its bound, plain version and bf16 `F.linear` on the
    dequantized weight."""
    from mlx_audio_tpu_torch.ops.cuda.quant_matmul import (quantized_matmul,
                                                           quantized_matmul_reference)

    timing = {}
    bf16 = torch.bfloat16
    for shape, M, N, K in ORPHEUS_GEMV + ORPHEUS_MMA:
        key = f"orpheus_{shape}_m{M}"
        g = torch.Generator(device="cuda").manual_seed(470 + M)
        sets = [random_quant_weights(N, K, g)]
        wbytes = weight_bytes(*sets[0])
        sets += [tuple(t.clone() for t in sets[0]) for _ in range(int(2 * L2_BYTES // wbytes))]
        x = torch.randn(M, K, generator=g, device="cuda").to(bf16)
        w_dense = quantized_matmul_reference(torch.eye(K, device="cuda"), *sets[0],
                                             group_size=GROUP).T.contiguous().bfloat16()
        dense = [w_dense] + [w_dense.clone() for _ in range(int(2 * L2_BYTES // (2 * N * K)))]
        ms, loop = device_ms([lambda w=w: quantized_matmul(x, *w, group_size=GROUP)
                              for w in sets], 200)
        plain, _ = device_ms([lambda w=w: quantized_matmul_reference(x, *w, group_size=GROUP)
                              for w in sets], 10)
        yard, _ = device_ms([lambda d=d: F.linear(x, d) for d in dense], 200)
        bound, by = quant_bound_ms(wbytes, M, K, N, bf16, 2.0 * M * N * K)
        ms = not_below_bound(key, ms, loop, bound)
        route = "qmm_gemv" if M <= 4 else "qmm_mma"
        timing[key] = dict(kernel=route, ms=ms, plain_ms=plain, library_ms=None,
                           yardstick_ms=yard, bound_ms=bound, bound_by=by, host_loop_ms=loop)
        log(f"[time] {key}: {route} int4 M={M} N={N} K={K} bf16 x, device time per call "
            f"{ms:.4f} ms, plain {plain:.4f} ms, yardstick F.linear on the bf16 dequantized "
            f"weight {yard:.4f} ms, bound {bound:.4f} ms ({by}, {wbytes / 1e6:.2f} MB of "
            f"weights, scales and biases); at {100 * bound / ms:.1f}% of bound")
        del sets, dense, w_dense
    for M in (1, 4):
        timing[f"orpheus_qmlp_m{M}"] = time_qmlp(M, dtype=bf16, **ORPHEUS_MLP)
    torch.cuda.empty_cache()
    return timing


def time_qmlp(M, K=1024, I=3072, N=1024, dtype=torch.float32) -> dict:
    """The fused quantized SwiGLU, int4, M rows (the talker's widths by
    default; 1 row: the single-request decode; 8: the serving batcher's
    tick), device time per call with the weights cycled past L2, beside its
    plain version and a bf16 yardstick."""
    from mlx_audio_tpu_torch.ops.cuda.quant_matmul import (quantized_matmul_reference,
                                                           quantized_mlp,
                                                           quantized_mlp_reference)

    g = torch.Generator(device="cuda").manual_seed(500)
    sets = [(quant_weights(2 * I, K, 4, g), quant_weights(N, I, 4, g))]
    wbytes = weight_bytes(*sets[0][0]) + weight_bytes(*sets[0][1])
    sets += [tuple(tuple(t.clone() for t in part) for part in sets[0])
             for _ in range(int(2 * L2_BYTES // wbytes))]
    x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
    eye = torch.eye(K, device="cuda")
    w_gu = quantized_matmul_reference(eye, *sets[0][0], group_size=GROUP).T.bfloat16()
    w_d = quantized_matmul_reference(torch.eye(I, device="cuda"), *sets[0][1],
                                     group_size=GROUP).T.bfloat16()
    dense = [(w_gu.clone(), w_d.clone()) for _ in range(int(2 * L2_BYTES // (6 * I * K)) + 1)]
    xb = x.bfloat16()

    def yard_mlp(d):
        gate, up = F.linear(xb, d[0]).chunk(2, dim=-1)
        return F.linear(F.silu(gate) * up, d[1])

    ms, loop = device_ms([lambda w=w: quantized_mlp(x, *w[0], *w[1], group_size=GROUP)
                          for w in sets], 400)
    plain, _ = device_ms([lambda w=w: quantized_mlp_reference(x, *w[0], *w[1],
                                                             group_size=GROUP)
                          for w in sets], 40)
    yard, _ = device_ms([lambda d=d: yard_mlp(d) for d in dense], 400)
    bound, by = quant_bound_ms(wbytes, M, K, N, dtype, 2.0 * M * (2 * I * K + N * I))
    log(f"[time] qmlp int4 M={M} K={K} I={I} N={N} {str(dtype)[6:]} x (weights cycled past "
        f"L2), device "
        f"time per call: kernel (its one launch, no memset) {ms:.4f} ms, plain {plain:.4f} ms, "
        f"yardstick bf16 F.linear gate_up, silu*mul, F.linear down {yard:.4f} ms, bound "
        f"{bound:.4f} ms ({by}); kernel at {100 * bound / ms:.1f}% of bound; a Python loop "
        f"of launches takes {loop:.4f} ms a call")
    return dict(ms=ms, plain_ms=plain, library_ms=None, yardstick_ms=yard, bound_ms=bound,
                bound_by=by, host_loop_ms=loop)


def time_prefill(cases=None) -> dict:
    """The tensor-core GEMM at QMM_PREFILL's shapes, int4 and 6-bit, bf16 x
    (and f32 x at the talker's four), or at `cases` ((bits, shape, M, N, K,
    dtype)), device time per call with the weights
    cycled past L2, beside the tiled CUDA-core kernel in the same call (x at a
    2-byte offset, which the tiled kernel takes and the GEMM does not), the
    plain version, bf16 `F.linear` on the dequantized weight (a yardstick,
    never a route) and the bound: the operations at the bf16 tensor-core
    peak (three times them for f32 x, split into three bf16 parts) against
    the bytes."""
    from mlx_audio_tpu_torch.ops.cuda.quant_matmul import (quantized_matmul,
                                                           quantized_matmul_reference)

    timing = {}
    cases = cases or [(bits, shape, M, N, K, dtype) for bits in (4, 6)
                      for dtype in (torch.bfloat16, torch.float32)
                      for shape, M, N, K in QMM_PREFILL if dtype == torch.bfloat16 or M == TP]
    for bits, shape, M, N, K, dtype in cases:
        key = f"{'qmm6' if bits == 6 else 'qmm'}_{shape}_m{M}" + ("_f32" if dtype != torch.bfloat16
                                                                 else "")
        g = torch.Generator(device="cuda").manual_seed(450 + bits)
        sets = [quant_weights(N, K, bits, g)]
        wbytes = weight_bytes(*sets[0])
        sets += [tuple(t.clone() for t in sets[0]) for _ in range(int(2 * L2_BYTES // wbytes))]
        x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
        x_off = torch.cat([x[:, :1], x], dim=1)[:, 1:]  # not 16-byte aligned
        w_dense = quantized_matmul_reference(torch.eye(K, device="cuda"), *sets[0], bits=bits,
                                             group_size=GROUP).T.contiguous().bfloat16()
        dense = [w_dense] + [w_dense.clone() for _ in range(int(2 * L2_BYTES // (2 * N * K)))]
        xb = x.bfloat16()

        def qmm(xx, w):
            return quantized_matmul(xx, *w, bits=bits, group_size=GROUP)

        for xx, want in ((x, "qmm_mma"), (x_off, "qmm_kernel")):
            fault = qmm_route_fault(*qmm_taken(lambda: qmm(xx, sets[0]), bits), want, bits)
            if fault:
                raise SystemExit(f"chip_smoke: {key} did not launch one {want}: {fault}")
        ms, loop = device_ms([lambda w=w: qmm(x, w) for w in sets], 400)
        tiled, _ = device_ms([lambda w=w: qmm(x_off, w) for w in sets], 100)
        plain, _ = device_ms([lambda w=w: quantized_matmul_reference(
            x, *w, bits=bits, group_size=GROUP) for w in sets], 20)
        yard, _ = device_ms([lambda d=d: F.linear(xb, d) for d in dense], 400)
        bound, by = quant_bound_ms(wbytes, M, K, N, dtype, 2.0 * M * N * K)
        timing[key] = dict(ms=ms, plain_ms=plain, library_ms=None, yardstick_ms=yard,
                           tiled_ms=tiled, bound_ms=bound, bound_by=by, host_loop_ms=loop)
        log(f"[time] {key}: {bits}-bit M={M} N={N} K={K} {str(dtype)[6:]} x (weights cycled "
            f"past L2), device time per call: qmm_mma {ms:.4f} ms, the tiled qmm_kernel "
            f"{tiled:.4f} ms ({tiled / ms:.2f}x), plain {plain:.4f} ms, yardstick F.linear on "
            f"the bf16 dequantized weight {yard:.4f} ms ({ms / yard:.2f}x of it), bound "
            f"{bound:.4f} ms ({by}); qmm_mma at {100 * bound / ms:.1f}% of bound")
        del sets, dense
    torch.cuda.empty_cache()
    return timing


def qwen_predicate(path, m):
    """bench.py's int4 choice: every Linear but the code predictor's heads,
    which the decode loop reads raw."""
    from mlx_audio_tpu_torch.nn import Linear

    return isinstance(m, Linear) and "code_predictor.lm_head" not in path


def qwen_model(bits, device="cuda", dtype=torch.bfloat16, seed=0, speaker=False, **depth):
    """Qwen3-TTS at the published 0.6B widths (`ModelConfig.from_dict({})`),
    quantized and row-stacked as bench.py builds it (`bits=None`: not
    quantized, as `bench_qwen3_tts()`); `speaker` adds a Base checkpoint's
    speaker encoder at its published widths; `depth` may cut the layer
    counts (talker, code_predictor, codec)."""
    from mlx_audio_tpu_torch.nn.quantized import fuse_quantized_projections, quantize_module
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model, ModelConfig

    cfg = ModelConfig.from_dict({"speaker_encoder_config": {}} if speaker else {})
    if depth:
        cfg.talker_config.num_hidden_layers = depth["talker"]
        cfg.talker_config.code_predictor_config.num_hidden_layers = depth["code_predictor"]
        cfg.tokenizer_config.decoder_config.num_hidden_layers = depth["codec"]
    model = Model(cfg, device=device, dtype=dtype, seed=seed)
    if bits is not None:
        quantize_module(model, bits=bits, predicate=qwen_predicate)
        fuse_quantized_projections(model)
    model.set_runtime(tokenizer=AsciiTok())
    return model


def phase_qwen_card_vs_cpu():
    """A 2-layer talker, 1-layer code predictor and 1-layer codec at full
    width, int4, float32: the card takes the kernels, the CPU dequantize +
    matmul. Prefill logits, one decode step and a codec waveform."""
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    depth = dict(talker=2, code_predictor=1, codec=1)
    cpu = qwen_model(4, device="cpu", dtype=torch.float32, seed=1, **depth)
    card = qwen_model(4, device="cuda", dtype=torch.float32, seed=2, **depth)
    card.load_state_dict(cpu.state_dict())
    qk.reset_launches()
    errs = {}
    with torch.inference_mode():
        out = {}
        for tag, m in (("cpu", cpu), ("card", card)):
            embeds, trailing, _ = m._prepare_generation_inputs(QWEN_TEXT)
            Tp = embeds.shape[1]
            inp = embeds.new_zeros(1, 32, embeds.shape[-1])
            inp[:, :Tp] = embeds
            caches = m.talker.model.make_caches(1, 40)
            logits, _ = m._prefill(caches, inp, Tp)
            step, _ = m.talker(trailing[:, :1], caches)
            codes = torch.randint(0, 2048, (1, 16, 40),
                                  generator=torch.Generator().manual_seed(3))
            wav = m.speech_tokenizer.decode(codes.to(m.device))
            out[tag] = dict(inputs=embeds, prefill=logits, step=step, wave=wav)
    for what in ("inputs", "prefill", "step", "wave"):
        errs[what] = (out["card"][what].cpu() - out["cpu"][what]).abs().max().item()
    counts = quant_counts(4)
    log(f"[card-vs-cpu] Qwen3-TTS 2+1+1 layers at full width, int4, f32: prompt embeds "
        f"max|d|={errs['inputs']:.3e}, prefill logits {errs['prefill']:.3e}, decode step "
        f"logits {errs['step']:.3e}, codec waveform {errs['wave']:.3e} (atol "
        f"{QWEN_CARD_VS_CPU_ATOL:g}); card launches {counts}")
    for what, err in errs.items():
        if not err <= QWEN_CARD_VS_CPU_ATOL:
            raise SystemExit(f"chip_smoke: Qwen3-TTS card vs CPU {what} max|d| {err}")
    # the f32 prefill at M = 32 takes the tensor-core GEMM's split route
    if min(counts[k] for k in ("qmm_gemv", "qmm_mma", "qmlp")) <= 0:
        raise SystemExit("chip_smoke: the card comparison did not go through the kernels")
    del cpu, card
    torch.cuda.empty_cache()


def route_table(bits):
    """Counts by wrapper and qmm kernel, and the two helpers that add a
    projection or a transformer layer at M rows to them, by the routing
    guards (`nn.quantized.qmm_routable`, `fused_mlp_routable`)."""
    from mlx_audio_tpu_torch.nn.quantized import fused_mlp_routable, qmm_routable

    n = {"qmm": 0, "qmlp": 0, "qmm_gemv": 0, "qmm_mma": 0, "qmm_kernel": 0}

    def proj(N, K, M, times=1):
        if qmm_routable(bits, GROUP, N, K, M):
            n["qmm"] += times
            n[qmm_route("", M, bits, K, GROUP)] += times

    def layer(c, M, times=1):
        q, kv = c.num_attention_heads * c.head_dim, c.num_key_value_heads * c.head_dim
        proj(q + 2 * kv, c.hidden_size, M, times)  # fused q/k/v
        proj(c.hidden_size, q, M, times)  # o_proj
        if fused_mlp_routable(bits, GROUP, c.hidden_size, c.intermediate_size,
                              c.hidden_size, M):
            n["qmlp"] += times
        else:
            proj(2 * c.intermediate_size, c.hidden_size, M, times)  # fused gate/up
            proj(c.hidden_size, c.intermediate_size, M, times)  # down

    return n, proj, layer


def predicted_serving_launches(model, bits, prompt_buckets, frames, slots,
                               layers_only=False) -> dict:
    """Kernel launches of the slot batcher (`Qwen3TTSBatcher`) from the
    routing guards: each request's B = 1 prefill at its prompt bucket (the
    talker's layers and its codec head over every row), then `frames` frame
    steps of the whole pool (ticks x tick_frames, every slot, live or not):
    the talker step and its head at M = slots, the code predictor's
    two-token seed at M = 2 slots and its 15 single steps at M = slots. The
    text projection runs on the callers' threads, before the count.
    `layers_only`: a loaded model, whose codec head stays unquantized."""
    tk = model.config.talker_config
    cp = tk.code_predictor_config
    n, proj, layer = route_table(bits)
    for bucket in prompt_buckets:  # one a request
        layer(tk, bucket, tk.num_hidden_layers)
        if not layers_only:
            proj(tk.vocab_size, tk.hidden_size, bucket)
    layer(tk, slots, frames * tk.num_hidden_layers)
    if not layers_only:
        proj(tk.vocab_size, tk.hidden_size, slots, frames)
    layer(cp, 2 * slots, frames * cp.num_hidden_layers)
    layer(cp, slots, frames * cp.num_hidden_layers * (tk.num_code_groups - 1))
    return n


def predicted_launches(model, bits, frames, layers_only=False) -> dict:
    """Kernel launches of one `generate` of `frames` frames of QWEN_TEXT,
    from the routing guards (`nn.quantized.qmm_routable`,
    `fused_mlp_routable`) applied to every quantized call the path makes:
    "qmm" and "qmlp" by wrapper, and the qmm launches by kernel
    (`qmm_route`). `layers_only`: the model quantizes what the loader does
    (`Model.model_quant_predicate`: the talker's and the code predictor's
    transformer layers), not the text projection, codec head and codec."""
    cfg = model.config
    tk = cfg.talker_config
    cp = tk.code_predictor_config
    dc = cfg.tokenizer_config.decoder_config
    n, proj, layer = route_table(bits)

    def head(N, K, M, times=1):  # a projection outside the transformer layers
        if not layers_only:
            proj(N, K, M, times)

    chat = f"<|im_start|>assistant\n{QWEN_TEXT}<|im_end|>\n<|im_start|>assistant\n"
    for M in (len(AsciiTok().encode(chat)), 3):  # the prompt, then tts bos/eos/pad
        head(tk.text_hidden_size, tk.text_hidden_size, M)
        head(tk.hidden_size, tk.text_hidden_size, M)
    prompt = model._prepare_generation_inputs(QWEN_TEXT)[0].shape[1]
    Tp = -(-prompt // 32) * 32  # the prefill bucket, codec head over all of it
    if Tp != TP:
        raise SystemExit(f"chip_smoke: the prefill bucket is {Tp}, phase 2 timed TP = {TP}")
    layer(tk, Tp, tk.num_hidden_layers)
    head(tk.vocab_size, tk.hidden_size, Tp)
    # each frame: one talker step and its head; 16 code predictor calls, the
    # two-token seed and 15 single tokens (the last one unused)
    layer(tk, 1, frames * tk.num_hidden_layers)
    head(tk.vocab_size, tk.hidden_size, 1, frames)
    layer(cp, 2, frames * cp.num_hidden_layers)
    layer(cp, 1, frames * cp.num_hidden_layers * (tk.num_code_groups - 1))
    if layers_only:
        return n
    # the codec: one chunk (frames <= 300), B = 1, so M = frames, then the
    # ConvNeXt blocks after each upsampling
    assert frames <= 300
    proj(dc.hidden_size, dc.latent_dim, frames)
    layer(dc, frames, dc.num_hidden_layers)
    proj(dc.latent_dim, dc.hidden_size, frames)
    T = frames
    for r in dc.upsampling_ratios:
        T *= r
        proj(4 * dc.latent_dim, dc.latent_dim, T)
        proj(dc.latent_dim, 4 * dc.latent_dim, T)
    return n


def qwen_run(model, frames, codes_seen):
    def run():
        out = list(model.generate(QWEN_TEXT, temperature=0.9, top_k=50, max_tokens=frames,
                                  min_tokens=frames, seed=0))
        torch.cuda.synchronize()
        return out

    orig = model._decode_codes

    def spy(codes):
        codes_seen.append(np.array(codes))
        return orig(codes)

    model._decode_codes = spy
    return run


def quant_counts(bits) -> dict:
    """The quantized wrappers' launch counts, the qmm ones by kernel."""
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    if bits == 6:
        return {"qmm6": qk.quantized_matmul6.launches, **qk.quantized_matmul6.kernels}
    return {"qmm": qk.quantized_matmul.launches, "qmlp": qk.quantized_mlp.launches,
            **qk.quantized_matmul.kernels}


def counted_run(run, bits, predicted, label):
    """One run with the quantized counts set to 0 just before it and read
    just after, each held to the routing table's; the kernels the path must
    take (the GEMV, the tensor-core GEMM, and qmlp at 4 bits) at least once."""
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    qk.reset_launches()
    t0 = time.perf_counter()
    results = run()
    wall = time.perf_counter() - t0
    got = quant_counts(bits)
    log(f"[{label}] launches {got}, routing table {predicted}")
    for k, want in predicted.items():
        if got[k] != want:
            raise SystemExit(f"chip_smoke: {label} launched {k} {got[k]} times, the routing "
                             f"table says {want}")
    for k in ("qmm_gemv", "qmm_mma") + (("qmlp",) if bits != 6 else ()):
        if got[k] <= 0:
            raise SystemExit(f"chip_smoke: {label} launched no {k}")
    return results, wall, got


def check_synthesis(results, frames, codes_seen, model, label):
    if len(results) != 1 or results[0].token_count != frames:
        raise SystemExit(f"chip_smoke: {label} gave {[r.token_count for r in results]} frames")
    audio = results[0].audio
    G = model.config.talker_config.num_code_groups
    if audio.shape != (frames * model.speech_tokenizer.decode_upsample_rate,) or \
            not np.isfinite(audio).all() or np.abs(audio).max() > 1.0:
        raise SystemExit(f"chip_smoke: {label} audio {audio.shape} not finite or out of range")
    codes = codes_seen[-1]
    if codes.shape != (frames, G) or codes.min() < 0 or codes.max() >= 2048:
        raise SystemExit(f"chip_smoke: {label} codes {codes.shape} out of range")
    if any(not np.array_equal(c, codes) for c in codes_seen):
        raise SystemExit(f"chip_smoke: {label}: repeated runs with one seed disagree")


def phase_qwen_slice(keep):
    """Qwen3-TTS 0.6B int4: QWEN_FRAMES through `generate`, a warm-up and
    QWEN_TIMED timed runs, launches held to the routing table's each run. The model
    stays in `keep` for phase 11."""
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    t0 = time.perf_counter()
    model = qwen_model(4)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[qwen3] Qwen3-TTS 0.6B widths, int4 g64 (fused q/k/v and gate/up), bf16 "
        f"activations in, f32 scales and KV caches: {n_params / 1e6:.1f} M stored values, "
        f"built in {time.perf_counter() - t0:.1f} s")
    frames = QWEN_FRAMES
    predicted = predicted_launches(model, 4, frames)
    codes_seen = []
    run = qwen_run(model, frames, codes_seen)
    for _ in range(QWEN_WARMUP):
        t0 = time.perf_counter()
        run()
        log(f"[qwen3] warm-up wall {time.perf_counter() - t0:.4f} s")
    torch.cuda.reset_peak_memory_stats()
    walls, launches = [], None
    for _ in range(QWEN_TIMED):
        results, wall, got = counted_run(run, 4, predicted, "qwen3")
        walls.append(wall)
        launches = launches or got
        check_synthesis(results, frames, codes_seen, model, "qwen3 int4")
        if qk.quantized_matmul6.launches:
            raise SystemExit("chip_smoke: the int4 path launched the 6-bit kernel")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    audio_s = results[0].samples / model.sample_rate
    med = statistics.median(walls)
    log(f"[qwen3] {frames} frames = {audio_s:.2f} s of audio, {QWEN_TIMED} runs after "
        f"{QWEN_WARMUP} warm-up: walls {', '.join(f'{w:.4f}' for w in walls)} s; median "
        f"RTF {med / audio_s:.4f} (wall / audio), {frames / med:.1f} talker frames/s, "
        f"{audio_s / med:.2f}x real time; peak memory {peak_gb:.2f} GB; codes identical "
        f"across {len(codes_seen)} runs")
    short = qwen_run(model, QWEN_PROFILE_FRAMES, [])
    pred16 = predicted_launches(model, 4, QWEN_PROFILE_FRAMES)
    _, seen = profile_one_run(short, f"one {QWEN_PROFILE_FRAMES}-frame synthesis")
    log_m_gt_4(seen, 4, pred16, "qwen3")
    del model._decode_codes  # qwen_run's spy
    keep["qwen3_int4"] = model
    return launches


def phase_qwen_bf16(keep):
    """Qwen3-TTS 0.6B unquantized in bf16, as `bench_qwen3_tts()` runs it:
    QWEN_FRAMES frames, temperature 0.9, top_k 50, seed 0; the median of
    QWEN_TIMED runs after a warm-up, and no launch of any quantized kernel.
    The model stays in `keep` for phase 11."""
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    gc.collect()
    torch.cuda.empty_cache()
    model = qwen_model(None)
    n_params = sum(p.numel() for p in model.parameters())
    frames = QWEN_FRAMES
    codes_seen = []
    run = qwen_run(model, frames, codes_seen)
    t0 = time.perf_counter()
    run()
    log(f"[qwen3-bf16] Qwen3-TTS 0.6B widths, bf16, not quantized, {n_params / 1e6:.1f} M "
        f"params; warm-up wall {time.perf_counter() - t0:.4f} s")
    torch.cuda.reset_peak_memory_stats()
    qk.reset_launches()
    walls = []
    for _ in range(QWEN_TIMED):
        t0 = time.perf_counter()
        results = run()
        walls.append(time.perf_counter() - t0)
        check_synthesis(results, frames, codes_seen, model, "qwen3 bf16")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    quant = {"qmm_qmlp": quant_counts(4), "qmm6": quant_counts(6)}
    if any(n for counts in quant.values() for n in counts.values()):
        raise SystemExit(f"chip_smoke: the unquantized model launched quantized kernels {quant}")
    audio_s = results[0].samples / model.sample_rate
    med = statistics.median(walls)
    log(f"[qwen3-bf16] {frames} frames = {audio_s:.2f} s of audio, {QWEN_TIMED} runs after "
        f"{QWEN_WARMUP} warm-up: "
        f"walls {', '.join(f'{w:.4f}' for w in walls)} s; median RTF {med / audio_s:.4f}, "
        f"{frames / med:.1f} talker frames/s; peak memory {peak_gb:.2f} GB; quantized "
        f"kernel launches {quant}; codes identical across {len(codes_seen)} runs")
    del model._decode_codes  # qwen_run's spy
    keep["qwen3_bf16"] = model
    return {"frames": frames, "audio_s": audio_s, "walls_s": walls, "rtf": med / audio_s,
            "frames_per_s": frames / med, "peak_gb": peak_gb, "quantized_launches": quant}


def phase_qwen_6bit():
    """The same model at 6 bits, 32 frames: the 6-bit kernel carries every
    routed projection, the MLPs included (the fused MLP kernel takes 4 and
    8 bits). Then a profiled 16-frame run: device time per frame and the
    6-bit GEMV's time per launch in the decode loop, with the run's 6-bit
    launches held to the routing table's."""
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    model = qwen_model(6)
    frames = QWEN_FRAMES_6BIT
    predicted = six_bit(predicted_launches(model, 6, frames))
    codes_seen = []
    run = qwen_run(model, frames, codes_seen)
    walls = []
    for _ in range(2):
        results, wall, got = counted_run(run, 6, predicted, "qwen3-6bit")
        walls.append(wall)
        check_synthesis(results, frames, codes_seen, model, "qwen3 6-bit")
    log(f"[qwen3-6bit] {frames} frames twice: walls {', '.join(f'{w:.4f}' for w in walls)} s, "
        f"codes identical")
    pframes = QWEN_PROFILE_FRAMES
    short = qwen_run(model, pframes, [])
    pred16 = six_bit(predicted_launches(model, 6, pframes))  # runs projections itself
    qk.reset_launches()
    busy, seen = profile_one_run(short, f"one {pframes}-frame 6-bit synthesis")
    counted, want = quant_counts(6), pred16
    q6 = {k: v for k, v in seen.items() if "<6," in k and ("qmm_gemv" in k or "qmm_kernel" in k)}
    n = sum(c for c, _ in q6.values())
    gemv = [(c, us) for k, (c, us) in q6.items() if "qmm_gemv" in k]
    n_gemv, us_gemv = sum(c for c, _ in gemv), sum(us for _, us in gemv)
    log(f"[qwen3-6bit] profiled {pframes} frames: device time {busy / 1e3:.2f} ms, "
        f"{busy / 1e3 / pframes:.3f} ms a frame; 6-bit launches counted {counted} (routing "
        f"table {want}), {n} in the profile: the GEMV {n_gemv} at "
        f"{us_gemv / max(n_gemv, 1):.2f} us a launch, {us_gemv / 1e3:.2f} ms in all")
    log_m_gt_4(seen, 6, pred16, "qwen3-6bit")
    if counted != want:
        raise SystemExit(f"chip_smoke: the profiled 6-bit run launched {counted}, the routing "
                         f"table says {want}")
    del model, run, short
    torch.cuda.empty_cache()
    return got


def six_bit(predicted) -> dict:
    """A routing table's counts under the 6-bit wrapper's names."""
    return {"qmm6": predicted["qmm"],
            **{k: predicted[k] for k in ("qmm_gemv", "qmm_mma", "qmm_kernel")}}


def log_m_gt_4(seen, bits, predicted, label) -> None:
    """The M > 4 kernels' device time and launches in a profiled run, beside
    the routing table's count."""
    for kernel in ("qmm_mma", "qmm_kernel"):
        hits = [(c, us) for k, (c, us) in seen.items() if kernel in k and f"<{bits}," in k]
        n, us = sum(c for c, _ in hits), sum(us for _, us in hits)
        log(f"[{label}] profiled: {kernel} (M > 4) {n} launches (routing table "
            f"{predicted[kernel]}), {us / 1e3:.2f} ms of device time"
            + (f", {us / n:.2f} us a launch" if n else ""))


def relu2_inputs(B, G, N, D, E, dtype, split_v, seed):
    """q, k (B, G, N, D) and v (B, G, N, E); with `split_v`, v is the first
    half of a (B, G, N, 2E) tensor, as MossFormer2 hands v and u over."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(B, G, N, D, generator=g, device="cuda").to(dtype) for _ in range(2))
    if split_v:
        v = torch.randn(B, G, N, 2 * E, generator=g, device="cuda").to(dtype)[..., :E]
    else:
        v = torch.randn(B, G, N, E, generator=g, device="cuda").to(dtype)
    return q, k, v


def planted_relu2_check(name, q, k, v, ref) -> None:
    """What a kernel without the ReLU (negative scores squared too), or one
    that skips the last, ragged key tile of 64, returns; the bars must
    reject both."""
    from mlx_audio_tpu_torch.ops.cuda.relu2_attention import relu2_attention_reference

    N = q.shape[2]
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) / N
    faults = [("ReLU dropped", torch.matmul(sim.square().to(v.dtype).float(),
                                            v.float()).to(v.dtype))]
    if N % 64:
        n0 = N - N % 64
        faults.append((f"last key tile ({N % 64} keys) skipped",
                       relu2_attention_reference(q, k[..., :n0, :], v[..., :n0, :], N)))
    for fault, planted in faults:
        ok, _, desc = compare_q(planted, ref, R2_BF16_ULPS)
        log(f"[kernel] planted fault in relu2 {name} ({fault}): {desc} -> "
            f"{'passes: the bar is too loose' if ok else 'rejected'}")
        if ok:
            raise SystemExit(f"chip_smoke: the relu2 bar accepts a kernel with the {fault}")


def relu2_bound_ms(B, G, N, D, E, dtype) -> tuple:
    flops = 2.0 * B * G * N * N * (D + E)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * B * G * N * (2 * D + 2 * E)  # q, k, v read once; out written once
    t_ops, t_bytes = ops_s(flops, dtype), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_relu2_kernel():
    """The ReLU² kernel against its plain version at the slice's shapes and
    ragged ones, then timed at the 20 s and 4 s chunk shapes."""
    from mlx_audio_tpu_torch.ops.cuda.relu2_attention import (
        relu2_attention, relu2_attention_reference)

    errs = {}
    for i, (name, B, G, N, D, E, dtype, split_v) in enumerate(R2_CASES):
        q, k, v = relu2_inputs(B, G, N, D, E, dtype, split_v, seed=600 + i)
        out = relu2_attention(q, k, v)
        torch.cuda.synchronize()
        ref = relu2_attention_reference(q, k, v)
        ok, err, desc = compare_q(out, ref, R2_BF16_ULPS)
        log(f"[kernel] relu2 {name} B={B} G={G} N={N} D={D} E={E} v row stride "
            f"{v.stride(2)}: {desc}")
        if not ok:
            raise SystemExit(f"chip_smoke: relu2_attention {name} over its bar: {desc}")
        errs[name] = err
        if name in ("chunk20s_f32", "merged20s_f32", "ragged200_f32", "ragged200_bf16"):
            planted_relu2_check(name, q, k, v, ref)

    timing = {}
    for name, B, G, E, dtype, split_v in (
            ("merged20s_f32", 1, 10, 2048, torch.float32, False),
            ("merged4s_f32", 1, 2, 2048, torch.float32, False),
            ("merged20s_bf16", 1, 10, 2048, torch.bfloat16, False),
            ("merged4s_bf16", 1, 2, 2048, torch.bfloat16, False),
            ("chunk20s_f32", 1, 10, 1024, torch.float32, True),
            ("merged4s_b8_f32", 8, 2, 2048, torch.float32, False)):
        N, D = 256, 128
        q, k, v = relu2_inputs(B, G, N, D, E, dtype, split_v, seed=700)
        ms, loop = device_ms([lambda: relu2_attention(q, k, v, N)], 200)
        plain, _ = device_ms([lambda: relu2_attention_reference(q, k, v, N)], 50)
        bound, by = relu2_bound_ms(B, G, N, D, E, dtype)
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
                            bound_by=by, host_loop_ms=loop)
        log(f"[time] relu2 {name} B={B} G={G} N={N} D={D} E={E} (v row stride {v.stride(2)}), "
            f"device time per call: kernel {ms:.4f} ms, plain (two cuBLAS matmuls) {plain:.4f} ms, "
            f"no library call computes ReLU² attention, bound {bound:.4f} ms ({by}); kernel "
            f"at {100 * bound / ms:.1f}% of bound; a Python loop of launches takes "
            f"{loop:.4f} ms a call")
    return errs, timing


def fill_depthwise(model, seed: int) -> None:
    """Seeded uniform values (bound K^-1/2) for the depthwise weights, which
    the constructors leave at zero, so that no branch computes zeros."""
    from mlx_audio_tpu_torch.sts.models.mossformer2_se.mossformer2 import (ConvModule,
                                                                           UniDeepFsmn)

    g = torch.Generator(device=model.device).manual_seed(seed)
    for m in model.modules():
        w = {ConvModule: "weight", UniDeepFsmn: "conv1"}.get(type(m))
        if w:
            p = getattr(m, w)
            p.data.uniform_(-p.shape[1] ** -0.5, p.shape[1] ** -0.5, generator=g)


def phase_moss_card_vs_cpu():
    """A one-block MossFormer2-SE at full width, f32, TF32 off: the card
    (ReLU² kernel, cuFFT, cuDNN, cuBLAS) against the CPU on one 4 s chunk of
    seeded noise, the same dither draw fed to both."""
    from mlx_audio_tpu_torch import dsp
    from mlx_audio_tpu_torch.ops.cuda.relu2_attention import relu2_attention
    from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model, MossFormer2SEConfig
    from mlx_audio_tpu_torch.sts.models.mossformer2_se.model import (
        MAX_WAV_VALUE, _features, _process_chunk_core)

    cfg = MossFormer2SEConfig(num_blocks=1)
    cpu = Model(cfg, device="cpu", seed=1)
    fill_depthwise(cpu, 2)
    card = Model(cfg, device="cuda", seed=3)
    card.load_state_dict(cpu.state_dict())
    audio = torch.from_numpy((np.random.default_rng(4).standard_normal(4 * cfg.sample_rate)
                              * 0.05 * MAX_WAV_VALUE).astype(np.float32))
    frames = 1 + (audio.shape[0] - cfg.win_len) // cfg.win_inc
    noise = dsp.kaldi_dither((frames, cfg.win_len), "cpu")
    relu2_attention.launches = 0
    out = {}
    with torch.inference_mode():
        for tag, m, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
            x, n = audio.to(dev), noise.to(dev)
            mask = m.net.model(_features(x, cfg, n))[-1][0]
            wave = _process_chunk_core(m.net.model, x, cfg, n)
            out[tag] = (mask.cpu(), wave.cpu())
    launches = relu2_attention.launches
    for i, what in enumerate(("mask", "waveform")):
        ref, got = out["cpu"][i], out["card"][i]
        err, peak = (got - ref).abs().max().item(), ref.abs().max().item()
        log(f"[card-vs-cpu] MossFormer2-SE, 1 block at full width, f32, one 4 s chunk: "
            f"{what} {tuple(got.shape)} max|d|={err:.3e}, max|ref|={peak:.3e} (bar "
            f"{MOSS_CARD_VS_CPU_REL:g} of max|ref|)")
        if not err <= MOSS_CARD_VS_CPU_REL * peak or not torch.isfinite(got).all():
            raise SystemExit(f"chip_smoke: MossFormer2-SE card vs CPU {what} max|d| {err}")
    log(f"[card-vs-cpu] MossFormer2-SE card launches: relu2 {launches}")
    if launches != 2:  # one FLASH layer (v and u in one call), two forward passes
        raise SystemExit("chip_smoke: the card comparison did not go through the relu2 kernel")
    del cpu, card
    torch.cuda.empty_cache()


def phase_moss_slice(keep):
    """MossFormer2-SE 48 kHz at full width, f32: three requests through
    `Model.enhance`, 1 warm-up and 3 timed runs each; the ReLU² kernel's
    launches of one pass over the three held to the prediction. The model
    stays in `keep` for phase 11."""
    from mlx_audio_tpu_torch.ops.cuda.relu2_attention import relu2_attention
    from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model

    gc.collect()  # the Qwen3-TTS models of phases 5-6 sit in reference cycles
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model = Model(device="cuda", seed=0)
    fill_depthwise(model, 1)
    torch.cuda.synchronize()
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[moss] MossFormer2-SE 48 kHz widths ({cfg.in_channels} in, d_model "
        f"{cfg.out_channels}, {cfg.num_blocks} blocks, {cfg.out_channels_final}-bin mask), f32, "
        f"{n_params / 1e6:.1f} M params, built in {time.perf_counter() - t0:.1f} s")
    chunks = [n for _, _, n in MOSS_REQUESTS]
    predicted = cfg.num_blocks * sum(chunks)  # v;u in one call, each FLASH layer, each chunk
    audios = [(np.random.default_rng(10 + i).standard_normal(int(sec * cfg.sample_rate))
               * 0.05).astype(np.float32) for i, (sec, _, _) in enumerate(MOSS_REQUESTS)]

    def run(i):
        t0 = time.perf_counter()
        out = model.enhance(audios[i])  # returns numpy: synchronised
        return out, time.perf_counter() - t0

    for _ in range(MOSS_WARMUP):
        log(f"[moss] warm-up walls {', '.join(f'{run(i)[1]:.4f}' for i in range(3))} s")
    torch.cuda.reset_peak_memory_stats()
    relu2_attention.launches = 0
    firsts, walls = [], [[] for _ in MOSS_REQUESTS]
    for i in range(3):
        out, wall = run(i)
        firsts.append(out)
        walls[i].append(wall)
    launches = relu2_attention.launches
    log(f"[moss] relu2 launches over the three requests: {launches} (predicted "
        f"{cfg.num_blocks} FLASH layers x {sum(chunks)} chunks {chunks} = {predicted})")
    if launches != predicted:
        raise SystemExit(f"chip_smoke: MossFormer2-SE launched relu2 {launches} times, "
                         f"predicted {predicted}")
    for _ in range(MOSS_TIMED - 1):
        for i in range(3):
            out, wall = run(i)
            walls[i].append(wall)
            if not np.array_equal(out, firsts[i]):
                raise SystemExit("chip_smoke: MossFormer2-SE repeated runs disagree")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, ((sec, route, _), out) in enumerate(zip(MOSS_REQUESTS, firsts)):
        if out.shape != audios[i].shape or not np.isfinite(out).all():
            raise SystemExit(f"chip_smoke: MossFormer2-SE {sec} s output {out.shape} not finite")
        med = statistics.median(walls[i])
        log(f"[moss] {sec:.0f} s {route} ({chunks[i]} chunk{'s' * (chunks[i] > 1)}), "
            f"{MOSS_TIMED} runs after {MOSS_WARMUP} warm-ups: walls "
            f"{', '.join(f'{w:.4f}' for w in walls[i])} s; median {med:.4f} s = "
            f"{sec / med:.1f}x real time; output max|y| {np.abs(out).max():.4f}, "
            f"identical across runs")
    log(f"[moss] peak memory {peak_gb:.2f} GB, of which {before_gb:.2f} GB was allocated "
        f"before the model was built")
    profile_one_run(lambda: run(0), "one 20 s enhancement")
    keep["mossformer2_se"] = model
    return launches


def kokoro_model(device, dtype=torch.float32, seed=0):
    """Kokoro-82M at bench.py's widths with seeded random weights."""
    from mlx_audio_tpu_torch.nn import cast_floats
    from mlx_audio_tpu_torch.tts.models.kokoro import Model, ModelConfig

    vocab = {c: i + 1 for i, c in enumerate(dict.fromkeys(KOKORO_VOCAB_CHARS))}
    model = Model(ModelConfig.from_dict({**KOKORO_82M_CONFIG, "vocab": vocab}),
                  device=device, seed=seed)
    return cast_floats(model, dtype) if dtype != torch.float32 else model


def port_kernel_launches() -> dict:
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.ops.cuda.relu2_attention import relu2_attention

    return {"flash": flash_attention.launches, "qmm": qk.quantized_matmul.launches,
            "qmm6": qk.quantized_matmul6.launches, "qmlp": qk.quantized_mlp.launches,
            "relu2": relu2_attention.launches}


def phase_kokoro_card_vs_cpu(keep):
    """Kokoro-82M at full width, float32, TF32 off: the card against the CPU
    on ~40 phonemes, with one noise draw (made on the CPU) given to both.
    The card's model stays in `keep` for phase 11."""
    from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import FRAME_BUCKETS, _bucket

    cpu = kokoro_model("cpu", seed=1)
    card = kokoro_model("cuda", seed=2)
    card.load_state_dict(cpu.state_dict())
    ps = KOKORO_PHONEMES[:40]
    ref_s = (np.random.default_rng(3).standard_normal((1, 256)) * 0.1).astype(np.float32)
    frames = _bucket(int(card(ps, ref_s, return_output=True).pred_dur.sum()), FRAME_BUCKETS)
    L = frames * 2 * card.decoder.generator.total_upsample
    g = torch.Generator().manual_seed(4)
    noise = (torch.randn(1, 9, generator=g), torch.randn(1, L, 9, generator=g))
    t0 = time.perf_counter()
    ref = cpu(ps, ref_s, return_output=True, noise=noise)
    cpu_s = time.perf_counter() - t0
    got = card(ps, ref_s, return_output=True, noise=tuple(n.cuda() for n in noise))
    if not np.array_equal(ref.pred_dur, got.pred_dur):
        raise SystemExit(f"chip_smoke: Kokoro pred_dur card {got.pred_dur} vs CPU {ref.pred_dur}")
    if got.audio.shape != ref.audio.shape or not np.isfinite(got.audio).all():
        raise SystemExit(f"chip_smoke: Kokoro card audio {got.audio.shape} vs {ref.audio.shape}")
    err, peak = np.abs(got.audio - ref.audio).max(), np.abs(ref.audio).max()
    corr = np.corrcoef(got.audio, ref.audio)[0, 1]
    log(f"[card-vs-cpu] Kokoro-82M at full width, f32, {len(ps)} phonemes, {frames}-frame "
        f"bucket ({ref.pred_dur.sum()} frames, CPU {cpu_s:.1f} s): pred_dur identical; audio "
        f"{got.audio.shape} max|d|={err:.3e} ({err * 32767:.1f} int16 steps), max|ref|="
        f"{peak:.3e}, corr {corr:.6f} (bar {KOKORO_CARD_VS_CPU_REL:g} of max|ref|)")
    if not err <= KOKORO_CARD_VS_CPU_REL * peak:
        raise SystemExit(f"chip_smoke: Kokoro card vs CPU audio max|d| {err}")
    keep["kokoro_f32"] = card
    del cpu
    return {"phonemes": len(ps), "max_abs_err": float(err),
            "bar": float(KOKORO_CARD_VS_CPU_REL * peak)}


def phase_kokoro(keep):
    """Kokoro-82M at bench.py's widths in bf16 (seeded random weights):
    bench.py's 508 phonemes through `Model.__call__`, one warm-up and 5 timed
    runs (RTF = mean wall / audio seconds, as bench.py), one profiled run,
    and `Model.generate` through the pipeline with a seeded voice pack. The
    model stays in `keep` for phase 11."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = kokoro_model("cuda", torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[kokoro] Kokoro-82M (bench.py widths), bf16, {n_params:,} params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    ps = KOKORO_PHONEMES[:508]
    ref_s = (np.random.default_rng(0).standard_normal((1, 256)) * 0.1).astype(np.float32)
    sr = model.sample_rate
    voiced = []  # the sine source's voiced share (F0 above its threshold)
    hook = model.decoder.generator.m_source.l_sin_gen.register_forward_hook(
        lambda mod, args, out: voiced.append(out[1].mean().item()))
    t0 = time.perf_counter()
    first = model(ps, ref_s, return_output=True)
    log(f"[kokoro] warm-up {time.perf_counter() - t0:.2f} s; voiced share of the sine "
        f"source's samples {voiced[0]:.4f}")
    hook.remove()
    frames = int(first.pred_dur.sum())
    audio_s = first.audio.shape[0] / sr
    torch.cuda.reset_peak_memory_stats()
    before = port_kernel_launches()
    walls = []
    for _ in range(KOKORO_TIMED):
        t0 = time.perf_counter()
        audio = model(ps, ref_s)  # numpy: synchronised
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(audio, first.audio):
            raise SystemExit("chip_smoke: Kokoro repeated runs disagree")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = port_kernel_launches()
    spf = 2 * model.decoder.generator.total_upsample
    if not np.isfinite(first.audio).all() or first.audio.shape[0] != frames * spf:
        raise SystemExit(f"chip_smoke: Kokoro audio {first.audio.shape} for {frames} frames")
    wall = sum(walls) / len(walls)
    from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import FRAME_BUCKETS, _bucket

    log(f"[kokoro] {len(ps)} phonemes -> {frames} frames ({_bucket(frames, FRAME_BUCKETS)}-frame "
        f"bucket), {audio_s:.2f} s of audio; {KOKORO_TIMED} runs after 1 warm-up: walls "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; mean {wall:.4f} s, RTF {wall / audio_s:.6f}; "
        f"audio identical across runs, max|y| {np.abs(first.audio).max():.4f}")
    log(f"[kokoro] peak memory {peak_gb:.2f} GB; the port's kernels launched "
        f"{ {k: after[k] - before[k] for k in after} } (none is on this path)")
    profile_one_run(lambda: model(ps, ref_s), "one Kokoro-82M synthesis")
    profiled = profile_one_run.last
    # the frame-rate BiLSTM (predictor.shared) alone, at this run's bucket
    bucket = _bucket(frames, FRAME_BUCKETS)
    width = model.config.hidden_dim + model.config.style_dim
    en = torch.randn(1, bucket, width, generator=torch.Generator().manual_seed(6)).to(
        model.device, torch.bfloat16)
    valid = torch.tensor([frames], device=model.device)
    with torch.inference_mode():
        profile_one_run(lambda: model.predictor.shared(en, valid_len=valid).sum().item(),
                        f"the frame-rate BiLSTM ({bucket} steps forward, {frames} back)")
    bilstm = profile_one_run.last
    pack = (np.random.default_rng(5).standard_normal((510, 1, 256)) * 0.1).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "voices").mkdir()
        np.savez(Path(d) / "voices" / "af_smoke.npz", voice=pack)
        model.repo_id = d
        text = "The quick brown fox jumps over the lazy dog."
        results = list(model.generate(text, voice="af_smoke"))
    if len(results) != 1 or not np.isfinite(results[0].audio).all() or results[0].samples <= 0:
        raise SystemExit(f"chip_smoke: Kokoro generate gave {len(results)} segments")
    r = results[0]
    log(f"[kokoro] generate({text!r}, voice=af_smoke): {r.token_count} phonemes, "
        f"{r.samples} samples ({r.audio_duration}), {r.processing_time_seconds:.3f} s, "
        f"RTF {r.real_time_factor}, peak memory {r.peak_memory_usage} GiB")
    model.repo_id, model._pipelines = None, {}  # the voice directory is gone
    keep["kokoro"] = model
    return {"phonemes": len(ps), "frames": frames, "audio_s": audio_s, "voiced": voiced[0],
            "walls_s": walls, "rtf": wall / audio_s, "peak_gb": peak_gb,
            "profiled": profiled, "frame_rate_bilstm": bilstm,
            "port_kernel_launches": {k: after[k] - before[k] for k in after}}


# Phase 9: the rest of Whisper (the seek loop, beam search, word timing,
# streaming, writers) at full width in bf16, on the phase 4 model
REST_SEEK_S, REST_DEFAULTS_S, REST_LONG_S, REST_STREAM_S = 120.0, 30.0, 600.0, 10.0
REST_TIMED = 1  # 3 until phase 12 came, 2 until phase 13 came


def noise(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.05
            ).astype(np.float32)


def check_words(out, label) -> int:
    """Every word has start <= end; within a segment the starts and the ends
    do not decrease, and all lie inside the segment's 30 s window (to the
    0.01 s the times are rounded to). Returns the number of words."""
    n = 0
    for s in out.segments:
        lo = s["seek"] / 100.0
        ws = s["words"]
        n += len(ws)
        for w in ws:
            if not (w["start"] <= w["end"] and lo - 0.01 <= w["start"]
                    and w["end"] <= lo + 30.0 + 0.01):
                raise SystemExit(f"chip_smoke: {label} word {w} outside [{lo}, {lo + 30}]")
        for a, b in zip(ws, ws[1:]):
            if b["start"] < a["start"] or b["end"] < a["end"]:
                raise SystemExit(f"chip_smoke: {label} word times decrease: {a}, {b}")
    return n


def phase_whisper_rest(keep):
    """Whisper-large-v3-turbo in bf16 (the phase 4 model, seeded weights) through
    every route the port added after `generate_chunked`: the seek loop at
    `bench_whisper_serving`'s settings and at its defaults, conditioned
    long-form at `bench_whisper_conditioned`'s, beam search, word timing
    through both entry points, AlignAtt streaming and the writers. Each
    step's flash launches are held to a count derived from the code: one
    launch per encoder layer per encoder pass, and one encoder pass per seek
    window (two with word timing), per chunked group (word timing reuses
    its K/V), per conditioned decode group, per streamed chunk. The model
    stays in `keep` for phase 11."""
    import tempfile

    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions
    from mlx_audio_tpu_torch.stt.models.whisper import streaming, whisper
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer
    from mlx_audio_tpu_torch.stt.models.whisper.writers import get_writer

    gc.collect()
    torch.cuda.empty_cache()
    model = Model(ModelDimensions(**TURBO), dtype=torch.bfloat16, seed=0)
    tok = DummyTokenizer(n_vocab=TURBO["n_vocab"])
    L = TURBO["n_audio_layer"]
    rec = {}

    # every decode call of the entry points, by its temperature: the seek
    # loop makes one or more per window, the chunked path one per group
    decodes = []

    def spy(fn):
        def wrapped(*args, **kw):
            decodes.append(args[4].temperature)
            return fn(*args, **kw)
        return wrapped

    decode_window, decode_window_batch = whisper.decode_window, whisper.decode_window_batch
    whisper.decode_window = spy(decode_window)
    whisper.decode_window_batch = spy(decode_window_batch)

    def counted(run):
        decodes.clear()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, flash_attention.launches, list(decodes)

    def hold(label, launches, predicted, why):
        log(f"[rest] {label}: flash launches {launches}, predicted {predicted} ({why})")
        if launches != predicted:
            raise SystemExit(f"chip_smoke: {label} launched flash {launches} times, "
                             f"predicted {predicted}")

    def tokens(out):
        return [s["tokens"] for s in out.segments]

    def timed(label, run, seconds, predict, runs=REST_TIMED):
        """1 warm-up and `runs` counted runs: launches held each run,
        tokens equal across runs; returns (last output, walls)."""
        counted(run)
        outs, walls = [], []
        for _ in range(runs):
            out, wall, n, dec = counted(run)
            hold(label, n, *predict(out, dec))
            outs.append(out)
            walls.append(wall)
        if any(tokens(o) != tokens(outs[0]) for o in outs):
            raise SystemExit(f"chip_smoke: {label}: repeated runs disagree")
        med = statistics.median(walls)
        log(f"[rest] {label}: {runs} runs after 1 warm-up, walls "
            f"{', '.join(f'{w:.4f}' for w in walls)} s; median {med:.4f} s = "
            f"{seconds / med:.1f}x real time; tokens identical across runs")
        return outs[-1], walls

    # 1. the seek loop at bench_whisper_serving's settings
    a120 = noise(REST_SEEK_S, 0)
    windows = -(-len(a120) // 160 // 3000)  # content frames / N_FRAMES, rounded up
    seek_kw = dict(language="en", temperature=0.0, condition_on_previous_text=False,
                   no_speech_threshold=None, without_timestamps=True, sample_len=96,
                   tokenizer=tok)
    seek, walls = timed(
        f"seek loop, {REST_SEEK_S:g} s", lambda: model.generate(a120, **seek_kw), REST_SEEK_S,
        lambda out, dec: (L * len(dec), f"{L} per window, {len(dec)} windows decoded, "
                                        f"{windows} expected"))
    if len(seek.segments) != windows or any(len(t) != 96 for t in tokens(seek)):
        raise SystemExit(f"chip_smoke: seek loop gave {[len(t) for t in tokens(seek)]}")
    med = statistics.median(walls)
    _, seen = profile_one_run(lambda: model.generate(a120, **seek_kw),
                              f"one {REST_SEEK_S:g} s seek-loop transcription")
    flash = {k: n for k, (n, _) in seen.items() if "flash_fwd_bf16" in k}
    if seen and list(flash.values()) != [L * windows]:
        raise SystemExit(f"chip_smoke: the seek-loop profile shows flash kernels {flash}")
    chunk_kw = dict(language="en", temperature=0.0, tokenizer=tok, without_timestamps=True,
                    sample_len=96)
    greedy, cwalls = timed(f"chunked, {REST_SEEK_S:g} s (same call)",
                           lambda: model.generate_chunked(a120, **chunk_kw), REST_SEEK_S,
                           lambda out, dec: (L, "one group of 4 windows"))
    cmed = statistics.median(cwalls)
    log(f"[rest] seek loop {REST_SEEK_S / med:.1f}x real time against chunked "
        f"{REST_SEEK_S / cmed:.1f}x in this call: chunked is {med / cmed:.2f}x faster")
    rec["seek_loop"] = {"audio_s": REST_SEEK_S, "walls_s": walls, "xrt": REST_SEEK_S / med,
                        "flash_launches": L * windows, "profiled": profile_one_run.last,
                        "chunked_walls_s": cwalls, "chunked_xrt": REST_SEEK_S / cmed}

    # 2. the seek loop at its defaults: timestamps, conditioning, the
    # six-temperature fallback
    a30 = noise(REST_DEFAULTS_S, 2)
    out, wall, n, dec = counted(lambda: model.generate(a30, language="en", tokenizer=tok,
                                                        sample_len=96))
    starts = [i for i, t in enumerate(dec) if t == 0.0]
    tried = [dec[i:j] for i, j in zip(starts, starts[1:] + [len(dec)])]
    hold("seek loop defaults, 30 s", n, L * len(starts),
         f"{L} per window, {len(starts)} windows")
    log(f"[rest] seek loop defaults, 30 s: wall {wall:.4f} s, {len(out.segments)} segments; "
        f"temperatures tried per window {tried}, each window ended at "
        f"{[t[-1] for t in tried]}")
    rec["seek_defaults"] = {"audio_s": REST_DEFAULTS_S, "wall_s": wall, "windows": len(starts),
                            "temperatures": tried, "segments": len(out.segments)}

    # 3. conditioned long-form at bench_whisper_conditioned's settings
    a600 = noise(REST_LONG_S, 1)
    long_kw = dict(language="en", temperature=0.0, tokenizer=tok, without_timestamps=True,
                   sample_len=96, condition_on_previous_text=True, max_sweeps=2,
                   strict_conditioning=False)
    long, lwalls = timed(
        f"conditioned long-form, {REST_LONG_S:g} s",
        lambda: model.generate_chunked(a600, **long_kw), REST_LONG_S,
        lambda out, dec: (L * len(dec), f"{L} per decode group, {len(dec)} groups over "
                                        f"{out.extra['sweeps']} sweeps"))
    rec["conditioned"] = {"audio_s": REST_LONG_S, "walls_s": lwalls,
                          "xrt": REST_LONG_S / statistics.median(lwalls),
                          "sweeps": long.extra["sweeps"], "windows": len(long.segments)}

    # 4. beam search
    beam_runs = []
    for _ in range(2):
        out, wall, n, dec = counted(lambda: model.generate_chunked(a120, beam_size=5,
                                                                    **chunk_kw))
        hold("beam 5, 120 s", n, L, "one group of 4 windows x 5 beams")
        beam_runs.append((out, wall))
    if tokens(beam_runs[0][0]) != tokens(beam_runs[1][0]):
        raise SystemExit("chip_smoke: beam search: repeated runs disagree")
    beam1 = model.generate_chunked(a120, beam_size=1, **chunk_kw)
    if tokens(beam1) != tokens(greedy):
        raise SystemExit("chip_smoke: beam_size=1 does not give the greedy tokens")
    log(f"[rest] beam 5, 120 s: walls {', '.join(f'{w:.4f}' for _, w in beam_runs)} s, "
        f"tokens per window {[len(t) for t in tokens(beam_runs[0][0])]}, identical across "
        f"the 2 runs; beam_size=1 gives the greedy tokens")
    rec["beam5"] = {"audio_s": REST_SEEK_S, "walls_s": [w for _, w in beam_runs],
                    "flash_launches": L}

    # 5. word timing through both entry points
    words_out, wall, n, dec = counted(lambda: model.generate_chunked(
        a120, word_timestamps=True, **chunk_kw))
    hold("chunked word timing, 120 s", n, L, "one group; DTW reuses its K/V")
    n_words = check_words(words_out, "chunked word timing")
    log(f"[rest] chunked word timing, 120 s: wall {wall:.4f} s, {n_words} words")
    seek_words, swall, n, dec = counted(lambda: model.generate(
        a30, word_timestamps=True, **seek_kw))
    # without timestamps every window decodes text (EOT is never chosen), so
    # every window takes an alignment pass
    hold("seek-loop word timing, 30 s", n, 2 * L * len(dec),
         f"{2 * L} per window: the window and its alignment pass, {len(dec)} windows")
    n_seek_words = check_words(seek_words, "seek-loop word timing")
    if not n_seek_words:
        raise SystemExit("chip_smoke: the seek loop's word timing gave no words")
    log(f"[rest] seek-loop word timing, 30 s: wall {swall:.4f} s, {len(dec)} windows, "
        f"{n_seek_words} words")
    rec["word_timing"] = {"chunked_wall_s": wall, "chunked_words": n_words,
                          "seek_wall_s": swall, "seek_windows": len(dec),
                          "seek_words": n_seek_words}

    # 6. AlignAtt streaming, 1 s chunks
    a10 = noise(REST_STREAM_S, 3)
    chunk_walls = []
    decode_chunk = streaming.StreamingDecoder.decode_chunk

    def timed_chunk(self, *args, **kw):
        t0 = time.perf_counter()
        result = decode_chunk(self, *args, **kw)  # ends with a host read
        chunk_walls.append(time.perf_counter() - t0)
        return result

    streaming.StreamingDecoder.decode_chunk = timed_chunk

    def stream():
        t0 = time.perf_counter()
        first, results = None, []
        for r in model.generate_streaming(a10, chunk_duration=1.0, language="en",
                                          tokenizer=tok):
            first = first if first is not None else time.perf_counter() - t0
            results.append(r)
        return results, first

    stream()
    chunk_walls.clear()
    (results, first), wall, n, _ = counted(stream)
    chunks = int(REST_STREAM_S)
    hold("streaming, 10 s in 1 s chunks", n, L * chunks, f"{L} per chunk, {chunks} chunks")
    if not results or not results[-1].is_final or len(chunk_walls) != chunks:
        raise SystemExit(f"chip_smoke: streaming gave {len(results)} results over "
                         f"{len(chunk_walls)} chunks")
    log(f"[rest] streaming, 10 s: time to first result {first:.4f} s, wall {wall:.4f} s, "
        f"per chunk {', '.join(f'{w:.4f}' for w in chunk_walls)} s; {len(results)} results, "
        f"{sum(len(r.tokens) for r in results)} tokens")
    rec["streaming"] = {"audio_s": REST_STREAM_S, "first_result_s": first, "wall_s": wall,
                        "chunk_walls_s": list(chunk_walls), "results": len(results)}
    streaming.StreamingDecoder.decode_chunk = decode_chunk
    whisper.decode_window, whisper.decode_window_batch = decode_window, decode_window_batch

    # 7. the writers, on step 5's chunked output
    with tempfile.TemporaryDirectory() as d:
        get_writer("all", d)(words_out, "phase9.wav")
        sizes = {p.name: p.stat().st_size for p in sorted(Path(d).iterdir())}
    if sorted(sizes) != [f"phase9.{e}" for e in ("json", "srt", "tsv", "txt", "vtt")] \
            or not all(sizes.values()):
        raise SystemExit(f"chip_smoke: the writers wrote {sizes}")
    log(f"[rest] writers: {sizes} bytes")
    rec["writers_bytes"] = sizes
    keep["whisper"] = model
    return rec


# Phase 10: Whisper-large-v3-turbo, int4 Qwen3-TTS and Kokoro-82M loaded from
# checkpoint directories written in the run, through the library calls of
# the two generate CLIs, each held to the same seeded model in memory
LOADED_WHISPER_S, LOADED_WAV_SR = 120.0, 44100
LOADED_QWEN_FRAMES = 32
LOADED_KOKORO_TEXT = "The quick brown fox jumps over the lazy dog."


def same_parameters(a, b, label) -> None:
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    if sorted(pa) != sorted(pb):
        raise SystemExit(f"chip_smoke: {label}: the loaded model's parameters are not the "
                         f"in-memory model's: {sorted(set(pa) ^ set(pb))[:5]}")
    bad = [k for k in pa if pa[k].dtype != pb[k].dtype or not torch.equal(pa[k], pb[k])]
    if bad:
        raise SystemExit(f"chip_smoke: {label}: loaded parameters differ: {bad[:5]}")


def timed_load(path, **kw):
    from mlx_audio_tpu_torch import utils

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = utils.load_model(path, **kw)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def checkpoint_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).glob("*.safetensors"))


def loaded_safetensors(tmp: Path) -> dict:
    """The reader on this machine (no `safetensors` package here): every
    dtype written and read back bit for bit, a sharded checkpoint through
    its index, and a file cut short rejected."""
    from mlx_audio_tpu_torch import convert, safetensors_io, utils

    rng = np.random.default_rng(11)
    t = {f"x.{n}": rng.integers(0, 256, 96, dtype=np.uint8).view(d).reshape(-1, 2)
         for n, d in (("f64", "<f8"), ("f32", "<f4"), ("f16", "<f2"), ("i64", "<i8"),
                      ("u64", "<u8"), ("i32", "<i4"), ("u32", "<u4"), ("i16", "<i2"),
                      ("u16", "<u2"), ("i8", "i1"), ("u8", "u1"))}
    t["x.bool"] = rng.integers(0, 2, 10).astype(bool)
    t["x.bf16"] = torch.from_numpy(rng.integers(-2**15, 2**15, 40, dtype=np.int16)).view(
        torch.bfloat16).reshape(4, 10)
    path = tmp / "dtypes.safetensors"
    safetensors_io.save_file(t, path)
    back = safetensors_io.load_file(path)
    for k, v in t.items():
        got = back[k]
        same = (got.dtype == v.dtype and torch.equal(got.view(torch.int16), v.view(torch.int16))
                if isinstance(v, torch.Tensor) else
                got.dtype == v.dtype and got.shape == v.shape and got.tobytes() == v.tobytes())
        if not same:
            raise SystemExit(f"chip_smoke: safetensors round trip changed {k}")
    saved = convert.MAX_FILE_SIZE_GB
    convert.MAX_FILE_SIZE_GB = 200 / 1024**3  # a shard per tensor or two
    try:
        convert.save_model(tmp / "sharded", t, {"model_type": "none"})
    finally:
        convert.MAX_FILE_SIZE_GB = saved
    shards = sorted(p.name for p in (tmp / "sharded").glob("*.safetensors"))
    back = utils.load_weight_files(tmp / "sharded")
    if len(shards) < 2 or sorted(back) != sorted(t):
        raise SystemExit(f"chip_smoke: sharded checkpoint {shards} read back {sorted(back)}")
    (tmp / "cut.safetensors").write_bytes(path.read_bytes()[:-5])
    try:
        safetensors_io.load_file(tmp / "cut.safetensors")
    except ValueError as e:
        if "cut.safetensors" not in str(e):
            raise
    else:
        raise SystemExit("chip_smoke: a safetensors file cut short was read")
    log(f"[loaded] safetensors: {len(t)} dtypes round-tripped bit for bit, {len(shards)} "
        f"shards read through the index, a cut file rejected")
    return {"dtypes": len(t), "shards": len(shards)}


def loaded_whisper(tmp: Path, smi: str) -> dict:
    """The phase 4 model (bf16) written by `flatten_params` + `save_model`,
    loaded by `utils.load_model`, and run by `stt.generate.
    generate_transcription(model_path=...)` on a 120 s 44.1 kHz stereo PCM-16
    wav: the same tokens as the in-memory model on `utils.load_audio` of the
    file, 32 flash launches, the five writers' files."""
    from mlx_audio_tpu_torch import audio_io, convert, utils
    from mlx_audio_tpu_torch.nn import flatten_params
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.stt import generate as stt_generate
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

    model = Model(ModelDimensions(**TURBO), dtype=torch.bfloat16, seed=0)
    d = tmp / "whisper-large-v3-turbo"
    t0 = time.perf_counter()
    convert.save_model(d, flatten_params(model), dict(TURBO, model_type="whisper"))
    save_s = time.perf_counter() - t0
    nbytes = checkpoint_bytes(d)
    loaded, load_s = timed_load(d)
    same_parameters(loaded, model, "whisper")
    if loaded.decoder.token_embedding.weight.dtype != torch.bfloat16:
        raise SystemExit("chip_smoke: the bf16 Whisper checkpoint did not load in bf16")
    log(f"[loaded] whisper: {nbytes / 1e9:.3f} GB bf16 in {len(list(d.glob('*.safetensors')))} "
        f"shard(s), written in {save_s:.2f} s; load_model {load_s:.2f} s = "
        f"{nbytes / load_s / 1e9:.2f} GB/s; parameters equal the in-memory model's "
        f"({smi})")

    n = int(LOADED_WAV_SR * LOADED_WHISPER_S)
    x = (np.random.default_rng(10).standard_normal((n, 2)) * 0.05).astype(np.float32)
    wav = tmp / "noise120_44k_stereo.wav"
    audio_io.write(wav, x, LOADED_WAV_SR)  # PCM-16
    tok = DummyTokenizer(n_vocab=TURBO["n_vocab"])
    # without timestamps the seeded weights decode sample_len text tokens a
    # window, as in phase 4
    opts = dict(language="en", temperature=0.0, without_timestamps=True, tokenizer=tok)
    audio16 = utils.load_audio(wav, sample_rate=16000)

    def in_memory():
        out = model.generate_chunked(audio16, sample_len=96, **opts)
        torch.cuda.synchronize()
        return out

    def cli(**where):
        out = stt_generate.generate_transcription(
            audio=str(wav), chunked=True, verbose=False, gen_kwargs={"sample_len": 96},
            **where, **opts)
        torch.cuda.synchronize()
        return out

    in_memory()  # warm-up
    t0 = time.perf_counter()
    ref = in_memory()
    mem_s = time.perf_counter() - t0
    out_dir = tmp / "transcripts"
    flash_attention.launches = 0
    t0 = time.perf_counter()
    res = cli(model_path=str(d), output_path=str(out_dir), format="all")
    cli_s = time.perf_counter() - t0
    launches = flash_attention.launches
    t0 = time.perf_counter()
    res2 = cli(model=loaded)
    cli_loaded_s = time.perf_counter() - t0
    want = TURBO["n_audio_layer"]
    if launches != want:
        raise SystemExit(f"chip_smoke: the loaded Whisper launched flash {launches} times, "
                         f"the code says {want} (one per encoder layer, B = 4)")
    tokens = [[s["tokens"] for s in r.segments] for r in (ref, res, res2)]
    if not tokens[0] or tokens[1] != tokens[0] or tokens[2] != tokens[0]:
        raise SystemExit(f"chip_smoke: the loaded Whisper's tokens {tokens[1][:2]} are not "
                         f"the in-memory model's {tokens[0][:2]}")
    sizes = {p.name: p.stat().st_size for p in sorted(out_dir.iterdir())}
    if sorted(sizes) != [f"noise120_44k_stereo.{e}" for e in ("json", "srt", "tsv", "txt",
                                                              "vtt")] or not all(sizes.values()):
        raise SystemExit(f"chip_smoke: the CLI route wrote {sizes}")
    sec = LOADED_WHISPER_S
    log(f"[loaded] whisper: generate_transcription(model_path=..., chunked) on {sec:.0f} s "
        f"at 44.1 kHz stereo: {cli_s:.4f} s with the load = {sec / cli_s:.1f}x real time; "
        f"on the loaded model (read, downmix, resample, transcribe) {cli_loaded_s:.4f} s = "
        f"{sec / cli_loaded_s:.1f}x; the in-memory model on the same 16 kHz waveform "
        f"{mem_s:.4f} s = {sec / mem_s:.1f}x; tokens identical ({len(tokens[0])} windows, "
        f"{sum(len(t) for t in tokens[0])} tokens); flash launches {launches}; writers "
        f"{sizes} bytes ({smi})")
    del model, loaded
    write_tokenizer_json(d, "whisper")  # the directory stays for phase 12
    gc.collect()
    torch.cuda.empty_cache()
    return {"checkpoint_bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "load_gb_per_s": nbytes / load_s / 1e9, "audio_s": sec, "cli_wall_s": cli_s,
            "cli_loaded_wall_s": cli_loaded_s, "in_memory_wall_s": mem_s,
            "flash_launches": launches}


def loaded_qwen3(tmp: Path, smi: str) -> dict:
    """Qwen3-TTS at the published widths in bf16, written unquantized,
    converted to 4 bits by `convert` with `checkpoint_quant_predicate`,
    loaded, and run by `tts.generate.generate_audio(model_path=...)`: the
    codes of the in-memory model quantized with the loader's predicate and
    row-stacked, the wav equal to the model's int16 samples, and the
    quantized kernels' launches equal to the routing table's."""
    from mlx_audio_tpu_torch import audio_io, convert
    from mlx_audio_tpu_torch.nn import Linear, flatten_params
    from mlx_audio_tpu_torch.nn.quantized import fuse_quantized_projections, quantize_module
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.tts import generate as tts_generate
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import (Model, ModelConfig,
                                                         checkpoint_quant_predicate)

    model = Model(ModelConfig.from_dict({}), dtype=torch.bfloat16, seed=0)
    src, q4 = tmp / "qwen3-tts-0.6b", tmp / "qwen3-tts-0.6b-4bit"
    t0 = time.perf_counter()
    convert.save_model(src, flatten_params(model), {"model_type": "qwen3_tts"})
    save_s = time.perf_counter() - t0
    src_bytes = checkpoint_bytes(src)
    t0 = time.perf_counter()
    convert.convert(str(src), str(q4), quantize=True, q_bits=4, q_group_size=GROUP,
                    q_recipe=checkpoint_quant_predicate)
    convert_s = time.perf_counter() - t0
    shutil.rmtree(src)
    nbytes = checkpoint_bytes(q4)
    quantize_module(model, bits=4, group_size=GROUP,
                    predicate=lambda p, m: isinstance(m, Linear) and Model.model_quant_predicate(p))
    fuse_quantized_projections(model)
    model.set_runtime(tokenizer=AsciiTok())  # the class's: the loaded models' too
    loaded, load_s = timed_load(q4)
    same_parameters(loaded, model, "qwen3 int4")
    log(f"[loaded] qwen3: {src_bytes / 1e9:.3f} GB bf16 written in {save_s:.2f} s, converted "
        f"to 4 bits in {convert_s:.2f} s ({nbytes / 1e9:.3f} GB); load_model {load_s:.2f} s = "
        f"{nbytes / load_s / 1e9:.2f} GB/s; parameters equal the in-memory model's, "
        f"quantized with the loader's predicate and row-stacked ({smi})")

    frames = LOADED_QWEN_FRAMES
    predicted = predicted_launches(loaded, 4, frames, layers_only=True)
    seen = []
    decode = Model._decode_codes

    def spy(self, codes):
        seen.append(np.array(codes))
        return decode(self, codes)

    kw = dict(max_tokens=frames, min_tokens=frames, temperature=0.9, top_k=50, seed=0,
              verbose=False)
    Model._decode_codes = spy
    try:
        t0 = time.perf_counter()
        mem = tts_generate.generate_audio(QWEN_TEXT, model=model, output_path=str(tmp / "q_mem"),
                                          **kw)
        mem_s = time.perf_counter() - t0
        qk.reset_launches()
        t0 = time.perf_counter()
        res = tts_generate.generate_audio(QWEN_TEXT, model_path=str(q4),
                                          output_path=str(tmp / "q_cli"), **kw)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        got = quant_counts(4)
    finally:
        Model._decode_codes = decode
    log(f"[loaded] qwen3: launches {got}, routing table {predicted}")
    for k, want in predicted.items():
        if got[k] != want:
            raise SystemExit(f"chip_smoke: the loaded int4 Qwen3-TTS launched {k} {got[k]} "
                             f"times, the routing table says {want}")
    for k in ("qmm_gemv", "qmm_mma", "qmlp"):
        if got[k] <= 0:
            raise SystemExit(f"chip_smoke: the loaded int4 Qwen3-TTS launched no {k}")
    G = model.config.talker_config.num_code_groups
    if len(seen) != 2 or seen[0].shape != (frames, G) or not np.array_equal(seen[0], seen[1]):
        raise SystemExit(f"chip_smoke: the loaded int4 Qwen3-TTS's codes are not the "
                         f"in-memory model's ({[c.shape for c in seen]})")
    pcm = np.clip(np.round(np.asarray(res[0].audio) * 32768.0), -32768, 32767).astype(np.int16)
    wav, sr = audio_io.read(tmp / "q_cli" / "audio_000.wav", dtype="int16")
    wav_mem, _ = audio_io.read(tmp / "q_mem" / "audio_000.wav", dtype="int16")
    if len(res) != 1 or sr != model.sample_rate or not np.array_equal(wav, pcm) \
            or not np.array_equal(wav, wav_mem):
        raise SystemExit("chip_smoke: the loaded int4 Qwen3-TTS's wav is not the model's "
                         "int16 samples or not the in-memory model's")
    audio_s = pcm.shape[0] / sr
    log(f"[loaded] qwen3: generate_audio(model_path=..., {frames} frames): {cli_s:.4f} s with "
        f"the load; the in-memory model through generate_audio(model=...) {mem_s:.4f} s (its "
        f"first run); {audio_s:.2f} s of audio; codes identical, wav = the model's int16 "
        f"samples = the in-memory model's ({smi})")
    del model, loaded
    write_tokenizer_json(q4, "qwen2")  # the directory stays for phase 12
    gc.collect()
    torch.cuda.empty_cache()
    return {"source_bytes": src_bytes, "checkpoint_bytes": nbytes, "save_s": save_s,
            "convert_s": convert_s, "load_s": load_s, "load_gb_per_s": nbytes / load_s / 1e9,
            "frames": frames, "cli_wall_s": cli_s, "in_memory_wall_s": mem_s,
            "launches": {k: got[k] for k in ("qmm", "qmlp", "qmm_gemv", "qmm_mma",
                                             "qmm_kernel")},
            "predicted": predicted}


def loaded_kokoro(tmp: Path, smi: str) -> dict:
    """Kokoro-82M (bf16) written in the upstream torch layout (weight norm as
    weight_g / weight_v, nn.LSTM names) with a seeded voices/ pack, loaded
    in bf16 and run by `tts.generate.generate_audio(model_path=...)`: its
    wav within one int16 step of the in-memory model's."""
    from mlx_audio_tpu_torch import audio_io, convert, safetensors_io
    from mlx_audio_tpu_torch.tts import generate as tts_generate
    from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import torch_checkpoint

    model = kokoro_model("cuda", torch.bfloat16)
    vocab = {c: i + 1 for i, c in enumerate(dict.fromkeys(KOKORO_VOCAB_CHARS))}
    d = tmp / "kokoro-82m"
    t0 = time.perf_counter()
    convert.save_model(d, torch_checkpoint(model),
                       {**KOKORO_82M_CONFIG, "vocab": vocab, "model_type": "kokoro"})
    save_s = time.perf_counter() - t0
    (d / "voices").mkdir()
    pack = (np.random.default_rng(5).standard_normal((510, 1, 2 * model.config.style_dim))
            * 0.1).astype(np.float32)
    safetensors_io.save_file({"voice": pack}, d / "voices" / "af_smoke.safetensors")
    nbytes = checkpoint_bytes(d)
    loaded, load_s = timed_load(d, dtype=torch.bfloat16)
    same_parameters(loaded, model, "kokoro")
    del loaded
    model.repo_id = str(d)
    before = port_kernel_launches()
    t0 = time.perf_counter()
    mem = tts_generate.generate_audio(LOADED_KOKORO_TEXT, model=model, voice="af_smoke",
                                      output_path=str(tmp / "k_mem"), verbose=False)
    mem_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = tts_generate.generate_audio(LOADED_KOKORO_TEXT, model_path=str(d), voice="af_smoke",
                                      dtype=torch.bfloat16, output_path=str(tmp / "k_cli"),
                                      verbose=False)
    cli_s = time.perf_counter() - t0
    after = port_kernel_launches()
    a, sr = audio_io.read(tmp / "k_cli" / "audio_000.wav", dtype="int16")
    b, _ = audio_io.read(tmp / "k_mem" / "audio_000.wav", dtype="int16")
    steps = int(np.abs(a.astype(np.int32) - b).max()) if a.shape == b.shape else None
    if len(res) != 1 or len(mem) != 1 or steps is None or steps > 1 or a.size == 0:
        raise SystemExit(f"chip_smoke: the loaded Kokoro's wav {a.shape} is not within one "
                         f"int16 step of the in-memory model's {b.shape} ({steps})")
    log(f"[loaded] kokoro: {nbytes / 1e6:.1f} MB float32 in the torch layout written in "
        f"{save_s:.2f} s; load_model(dtype=bf16) {load_s:.2f} s = {nbytes / load_s / 1e9:.2f} "
        f"GB/s, parameters equal the in-memory bf16 model's; generate_audio(model_path=..., "
        f"voice=af_smoke) {cli_s:.4f} s with the load, the in-memory model {mem_s:.4f} s; "
        f"{a.shape[0] / sr:.2f} s of audio, max |d| {steps} int16 step(s); the port's kernels "
        f"launched { {k: after[k] - before[k] for k in after} } (none is on this path) ({smi})")
    del model  # the directory stays for phase 12
    torch.cuda.empty_cache()
    return {"checkpoint_bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "load_gb_per_s": nbytes / load_s / 1e9, "cli_wall_s": cli_s,
            "in_memory_wall_s": mem_s, "max_int16_steps": steps}


def phase_loaded(smi: str, tmp: Path) -> dict:
    """Phase 10: every checkpoint in `tmp` (a temporary directory that main
    removes after phase 12, which serves the Whisper, int4 Qwen3-TTS and
    Kokoro directories, each with the tokenizer.json it needs)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = {"safetensors": loaded_safetensors(tmp), "whisper": loaded_whisper(tmp, smi),
           "qwen3_int4": loaded_qwen3(tmp, smi), "kokoro": loaded_kokoro(tmp, smi)}
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[loaded] phase 10 wall {rec['wall_s']:.1f} s")
    return rec


# Phase 11: serving, on the models of phases 5, 7, 8 and 9 (the phase 4
# Whisper), at bench.py's serving shapes, cut in depth: 1 trial where
# bench.py takes 3 (2 until phase 13 came), Qwen3-TTS bf16 streams of 8 frames
# (16 until phase 13 came) where it decodes 64
SERVE_STREAMS, SERVE_TRIALS = 8, 1
SERVE_WHISPER_S = 30.0
SERVE_QWEN_FRAMES, SERVE_QWEN_TICK, SERVE_QWEN_MAX_LEN = 8, 8, 1024  # 16 until phase 13
SERVE_INT4_FRAMES = 16
SERVE_KOKORO_REQUESTS = 4
SERVE_KOKORO_TEXT = "The quick brown fox jumps over the lazy dog."
# Kokoro batched against sequential: in float32 within one int16 step (the
# same float32 operations at another batch width); in bf16 the batched
# GEMMs, convolutions and LSTM round each bf16 activation in other places
# (on the CPU at full width, 40 phonemes: 365-377 int16 steps apart,
# correlation 0.99994; in float32 one step), so the bf16 rows are held to
# the JAX package's own bar for batched Kokoro (tests/test_serving.py).
KOKORO_SERVE_BF16_CORR = 0.999
SERVE_TIMEOUT = 600
# Tokens of the batched and the sequential Whisper path may part only where
# the two bf16 runs round in other places: the batched encoder's GEMMs tile
# 8 x 1500 rows where the sequential tile 1500, and each bf16 activation may
# round the other way, which a 32-layer encoder carries into the logits as
# a few bf16 ulps. The bar: the two chosen tokens' logits within this many
# bf16 ulps at their magnitude.
SERVE_TIE_ULPS = 4
# Qwen3-TTS int4 greedy, the batcher (tensor-core GEMM at M = 8) against
# `_run_codes` (the GEMV at M = 1): float32 residual stream and logits,
# sums in other orders; codes may part only where the reference's two
# candidates lie within this share of its largest |logit|.
SERVE_QWEN_TIE_REL = 1e-4


def serve_texts():
    """bench_qwen3_serving's eight texts."""
    return [f"Concurrent stream number {i}: the quick brown fox jumps over the lazy dog "
            "while the synthesis model turns text into speech." for i in range(SERVE_STREAMS)]


def results_in_time(futs) -> list:
    return [f.result(timeout=SERVE_TIMEOUT) for f in futs]


def concurrently(fn, args) -> list:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(args)) as ex:
        return results_in_time([ex.submit(fn, a) for a in args])


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def serve_whisper(model) -> dict:
    """bench_whisper_serving on the phase 4 model in bf16: 8 streams of 30 s
    seeded noise through `generate` (the seek loop), sequential once, then
    through `make_batcher(max_batch=8, window_ms=50)`: the batch buckets
    warmed, a warm concurrent wave, the median of SERVE_TRIALS concurrent
    trials. Each trial's flash launches held to 32 per batched encode (one per encoder
    layer per dispatch); each stream's tokens to its sequential tokens, or
    a near-tie where they part (SERVE_TIE_ULPS)."""
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.stt.models.whisper.decoding import DecodingOptions
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

    tok = DummyTokenizer(n_vocab=TURBO["n_vocab"])
    rng = np.random.default_rng(2)  # bench.py's
    audios = [(rng.standard_normal(int(16000 * SERVE_WHISPER_S)) * 0.05).astype(np.float32)
              for _ in range(SERVE_STREAMS)]
    kw = dict(language="en", temperature=0.0, tokenizer=tok, condition_on_previous_text=False,
              no_speech_threshold=None, without_timestamps=True, sample_len=96)

    def transcribe(a):
        return model.generate(a, **kw)  # tokens reach the host: synchronised

    def tokens(out):
        return [s["tokens"] for s in out.segments]

    transcribe(audios[0])
    t0 = time.perf_counter()
    seq = [transcribe(a) for a in audios]
    seq_wall = time.perf_counter() - t0
    L = TURBO["n_audio_layer"]
    batcher = model.make_batcher(max_batch=SERVE_STREAMS, window_ms=50.0).install()
    try:
        opts = DecodingOptions(task="transcribe", language="en", temperature=0.0,
                               without_timestamps=True, sample_len=96)
        t0 = time.perf_counter()
        batcher.warmup(torch.zeros(3000, TURBO["n_mels"], device=model.device),
                       list(tok.sot_sequence_including_notimestamps), opts, tok)
        warm_s = time.perf_counter() - t0
        concurrently(transcribe, audios)
        walls, dispatches, launches = [], [], []
        for _ in range(SERVE_TRIALS):
            d0 = batcher.dispatch_count
            flash_attention.launches = 0
            t0 = time.perf_counter()
            outs = concurrently(transcribe, audios)
            walls.append(time.perf_counter() - t0)
            launches.append(flash_attention.launches)
            dispatches.append(batcher.dispatch_count - d0)
            if launches[-1] != L * dispatches[-1]:
                raise SystemExit(f"chip_smoke: a serving trial launched flash {launches[-1]} "
                                 f"times over {dispatches[-1]} dispatches, the code says "
                                 f"{L} per batched encode")
            parted = check_served_tokens(model, audios, seq, outs, tok, opts)
        profile_one_run(lambda: concurrently(transcribe, audios),
                        f"one concurrent wave of {SERVE_STREAMS} x {SERVE_WHISPER_S:g} s")
        profiled = profile_one_run.last
    finally:
        batcher.close()
    sampled = sampled_decode_cost(model, audios, tok)
    med = statistics.median(walls)
    total = SERVE_WHISPER_S * SERVE_STREAMS
    if any(len(t) != 1 or len(t[0]) != 96 for t in map(tokens, seq)):
        raise SystemExit(f"chip_smoke: served Whisper windows {[tokens(o) for o in seq][:1]}")
    log(f"[serving] whisper: {SERVE_STREAMS} x {SERVE_WHISPER_S:g} s, bf16, window 50 ms: "
        f"sequential {seq_wall:.4f} s ({total / seq_wall:.1f}x real time); batched walls "
        f"{', '.join(f'{w:.4f}' for w in walls)} s, median {med:.4f} s = {total / med:.1f}x "
        f"aggregate real time, {seq_wall / med:.2f}x sequential; dispatches per trial "
        f"{dispatches}, flash launches per trial {launches} ({L} per batched encode); bucket "
        f"warm-up {warm_s:.2f} s; streams whose tokens part from sequential: {parted}")
    return {"streams": SERVE_STREAMS, "audio_s": total, "sequential_wall_s": seq_wall,
            "walls_s": walls, "aggregate_xrt": total / med, "speedup": seq_wall / med,
            "dispatches": dispatches, "flash_launches": launches, "warmup_s": warm_s,
            "parted": parted, "profiled": profiled, "sampled_decode": sampled}


def sampled_decode_cost(model, audios, tok, steps=96) -> dict:
    """The batched sampled decode the server's fallback runs (8 windows,
    t = 0.4, up to `steps` steps): its wall, and its Gumbel noise timed
    alone two ways for the same steps: one (8, V) draw a step from one
    generator, as the decode drew before its rows had generators of their
    own, and `uniform_noise`'s (NOISE_STEPS, V) draw a row every NOISE_STEPS
    steps (8 launches every 16 steps where the other makes one a step)."""
    from mlx_audio_tpu_torch.stt.models.whisper import Model
    from mlx_audio_tpu_torch.stt.models.whisper import decoding as dec

    V, dev, B = model.dims.n_vocab, model.device, len(audios)
    opts = dec.DecodingOptions(task="transcribe", language="en", temperature=0.4,
                               without_timestamps=True, sample_len=steps)
    prompts = [list(tok.sot_sequence_including_notimestamps)] * B

    def wall(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.inference_mode():
        _, kv = model._encode(torch.cat([model._mel_chunks_device(a)[0][:1] for a in audios]))
        res = []
        decode_s = wall(lambda: res.append(dec.decode_window_batch(
            model, kv, tok, prompts, opts, n_ctx=model.dims.n_text_ctx, n_vocab=V,
            decoder_step=Model._decoder_step, make_caches=model._make_caches)))
        shared = torch.Generator(device=dev).manual_seed(0)
        gens = [torch.Generator(device=dev).manual_seed(j) for j in range(B)]
        one_s = wall(lambda: [torch.rand((B, V), generator=shared, device=dev)
                              for _ in range(steps)])
        rows_s = wall(lambda: [dec.uniform_noise(gens, V, dev)
                               for _ in range(0, steps, dec.NOISE_STEPS)])
    n = max(len(r.tokens) for r in res[-1])
    log(f"[serving] whisper sampled decode, {B} windows at t = 0.4: {decode_s:.4f} s for up "
        f"to {steps} steps (longest row {n} tokens); the noise alone for {steps} steps: one "
        f"({B}, V) draw a step {one_s * 1e3:.3f} ms, a ({dec.NOISE_STEPS}, V) draw a row every "
        f"{dec.NOISE_STEPS} steps {rows_s * 1e3:.3f} ms")
    return {"windows": B, "steps": steps, "longest_row": n, "decode_s": decode_s,
            "noise_one_draw_a_step_ms": one_s * 1e3, "noise_draw_a_row_ms": rows_s * 1e3}


def check_served_tokens(model, audios, seq, outs, tok, opts) -> list:
    """Each stream's batched tokens against its sequential tokens; where
    they part, a near-tie (`parting_gap`). Returns [(stream, step, gap,
    bar)]."""
    parted = []
    prompt = list(tok.sot_sequence_including_notimestamps)
    for i, (s, o) in enumerate(zip(seq, outs)):
        a, b = o.segments[0]["tokens"], s.segments[0]["tokens"]
        if a != b:
            mel, _ = model._mel_chunks_device(audios[i])
            j, _, gap, bar = parting_gap(model, mel[0], prompt, opts, tok, a, b,
                                         f"[serving] whisper stream {i}")
            parted.append((i, j, gap, bar))
    return parted


def serve_qwen_bf16(model) -> dict:
    """bench_qwen3_serving's shape on the unquantized bf16 model, cut in
    depth: 8 sampled streams x SERVE_QWEN_FRAMES (8; bench.py decodes 64),
    slots 8, max_len 1024, tick_frames 8; a warm wave, the 8 requests one
    live slot at a time on the same engine, then the median of SERVE_TRIALS
    (2; bench.py takes 3) concurrent trials. Each request's codes in every
    trial equal its one-slot codes (a request's draws depend only on its
    seed)."""
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    preps = [model._prepare_generation_inputs(t)[:2] for t in serve_texts()]
    samp = dict(max_tokens=SERVE_QWEN_FRAMES, min_tokens=SERVE_QWEN_FRAMES, temperature=0.9,
                top_k=50, top_p=1.0, repetition_penalty=1.05)
    qk.reset_launches()
    batcher = model.make_batcher(slots=SERVE_STREAMS, max_len=SERVE_QWEN_MAX_LEN,
                                 tick_frames=SERVE_QWEN_TICK)
    try:
        warm = {**samp, "max_tokens": SERVE_QWEN_TICK, "min_tokens": SERVE_QWEN_TICK}
        t0 = time.perf_counter()
        results_in_time([batcher.submit(e, t, seed=0, **warm) for e, t in preps])
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = [batcher.submit(e, t, seed=i, **samp).result(timeout=SERVE_TIMEOUT)
                 for i, (e, t) in enumerate(preps)]
        seq_wall = time.perf_counter() - t0
        walls, ticks = [], []
        for _ in range(SERVE_TRIALS):
            d0 = batcher.dispatch_count
            t0 = time.perf_counter()
            frames = results_in_time([batcher.submit(e, t, seed=i, **samp)
                                      for i, (e, t) in enumerate(preps)])
            walls.append(time.perf_counter() - t0)
            ticks.append(batcher.dispatch_count - d0)
            check_served_codes(frames, alone, "qwen3 bf16")
        profile_one_run(lambda: results_in_time([batcher.submit(e, t, seed=i, **warm)
                                                 for i, (e, t) in enumerate(preps)]),
                        f"one tick of {SERVE_STREAMS} slots x {SERVE_QWEN_TICK} frames")
        profiled = profile_one_run.last
    finally:
        batcher.close()
    quant = quant_counts(4)
    if any(quant.values()):
        raise SystemExit(f"chip_smoke: the unquantized model launched quantized kernels {quant}")
    total = sum(f.shape[0] for f in frames)
    med = statistics.median(walls)
    log(f"[serving] qwen3 bf16: {SERVE_STREAMS} sampled streams x {SERVE_QWEN_FRAMES} frames, "
        f"slots {SERVE_STREAMS}, tick {SERVE_QWEN_TICK}: warm wave {warm_s:.2f} s; one live slot "
        f"at a time {seq_wall:.4f} s; concurrent walls {', '.join(f'{w:.4f}' for w in walls)} s, "
        f"median {med:.4f} s = {seq_wall / med:.2f}x sequential, {total / med:.1f} aggregate "
        f"frames/s ({total / 12.5 / med:.2f}x real time); ticks per trial {ticks}; every "
        f"request's codes equal its one-slot codes")
    return {"streams": SERVE_STREAMS, "frames": total, "sequential_wall_s": seq_wall,
            "walls_s": walls, "speedup": seq_wall / med, "frames_per_s": total / med,
            "ticks": ticks, "warmup_s": warm_s, "profiled": profiled}


def check_served_codes(got, want, label) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise SystemExit(f"chip_smoke: {label} request {i}: served codes {g.shape} differ "
                             f"from its one-slot codes {w.shape}")


def serve_qwen_int4(model) -> dict:
    """The int4 model of phase 5 through the same batcher: 8 sampled streams
    x 16 frames, every quantized launch held to the routing table at the
    pool's shapes (`predicted_serving_launches`); each request's codes equal
    its one-slot codes; a greedy request's codes (one live slot) equal
    `_run_codes`' greedy codes, or part at a near-tie (SERVE_QWEN_TIE_REL)."""
    from mlx_audio_tpu_torch.lm.continuous import _bucket
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import batcher as batcher_mod

    preps = [model._prepare_generation_inputs(t)[:2] for t in serve_texts()]
    T = preps[0][0].shape[1]
    samp = dict(max_tokens=SERVE_INT4_FRAMES, min_tokens=SERVE_INT4_FRAMES, temperature=0.9,
                top_k=50, top_p=1.0, repetition_penalty=1.05)
    batcher = model.make_batcher(slots=SERVE_STREAMS, max_len=SERVE_QWEN_MAX_LEN,
                                 tick_frames=SERVE_QWEN_TICK)
    try:
        results_in_time([batcher.submit(e, t, seed=0, **samp) for e, t in preps])  # warm
        qk.reset_launches()
        d0 = batcher.dispatch_count
        t0 = time.perf_counter()
        codes = results_in_time([batcher.submit(e, t, seed=i, **samp)
                                 for i, (e, t) in enumerate(preps)])
        wall = time.perf_counter() - t0
        ticks = batcher.dispatch_count - d0
        got = quant_counts(4)
        predicted = predicted_serving_launches(model, 4, [_bucket(T)] * SERVE_STREAMS,
                                               ticks * SERVE_QWEN_TICK, SERVE_STREAMS)
        log(f"[serving] qwen3 int4: {SERVE_STREAMS} x {SERVE_INT4_FRAMES} frames in {ticks} "
            f"ticks, wall {wall:.4f} s; launches {got}, routing table {predicted} (prefill "
            f"at M = {_bucket(T)}, ticks at M = {SERVE_STREAMS})")
        for k, want in predicted.items():
            if got[k] != want:
                raise SystemExit(f"chip_smoke: served int4 Qwen3-TTS launched {k} {got[k]} "
                                 f"times, the routing table says {want}")
        for k in ("qmm_mma", "qmlp"):
            if got[k] <= 0:
                raise SystemExit(f"chip_smoke: served int4 Qwen3-TTS launched no {k}")
        alone = [batcher.submit(e, t, seed=i, **samp).result(timeout=SERVE_TIMEOUT)
                 for i, (e, t) in enumerate(preps)]
        check_served_codes(codes, alone, "qwen3 int4")
        greedy = dict(samp, temperature=0.0, top_k=0, repetition_penalty=1.0)
        served_lg = []
        sample_rows = batcher_mod._sample_rows_core

        def spy(logits, *a, **kw):
            served_lg.append(logits[0].float().clone())  # the one live slot's row
            return sample_rows(logits, *a, **kw)

        batcher_mod._sample_rows_core = spy
        try:
            served = batcher.submit(*preps[0], seed=0, **greedy).result(timeout=SERVE_TIMEOUT)
        finally:
            batcher_mod._sample_rows_core = sample_rows
    finally:
        batcher.close()
    parted = check_greedy_codes(model, serve_texts()[0], served, served_lg, greedy)
    log(f"[serving] qwen3 int4: every request's codes equal its one-slot codes; a greedy "
        f"request through the batcher against _run_codes: "
        f"{'identical' if parted is None else parted}")
    return {"streams": SERVE_STREAMS, "frames": sum(c.shape[0] for c in codes), "wall_s": wall,
            "ticks": ticks, "launches": got, "predicted": predicted, "greedy_parted": parted}


def check_greedy_codes(model, text, served, served_lg, greedy):
    """The batcher's greedy codes against `_run_codes`' (one request, B = 1),
    draw by draw (c0, then the 15 codebooks, a frame at a time). Where they
    part, `_run_codes`' logits must put the two choices within
    SERVE_QWEN_TIE_REL of their largest |logit|."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import qwen3_tts

    ref_lg = []
    sample = qwen3_tts._sample

    def spy(logits, *a, **kw):
        ref_lg.append(logits[0].float().clone())
        return sample(logits, *a, **kw)

    qwen3_tts._sample = spy
    try:
        emb, tr, pad = model._prepare_generation_inputs(text)
        ref = np.concatenate(list(model._run_codes(
            emb, tr, pad, chunk_tokens=greedy["max_tokens"], seed=0, **greedy)))
    finally:
        qwen3_tts._sample = sample
    if ref.shape != served.shape:
        raise SystemExit(f"chip_smoke: greedy codes {served.shape} vs _run_codes {ref.shape}")
    if np.array_equal(ref, served):
        return None
    a, b = served.reshape(-1), ref.reshape(-1)
    k = int(np.nonzero(a != b)[0][0])
    lg = ref_lg[k]
    gap = abs(lg[int(a[k])] - lg[int(b[k])]).item()
    bar = SERVE_QWEN_TIE_REL * lg.abs().max().item()
    log(f"[serving] qwen3 int4 greedy: the batcher and _run_codes part at draw {k} (frame "
        f"{k // ref.shape[1]}, codebook {k % ref.shape[1]}): batcher {int(a[k])}, _run_codes "
        f"{int(b[k])}, gap {gap:.3e} (bar {bar:.3e}); the batcher's own logits there give "
        f"{(served_lg[k][int(a[k])] - served_lg[k][int(b[k])]).item():.3e}")
    if not gap <= bar:
        raise SystemExit(f"chip_smoke: greedy codes part from _run_codes at draw {k} with a "
                         f"gap of {gap}, not a near-tie")
    return {"draw": k, "gap": gap, "bar": bar}


def serve_moss(model) -> dict:
    """Phase 7's 90 s request chunked through `make_batcher` (max_batch 8):
    its own 4 s chunks fuse; ReLU² launches held to one per FLASH layer per
    batched dispatch; the output within MOSS_CARD_VS_CPU_REL of the peak of
    the unbatched route's. Median of 3 after a warm-up, beside the
    unbatched route's in the same call."""
    from mlx_audio_tpu_torch.ops.cuda.relu2_attention import relu2_attention

    cfg = model.config
    sec = MOSS_REQUESTS[2][0]
    audio = (np.random.default_rng(12).standard_normal(int(sec * cfg.sample_rate))
             * 0.05).astype(np.float32)  # phase 7's 90 s request

    def timed(n):
        walls, out = [], None
        for _ in range(n):
            t0 = time.perf_counter()
            out = model.enhance(audio)  # numpy: synchronised
            walls.append(time.perf_counter() - t0)
        return out, walls

    ref, plain = timed(SERVE_TRIALS)
    batcher = model.make_batcher(max_batch=SERVE_STREAMS).install()
    try:
        warm, _ = timed(1)
        relu2_attention.launches = 0
        d0 = batcher.dispatch_count
        out, walls = timed(1)
        launches, dispatches = relu2_attention.launches, batcher.dispatch_count - d0
        more, walls2 = timed(SERVE_TRIALS - 1)
        walls += walls2
        profile_one_run(lambda: timed(1), f"one {sec:g} s chunked enhancement, batched")
        profiled = profile_one_run.last
    finally:
        batcher.close()
    err, peak = np.abs(out - ref).max(), np.abs(ref).max()
    med, pmed = statistics.median(walls), statistics.median(plain)
    log(f"[serving] mossformer2-se: {sec:g} s chunked through the batcher: {dispatches} batched "
        f"dispatches, relu2 launches {launches} (predicted {cfg.num_blocks} a dispatch); walls "
        f"{', '.join(f'{w:.4f}' for w in walls)} s, median {med:.4f} s = {sec / med:.1f}x real "
        f"time; unbatched in this call {pmed:.4f} s ({pmed / med:.2f}x slower); output max|d| "
        f"{err:.3e} against the unbatched route, max|ref| {peak:.3e} (bar "
        f"{MOSS_CARD_VS_CPU_REL:g} of max|ref|)")
    if launches != cfg.num_blocks * dispatches:
        raise SystemExit(f"chip_smoke: served MossFormer2-SE launched relu2 {launches} times "
                         f"over {dispatches} dispatches")
    if not err <= MOSS_CARD_VS_CPU_REL * peak or not all(
            np.array_equal(out, o) for o in (warm, more) if o is not None):
        raise SystemExit(f"chip_smoke: served MossFormer2-SE output max|d| {err}, or repeated "
                         f"runs disagree")
    return {"audio_s": sec, "dispatches": dispatches, "relu2_launches": launches,
            "walls_s": walls, "xrt": sec / med, "unbatched_walls_s": plain,
            "max_abs_err": float(err), "profiled": profiled}


def serve_kokoro(model, label, bar) -> dict:
    """4 concurrent `generate` calls (one text, four seeded voice packs)
    through `make_batcher`, against the same calls one after another: the
    rows share a frame bucket, so each draws its sequential noise; each
    request's audio held to its sequential audio by `bar` ("int16": within
    one int16 step; else a least correlation); the dispatch count."""
    import tempfile

    from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import FRAME_BUCKETS, _bucket

    n = SERVE_KOKORO_REQUESTS
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "voices").mkdir()
        for i in range(n):
            pack = (np.random.default_rng(40 + i).standard_normal(
                (510, 1, 2 * model.config.style_dim)) * 0.1).astype(np.float32)
            np.savez(Path(d) / "voices" / f"af_serve{i}.npz", voice=pack)
        model.repo_id, model._pipelines = d, {}

        def run(i):
            res = list(model.generate(SERVE_KOKORO_TEXT, voice=f"af_serve{i}"))
            if len(res) != 1:
                raise SystemExit(f"chip_smoke: Kokoro generate gave {len(res)} segments")
            return res[0]

        seq = [run(i) for i in range(n)]
        t0 = time.perf_counter()
        seq = [run(i) for i in range(n)]
        seq_wall = time.perf_counter() - t0
        batcher = model.make_batcher(max_batch=n, window_ms=100.0).install()
        try:
            concurrently(run, list(range(n)))  # warm
            d0 = batcher.dispatch_count
            t0 = time.perf_counter()
            outs = concurrently(run, list(range(n)))
            wall = time.perf_counter() - t0
            dispatches = batcher.dispatch_count - d0
        finally:
            batcher.close()
        model.repo_id, model._pipelines = None, {}
    spf = 2 * model.decoder.generator.total_upsample
    buckets = [_bucket(r.samples // spf, FRAME_BUCKETS) for r in seq]
    if [o.samples for o in outs] != [r.samples for r in seq] or len(set(buckets)) != 1:
        raise SystemExit(f"chip_smoke: Kokoro {label}: served lengths {[o.samples for o in outs]} "
                         f"against {[r.samples for r in seq]}, frame buckets {buckets}")
    steps = [int(np.abs(np.round(o.audio * 32767.0) - np.round(s.audio * 32767.0)).max())
             for o, s in zip(outs, seq)]
    corr = [float(np.corrcoef(o.audio, s.audio)[0, 1]) for o, s in zip(outs, seq)]
    log(f"[serving] kokoro {label}: {n} concurrent generate calls ({SERVE_KOKORO_TEXT!r}, "
        f"voices af_serve0-{n - 1}): {dispatches} dispatch(es), wall {wall:.4f} s against "
        f"{seq_wall:.4f} s one after another ({seq_wall / wall:.2f}x); frame buckets {buckets}; "
        f"from each sequential call: int16 steps {steps}, correlation "
        f"{', '.join(f'{c:.6f}' for c in corr)} (bar: "
        f"{'one int16 step' if bar == 'int16' else f'correlation >= {bar}'})")
    if (max(steps) > 1) if bar == "int16" else (min(corr) < bar):
        raise SystemExit(f"chip_smoke: served Kokoro {label} audio over its bar: steps {steps}, "
                         f"correlation {corr}")
    return {"requests": n, "dispatches": dispatches, "wall_s": wall,
            "sequential_wall_s": seq_wall, "max_int16_steps": max(steps),
            "min_corr": min(corr)}


def phase_serving(keep) -> dict:
    """Phase 11: the serving batchers on the models of phases 5, 7, 8 and 9
    (built here from the same seeds when those phases did not run)."""
    gc.collect()
    torch.cuda.empty_cache()
    if "whisper" not in keep:
        from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

        keep["whisper"] = Model(ModelDimensions(**TURBO), dtype=torch.bfloat16, seed=0)
    if "qwen3_bf16" not in keep:
        keep["qwen3_bf16"] = qwen_model(None)
    if "qwen3_int4" not in keep:
        keep["qwen3_int4"] = qwen_model(4)
    if "mossformer2_se" not in keep:
        from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model

        keep["mossformer2_se"] = Model(device="cuda", seed=0)
        fill_depthwise(keep["mossformer2_se"], 1)
    if "kokoro" not in keep:
        keep["kokoro"] = kokoro_model("cuda", torch.bfloat16)
    if "kokoro_f32" not in keep:
        keep["kokoro_f32"] = kokoro_model("cuda", seed=1)
    t0 = time.perf_counter()
    rec = {"whisper": serve_whisper(keep["whisper"]),
           "qwen3_bf16": serve_qwen_bf16(keep["qwen3_bf16"]),
           "qwen3_int4": serve_qwen_int4(keep["qwen3_int4"]),
           "mossformer2_se": serve_moss(keep["mossformer2_se"]),
           "kokoro_f32": serve_kokoro(keep["kokoro_f32"], "f32", "int16"),
           "kokoro_bf16": serve_kokoro(keep["kokoro"], "bf16", KOKORO_SERVE_BF16_CORR)}
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[serving] phase 11 wall {rec['wall_s']:.1f} s")
    return rec


# Phase 12: serving over HTTP and WebSocket (`server.py`, stdlib transport)
# on the checkpoint directories phase 10 wrote, each with its tokenizer.json
# cut in depth to make room for phase 15: a 15 s upload (one window, 30 s
# and two windows until then) and 4 concurrent uploads (8 until then); 2
# since phase 17 (each in-memory reference decodes its window at all six
# fallback temperatures, ~8 s)
HTTP_WHISPER_S, HTTP_STREAMS = 15.0, 2
# the concurrent uploads: one window each, each its own seed, level and
# length
HTTP_CONC_S = tuple(8.0 + 0.5 * i for i in range(HTTP_STREAMS))
# the int4 Whisper's upload: one 30 s window (a 30 s upload can take two);
# seeded weights decode every window at all six fallback temperatures
HTTP_INT4_S = 20.0
HTTP_TEXT = "The quick brown fox jumps over the lazy dog."
# the wave of four speech requests (phase 12's, and phase 13's batcher's
# prompts): each its own text, of words the generated tokenizer.json merges
# (12-13 ids each, so each decode is capped at 128 frames as HTTP_TEXT's is;
# a text of 22 ids or more doubles it)
HTTP_TEXTS = (HTTP_TEXT, "The lazy dog jumps over the quick brown fox.",
              "Hello world, the model turns text into speech.",
              "The model turns text into speech while the dog jumps.")
# the int4 Qwen3-TTS directory is served as a CustomVoice checkpoint (one
# seeded speaker): its decode is capped by the text's length (128 frames
# here), where the Base route runs to EOS or 4096 frames, which seeded
# weights may never draw
QWEN_SPEAKER, QWEN_SPEAKER_ID = "smoke", 3000
# the speech route has no frame cap: the served model's cap by the text's
# length (128 frames here) is set to this, for the request alone, the wave
# and the one-slot references alike (cut in depth to make room for phases
# 16, 18 and 19: 16 frames are one tick of the batcher's 16, 24 until phase
# 19 came)
HTTP_QWEN_FRAMES = 16
HTTP_STREAM_INTERVAL = 0.8  # s of audio a streamed chunk: 10 frames
FLASH_PER_ENCODE = TURBO["n_audio_layer"]


def http_json(url, obj=None, method=None, timeout=SERVE_TIMEOUT):
    """(status, body bytes) of one request; a JSON body when `obj` is given."""
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def http_multipart(url, fields: dict, wav: bytes, timeout=SERVE_TIMEOUT) -> bytes:
    import urllib.request

    b = "chipsmokeboundary"
    body = b"".join(f'--{b}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
                    .encode() for k, v in fields.items())
    body += (f'--{b}\r\nContent-Disposition: form-data; name="file"; filename="a.wav"\r\n'
             f"Content-Type: audio/wav\r\n\r\n").encode() + wav + f"\r\n--{b}--\r\n".encode()
    req = urllib.request.Request(url + "/v1/audio/transcriptions", data=body, method="POST",
                                 headers={"Content-Type": f"multipart/form-data; boundary={b}"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def http_speech_timed(url, payload) -> tuple:
    """(body, seconds to the status line, seconds to the last byte): the
    status line follows the model's first chunk, so the first is the time
    to first audio."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=SERVE_TIMEOUT)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/audio/speech", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        first = time.perf_counter() - t0
        body = resp.read()
        total = time.perf_counter() - t0
        if resp.status != 200:
            raise SystemExit(f"chip_smoke: /v1/audio/speech answered {resp.status}: {body[:300]}")
        return body, first, total
    finally:
        conn.close()


def ws_open(url, path):
    """A WebSocket client made from `ws.client_handshake_headers`."""
    import socket
    from urllib.parse import urlsplit

    from mlx_audio_tpu_torch import ws

    u = urlsplit(url)
    sock = socket.create_connection((u.hostname, u.port), timeout=SERVE_TIMEOUT)
    req, expect = ws.client_handshake_headers(f"{u.hostname}:{u.port}", path)
    sock.sendall(req)
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    head = resp.split(b"\r\n\r\n")[0].decode()
    if " 101 " not in head.splitlines()[0] or expect not in head:
        raise SystemExit(f"chip_smoke: the WebSocket upgrade of {path} answered {head!r}")
    return sock, ws.WebSocketConnection(sock.makefile("rb"), sock.makefile("wb"),
                                        mask_outgoing=True)


def load_served(url, provider, name) -> dict:
    """POST /v1/models, then wait for the batcher's warm-up, which must not
    have raised."""
    t0 = time.perf_counter()
    status, body = http_json(url + "/v1/models", {"model_name": name})
    load_s = time.perf_counter() - t0
    if status != 200 or json.loads(body)["status"] != "success":
        raise SystemExit(f"chip_smoke: POST /v1/models {name}: {status} {body[:300]}")
    t0 = time.perf_counter()
    err = provider.wait_warmup(name, timeout=SERVE_TIMEOUT)
    if err is not None:
        raise SystemExit(f"chip_smoke: the batcher warm-up of {name} raised {err!r}")
    return {"load_s": load_s, "warmup_s": time.perf_counter() - t0}


def unload_served(url, provider, name) -> None:
    """DELETE /v1/models/<id>: the batcher's scheduler thread must end."""
    from mlx_audio_tpu_torch.serving import get_infer_hook

    model = provider.load_model(name)
    batcher = get_infer_hook(model)
    # the scheduler's thread: a BatchScheduler's, a ContinuousBatcher's, or
    # the batcher's own
    thread = getattr(batcher, "sched", getattr(batcher, "cb", batcher))._thread
    status, body = http_json(f"{url}/v1/models/{name}", method="DELETE")
    thread.join(60)
    if status != 200 or thread.is_alive() or get_infer_hook(model) is not None:
        raise SystemExit(f"chip_smoke: DELETE {name} answered {status} {body[:200]} and left "
                         f"the batcher's thread {'alive' if thread.is_alive() else 'ended'}")


def http_routes(url) -> None:
    _, health = http_json(url + "/health")
    _, root = http_json(url + "/")
    _, ui = http_json(url + "/ui")
    _, models = http_json(url + "/v1/models")
    if (json.loads(health) != {"status": "ok"} or "/ui" not in json.loads(root)["endpoints"]
            or b"studio" not in ui or json.loads(models)["data"] != []):
        raise SystemExit("chip_smoke: GET /health, /, /ui or /v1/models answered wrongly")
    log(f"[server] GET /health, /, /ui ({len(ui)} bytes) and /v1/models answer")


def noise_wav(seconds, seed, sr=16000, channels=1, scale=0.05) -> bytes:
    from mlx_audio_tpu_torch import audio_io

    shape = (int(sr * seconds),) + ((channels,) if channels > 1 else ())
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return audio_io.encode_bytes(x, sr, "wav")


def seg_tokens(segments) -> list:
    return [t for s in segments for t in s["tokens"]]


def transcript_key(text, duration, segments) -> tuple:
    """What a verbose_json transcription says: its text, its duration and
    each segment's times, text and tokens."""
    return (text, round(duration, 6)) + tuple(
        (round(s["start"], 6), round(s["end"], 6), s["text"], tuple(s["tokens"]))
        for s in segments)


class WindowDecodes:
    """Records the window decodes a model's installed `WhisperBatcher` serves
    (the seek loop's `hook(window, prompt, opts, tokenizer)`), by putting a
    recording hook in front of it in the infer-hook registry: per calling
    thread (a served request's handler), in order, (window, prompt,
    options, tokens). `close` puts the batcher back."""

    def __init__(self, model):
        from mlx_audio_tpu_torch.serving import get_infer_hook, register_infer_hook

        self.model, self.batcher = model, get_infer_hook(model)
        self.lock = threading.Lock()
        self.by_thread = {}
        register_infer_hook(model, self)

    def __call__(self, window, prompt, opts, tokenizer):
        res = self.batcher(window, prompt, opts, tokenizer)
        with self.lock:
            self.by_thread.setdefault(threading.get_ident(), []).append(
                (window, list(prompt), opts, list(res.tokens)))
        return res

    def take(self) -> list:
        """This thread's decodes so far, which it forgets."""
        with self.lock:
            return self.by_thread.pop(threading.get_ident(), [])

    def close(self) -> None:
        from mlx_audio_tpu_torch.serving import register_infer_hook

        register_infer_hook(self.model, self.batcher)


def check_served_windows(model, outs, wants, served, tok) -> list:
    """Each served transcription against the in-memory model's sequential
    transcription of the same upload: the same text, duration and segments
    (times, text and tokens), or, at the
    first window decode where the two part (the same window, prompt and
    temperature, other tokens), a near-tie (`parting_gap`). `wants` holds
    (result, its decodes) a request, `served` the decodes of each served
    request, matched to it by their first window. Returns [(request,
    decode, temperature, step, what, gap, bar)]."""
    parted = []
    for i, (o, (want, seq)) in enumerate(zip(outs, wants)):
        if transcript_key(o["text"], o["duration"], o["segments"]) == transcript_key(
                want.text, want.duration, want.segments):
            continue
        srv = next((d for d in served if torch.equal(d[0][0], seq[0][0])), None)
        k = next((k for k, (x, y) in enumerate(zip(srv or [], seq))
                  if (x[2].temperature, x[3]) != (y[2].temperature, y[3])), None)
        if k is None or srv[k][2].temperature != seq[k][2].temperature or srv[k][1] != seq[k][1]:
            raise SystemExit(f"chip_smoke: served Whisper request {i} differs from its "
                             f"sequential transcription with no decode parting at the same "
                             f"window, prompt and temperature (decode {k})")
        (window, prompt, opts, b), a = seq[k], srv[k][3]
        parted.append((i, k, opts.temperature, *parting_gap(
            model, window, prompt, opts, tok, a, b,
            f"[server] whisper request {i}, decode {k} (t={opts.temperature})")))
    return parted


def parting_gap(model, window, prompt, opts, tok, a, b, label) -> tuple:
    """Where a served decode `a` parts from the sequential decode `b` of the
    same window, prompt and options: the sequential path's logits after the
    common prefix (a B = 1 encode and decoder pass), through the decoding
    rules, must put the two choices within SERVE_TIE_ULPS bf16 ulps; at
    t > 0 the row's Gumbel noise (its generator seeded 0, as
    `decode_window_batch` seeds a window's only sample) is added and the
    bar divided by t. Where the served choice is one the sequential rules
    masked, the rule that can flip on the logits is the forced timestamp
    (P(timestamps) > the best text token's): its two log-probabilities must
    lie within the bar. Returns (step, what, gap, bar); raises if it is no
    near-tie."""
    from mlx_audio_tpu_torch.stt.models.whisper import decoding as dec

    j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    ca = a[j] if j < len(a) else tok.eot
    cb = b[j] if j < len(b) else tok.eot
    toks, dev, V, ts = list(prompt) + list(b[:j]), model.device, model.dims.n_vocab, \
        tok.timestamp_begin
    stamps = [x for x in b[:j] if x >= ts]
    with torch.inference_mode():
        _, kv = model._encode(window[None])
        raw = model.decoder(torch.tensor([toks], device=dev), 0, None, kv)[0][0, -1].float()
        f = dec._apply_rules(
            raw[None].clone(), j, torch.tensor([toks[-1]], device=dev),
            torch.tensor([toks[-2]], device=dev),
            torch.tensor([stamps[-1] if stamps else ts], device=dev),
            suppress_mask=torch.from_numpy(dec._suppress_mask(tok, opts, V)).to(dev),
            eot=tok.eot, timestamp_begin=ts, no_timestamps=tok.no_timestamps,
            blank=(tok.encode(" ") or [tok.eot])[0], without_timestamps=opts.without_timestamps,
            max_initial_ts_index=(V if opts.max_initial_timestamp is None
                                  else round(opts.max_initial_timestamp / 0.02)))[0]
        t = float(opts.temperature)
        if not torch.isfinite(f[ca]):  # masked for the sequential run
            lp = torch.log_softmax(raw, dim=-1)
            is_ts = torch.arange(V, device=dev) >= ts
            x, y = torch.logsumexp(lp[is_ts], 0).item(), lp[~is_ts].max().item()
            what, gap = "forced-timestamp rule", abs(x - y)
            bar = SERVE_TIE_ULPS * bf16_ulp(max(abs(x), abs(y)))
        else:
            what, gap = "choice", (f[cb] - f[ca]).item()
            bar = SERVE_TIE_ULPS * bf16_ulp(max(abs(f[ca].item()), abs(f[cb].item())))
            if t > 0:
                gen = torch.Generator(device=dev).manual_seed(0)
                for _ in range(j // dec.NOISE_STEPS + 1):
                    u = dec.uniform_noise([gen], V, dev)[0, j % dec.NOISE_STEPS]
                g = -torch.log(-torch.log(u.clamp_min(1e-20)))
                gap, bar = gap / t + (g[cb] - g[ca]).item(), bar / t
    log(f"{label}: served and sequential part at step {j} (served {a[j:j + 3]}, sequential "
        f"{b[j:j + 3]}); {what} gap {gap:.3e} (bar {bar:.3e} = {SERVE_TIE_ULPS} bf16 ulp"
        f"{' / t' if t and what == 'choice' else ''})")
    if not abs(gap) <= bar:
        raise SystemExit(f"chip_smoke: {label}: served and sequential part at step {j} with a "
                         f"{what} gap of {gap}: not a near-tie")
    return j, what, gap, bar


def http_whisper(url, provider, tmp: Path, keep, smi) -> dict:
    """Whisper-large-v3-turbo (bf16) over HTTP and WebSocket, held to the
    in-memory phase 4 model (same seed) through a batcher of its own (the
    server's defaults, one row here)."""
    from mlx_audio_tpu_torch import profiling, server
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.serving import get_infer_hook
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import WhisperTokenizer

    d = tmp / "whisper-large-v3-turbo"
    name = str(d)
    rec = load_served(url, provider, name)
    served = provider.load_model(name)
    batcher = get_infer_hook(served)
    ref = keep.get("whisper") or Model(ModelDimensions(**TURBO), dtype=torch.bfloat16, seed=0)
    ref_batcher = ref.make_batcher().install()

    def tok():
        return WhisperTokenizer(d, language="en")

    try:
        # one request: 30 s of 44.1 kHz stereo noise
        wav = noise_wav(HTTP_WHISPER_S, 21, sr=44100, channels=2)
        fields = {"model": name, "language": "en", "response_format": "verbose_json"}
        flash_attention.launches, d0 = 0, batcher.dispatch_count
        t0 = time.perf_counter()
        one = json.loads(http_multipart(url, fields, wav))
        one_s = time.perf_counter() - t0
        launches, dispatches = flash_attention.launches, batcher.dispatch_count - d0
        want = ref.generate(server._read_16k(wav), language="en", tokenizer=tok())
        if launches != FLASH_PER_ENCODE * dispatches or not dispatches:
            raise SystemExit(f"chip_smoke: a served transcription launched flash {launches} "
                             f"times over {dispatches} batched dispatches")
        if one["text"] != want.text or seg_tokens(one["segments"]) != seg_tokens(
                want.segments) or not seg_tokens(want.segments):
            raise SystemExit(f"chip_smoke: the served text {one['text'][:80]!r} is not the "
                             f"in-memory model's {want.text[:80]!r}")
        log(f"[server] whisper: POST /v1/models {rec['load_s']:.2f} s, warm-up "
            f"{rec['warmup_s']:.2f} s; one {HTTP_WHISPER_S:g} s 44.1 kHz stereo transcription "
            f"{one_s:.4f} s "
            f"({HTTP_WHISPER_S / one_s:.1f}x real time), {dispatches} batched decode(s), flash "
            f"launches {launches} ({FLASH_PER_ENCODE} per encode); text = the reader's decode "
            f"of the in-memory model's {len(seg_tokens(want.segments))} tokens "
            f"({len(one['segments'])} segments, temperatures "
            f"{[s['temperature'] for s in one['segments']]})")

        # HTTP_STREAMS concurrent requests, each its own seeded upload and length (one
        # window each): one batched encode and decode a step of the seek
        # loops, each transcription the in-memory model's sequential one of
        # the same upload, or a stated near-tie. The seeded weights decode
        # few text tokens, often the same ones for other noise, so the
        # lengths keep the 8 answers apart (each states its duration). The
        # first asks for NDJSON: its segment lines and done line are its
        # answer
        wavs = [noise_wav(HTTP_CONC_S[i], 30 + i, scale=0.02 * (1 + i))
                for i in range(HTTP_STREAMS)]

        def transcribe(i):
            if i:
                return json.loads(http_multipart(url, fields, wavs[i]))
            lines = [json.loads(x) for x in http_multipart(
                url, dict(fields, stream="true"), wavs[0]).splitlines() if x.strip()]
            *segs, done = lines
            if done.get("type") != "done" or done["text"] != "".join(
                    x["text"] for x in segs).strip():
                raise SystemExit(f"chip_smoke: the NDJSON stream ends {done}, not a done line "
                                 f"with its segments' text")
            return {"text": done["text"], "duration": done["duration"], "segments": segs}

        served_decodes = WindowDecodes(served)
        flash_attention.launches, d0 = 0, batcher.dispatch_count
        t0 = time.perf_counter()
        try:
            outs = concurrently(transcribe, list(range(HTTP_STREAMS)))
        finally:
            served_decodes.close()
        conc_s = time.perf_counter() - t0
        c_launches, c_dispatches = flash_attention.launches, batcher.dispatch_count - d0
        if c_launches != FLASH_PER_ENCODE * c_dispatches:
            raise SystemExit(f"chip_smoke: the served transcriptions launched flash {c_launches} "
                             f"times over {c_dispatches} batched dispatches")
        ref_decodes = WindowDecodes(ref)
        t0 = time.perf_counter()
        try:
            wants = [(ref.generate(server._read_16k(w), language="en", tokenizer=tok()),
                      ref_decodes.take()) for w in wavs]
        finally:
            ref_decodes.close()
        seq_s = time.perf_counter() - t0
        keys = [transcript_key(w.text, w.duration, w.segments) for w, _ in wants]
        if len(set(keys)) != HTTP_STREAMS:
            raise SystemExit("chip_smoke: two of the uploads have the same transcription, so "
                             "a response sent to the other request could pass")
        distinct_tokens = len({tuple(seg_tokens(w.segments)) for w, _ in wants})
        parted = check_served_windows(ref, outs, wants, served_decodes.by_thread.values(), tok())
        same = [transcript_key(o["text"], o["duration"], o["segments"]) == k
                for o, k in zip(outs, keys)]
        total = sum(HTTP_CONC_S)
        log(f"[server] whisper: {HTTP_STREAMS} concurrent requests (the first as NDJSON: "
            f"{len(outs[0]['segments'])} segment lines and a done line), each its own seeded "
            f"upload of {HTTP_CONC_S[0]:g}-{HTTP_CONC_S[-1]:g} s ({distinct_tokens} distinct "
            f"token lists), in {conc_s:.4f} s = {total / conc_s:.1f}x aggregate real time "
            f"({seq_s:.4f} s one after another in memory: {seq_s / conc_s:.2f}x), "
            f"{c_dispatches} batched dispatches, flash launches "
            f"{c_launches}; transcriptions equal to their own sequential ones: {same}; parted at "
            f"near-ties: {parted}")

        # realtime, one session: a seeded burst, then silence, in 16 kHz
        # int16 frames
        burst = (np.clip(np.random.default_rng(22).standard_normal(16000) * 0.3, -1, 1)
                 * 32767).astype("<i2").tobytes()
        silence = bytes(8000)
        sock, conn = ws_open(url, f"/v1/audio/transcriptions/realtime?model={name}")
        try:
            for i in range(0, len(burst), 6400):
                conn.send_binary(burst[i:i + 6400])
            events = []
            t0 = time.perf_counter()
            for _ in range(3):
                conn.send_binary(silence)
            while not any(e.get("type") == "final" for e in events):
                events.append(json.loads(conn.recv()[1]))
            final_s = time.perf_counter() - t0
        finally:
            sock.close()
        stats, peak = profiling.memory_stats(), profiling.peak_memory_gb()
        if not stats or peak <= 0:
            raise SystemExit(f"chip_smoke: memory stats are empty ({len(stats)}, {peak})")
        buf = np.frombuffer(burst + silence * 2, np.int16).astype(np.float32) / 32768.0
        rt_want = ref.generate(buf, tokenizer=tok()).text
        if events[-1]["text"] != rt_want:
            raise SystemExit(f"chip_smoke: the realtime final {events[-1]['text'][:60]!r} is "
                             f"not generate's {rt_want[:60]!r}")
        log(f"[server] whisper realtime WebSocket: {len(events)} event(s), the final "
            f"{final_s:.4f} s after the silence began, text = generate on the same buffer; "
            f"memory_stats {len(stats)} keys, peak_memory_gb {peak} ({smi})")
    finally:
        ref_batcher.close()
    unload_served(url, provider, name)
    return dict(rec, one_wall_s=one_s, flash_launches=launches, dispatches=dispatches,
                concurrent_wall_s=conc_s, concurrent_xrt=total / conc_s,
                concurrent_sequential_wall_s=seq_s,
                concurrent_dispatches=c_dispatches, concurrent_flash_launches=c_launches,
                parted=parted, realtime_final_s=final_s, peak_memory_gb=peak)


def pcm16(audio) -> bytes:
    from mlx_audio_tpu_torch.server import _pcm16

    return _pcm16(audio)


def http_qwen(url, provider, tmp: Path, smi) -> dict:
    """Int4 Qwen3-TTS 0.6B (the phase 10 directory, served as CustomVoice)
    over HTTP and WebSocket."""
    from mlx_audio_tpu_torch.lm.continuous import _bucket
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.serving import get_infer_hook

    d = tmp / "qwen3-tts-0.6b-4bit"
    cfg = json.loads((d / "config.json").read_text())
    cfg["tts_model_type"] = "custom_voice"
    cfg["talker_config"] = dict(cfg.get("talker_config") or {},
                                spk_id={QWEN_SPEAKER: QWEN_SPEAKER_ID})
    (d / "config.json").write_text(json.dumps(cfg, indent=2))
    name = str(d)
    rec = load_served(url, provider, name)
    model = provider.load_model(name)
    model._effective_max_tokens = lambda text, max_tokens: min(HTTP_QWEN_FRAMES, max_tokens)
    batcher = get_infer_hook(model)
    req = {"model": name, "input": HTTP_TEXT, "voice": QWEN_SPEAKER, "temperature": 0.0,
           "streaming_interval": HTTP_STREAM_INTERVAL}

    # greedy, streamed wav, alone: time to first byte
    body, ttfb, wall = http_speech_timed(url, dict(req, response_format="wav"))
    audio_s = (len(body) - 44) / 2 / model.sample_rate

    # then one full wave of the pool (the server's batcher: 4 slots), each
    # request its own text: the first text over the WebSocket route, the
    # second through the served model's own `generate` in process, the last
    # two over HTTP. Each must give the samples its text gives with one live
    # slot (greedy codes do not depend on co-tenants): the first body, and
    # for the others the model's `generate` after the wave, one at a time.
    # Every quantized launch of the wave is held to the routing table at the
    # pool's shapes
    def over_ws(text):
        sock, conn = ws_open(url, "/v1/audio/speech/stream")
        try:
            t0 = time.perf_counter()
            conn.send_text(json.dumps(dict(req, input=text)))
            start = json.loads(conn.recv()[1])
            frames, first = [], None
            while True:
                op, payload = conn.recv()
                if op == 0x1:
                    return start, json.loads(payload), frames, first, time.perf_counter() - t0
                if first is None:
                    first = time.perf_counter() - t0
                frames.append(payload)
        finally:
            sock.close()

    def in_process(text):
        kw = dict(text=text, voice=QWEN_SPEAKER, speed=1.0, lang_code="a",
                  temperature=0.0, stream=True, streaming_interval=HTTP_STREAM_INTERVAL)
        return b"".join(pcm16(r.audio) for r in model.generate(**kw))

    def over_http(text):
        return http_json(url + "/v1/audio/speech", dict(req, input=text,
                                                        response_format="pcm"))[1]

    buckets = [_bucket(model._prepare_generation_inputs(t, language="a", speaker=QWEN_SPEAKER)[0]
                       .shape[1]) for t in HTTP_TEXTS]
    qk.reset_launches()
    t0_ticks = batcher.dispatch_count
    t0 = time.perf_counter()
    wave = concurrently(lambda fa: fa[0](fa[1]), list(zip(
        (over_ws, in_process, over_http, over_http), HTTP_TEXTS)))
    conc_s = time.perf_counter() - t0
    ticks = batcher.dispatch_count - t0_ticks
    got = quant_counts(4)
    t0 = time.perf_counter()
    wants = [body[44:]] + [in_process(t) for t in HTTP_TEXTS[1:]]
    alone_s = time.perf_counter() - t0
    (start, done, frames, first_frame, ws_wall), *bodies = wave
    if body[:4] != b"RIFF" or not all(wants) or len(set(wants)) != len(wants):
        raise SystemExit(f"chip_smoke: the one-slot speech of the four texts is empty or not "
                         f"distinct ({[len(w) for w in wants]} bytes)")
    if start.get("type") != "start" or done.get("type") != "done" or b"".join(frames) != wants[0]:
        raise SystemExit(f"chip_smoke: the WebSocket speech ({start}, {done}) is not the HTTP "
                         f"body's samples")
    for i, (b, w) in enumerate(zip(bodies, wants[1:]), 1):
        if b != w:
            raise SystemExit(f"chip_smoke: greedy request {i} beside co-tenants gave other "
                             f"samples ({len(b)} bytes) than alone ({len(w)} bytes)")
    predicted = predicted_serving_launches(model, 4, buckets, ticks * batcher.tick_frames,
                                           batcher.slots, layers_only=True)
    wave_s = sum(len(w) for w in wants) / 2 / model.sample_rate
    log(f"[server] qwen3 int4 greedy CustomVoice speech, {audio_s:.2f} s of audio: HTTP time "
        f"to first byte {ttfb:.4f} s, wall {wall:.4f} s (RTF {wall / audio_s:.3f}), alone; "
        f"then a wave of {len(wave)} texts in {conc_s:.4f} s ({wave_s / conc_s:.2f}x real "
        f"time aggregate, {ticks} ticks of {batcher.slots} slots): the WebSocket route (first "
        f"frame {first_frame:.4f} s, {len(frames)} frames), the model's generate in process "
        f"and two HTTP requests, each equal int16 for int16 to its text alone (the last three "
        f"{alone_s:.4f} s one after another); launches {got}, routing table {predicted} "
        f"({smi})")
    for k, n in predicted.items():
        if got[k] != n:
            raise SystemExit(f"chip_smoke: the served wave launched {k} {got[k]} times, the "
                             f"routing table says {n}")
    unload_served(url, provider, name)
    return dict(rec, audio_s=audio_s, ttfb_s=ttfb, wall_s=wall, ws_first_frame_s=first_frame,
                ws_wall_s=ws_wall, wave=len(wave), wave_wall_s=conc_s,
                wave_xrt=wave_s / conc_s, alone_wall_s=alone_s, ticks=ticks, launches=got,
                predicted=predicted)


def http_kokoro(url, provider, tmp: Path) -> dict:
    """Kokoro-82M (the phase 10 directory, float32) against the in-memory
    model of the same seed in float32, within one int16 step; then the same
    request again inside `profiling.trace` and `annotate('request')` (the
    served request the trace covers: a short one, since a Whisper request's
    decode at every fallback temperature makes a 470 MB trace)."""
    from mlx_audio_tpu_torch import profiling
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import torch_checkpoint

    d = tmp / "kokoro-82m"
    name = str(d)
    rec = load_served(url, provider, name)
    body, ttfb, wall = http_speech_timed(url, {"model": name, "input": LOADED_KOKORO_TEXT,
                                               "voice": "af_smoke", "response_format": "wav"})
    # the in-memory float32 model: built in float32 (its STFT tables too, as
    # the loader builds them), with the weights of phase 10's bf16 model
    # taken through the upstream layout in memory (the weight-norm fold
    # moves a weight by up to a float32 ulp, as the loader's does)
    model = kokoro_model("cuda")
    load_weights(model, model.sanitize(torch_checkpoint(kokoro_model("cuda", torch.bfloat16))))
    model.repo_id = str(d)
    want = np.frombuffer(b"".join(pcm16(r.audio) for r in model.generate(
        LOADED_KOKORO_TEXT, voice="af_smoke", speed=1.0, lang_code="a")), "<i2")
    got = np.frombuffer(body[44:], "<i2")
    steps = int(np.abs(got.astype(np.int32) - want).max()) if got.shape == want.shape else None
    del model
    if steps is None or steps > 1 or not want.size:
        raise SystemExit(f"chip_smoke: served Kokoro {got.shape} is not within one int16 step "
                         f"of the in-memory model's {want.shape} ({steps})")
    trace_dir = tmp / "trace"
    t_trace = time.perf_counter()
    with profiling.trace(trace_dir):
        with profiling.annotate("request"):
            again = http_speech_timed(url, {"model": name, "input": LOADED_KOKORO_TEXT,
                                            "voice": "af_smoke", "response_format": "wav"})[0]
    traced_s = time.perf_counter() - t_trace
    events = [e for p in trace_dir.glob("*.json")
              for e in json.loads(p.read_text()).get("traceEvents", [])]
    trace_bytes = sum(p.stat().st_size for p in trace_dir.glob("*.json"))
    shutil.rmtree(trace_dir)
    kernels = sum(e.get("cat") == "kernel" for e in events)
    again = np.frombuffer(again[44:], "<i2")
    again_steps = (int(np.abs(again.astype(np.int32) - want).max())
                   if again.shape == want.shape else None)
    if again_steps is None or again_steps > 1 or not kernels or not any(
            e.get("name") == "request" for e in events):
        raise SystemExit(f"chip_smoke: the traced Kokoro request is not within one int16 step "
                         f"of the in-memory model ({again_steps}), or its trace "
                         f"({len(events)} events) lacks the span or device kernels")
    log(f"[server] kokoro f32: {want.size / 24000:.2f} s of audio, time to first byte "
        f"{ttfb:.4f} s, wall {wall:.4f} s; max |d| {steps} int16 step(s) from the in-memory "
        f"model; the same request inside profiling.trace and annotate('request'): max |d| "
        f"{again_steps} int16 step(s), {traced_s:.2f} s with the export, {trace_bytes / 1e6:.1f} MB of Chrome trace "
        f"naming 'request' with {kernels} device kernels")
    unload_served(url, provider, name)
    return dict(rec, ttfb_s=ttfb, wall_s=wall, max_int16_steps=steps, traced_s=traced_s,
                trace_bytes=trace_bytes, traced_kernels=kernels)


def http_whisper_int4(url, provider, tmp: Path) -> dict:
    """Whisper-large-v3-turbo converted to int4: served, its quantized
    launches held to the code's count (every decoder step: per layer the
    fused q/k/v, o, the cross-attention's query and out, mlp1 and mlp2,
    each where the routing guard takes it), the fused q/k/v's as the
    wrapper counts them at N = 3 x 1280; then, in process, its decode on
    one encoder output against the same checkpoint loaded without the
    row-stack: identical tokens, and two fewer launches a layer a step."""
    from mlx_audio_tpu_torch import convert, server, utils
    from mlx_audio_tpu_torch.nn import quantized as nnq
    from mlx_audio_tpu_torch.nn.quantized import qmm_routable
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.stt.models.whisper import Model
    from mlx_audio_tpu_torch.stt.models.whisper.decoding import DecodingOptions, decode_window
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import WhisperTokenizer

    src = tmp / "whisper-large-v3-turbo"
    d = tmp / "whisper-large-v3-turbo-4bit"
    t0 = time.perf_counter()
    convert.convert(str(src), str(d), quantize=True, q_bits=4, q_group_size=GROUP)
    convert_s = time.perf_counter() - t0
    name = str(d)
    rec = load_served(url, provider, name)
    served = provider.load_model(name)
    layers, D = TURBO["n_text_layer"], TURBO["n_text_state"]
    enc_layers, Da = TURBO["n_audio_layer"], TURBO["n_audio_state"]
    # (N, K) of a decoder layer's quantized projections: the fused q/k/v,
    # out, the cross-attention's query and out, mlp1, mlp2; of an encoder
    # layer's; and the cross-attention's key and value over the encoder
    # output, once an encode
    shapes = [(3 * D, D), (D, D), (D, D), (D, D), (4 * D, D), (D, 4 * D)]
    enc_shapes = [(3 * Da, Da), (Da, Da), (4 * Da, Da), (Da, 4 * Da)]
    kv_shapes = [(D, Da), (D, Da)]
    fused = sum(hasattr(b.attn, "qkv_fused") for b in served.decoder.blocks)
    crossed = sum(hasattr(b.cross_attn, "qkv_fused") for b in served.decoder.blocks)
    if fused != layers or crossed:
        raise SystemExit(f"chip_smoke: the int4 Whisper row-stacked {fused} self-attentions and "
                         f"{crossed} cross-attentions")

    rows, enc_rows = [], []
    step, encode = Model._decoder_step, Model._encode

    def spy(model, tokens, *a, **kw):
        rows.append(tokens.shape[0] * tokens.shape[1])
        return step(model, tokens, *a, **kw)

    def encode_spy(model, mel):
        enc_rows.append(mel.shape[0] * TURBO["n_audio_ctx"])
        return encode(model, mel)

    def predicted(dec_ms, enc_ms) -> dict:
        n = {"qmm": 0, "qmm_gemv": 0, "qmm_mma": 0, "qmm_kernel": 0}
        for ms, table in ((dec_ms, [(s, layers) for s in shapes]),
                          (enc_ms, [(s, enc_layers) for s in enc_shapes]
                           + [(s, layers) for s in kv_shapes])):
            for M in ms:
                for (N, K), times in table:
                    if qmm_routable(4, GROUP, N, K, M):
                        n["qmm"] += times
                        n[qmm_route("", M, 4, K, GROUP)] += times
        return n

    wav = noise_wav(HTTP_INT4_S, 41)  # one window
    Model._decoder_step = staticmethod(spy)
    Model._encode = encode_spy
    try:
        qk.reset_launches()
        t0 = time.perf_counter()
        out = json.loads(http_multipart(url, {"model": name, "language": "en",
                                              "response_format": "verbose_json"}, wav))
        wall = time.perf_counter() - t0
        got = {k: quant_counts(4)[k] for k in ("qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")}
        qkv = qk.quantized_matmul.shapes.get((3 * D, D), 0)  # counted where it launches
        served_rows, served_enc = list(rows), list(enc_rows)
        want = predicted(served_rows, served_enc)
        want_qkv = sum(layers * qmm_routable(4, GROUP, 3 * D, D, M) for M in served_rows)
        if got != want or qkv != want_qkv or not qkv:
            raise SystemExit(f"chip_smoke: the served int4 Whisper launched {got}, {qkv} of "
                             f"them the fused q/k/v; the code says {want}, {want_qkv}, over "
                             f"{len(served_rows)} decoder steps and {len(served_enc)} encodes")
        # fused against unfused on one encoder output, greedy, 96 tokens
        tok = WhisperTokenizer(d, language="en")
        opts = DecodingOptions(task="transcribe", language="en", temperature=0.0,
                               without_timestamps=True, sample_len=96)
        prompt = list(tok.sot_sequence_including_notimestamps)
        mel, _ = served._mel_chunks_device(server._read_16k(wav))
        unfused_load = nnq.fuse_quantized_projections
        nnq.fuse_quantized_projections = lambda model: 0
        try:
            unfused = utils.load_model(d, device=served.device)
        finally:
            nnq.fuse_quantized_projections = unfused_load
        toks, counts = [], []
        with torch.inference_mode():
            _, cross_kv = served._encode(mel[:1])
            for m in (served, unfused):
                qk.reset_launches()
                rows.clear()
                res = decode_window(m, cross_kv, tok, prompt, opts, n_ctx=m.dims.n_text_ctx,
                                    n_vocab=m.dims.n_vocab, decoder_step=Model._decoder_step,
                                    make_caches=m._make_caches)
                toks.append(res.tokens)
                counts.append((quant_counts(4)["qmm"], list(rows),
                               qk.quantized_matmul.shapes.get((3 * D, D), 0)))
    finally:
        Model._decoder_step, Model._encode = step, encode
    del unfused
    (nf, dec_rows, qkv_f), (nu, dec_rows_u, qkv_u) = counts
    calls = len(dec_rows)
    # three launches at N = D where the row-stack makes one at N = 3D, a
    # layer a step (at these widths every one is routed: 2 a layer a step)
    extra = sum(layers * (3 * qmm_routable(4, GROUP, D, D, M)
                          - qmm_routable(4, GROUP, 3 * D, D, M)) for M in dec_rows)
    if (toks[0] != toks[1] or not toks[0] or dec_rows != dec_rows_u or nu - nf != extra
            or qkv_u or qkv_f != sum(layers * qmm_routable(4, GROUP, 3 * D, D, M)
                                     for M in dec_rows)):
        raise SystemExit(f"chip_smoke: fused and unfused int4 Whisper: tokens "
                         f"{'equal' if toks[0] == toks[1] else 'differ'}, qmm launches {nf} and "
                         f"{nu} over {calls} and {len(dec_rows_u)} decoder steps (fused q/k/v "
                         f"{qkv_f} and {qkv_u}), the code says {extra} more unfused")
    log(f"[server] whisper int4: converted in {convert_s:.2f} s; POST /v1/models "
        f"{rec['load_s']:.2f} s; q/k/v row-stacked on the {fused} self-attentions only; one "
        f"served {HTTP_INT4_S:g} s transcription {wall:.4f} s over {len(served_enc)} encode(s) and "
        f"{len(served_rows)} decoder steps (rows {sorted(set(served_rows))}; the encodes' "
        f"share {predicted([], served_enc)['qmm']}): quantized launches {got} = the code's "
        f"count, of which {qkv} at the fused q/k/v's N = {3 * D}, K = {D}; fused and unfused "
        f"decodes on one encoder output: {len(toks[0])} identical tokens, qmm launches {nf} "
        f"({qkv_f} fused q/k/v) and {nu} ({extra} more unfused over {calls} steps)")
    unload_served(url, provider, name)
    return dict(rec, convert_s=convert_s, wall_s=wall, decoder_steps=len(served_rows),
                launches=got, fused_qkv_launches=qkv, fused_qmm=nf, unfused_qmm=nu,
                fused_decode_qkv_launches=qkv_f, decode_steps=calls,
                text_chars=len(out["text"]))


def phase_http(smi: str, tmp: Path, keep) -> dict:
    """Phase 12: `server.serve_stdlib` in process on a free port, models
    loaded through POST /v1/models from phase 10's directories."""
    from mlx_audio_tpu_torch import server
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model as Qwen

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    provider = server.ModelProvider()  # on the card
    httpd = server.serve_stdlib("127.0.0.1", 0, provider)
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    saved = Qwen._tokenizer
    Qwen._tokenizer = None  # phase 5's stand-in: served models read their tokenizer.json
    try:
        http_routes(url)
        rec = {"whisper": http_whisper(url, provider, tmp, keep, smi),
               "qwen3_int4": http_qwen(url, provider, tmp, smi),
               "kokoro_f32": http_kokoro(url, provider, tmp),
               "whisper_int4": http_whisper_int4(url, provider, tmp)}
    finally:
        Qwen._tokenizer = saved
        httpd.shutdown()
        httpd.server_close()
        for name in provider.list_models():
            provider.unload(name)
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[server] phase 12 wall {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 13: Orpheus-3B int4 through the LM core (CausalLM, the generate
# loops, the continuous batcher) and SNAC 24 kHz, loaded from a checkpoint
# directory written in the run; Qwen3-TTS Base's x-vector voice cloning
# ---------------------------------------------------------------------------

# Orpheus-3B: Llama-3.2-3B's published widths and llama3 rope scaling with
# the audio vocabulary (scripts/bench_serving.py:175-179); the lm_head
# untied, as the repository's own builds leave it
ORPHEUS_CFG = dict(
    model_type="llama", hidden_size=3072, num_hidden_layers=28, intermediate_size=8192,
    num_attention_heads=24, num_key_value_heads=8, head_dim=128, vocab_size=156940,
    rope_theta=500000.0, rms_norm_eps=1e-5, max_position_embeddings=131072,
    tie_word_embeddings=False,
    rope_scaling={"factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192, "rope_type": "llama3"})
# hubertsiuzdak/snac_24khz's published config: hop 512, one 7-token frame is
# 4 latent frames (the first codebook's stride), 2048 samples
SNAC_24K = dict(sampling_rate=24000, encoder_dim=48, encoder_rates=[2, 4, 8, 8],
                decoder_dim=1024, decoder_rates=[8, 8, 4, 2], attn_window_size=None,
                codebook_size=4096, codebook_dim=8, vq_strides=[4, 2, 1], noise=True,
                depthwise=True)
# The seeded checkpoint plants a greedy path through the full model: every
# weight is random int4 codes with per-group scales, the residual branches'
# at a small scale; the lm_head's at a large one; and the (bf16) embedding
# row of token t is the dequantized lm_head row of its planted successor, so
# the residual stream points at the successor's row and the argmax takes it
# by a wide margin. From END_OF_HUMAN the path runs START_OF_AI,
# START_OF_SPEECH, ORPHEUS_SPOKEN frames of 7 codes (each slot its own
# codebook offset), END_OF_SPEECH; a second set of ORPHEUS_CYCLE frames
# loops without end (the batcher's prompts enter it). Tokens off the path
# succeed themselves.
ORPHEUS_SPOKEN = 23
ORPHEUS_CYCLE = 100
ORPHEUS_RESIDUAL_SCALE = 1e-3
ORPHEUS_TEXT = HTTP_TEXT
# Model.generate at the greedy defaults (repetition penalty 1.3 over 20
# tokens): SOA, SOS, 23 frames and END_OF_SPEECH are 164 tokens, under the cap
ORPHEUS_MAX_TOKENS = 7 * 24
ORPHEUS_STREAM_INTERVAL = 0.5  # s of audio a streamed chunk: 63 tokens, 9 frames
ORPHEUS_TIMED = 1
ORPHEUS_PROFILE_TOKENS = 2 + 7 * 6
# the reduced-depth copy's tokens card against CPU (every CPU step
# dequantizes the 156940 x 3072 lm_head; 3 until phase 18 came)
ORPHEUS_CPU_TOKENS = 1
# The layers' share of the planted path's logits is small (the residual
# branches are scaled by ORPHEUS_RESIDUAL_SCALE), so the float32 two-layer
# copy's logits are held to ORPHEUS_LAYER_BAR of what its layers add to them
# (their distance from the logits of the embedding alone), beside
# CARD_VS_CPU_ATOL of their peak; planted faults of the decode must exceed it
ORPHEUS_LAYER_BAR = 1e-2
# the two-layer copy's batched wave: each request's tokens, and the decode
# steps whose logits each slot holds to its sequential run (within and
# across 16-step ticks)
ORPHEUS_CHECK_TOKENS = 40
ORPHEUS_CHECK_STEPS = (1, 8, 15, 16, 17, 33, 39)
# bench_snac_lm_continuous's settings (scripts/bench_serving.py:161-231),
# cut in depth to 32 tokens a request, two ticks (its 128 until phase 17
# came, 64 until phase 18 came)
ORPHEUS_SLOTS, ORPHEUS_TICK, ORPHEUS_POOL_LEN, ORPHEUS_BATCH_TOKENS = 4, 16, 256, 32
# Qwen3-TTS Base x-vector cloning: a 3 s 24 kHz reference, 16 frames
XVEC_FRAMES = 16


def orpheus_successors(V: int, seed: int = 0, model_cls=None):
    """(successor of every token id, the spoken frames' codes (23, 7), the
    cycle's codes (100, 7)), codes 0..4095 a slot, for the special-token
    layout of `model_cls` (default Orpheus; VyvoTTS has its own)."""
    from mlx_audio_tpu_torch.tts.models.llama import Model as Orpheus

    m = model_cls or Orpheus
    rng = np.random.default_rng(seed)
    n = ORPHEUS_SPOKEN + ORPHEUS_CYCLE
    codes = np.stack([rng.permutation(4096)[:n] for _ in range(7)], axis=1)
    tok = m.AUDIO_TOKENS_START + np.arange(7) * 4096 + codes
    succ = np.arange(V)
    succ[m.END_OF_HUMAN] = m.START_OF_AI
    succ[m.START_OF_AI] = m.START_OF_SPEECH
    succ[m.START_OF_SPEECH] = tok[0, 0]
    A, C = ORPHEUS_SPOKEN, ORPHEUS_CYCLE
    for f in range(n):
        succ[tok[f, :6]] = tok[f, 1:]
        if f < A - 1:
            succ[tok[f, 6]] = tok[f + 1, 0]
        elif f == A - 1:
            succ[tok[f, 6]] = m.END_OF_SPEECH
        else:
            succ[tok[f, 6]] = tok[A + (f - A + 1) % C, 0]
    return succ, codes[:A], codes[A:]


def frame_codes(codes) -> list:
    """Frames of 7 slot codes → the flat code list `parse_output` gives."""
    return [int(c) + 4096 * k for frame in codes for k, c in enumerate(frame)]


def write_orpheus(path: Path, reduced: Path, succ, seed: int = 0) -> tuple:
    """Orpheus-3B int4 (g64, every Linear; the embedding bf16) into `path`
    and its first two layers into `reduced`, each with a Llama-3 style
    tokenizer.json. One matrix at a time is drawn on the card; the host
    holds the int4 checkpoint, never a float model. → (seconds, bytes)."""
    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.quantized import dequantize_arrays

    t0 = time.perf_counter()
    c = ORPHEUS_CFG
    D, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    q, kv = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def host(prefix, w, s, b):
        return {f"{prefix}.weight": w.cpu().numpy().view(np.uint32),
                f"{prefix}.scales": s.cpu().numpy(), f"{prefix}.biases": b.cpu().numpy()}

    ones = torch.ones(D, dtype=torch.bfloat16)
    weights = {}
    for layer in range(c["num_hidden_layers"]):
        p = f"model.layers.{layer}"
        for name, N, K in (("self_attn.q_proj", q, D), ("self_attn.k_proj", kv, D),
                           ("self_attn.v_proj", kv, D), ("self_attn.o_proj", D, q),
                           ("mlp.gate_proj", I, D), ("mlp.up_proj", I, D),
                           ("mlp.down_proj", D, I)):
            weights.update(host(f"{p}.{name}",
                                *random_quant_weights(N, K, g, ORPHEUS_RESIDUAL_SCALE)))
        weights[f"{p}.input_layernorm.weight"] = ones
        weights[f"{p}.post_attention_layernorm.weight"] = ones
    head = random_quant_weights(V, D, g, 1.0)
    weights.update(host("lm_head", *head))
    weights["model.norm.weight"] = ones
    emb = torch.empty(V, D, dtype=torch.bfloat16, device="cuda")
    succ_t = torch.as_tensor(succ, device="cuda")
    for i in range(0, V, 16384):
        rows = succ_t[i:i + 16384]
        emb[i:i + 16384] = dequantize_arrays(head[0][rows], head[1][rows], head[2][rows],
                                             GROUP, 4, torch.bfloat16)
    weights["model.embed_tokens.weight"] = emb.cpu()
    del emb, head
    quant = {"group_size": GROUP, "bits": 4}
    save_model(path, weights, dict(c, quantization=quant))
    write_tokenizer_json(path, "llama3")
    two = {k: v for k, v in weights.items()
           if not k.startswith("model.layers.") or int(k.split(".")[2]) < 2}
    save_model(reduced, two, dict(c, num_hidden_layers=2, quantization=quant))
    write_tokenizer_json(reduced, "llama3")
    torch.cuda.empty_cache()
    return time.perf_counter() - t0, checkpoint_bytes(path)


def decode_calls(n_gen: int, max_tokens: int, chunk: int) -> int:
    """The model calls of `lm.generate`'s decode for n_gen tokens (EOS last)
    under max_tokens, in chunks of `chunk` steps: a chunk stops at the first
    poll (every POLL_STEPS steps, before its last step) after EOS."""
    from mlx_audio_tpu_torch.lm.generate import POLL_STEPS

    calls = produced = 0
    while produced < max_tokens:
        steps = min(chunk, max_tokens - produced)
        eos = n_gen - 1 - produced
        if 0 <= eos < steps:
            i = eos + 1
            while i < steps and i % POLL_STEPS:
                i += 1
            return calls + i
        calls += steps
        produced += steps
    return calls


def orpheus_launches(layers: int, calls) -> dict:
    """The quantized launches of model calls [(rows M, calls)] from the code:
    a layer's fused q/k/v and o_proj through qmm (the GEMV at M <= 4, the
    tensor-core GEMM above), its MLP through the fused kernel up to
    QMLP_MAX_M rows (else gate/up and down through qmm), and the lm_head
    through qmm."""
    from mlx_audio_tpu_torch.ops.cuda.quant_matmul import QMLP_MAX_M

    got = {"qmm": 0, "qmlp": 0, "qmm_kernel": 0, "qmm_gemv": 0, "qmm_mma": 0}
    for M, n in calls:
        per = 2 * layers + 1
        if M <= QMLP_MAX_M:
            got["qmlp"] += layers * n
        else:
            per += 2 * layers
        got["qmm_gemv" if M <= 4 else "qmm_mma"] += per * n
        got["qmm"] += per * n
    return got


def held_launches(label, predicted) -> dict:
    got = quant_counts(4)
    log(f"[orpheus] {label}: launches {got}, from the code {predicted}")
    if got != predicted:
        raise SystemExit(f"chip_smoke: {label} launched {got}, the code says {predicted}")
    return got


def wave_prompts(model, cycle) -> list:
    """The four texts' prompts, each entering the planted cycle at its own
    frame, so that the four requests' tokens differ."""
    M = type(model)
    return [model.prepare_input_ids(t) + [
        M.START_OF_AI, M.START_OF_SPEECH,
        M.AUDIO_TOKENS_START + int(cycle[25 * i, 0])] for i, t in enumerate(HTTP_TEXTS)]


def logit_rows(rows, fault: bool = False):
    """A `generate_tokens` model call that keeps every call's last float32
    logits on the host. `fault` plants an off-by-one cache position: each
    decode step writes its K/V over its predecessor's, at its predecessor's
    position."""
    def call(model, ids, caches):
        if fault and ids.shape[1] == 1:
            for c in caches:
                c.pos -= 1
        logits, caches = model(ids, caches)
        rows.append(logits[0, -1].float().cpu())
        return logits, caches
    return call


def plant_logits(model, toks) -> torch.Tensor:
    """The logits of tokens `toks` from the embedding alone, the layers
    skipped: what the layers add is the logits' distance from these."""
    ids = torch.as_tensor([list(toks)], device=model.device)
    return model.logits(model.model.norm(model.model.embed_tokens(ids)))[0].float().cpu()


def within(gaps) -> bool:
    """Every row (max|got - want|, want's peak, what the layers add to want)
    inside both bars."""
    return all(d <= CARD_VS_CPU_ATOL * peak and d <= ORPHEUS_LAYER_BAR * add
               for d, peak, add in gaps)


def row_gaps(pairs) -> list:
    """(got, want, plant) rows → (max|got - want|, want's peak, max|want -
    plant|) each."""
    return [((g - w).abs().max().item(), w.abs().max().item(), (w - p).abs().max().item())
            for g, w, p in pairs]


def batched_rows(model, prompts, fault=None) -> tuple:
    """One wave of `prompts` through the model's LMContinuousBatcher →
    (each request's tokens, {(request, decode step): its slot's float32
    logits} at ORPHEUS_CHECK_STEPS). `fault` plants one: "position" steps
    every slot at its predecessor's position, "slots" makes slots 0 and 1
    read (and write) each other's caches."""
    from mlx_audio_tpu_torch.lm import continuous as lc

    step, rows = lc._step, {}
    batcher = model.make_batcher(slots=ORPHEUS_SLOTS, max_len=ORPHEUS_POOL_LEN,
                                 tick_tokens=ORPHEUS_TICK)

    def swap(caches):
        for c in caches:
            c.k[[0, 1]] = c.k[[1, 0]]
            c.v[[0, 1]] = c.v[[1, 0]]

    def spy(m, caches, tokens, pos):
        if fault == "slots":
            swap(caches)
        logits = step(m, caches, tokens, pos - 1 if fault == "position" else pos)
        if fault == "slots":
            swap(caches)
        at = pos.tolist()
        for slot, req in enumerate(batcher.cb.active):
            # a slot at position p draws its request's token p - T + 1
            k = -1 if req is None else at[slot] - len(req.prompt) + 1
            if k in ORPHEUS_CHECK_STEPS:
                rows[(id(req.future), k)] = logits[slot].cpu()
        return logits

    lc._step = spy
    try:
        futs = [batcher.submit(p, max_tokens=ORPHEUS_CHECK_TOKENS) for p in prompts]
        outs = results_in_time(futs)
    finally:
        lc._step = step
        batcher.close()
    index = {id(f): i for i, f in enumerate(futs)}
    return outs, {(index[f], k): r for (f, k), r in rows.items()}


def orpheus_two_layer(reduced: Path, ids, prompts) -> dict:
    """The two-layer copy at full width in float32 (TF32 off), where the
    logits resolve what the layers add. `generate_tokens` card against CPU:
    every call's logits (the prompt's, and each M = 1 decode step's through
    the bf16 KV cache) and ORPHEUS_CPU_TOKENS greedy tokens, which must be
    identical. Then one LMContinuousBatcher wave of the four prompts on the
    card: each request's tokens equal to its sequential run's, and each
    slot's logits at ORPHEUS_CHECK_STEPS held to them. Logits are held to
    both bars (`within`); planted faults must break them: an off-by-one
    cache position in the decode and in the batcher, and two slots that
    read each other's caches."""
    from mlx_audio_tpu_torch.lm.generate import generate_tokens
    from mlx_audio_tpu_torch.tts.models.llama import Model as Orpheus

    t0 = time.perf_counter()
    kw = dict(max_tokens=ORPHEUS_CPU_TOKENS, repetition_penalty=1.3,
              repetition_context_size=20, eos_token_ids=(Orpheus.END_OF_SPEECH,))
    cpu, cpu_load = timed_load(str(reduced), device="cpu", dtype=torch.float32)
    want = []
    with torch.inference_mode():
        want_toks = generate_tokens(cpu, ids, model_call=logit_rows(want), **kw)[0][0].tolist()
    del cpu
    card, _ = timed_load(str(reduced), device="cuda", dtype=torch.float32)
    got, bad = [], []
    with torch.inference_mode():
        toks = generate_tokens(card, ids, model_call=logit_rows(got), **kw)[0][0].tolist()
        generate_tokens(card, ids, model_call=logit_rows(bad, fault=True), **kw)
        plant = plant_logits(card, [ids[-1]] + want_toks)
    gaps = row_gaps(zip(got, want, plant))
    fault = row_gaps(zip(bad, want, plant))
    log(f"[orpheus] two-layer copy, float32, card against CPU: logits of the prompt and "
        f"{len(gaps) - 1} decode steps, max|d| {[f'{g[0]:.3e}' for g in gaps]}, peaks "
        f"{[round(g[1], 1) for g in gaps]} (bar {CARD_VS_CPU_ATOL:g} of each), what the layers "
        f"add {[round(g[2], 3) for g in gaps]} (bar {ORPHEUS_LAYER_BAR:g} of each); greedy "
        f"tokens {toks} vs {want_toks}; a planted off-by-one cache position parts them by "
        f"{[f'{g[0]:.3e}' for g in fault]} ({time.perf_counter() - t0:.1f} s, the CPU load "
        f"{cpu_load:.1f} s)")
    if not within(gaps) or toks != want_toks or len(gaps) != ORPHEUS_CPU_TOKENS + 1:
        raise SystemExit("chip_smoke: the Orpheus two-layer copy parts card from CPU")
    if within(fault):
        raise SystemExit("chip_smoke: the two-layer decode check passes an off-by-one cache "
                         "position")

    t1 = time.perf_counter()
    seq = []
    with torch.inference_mode():
        for p in prompts:
            rows = []
            out = generate_tokens(card, p, max_tokens=ORPHEUS_CHECK_TOKENS,
                                  model_call=logit_rows(rows))[0][0].tolist()
            seq.append((out, rows, plant_logits(card, [p[-1]] + out)))

    def wave_gaps(rows):
        return row_gaps((r, seq[i][1][k], seq[i][2][k]) for (i, k), r in sorted(rows.items()))

    outs, rows = batched_rows(card, prompts)
    wave = wave_gaps(rows)
    faults = {}
    for kind in ("position", "slots"):
        f_outs, f_rows = batched_rows(card, prompts, kind)
        faults[kind] = max(g[0] for g in wave_gaps(f_rows))
        if within(wave_gaps(f_rows)) and f_outs == outs:
            raise SystemExit(f"chip_smoke: the two-layer batched check passes a planted "
                             f"{kind} fault")
    worst = max(g[0] / min(CARD_VS_CPU_ATOL * g[1], ORPHEUS_LAYER_BAR * g[2]) for g in wave)
    log(f"[orpheus] two-layer copy, float32, LMContinuousBatcher ({ORPHEUS_SLOTS} slots, tick "
        f"{ORPHEUS_TICK}): {len(prompts)} x {ORPHEUS_CHECK_TOKENS} tokens equal to each "
        f"request's sequential run; each slot's logits at decode steps {ORPHEUS_CHECK_STEPS} "
        f"against its sequential run: max|d| {max(g[0] for g in wave):.3e}, what the layers "
        f"add at least {min(g[2] for g in wave):.3f}, worst share of its bar {worst:.3f}; "
        f"planted faults part them by {', '.join(f'{v:.3e} ({k})' for k, v in faults.items())} "
        f"({time.perf_counter() - t1:.1f} s)")
    if (outs != [o for o, _, _ in seq] or len(rows) != len(prompts) * len(ORPHEUS_CHECK_STEPS)
            or not within(wave)):
        raise SystemExit("chip_smoke: the two-layer batched wave parts from its sequential runs")
    del card
    return {"logits_max_abs_err": max(g[0] for g in gaps),
            "logits_peak": min(g[1] for g in gaps), "layers_add": min(g[2] for g in gaps),
            "off_by_one_gap": max(g[0] for g in fault), "tokens": toks,
            "batched_max_abs_err": max(g[0] for g in wave),
            "batched_layers_add": min(g[2] for g in wave), "batched_fault_gaps": faults,
            "wall_s": time.perf_counter() - t0}


def orpheus_batched(model, prompts) -> dict:
    """`make_batcher` (an LMContinuousBatcher) at bench_snac_lm_continuous's
    settings: four distinct prompts (each text's prompt entering the
    planted cycle at its own frame), each held to its sequential greedy
    `generate_tokens`; tokens/s and the speedup over sequential; launches
    held to the code's count."""
    from mlx_audio_tpu_torch.lm.continuous import _bucket
    from mlx_audio_tpu_torch.lm.generate import generate_tokens
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    with torch.inference_mode():  # the model is warm: phase 13 has run it
        t0 = time.perf_counter()
        seq = [generate_tokens(model, p, max_tokens=ORPHEUS_BATCH_TOKENS)[0][0].tolist()
               for p in prompts]
        seq_s = time.perf_counter() - t0
    batcher = model.make_batcher(slots=ORPHEUS_SLOTS, max_len=ORPHEUS_POOL_LEN,
                                 tick_tokens=ORPHEUS_TICK)
    try:
        batcher.warmup()
        qk.reset_launches()
        ticks0 = batcher.dispatch_count
        t0 = time.perf_counter()
        outs = results_in_time([batcher.submit(p, max_tokens=ORPHEUS_BATCH_TOKENS)
                                for p in prompts])
        bat_s = time.perf_counter() - t0
        ticks = batcher.dispatch_count - ticks0
    finally:
        batcher.close()
    layers = model.config.num_hidden_layers
    predicted = orpheus_launches(layers, [(_bucket(len(p)), 1) for p in prompts]
                                 + [(ORPHEUS_SLOTS, ticks * ORPHEUS_TICK)])
    got = held_launches("batched wave", predicted)
    if outs != seq or len({tuple(o) for o in outs}) != len(outs):
        raise SystemExit("chip_smoke: batched Orpheus tokens differ from sequential, or the "
                         "four requests' tokens are not distinct")
    total = sum(len(o) for o in outs)
    log(f"[orpheus] LMContinuousBatcher ({ORPHEUS_SLOTS} slots, tick {ORPHEUS_TICK}, pool "
        f"{ORPHEUS_POOL_LEN}): {len(outs)} x {ORPHEUS_BATCH_TOKENS} tokens in {bat_s:.4f} s "
        f"({total / bat_s:.1f} tokens/s aggregate, {ticks} ticks), sequential {seq_s:.4f} s "
        f"({total / seq_s:.1f} tokens/s): speedup {seq_s / bat_s:.2f}x; every request's "
        f"tokens equal its sequential greedy tokens")
    return {"tokens_per_s": total / bat_s, "sequential_tokens_per_s": total / seq_s,
            "batched_wall_s": bat_s, "sequential_wall_s": seq_s, "speedup": seq_s / bat_s,
            "ticks": ticks, "launches": got}


def orpheus_served(path: Path, want: bytes) -> dict:
    """One greedy speech request through `server.py` (a stdlib server in
    process; the provider installs the model's LMContinuousBatcher and warms
    it), held int16 for int16 to the in-memory model's samples."""
    from mlx_audio_tpu_torch import server

    provider = server.ModelProvider()
    httpd = server.serve_stdlib("127.0.0.1", 0, provider)
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    name = str(path)
    try:
        rec = load_served(url, provider, name)
        body, ttfb, wall = http_speech_timed(url, {"model": name, "input": ORPHEUS_TEXT,
                                                   "temperature": 0.0,
                                                   "response_format": "wav"})
        unload_served(url, provider, name)
    finally:
        httpd.shutdown()
        httpd.server_close()
        for n in provider.list_models():
            provider.unload(n)
    if body[:4] != b"RIFF" or body[44:] != want:
        raise SystemExit(f"chip_smoke: the served Orpheus speech ({len(body)} bytes) is not "
                         f"the in-memory model's samples ({len(want)} bytes)")
    audio_s = (len(body) - 44) / 2 / SNAC_24K["sampling_rate"]
    log(f"[orpheus] served over HTTP: {audio_s:.3f} s of audio, time to first byte "
        f"{ttfb:.4f} s, wall {wall:.4f} s (load {rec['load_s']:.1f} s, batcher warm-up "
        f"{rec['warmup_s']:.1f} s); equal int16 for int16 to the in-memory samples")
    return {"ttfb_s": ttfb, "wall_s": wall, "audio_s": audio_s, **rec}


def stream_reference(snac, spoken, chunks) -> None:
    """Each streamed chunk against its own reference: one SNAC decode of its
    planted frames and the frames of decode_stream's context before them
    (8 latent frames at the first codebook's stride), past the context.
    They must be equal: the same decode of the same codes."""
    from mlx_audio_tpu_torch.tts.models.snac_lm import codes_to_layers

    frame = snac.hop_length * snac.vq_strides[0]
    ctx = 8 // snac.vq_strides[0]
    f0 = 0
    with torch.inference_mode():
        for i, audio in enumerate(chunks):
            n, rest = divmod(len(audio), frame)
            c0 = max(0, f0 - ctx)
            want = snac.decode(codes_to_layers(frame_codes(spoken[c0:f0 + n])))
            want = want[..., (f0 - c0) * frame:].float().cpu().numpy().reshape(-1)
            if rest or not np.array_equal(audio, want):
                raise SystemExit(f"chip_smoke: streamed chunk {i} ({len(audio)} samples) is "
                                 f"not one decode of frames {f0}-{f0 + n} past their context")
            f0 += n
    if f0 != len(spoken):
        raise SystemExit(f"chip_smoke: the stream decoded {f0} frames of {len(spoken)}")


def snac_checks(snac, codes) -> dict:
    """SNAC 24 kHz alone: the planted frames decoded on the card against the
    CPU in float32 (TF32 off, the same noise draws), at phase 3's bar; and
    `decode_stream` in chunks of 8 frames, each chunk's samples equal to one
    decode of its context and codes past the context."""
    from mlx_audio_tpu_torch.codec.models import SNAC
    from mlx_audio_tpu_torch.tts.models.snac_lm import codes_to_layers

    def noise():  # one CPU stream a decode, on either device
        g = torch.Generator().manual_seed(0)
        return lambda shape: torch.randn(shape, generator=g)

    layers = codes_to_layers(frame_codes(codes))
    cpu = SNAC(**SNAC_24K, device="cpu")
    cpu.load_state_dict(snac.state_dict())
    t0 = time.perf_counter()
    card_audio = snac.decode(layers, noise_fn=noise()).cpu()
    card_s = time.perf_counter() - t0
    cpu_audio = cpu.decode(layers, noise_fn=noise())
    d = (card_audio - cpu_audio).abs().max().item()
    peak = cpu_audio.abs().max().item()
    frame = snac.hop_length * snac.vq_strides[0]
    if card_audio.shape != (1, 1, frame * len(codes)) or d > CARD_VS_CPU_ATOL or peak < 0.1:
        raise SystemExit(f"chip_smoke: SNAC decode {tuple(card_audio.shape)}, card against "
                         f"CPU max|d| {d:.3e}")
    chunks, ctx, gap = [], None, 0.0
    full = snac.decode(layers)
    ctx_s = 8 * snac.hop_length
    for f0 in range(0, len(codes), 8):
        part = codes_to_layers(frame_codes(codes[f0:f0 + 8]))
        audio, new_ctx = snac.decode_stream(part, ctx)
        if ctx is not None:
            comb = [torch.cat([p[:, -max(1, 8 // s):].cpu(), n], dim=1)
                    for p, n, s in zip(ctx, part, snac.vq_strides)]
            want = snac.decode(comb)[..., ctx_s:]
            if not torch.equal(audio, want):
                raise SystemExit(f"chip_smoke: SNAC decode_stream at frame {f0} is not one "
                                 f"decode past its context")
        chunks.append(audio)
        ctx = new_ctx
    joined = torch.cat(chunks, dim=-1)
    gap = (joined - full).abs().max().item()
    if joined.shape != full.shape:
        raise SystemExit(f"chip_smoke: SNAC stream {tuple(joined.shape)} against one decode "
                         f"{tuple(full.shape)}")
    log(f"[snac] 24 kHz decode of {len(codes)} frames on the card {card_s:.4f} s; card "
        f"against CPU float32 max|d| {d:.3e} (peak {peak:.4f}, bar {CARD_VS_CPU_ATOL:g}); "
        f"decode_stream in 8-frame chunks: each chunk equal to one decode of its context "
        f"past the context; joined against one decode of all, max|d| {gap:.3e} (the "
        f"context covers part of the receptive field)")
    return {"max_abs_err": d, "peak": peak, "decode_s": card_s, "stream_gap": gap}


def xvector_checks(keep) -> dict:
    """Qwen3-TTS Base with the ECAPA-TDNN speaker encoder: the x-vector card
    against CPU in float32 (a shallow model at full width, TF32 off), then
    one XVEC_FRAMES-frame synthesis of the int4 model with `ref_audio` and no
    `ref_text`."""
    from mlx_audio_tpu_torch.nn.module import cast_floats, init_weights
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.config import Qwen3TTSSpeakerEncoderConfig
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speaker_encoder import (
        Qwen3TTSSpeakerEncoder)

    sr = 24000
    t = np.arange(3 * sr) / sr
    rng = np.random.default_rng(7)
    ref = (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 3 * t))
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    depth = dict(talker=2, code_predictor=1, codec=1)
    cpu = qwen_model(4, device="cpu", dtype=torch.float32, seed=1, speaker=True, **depth)
    card = qwen_model(4, device="cuda", dtype=torch.float32, seed=2, speaker=True, **depth)
    card.load_state_dict(cpu.state_dict())
    e_cpu = cpu.extract_speaker_embedding(ref)
    e_card = card.extract_speaker_embedding(ref).cpu()
    d = (e_card - e_cpu).abs().max().item()
    peak = e_cpu.abs().max().item()
    log(f"[xvector] speaker embedding {tuple(e_card.shape)}, float32, card against CPU max|d| "
        f"{d:.3e} of peak {peak:.3f} (bar {CARD_VS_CPU_ATOL:g} of it)")
    if e_card.shape != (1, 1, 1024) or d > CARD_VS_CPU_ATOL * peak:
        raise SystemExit("chip_smoke: the x-vector parts card from CPU")
    del cpu, card
    model = keep.get("qwen3_int4") or qwen_model(4)
    if model.speaker_encoder is None:  # phase 5's model: give it a Base speaker encoder
        cfg = Qwen3TTSSpeakerEncoderConfig()
        model.config.speaker_encoder_config = cfg
        model.speaker_encoder = Qwen3TTSSpeakerEncoder(cfg, device="cuda")
        init_weights(model.speaker_encoder, torch.Generator(device="cuda").manual_seed(3))
        cast_floats(model.speaker_encoder, torch.bfloat16)
    with_ref = model._prepare_generation_inputs(QWEN_TEXT, ref_audio=ref)[0].shape[1]
    without = model._prepare_generation_inputs(QWEN_TEXT)[0].shape[1]
    t0 = time.perf_counter()
    res = list(model.generate(QWEN_TEXT, ref_audio=ref, max_tokens=XVEC_FRAMES,
                              min_tokens=XVEC_FRAMES, temperature=0.9, top_k=50))
    wall = time.perf_counter() - t0
    up = model.speech_tokenizer.decode_upsample_rate
    if (with_ref != without + 1 or len(res) != 1 or res[0].token_count != XVEC_FRAMES
            or res[0].audio.shape != (XVEC_FRAMES * up,) or not np.isfinite(res[0].audio).all()):
        raise SystemExit(f"chip_smoke: x-vector synthesis: prompt {with_ref} vs {without} "
                         f"positions, {[r.token_count for r in res]} frames")
    log(f"[xvector] Qwen3-TTS int4 Base, ref_audio without ref_text: the speaker's x-vector "
        f"takes one prompt position ({with_ref} against {without}); {XVEC_FRAMES} frames in "
        f"{wall:.4f} s")
    return {"max_abs_err": d, "peak": peak, "synthesis_s": wall}


def phase_orpheus(smi: str, keep) -> dict:
    """Phase 13 (see the module docstring)."""
    from mlx_audio_tpu_torch.codec.models import SNAC
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.tts.models.llama import Model as Orpheus
    from mlx_audio_tpu_torch.tts.models.snac_lm import codes_to_layers

    for k in [k for k in keep if k != "qwen3_int4"]:  # the last phase: free the card
        del keep[k]
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):  # the phase's own clock, for its share of the time limit
        log(f"[orpheus] {time.perf_counter() - t_phase:.1f} s into phase 13 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="orpheus-"))
    try:
        path, reduced = tmp / "orpheus-3b-int4", tmp / "orpheus-3b-int4-2layer"
        succ, spoken, cycle = orpheus_successors(ORPHEUS_CFG["vocab_size"])
        write_s, nbytes = write_orpheus(path, reduced, succ)
        model, load_s = timed_load(str(path))
        layers = model.config.num_hidden_layers
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[orpheus] Orpheus-3B int4 g64 (every Linear, fused q/k/v and gate/up; bf16 "
            f"embedding and activations; llama3 rope): {n_params / 1e6:.1f} M stored values, "
            f"{nbytes / 1e9:.3f} GB written in {write_s:.1f} s (with the two-layer copy), "
            f"loaded in {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} GB/s)")
        snac = SNAC(**SNAC_24K, device="cuda", seed=3)
        # seeded weights leave the samples ~1e-4: the output layer is scaled
        # so that the planted frames reach 0.3, which the card-against-CPU
        # bar and the served int16 samples can resolve
        with torch.no_grad():
            quiet = snac.decode(codes_to_layers(frame_codes(spoken))).abs().max().item()
            snac.decoder.model[-1].weight.mul_(0.3 / quiet)
        log(f"[snac] 24 kHz at the published widths, seeded: output layer scaled by "
            f"{0.3 / quiet:.1f} (peak {quiet:.3e} before)")
        model.set_runtime(codec=snac)
        ids = model.prepare_input_ids(ORPHEUS_TEXT)
        want_codes = frame_codes(spoken)
        n_gen = 2 + len(want_codes) + 1  # SOA, SOS, the codes, END_OF_SPEECH
        seen = []
        decode = model.decode_audio
        model.decode_audio = lambda codes: (seen.append(list(codes)), decode(codes))[1]

        def run(**kw):
            kw = dict(dict(max_tokens=ORPHEUS_MAX_TOKENS), **kw)
            with torch.inference_mode():
                out = list(model.generate(ORPHEUS_TEXT, temperature=0.0, **kw))
            torch.cuda.synchronize()
            return out

        calls = decode_calls(n_gen, ORPHEUS_MAX_TOKENS, ORPHEUS_MAX_TOKENS)
        predicted = orpheus_launches(layers, [(len(ids), 1), (1, calls)])
        run()  # warm-up
        walls = []
        for _ in range(ORPHEUS_TIMED):
            qk.reset_launches()
            t0 = time.perf_counter()
            res = run()
            walls.append(time.perf_counter() - t0)
            launches = held_launches("generate", predicted)
        audio = res[0].audio
        audio_s = len(audio) / model.sample_rate
        if (len(res) != 1 or res[0].token_count != n_gen or seen[-1] != want_codes
                or audio.shape != (snac.hop_length * snac.vq_strides[0] * ORPHEUS_SPOKEN,)
                or not np.isfinite(audio).all() or np.abs(audio).max() > 1.0):
            raise SystemExit(f"chip_smoke: Orpheus generate gave {[r.token_count for r in res]}"
                             f" tokens, audio {audio.shape}, codes not the planted frames")
        wall = statistics.median(walls)
        log(f"[orpheus] generate (greedy, repetition penalty 1.3 over 20), prompt {len(ids)} "
            f"tokens: {n_gen} tokens to END_OF_SPEECH, {audio_s:.4f} s of audio, wall median "
            f"{wall:.4f} s of {walls} (RTF {wall / audio_s:.4f}, {n_gen / wall:.1f} tokens/s), "
            f"{calls} decode calls ({smi})")
        mark("timed generate")
        # profiled on ORPHEUS_PROFILE_TOKENS: the profiler's post-processing
        # grows with the ~1,400 launches a decode step
        busy_us, kernels = profile_one_run(lambda: run(max_tokens=ORPHEUS_PROFILE_TOKENS),
                                           f"one Orpheus generate of {ORPHEUS_PROFILE_TOKENS} "
                                           f"tokens")
        mark("the profiled generate")
        prof = dict(profile_one_run.last)
        prof["port_kernels"] = {k: {"launches": n, "device_ms": us / 1e3}
                                for k, (n, us) in kernels.items()}

        qk.reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            stream = model.generate(ORPHEUS_TEXT, temperature=0.0, max_tokens=ORPHEUS_MAX_TOKENS,
                                    stream=True, streaming_interval=ORPHEUS_STREAM_INTERVAL)
            first = next(stream)
            ttfa = time.perf_counter() - t0
            chunks = [first] + list(stream)
        stream_s = time.perf_counter() - t0
        joined = np.concatenate([c.audio for c in chunks])
        held_launches("stream", orpheus_launches(layers, [(len(ids), 1), (1, decode_calls(
            n_gen, ORPHEUS_MAX_TOKENS, 32))]))
        if joined.shape != audio.shape or not np.isfinite(joined).all():
            raise SystemExit(f"chip_smoke: the streamed Orpheus audio {joined.shape} against "
                             f"{audio.shape}")
        stream_reference(snac, spoken, [c.audio for c in chunks])
        log(f"[orpheus] stream=True, {ORPHEUS_STREAM_INTERVAL} s interval: time to first audio "
            f"{ttfa:.4f} s ({len(chunks)} chunks of {[len(c.audio) for c in chunks]} samples, "
            f"wall {stream_s:.4f} s); each chunk equal to one decode of its planted frames "
            f"past its context; joined against one decode of all: max|d| "
            f"{np.abs(joined - audio).max():.3e} (the context covers part of the receptive "
            f"field)")

        mark("the stream")
        prompts = wave_prompts(model, cycle)
        cpu = orpheus_two_layer(reduced, ids, prompts)
        mark("the two-layer copy")
        batched = orpheus_batched(model, prompts)
        mark("the batched wave")
        # the served request decodes to END_OF_SPEECH under the default cap;
        # the timed run's cap came after it too, so its samples are the same
        served = orpheus_served(path, pcm16(audio))
        mark("the served request")
        snac_rec = snac_checks(snac, spoken)
        mark("SNAC")
        del model
        Orpheus._codec = None
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    xvec = xvector_checks(keep)
    mark("the x-vector checks")
    rec = {"write_s": write_s, "checkpoint_bytes": nbytes, "load_s": load_s,
           "prompt_tokens": len(ids), "generated_tokens": n_gen, "audio_s": audio_s,
           "wall_s": wall, "walls_s": walls, "rtf": wall / audio_s, "decode_calls": calls,
           "launches": launches, "profile_tokens": ORPHEUS_PROFILE_TOKENS, "profile": prof,
           "ttfa_s": ttfa, "stream_wall_s": stream_s,
           "card_vs_cpu": cpu, "batched": batched, "served": served, "snac": snac_rec,
           "xvector": xvec, "phase_s": time.perf_counter() - t_phase}
    log(f"[orpheus] phase 13 wall {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 14: Sesame / CSM-1B and the Mimi codec
# ---------------------------------------------------------------------------

CSM_TEXT = "The quick brown fox jumps over the lazy dog."
CSM_REF_TEXT = "A seeded reference line that the model never heard."
CSM_REF_S = 5.0
CSM_MAX_MS = 2560  # 32 frames of 80 ms (64 until phase 18 came)
CSM_FRAMES = 32
CSM_SAMPLED_MS = 1280  # the sampled run: 16 frames (64 until phase 17 came)
CSM_STREAM_INTERVAL = 0.5  # 6 frames a chunk
CSM_STREAM_MS = 1280  # the stream: 16 frames (64 until phase 17 came, 32 until 19)
CSM_PROFILE_MS = 640  # 8 frames, profiled
CSM_WARM_MS = 320  # 4 frames warm the path (the eager loop compiles nothing)
CSM_TIMED = 1
# the two-layer float32 copy, card against CPU: frames checked, and the
# share of what the layers add that a logit may part by (phase 13's bar)
CSM_CPU_FRAMES = 4
CSM_LAYER_BAR = 1e-2
# the audio head's spread: logits of O(1) over the decoder's 1024 normed
# dimensions (the JAX package starts it at zero, which decodes every
# codebook past the first to 0)
CSM_HEAD_STD = 1024 ** -0.5
# bench.py's bench_sesame_serving: 8 streams, a 1024-row pool, 48-token
# prompts, sampled at 0.9 / top-k 50, cut to one tick of 4 frames a stream.
# That cuts frames and changes a serving setting: the tick is 4 where
# bench.py's is 8 (a tick always runs its full count of frames, so 4 frames
# in a tick of 8 would cost what 8 do). Earlier: bench.py's 64 frames in
# ticks of 8 until phase 15 came, when the sequential run alone took ~100 s
# at ~190 ms a frame; 32 until phase 17 came, ~54 s; 16, two ticks, until
# phase 19 came; 8, one tick of 8, until phase 20 came. Greedy streams of 2
# frames (4 until 19) for the batched-against-sequential check
CSM_STREAMS, CSM_SERVE_FRAMES, CSM_TICK, CSM_POOL, CSM_PROMPT = 8, 4, 4, 1024, 48
CSM_GREEDY_FRAMES = 2  # 4 until phase 19 came
CSM_INT4_FRAMES = 16
CSM_SERVED_FRAMES = 16
MIMI_FRAMES = 64
ICL_FRAMES = 16
ICL_REF_TEXT = "A short reference line."


def csm_upstream_key(k: str) -> str:
    """The JAX package's name of a CSM parameter → the upstream
    checkpoint's (what `Model.sanitize` maps back)."""
    k = k[len("model."):]
    k = k.replace("self_attn", "attn").replace("o_proj", "output_proj")
    k = k.replace("gate_proj", "w1").replace("down_proj", "w2").replace("up_proj", "w3")
    k = k.replace("input_layernorm", "sa_norm").replace("post_attention_layernorm", "mlp_norm")
    if k.endswith("norm.weight"):
        k = k[: -len(".weight")] + ".scale"
    return k


def mimi_kyutai_key(k: str) -> str:
    """The JAX package's name of a Mimi parameter → kyutai's (the inverse
    of `Mimi.sanitize`'s index map, for the published four SEANet ratios)."""
    k = k.replace(".block.1.", ".block.3.").replace(".block.0.", ".block.1.")
    for side in ("encoder", "decoder"):
        k = k.replace(f"{side}.init_conv1d.", f"{side}.model.0.")
        k = k.replace(f"{side}.final_conv1d.", f"{side}.model.14.")
    for pat, at in ((r"encoder\.layers\.(\d)\.residuals\.0\.", ("encoder", 1)),
                    (r"encoder\.layers\.(\d)\.downsample\.", ("encoder", 3)),
                    (r"decoder\.layers\.(\d)\.upsample\.", ("decoder", 2)),
                    (r"decoder\.layers\.(\d)\.residuals\.0\.", ("decoder", 3))):
        k = re.sub(pat, lambda m, a=at: f"{a[0]}.model.{a[1] + 3 * int(m.group(1))}.", k)
    k = k.replace(".conv.", ".conv.conv.").replace(".convtr.", ".convtr.convtr.")
    k = k.replace("transformer_layers.", "transformer.layers.")
    k = k.replace(".gating.linear", ".linear").replace(".in_proj.weight", ".in_proj_weight")
    return k.replace(".codebook.", "._codebook.")


def mimi_torch_layout(k: str, v):
    """A JAX-layout Mimi conv weight in torch's layout: Conv1d (O, I, K),
    ConvTranspose1d (I, O/g, K); the top-level upsample is depthwise."""
    if v.ndim != 3:
        return v
    t = torch.as_tensor(v)
    if ".convtr." in k:
        o, kk, i_g = t.shape
        g = o // i_g if k.startswith("upsample.") else 1
        return (t.reshape(g, o // g, kk, i_g).permute(0, 3, 1, 2)
                .reshape(g * i_g, o // g, kk).contiguous())
    return t.permute(0, 2, 1).contiguous()


def csm_config():
    """CSM-1B's published configuration, `ModelConfig()`."""
    from mlx_audio_tpu_torch.tts.models.sesame.sesame import ModelConfig

    return ModelConfig()


def csm_seeded(seed: int = 14):
    """CSM-1B at the published widths on the card, in bf16, with weights
    drawn from `seed` (the audio head too, at CSM_HEAD_STD). The heads draw
    all 2051 codes; Mimi decodes the three past its 2048 bins as its last
    one, as the JAX package does."""
    from mlx_audio_tpu_torch.nn.module import cast_floats
    from mlx_audio_tpu_torch.tts.models.sesame import Model

    model = Model(csm_config(), device="cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        model.model.audio_head.normal_(0.0, CSM_HEAD_STD, generator=g)
    return cast_floats(model, torch.bfloat16)


def mimi_seeded(seed: int = 15):
    """Mimi at `mimi_202407(32)` on the card in float32, the codebooks
    drawn from `seed` (the JAX package starts them at zero)."""
    from mlx_audio_tpu_torch.codec.models.mimi.mimi import Mimi, mimi_202407

    mimi = Mimi(mimi_202407(32), device="cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in mimi.named_parameters():
            if name.endswith("embedding_sum"):
                p.normal_(0.0, 1.0, generator=g)
    return mimi


def write_csm(path: Path, reduced: Path, model, mimi) -> tuple:
    """The CSM checkpoint in the upstream key layout (config.json with
    model_type "csm", a Llama-3 style tokenizer.json and its
    tokenizer_config.json, Mimi's safetensors in kyutai's layout in mimi/,
    where the model looks for its codec), and a
    copy whose backbone and depth decoder keep two layers each. → (seconds,
    bytes)."""
    from mlx_audio_tpu_torch import convert, safetensors_io
    from mlx_audio_tpu_torch.codec.models.mimi.mimi import DEFAULT_FILENAME
    from mlx_audio_tpu_torch.nn.module import flatten_params

    t0 = time.perf_counter()
    flat = {csm_upstream_key(k): v for k, v in flatten_params(model).items()}
    keep = re.compile(r"^(backbone|decoder)\.layers\.(\d+)\.")
    two = {k: v for k, v in flat.items()
           if not (m := keep.match(k)) or int(m.group(2)) < 2}
    cfg = dataclass_dict(model.config)
    for where, weights, c in ((path, flat, cfg), (reduced, two, dict(
            cfg, num_hidden_layers=2,
            depth_decoder_config=dict(cfg["depth_decoder_config"], num_hidden_layers=2)))):
        convert.save_model(where, weights, dict(c, model_type="csm"))
        write_tokenizer_json(where, "llama3")
        (where / "tokenizer_config.json").write_text(json.dumps(
            {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"}))
    kyutai = {mimi_kyutai_key(k): mimi_torch_layout(k, v)
              for k, v in flatten_params(mimi).items()}
    (path / "mimi").mkdir()
    safetensors_io.save_file(kyutai, path / "mimi" / DEFAULT_FILENAME)
    del flat, two
    return time.perf_counter() - t0, checkpoint_bytes(path) + checkpoint_bytes(path / "mimi")


def dataclass_dict(cfg) -> dict:
    import dataclasses

    out = dataclasses.asdict(cfg)
    out.pop("model_path", None)
    return out


def csm_prompt(model, seed: int = 5, text_len: int = 20, audio_frames: int = 12):
    """A seeded prompt of `text_len` text tokens then `audio_frames` frames
    of audio codes, as token and mask frames (1, T, 33) on the host."""
    K = model.config.audio_num_codebooks
    rng = np.random.default_rng(seed)
    T = text_len + audio_frames
    tokens = np.zeros((1, T, K + 1), np.int64)
    mask = np.zeros((1, T, K + 1), bool)
    tokens[0, :text_len, -1] = rng.integers(5, 128000, text_len)
    mask[0, :text_len, -1] = True
    tokens[0, text_len:, :K] = rng.integers(1, model.config.audio_vocab_size, (audio_frames, K))
    mask[0, text_len:, :K] = True
    return tokens, mask


def csm_logit_rows(model, tokens, mask, frames: int, seed: int = 0):
    """Greedy frames of the direct loop, keeping every logits row the
    frames were drawn from (codebook 0's, then the depth decoder's) and the
    same row with the layers skipped (what the layers add is the distance
    between them). → (frames (n, K), [(logits, plant)] on the host)."""
    from mlx_audio_tpu_torch.tts.models.sesame import sesame as ses

    sm = model.model
    V = sm.args.audio_vocab_size
    rows = []

    def rec(logits, _gen):
        rows.append(logits[0].float().cpu())
        return torch.argmax(logits, dim=-1)

    dev = model.device
    with torch.inference_mode():
        tok, msk = torch.as_tensor(tokens, device=dev), torch.as_tensor(mask, device=dev)
        caches = sm.make_backbone_caches(1, tokens.shape[1] + frames + 1)
        h = ses._prefill(sm, caches, tok, msk)
        gen = torch.Generator(device=dev).manual_seed(seed)
        out, n = ses._generate_frames(sm, caches, h, gen, frames, 0.0, 0, sampler=rec)
        out = out[0, :n]
        head = sm.audio_head_f32()
        plants, last = [], sm.embed_frames(tok, msk)[:, -1]
        for f in range(n):
            frame = out[f:f + 1]
            plants.append(sm.codebook0_head(sm.backbone.norm(last))[0].float().cpu())
            for i in range(1, frame.shape[1]):
                inp = sm.projection(sm.audio_embeddings(frame[:, i - 1] + (i - 1) * V))
                plants.append((sm.decoder.norm(inp).float() @ head[i - 1])[0].cpu())
            last = sm.frame_embedding(frame)[:, -1]
    return out.cpu().numpy(), list(zip(rows, plants))


def csm_gaps(got, want) -> list:
    """(max|d|, the row's peak, what the layers add) per logits row."""
    return [((g - w).abs().max().item(), w.abs().max().item(), (w - p).abs().max().item())
            for (g, _), (w, p) in zip(got, want)]


def csm_within(gaps) -> bool:
    return all(d <= CARD_VS_CPU_ATOL * peak and d <= CSM_LAYER_BAR * add
               for d, peak, add in gaps)


def csm_two_layer(reduced: Path) -> dict:
    """The two-layer copy at full width in float32 (TF32 off): greedy
    frames of the direct loop card against CPU, identical, with every
    logits row held to both bars; a planted off-by-one codebook offset (each
    codebook reading its predecessor's rows of the shared audio table) must
    break them."""
    t0 = time.perf_counter()
    cpu, cpu_load = timed_load(str(reduced), device="cpu", dtype=torch.float32)
    tokens, mask = csm_prompt(cpu)
    want_frames, want = csm_logit_rows(cpu, tokens, mask, CSM_CPU_FRAMES)
    del cpu
    card, _ = timed_load(str(reduced), device="cuda", dtype=torch.float32)
    frames, got = csm_logit_rows(card, tokens, mask, CSM_CPU_FRAMES)
    gaps = csm_gaps(got, want)
    emb = card.model.audio_embeddings
    V = card.config.audio_vocab_size
    forward = emb.forward
    emb.forward = lambda x: forward(torch.where(x >= V, x - V, x))
    try:
        bad_frames, bad = csm_logit_rows(card, tokens, mask, CSM_CPU_FRAMES)
    finally:
        del emb.forward
    fault = csm_gaps(bad, want)
    worst = max(g[0] / min(CARD_VS_CPU_ATOL * g[1], CSM_LAYER_BAR * g[2]) for g in gaps)
    log(f"[csm] two-layer copy, float32, card against CPU: {len(gaps)} logits rows "
        f"({CSM_CPU_FRAMES} frames x {card.config.audio_num_codebooks} codebooks), max|d| {max(g[0] for g in gaps):.3e}, "
        f"peaks >= {min(g[1] for g in gaps):.2f} (bar {CARD_VS_CPU_ATOL:g} of each), what the "
        f"layers add >= {min(g[2] for g in gaps):.3f} (bar {CSM_LAYER_BAR:g} of each), worst "
        f"share of its bar {worst:.3f}; greedy frames identical: "
        f"{np.array_equal(frames, want_frames)}; a planted off-by-one codebook offset parts "
        f"them by {max(g[0] for g in fault):.3e} ({time.perf_counter() - t0:.1f} s, the CPU "
        f"load {cpu_load:.1f} s)")
    if not csm_within(gaps) or not np.array_equal(frames, want_frames) \
            or frames.shape != (CSM_CPU_FRAMES, card.config.audio_num_codebooks):
        raise SystemExit("chip_smoke: the CSM two-layer copy parts card from CPU")
    if csm_within(fault) and np.array_equal(bad_frames, want_frames):
        raise SystemExit("chip_smoke: the CSM check passes an off-by-one codebook offset")
    del card
    return {"logits_max_abs_err": max(g[0] for g in gaps), "layers_add": min(g[2] for g in gaps),
            "worst_share_of_bar": worst, "offset_fault_gap": max(g[0] for g in fault),
            "frames": frames.tolist(), "wall_s": time.perf_counter() - t0}


def mimi_checks(mimi, ref) -> dict:
    """Mimi at the published widths, float32: the decode of MIMI_FRAMES
    seeded frames card against CPU; the streaming decode (a frame a step,
    the 250-slot rings not yet wrapped) against the offline one; a planted
    ring fault (each position's keys written one slot on) must part them; the
    reference's codes card against CPU (counted)."""
    from mlx_audio_tpu_torch.codec.models.mimi.mimi import Mimi, MimiStreamingDecoder
    from mlx_audio_tpu_torch.lm import cache as lcache

    t0 = time.perf_counter()
    cpu = Mimi(mimi.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in mimi.state_dict().items()})
    nq, bins = mimi.cfg.quantizer_nq, mimi.cfg.quantizer_bins
    codes = np.random.default_rng(11).integers(0, bins, (1, nq, MIMI_FRAMES))
    card_wav = mimi.decode(codes).cpu()
    cpu_wav = cpu.decode(codes)
    peak = cpu_wav.abs().max().item()
    d = (card_wav - cpu_wav).abs().max().item()

    def streamed():
        dec = MimiStreamingDecoder(mimi)
        return torch.cat([dec.decode_frames(codes[0, :, i:i + 1]).cpu()
                          for i in range(MIMI_FRAMES)], dim=-1)

    ts = time.perf_counter()
    stream = streamed()
    stream_s = time.perf_counter() - ts
    ds = (stream - card_wav).abs().max().item()
    update = lcache.RingKVCache.update

    def off_by_one(self, k, v):  # position p's keys and values land in slot p + 1
        written = self.pos + torch.arange(k.shape[2], device=k.device)
        self.k[:, :, (written + 1) % self.window] = k.to(self.k.dtype)
        self.v[:, :, (written + 1) % self.window] = v.to(self.v.dtype)
        self.pos_buf[written % self.window] = written
        self.pos += k.shape[2]
        return self.k, self.v, self

    lcache.RingKVCache.update = off_by_one
    try:
        bad = (streamed() - card_wav).abs().max().item()
    finally:
        lcache.RingKVCache.update = update
    enc_card = mimi.encode(ref[None, None]).cpu().numpy()
    enc_cpu = cpu.encode(ref[None, None]).numpy()
    agree = float((enc_card == enc_cpu).mean())
    log(f"[mimi] mimi_202407(32), float32: decode of {MIMI_FRAMES} frames card against CPU "
        f"max|d| {d:.3e} of peak {peak:.3f} (bar {CARD_VS_CPU_ATOL:g} of it); streaming decode "
        f"a frame a step ({stream_s:.3f} s) against offline max|d| {ds:.3e} (same bar); keys "
        f"written one ring slot on part them by {bad:.3e}; the {CSM_REF_S:g} s "
        f"reference's codes {enc_card.shape} agree card against CPU at {100 * agree:.2f}% "
        f"({time.perf_counter() - t0:.1f} s)")
    if (d > CARD_VS_CPU_ATOL * peak or ds > CARD_VS_CPU_ATOL * peak
            or card_wav.shape != (1, 1, MIMI_FRAMES * mimi.frame_size)):
        raise SystemExit("chip_smoke: Mimi parts card from CPU, or streaming from offline")
    if bad <= CARD_VS_CPU_ATOL * peak:
        raise SystemExit("chip_smoke: the Mimi streaming check passes keys written one ring "
                         "slot on")
    return {"decode_max_abs_err": d, "peak": peak, "stream_max_abs_err": ds,
            "stream_s": stream_s, "ring_fault_gap": bad, "encode_agreement": agree}


def csm_reference(seconds=CSM_REF_S, seed=12, sr: int = 24000) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 160 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def csm_generate(csm, mimi, ref, smi) -> dict:
    """`Model.generate` with the seeded reference (Mimi-encoded on the card)
    and its text: greedy at CSM_MAX_MS and at temperature 0.9 / top-k 50 at
    CSM_SAMPLED_MS; wall, frames/s, RTF; one profiled run; the stream at
    0.5 s to CSM_STREAM_MS, each chunk's frames the monolithic decode's; the
    watermark found on the output and not on unmarked audio."""
    from mlx_audio_tpu_torch.tts.models.sesame import watermarking as wm

    seen = {"offline": [], "stream": []}
    decode, step = mimi.decode, mimi.decode_step
    mimi.decode = lambda c: (seen["offline"].append(np.asarray(torch.as_tensor(c).cpu())),
                             decode(c))[1]
    mimi.decode_step = lambda c, s: (seen["stream"].append(np.asarray(torch.as_tensor(c).cpu())),
                                     step(c, s))[1]

    def run(**kw):
        kw = dict(dict(ref_audio=ref, ref_text=CSM_REF_TEXT, max_audio_length_ms=CSM_MAX_MS),
                  **kw)
        with torch.inference_mode():
            out = list(csm.generate(CSM_TEXT, **kw))
        torch.cuda.synchronize()
        return out

    try:
        run(temperature=0.0, max_audio_length_ms=CSM_WARM_MS)  # warm-up
        walls, res = [], None
        for _ in range(CSM_TIMED):
            seen["offline"].clear()
            t0 = time.perf_counter()
            res = run(temperature=0.0)
            walls.append(time.perf_counter() - t0)
        greedy = seen["offline"][-1][0].T  # (n, 32)
        t0 = time.perf_counter()
        sampled = run(temperature=0.9, top_k=50, seed=1, max_audio_length_ms=CSM_SAMPLED_MS)
        sampled_s = time.perf_counter() - t0
        _, kernels = profile_one_run(lambda: run(temperature=0.0,
                                                 max_audio_length_ms=CSM_PROFILE_MS),
                                     f"one CSM-1B generate of {CSM_PROFILE_MS // 80} frames")
        prof = dict(profile_one_run.last)
        seen["stream"].clear()
        t0 = time.perf_counter()
        with torch.inference_mode():
            gen = csm.generate(CSM_TEXT, ref_audio=ref, ref_text=CSM_REF_TEXT,
                               max_audio_length_ms=CSM_STREAM_MS, temperature=0.0,
                               stream=True, streaming_interval=CSM_STREAM_INTERVAL,
                               apply_watermark=False)
            first = next(gen)
            ttfa = time.perf_counter() - t0
            chunks = [first] + list(gen)
        stream_s = time.perf_counter() - t0
    finally:
        del mimi.decode, mimi.decode_step
    streamed = np.concatenate([c[0].T for c in seen["stream"]])
    audio = res[0].audio
    unmarked = np.concatenate([c.audio for c in chunks])
    key = wm.CSM_1B_GH_WATERMARK
    marked_found = wm.verify(wm.load_watermarker(), audio, 24000, key)
    plain_found = wm.verify(wm.load_watermarker(), unmarked, 24000, key)
    ref_found = wm.verify(wm.load_watermarker(), ref, 24000, key)
    wall = statistics.median(walls)
    audio_s = len(audio) / 24000
    n = res[0].token_count
    log(f"[csm] generate (greedy, ref_audio {CSM_REF_S:g} s + ref_text, watermarked), "
        f"prompt {res[0].prompt['tokens']} positions: {n} frames, {audio_s:.3f} s of audio, "
        f"wall {wall:.4f} s of {walls} ({n / wall:.2f} frames/s, RTF {wall / audio_s:.4f}); "
        f"sampled (0.9, top-k 50) {sampled[0].token_count} frames in {sampled_s:.4f} s "
        f"({sampled[0].token_count / sampled_s:.2f} frames/s) ({smi})")
    frames_prof = CSM_PROFILE_MS // 80
    log(f"[csm] profiled {frames_prof} frames: device busy {prof['device_ms']:.1f} ms of "
        f"{prof['wall_ms']:.1f} ms wall (idle share {100 * prof['idle_share']:.1f}%), "
        f"{prof['launches']} launches, {prof['launches'] / frames_prof:.0f} a frame with the "
        f"prefill, the reference's encode and the decode spread over them")
    log(f"[csm] stream=True at {CSM_STREAM_INTERVAL} s: time to first audio {ttfa:.4f} s, "
        f"{len(chunks)} chunks of {[c.token_count for c in chunks]} frames, wall "
        f"{stream_s:.4f} s; the streamed frames equal the monolithic greedy frames: "
        f"{np.array_equal(streamed, greedy[:CSM_STREAM_MS // 80])}; watermark found on the "
        f"output {marked_found}, on the unmarked stream {plain_found}, on the reference "
        f"{ref_found}")
    if (n != CSM_FRAMES or len(audio) != CSM_FRAMES * 1920 or not np.isfinite(audio).all()
            or sampled[0].token_count != CSM_SAMPLED_MS // 80
            or not np.array_equal(streamed, greedy[:CSM_STREAM_MS // 80])
            or greedy.shape != (CSM_FRAMES, csm.config.audio_num_codebooks)):
        raise SystemExit("chip_smoke: CSM generate gave the wrong frames, or the stream parts "
                         "from the monolithic decode")
    if not marked_found or plain_found or ref_found:
        raise SystemExit("chip_smoke: the watermark is not found on the output, or found on "
                         "unmarked audio")
    return {"frames": n, "audio_s": audio_s, "wall_s": wall, "walls_s": walls,
            "frames_per_s": n / wall, "rtf": wall / audio_s, "sampled_wall_s": sampled_s,
            "profile": prof, "port_kernels": {k: v[0] for k, v in kernels.items()},
            "ttfa_s": ttfa, "stream_wall_s": stream_s, "chunks": len(chunks),
            "prompt_positions": res[0].prompt["tokens"]}


def csm_serving(csm) -> dict:
    """bench.py's bench_sesame_serving on the port, with its tick cut to
    CSM_TICK (bench.py's is 8): a warm wave, then 8 streams of
    CSM_SERVE_FRAMES sampled frames one at a time and all at once through
    one `SesameBatcher` (one trial, where bench.py takes the median of 3); then
    8 greedy streams of CSM_GREEDY_FRAMES, batched against sequential
    through the same pool (identical frames)."""
    rng = np.random.default_rng(3)
    K = csm.config.audio_num_codebooks
    prompts = []
    for _ in range(CSM_STREAMS):
        toks = np.zeros((1, CSM_PROMPT, K + 1), np.int64)
        toks[:, :, -1] = rng.integers(5, 1000, CSM_PROMPT)
        mask = np.zeros((1, CSM_PROMPT, K + 1), bool)
        mask[:, :, -1] = True
        prompts.append((toks, mask))
    batcher = csm.make_batcher(slots=CSM_STREAMS, max_len=CSM_POOL, tick_frames=CSM_TICK)
    try:
        results_in_time([batcher.submit(t, m, max_frames=CSM_TICK, temp=0.9, top_k=50, seed=0)
                         for t, m in prompts])
        t0 = time.perf_counter()
        for i, (t, m) in enumerate(prompts):
            batcher.submit(t, m, max_frames=CSM_SERVE_FRAMES, temp=0.9, top_k=50,
                           seed=i).result(timeout=SERVE_TIMEOUT)
        seq_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        frames = results_in_time([batcher.submit(t, m, max_frames=CSM_SERVE_FRAMES, temp=0.9,
                                                 top_k=50, seed=i)
                                  for i, (t, m) in enumerate(prompts)])
        bat_s = time.perf_counter() - t0
        seq_greedy = [batcher.submit(t, m, max_frames=CSM_GREEDY_FRAMES, temp=0.0,
                                     top_k=0).result(timeout=SERVE_TIMEOUT)
                      for t, m in prompts]
        bat_greedy = results_in_time([batcher.submit(t, m, max_frames=CSM_GREEDY_FRAMES,
                                                     temp=0.0, top_k=0)
                                      for t, m in prompts])
    finally:
        batcher.close()
    total = sum(f.shape[0] for f in frames)
    speedup = seq_s / bat_s
    same = all(np.array_equal(a, b) for a, b in zip(seq_greedy, bat_greedy))
    log(f"[csm] bench_sesame_serving on the port ({CSM_STREAMS} streams x {CSM_SERVE_FRAMES} "
        f"sampled frames, tick {CSM_TICK}, pool {CSM_POOL}, {CSM_PROMPT}-token prompts): "
        f"sequential {seq_s:.4f} s, batched {bat_s:.4f} s (one trial): speedup {speedup:.2f}x "
        f"against bench.py's 2x target, {total / bat_s:.1f} frames/s aggregate "
        f"({total / seq_s:.1f} sequential); greedy {CSM_GREEDY_FRAMES}-frame streams batched "
        f"equal to sequential: {same}")
    if total != CSM_STREAMS * CSM_SERVE_FRAMES or not same \
            or any(f.shape != (CSM_GREEDY_FRAMES, K) for f in bat_greedy):
        raise SystemExit("chip_smoke: bench_sesame_serving lost frames, or greedy batched "
                         "frames part from sequential")
    return {"sequential_wall_s": seq_s, "batched_wall_s": bat_s, "speedup": speedup,
            "target": 2.0, "frames_per_s": total / bat_s,
            "sequential_frames_per_s": total / seq_s}


def csm_launches(cfg, prompt_rows: int, frames: int) -> dict:
    """The quantized launches of the int4 direct loop from the code: the
    prefill (M = prompt_rows) and `frames` backbone steps (M = 1), and per
    frame codebook0_head (M = 1), the projection and the depth decoder at M
    = 2 (the two-token seed) and then K - 1 steps at M = 1. Each layer's
    fused q/k/v and o_proj take qmm where `qmm_routable` admits the shape
    (the GEMV at M <= 4, the tensor-core GEMM above); its MLP the fused
    kernel where `fused_mlp_routable` admits it, else gate/up and down
    through qmm."""
    from mlx_audio_tpu_torch.nn.quantized import fused_mlp_routable, qmm_routable

    got = {"qmm": 0, "qmlp": 0, "qmm_kernel": 0, "qmm_gemv": 0, "qmm_mma": 0}

    def qmm(N, K, M, n=1):
        if qmm_routable(4, GROUP, N, K, M):
            got["qmm"] += n
            got["qmm_gemv" if M <= 4 else "qmm_mma"] += n

    def layers(D, I, heads, kv, hd, count, M, n=1):
        for _ in range(count):
            qmm((heads + 2 * kv) * hd, D, M, n)
            qmm(D, heads * hd, M, n)
            if fused_mlp_routable(4, GROUP, D, I, D, M):
                got["qmlp"] += n
            else:
                qmm(2 * I, D, M, n)
                qmm(D, I, M, n)

    d = cfg.depth_decoder_config
    K = cfg.audio_num_codebooks
    bb = (cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads,
          cfg.num_key_value_heads, cfg.head_dim, cfg.num_hidden_layers)
    dec = (d.hidden_size, d.intermediate_size, d.num_attention_heads, d.num_key_value_heads,
           d.head_dim, d.num_hidden_layers)
    layers(*bb, prompt_rows)
    layers(*bb, 1, frames)
    qmm(cfg.audio_vocab_size, cfg.hidden_size, 1, frames)  # codebook0_head
    qmm(d.hidden_size, cfg.hidden_size, 2, frames)  # the seed's projection
    layers(*dec, 2, frames)
    qmm(d.hidden_size, cfg.hidden_size, 1, frames * (K - 1))
    layers(*dec, 1, frames * (K - 1))
    return got


def csm_int4(path: Path, tmp: Path) -> dict:
    """`convert(quantize=True)` of the phase's directory (int4 g64, every
    2-D weight), loaded by `utils.load_model`, then CSM_INT4_FRAMES greedy
    frames of the direct loop after an 80-position prompt, with its
    quantized launches held to `csm_launches` (the counts set to 0 just
    before it)."""
    from mlx_audio_tpu_torch import convert
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.tts.models.sesame import sesame as ses

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        q = convert.convert(str(path), str(tmp / "csm-1b-int4"), quantize=True)
    convert_s = time.perf_counter() - t0
    model, load_s = timed_load(str(q))
    tokens, mask = csm_prompt(model, seed=6, audio_frames=60)
    dev = model.device
    with torch.inference_mode():
        tok, msk = torch.as_tensor(tokens, device=dev), torch.as_tensor(mask, device=dev)

        def loop(frames):
            caches = model.model.make_backbone_caches(1, tokens.shape[1] + frames + 1)
            h = ses._prefill(model.model, caches, tok, msk)
            gen = torch.Generator(device=dev).manual_seed(0)
            return ses._generate_frames(model.model, caches, h, gen, frames, 0.0, 0)

        loop(2)  # warm-up
        torch.cuda.synchronize()
        qk.reset_launches()
        t1 = time.perf_counter()
        frames, n = loop(CSM_INT4_FRAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    got = quant_counts(4)
    predicted = csm_launches(model.config, tokens.shape[1], CSM_INT4_FRAMES)
    codes = frames[0, :n].cpu().numpy()
    log(f"[csm] int4 g64 by convert(quantize=True) in {convert_s:.1f} s "
        f"({checkpoint_bytes(q) / 1e9:.3f} GB), loaded in {load_s:.1f} s; the direct loop, "
        f"{tokens.shape[1]}-position prompt and {n} greedy frames in {wall:.4f} s "
        f"({n / wall:.2f} frames/s): launches {got}, from the code {predicted}")
    if got != predicted or n != CSM_INT4_FRAMES or not (
            (codes >= 0) & (codes < model.config.audio_vocab_size)).all():
        raise SystemExit(f"chip_smoke: the int4 CSM launched {got}, the code says {predicted}, "
                         f"or gave {n} frames")
    del model
    shutil.rmtree(q, ignore_errors=True)
    return {"convert_s": convert_s, "load_s": load_s, "frames": n, "wall_s": wall,
            "frames_per_s": n / wall, "launches": got, "prompt_positions": tokens.shape[1]}


def csm_served(csm, path: Path, tmp: Path, ref) -> dict:
    """One streamed speech request (ref_audio as a wav path and its text,
    greedy) through `server.py` with the provider's SesameBatcher; the
    served samples equal the in-memory model's through an identical pool,
    int16 for int16. The pool is sized so that it ends the request after
    CSM_SERVED_FRAMES frames: the speech route has no frame cap."""
    from mlx_audio_tpu_torch import audio_io, server
    from mlx_audio_tpu_torch.tts.models.sesame import Model, Segment
    from mlx_audio_tpu_torch.tts.models.sesame.batcher import SesameBatcher

    wav = tmp / "csm-ref.wav"
    audio_io.write(wav, ref, 24000)
    seg = csm._tokenize_segment(Segment(speaker=0, text=f"{CSM_REF_TEXT} {CSM_TEXT}",
                                        audio=audio_io.read(wav)[0]), add_eos=False)
    pool = seg[0].shape[0] + CSM_SERVED_FRAMES + 1
    make = Model.make_batcher
    Model.make_batcher = lambda self, **kw: SesameBatcher(self, **dict(dict(max_len=pool), **kw))
    provider = server.ModelProvider()
    httpd = server.serve_stdlib("127.0.0.1", 0, provider)
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    name = str(path)
    try:
        rec = load_served(url, provider, name)
        body, ttfb, wall = http_speech_timed(url, {
            "model": name, "input": CSM_TEXT, "ref_audio": str(wav), "ref_text": CSM_REF_TEXT,
            "temperature": 0.0, "response_format": "wav",
            "streaming_interval": CSM_STREAM_INTERVAL})
        unload_served(url, provider, name)
        batcher = csm.make_batcher().install()
        try:
            with torch.inference_mode():
                want = np.concatenate([r.audio for r in csm.generate(
                    CSM_TEXT, ref_audio=str(wav), ref_text=CSM_REF_TEXT, temperature=0.0,
                    stream=True, streaming_interval=CSM_STREAM_INTERVAL)])
        finally:
            batcher.close()
    finally:
        Model.make_batcher = make
        httpd.shutdown()
        httpd.server_close()
        for n in provider.list_models():
            provider.unload(n)
    if body[:4] != b"RIFF" or body[44:] != pcm16(want) \
            or len(want) != CSM_SERVED_FRAMES * 1920:
        raise SystemExit(f"chip_smoke: the served CSM speech ({len(body)} bytes) is not the "
                         f"in-memory model's samples ({len(want)} samples)")
    log(f"[csm] served over HTTP (streamed, SesameBatcher, pool {pool}): "
        f"{len(want) / 24000:.3f} s of audio, time to first byte {ttfb:.4f} s, wall "
        f"{wall:.4f} s (load {rec['load_s']:.1f} s, batcher warm-up {rec['warmup_s']:.1f} s); "
        f"equal int16 for int16 to the in-memory model's")
    return {"ttfb_s": ttfb, "wall_s": wall, "audio_s": len(want) / 24000, **rec}


def icl_checks(keep) -> dict:
    """Qwen3-TTS ICL on phase 13's int4 Base model: a speech-tokenizer
    encoder at `Qwen3TTSTokenizerEncoderConfig()`'s widths (seeded), its
    reference codes card against CPU in float32 (identical), then
    ICL_FRAMES frames of ICL synthesis with ref_audio + ref_text."""
    from mlx_audio_tpu_torch.nn.module import cast_floats
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer import (
        Qwen3TTSSpeechTokenizerEncoder)

    t0 = time.perf_counter()
    model = keep.get("qwen3_int4") or qwen_model(4)
    enc = model.speech_tokenizer.build_encoder(seed=21)
    g = torch.Generator(device="cuda").manual_seed(22)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith("embedding_sum"):
                p.normal_(0.0, 1.0, generator=g)
    cfg = model.config.tokenizer_config.encoder_config
    state = {k: v.float().cpu() for k, v in enc.state_dict().items()}
    ref = csm_reference(3.0, seed=13)
    codes = {}
    for side, dev in (("cpu", "cpu"), ("card", "cuda")):
        e = cast_floats(Qwen3TTSSpeechTokenizerEncoder(cfg, device=dev), torch.float32)
        e.load_state_dict(state)
        with torch.inference_mode():
            codes[side] = e.encode(torch.as_tensor(ref, device=dev)[None, None]).cpu().numpy()
        del e
    t1 = time.perf_counter()
    res = list(model.generate(QWEN_TEXT, ref_audio=ref, ref_text=ICL_REF_TEXT,
                              max_tokens=ICL_FRAMES, temperature=0.9, top_k=50))
    wall = time.perf_counter() - t1
    n = sum(r.token_count for r in res)
    log(f"[icl] Qwen3-TTS int4 Base, speech-tokenizer encoder at the published widths "
        f"(seeded): reference codes {codes['cpu'].shape} card against CPU (float32) identical: "
        f"{np.array_equal(codes['cpu'], codes['card'])}; ICL synthesis with ref_audio + "
        f"ref_text: {n} frames in {wall:.4f} s ({time.perf_counter() - t0:.1f} s)")
    frames = math.ceil(len(ref) / 1920)  # the edge-padded downsample rounds up
    if not np.array_equal(codes["cpu"], codes["card"]) \
            or codes["cpu"].shape != (1, min(16, cfg.num_quantizers), frames):
        raise SystemExit("chip_smoke: the speech-tokenizer encoder's codes part card from CPU")
    if len(res) != 1 or not 0 < n <= ICL_FRAMES or not np.isfinite(res[0].audio).all():
        raise SystemExit(f"chip_smoke: ICL synthesis gave {[r.token_count for r in res]} frames")
    del model.speech_tokenizer.encoder
    return {"codes_identical": True, "frames": n, "wall_s": wall}


def phase_csm(smi: str, keep) -> dict:
    """Phase 14 (see the module docstring)."""
    from mlx_audio_tpu_torch.codec.models.mimi.mimi import Mimi
    from mlx_audio_tpu_torch.tts.models.sesame import Model as Csm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[csm] {time.perf_counter() - t_phase:.1f} s into phase 14 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="csm-"))
    try:
        path, reduced = tmp / "csm-1b", tmp / "csm-1b-2layer"
        source, mimi_src = csm_seeded(), mimi_seeded()
        write_s, nbytes = write_csm(path, reduced, source, mimi_src)
        csm, load_s = timed_load(str(path))
        same_parameters(csm, source, "CSM-1B")
        del source
        mimi = Mimi.from_pretrained(str(path / "mimi"), device="cuda")
        same_parameters(mimi, mimi_src, "Mimi")
        del mimi_src
        n_params = sum(p.numel() for p in csm.parameters())
        log(f"[csm] CSM-1B bf16 (backbone 16 x 2048, depth decoder 4 x 1024, 32 codebooks of "
            f"2051, llama3 rope) and Mimi mimi_202407(32) float32, seeded: {n_params / 1e6:.1f} "
            f"M parameters, {nbytes / 1e9:.3f} GB written in the upstream and kyutai layouts "
            f"in {write_s:.1f} s (with the two-layer copy), loaded by utils.load_model in "
            f"{load_s:.2f} s and Mimi.from_pretrained, equal to the sources")
        mark("writing and loading")
        cpu = csm_two_layer(reduced)
        mark("the two-layer copy")
        ref = csm_reference()
        mimi_rec = mimi_checks(mimi, ref)
        mark("Mimi")
        csm.set_runtime(mimi=mimi)
        gen = csm_generate(csm, mimi, ref, smi)
        mark("generate")
        serving = csm_serving(csm)
        mark("bench_sesame_serving")
        int4 = csm_int4(path, tmp)
        mark("int4")
        served = csm_served(csm, path, tmp, ref)
        mark("the served request")
        del csm
        Csm._mimi = Csm._text_tokenizer = None
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    icl = icl_checks(keep)
    mark("ICL")
    rec = {"write_s": write_s, "checkpoint_bytes": nbytes, "load_s": load_s,
           "card_vs_cpu": cpu, "mimi": mimi_rec, "generate": gen, "serving": serving,
           "int4": int4, "served": served, "icl": icl,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[csm] phase 14 wall {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 15: the DAC codec, Dia-1.6B and Llama-OuteTTS-1.0-1B
# ---------------------------------------------------------------------------

# OuteTTS ties its head to the embedding (Llama-3.2-1B), so the planted path
# lives in the layers: every embedding row is drawn N(0, 1); every residual
# branch's output projection is scaled by OUTETTS_RESIDUAL_SCALE; and layer
# 0's MLP is a lookup whose unit i fires (gate OUTETTS_GATE) on token t_i's
# embedding and writes e[s_i] - e[t_i], so the last hidden state points at
# the successor s_i's row and the tied head takes it by a margin of ~D.
OUTETTS_GATE = 20.0
OUTETTS_RESIDUAL_SCALE = 1e-2


def outetts_path(tok, frames: int, seed: int = 0) -> list:
    """The planted path's token ids: `frames` c1/c2 pairs of distinct codes,
    <|c1_1024|> among them (past the 1024-entry codebook: the DAC's decode
    clamps it), then <|audio_end|>."""
    rng = np.random.default_rng(seed)
    c1 = rng.permutation(1025)[:frames]
    if 1024 not in c1:
        c1[frames // 2] = 1024
    c2 = rng.permutation(1024)[:frames]
    ids = []
    for a, b in zip(c1, c2):
        ids += [tok.token_to_id(f"<|c1_{a}|>"), tok.token_to_id(f"<|c2_{b}|>")]
    return ids + [tok.token_to_id("<|audio_end|>")]


@torch.no_grad()
def plant_outetts(model, succ: dict, seed: int = 0):
    """Plant the greedy successor map `succ` {token: next token} in a
    tied-embedding `CausalLM` (in place; see OUTETTS_GATE)."""
    lm = model.model
    E = lm.embed_tokens.weight
    D = E.shape[1]
    g = torch.Generator(device=E.device).manual_seed(seed)
    E.normal_(0.0, 1.0, generator=g)
    for layer in lm.layers:
        layer.self_attn.o_proj.weight.mul_(OUTETTS_RESIDUAL_SCALE)
        layer.mlp.down_proj.weight.mul_(OUTETTS_RESIDUAL_SCALE)
    mlp = lm.layers[0].mlp
    t = torch.as_tensor(list(succ), device=E.device)
    a_t = E[t].float()
    a_s = E[torch.as_tensor(list(succ.values()), device=E.device)].float()
    P = len(t)
    if P > mlp.gate_proj.weight.shape[0]:
        raise ValueError(f"{P} planted tokens exceed the MLP's units")
    w = mlp.gate_proj.weight
    w[:P] = (OUTETTS_GATE * a_t / D).to(w.dtype)
    mlp.up_proj.weight[:P] = (a_t / D).to(w.dtype)
    silu = OUTETTS_GATE / (1 + math.exp(-OUTETTS_GATE))
    mlp.down_proj.weight[:, :P] = ((a_s - a_t) / silu).T.to(w.dtype)
    return model


# DAC at the two published widths the families load: descript's 44.1 kHz
# model (Dia: mlx-community/descript-audio-codec-44khz; hop 512, 86 frames
# a second) and the 24 kHz 1.5 kbps speech model (OuteTTS:
# mlx-community/dac-speech-24khz-1.5kbps; the class defaults, 2 codebooks,
# hop 320, 75 frames a second)
DAC_44K = dict(encoder_dim=64, encoder_rates=[2, 4, 8, 8], latent_dim=1024, decoder_dim=1536,
               decoder_rates=[8, 8, 4, 2], n_codebooks=9, codebook_size=1024, codebook_dim=8,
               sample_rate=44100)
DAC_24K = dict(n_codebooks=2, sample_rate=24000)
DAC_FRAMES = 86  # one second at 44.1 kHz
DAC_ATOL = 1e-5  # of the peak, card against CPU, float32
# a code the card's and the CPU's encode may choose apart only at a near-tie
# of the two codes' cosine similarities (float32 sums in other orders)
DAC_TIE = 1e-5
# Dia-1.6B, `DiaConfig()`: a two-speaker text, 128 frames (256 until phase
# 18 came; the EOS column of
# channel 0's logits is zeroed in the seeded checkpoint, so every run takes
# its cap), greedy then sampled at the defaults (1.3, cfg 3.0, top-k 35)
DIA_TEXT = ("[S1] The quick brown fox jumps over the lazy dog. "
            "[S2] And the lazy dog jumps over the quick brown fox.")
DIA_FRAMES = 128
DIA_SAMPLED_FRAMES = 64  # 256 until phase 17 came
DIA_PROFILE_FRAMES = 32
DIA_REF_S = 5.0
DIA_REF_TEXT = "[S1] A seeded reference line."
DIA_CLONE_FRAMES = 32
DIA_SLOTS, DIA_BATCH_FRAMES, DIA_TICK = 4, 32, 8  # 64 frames until phase 17 came
DIA_TEXTS = (DIA_TEXT, "[S1] Hello world. [S2] The model turns text into speech.",
             "[S1] A concurrent stream. [S2] Another one, its own words.",
             "[S1] The lazy dog. [S2] The quick brown fox jumps over it.")
# the two-layer float32 copy: a seeded 8-frame delayed prompt, then 8 greedy
# steps, every decoder call's logits card against CPU
DIA_CPU_PROMPT, DIA_CPU_STEPS = 8, 8
DIA_LAYER_BAR = 1e-2
# Llama-OuteTTS-1.0-1B: Llama-3.2-1B's published widths, tied embeddings
OUTETTS_CFG = dict(
    model_type="llama", hidden_size=2048, num_hidden_layers=16, intermediate_size=8192,
    num_attention_heads=32, num_key_value_heads=8, head_dim=64, vocab_size=131626,
    rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
    tie_word_embeddings=True,
    rope_scaling={"factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192, "rope_type": "llama3"})
OUTETTS_FRAMES = 50  # planted c1/c2 pairs: 101 tokens with <|audio_end|> (100 until 19)
OUTETTS_PROFILE_TOKENS = 64
OUTETTS_STREAM_INTERVAL = 0.5  # s of tokens a streamed chunk: 68 tokens
OUTETTS_REF_S = 5.0
OUTETTS_REF_TEXT = "A seeded reference line that the model never heard."
# the batched wave: prompts entering the path at these tokens; 16-step ticks
OUTETTS_ENTRIES, OUTETTS_TICK = (20, 40, 60, 80), 16
OUTETTS_INT4_TOKENS = 16
OUTETTS_CPU_TOKENS = 16
OUTETTS_LAYER_BAR = 1e-2


def zero_port_launches() -> None:
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.ops.cuda.relu2_attention import relu2_attention

    flash_attention.launches = relu2_attention.launches = 0
    qk.reset_launches()


def no_port_launches(label) -> dict:
    got = port_kernel_launches()
    if any(got.values()):
        raise SystemExit(f"chip_smoke: {label} launched the port's kernels {got}; its path has "
                         "none")
    return got


def dac_first_parting(cpu, audio, card_codes, cpu_codes) -> dict:
    """At the first quantizer whose codes part card from CPU, its first
    parting frame: the CPU's cosine similarities of the two codes."""
    with torch.inference_mode():
        z = cpu.encoder(torch.as_tensor(audio))
        residual = z
        for i, q in enumerate(cpu.quantizer.quantizers):
            diff = np.nonzero(card_codes[0, i] != cpu_codes[0, i])[0]
            z_e = q.in_proj(residual)
            if len(diff):
                t = int(diff[0])
                enc = z_e[0, :, t] / z_e[0, :, t].norm().clamp(min=1e-12)
                cb = q.codebook.weight / q.codebook.weight.norm(dim=-1, keepdim=True)
                sim = cb @ enc
                a, b = int(card_codes[0, i, t]), int(cpu_codes[0, i, t])
                return {"quantizer": i, "frame": t, "card_code": a, "cpu_code": b,
                        "card_sim": float(sim[a]), "cpu_sim": float(sim[b])}
            z_q, _ = q.decode_latents(z_e)
            residual = residual - q.out_proj(z_q)
    return {}


def dac_checks(dac) -> dict:
    """The 44.1 kHz DAC in float32 (TF32 off): `decode_codes` of DAC_FRAMES
    seeded frames card against CPU within DAC_ATOL of the peak; the codes of
    a 1 s reference card against CPU (identical, or parted first at a
    near-tie, whose two similarities are reported); a code of 1024 decodes as
    the last bin with no device assert; the decode and encode timed."""
    from mlx_audio_tpu_torch.codec.models import DAC

    t0 = time.perf_counter()
    cpu = DAC(**DAC_44K, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in dac.state_dict().items()})
    codes = np.random.default_rng(13).integers(0, 1024, (1, 9, DAC_FRAMES))
    card_wav = dac.decode_codes(codes).cpu()
    cpu_wav = cpu.decode_codes(codes)
    peak = cpu_wav.abs().max().item()
    d = (card_wav - cpu_wav).abs().max().item()
    past = codes.copy()
    past[0, :, 10] = 1024
    last = codes.copy()
    last[0, :, 10] = 1023
    past_wav = dac.decode_codes(past)
    torch.cuda.synchronize()  # a device-side assert would surface here
    # cuDNN's transposed convolutions may sum in another order from call to call
    clamped = (past_wav - dac.decode_codes(last)).abs().max().item() <= DAC_ATOL * peak
    ref = csm_reference(1.0, 14, sr=44100)[None, None]
    x = dac.preprocess(ref)
    card_codes = dac.encode(x)[1].cpu().numpy()
    cpu_codes = cpu.encode(x.cpu())[1].numpy()
    parted = int((card_codes != cpu_codes).sum())
    first = dac_first_parting(cpu, x.cpu(), card_codes, cpu_codes) if parted else {}
    decode_ms = time_ms(lambda: dac.decode_codes(codes), iters=3, warmup=1)
    encode_ms = time_ms(lambda: dac.encode(x), iters=3, warmup=1)
    log(f"[dac] 44.1 kHz (encoder 64 x [2, 4, 8, 8], latent 1024, decoder 1536 x [8, 8, 4, 2], "
        f"9 x 1024 codes of dim 8), float32: decode_codes of {DAC_FRAMES} frames card against "
        f"CPU max|d| {d:.3e} of peak {peak:.4f} (bar {DAC_ATOL:g} of it); a code of 1024 "
        f"decodes as the last bin: {clamped}; the 1 s reference's codes {card_codes.shape} "
        f"part card from CPU at {parted} of {card_codes.size}{f' (first {first})' if first else ''}"
        f"; decode {decode_ms:.2f} ms, encode {encode_ms:.2f} ms a call (CUDA events, "
        f"{time.perf_counter() - t0:.1f} s)")
    if d > DAC_ATOL * peak or card_wav.shape != (1, 1, DAC_FRAMES * 512) or not clamped:
        raise SystemExit("chip_smoke: the DAC's decode parts card from CPU, or a code of 1024 "
                         "does not decode as the last bin")
    if parted and abs(first["card_sim"] - first["cpu_sim"]) > DAC_TIE:
        raise SystemExit(f"chip_smoke: the DAC's codes part card from CPU away from a near-tie "
                         f"{first}")
    del cpu
    return {"decode_max_abs_err": d, "peak": peak, "code_1024_is_last_bin": clamped,
            "encode_codes_parted": parted, "first_parting": first, "decode_ms": decode_ms,
            "encode_ms": encode_ms, "frames": DAC_FRAMES}


def dia_seeded(seed: int = 16):
    """Dia-1.6B at `DiaConfig()` on the card in bf16, weights drawn from
    `seed`; channel 0's EOS column of the logits zeroed (random weights would
    otherwise end a run wherever they draw it)."""
    from mlx_audio_tpu_torch.nn.module import cast_floats
    from mlx_audio_tpu_torch.tts.models.dia import DiaConfig, Model

    model = Model(DiaConfig(), device="cuda", seed=seed)
    with torch.no_grad():
        model.model.decoder.logits_dense.weight[:, 0, model.config.data.audio_eos_value] = 0
    return cast_floats(model, torch.bfloat16)


def write_dia(path: Path, reduced: Path, model, dac) -> tuple:
    """Dia in the JAX package's checkpoint layout (config.json with model
    type dia, the DAC in dac/) and a copy with two encoder and two decoder
    layers. → (seconds, bytes)."""
    import dataclasses

    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import flatten_params

    t0 = time.perf_counter()
    flat = flatten_params(model)
    keep = re.compile(r"^model\.(encoder|decoder)\.layers\.(\d+)\.")
    two = {k: v for k, v in flat.items() if not (m := keep.match(k)) or int(m.group(2)) < 2}
    cfg = dataclasses.asdict(model.config)
    small = json.loads(json.dumps(cfg))
    small["model"]["encoder"]["n_layer"] = small["model"]["decoder"]["n_layer"] = 2
    dac_flat = flatten_params(dac)
    for where, weights, c in ((path, flat, cfg), (reduced, two, small)):
        save_model(where, weights, dict(c, model_type="dia"))
        save_model(where / "dac", dac_flat, dict(DAC_44K))
    del flat, two
    return time.perf_counter() - t0, checkpoint_bytes(path) + checkpoint_bytes(path / "dac")


def dia_logit_rows(model, fault: bool = False):
    """The two-layer copy's decoder calls over a seeded 8-frame delayed prompt
    and DIA_CPU_STEPS greedy steps: (frames, [(logits, plant)]) on the host,
    `plant` the same call's logits with the layers skipped (what the layers
    add is the distance between them). `fault` swaps [uncond, cond] in the
    CFG combine."""
    from mlx_audio_tpu_torch.lm.cache import KVCache
    from mlx_audio_tpu_torch.tts.models.dia import audio as daudio
    from mlx_audio_tpu_torch.tts.models.dia import dia

    dm, data, dec = model.model, model.config.data, model.config.model.decoder
    dev = model.device
    rows = []
    forward = dm.decoder.forward

    def recorded(tgt_ids, *a, **kw):
        logits, caches = forward(tgt_ids, *a, **kw)
        x = sum(dm.decoder.embeddings[i](tgt_ids[..., i]) for i in range(data.channels))
        plant = dm.decoder.logits_dense(dm.decoder.norm(x)).float()
        rows.append((logits.cpu(), plant.cpu()))
        return logits, caches

    cfg_pred = dia._cfg_pred
    dm.decoder.forward = recorded
    if fault:
        dia._cfg_pred = lambda last, *a: cfg_pred(last.flip(0), *a)
    try:
        with torch.inference_mode():
            src, mask = model._prepare_text(DIA_TEXT)
            src2, pos, enc, cross = dia._text_pair(src, mask, dev)
            _, ckv = dia._encode_text(dm, src2, pos, enc)
            codes = np.random.default_rng(9).integers(0, 1024, (1, DIA_CPU_PROMPT, data.channels))
            prompt = daudio.apply_audio_delay(torch.as_tensor(codes, device=dev),
                                              data.delay_pattern, data.audio_bos_value,
                                              data.audio_pad_value)
            bos = torch.full((1, 1, data.channels), data.audio_bos_value, device=dev)
            prompt = torch.cat([bos, prompt], dim=1)
            P = prompt.shape[1]
            caches = [KVCache(2, dec.kv_heads, P + DIA_CPU_STEPS + 64, dec.gqa_head_dim,
                              dtype=torch.float32, device=dev) for _ in range(dec.n_layer)]
            dm.decoder(prompt.expand(2, P, -1)[:, :-1],
                       torch.arange(P - 1, device=dev)[None].expand(2, -1), caches, ckv,
                       self_mask=caches[0].attention_mask(P - 1), cross_mask=cross)
            gen = torch.Generator(device=dev).manual_seed(0)
            frames, n = dia._generate_loop(
                dm, caches, ckv, cross, prompt[0, -1], P - 1, gen, DIA_CPU_STEPS, 3.0, 0.0, 35,
                data.audio_eos_value, data.audio_pad_value, data.audio_bos_value,
                tuple(data.delay_pattern))
    finally:
        del dm.decoder.forward
        dia._cfg_pred = cfg_pred
    return frames.cpu().numpy(), rows


def dia_two_layer(reduced: Path) -> dict:
    """The two-layer copy at full width in float32 (TF32 off): every decoder
    call's logits (the prompt's and each step's) card against CPU at both
    bars, the greedy frames identical; [uncond, cond] swapped in the CFG
    combine must break the check."""
    t0 = time.perf_counter()
    cpu, cpu_load = timed_load(str(reduced), device="cpu", dtype=torch.float32)
    want_frames, want = dia_logit_rows(cpu)
    del cpu
    card, _ = timed_load(str(reduced), device="cuda", dtype=torch.float32)
    frames, got = dia_logit_rows(card)
    bad_frames, bad = dia_logit_rows(card, fault=True)
    gaps = csm_gaps(got, want)
    fault = csm_gaps(bad, want)

    def ok(g):
        return all(d <= CARD_VS_CPU_ATOL * peak and d <= DIA_LAYER_BAR * add for d, peak, add in g)

    worst = max(g[0] / min(CARD_VS_CPU_ATOL * g[1], DIA_LAYER_BAR * g[2]) for g in gaps)
    log(f"[dia] two-layer copy, float32, card against CPU: {len(gaps)} decoder calls (an "
        f"{DIA_CPU_PROMPT}-frame prompt, {DIA_CPU_STEPS} greedy steps), max|d| "
        f"{max(g[0] for g in gaps):.3e}, peaks >= {min(g[1] for g in gaps):.3f} (bar "
        f"{CARD_VS_CPU_ATOL:g} of each), what the layers add >= {min(g[2] for g in gaps):.4f} "
        f"(bar {DIA_LAYER_BAR:g} of each), worst share of its bar {worst:.3f}; greedy frames "
        f"identical: {np.array_equal(frames, want_frames)}; [uncond, cond] swapped parts them by "
        f"{max(g[0] for g in fault):.3e}, frames identical {np.array_equal(bad_frames, want_frames)}"
        f" ({time.perf_counter() - t0:.1f} s, the CPU load {cpu_load:.1f} s)")
    if not ok(gaps) or not np.array_equal(frames, want_frames) or frames.shape[0] != DIA_CPU_STEPS:
        raise SystemExit("chip_smoke: the Dia two-layer copy parts card from CPU")
    if ok(fault) and np.array_equal(bad_frames, want_frames):
        raise SystemExit("chip_smoke: the Dia check passes [uncond, cond] swapped")
    del card
    return {"logits_max_abs_err": max(g[0] for g in gaps), "layers_add": min(g[2] for g in gaps),
            "worst_share_of_bar": worst, "swap_fault_gap": max(g[0] for g in fault),
            "frames": frames.tolist(), "wall_s": time.perf_counter() - t0}


def dia_generate(dia, smi) -> dict:
    """`Model.generate` of DIA_TEXT (one segment: two turns), greedy at
    DIA_FRAMES and sampled at DIA_SAMPLED_FRAMES; a profiled run of
    DIA_PROFILE_FRAMES; a voice clone from a DIA_REF_S reference (DAC
    encode, then its prefill). The DAC is the checkpoint's dac/, read by
    `Model.dac_model`."""
    def run(**kw):
        with torch.inference_mode():
            out = list(dia.generate(DIA_TEXT, **dict(dict(temperature=0.0,
                                                          max_tokens=DIA_FRAMES), **kw)))
        torch.cuda.synchronize()
        return out

    run(max_tokens=16)  # warm-up (the DAC loads from dac/ here)
    zero_port_launches()
    t0 = time.perf_counter()
    greedy = run()
    wall = time.perf_counter() - t0
    launches = no_port_launches("Dia's greedy generate")
    t0 = time.perf_counter()
    sampled = run(temperature=1.3, cfg_scale=3.0, cfg_filter_top_k=35,
                  max_tokens=DIA_SAMPLED_FRAMES)
    sampled_s = time.perf_counter() - t0
    _, _ = profile_one_run(lambda: run(max_tokens=DIA_PROFILE_FRAMES),
                           f"one Dia-1.6B generate of {DIA_PROFILE_FRAMES} frames")
    prof = dict(profile_one_run.last)
    ref = csm_reference(DIA_REF_S, 15, sr=44100)
    x = dia.dac_model.preprocess(ref[None, None])
    encode_s = time_ms(lambda: dia.dac_model.encode(x), iters=1, warmup=1) / 1e3
    t0 = time.perf_counter()
    clone = run(ref_audio=ref, ref_text=DIA_REF_TEXT, max_tokens=DIA_CLONE_FRAMES)
    clone_s = time.perf_counter() - t0
    n, audio = greedy[0].token_count, greedy[0].audio
    audio_s = len(audio) / 44100
    per_frame = DIA_PROFILE_FRAMES
    log(f"[dia] generate (greedy, {len(greedy)} segment of two turns): {n} frames, "
        f"{audio_s:.3f} s of audio, wall {wall:.4f} s ({n / wall:.2f} frames/s, RTF "
        f"{wall / audio_s:.4f}); sampled (1.3, cfg 3.0, top-k 35) {sampled[0].token_count} "
        f"frames in {sampled_s:.4f} s ({sampled[0].token_count / sampled_s:.2f} frames/s); the "
        f"port's kernels launched {launches} ({smi})")
    log(f"[dia] profiled {per_frame} frames: device busy {prof['device_ms']:.1f} ms of "
        f"{prof['wall_ms']:.1f} ms wall (idle share {100 * prof['idle_share']:.1f}%), "
        f"{prof['launches']} launches, {prof['launches'] / per_frame:.0f} and "
        f"{prof['device_ms'] / per_frame:.3f} ms of device time a step with the text encode and "
        f"the DAC decode spread over them")
    log(f"[dia] voice clone: a {DIA_REF_S:g} s reference DAC-encoded in {encode_s:.4f} s "
        f"({x.shape[-1] // 512} frames, prefilled with the text), then {clone[0].token_count} "
        f"greedy frames: wall {clone_s:.4f} s")
    if (n != DIA_FRAMES or len(audio) != (DIA_FRAMES - 15) * 512 or not np.isfinite(audio).all()
            or clone[0].token_count != DIA_CLONE_FRAMES or not np.isfinite(clone[0].audio).all()
            or not np.isfinite(sampled[0].audio).all()):
        raise SystemExit("chip_smoke: Dia's generate gave the wrong frames or non-finite audio")
    return {"frames": n, "audio_s": audio_s, "wall_s": wall, "frames_per_s": n / wall,
            "rtf": wall / audio_s, "sampled_frames": sampled[0].token_count,
            "sampled_wall_s": sampled_s, "launches": launches, "profile": prof,
            "profile_frames": per_frame, "clone_encode_s": encode_s, "clone_wall_s": clone_s,
            "clone_frames": clone[0].token_count}


def dia_batched(dia) -> dict:
    """`DiaBatcher` at DIA_SLOTS slots: four greedy requests of
    DIA_BATCH_FRAMES frames at once, each equal to its frames alone through
    the same pool."""
    b = dia.make_batcher(slots=DIA_SLOTS, tick_frames=DIA_TICK, max_tokens_cap=DIA_BATCH_FRAMES)
    try:
        b.warmup()
        inputs = [dia._prepare_text(t) for t in DIA_TEXTS]

        def submit(src_mask):
            return b.submit(*src_mask, max_tokens=DIA_BATCH_FRAMES, temperature=0.0)

        t0, s0 = time.perf_counter(), b.steps
        futs = [submit(sm) for sm in inputs]
        batched = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        batched_s, ticks = time.perf_counter() - t0, b.steps - s0
        t0 = time.perf_counter()
        alone = [submit(sm).result(timeout=SERVE_TIMEOUT) for sm in inputs]
        alone_s = time.perf_counter() - t0
    finally:
        b.close()
    same = [np.array_equal(x, y) for x, y in zip(batched, alone)]
    frames = sum(len(x) for x in batched)
    log(f"[dia] DiaBatcher ({DIA_SLOTS} slots, tick {DIA_TICK}): {len(batched)} x "
        f"{DIA_BATCH_FRAMES} greedy frames in {batched_s:.4f} s ({frames / batched_s:.1f} "
        f"frames/s aggregate, {ticks} ticks), one after another {alone_s:.4f} s "
        f"({frames / alone_s:.1f} frames/s): speedup {alone_s / batched_s:.2f}x; batched = "
        f"alone: {same}")
    if not all(same) or any(len(x) != DIA_BATCH_FRAMES for x in batched) or len(
            {x.tobytes() for x in batched}) != len(batched):
        raise SystemExit("chip_smoke: DiaBatcher's frames part from each request's frames alone")
    return {"slots": DIA_SLOTS, "frames": DIA_BATCH_FRAMES, "batched_s": batched_s,
            "alone_s": alone_s, "speedup": alone_s / batched_s, "ticks": ticks}


def outetts_succ(tok, path) -> dict:
    """The planted successor map: both prompt endings (a plain prompt's last
    "\\n", a speaker prompt's <|word_start|>) lead onto the path."""
    succ = {tok.encode("\n", add_special_tokens=False)[-1]: path[0],
            tok.token_to_id("<|word_start|>"): path[0]}
    succ.update(zip(path, path[1:]))
    return succ


def write_outetts(path: Path, reduced: Path, tok_dir: Path, seed: int = 17) -> tuple:
    """Llama-OuteTTS-1.0-1B in bf16 with the planted path, a tokenizer.json
    with OuteTTS's added tokens and the 24 kHz DAC in dac/, and its first two
    layers as a copy. → (seconds, bytes, path's token ids)."""
    from mlx_audio_tpu_torch.codec.models import DAC
    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import cast_floats, flatten_params
    from mlx_audio_tpu_torch.tokenizer_json import load
    from mlx_audio_tpu_torch.tts.models.outetts import Model

    t0 = time.perf_counter()
    tok = load(write_tokenizer_json(tok_dir, "outetts"))
    planted = outetts_path(tok, OUTETTS_FRAMES)
    model = plant_outetts(Model(OUTETTS_CFG, device="cuda", seed=seed),
                          outetts_succ(tok, planted), seed)
    flat = flatten_params(cast_floats(model, torch.bfloat16))
    del model
    dac = flatten_params(DAC(**DAC_24K, device="cuda", seed=seed + 1))
    two = {k: v for k, v in flat.items()
           if not k.startswith("model.layers.") or int(k.split(".")[2]) < 2}
    for where, weights, c in ((path, flat, OUTETTS_CFG),
                              (reduced, two, dict(OUTETTS_CFG, num_hidden_layers=2))):
        save_model(where, weights, c)
        shutil.copy(tok_dir / "tokenizer.json", where / "tokenizer.json")
        save_model(where / "dac", dac, dict(DAC_24K))
    del flat, two
    torch.cuda.empty_cache()
    return time.perf_counter() - t0, checkpoint_bytes(path), planted


def outetts_launches(layers: int, calls) -> dict:
    """`orpheus_launches` without the head: a tied int4 head is a
    `QuantizedEmbedding`, whose `as_linear` dequantizes the table and takes
    `F.linear`, no kernel."""
    got = orpheus_launches(layers, calls)
    for M, n in calls:
        got["qmm"] -= n
        got["qmm_gemv" if M <= 4 else "qmm_mma"] -= n
    return got


def outetts_logit_rows(model, ids, tokens: int):
    """Greedy tokens of `generate_tokens` with every call's last-position
    logits and the same logits with the layers skipped: (tokens, [(logits,
    plant)]) on the host."""
    from mlx_audio_tpu_torch.lm.generate import generate_tokens

    rows = []

    def call(m, x, caches):
        logits, caches = m(x, caches)
        plant = m.logits(m.model.norm(m.model.embed_tokens(x)))
        rows.append((logits[0, -1].float().cpu(), plant[0, -1].float().cpu()))
        return logits, caches

    with torch.inference_mode():
        toks, _ = generate_tokens(model, ids, max_tokens=tokens, repetition_penalty=1.1,
                                  repetition_context_size=64, model_call=call)
    return toks[0].tolist(), rows


def outetts_checks(path: Path, reduced: Path, tmp: Path, planted, smi) -> dict:
    """Phase 15's OuteTTS part (see the module docstring)."""
    from mlx_audio_tpu_torch import convert
    from mlx_audio_tpu_torch.lm.generate import generate_tokens
    from mlx_audio_tpu_torch.tts.models.outetts import Model

    rec = {}
    model, load_s = timed_load(str(path))
    rec["load_s"] = load_s
    pp, tok = model.prompt_processor, model.tokenizer
    ids = tok.encode(pp.get_completion_prompt(HTTP_TEXT), add_special_tokens=False)
    want_codes = pp.extract_audio_from_tokens(planted)

    def run(**kw):
        with torch.inference_mode():
            out = list(model.generate(HTTP_TEXT, **dict(dict(temperature=0.0), **kw)))
        torch.cuda.synchronize()
        return out

    run(max_tokens=16)  # warm-up (the DAC loads from dac/ here)
    zero_port_launches()
    t0 = time.perf_counter()
    greedy = run()
    wall = time.perf_counter() - t0
    launches = no_port_launches("OuteTTS's bf16 generate")
    want_audio = model.codec.decode_codes(torch.as_tensor([want_codes])).float().cpu().numpy()
    audio = greedy[0].audio
    # cuDNN's transposed convolutions may sum in another order from call to call
    # (the stride-5 transposed conv makes a frame 320 samples less a few at
    # the ends, as in the JAX package)
    decode_d = (float(np.abs(audio - want_audio.reshape(-1)).max())
                if audio.size == want_audio.size else float("inf"))
    decoded = decode_d <= DAC_ATOL * float(np.abs(want_audio).max())
    n = greedy[0].token_count
    t0 = time.perf_counter()
    sampled = run(temperature=0.4, top_p=0.9, top_k=40, min_p=0.05, repetition_penalty=1.1,
                  repetition_context_size=64)
    sampled_s = time.perf_counter() - t0
    _, _ = profile_one_run(lambda: run(max_tokens=OUTETTS_PROFILE_TOKENS),
                           f"one OuteTTS generate of {OUTETTS_PROFILE_TOKENS} tokens")
    prof = dict(profile_one_run.last)
    t0 = time.perf_counter()
    with torch.inference_mode():
        gen = model.generate(HTTP_TEXT, temperature=0.0, stream=True,
                             streaming_interval=OUTETTS_STREAM_INTERVAL)
        first = next(gen)
        ttfa = time.perf_counter() - t0
        chunks = [first] + list(gen)
    stream_s = time.perf_counter() - t0
    streamed_tokens = sum(c.token_count for c in chunks)
    streamed_samples = sum(c.samples for c in chunks)
    ref = csm_reference(OUTETTS_REF_S, 16)
    t0 = time.perf_counter()
    speaker = model.create_speaker(ref, OUTETTS_REF_TEXT)
    speaker_s = time.perf_counter() - t0
    spk_path = tmp / "speaker.json"
    model.save_speaker(speaker, str(spk_path))
    cloned = run(voice=str(spk_path))
    audio_s = len(audio) / 24000
    log(f"[outetts] generate (greedy, repetition 1.1 over 64), prompt {len(ids)} tokens: {n} "
        f"tokens to <|audio_end|>, {audio_s:.3f} s of audio, wall {wall:.4f} s ({n / wall:.1f} "
        f"tokens/s, RTF {wall / audio_s:.4f}); the planted codes, <|c1_1024|> clamped, decode to "
        f"the same samples: {decoded} (max|d| {decode_d:.2e}); sampled (0.4, "
        f"top-p 0.9, top-k 40, min-p 0.05) {sampled[0].token_count} tokens in {sampled_s:.4f} s; "
        f"the port's kernels launched {launches} ({smi})")
    log(f"[outetts] profiled {OUTETTS_PROFILE_TOKENS} tokens: device busy {prof['device_ms']:.1f} "
        f"ms of {prof['wall_ms']:.1f} ms wall (idle share {100 * prof['idle_share']:.1f}%), "
        f"{prof['launches']} launches, {prof['launches'] / OUTETTS_PROFILE_TOKENS:.0f} and "
        f"{prof['device_ms'] / OUTETTS_PROFILE_TOKENS:.3f} ms of device time a token with the "
        f"prefill and the DAC decode spread over them")
    log(f"[outetts] stream=True at {OUTETTS_STREAM_INTERVAL} s: time to first audio {ttfa:.4f} s, "
        f"{len(chunks)} chunks of {[c.token_count for c in chunks]} tokens, wall {stream_s:.4f} "
        f"s; a speaker from the {OUTETTS_REF_S:g} s reference (create_speaker, DAC encode) in "
        f"{speaker_s:.4f} s: {len(speaker['words'])} words, "
        f"{sum(len(w['c1']) for w in speaker['words'])} code pairs; generate with it: "
        f"{cloned[0].token_count} tokens")
    if (n != len(planted) or not decoded
            # a last chunk of <|audio_end|> alone brings no samples and is not yielded
            or streamed_tokens not in (n - 1, n) or streamed_samples != len(audio)
            or cloned[0].token_count != len(planted) or len(audio) != want_audio.size):
        raise SystemExit(f"chip_smoke: OuteTTS's generate left the planted path, or the stream "
                         f"parts from it: {n} tokens, decoded {decoded}, streamed "
                         f"{streamed_tokens} tokens and {streamed_samples} samples of "
                         f"{len(audio)}, cloned {cloned[0].token_count}")
    rec.update(tokens=n, audio_s=audio_s, wall_s=wall, tokens_per_s=n / wall,
               rtf=wall / audio_s, sampled_tokens=sampled[0].token_count,
               sampled_wall_s=sampled_s, launches=launches, profile=prof,
               profile_tokens=OUTETTS_PROFILE_TOKENS, ttfa_s=ttfa, stream_wall_s=stream_s,
               chunks=len(chunks), speaker_s=speaker_s, prompt_tokens=len(ids))

    # the batched wave: four prompts entering the path at their own tokens
    prompts = [ids + [planted[k]] for k in OUTETTS_ENTRIES]
    kw = dict(max_tokens=len(planted), eos_ids=(planted[-1],), repetition_penalty=1.1)
    b = model.make_batcher(slots=4, max_len=512, tick_tokens=OUTETTS_TICK)
    try:
        b.warmup()
        t0, s0 = time.perf_counter(), b.dispatch_count
        futs = [b.submit(p, **kw) for p in prompts]
        outs = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        batched_s, ticks = time.perf_counter() - t0, b.dispatch_count - s0
    finally:
        b.close()
    t0 = time.perf_counter()
    with torch.inference_mode():
        alone = [generate_tokens(model, p, max_tokens=len(planted), repetition_penalty=1.1,
                                 eos_token_ids=(planted[-1],))[0][0].tolist() for p in prompts]
    alone_s = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    log(f"[outetts] LMContinuousBatcher (4 slots, tick {OUTETTS_TICK}): {total} tokens of 4 "
        f"requests in {batched_s:.4f} s ({total / batched_s:.1f} tokens/s aggregate, {ticks} "
        f"ticks), sequential {alone_s:.4f} s ({total / alone_s:.1f} tokens/s): speedup "
        f"{alone_s / batched_s:.2f}x; each equal to its sequential greedy tokens: "
        f"{[o == a for o, a in zip(outs, alone)]}")
    if any(o != a or o != planted[planted.index(p[-1]) + 1:]
           for o, a, p in zip(outs, alone, prompts)):
        raise SystemExit("chip_smoke: OuteTTS's batched tokens part from their sequential ones")
    rec["batched"] = {"tokens": total, "batched_s": batched_s, "alone_s": alone_s,
                      "speedup": alone_s / batched_s, "ticks": ticks}
    del model
    Model._tokenizer = Model._codec = Model._prompt_processor = None
    gc.collect()
    torch.cuda.empty_cache()

    # int4 by convert: OUTETTS_INT4_TOKENS tokens, launches from the code
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        q = convert.convert(str(path), str(tmp / "llama-outetts-1.0-1b-4bit"), quantize=True)
    convert_s = time.perf_counter() - t0
    q4, q_load_s = timed_load(str(q))
    head = type(q4.model.embed_tokens).__name__
    with torch.inference_mode():
        generate_tokens(q4, ids, max_tokens=2)  # warm-up
        torch.cuda.synchronize()
        qk.reset_launches()
        t0 = time.perf_counter()
        toks, n4 = generate_tokens(q4, ids, max_tokens=OUTETTS_INT4_TOKENS)
        torch.cuda.synchronize()
        wall4 = time.perf_counter() - t0
    got = quant_counts(4)
    predicted = outetts_launches(OUTETTS_CFG["num_hidden_layers"],
                                 [(len(ids), 1), (1, OUTETTS_INT4_TOKENS)])
    head_ms = time_ms(lambda: q4.logits(torch.zeros(1, 1, OUTETTS_CFG["hidden_size"],
                                                    device="cuda")), iters=5, warmup=1)
    log(f"[outetts] int4 g64 by convert(quantize=True) in {convert_s:.1f} s, loaded in "
        f"{q_load_s:.1f} s; {n4} greedy tokens after the {len(ids)}-token prompt in "
        f"{wall4:.4f} s ({n4 / wall4:.1f} tokens/s): launches {got}, from the code {predicted}; "
        f"the tied head is a {head} whose as_linear dequantizes the table and takes F.linear: "
        f"{head_ms:.3f} ms a step (CUDA events, float32 x)")
    if got != predicted or n4 != OUTETTS_INT4_TOKENS:
        raise SystemExit(f"chip_smoke: the int4 OuteTTS launched {got}, the code says {predicted}")
    rec["int4"] = {"convert_s": convert_s, "load_s": q_load_s, "tokens": n4, "wall_s": wall4,
                   "tokens_per_s": n4 / wall4, "launches": got, "head": head,
                   "head_ms": head_ms}
    del q4
    shutil.rmtree(q, ignore_errors=True)
    Model._tokenizer = Model._codec = Model._prompt_processor = None
    gc.collect()
    torch.cuda.empty_cache()

    # the two-layer copy in float32, card against CPU
    t0 = time.perf_counter()
    cpu, _ = timed_load(str(reduced), device="cpu", dtype=torch.float32)
    want_toks, want = outetts_logit_rows(cpu, ids, OUTETTS_CPU_TOKENS)
    del cpu
    card, _ = timed_load(str(reduced), device="cuda", dtype=torch.float32)
    got_toks, got_rows = outetts_logit_rows(card, ids, OUTETTS_CPU_TOKENS)
    del card
    gaps = csm_gaps(got_rows, want)
    ok = all(d <= CARD_VS_CPU_ATOL * peak and d <= OUTETTS_LAYER_BAR * add for d, peak, add in gaps)
    log(f"[outetts] two-layer copy, float32, card against CPU: {len(gaps)} calls' logits (the "
        f"prompt's and {OUTETTS_CPU_TOKENS} steps'), max|d| {max(g[0] for g in gaps):.3e}, peaks "
        f">= {min(g[1] for g in gaps):.1f} (bar {CARD_VS_CPU_ATOL:g} of each), what the layers "
        f"add >= {min(g[2] for g in gaps):.1f} (bar {OUTETTS_LAYER_BAR:g} of each); greedy "
        f"tokens identical: {got_toks == want_toks}, on the path: "
        f"{got_toks == planted[:OUTETTS_CPU_TOKENS]} ({time.perf_counter() - t0:.1f} s)")
    if not ok or got_toks != want_toks or got_toks != planted[:OUTETTS_CPU_TOKENS]:
        raise SystemExit("chip_smoke: the OuteTTS two-layer copy parts card from CPU")
    rec["card_vs_cpu"] = {"logits_max_abs_err": max(g[0] for g in gaps),
                          "layers_add": min(g[2] for g in gaps),
                          "wall_s": time.perf_counter() - t0}
    Model._tokenizer = Model._codec = Model._prompt_processor = None
    return rec


def phase_dia_outetts(smi: str) -> dict:
    """Phase 15 (see the module docstring)."""
    from mlx_audio_tpu_torch.codec.models import DAC
    from mlx_audio_tpu_torch.tts.models.dia import Model as Dia

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[dia] {time.perf_counter() - t_phase:.1f} s into phase 15 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="dia-"))
    try:
        dac = DAC(**DAC_44K, device="cuda", seed=18).eval()
        dac_rec = dac_checks(dac)
        mark("the DAC")
        path, reduced = tmp / "dia-1.6b", tmp / "dia-1.6b-2layer"
        source = dia_seeded()
        write_s, nbytes = write_dia(path, reduced, source, dac)
        dia, load_s = timed_load(str(path))
        same_parameters(dia, source, "Dia-1.6B")
        del source, dac
        log(f"[dia] Dia-1.6B bf16 (encoder 12 x 1024, decoder 18 x 2048, 16/4 heads of 128, 9 "
            f"channels of 1028) and the 44.1 kHz DAC float32 in dac/, seeded: "
            f"{sum(p.numel() for p in dia.parameters()) / 1e6:.1f} M parameters, "
            f"{nbytes / 1e9:.3f} GB written in {write_s:.1f} s (with the two-layer copy), "
            f"loaded by utils.load_model in {load_s:.2f} s, equal to the source")
        mark("writing and loading Dia")
        cpu = dia_two_layer(reduced)
        mark("the Dia two-layer copy")
        Dia._dac = None  # the checkpoint's own dac/
        gen = dia_generate(dia, smi)
        mark("Dia's generate")
        batched = dia_batched(dia)
        mark("DiaBatcher")
        del dia
        Dia._dac = None
        gc.collect()
        torch.cuda.empty_cache()
        opath, oreduced = tmp / "llama-outetts-1.0-1b", tmp / "llama-outetts-1.0-1b-2layer"
        tok_dir = tmp / "tokenizer"
        tok_dir.mkdir()
        owrite_s, obytes, planted = write_outetts(opath, oreduced, tok_dir)
        log(f"[outetts] Llama-OuteTTS-1.0-1B bf16 (16 x 2048, 32/8 heads of 64, tied "
            f"embeddings over {OUTETTS_CFG['vocab_size']} tokens, llama3 rope), the planted path "
            f"of {OUTETTS_FRAMES} c1/c2 pairs, a tokenizer.json with OuteTTS's added tokens and "
            f"the 24 kHz DAC (2 codebooks) in dac/, seeded: {obytes / 1e9:.3f} GB written in "
            f"{owrite_s:.1f} s (with the two-layer copy)")
        outetts = outetts_checks(opath, oreduced, tmp, planted, smi)
        mark("OuteTTS")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"dac": dac_rec, "dia": {"write_s": write_s, "checkpoint_bytes": nbytes,
                                   "load_s": load_s, "card_vs_cpu": cpu, "generate": gen,
                                   "batched": batched},
           "outetts": dict(outetts, write_s=owrite_s, checkpoint_bytes=obytes),
           "phase_s": time.perf_counter() - t_phase}
    log(f"[dia] phase 15 wall {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 16: EnCodec 24 kHz and Bark-small
# ---------------------------------------------------------------------------

# a gain of the planted stop row over the final norm's output: its logit is
# ~gain·sqrt(D) where the plant sits and ~gain·N(0, 1) elsewhere
BARK_PLANT_SCALE = 1e4


def plant_bark_stop(model, tokens: int, gain: float = 1.0, seed: int = 0):
    """Plant the semantic stage's stop after `tokens` tokens, whatever the
    text: the position whose logits draw step `tokens` (256 + tokens: the
    257-row prefill's last position draws step 0) carries
    BARK_PLANT_SCALE times a zero-mean unit direction v, which then rules
    the final norm's output there, and the stop token's head row is
    gain·v. → the planted row's added vector (to lift the plant again)."""
    from mlx_audio_tpu_torch.tts.models.bark.bark import SEMANTIC_PAD_TOKEN

    gpt = model.semantic
    w = gpt.position_embeds_layer.weight
    g = torch.Generator(device=w.device).manual_seed(seed)
    v = torch.randn(w.shape[1], generator=g, device=w.device)
    v = v - v.mean()
    v = v / v.norm()
    with torch.no_grad():
        w[256 + tokens] += BARK_PLANT_SCALE * v
        gpt.lm_head.weight[SEMANTIC_PAD_TOKEN] = gain * v
    return BARK_PLANT_SCALE * v


# Bark-small's published widths (suno/bark-small: three GPTs of 12 x 768, 12
# heads of 64, a 1024-row position table, no bias), in the JAX package's
# config names
BARK_GPT = dict(block_size=1024, n_layer=12, n_head=12, n_embd=768, bias=False)
BARK_CFG = dict(
    model_type="bark",
    semantic_config=dict(BARK_GPT, model_type="semantic", input_vocab_size=129600,
                         output_vocab_size=10048),
    coarse_acoustics_config=dict(BARK_GPT, model_type="coarse_acoustics",
                                 input_vocab_size=12096, output_vocab_size=12096),
    fine_acoustics_config=dict(BARK_GPT, model_type="fine_acoustics", input_vocab_size=1056,
                               output_vocab_size=1056, n_codes_total=8, n_codes_given=1))
BARK_STAGES = ("semantic_config", "coarse_acoustics_config", "fine_acoustics_config")
# bert-base-multilingual-cased's vocabulary size: TEXT_PAD_TOKEN = 10,048 +
# 119,547 (bark.py:33)
BARK_WORDPIECE = 119547
BARK_TEXT = HTTP_TEXT
# the planted stop: 150 semantic tokens give 450 coarse steps in 8 windows
# of 60 (the last takes 30), 225 frames in one fine chunk, 72,000 samples
BARK_TOKENS = 150
BARK_FRAMES = 225
BARK_TIMED = 2  # 3 until phase 19 came
BARK_PROFILE_STEPS = 32
# the two-layer copy: teacher-forced decode steps of each causal stage
BARK_CPU_STEPS = 8
BARK_LAYER_BAR = 1e-2
# int4: 16 semantic tokens, one coarse window, one fine chunk; its logits
# against F.linear on the dequantized weights, at this share of each peak
BARK_INT4_TOKENS = 16
BARK_INT4_BAR = 1e-3
BARK_BATCH = 4
ENCODEC_S = 5.0
ENCODEC_BANDWIDTH = 6.0  # kbps: 8 codebooks at 75 Hz
ENCODEC_ATOL = 1e-5  # of the peak, card against CPU, float32


def write_bark_tokenizer(path) -> Path:
    """A WordPiece tokenizer.json of BARK_WORDPIECE entries laid out as
    bert-base-multilingual-cased's begins ([PAD] 0, [unused1-99], [UNK] 100,
    [CLS] 101, [SEP] 102, [MASK] 103), then printable ASCII and its `##`
    continuations, the phase's words, and fill entries up to the count;
    cased, accents kept, CJK split, as `tokenizers` writes
    BertWordPieceTokenizer's."""
    vocab = {"[PAD]": 0}
    for i in range(1, 100):
        vocab[f"[unused{i}]"] = i
    for t in ("[UNK]", "[CLS]", "[SEP]", "[MASK]"):
        vocab[t] = len(vocab)
    chars = [chr(c) for c in range(33, 127)]
    words = sorted({w for t in HTTP_TEXTS for w in re.findall(r"[A-Za-z]+", t)})
    for t in chars + ["##" + c for c in chars if c.isalnum()] + words:
        vocab.setdefault(t, len(vocab))
    for k in range(BARK_WORDPIECE - len(vocab)):
        vocab[f"[fill{k}]"] = len(vocab)
    assert len(vocab) == BARK_WORDPIECE
    special = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for t in special],
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": False},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {"type": "BertProcessing", "sep": ["[SEP]", vocab["[SEP]"]],
                           "cls": ["[CLS]", vocab["[CLS]"]]},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab}}
    path = Path(path)
    if path.suffix != ".json":
        path = path / "tokenizer.json"
    path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    return path


def encodec_seeded(seed: int = 19):
    """EnCodec at `EncodecConfig()` (facebook/encodec_24khz) on the card,
    weights drawn from `seed`, each convolution scaled to unit gain (√3, and
    √(3·stride) for a transposed one: the initialiser's 1/fan-in bound
    leaves 1e-6 at the decoder's output), the codebooks drawn N(0, σ²) at
    the encoder's output spread σ on the phase's reference (the JAX package
    starts them at zero, which decodes everything to one vector)."""
    from mlx_audio_tpu_torch.codec.models import Encodec, EncodecConfig
    from mlx_audio_tpu_torch.codec.models.encodec.encodec import (EncodecConv1d,
                                                                  EncodecConvTranspose1d)

    enc = Encodec(EncodecConfig(), device="cuda", seed=seed).eval()
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, (EncodecConv1d, EncodecConvTranspose1d)):
                stride = m.conv.stride if isinstance(m, EncodecConvTranspose1d) else 1
                m.conv.weight.mul_(math.sqrt(3 * stride))
    ref = torch.as_tensor(csm_reference(ENCODEC_S, 17), device="cuda")[None, None]
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.inference_mode():
        std = enc.encoder(ref).std()
    with torch.no_grad():
        for layer in enc.quantizer.layers:
            e = layer.codebook.embed
            e.copy_(torch.randn(e.shape, generator=g, device="cuda") * std)
    return enc


def encodec_checks(enc) -> dict:
    """EnCodec 24 kHz in float32 (TF32 off): a ENCODEC_S s reference encoded
    at ENCODEC_BANDWIDTH kbps card against CPU, the codes identical; those
    codes decoded card against CPU within ENCODEC_ATOL of the peak; a code of
    1024 decodes as the last bin with no device assert; encode and decode
    timed."""
    from mlx_audio_tpu_torch.codec.models import Encodec, EncodecConfig

    t0 = time.perf_counter()
    cpu = Encodec(EncodecConfig(), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in enc.state_dict().items()})
    ref = csm_reference(ENCODEC_S, 17)[None, None]
    codes, _ = enc.encode(ref, bandwidth=ENCODEC_BANDWIDTH)
    cpu_codes, _ = cpu.encode(ref, bandwidth=ENCODEC_BANDWIDTH)
    codes = codes.cpu()
    parted = int((codes != cpu_codes).sum())
    card_wav = enc.decode(codes).cpu()
    cpu_wav = cpu.decode(codes)
    peak = cpu_wav.abs().max().item()
    d = (card_wav - cpu_wav).abs().max().item()
    past, last = codes.clone(), codes.clone()
    past[..., 10] = 1024
    last[..., 10] = 1023
    past_wav = enc.decode(past)
    torch.cuda.synchronize()  # a device-side assert would surface here
    # cuDNN's transposed convolutions may sum in another order from call to call
    clamped = (past_wav - enc.decode(last)).abs().max().item() <= ENCODEC_ATOL * peak
    encode_ms = time_ms(lambda: enc.encode(ref, bandwidth=ENCODEC_BANDWIDTH), iters=3, warmup=1)
    decode_ms = time_ms(lambda: enc.decode(codes), iters=3, warmup=1)
    n = int(ENCODEC_S * 24000)
    log(f"[encodec] EncodecConfig() (24 kHz, 32 filters, ratios [8, 5, 4, 2], a 2-layer LSTM "
        f"of 512, 32 codebooks of 1024 x 128), float32: a {ENCODEC_S:g} s reference at "
        f"{ENCODEC_BANDWIDTH:g} kbps -> codes {tuple(codes.shape)}, card against CPU parted at "
        f"{parted}; decode card against CPU max|d| {d:.3e} of peak {peak:.4f} (bar "
        f"{ENCODEC_ATOL:g} of it); a code of 1024 decodes as the last bin: {clamped}; encode "
        f"{encode_ms:.2f} ms, decode {decode_ms:.2f} ms a call (CUDA events, "
        f"{time.perf_counter() - t0:.1f} s)")
    if (parted or d > ENCODEC_ATOL * peak or card_wav.shape != (1, 1, n) or not clamped
            or codes.shape != (1, 1, 8, n // 320)):
        raise SystemExit("chip_smoke: EnCodec's codes or decode part card from CPU, or a code "
                         "of 1024 does not decode as the last bin")
    del cpu
    return {"codes_parted": parted, "codes_shape": list(codes.shape), "decode_max_abs_err": d,
            "peak": peak, "code_1024_is_last_bin": clamped, "encode_ms": encode_ms,
            "decode_ms": decode_ms, "seconds": ENCODEC_S}


def write_bark(path: Path, reduced: Path, model, enc) -> tuple:
    """Bark in the JAX package's checkpoint layout (config.json with model
    type bark, the WordPiece tokenizer.json, EnCodec in encodec/) and a copy
    with two layers in each stage. → (seconds, bytes)."""
    import dataclasses

    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import flatten_params

    t0 = time.perf_counter()
    flat = flatten_params(model)
    keep = re.compile(r"^(semantic|coarse_acoustics|fine_acoustics)\.layers\.(\d+)\.")
    two = {k: v for k, v in flat.items() if not (m := keep.match(k)) or int(m.group(2)) < 2}
    small = json.loads(json.dumps(BARK_CFG))
    for stage in BARK_STAGES:
        small[stage]["n_layer"] = 2
    enc_flat, enc_cfg = flatten_params(enc), dataclasses.asdict(enc.config)
    for where, weights, c in ((path, flat, BARK_CFG), (reduced, two, small)):
        save_model(where, weights, c)
        write_bark_tokenizer(where)
        save_model(where / "encodec", enc_flat, enc_cfg)
    del flat, two
    return time.perf_counter() - t0, checkpoint_bytes(path) + checkpoint_bytes(path / "encodec")


def bark_logit_rows(model, fault: bool = False, plants: bool = True,
                    sem_steps: int = BARK_CPU_STEPS, coarse_steps: int = BARK_CPU_STEPS):
    """Teacher-forced logits of the three stages through their own loops:
    the semantic prefill of BARK_TEXT and `sem_steps` steps fed seeded
    tokens, a first coarse window's prefill (pad rows between the context
    and its 317 rows) and `coarse_steps` steps fed seeded codes, and the
    fine stack's six codebooks over a seeded 512-frame chunk. → [(logits,
    plant)] on the host, `plant` the same call's logits with the layers
    skipped (what the layers add is the distance between them) or None.
    `fault` feeds each decode step its position plus one."""
    from mlx_audio_tpu_torch.tts.models.bark import bark as bk

    dev = model.device
    rng = np.random.default_rng(21)
    rows, hooks = [], []

    def forced(tokens, vocab):
        def draw(i):
            x = torch.zeros(1, vocab, device=dev)
            x[0, int(tokens[i])] = 1e30
            return x
        return draw

    def record(stack, heads, select):
        x_in = {}

        def pre(mod, args):
            x_in["x"] = args[0]

        def post(mod, args, out):
            plant = None
            if plants:
                plant = mod.forward(stack.layernorm_final(select(x_in["x"]))).float().cpu()
            rows.append((out.float().cpu(), plant))

        hooks.append(stack.layers[0].register_forward_pre_hook(pre))
        hooks.extend(h.register_forward_hook(post) for h in heads)

    def shifted(mod, args):  # a decode step's position, plus one
        return (args[0] + 1,) if args[0].numel() == 1 else None

    sem, coarse, fine = model.semantic, model.coarse_acoustics, model.fine_acoustics
    record(sem, [sem.lm_head], lambda x: x[:, -1:])
    ctx = 257
    record(coarse, [coarse.lm_head],
           lambda x: x[:, -1:] if x.shape[1] == 1 else x[:, ctx - 1:ctx])
    record(fine, list(fine.lm_heads), lambda x: x)
    if fault:
        hooks += [g.position_embeds_layer.register_forward_pre_hook(shifted)
                  for g in (sem, coarse)]
    ids = torch.as_tensor(model.text_ids(BARK_TEXT)[None], device=dev)
    hist = torch.full_like(ids, bk.SEMANTIC_PAD_TOKEN)
    one = torch.ones(1, device=dev)
    try:
        with torch.inference_mode():
            bk.semantic_rows(sem, bk.semantic_prefill(sem, ids, hist), one,
                             forced(rng.integers(0, 10000, sem_steps), 10001), sem_steps)
            x_sem = rng.integers(0, 10000, 40)
            prefill = np.full(317, bk.COARSE_SEMANTIC_PAD_TOKEN)
            prefill[:40] = x_sem
            prefill[256] = bk.COARSE_INFER_TOKEN
            codes = rng.integers(0, 1024, coarse_steps) + 10000 + 1024 * (
                np.arange(coarse_steps) % 2)
            lp = lambda v: torch.as_tensor([v], device=dev)  # noqa: E731
            bk.coarse_window_rows(coarse, torch.as_tensor(prefill[None], device=dev), lp(ctx),
                                  lp(0), lp(10 ** 6), one, forced(codes, 12096), coarse_steps)
            idx = torch.as_tensor(rng.integers(0, 1024, (1, 512, 8)), device=dev)
            for cb in range(bk.N_COARSE_CODEBOOKS, bk.N_FINE_CODEBOOKS):
                fine(cb, idx)
    finally:
        for h in hooks:
            h.remove()
    return rows


def bark_two_layer(reduced: Path) -> dict:
    """The two-layer copy at full width in float32 (TF32 off): every stage's
    teacher-forced logits card against CPU at both bars; an off-by-one
    decode position must break the check."""
    from mlx_audio_tpu_torch.tts.models.bark import Model

    t0 = time.perf_counter()
    Model._tokenizer = Model._codec = None
    cpu, cpu_load = timed_load(str(reduced), device="cpu", dtype=torch.float32)
    want = bark_logit_rows(cpu)
    del cpu
    card, _ = timed_load(str(reduced), device="cuda", dtype=torch.float32)
    got = bark_logit_rows(card)
    bad = bark_logit_rows(card, fault=True, plants=False)
    gaps, fault = csm_gaps(got, want), csm_gaps(bad, want)

    def ok(g):
        return all(d <= CARD_VS_CPU_ATOL * peak and d <= BARK_LAYER_BAR * add
                   for d, peak, add in g)

    worst = max(g[0] / min(CARD_VS_CPU_ATOL * g[1], BARK_LAYER_BAR * g[2]) for g in gaps)
    log(f"[bark] two-layer copy, float32, card against CPU: {len(gaps)} calls' logits (the "
        f"semantic prefill and {BARK_CPU_STEPS} teacher-forced steps, a coarse window's prefill "
        f"and {BARK_CPU_STEPS - 1} steps, the fine stack's 6 codebooks over 512 frames), max|d| "
        f"{max(g[0] for g in gaps):.3e}, peaks >= {min(g[1] for g in gaps):.3f} (bar "
        f"{CARD_VS_CPU_ATOL:g} of each), what the layers add >= {min(g[2] for g in gaps):.4f} "
        f"(bar {BARK_LAYER_BAR:g} of each), worst share of its bar {worst:.3f}; an off-by-one "
        f"decode position parts them by {max(g[0] for g in fault):.3e} "
        f"({time.perf_counter() - t0:.1f} s, the CPU load {cpu_load:.1f} s)")
    if len(gaps) != 2 * BARK_CPU_STEPS + 7 or not ok(gaps):
        raise SystemExit("chip_smoke: the Bark two-layer copy parts card from CPU")
    if ok(fault):
        raise SystemExit("chip_smoke: the Bark check passes an off-by-one decode position")
    del card
    Model._tokenizer = Model._codec = None
    return {"logits_max_abs_err": max(g[0] for g in gaps), "layers_add": min(g[2] for g in gaps),
            "worst_share_of_bar": worst, "fault_gap": max(g[0] for g in fault), "calls": len(gaps),
            "wall_s": time.perf_counter() - t0}


def bark_generate(bark, plant, smi) -> dict:
    """`Model.generate` of BARK_TEXT, sampled (0.7, fine 0.5), BARK_TIMED
    times after a warm-up, each stage timed; 32 semantic steps profiled
    (less the prefill, profiled alone); the semantic stage run to its
    768-step cap with the plant lifted (greedy, the stop's head row at 0:
    its last step reads position 1024)."""
    from mlx_audio_tpu_torch.tts.models.bark import bark as bk

    stages = ("generate_text_semantic", "generate_coarse", "generate_fine", "decode_codes")
    split = {s: [] for s in stages}

    def timed(name):
        orig = getattr(bark, name)

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            split[name].append(time.perf_counter() - t0)
            return out
        return run

    for name in stages:
        setattr(bark, name, timed(name))
    try:
        with torch.inference_mode():
            list(bark.generate(BARK_TEXT, seed=100))  # warm-up (EnCodec loads from encodec/)
            for s in stages:
                split[s].clear()
            zero_port_launches()
            walls, outs = [], []
            for seed in range(BARK_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(list(bark.generate(BARK_TEXT, seed=seed)))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        launches = no_port_launches("Bark's float32 generate")
    finally:
        for name in stages:
            delattr(bark, name)
    wall = statistics.median(walls)
    audio_s = BARK_FRAMES * 320 / 24000
    med = {s: statistics.median(v) for s, v in split.items()}

    gpt = bark.semantic
    dev = bark.device
    ids = torch.as_tensor(bark.text_ids(BARK_TEXT)[None], device=dev)
    hist = torch.full_like(ids, bk.SEMANTIC_PAD_TOKEN)

    def sem(steps):
        def run():
            with torch.inference_mode():
                gen = torch.Generator(device=dev).manual_seed(0)
                bk.semantic_rows(gpt, bk.semantic_prefill(gpt, ids, hist),
                                 torch.full((1,), 0.7, device=dev),
                                 lambda i: bk.gumbel_rows([gen], (10001,), dev), steps)
            torch.cuda.synchronize()
        return run

    sem(BARK_PROFILE_STEPS)()
    _, _ = profile_one_run(sem(0), "the semantic prefill")
    pre = dict(profile_one_run.last)
    _, _ = profile_one_run(sem(BARK_PROFILE_STEPS),
                           f"the semantic prefill and {BARK_PROFILE_STEPS} steps")
    prof = dict(profile_one_run.last)
    steps = BARK_PROFILE_STEPS
    per_step = {"launches": (prof["launches"] - pre["launches"]) / steps,
                "device_ms": (prof["device_ms"] - pre["device_ms"]) / steps,
                "wall_ms": (prof["wall_ms"] - pre["wall_ms"]) / steps}

    w = gpt.position_embeds_layer.weight
    head = gpt.lm_head.weight
    stop_row = head[bk.SEMANTIC_PAD_TOKEN].clone()
    with torch.no_grad():
        w[256 + BARK_TOKENS] -= plant
        head[bk.SEMANTIC_PAD_TOKEN] = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        capped = bark.generate_text_semantic(BARK_TEXT, None, temperature=0.0)
        torch.cuda.synchronize()  # a device-side assert would surface here
        capped_s = time.perf_counter() - t0
    finally:
        with torch.no_grad():
            w[256 + BARK_TOKENS] += plant
            head[bk.SEMANTIC_PAD_TOKEN] = stop_row
    n = [o[0].token_count for o in outs]
    log(f"[bark] generate (sampled 0.7, fine 0.5), {BARK_TIMED} runs after a warm-up: "
        f"{n} semantic tokens, {audio_s:.3f} s of audio, median wall {wall:.4f} s (RTF "
        f"{wall / audio_s:.4f}; walls {[round(x, 4) for x in walls]}); median split: semantic "
        f"{med['generate_text_semantic']:.4f} s, coarse {med['generate_coarse']:.4f} s, fine "
        f"{med['generate_fine']:.4f} s, EnCodec decode {med['decode_codes']:.4f} s; the port's "
        f"kernels launched {launches} ({smi})")
    log(f"[bark] profiled semantic steps: {per_step['launches']:.0f} launches and "
        f"{per_step['device_ms']:.3f} ms of device time in {per_step['wall_ms']:.3f} ms of wall "
        f"a step (idle share {100 * (1 - per_step['device_ms'] / per_step['wall_ms']):.1f}%; the "
        f"prefill {pre['launches']} launches, {pre['device_ms']:.2f} ms of device time)")
    log(f"[bark] the semantic stage to its cap (plant lifted, greedy): {len(capped)} tokens in "
        f"{capped_s:.4f} s, its last step at position 1024, clamped to row 1023, no device "
        f"assert")
    if (any(o[0].token_count != BARK_TOKENS or len(o) != 1 for o in outs)
            or any(o[0].audio.shape != (BARK_FRAMES * 320,) or not np.isfinite(o[0].audio).all()
                   for o in outs)
            or len(capped) != bk.SEMANTIC_MAX_STEPS):
        raise SystemExit("chip_smoke: Bark's generate left the planted length, gave non-finite "
                         "audio, or the semantic stage stopped short of its cap")
    return {"tokens": n, "audio_s": audio_s, "wall_s": wall, "walls_s": walls,
            "rtf": wall / audio_s, "split_s": med, "launches": launches,
            "semantic_step": per_step, "profile": prof, "prefill_profile": pre,
            "capped_tokens": len(capped), "capped_s": capped_s}


def bark_batched(bark) -> dict:
    """`BarkBatcher` at BARK_BATCH rows: four sampled requests at once, each
    one's codes equal to its run alone through the same pool and its audio
    within ENCODEC_ATOL of the peak (cuDNN's transposed convolutions may sum
    in another order from call to call); the speedup over the four alone."""
    from concurrent.futures import ThreadPoolExecutor

    local = threading.local()
    codes = {}
    decode = bark.decode_codes

    def spy(fine):
        codes.setdefault(local.key, []).append(np.array(fine))
        return decode(fine)

    def one(i, tag):
        local.key = (tag, i)
        with torch.inference_mode():
            return list(bark.generate(HTTP_TEXTS[i], seed=i))[0]

    bark.decode_codes = spy
    b = bark.make_batcher(max_batch=BARK_BATCH).install()
    try:
        b.warmup()
        d0 = b.dispatch_count
        t0 = time.perf_counter()
        with ThreadPoolExecutor(BARK_BATCH) as pool:
            futs = [pool.submit(one, i, "batched") for i in range(BARK_BATCH)]
            batched = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        batched_s, dispatches = time.perf_counter() - t0, b.dispatch_count - d0
        t0 = time.perf_counter()
        alone = [one(i, "alone") for i in range(BARK_BATCH)]
        alone_s = time.perf_counter() - t0
    finally:
        b.close()
        del bark.decode_codes
    same = [np.array_equal(codes[("batched", i)][0], codes[("alone", i)][0])
            for i in range(BARK_BATCH)]
    peak = max(float(np.abs(a.audio).max()) for a in alone)
    audio_d = max(float(np.abs(x.audio - y.audio).max()) for x, y in zip(batched, alone))
    log(f"[bark] BarkBatcher ({BARK_BATCH} rows): {BARK_BATCH} sampled requests in "
        f"{batched_s:.4f} s ({dispatches} fused dispatches), alone through the pool "
        f"{alone_s:.4f} s: speedup {alone_s / batched_s:.2f}x; codes equal to alone: {same}, "
        f"audio max|d| {audio_d:.2e} of peak {peak:.4f}")
    if (not all(same) or audio_d > ENCODEC_ATOL * peak
            or len({codes[("batched", i)][0].tobytes() for i in range(BARK_BATCH)}) != BARK_BATCH
            or any(x.token_count != BARK_TOKENS for x in batched)):
        raise SystemExit("chip_smoke: BarkBatcher's codes part from each request's alone")
    return {"rows": BARK_BATCH, "batched_s": batched_s, "alone_s": alone_s,
            "speedup": alone_s / batched_s, "dispatches": dispatches,
            "audio_max_abs_err": audio_d}


def bark_served(bark, path: Path) -> dict:
    """One speech request through `server.py` after the provider's
    BarkBatcher warm-up (one call of each stage on padding); the served
    samples equal the in-memory model's through an identical pool, within
    one int16 step (cuDNN's transposed convolutions)."""
    from mlx_audio_tpu_torch import server
    from mlx_audio_tpu_torch.serving import get_infer_hook

    provider = server.ModelProvider()
    httpd = server.serve_stdlib("127.0.0.1", 0, provider)
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    name = str(path)
    try:
        rec = load_served(url, provider, name)
        body, ttfb, wall = http_speech_timed(url, {"model": name, "input": BARK_TEXT,
                                                   "response_format": "wav"})
        batcher = get_infer_hook(provider.load_model(name))
        threads = [s._thread for s in (batcher.sem_sched, batcher.coarse_sched,
                                       batcher.fine_sched)]
        status, _ = http_json(f"{url}/v1/models/{name}", method="DELETE")
        for t in threads:
            t.join(60)
        if status != 200 or any(t.is_alive() for t in threads):
            raise SystemExit(f"chip_smoke: DELETE {name} answered {status} or left a "
                             "BarkBatcher thread alive")
        b = bark.make_batcher().install()
        try:
            with torch.inference_mode():
                want = list(bark.generate(BARK_TEXT))[0].audio
        finally:
            b.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        for n in provider.list_models():
            provider.unload(n)
    got = np.frombuffer(body[44:], np.int16).astype(np.int32)
    ref = np.frombuffer(pcm16(want), np.int16).astype(np.int32)
    steps = int(np.abs(got - ref).max()) if got.shape == ref.shape else -1
    log(f"[bark] served over HTTP (BarkBatcher, warmed): {len(want) / 24000:.3f} s of audio, "
        f"time to first byte {ttfb:.4f} s, wall {wall:.4f} s (load {rec['load_s']:.1f} s, "
        f"warm-up {rec['warmup_s']:.1f} s); the in-memory model's samples within {steps} int16 "
        f"steps")
    if body[:4] != b"RIFF" or not 0 <= steps <= 1 or len(want) != BARK_FRAMES * 320:
        raise SystemExit(f"chip_smoke: the served Bark speech ({len(body)} bytes) is not the "
                         f"in-memory model's samples ({len(want)})")
    return {"ttfb_s": ttfb, "wall_s": wall, "int16_steps": steps, **rec}


def bark_launches(sem_steps: int, coarse_steps: int) -> dict:
    """Quantized launches of `bark_logit_rows(plants=False)` on int4 Bark by
    the routing guard (`route_table`): each layer's att_proj, out_proj,
    in_proj and the MLP's out_proj, and the head, at each call's rows. The
    semantic prefill (257 rows, its head on the last row), the steps (one
    row); the coarse prefill (317 rows, its head on the context's last row),
    its steps less the last, which computes nothing past its token; the fine
    stack's six calls over 512 rows. The embeddings dequantize their rows
    and launch nothing."""
    n, proj, _ = route_table(4)

    def calls(cfg, M, times=1):
        D = cfg["n_embd"]
        for N, K in ((3 * D, D), (D, D), (4 * D, D), (D, 4 * D)):
            proj(N, K, M, cfg["n_layer"] * times)

    s, c, f = (BARK_CFG[k] for k in BARK_STAGES)
    calls(s, 257)
    calls(s, 1, sem_steps)
    proj(s["output_vocab_size"], s["n_embd"], 1, sem_steps + 1)
    calls(c, 317)
    calls(c, 1, coarse_steps - 1)
    proj(c["output_vocab_size"], c["n_embd"], 1, coarse_steps)
    calls(f, 512, 6)
    proj(f["output_vocab_size"], f["n_embd"], 512, 6)
    return n


def bark_int4(path: Path, tmp: Path) -> dict:
    """int4 g64 by `convert(quantize=True)` (every Linear and embedding table,
    as the JAX package's convert does), loaded: BARK_INT4_TOKENS semantic
    steps, one coarse window and one fine chunk, teacher-forced, with the
    quantized launches held to `bark_launches`; their logits held to the
    float32 model on the dequantized weights, within BARK_INT4_BAR of each
    peak."""
    from mlx_audio_tpu_torch import convert
    from mlx_audio_tpu_torch.nn.module import load_weights
    from mlx_audio_tpu_torch.nn.quantized import QuantizedEmbedding
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.tts.models.bark import Model
    from mlx_audio_tpu_torch.utils import load_weight_files

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        q = convert.convert(str(path), str(tmp / "bark-small-4bit"), quantize=True)
    convert_s = time.perf_counter() - t0
    q4, q_load_s = timed_load(str(q))
    embeds = type(q4.semantic.input_embeds_layer).__name__
    deq = Model(BARK_CFG, device="cuda")
    load_weights(deq, convert.dequantize_weights(load_weight_files(q), 4, GROUP))
    kw = dict(plants=False, sem_steps=BARK_INT4_TOKENS, coarse_steps=60)
    bark_logit_rows(q4, **kw)  # warm-up
    torch.cuda.synchronize()
    qk.reset_launches()
    t0 = time.perf_counter()
    rows = bark_logit_rows(q4, **kw)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    got = quant_counts(4)
    predicted = bark_launches(BARK_INT4_TOKENS, 60)
    want = bark_logit_rows(deq, **kw)
    gaps = csm_gaps(rows, [(w, w) for w, _ in want])
    worst = max(d / peak for d, peak, _ in gaps)
    log(f"[bark] int4 g64 by convert(quantize=True) in {convert_s:.1f} s, loaded in "
        f"{q_load_s:.1f} s (tables: {embeds}); {BARK_INT4_TOKENS} semantic steps, a coarse "
        f"window of 60, a fine chunk of 512, teacher-forced, in {wall4:.4f} s: launches {got}, "
        f"from the code {predicted}; {len(gaps)} calls' logits against the float32 model on the "
        f"dequantized weights: max|d| {max(g[0] for g in gaps):.3e}, worst share of the peak "
        f"{worst:.2e} (bar {BARK_INT4_BAR:g})")
    if got != predicted or worst > BARK_INT4_BAR or embeds != QuantizedEmbedding.__name__:
        raise SystemExit(f"chip_smoke: the int4 Bark launched {got} (the code says "
                         f"{predicted}), or its logits part from the dequantized model's")
    del q4, deq
    shutil.rmtree(q, ignore_errors=True)
    Model._tokenizer = Model._codec = None
    gc.collect()
    torch.cuda.empty_cache()
    return {"convert_s": convert_s, "load_s": q_load_s, "wall_s": wall4, "launches": got,
            "tables": embeds, "logits_max_abs_err": max(g[0] for g in gaps),
            "worst_share_of_peak": worst}


def phase_bark(smi: str) -> dict:
    """Phase 16 (see the module docstring)."""
    from mlx_audio_tpu_torch.tts.models.bark import Model as Bark

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[bark] {time.perf_counter() - t_phase:.1f} s into phase 16 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="bark-"))
    try:
        enc = encodec_seeded()
        enc_rec = encodec_checks(enc)
        mark("EnCodec")
        path, reduced = tmp / "bark-small", tmp / "bark-small-2layer"
        source = Bark(BARK_CFG, device="cuda", seed=20)
        plant = plant_bark_stop(source, BARK_TOKENS, seed=20)
        write_s, nbytes = write_bark(path, reduced, source, enc)
        del enc
        Bark._tokenizer = Bark._codec = None
        bark, load_s = timed_load(str(path))
        same_parameters(bark, source, "Bark-small")
        del source
        log(f"[bark] Bark-small float32 (three GPTs of 12 x 768, 12 heads of 64, semantic "
            f"129,600 in / 10,048 out, coarse 12,096, fine 1,056 over 8 codebooks), the stop "
            f"planted after {BARK_TOKENS} semantic tokens, a WordPiece tokenizer.json of "
            f"{BARK_WORDPIECE} entries and EnCodec in encodec/, seeded: "
            f"{sum(p.numel() for p in bark.parameters()) / 1e6:.1f} M parameters, "
            f"{nbytes / 1e9:.3f} GB written in {write_s:.1f} s (with the two-layer copy), "
            f"loaded by utils.load_model in {load_s:.2f} s, equal to the source")
        mark("writing and loading")
        cpu = bark_two_layer(reduced)
        mark("the two-layer copy")
        gen = bark_generate(bark, plant, smi)
        mark("generate")
        batched = bark_batched(bark)
        mark("BarkBatcher")
        served = bark_served(bark, path)
        mark("the served request")
        del bark
        Bark._tokenizer = Bark._codec = None
        gc.collect()
        torch.cuda.empty_cache()
        int4 = bark_int4(path, tmp)
        mark("int4")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        Bark._tokenizer = Bark._codec = None
    rec = {"encodec": enc_rec, "write_s": write_s, "checkpoint_bytes": nbytes,
           "load_s": load_s, "card_vs_cpu": cpu, "generate": gen, "batched": batched,
           "served": served, "int4": int4, "phase_s": time.perf_counter() - t_phase}
    log(f"[bark] phase 16 wall {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 17: Vocos, Soprano, Spark-TTS, Wav2Vec2
# ---------------------------------------------------------------------------

# Spark-TTS-0.5B: the LLM at the JAX Model's defaults (Qwen2.5-0.5B), BiCodec
# at the published BiCodec/config.yaml's widths, Wav2Vec2-XLSR-53
SPARK_LLM = dict(vocab_size=166000, hidden_size=896, intermediate_size=4864,
                 num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
                 rope_theta=1000000.0, tie_word_embeddings=True)
BICODEC_CFG = {
    "mel_params": {"sample_rate": 16000, "n_fft": 1024, "win_length": 640, "hop_length": 320,
                   "mel_fmin": 10, "mel_fmax": None, "num_mels": 128},
    "encoder": {"input_channels": 1024, "vocos_dim": 384, "vocos_intermediate_dim": 2048,
                "vocos_num_layers": 12, "out_channels": 1024, "sample_ratios": [1, 1]},
    "decoder": {"input_channel": 1024, "channels": 1536, "rates": [8, 5, 4, 2],
                "kernel_sizes": [16, 11, 8, 4]},
    "quantizer": {"input_dim": 1024, "codebook_size": 8192, "codebook_dim": 8,
                  "commitment": 0.25, "codebook_loss_weight": 2.0,
                  "use_l2_normlize": True, "threshold_ema_dead_code": 0.2},
    "speaker_encoder": {"input_dim": 128, "out_dim": 1024, "latent_dim": 128,
                        "token_num": 32, "fsq_levels": [4, 4, 4, 4, 4, 4],
                        "fsq_num_quantizers": 1},
    "prenet": {"input_channels": 1024, "vocos_dim": 384, "vocos_intermediate_dim": 2048,
               "vocos_num_layers": 12, "out_channels": 1024, "condition_dim": 1024,
               "sample_ratios": [1, 1], "use_tanh_at_final": False},
    "postnet": {"input_channels": 1024, "vocos_dim": 384, "vocos_intermediate_dim": 2048,
                "vocos_num_layers": 6, "out_channels": 1024, "use_tanh_at_final": False},
}
BICODEC_TOP = {"sample_rate": 16000, "ref_segment_duration": 6, "latent_hop_length": 320,
               "volume_normalize": True}
XLSR_CFG = dict(model_type="wav2vec2", vocab_size=0, hidden_size=1024, num_hidden_layers=24,
                num_attention_heads=16, intermediate_size=4096, feat_extract_norm="layer",
                do_stable_layer_norm=True, conv_bias=True)
W2V_BASE_CFG = dict(model_type="wav2vec2")  # wav2vec2-base-960h: the ModelConfig defaults
SPARK_EOS = "<|im_end|>"


def spark_succ(tok, n_global: int, n_semantic: int, seed: int = 0) -> tuple:
    """The planted successor map of a Spark LLM and its paths: the control
    prompt's <|end_style_label|> leads through n_global distinct global
    tokens to the semantic path, the clone prompt's <|end_global_token|>
    straight to it, and n_semantic distinct semantic tokens end at the eos.
    → (succ, global codes, semantic codes)."""
    rng = np.random.default_rng(seed)
    glob = rng.permutation(_count(tok, "global"))[:n_global]
    sem = rng.permutation(_count(tok, "semantic"))[:n_semantic]
    g_ids = [tok.token_to_id(f"<|bicodec_global_{int(i)}|>") for i in glob]
    s_ids = [tok.token_to_id(f"<|bicodec_semantic_{int(i)}|>") for i in sem]
    succ = {tok.token_to_id("<|end_style_label|>"): g_ids[0],
            tok.token_to_id("<|end_global_token|>"): s_ids[0]}
    chain = g_ids + s_ids + [tok.token_to_id(SPARK_EOS)]
    succ.update(zip(chain, chain[1:]))
    return succ, glob, sem


def _count(tok, kind: str) -> int:
    """The number of <|bicodec_{kind}_N|> tokens the tokenizer has."""
    n = 0
    while tok.token_to_id(f"<|bicodec_{kind}_{n}|>") is not None:
        n += 1
    return n


def write_spark_dir(path: Path, llm_cfg: dict, llm_flat: dict, bicodec_cfg: dict,
                    bicodec_flat: dict, w2v_cfg: dict, w2v_flat: dict, tok_path: Path) -> Path:
    """A Spark-TTS checkpoint directory as the loader reads it: config.json
    (model_type spark, the LLM's widths) and the LLM's weights under `llm.`,
    tokenizer.json with a tokenizer_config.json naming the eos, BiCodec/
    (config.yaml, model.safetensors) and wav2vec2-large-xlsr-53/."""
    import yaml

    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.safetensors_io import save_file

    path = Path(path)
    save_model(path, llm_flat, {"model_type": "spark", "sample_rate": 16000, "llm": llm_cfg})
    shutil.copy(tok_path, path / "tokenizer.json")
    (path / "tokenizer_config.json").write_text(json.dumps({"eos_token": SPARK_EOS}))
    (path / "BiCodec").mkdir(exist_ok=True)
    (path / "BiCodec" / "config.yaml").write_text(yaml.safe_dump(
        dict(BICODEC_TOP, audio_tokenizer=bicodec_cfg)))
    save_file({k: np.ascontiguousarray(np.asarray(v)) for k, v in bicodec_flat.items()},
              path / "BiCodec" / "model.safetensors")
    save_model(path / "wav2vec2-large-xlsr-53", w2v_flat, w2v_cfg)
    return path


# Soprano: the decoder at DecoderConfig()'s widths (Soprano-1.1), its LM a
# Qwen3 stand-in of about 80M parameters (Soprano-1.1-80M's config.json is
# not in the repository)
SOPRANO_CFG = dict(model_type="qwen3", vocab_size=16384, hidden_size=512,
                   intermediate_size=2048, num_hidden_layers=18, num_attention_heads=8,
                   num_key_value_heads=4, head_dim=64, rope_theta=1000000.0,
                   tie_word_embeddings=True, sample_rate=32000)
SOPRANO_TOKENS = 100  # planted: 6.4 s of audio at 32 kHz
SOPRANO_TEXT = "The quick brown fox jumps over the lazy dog."
SOPRANO_TEXTS = (SOPRANO_TEXT, "Hello world.", "The model turns text into speech.",
                 "A seeded line for the batcher.")
SOPRANO_PROFILE_STEPS = 32
SOPRANO_BATCH_TOKENS = 48  # each batched request's cap, mid-path
SPARK_BATCH_TOKENS = 64  # the globals and 31 semantic tokens
SPARK_TOKENS = 75  # planted: 1.5 s of audio at 50 semantic tokens a second (150 until 19)
SPARK_GLOBALS = 32
SPARK_TEXT = HTTP_TEXT
SPARK_TEXTS = (SPARK_TEXT, "Hello world.", "The model turns text into speech.",
               "A seeded line for the batcher.")
SPARK_REF_S = 6.0
SPARK_INT4_TOKENS = 16
SPARK_PROFILE_STEPS = 32
SPARK_CPU_TOKENS = 8
W2V_S = 30.0  # 1,499 frames: past the flash route's 1280
# upstream's vocos-mel-24khz and vocos-encodec-24khz config.yaml
VOCOS_MEL_CFG = {
    "feature_extractor": {"class_path": "vocos.feature_extractors.MelSpectrogramFeatures",
                          "init_args": {"sample_rate": 24000, "n_fft": 1024, "hop_length": 256,
                                        "n_mels": 100, "padding": "center"}},
    "backbone": {"class_path": "vocos.models.VocosBackbone",
                 "init_args": {"input_channels": 100, "dim": 512, "intermediate_dim": 1536,
                               "num_layers": 8}},
    "head": {"class_path": "vocos.heads.ISTFTHead",
             "init_args": {"dim": 512, "n_fft": 1024, "hop_length": 256, "padding": "center"}}}
VOCOS_ENCODEC_CFG = {
    "feature_extractor": {"class_path": "vocos.feature_extractors.EncodecFeatures",
                          "init_args": {"encodec_model": "encodec_24khz",
                                        "bandwidths": [1.5, 3.0, 6.0, 12.0]}},
    "backbone": {"class_path": "vocos.models.VocosBackbone",
                 "init_args": {"input_channels": 128, "dim": 384, "intermediate_dim": 1152,
                               "num_layers": 8, "adanorm_num_embeddings": 4}},
    "head": {"class_path": "vocos.heads.ISTFTHead",
             "init_args": {"dim": 384, "n_fft": 1280, "hop_length": 320, "padding": "same"}}}
VOCOS_S = 5.0
VOCOS_BANDWIDTH_ID = 2  # 6 kbps: 8 codebooks


def close_to(got, want) -> tuple:
    """(max|d|, the reference's peak) of two tensors or arrays."""
    g = torch.as_tensor(got).float().cpu()
    w = torch.as_tensor(want).float().cpu()
    if g.shape != w.shape:
        raise SystemExit(f"chip_smoke: shapes part: {tuple(g.shape)} against {tuple(w.shape)}")
    return (g - w).abs().max().item(), w.abs().max().item()


def held_close(label, got, want, bar=CARD_VS_CPU_ATOL) -> float:
    err, peak = close_to(got, want)
    log(f"[held] {label}: max|d| {err:.3e}, {err / max(peak, 1e-30):.2e} of the peak "
        f"{peak:.4g} (bar {bar:g})")
    if not err <= bar * peak:
        raise SystemExit(f"chip_smoke: {label} parts: max|d| {err} over {bar:g} of {peak}")
    return err / max(peak, 1e-30)


def vocos_checks(enc, smi) -> dict:
    """vocos-mel-24khz on 5 s and vocos-encodec-24khz on phase 16's EnCodec
    codes of the same 5 s at 6 kbps (bandwidth id 2), card against CPU in
    float32, with decode ms on the card."""
    from mlx_audio_tpu_torch.codec.models import Encodec, EncodecConfig, Vocos

    rec = {}
    audio = torch.as_tensor(csm_reference(VOCOS_S, 21))
    card = Vocos.from_hparams(VOCOS_MEL_CFG, device="cuda", seed=21)
    cpu = Vocos.from_hparams(VOCOS_MEL_CFG, device="cpu", seed=21)
    cpu.load_state_dict(card.state_dict())
    with torch.inference_mode():
        feats = card.feature_extractor(audio.cuda())
        feats_cpu = cpu.feature_extractor(audio)
    rel_f = held_close("vocos-mel-24khz features (100 mels, 5 s), card against CPU", feats,
                       feats_cpu)
    rel = held_close("vocos-mel-24khz decode of those features, card against CPU",
                     card.decode(feats), cpu.decode(feats_cpu))
    ms = time_ms(lambda: card.decode(feats), iters=10)
    whole = time_ms(lambda: card(audio.cuda()), iters=10)
    log(f"[vocos] vocos-mel-24khz (backbone 512/1536 x 8, n_fft 1024, hop 256), 5 s: decode "
        f"{ms:.3f} ms, features and decode {whole:.3f} ms ({smi})")
    rec["mel"] = {"features_rel": rel_f, "decode_rel": rel, "decode_ms": ms,
                  "features_and_decode_ms": whole}

    enc_cpu = Encodec(EncodecConfig(), device="cpu")
    enc_cpu.load_state_dict(enc.state_dict())
    card = Vocos.from_hparams(VOCOS_ENCODEC_CFG, device="cuda", seed=22, encodec=enc)
    cpu = Vocos.from_hparams(VOCOS_ENCODEC_CFG, device="cpu", seed=22, encodec=enc_cpu)
    cpu.load_state_dict(card.state_dict())
    codes = card.get_encodec_codes(audio.cuda(), VOCOS_BANDWIDTH_ID)
    codes_cpu = cpu.get_encodec_codes(audio, VOCOS_BANDWIDTH_ID)
    same = torch.equal(codes.cpu(), codes_cpu)
    log(f"[vocos] vocos-encodec-24khz: EnCodec codes of 5 s at 6 kbps {tuple(codes.shape)}, "
        f"identical card against CPU: {same}")
    if not same or codes.shape[0] != 8:
        raise SystemExit("chip_smoke: the EnCodec codes under Vocos part card from CPU")
    rel = held_close("vocos-encodec-24khz decode_from_codes (bandwidth id 2), card against CPU",
                     card.decode_from_codes(codes, bandwidth_id=VOCOS_BANDWIDTH_ID),
                     cpu.decode_from_codes(codes_cpu, bandwidth_id=VOCOS_BANDWIDTH_ID))
    ms = time_ms(lambda: card.decode_from_codes(codes, bandwidth_id=VOCOS_BANDWIDTH_ID),
                 iters=10)
    log(f"[vocos] vocos-encodec-24khz (backbone 384/1152 x 8, adanorm over 4 bandwidths, n_fft "
        f"1280, hop 320): decode_from_codes of 5 s {ms:.3f} ms ({smi})")
    rec["encodec"] = {"codes": list(codes.shape), "decode_rel": rel, "decode_ms": ms}
    del card, cpu, enc_cpu
    torch.cuda.empty_cache()
    return rec


def soprano_path(tok, n: int = SOPRANO_TOKENS, seed: int = 0) -> list:
    """[START], n distinct ordinary tokens, [STOP]."""
    rng = np.random.default_rng(seed)
    body = [int(t) for t in rng.permutation(np.arange(400, 16000))[:n]]
    return [tok.token_to_id("[START]")] + body + [tok.token_to_id("[STOP]")]


def write_soprano(path: Path, reduced: Path, tok_dir: Path, seed: int = 23) -> tuple:
    """Soprano-1.1 with the stand-in LM in float32, the planted path, a
    tokenizer.json (and its tokenizer_config.json) with Soprano's markers,
    the LM at the top level (`model.*`) as the published file has it, and
    its first two layers as a copy. → (seconds, bytes, the path)."""
    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import flatten_params
    from mlx_audio_tpu_torch.tokenizer_json import load
    from mlx_audio_tpu_torch.tts.models.soprano import Model

    t0 = time.perf_counter()
    tok = load(write_tokenizer_json(tok_dir, "soprano"))
    (tok_dir / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<|endoftext|>"}))
    path_ids = soprano_path(tok)
    model = Model(SOPRANO_CFG, device="cuda", seed=seed)
    plant_outetts(model.language_model, dict(zip(path_ids, path_ids[1:])), seed)
    flat = {(k[len("language_model."):] if k.startswith("language_model.") else k): v
            for k, v in flatten_params(model).items()}
    del model
    two = {k: v for k, v in flat.items()
           if not k.startswith("model.layers.") or int(k.split(".")[2]) < 2}
    for where, weights, n in ((path, flat, SOPRANO_CFG["num_hidden_layers"]), (reduced, two, 2)):
        save_model(where, weights, dict(SOPRANO_CFG, num_hidden_layers=n))
        for name in ("tokenizer.json", "tokenizer_config.json"):
            shutil.copy(tok_dir / name, where / name)
    torch.cuda.empty_cache()
    return time.perf_counter() - t0, checkpoint_bytes(path), path_ids


def soprano_checks(tmp: Path, smi: str) -> dict:
    """Phase 17's Soprano part (see the module docstring)."""
    from mlx_audio_tpu_torch.tts.models.soprano import Model
    from mlx_audio_tpu_torch.tts.models.soprano.soprano import _decode_with_hidden

    rec = {}
    path, reduced = tmp / "Soprano-1.1-80M", tmp / "Soprano-1.1-2layer"
    tok_dir = tmp / "soprano-tok"
    tok_dir.mkdir()
    write_s, nbytes, planted = write_soprano(path, reduced, tok_dir)
    model, load_s = timed_load(str(path))
    lm = model.language_model
    n_lm = sum(p.numel() for p in lm.parameters())
    n_dec = sum(p.numel() for p in model.decoder.parameters())
    log(f"[soprano] Soprano-1.1 (decoder 768/2304 x 8, dw kernel 3, n_fft 2048, hop 512, 32 "
        f"kHz) with a Qwen3 stand-in LM of {n_lm / 1e6:.1f} M parameters (18 x 512, 8 heads, 4 "
        f"KV heads, 16,384 tokens, tied), float32, the path planted ({SOPRANO_TOKENS} tokens, "
        f"then [STOP]): decoder {n_dec / 1e6:.1f} M parameters; {nbytes / 1e9:.3f} GB written in "
        f"{write_s:.1f} s, loaded by utils.load_model in {load_s:.2f} s")
    if model.config.decoder_config.decoder_dim != 768:
        raise SystemExit("chip_smoke: the Soprano-1.1 directory did not keep the 768 decoder")
    s1, s2 = model._stop_ids()
    ids = model.tokenizer.encode(f"[STOP][TEXT]{model._sentences(SOPRANO_TEXT)[0]}[START]",
                                 add_special_tokens=False)

    # the two-layer copy in float32, card against CPU
    t0 = time.perf_counter()
    cpu, _ = timed_load(str(reduced), device="cpu")
    card, _ = timed_load(str(reduced), device="cuda")
    h_cpu, n_cpu = _decode_with_hidden(cpu.language_model, ids, 16, 0.0, 1.0, (s1, s2))
    h_card, n_card = _decode_with_hidden(card.language_model, ids, 16, 0.0, 1.0, (s1, s2))
    rel_h = held_close("Soprano two-layer copy, 16 greedy steps' hidden states, card against CPU",
                       h_card, h_cpu)
    rel_a = held_close("Soprano two-layer copy, their decoder waveform, card against CPU",
                       card._decode_audio(h_card), cpu._decode_audio(h_cpu))
    if not n_cpu == n_card == min(16, SOPRANO_TOKENS):
        raise SystemExit(f"chip_smoke: the Soprano two-layer copy stopped at {n_card} on the "
                         f"card, {n_cpu} on the CPU")
    rec["card_vs_cpu"] = {"hidden_rel": rel_h, "audio_rel": rel_a,
                          "wall_s": time.perf_counter() - t0}
    del cpu, card

    # greedy generate on the planted path
    with torch.inference_mode():
        list(model.generate(SOPRANO_TEXT, temperature=0.0))  # warm-up
        torch.cuda.synchronize()
        zero_port_launches()
        t0 = time.perf_counter()
        res = list(model.generate(SOPRANO_TEXT, temperature=0.0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = no_port_launches("Soprano's float32 generate")
    audio_s = res[0].samples / model.sample_rate
    dc = model.config.decoder_config
    want = dc.upscale * SOPRANO_TOKENS * dc.hop_length  # (4n + 1 frames - 1) x hop
    if len(res) != 1 or res[0].token_count != SOPRANO_TOKENS or res[0].samples != want:
        raise SystemExit(f"chip_smoke: Soprano generated {[r.token_count for r in res]} tokens, "
                         f"{[r.samples for r in res]} samples; the path is {SOPRANO_TOKENS} "
                         f"tokens, {want} samples")
    if not np.isfinite(res[0].audio).all():
        raise SystemExit("chip_smoke: Soprano's waveform is not finite")
    with torch.inference_mode():
        _, _ = profile_one_run(lambda: _decode_with_hidden(lm, ids, 0, 0.0, 1.0, (s1, s2)),
                               "Soprano's prefill")
        pre = dict(profile_one_run.last)
        _, _ = profile_one_run(lambda: _decode_with_hidden(lm, ids, SOPRANO_PROFILE_STEPS, 0.0,
                                                           1.0, (s1, s2)),
                               f"Soprano's prefill and {SOPRANO_PROFILE_STEPS} steps")
        prof = dict(profile_one_run.last)
    steps = SOPRANO_PROFILE_STEPS
    per_step = {k: (prof[k] - pre[k]) / steps for k in ("launches", "device_ms", "wall_ms")}
    per_step["idle_share"] = 1 - per_step["device_ms"] / per_step["wall_ms"]
    log(f"[soprano] generate (greedy, {SOPRANO_TOKENS} tokens, {audio_s:.2f} s of audio): wall "
        f"{wall:.4f} s, RTF {wall / audio_s:.4f}, {SOPRANO_TOKENS / wall:.1f} tokens/s; a decode "
        f"step: {per_step['launches']:.0f} launches, {per_step['device_ms']:.3f} ms of device "
        f"time in {per_step['wall_ms']:.3f} ms of wall (idle {100 * per_step['idle_share']:.1f}%)"
        f"; the port's kernels launched {launches} ({smi})")
    rec["generate"] = {"wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
                       "tokens": SOPRANO_TOKENS, "launches": launches, "step": per_step}

    # SopranoBatcher: four requests, each equal to its run alone
    prompts = [model.tokenizer.encode(f"[STOP][TEXT]{model._sentences(t)[0]}[START]",
                                      add_special_tokens=False) for t in SOPRANO_TEXTS]
    n_b = SOPRANO_BATCH_TOKENS
    t0 = time.perf_counter()
    alone = [_decode_with_hidden(lm, p, n_b, 0.0, 1.0, (s1, s2)) for p in prompts]
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    b = model.make_batcher(slots=4, max_len=1024, tick_frames=16)
    try:
        b.warmup()
        t0 = time.perf_counter()
        futs = [b.submit(p, max_tokens=n_b, temperature=0.0, stop_ids=(s1, s2))
                for p in prompts]
        got = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        batch_s = time.perf_counter() - t0
        ticks = b.dispatch_count
    finally:
        b.close()
    rels = []
    for (h, n), g in zip(alone, got):
        if n != min(n_b, SOPRANO_TOKENS) or g.shape[0] != n + 1:
            raise SystemExit(f"chip_smoke: a batched Soprano request took {g.shape[0] - 1} "
                             f"tokens, alone {n}")
        rels.append(held_close("SopranoBatcher request against its run alone", g, h[0]))
    log(f"[soprano] SopranoBatcher, 4 requests x {n_b} tokens: {batch_s:.3f} s "
        f"batched ({ticks} ticks), {seq_s:.3f} s alone one after another: {seq_s / batch_s:.2f}x")
    rec["batched"] = {"wall_s": batch_s, "sequential_s": seq_s, "speedup": seq_s / batch_s,
                      "worst_rel": max(rels)}
    rec["served"] = served_speech(model, path, SOPRANO_TEXT, model.sample_rate, "soprano",
                                  want_samples=want)
    rec.update(write_s=write_s, checkpoint_bytes=nbytes, load_s=load_s)
    del model
    Model._tokenizer = None
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def served_speech(model, path: Path, text: str, sr: int, label: str, want_samples: int) -> dict:
    """One greedy speech request through `server.py` after the provider's
    batcher warm-up, equal to the in-memory model's samples through its own
    batcher within one int16 step; DELETE ends the batcher's thread."""
    from mlx_audio_tpu_torch import server

    provider = server.ModelProvider()
    httpd = server.serve_stdlib("127.0.0.1", 0, provider)
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    name = str(path)
    try:
        rec = load_served(url, provider, name)
        body, ttfb, wall = http_speech_timed(url, {"model": name, "input": text,
                                                   "temperature": 0.0,
                                                   "response_format": "wav"})
        unload_served(url, provider, name)
        b = model.make_batcher().install()
        try:
            with torch.inference_mode():
                want = list(model.generate(text, temperature=0.0))[0].audio
        finally:
            b.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        for n in provider.list_models():
            provider.unload(n)
    got = np.frombuffer(body[44:], np.int16).astype(np.int32)
    ref = np.frombuffer(pcm16(want), np.int16).astype(np.int32)
    steps = int(np.abs(got - ref).max()) if got.shape == ref.shape else -1
    log(f"[{label}] served over HTTP (its batcher, warmed): {len(want) / sr:.3f} s of audio, "
        f"time to first byte {ttfb:.4f} s, wall {wall:.4f} s (load {rec['load_s']:.1f} s, "
        f"warm-up {rec['warmup_s']:.1f} s); the in-memory model's samples within {steps} int16 "
        f"steps")
    if body[:4] != b"RIFF" or not 0 <= steps <= 1 or len(want) != want_samples:
        raise SystemExit(f"chip_smoke: the served {label} speech ({len(body)} bytes) is not the "
                         f"in-memory model's samples ({len(want)})")
    return {"ttfb_s": ttfb, "wall_s": wall, "int16_steps": steps, **rec}


def write_spark(path: Path, reduced: Path, tok_dir: Path, seed: int = 24) -> tuple:
    """Spark-TTS-0.5B: the LLM in bf16 with the planted path, BiCodec and
    Wav2Vec2-XLSR-53 in float32 (seeded), a tokenizer.json with Spark's
    tokens; the LLM's first two layers in float32 as a copy. → (seconds,
    bytes, the planted global and semantic codes)."""
    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import cast_floats, flatten_params
    from mlx_audio_tpu_torch.stt.models.wav2vec import Model as W2V
    from mlx_audio_tpu_torch.tokenizer_json import load
    from mlx_audio_tpu_torch.tts.models.spark import BiCodec, Model

    t0 = time.perf_counter()
    tok_path = write_tokenizer_json(tok_dir, "spark")
    tok = load(tok_path)
    succ, glob, sem = spark_succ(tok, SPARK_GLOBALS, SPARK_TOKENS, seed)
    model = Model({"llm": SPARK_LLM}, device="cuda", seed=seed)
    plant_outetts(model.llm, succ, seed)
    llm32 = {k[len("llm."):]: v for k, v in flatten_params(model).items()}
    two = {k: v for k, v in llm32.items()
           if not k.startswith("model.layers.") or int(k.split(".")[2]) < 2}
    save_model(reduced, two, {"model_type": "spark", "llm": dict(SPARK_LLM, num_hidden_layers=2)})
    del llm32, two
    llm = {k[len("llm."):]: v for k, v in flatten_params(cast_floats(model)).items()}
    del model
    bc = flatten_params(BiCodec.from_config(BICODEC_CFG, device="cuda", seed=seed + 1))
    xlsr = flatten_params(W2V(XLSR_CFG, device="cuda", seed=seed + 2))
    write_spark_dir(path, SPARK_LLM, llm, BICODEC_CFG, bc, XLSR_CFG, xlsr, tok_path)
    del llm, bc, xlsr
    torch.cuda.empty_cache()
    nbytes = sum(f.stat().st_size for f in Path(path).rglob("*.safetensors"))
    return time.perf_counter() - t0, nbytes, glob, sem


def spark_launches(llm: dict, calls) -> dict:
    """The quantized launches of int4 Spark LLM calls [(rows M, calls)] from
    the code: a layer's fused q/k/v, o_proj, fused gate/up and down through
    qmm where `qmm_routable` takes their shape (the fused MLP kernel's guard
    refuses I = 4864, not a multiple of 1024), the GEMV at M <= 4 and the
    tensor-core GEMM above; the tied head a `QuantizedEmbedding`, which
    takes `F.linear`, no kernel."""
    from mlx_audio_tpu_torch.nn.quantized import fused_mlp_routable, qmm_routable

    D, inter = llm["hidden_size"], llm["intermediate_size"]
    hd = D // llm["num_attention_heads"]
    shapes = [((llm["num_attention_heads"] + 2 * llm["num_key_value_heads"]) * hd, D),
              (D, llm["num_attention_heads"] * hd), (2 * inter, D), (D, inter)]
    got = {"qmm": 0, "qmlp": 0, "qmm_kernel": 0, "qmm_gemv": 0, "qmm_mma": 0}
    for M, n in calls:
        if fused_mlp_routable(4, GROUP, D, inter, D, M):
            raise SystemExit("chip_smoke: spark_launches counts the MLP through qmm, and the "
                             f"fused kernel's guard takes it at M = {M}")
        k = sum(qmm_routable(4, GROUP, N, K, M) for N, K in shapes) * llm["num_hidden_layers"] * n
        got["qmm"] += k
        got["qmm_gemv" if M <= 4 else "qmm_mma"] += k
    return got


def spark_checks(tmp: Path, smi: str) -> dict:
    """Phase 17's Spark-TTS and Wav2Vec2 parts (see the module docstring)."""
    from mlx_audio_tpu_torch import convert
    from mlx_audio_tpu_torch.lm.generate import generate_tokens
    from mlx_audio_tpu_torch.nn.module import load_weights
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention
    from mlx_audio_tpu_torch.stt.models.wav2vec import Model as W2V
    from mlx_audio_tpu_torch.tts.models.spark import Model
    from mlx_audio_tpu_torch.utils import load_weight_files

    rec = {}
    path, reduced = tmp / "Spark-TTS-0.5B", tmp / "Spark-TTS-2layer"
    tok_dir = tmp / "spark-tok"
    tok_dir.mkdir()
    write_s, nbytes, glob, sem = write_spark(path, reduced, tok_dir)
    spark, load_s = timed_load(str(path))
    t0 = time.perf_counter()
    rt = spark._resolve_runtime()
    rt_s = time.perf_counter() - t0
    bc, fe, tok = rt["bicodec"], rt["feature_extractor"], rt["tokenizer"]
    count = lambda m: sum(p.numel() for p in m.parameters()) / 1e6  # noqa: E731
    log(f"[spark] Spark-TTS-0.5B: the LLM (Qwen2.5-0.5B's widths, 24 x 896, 14 heads, 2 KV "
        f"heads, 166,000 tokens, tied) {count(spark):.1f} M parameters in bf16 with the planted "
        f"path ({SPARK_GLOBALS} global, then {SPARK_TOKENS} semantic tokens, then {SPARK_EOS}); "
        f"BiCodec {count(bc):.1f} M and Wav2Vec2-XLSR-53 {count(fe.model):.1f} M in float32, "
        f"seeded; {nbytes / 1e9:.3f} GB written in {write_s:.1f} s, loaded by utils.load_model "
        f"in {load_s:.2f} s, BiCodec and XLSR-53 from the directory in {rt_s:.2f} s")

    # the control route on the planted path
    kw = dict(temperature=0.0, gender="female", pitch=1.0, speed=1.0)
    with torch.inference_mode():
        # a short warm-up: the LLM's and BiCodec's first calls
        generate_tokens(spark.llm, [1] * 8, max_tokens=8, temp=0.0)
        bc.detokenize(np.zeros((1, 8), np.int64), np.zeros((1, SPARK_GLOBALS, 1), np.int64))
        torch.cuda.synchronize()
        zero_port_launches()
        t0 = time.perf_counter()
        res = list(spark.generate(SPARK_TEXT, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = no_port_launches("Spark's bf16 generate")
    # a semantic token's samples: the prenet's upsampling times the wave
    # generator's (1 x 320 at the published widths: 50 tokens a second)
    hop = int(np.prod(BICODEC_CFG["decoder"]["rates"])
              * np.prod(BICODEC_CFG["prenet"].get("sample_ratios", [1])))
    want_samples = SPARK_TOKENS * hop
    if len(res) != 1 or res[0].token_count != SPARK_TOKENS or res[0].samples != want_samples \
            or not np.isfinite(res[0].audio).all():
        raise SystemExit(f"chip_smoke: Spark's control route gave {[r.token_count for r in res]} "
                         f"semantic tokens, {[r.samples for r in res]} samples")
    ids = tok.encode(spark.process_prompt_control(SPARK_TEXT, "female", "moderate", "moderate"))
    eos = spark._eos_ids(tok)
    gen = dict(temp=0.0, repetition_penalty=1.3, repetition_context_size=20, eos_token_ids=eos)
    with torch.inference_mode():
        toks, _ = generate_tokens(spark.llm, ids, max_tokens=400, **gen)
        want = [tok.token_to_id(f"<|bicodec_global_{int(i)}|>") for i in glob] + [
            tok.token_to_id(f"<|bicodec_semantic_{int(i)}|>") for i in sem] + list(eos)
        if toks[0].tolist() != want:
            raise SystemExit("chip_smoke: Spark's greedy tokens left the planted path")
        _, _ = profile_one_run(lambda: generate_tokens(spark.llm, ids, max_tokens=1, **gen),
                               "Spark's prefill and a step")
        pre = dict(profile_one_run.last)
        _, _ = profile_one_run(lambda: generate_tokens(spark.llm, ids,
                                                       max_tokens=1 + SPARK_PROFILE_STEPS, **gen),
                               f"Spark's prefill and {1 + SPARK_PROFILE_STEPS} steps")
        prof = dict(profile_one_run.last)
    per_step = {k: (prof[k] - pre[k]) / SPARK_PROFILE_STEPS
                for k in ("launches", "device_ms", "wall_ms")}
    per_step["idle_share"] = 1 - per_step["device_ms"] / per_step["wall_ms"]
    audio_s = want_samples / 16000
    steps = SPARK_GLOBALS + SPARK_TOKENS + 1
    log(f"[spark] control route (greedy, {len(ids)}-token prompt, {steps} tokens: the planted "
        f"globals, semantics and eos), {audio_s:.2f} s of audio: wall {wall:.4f} s, RTF "
        f"{wall / audio_s:.4f}, {steps / wall:.1f} tokens/s; a decode step: "
        f"{per_step['launches']:.0f} launches, {per_step['device_ms']:.3f} ms of device time in "
        f"{per_step['wall_ms']:.3f} ms of wall (idle {100 * per_step['idle_share']:.1f}%); the "
        f"port's kernels launched {launches} ({smi})")
    rec["control"] = {"wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
                      "prompt_tokens": len(ids), "tokens": steps, "launches": launches,
                      "step": per_step}

    # the clone route from a 6 s reference, through XLSR-53 and the speaker encoder
    ref = csm_reference(SPARK_REF_S, 25, sr=16000)
    with torch.inference_mode():
        sem_r, glob_r = spark._reference_tokens(rt, bc, ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat = fe(ref.reshape(1, -1))
        torch.cuda.synchronize()
        xlsr_ms = (time.perf_counter() - t0) * 1e3
        clip = bc.get_ref_clip(ref.reshape(1, -1))[None]
        tok_ms = time_ms(lambda: bc.tokenize(feat, clip), iters=5)
        det_ms = time_ms(lambda: bc.detokenize(np.asarray([sem[:SPARK_TOKENS]]),
                                               glob_r.cpu().numpy()), iters=5)
        t0 = time.perf_counter()
        clone = list(spark.generate(SPARK_TEXT, ref_audio=ref, temperature=0.0))
        torch.cuda.synchronize()
        clone_s = time.perf_counter() - t0
    ratio = int(np.prod(BICODEC_CFG["encoder"].get("sample_ratios", [1])))
    if glob_r.shape != (1, SPARK_GLOBALS, 1) or feat.shape[1] != int(SPARK_REF_S * 50) - 1 \
            or sem_r.shape[1] != feat.shape[1] // ratio \
            or clone[0].token_count != SPARK_TOKENS or not np.isfinite(clone[0].audio).all():
        raise SystemExit(f"chip_smoke: Spark's clone route: global tokens {tuple(glob_r.shape)}, "
                         f"reference semantic tokens {tuple(sem_r.shape)}, "
                         f"{clone[0].token_count} tokens generated")
    log(f"[spark] clone route from {SPARK_REF_S:g} s: XLSR-53 features {tuple(feat.shape)} in "
        f"{xlsr_ms:.1f} ms, BiCodec tokenize {tok_ms:.2f} ms ({sem_r.shape[1]} semantic, "
        f"{SPARK_GLOBALS} global tokens), detokenize of {SPARK_TOKENS} tokens {det_ms:.2f} ms; "
        f"generate end to end {clone_s:.4f} s, {SPARK_TOKENS} semantic tokens ({smi})")
    rec["clone"] = {"wall_s": clone_s, "xlsr_ms": xlsr_ms, "tokenize_ms": tok_ms,
                    "detokenize_ms": det_ms, "reference_semantic": int(sem_r.shape[1])}

    # LMContinuousBatcher: four prompts, each equal to its sequential tokens
    prompts = [tok.encode(spark.process_prompt_control(t, "male", "high", "low"))
               for t in SPARK_TEXTS]
    t0 = time.perf_counter()
    n_b = SPARK_BATCH_TOKENS
    with torch.inference_mode():
        seq = [generate_tokens(spark.llm, p, max_tokens=n_b, **gen)[0][0].tolist()
               for p in prompts]
    seq_s = time.perf_counter() - t0
    b = spark.make_batcher(slots=4, max_len=512, tick_tokens=16)
    try:
        b.warmup()
        t0 = time.perf_counter()
        futs = [b.submit(p, max_tokens=n_b, eos_ids=eos, repetition_penalty=1.3,
                         repetition_context_size=20) for p in prompts]
        got = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        batch_s = time.perf_counter() - t0
    finally:
        b.close()
    if got != seq or any(g != want[:n_b] for g in got):
        raise SystemExit(f"chip_smoke: LMContinuousBatcher's Spark tokens part from sequential "
                         f"({[len(g) for g in got]} against {[len(s) for s in seq]})")
    log(f"[spark] LMContinuousBatcher, 4 prompts x {n_b} tokens: {batch_s:.3f} s batched, "
        f"{seq_s:.3f} s one after another ({seq_s / batch_s:.2f}x), each equal to its sequential "
        f"tokens")
    rec["batched"] = {"wall_s": batch_s, "sequential_s": seq_s, "speedup": seq_s / batch_s}

    # Wav2Vec2 on 30 s: XLSR-53's forward, then the base CTC model
    w30 = noise(W2V_S, 26)
    with torch.inference_mode():
        fe(w30.reshape(1, -1))
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        h = fe(w30.reshape(1, -1))
        torch.cuda.synchronize()
        xlsr_s = time.perf_counter() - t0
    xlsr_flash = flash_attention.launches
    w2v = W2V(W2V_BASE_CFG, device="cuda", seed=27)
    w2v.generate(w30)
    walls = []
    for _ in range(3):
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = w2v.generate(w30)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    base_flash = flash_attention.launches
    wall = statistics.median(walls)
    frames = h.shape[1]
    log(f"[wav2vec2] XLSR-53 (24 x 1024, 16 heads, f32) on {W2V_S:g} s: {frames} frames in "
        f"{xlsr_s:.4f} s, flash_fwd_f32 launches {xlsr_flash} (one a layer: 24); base CTC "
        f"(12 x 768, 12 heads, f32) generate median {wall:.4f} s of {[round(w, 4) for w in walls]}"
        f" ({W2V_S / wall:.1f}x real time, {out.generation_tokens} CTC tokens), flash launches "
        f"{base_flash} (12) ({smi})")
    if xlsr_flash != 24 or base_flash != 12 or frames != 1499 or not torch.isfinite(h).all():
        raise SystemExit(f"chip_smoke: Wav2Vec2 at 30 s launched flash {xlsr_flash} (XLSR-53) "
                         f"and {base_flash} (base) times, {frames} frames")
    rec["wav2vec2"] = {"xlsr_s": xlsr_s, "xlsr_flash_launches": xlsr_flash, "base_wall_s": wall,
                       "base_xrt": W2V_S / wall, "base_flash_launches": base_flash,
                       "frames": frames}
    del w2v, h
    rec["served"] = served_speech(spark, path, SPARK_TEXT, 16000, "spark",
                                  want_samples=want_samples)
    del spark, rt, bc, fe
    gc.collect()
    torch.cuda.empty_cache()

    # int4 by convert: the quantized launches held to the code's count
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        q = convert.convert(str(path), str(tmp / "Spark-TTS-0.5B-4bit"), quantize=True)
    convert_s = time.perf_counter() - t0
    q4, q_load_s = timed_load(str(q))
    head = type(q4.llm.model.embed_tokens).__name__
    rows = []

    def counted(m, x, caches):  # the calls' row counts, for the code's count
        rows.append(x.shape[1])
        return m(x, caches)

    with torch.inference_mode():
        generate_tokens(q4.llm, ids, max_tokens=SPARK_INT4_TOKENS, **gen)  # warm-up
        torch.cuda.synchronize()
        qk.reset_launches()
        t0 = time.perf_counter()
        toks4, n4 = generate_tokens(q4.llm, ids, max_tokens=SPARK_INT4_TOKENS,
                                    model_call=counted, **gen)
        torch.cuda.synchronize()
        wall4 = time.perf_counter() - t0
        got = quant_counts(4)
        hrow = torch.randn(1, 1, SPARK_LLM["hidden_size"], device="cuda")
        head_ms, _ = device_ms([lambda: q4.llm.logits(hrow)], 20)
    predicted = spark_launches(SPARK_LLM, [(M, 1) for M in rows])
    on_path = toks4[0].tolist() == want[:n4]
    # the same calls' logits against the float32 model on the dequantized
    # weights (every GEMM of the prompt and the steps held to it)
    deq = Model({"llm": SPARK_LLM}, device="cuda")
    load_weights(deq, deq.sanitize(convert.dequantize_weights(load_weight_files(q), 4, GROUP)))
    got_rows, want_rows = [], []
    with torch.inference_mode():
        deq_toks = generate_tokens(deq.llm, ids, max_tokens=SPARK_INT4_TOKENS,
                                   model_call=logit_rows(want_rows), **gen)[0][0].tolist()
        generate_tokens(q4.llm, ids, max_tokens=SPARK_INT4_TOKENS,
                        model_call=logit_rows(got_rows), **gen)
    del deq
    gaps = csm_gaps([(g, g) for g in got_rows], [(w, w) for w in want_rows])
    worst = max(d / peak for d, peak, _ in gaps)
    log(f"[spark] int4 g64 by convert(quantize=True) in {convert_s:.1f} s, loaded in "
        f"{q_load_s:.1f} s (tied head: {head}); {n4} greedy tokens in {wall4:.4f} s: launches "
        f"{got}, from the code {predicted}; {len(gaps)} calls' logits (the prompt's and "
        f"{len(gaps) - 1} steps') against the float32 model on the dequantized weights: max|d| "
        f"{max(g[0] for g in gaps):.3e}, worst share of the peak {worst:.2e} (bar "
        f"{BARK_INT4_BAR:g}); tokens on the bf16 path: {on_path}, the dequantized model's: "
        f"{deq_toks == want[:n4]}; the tied head's as_linear (dequantize the 166,000 x 896 "
        f"table, F.linear) {head_ms:.4f} ms of device time a step ({smi})")
    if got != predicted:
        raise SystemExit(f"chip_smoke: the int4 Spark launched {got}, the code says {predicted}")
    if not len(got_rows) == len(want_rows) == len(rows) or worst > BARK_INT4_BAR or not on_path or deq_toks != want[:n4]:
        raise SystemExit("chip_smoke: the int4 Spark's logits part from the dequantized "
                         "model's, or its greedy tokens leave the planted path")
    rec["int4"] = {"convert_s": convert_s, "load_s": q_load_s, "wall_s": wall4, "launches": got,
                   "head": head, "head_ms": head_ms, "tokens_on_path": on_path,
                   "logits_max_abs_err": max(g[0] for g in gaps), "worst_share_of_peak": worst}
    del q4
    shutil.rmtree(q, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the two-layer copy in float32, card against CPU
    t0 = time.perf_counter()
    cpu, _ = timed_load(str(reduced), device="cpu", dtype=torch.float32)
    want_toks, want_rows = outetts_logit_rows(cpu.llm, ids, SPARK_CPU_TOKENS)
    del cpu
    card, _ = timed_load(str(reduced), device="cuda", dtype=torch.float32)
    got_toks, got_rows = outetts_logit_rows(card.llm, ids, SPARK_CPU_TOKENS)
    del card
    gaps = csm_gaps(got_rows, want_rows)
    ok = all(d <= CARD_VS_CPU_ATOL * peak and d <= OUTETTS_LAYER_BAR * add for d, peak, add in gaps)
    log(f"[spark] two-layer copy, float32, card against CPU: {len(gaps)} calls' logits (the "
        f"prompt's and {SPARK_CPU_TOKENS} steps'), max|d| {max(g[0] for g in gaps):.3e}, peaks "
        f">= {min(g[1] for g in gaps):.1f} (bar {CARD_VS_CPU_ATOL:g} of each), what the layers "
        f"add >= {min(g[2] for g in gaps):.1f} (bar {OUTETTS_LAYER_BAR:g} of each); greedy "
        f"tokens identical: {got_toks == want_toks}, on the path: "
        f"{got_toks == want[:SPARK_CPU_TOKENS]} ({time.perf_counter() - t0:.1f} s)")
    if not ok or got_toks != want_toks or got_toks != want[:SPARK_CPU_TOKENS]:
        raise SystemExit("chip_smoke: the Spark two-layer copy parts card from CPU")
    rec["card_vs_cpu"] = {"logits_max_abs_err": max(g[0] for g in gaps),
                          "layers_add": min(g[2] for g in gaps),
                          "wall_s": time.perf_counter() - t0}
    rec.update(write_s=write_s, checkpoint_bytes=nbytes, load_s=load_s)
    return rec


def phase_spark_soprano(smi: str) -> dict:
    """Phase 17 (see the module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[slice17] {time.perf_counter() - t_phase:.1f} s into phase 17 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="slice17-"))
    try:
        enc = encodec_seeded()
        vocos = vocos_checks(enc, smi)
        del enc
        mark("Vocos")
        soprano = soprano_checks(tmp, smi)
        mark("Soprano")
        spark = spark_checks(tmp, smi)
        mark("Spark-TTS and Wav2Vec2")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"vocos": vocos, "soprano": soprano, "spark": spark,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[slice17] phase 17 wall {rec['phase_s']:.1f} s")
    return rec


INDEXTTS_PLANT_SCALE = 1e4
# IndexTTS-1.5's vocoder as this repository's code reads its config.yaml
# (not in the repository, so unchecked): 100 mels (the conformer's input
# too), rates whose product is the GPT's mel_length_compression (1024), the
# conditioning widths
INDEXTTS_BIGVGAN = {"num_mels": 100, "upsample_rates": [4, 4, 4, 4, 2, 2],
                    "upsample_kernel_sizes": [8, 8, 4, 4, 4, 4],
                    "upsample_initial_channel": 1536, "resblock": "1",
                    "resblock_kernel_sizes": [3, 7, 11],
                    "resblock_dilation_sizes": [[1, 3, 5]] * 3, "activation": "snakebeta",
                    "snake_logscale": True, "gpt_dim": 1024, "speaker_embedding_dim": 512,
                    "sampling_rate": 24000}
INDEXTTS_STOP = 70  # the planted stop's step: 71 latents, 72,704 samples, 3.03 s
INDEXTTS_TEXT = HTTP_TEXT
INDEXTTS_TEXTS = (INDEXTTS_TEXT, "Hello world.", "The model turns text into speech.",
                  "A seeded reference line that the model never heard.")
INDEXTTS_REF_S = 6.0
INDEXTTS_PROFILE_STEPS = 32
INDEXTTS_INT4_STEPS = 16
INDEXTTS_BATCH_TOKENS = 48  # each batched request's cap, before the planted stop
INDEXTTS_CPU_STEPS = 24  # the two-layer copy: 24 latents, 1.02 s of audio
INDEXTTS_LATENTS_SEED = 27


class IndexTok:
    """A seeded stand-in for IndexTTS's SentencePiece tokenizer (the
    published tokenizer.model is not in the repository, and the card's
    machine has no `sentencepiece`): each space-separated piece of the
    normalized text maps to an id in 2..11999."""

    def encode(self, text):
        import zlib

        return [zlib.crc32(w.encode()) % 11998 + 2 for w in text.split()]


def plant_indextts_stop(model, step: int, gain: float = 0.5, seed: int = 0):
    """Plant IndexTTS's stop code at decode step `step` (>= 1), whatever the
    prompt: the mel position row fed at step - 1 carries
    INDEXTTS_PLANT_SCALE times a zero-mean unit direction v, which then rules
    the final norm's output at step `step`, and the stop code's head row is
    gain·v (its bias 0). → the planted row's added vector."""
    stop = model.args.gpt.stop_mel_token
    w = model.mel_pos_embedding.weight
    g = torch.Generator(device=w.device).manual_seed(seed)
    v = torch.randn(w.shape[1], generator=g, device=w.device)
    v = v - v.mean()
    v = v / v.norm()
    with torch.no_grad():
        w[step - 1] += INDEXTTS_PLANT_SCALE * v
        model.mel_head.weight[stop] = gain * v
        model.mel_head.bias[stop] = 0.0
    return INDEXTTS_PLANT_SCALE * v


def indextts_config(layers=None) -> dict:
    """config.json of the slice's IndexTTS: `GPTConfig()` (IndexTTS-1.5's
    1024 x 20, 16 heads, 8,194 mel codes, 12,000 text tokens; the conformer
    at `ConformerArgs()`) and INDEXTTS_BIGVGAN."""
    import dataclasses

    from mlx_audio_tpu_torch.tts.models.indextts import GPTConfig

    gpt = dataclasses.asdict(GPTConfig())
    if layers is not None:
        gpt["layers"] = layers
    return {"model_type": "indextts", "gpt": gpt, "bigvgan": dict(INDEXTTS_BIGVGAN),
            "sample_rate": 24000}


def indextts_seeded(config, device="cuda", seed: int = 25):
    """IndexTTS from `seed`, its perceiver's latents drawn (the JAX
    initialiser's zeros make all 32 alike), the stop planted."""
    from mlx_audio_tpu_torch.tts.models.indextts import Model

    model = Model(config, device=device, seed=seed)
    g = torch.Generator(device=device).manual_seed(INDEXTTS_LATENTS_SEED)
    with torch.no_grad():
        model.perceiver_encoder.latents.normal_(0.0, 0.02, generator=g)
    plant_indextts_stop(model, INDEXTTS_STOP, seed=seed)
    return model


def indextts_prompt(model, text, mel):
    from mlx_audio_tpu_torch.tts.models.indextts import normalize

    ids = IndexTok().encode(normalize.tokenize_by_CJK_char(normalize.normalize(text)))
    return model.prepare_input_embedding(ids, mel)


def indextts_replay(model, emb, steps: int, codes=None) -> tuple:
    """`steps` decode steps of `_indextts_decode` whose draw is the argmax
    (top-k 1) or, given `codes`, replays them → (latents (steps, D), every
    step's float32 logits rows on the host, the codes taken)."""
    from mlx_audio_tpu_torch.tts.models.indextts.indextts import _indextts_decode

    rows, taken = [], []
    it = iter(codes) if codes is not None else None

    def sampler(logits, gen):
        rows.append(logits[0].float().cpu())
        tok = int(logits[0].argmax()) if it is None else next(it)
        taken.append(tok)
        return torch.tensor([tok], device=logits.device)

    lat, n = _indextts_decode(model, emb, steps, 1.0, 1, 0, sampler)
    return lat[:min(n, steps)], rows, taken


def conformer_rows(args, mel_frames: int) -> int:
    """The conditioning encoder's rows after its conv2d front."""
    from mlx_audio_tpu_torch.tts.models.indextts.indextts import Conv2dSubsampling

    t = mel_frames
    for ks, stride in Conv2dSubsampling._LAYERS[args.input_layer]:
        t = (t - ks) // stride + 1
    return t


def indextts_launches(config: dict, mel_frames: int, prompt: int, steps: int) -> dict:
    """The quantized launches of one int4 `generate` from the code: the
    conformer's projections at its T_c rows (the conv2d front's output,
    q/k/v/out and the position projection, the feed-forward pair), the
    perceiver's (the context projection at T_c, queries, output and the
    gated feed-forward's w_1 at its 32 latents, keys and values at T_c +
    32; w_2's K = 1365 is not a multiple of 64, so it stays float32), the
    GPT's four at the prompt's rows, then each decode step's mel head and
    the GPT's four at one row, through qmm where `qmm_routable` takes the
    shape (the GEMV at M <= 4, the tensor-core GEMM above). Tables and
    convolutions take no kernel."""
    from mlx_audio_tpu_torch.nn.quantized import qmm_routable
    from mlx_audio_tpu_torch.tts.models.indextts import ModelArgs
    from mlx_audio_tpu_torch.tts.models.indextts.indextts import Conv2dSubsampling

    args = ModelArgs(**{k: v for k, v in config.items() if k in ("gpt", "bigvgan")})
    g, cm = args.gpt, args.gpt.condition_module
    tc, d, D, L = conformer_rows(cm, mel_frames), cm.output_size, g.model_dim, 32
    f_out = cm.input_size
    for ks, stride in Conv2dSubsampling._LAYERS[cm.input_layer]:
        f_out = (f_out - ks + stride) // stride
    inner = cm.attention_heads * 64
    d_ff = (D * cm.perceiver_mult * 2) // 3
    calls = [(d, d * f_out, tc, 1)]  # N, K, M, calls
    calls += [(d, d, tc, 5 * cm.num_blocks), (cm.linear_units, d, tc, cm.num_blocks),
              (d, cm.linear_units, tc, cm.num_blocks)]
    if d != D:
        calls.append((D, d, tc, 1))
    calls += [(inner, D, L, 2), (inner, D, tc + L, 4), (D, inner, L, 2),
              (2 * d_ff, D, L, 2), (D, d_ff, L, 2)]
    gpt = [(3 * D, D), (D, D), (4 * D, D), (D, 4 * D)]
    calls += [(N, K, prompt, g.layers) for N, K in gpt]
    calls += [(N, K, 1, g.layers * steps) for N, K in gpt]
    calls.append((g.number_mel_codes, D, 1, steps))
    got = {"qmm": 0, "qmlp": 0, "qmm_kernel": 0, "qmm_gemv": 0, "qmm_mma": 0}
    for N, K, M, n in calls:
        if K % GROUP == 0 and qmm_routable(4, GROUP, N, K, M):
            got["qmm"] += n
            got["qmm_gemv" if M <= 4 else "qmm_mma"] += n
    return got


def indextts_generate(model, ref, smi) -> dict:
    """The float32 run: a warm-up, then `generate` (default sampling, the
    planted stop) timed; the conditioning, decode and BigVGAN split; a
    profiled prefill and INDEXTTS_PROFILE_STEPS steps; the vocoder's
    device time."""
    from mlx_audio_tpu_torch.tts.models.indextts import log_mel_spectrogram
    from mlx_audio_tpu_torch.tts.models.indextts.indextts import _indextts_decode

    model.set_runtime(tokenizer=IndexTok())
    with torch.inference_mode():
        list(model.generate(INDEXTTS_TEXT, ref_audio=ref, max_tokens=8, seed=0))  # warm-up
        torch.cuda.synchronize()
        zero_port_launches()
        t0 = time.perf_counter()
        res = list(model.generate(INDEXTTS_TEXT, ref_audio=ref, seed=1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = no_port_launches("IndexTTS's float32 generate")
    n = INDEXTTS_STOP + 1
    want = n * model.args.gpt.mel_length_compression
    if len(res) != 1 or res[0].token_count != n or res[0].samples != want:
        raise SystemExit(f"chip_smoke: IndexTTS generated {[r.token_count for r in res]} "
                         f"latents, {[r.samples for r in res]} samples; the planted stop gives "
                         f"{n}, {want}")
    if not np.isfinite(res[0].audio).all() or not np.abs(res[0].audio).max() > 0:
        raise SystemExit("chip_smoke: IndexTTS's waveform is not finite, or silent")
    audio_s = res[0].samples / model.sample_rate

    # the same request in its three parts, timed apart
    with torch.inference_mode():
        split = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = log_mel_spectrogram(ref, n_mels=100, device="cuda")
        emb = indextts_prompt(model, INDEXTTS_TEXT, mel)
        torch.cuda.synchronize()
        split["conditioning_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lat, n_split = _indextts_decode(model, emb, 800, 0.8, 30, 1)
        torch.cuda.synchronize()
        split["decode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        audio = model.bigvgan(lat[None, :n_split], mel)
        torch.cuda.synchronize()
        split["bigvgan_s"] = time.perf_counter() - t0
        rel = held_close("IndexTTS's split run against generate's waveform",
                         audio[0, :, 0], res[0].audio, bar=CARD_VS_CPU_ATOL)
        profile_one_run(lambda: _indextts_decode(model, emb, 0, 0.8, 30, 1),
                        "IndexTTS's GPT prefill")
        pre = dict(profile_one_run.last)
        steps = INDEXTTS_PROFILE_STEPS
        profile_one_run(lambda: _indextts_decode(model, emb, steps, 0.8, 30, 1),
                        f"IndexTTS's GPT prefill and {steps} steps")
        prof = dict(profile_one_run.last)
        profile_one_run(lambda: model.bigvgan(lat[None, :n_split], mel),
                        f"IndexTTS's BigVGAN on {n_split} latents")
        voc = dict(profile_one_run.last)
    per_step = {k: (prof[k] - pre[k]) / steps for k in ("launches", "device_ms", "wall_ms")}
    per_step["idle_share"] = 1 - per_step["device_ms"] / per_step["wall_ms"]
    log(f"[indextts] generate (temperature 0.8, top-k 30, {n} latents, {audio_s:.3f} s of "
        f"audio): wall {wall:.4f} s, RTF {wall / audio_s:.4f}; apart: conditioning "
        f"{split['conditioning_s']:.4f} s, decode {split['decode_s']:.4f} s "
        f"({n_split} latents), BigVGAN {split['bigvgan_s']:.4f} s ({voc['device_ms']:.2f} ms of "
        f"device time, {voc['launches']} launches); a decode step: "
        f"{per_step['launches']:.0f} launches, {per_step['device_ms']:.3f} ms of device time in "
        f"{per_step['wall_ms']:.3f} ms of wall (idle {100 * per_step['idle_share']:.1f}%); the "
        f"port's kernels launched {launches} ({smi})")
    if n_split != n:
        raise SystemExit(f"chip_smoke: IndexTTS's split decode took {n_split} latents, not {n}")
    return {"wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s, "latents": n,
            "samples": res[0].samples, "launches": launches, "split": split,
            "split_audio_rel": rel, "step": per_step,
            "bigvgan": {"device_ms": voc["device_ms"], "launches": voc["launches"],
                        "wall_ms": voc["wall_ms"]}}


def indextts_two_layer(flat: dict, ref) -> dict:
    """A two-layer float32 copy at full width (the GPT's first two layers;
    the conformer, the perceiver and the conditioned BigVGAN whole), card
    against CPU: the prompt embedding, INDEXTTS_CPU_STEPS decode steps'
    logits (the card replays the CPU's argmax codes, and takes the same
    argmax wherever the CPU's top two are apart by more than the gap), the
    latents, and BigVGAN over them (1.02 s of audio)."""
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.tts.models.indextts import Model, log_mel_spectrogram

    t0 = time.perf_counter()
    cfg = indextts_config(layers=2)
    two = {k: v for k, v in flat.items()
           if not k.startswith("gpt.h.") or int(k.split(".")[2]) < 2}

    def run(dev, codes=None):
        m = Model(cfg, device=dev)
        load_weights(m, two)
        with torch.inference_mode():
            mel = log_mel_spectrogram(ref, n_mels=100, device=dev)
            emb = indextts_prompt(m, INDEXTTS_TEXT, mel)
            lat, rows, codes = indextts_replay(m, emb, INDEXTTS_CPU_STEPS, codes)
            audio = m.bigvgan(lat[None], mel)[0, :, 0]
        return emb.cpu(), lat.cpu(), rows, codes, audio.cpu()

    e_cpu, l_cpu, r_cpu, c_cpu, a_cpu = run("cpu")
    e_card, l_card, r_card, _, a_card = run("cuda", c_cpu)
    rec = {"embedding_rel": held_close("IndexTTS two-layer copy, the prompt embedding (the "
                                       "conformer and perceiver), card against CPU",
                                       e_card, e_cpu),
           "latents_rel": held_close(f"IndexTTS two-layer copy, {INDEXTTS_CPU_STEPS} latents, "
                                     "card against CPU", l_card, l_cpu),
           "audio_rel": held_close("IndexTTS two-layer copy, the conditioned BigVGAN's "
                                   f"{a_cpu.numel()} samples, card against CPU", a_card, a_cpu)}
    worst, parted = 0.0, 0
    for rc, rg in zip(r_cpu, r_card):
        err, peak = close_to(rg, rc)
        worst = max(worst, err / peak)
        top2 = torch.topk(rc, 2).values
        if int(rg.argmax()) != int(rc.argmax()):
            parted += 1
            if float(top2[0] - top2[1]) > 2 * err:
                raise SystemExit("chip_smoke: the IndexTTS two-layer copy's card and CPU take "
                                 "different codes away from a near-tie")
    log(f"[indextts] two-layer copy, {len(r_cpu)} steps' logits: worst {worst:.2e} of the peak "
        f"(bar {CARD_VS_CPU_ATOL:g}), argmax parted at {parted} near-tie(s); codes "
        f"{c_cpu[:8]}... ({time.perf_counter() - t0:.1f} s)")
    if worst > CARD_VS_CPU_ATOL or len(r_cpu) != INDEXTTS_CPU_STEPS:
        raise SystemExit("chip_smoke: the IndexTTS two-layer copy's logits part card from CPU")
    rec.update(logits_worst_rel=worst, argmax_parted=parted,
               wall_s=time.perf_counter() - t0)
    return rec


def indextts_int4(path: Path, tmp: Path, ref, smi) -> dict:
    """int4 by the port's `convert`, loaded by `utils.load_model`: a
    generate of INDEXTTS_INT4_STEPS steps at top-k 1 with its quantized
    launches held to the code's count; then its prompt embedding, latents
    and logits held to the float32 port on the dequantized weights (which
    replays its codes)."""
    from mlx_audio_tpu_torch import convert
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.tts.models.indextts import Model, log_mel_spectrogram
    from mlx_audio_tpu_torch.utils import load_weight_files

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        q = convert.convert(str(path), str(tmp / "IndexTTS-int4"), quantize=True)
    convert_s = time.perf_counter() - t0
    q4, load_s = timed_load(str(q))
    q4.set_runtime(tokenizer=IndexTok())
    steps = INDEXTTS_INT4_STEPS
    with torch.inference_mode():
        list(q4.generate(INDEXTTS_TEXT, ref_audio=ref, max_tokens=4, top_k=1, seed=0))
        torch.cuda.synchronize()
        qk.reset_launches()
        t0 = time.perf_counter()
        res = list(q4.generate(INDEXTTS_TEXT, ref_audio=ref, max_tokens=steps, top_k=1, seed=0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = quant_counts(4)
        mel = log_mel_spectrogram(ref, n_mels=100, device="cuda")
        emb4 = indextts_prompt(q4, INDEXTTS_TEXT, mel)
        lat4, rows4, codes = indextts_replay(q4, emb4, steps)
    predicted = indextts_launches(indextts_config(), mel.shape[1], emb4.shape[1], steps)
    deq = Model(indextts_config(), device="cuda")
    load_weights(deq, deq.sanitize(convert.dequantize_weights(load_weight_files(q), 4, GROUP)),
                 strict=False)
    with torch.inference_mode():
        embd = indextts_prompt(deq, INDEXTTS_TEXT, mel)
        latd, rowsd, _ = indextts_replay(deq, embd, steps, codes)
    del deq
    worst = max(close_to(a, b)[0] / close_to(a, b)[1] for a, b in zip(rows4, rowsd))
    rel_e = held_close("int4 IndexTTS's prompt embedding against the float32 port on the "
                       "dequantized weights", emb4, embd, bar=BARK_INT4_BAR)
    rel_l = held_close(f"int4 IndexTTS's {steps} latents against the float32 port on the "
                       "dequantized weights", lat4, latd, bar=BARK_INT4_BAR)
    argmax_same = [int(a.argmax()) for a in rowsd] == codes
    log(f"[indextts] int4 g64 by convert(quantize=True) in {convert_s:.1f} s, loaded in "
        f"{load_s:.1f} s; generate of {steps} steps at top-k 1 in {wall:.4f} s "
        f"({res[0].token_count} latents): launches {got}, from the code {predicted}; {steps} "
        f"steps' logits against the float32 port on the dequantized weights: worst {worst:.2e} "
        f"of the peak (bar {BARK_INT4_BAR:g}), its argmax the int4 codes: {argmax_same} ({smi})")
    if got != predicted:
        raise SystemExit(f"chip_smoke: the int4 IndexTTS launched {got}, the code says "
                         f"{predicted}")
    if worst > BARK_INT4_BAR or not argmax_same or res[0].token_count != steps + 1:
        raise SystemExit("chip_smoke: the int4 IndexTTS parts from the dequantized model")
    rec = {"convert_s": convert_s, "load_s": load_s, "wall_s": wall, "launches": got,
           "embedding_rel": rel_e, "latents_rel": rel_l, "logits_worst_rel": worst,
           "prompt_rows": emb4.shape[1], "conformer_rows": conformer_rows(
               q4.args.gpt.condition_module, mel.shape[1])}
    del q4
    shutil.rmtree(q, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def indextts_batched(model, ref) -> dict:
    """IndexTTSBatcher with four requests at top-k 1, each capped at
    INDEXTTS_BATCH_TOKENS, each equal to `_indextts_decode` of the same
    request alone (latents, and their codes); the speedup over the four
    alone one after another."""
    from mlx_audio_tpu_torch.tts.models.indextts import log_mel_spectrogram
    from mlx_audio_tpu_torch.tts.models.indextts.indextts import _indextts_decode

    n_b = INDEXTTS_BATCH_TOKENS
    with torch.inference_mode():
        mel = log_mel_spectrogram(ref, n_mels=100, device="cuda")
        embs = [indextts_prompt(model, t, mel) for t in INDEXTTS_TEXTS]
        _indextts_decode(model, embs[0], 4, 0.8, 1, 0)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = [_indextts_decode(model, e, n_b, 0.8, 1, 0) for e in embs]
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    b = model.make_batcher(slots=4, max_len=1024, tick_frames=16)
    try:
        b.warmup()
        t0 = time.perf_counter()
        futs = [b.submit(e.cpu().numpy(), max_tokens=n_b, temperature=0.8, top_k=1, seed=i)
                for i, e in enumerate(embs)]
        got = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        batch_s = time.perf_counter() - t0
        ticks = b.dispatch_count
    finally:
        b.close()
    rels = []
    with torch.inference_mode():
        for (lat, n), g in zip(alone, got):
            if n != n_b + 1 or g.shape[0] != n_b:
                raise SystemExit(f"chip_smoke: a batched IndexTTS request kept {g.shape[0]} "
                                 f"latents, alone {min(n, n_b)}")
            rels.append(held_close("IndexTTSBatcher request against its run alone", g,
                                   lat[:n_b]))
            gc_ = model.mel_head(torch.as_tensor(g, device="cuda")).argmax(-1)
            if not torch.equal(gc_, model.mel_head(lat[:n_b]).argmax(-1)):
                raise SystemExit("chip_smoke: a batched IndexTTS request's codes part from "
                                 "its run alone")
    log(f"[indextts] IndexTTSBatcher, 4 requests x {n_b} latents at top-k 1: {batch_s:.3f} s "
        f"batched ({ticks} ticks), {seq_s:.3f} s alone one after another: "
        f"{seq_s / batch_s:.2f}x; codes identical")
    return {"wall_s": batch_s, "sequential_s": seq_s, "speedup": seq_s / batch_s,
            "ticks": ticks, "worst_rel": max(rels)}


def phase_indextts(smi: str) -> dict:
    """Phase 18 (see the module docstring)."""
    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import flatten_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[slice18] {time.perf_counter() - t_phase:.1f} s into phase 18 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="slice18-"))
    rec = {}
    try:
        t0 = time.perf_counter()
        model = indextts_seeded(indextts_config())
        n_par = {k: sum(p.numel() for n, p in model.named_parameters() if n.startswith(k))
                 for k in ("gpt.", "conditioning_encoder.", "perceiver_encoder.", "bigvgan.")}
        n_all = sum(p.numel() for p in model.parameters())
        flat = flatten_params(model)
        path = tmp / "IndexTTS-1.5"
        save_model(path, flat, indextts_config())
        write_s = time.perf_counter() - t0
        log(f"[indextts] IndexTTS (GPTConfig(): 1024 x 20, 16 heads, 8,194 mel codes, 12,000 "
            f"text tokens; ConformerArgs(): 256 x 6; BigVGAN 1536 / [4, 4, 4, 4, 2, 2] with "
            f"ECAPA-TDNN 512), float32, seeded, the stop planted at step {INDEXTTS_STOP}: "
            f"{n_all / 1e6:.1f} M parameters (GPT {n_par['gpt.'] / 1e6:.1f}, conformer "
            f"{n_par['conditioning_encoder.'] / 1e6:.1f}, perceiver "
            f"{n_par['perceiver_encoder.'] / 1e6:.1f}, BigVGAN {n_par['bigvgan.'] / 1e6:.1f}); "
            f"{checkpoint_bytes(path) / 1e9:.3f} GB written in {write_s:.1f} s")
        rec.update(parameters=n_all, parameters_by_part=n_par, write_s=write_s,
                   checkpoint_bytes=checkpoint_bytes(path))
        ref = csm_reference(INDEXTTS_REF_S, seed=26)
        rec["generate"] = indextts_generate(model, ref, smi)
        mark("the float32 generate")
        rec["batched"] = indextts_batched(model, ref)
        mark("IndexTTSBatcher")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        rec["card_vs_cpu"] = indextts_two_layer(flat, ref)
        del flat
        mark("the two-layer copy")
        rec["int4"] = indextts_int4(path, tmp, ref, smi)
        mark("int4")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice18] phase 18 wall {rec['phase_s']:.1f} s")
    return rec


CHATTERBOX_SPECIALS = ("[STOP]", "[UNK]", "[SPACE]", "[PAD]", "[SEP]", "[CLS]", "[MASK]")
CHATTERBOX_VOCAB = 704  # T3Config.english_only()'s text table
CHATTERBOX_START = 255  # T3Config's start_text_token; [STOP] is 0


def write_chatterbox_tokenizer(path, seed: int = 0, n_merges: int = 300) -> Path:
    """A stand-in for Chatterbox's English tokenizer.json (the published file
    is not in the repository) in the components this repository's reader
    assumes it has: a character-level BPE with [UNK], the `Whitespace`
    pre-tokenizer, no normalizer, decoder or post-processor, and the
    special tokens as added tokens at their vocabulary ids ([STOP] 0,
    [START] 255), 704 entries in all. Merges are learned from seeded words
    as `train_merges` learns them."""
    from collections import Counter

    rng = np.random.default_rng(seed)
    vocab = {t: i for i, t in enumerate(CHATTERBOX_SPECIALS)}
    for c in (chr(i) for i in range(33, 127)):
        vocab[c] = len(vocab)
    syll = ["ka", "to", "ri", "en", "st", "an", "qu", "er", "ing", "th", "ou", "ch"]
    words = [w for w in TOKENIZER_WORDS for _ in range(8)]
    words += ["".join(rng.choice(syll, rng.integers(1, 4))) for _ in range(400)]
    counts = Counter(tuple(w) for w in words)
    merges = []
    while len(merges) < n_merges:
        pairs = Counter()
        for w, c in counts.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        if len(vocab) == CHATTERBOX_START:
            vocab["[START]"] = CHATTERBOX_START
        vocab.setdefault(best[0] + best[1], len(vocab))
        merged = Counter()
        for w, c in counts.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        counts = merged
    if "[START]" not in vocab:
        while len(vocab) < CHATTERBOX_START:
            vocab[f"<fill{len(vocab)}>"] = len(vocab)
        vocab["[START]"] = CHATTERBOX_START
    while len(vocab) < CHATTERBOX_VOCAB:
        vocab[f"<fill{len(vocab)}>"] = len(vocab)
    specials = CHATTERBOX_SPECIALS + ("[START]",)
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False, "normalized": False,
                              "special": True} for t in specials],
            "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None, "decoder": None,
            "model": {"type": "BPE", "dropout": None, "unk_token": "[UNK]",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}}
    path = Path(path)
    if path.suffix != ".json":
        path = path / "tokenizer.json"
    path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    return path


def write_chatterbox_upstream(path: Path, model, s3tok) -> Path:
    """`model` (the port's Chatterbox) in the release's layout: ve.safetensors
    with torch's LSTM names, t3_cfg.safetensors with the Llama model's
    (`tfmr.layers...`, its unused `embed_tokens` included), s3gen.safetensors
    with the S3Tokenizer's own keys beside S3Gen's (the converter drops
    them), tokenizer.json, and the S3TokenizerV2 weights with their widths
    in s3tokenizer/."""
    import dataclasses
    import re as _re

    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import flatten_params
    from mlx_audio_tpu_torch.safetensors_io import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    names = {"Wx": "weight_ih", "Wh": "weight_hh", "bias_ih": "bias_ih", "bias_hh": "bias_hh"}
    ve = {}
    for k, v in flatten_params(model.ve).items():
        m = _re.fullmatch(r"lstm\.(\d+)\.(Wx|Wh|bias_ih|bias_hh)", k)
        ve[f"lstm.{names[m.group(2)]}_l{m.group(1)}" if m else k] = v
    ve["similarity_weight"] = np.ones(1, np.float32)
    save_file(ve, path / "ve.safetensors")
    save_file(flatten_params(model.t3), path / "t3_cfg.safetensors")
    gen = dict(flatten_params(model.s3gen))
    gen["tokenizer.quantizer.codebook"] = np.zeros((4, 4), np.float32)
    save_file(gen, path / "s3gen.safetensors")
    write_chatterbox_tokenizer(path)
    save_model(path / "s3tokenizer", flatten_params(s3tok), dataclasses.asdict(s3tok.config))
    return path


CHATTERBOX_TEXT = HTTP_TEXT
CHATTERBOX_TEXTS = (CHATTERBOX_TEXT, "Hello world.", "The model turns text into speech.",
                    "A seeded reference line that the model never heard.")
CHATTERBOX_REF_S = 10.0  # ModelConfig's dec_cond_len (its enc_cond_len is 6 s)
CHATTERBOX_STOP = 75  # planted: 75 speech tokens, 150 mel frames, 72,000 samples, 3.0 s
CHATTERBOX_OFFSET = 40.0  # the speech embeddings' shared direction u
CHATTERBOX_SUPPRESS = 5.0  # the head rows from SOS on: -5·u
CHATTERBOX_PLANT_SCALE = 1e4
CHATTERBOX_PROFILE_STEPS = 32
CHATTERBOX_INT4_STEPS = 16
CHATTERBOX_BATCH_TOKENS = 32  # two ticks of 16
CHATTERBOX_CPU_STEPS = 8
CHATTERBOX_CPU_REF_S = 2.0  # the copy cut in depth: a 2 s reference, HiFT on 1 s
# the copy cut in depth: T3 2 layers, S3Tokenizer 1, the conformer 1 + 1
# blocks, the estimator 1 mid block
CHATTERBOX_CUT_SIZES = {"encoder": dict(num_blocks=1, num_up_blocks=1),
                        "estimator": dict(num_mid_blocks=1)}


def plant_chatterbox(model, stop: int = CHATTERBOX_STOP, seed: int = 0):
    """Make a seeded T3 decode valid speech codes and stop after `stop`
    of them, whatever it samples: every speech embedding carries
    CHATTERBOX_OFFSET·u (u a zero-mean unit direction) and the head rows
    from SOS on are -CHATTERBOX_SUPPRESS·u, so no step takes a token past
    the codebook; the learned speech position row `stop` (fed with the code
    before it) carries CHATTERBOX_PLANT_SCALE·v (v a unit direction
    orthogonal to u), which then rules the final norm's output (about
    sqrt(D)·v), and the stop's head row is 16/sqrt(D)·v: a stop logit of
    ~16 there against the codes' ~N(0, 0.6)."""
    t3 = model.t3
    hp = t3.hp
    w = t3.speech_emb.weight
    g = torch.Generator(device=w.device).manual_seed(seed)
    u = torch.randn(w.shape[1], generator=g, device=w.device)
    u = u - u.mean()
    u = u / u.norm()
    v = torch.randn(w.shape[1], generator=g, device=w.device)
    v = v - v.mean()
    v = v - (v @ u) * u
    v = v / v.norm()
    with torch.no_grad():
        w += CHATTERBOX_OFFSET * u
        t3.speech_pos_emb.emb.weight[stop] += CHATTERBOX_PLANT_SCALE * v
        t3.speech_head.weight[hp.start_speech_token:] = -CHATTERBOX_SUPPRESS * u
        t3.speech_head.weight[hp.stop_speech_token] = 16.0 / w.shape[1] ** 0.5 * v


def chatterbox_config(t3_layers=None) -> dict:
    """config.json of the slice's Chatterbox: `ModelConfig()` (T3 at
    `T3Config.english_only()` on LLAMA_520M_CONFIG), T3 cut to `t3_layers`
    where given."""
    t3 = {} if t3_layers is None else {"llama_overrides": {"num_hidden_layers": t3_layers}}
    return {"model_type": "chatterbox", "t3_config": t3}


def chatterbox_seeded(device="cuda", seed: int = 28):
    """Chatterbox from `seed` at the published widths (`ModelConfig()`,
    `S3Token2Wav()`, `VoiceEncoder()`), the perceiver's queries drawn (the
    JAX initialiser's zeros make all 32 alike), the stop planted; and the
    S3TokenizerV2 at its `ModelConfig()` (128 mels, 1280 x 6, 20 heads)."""
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import ModelConfig, S3TokenizerV2
    from mlx_audio_tpu_torch.tts.models.chatterbox import Model

    model = Model(chatterbox_config(), device=device, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 2)
    with torch.no_grad():
        model.t3.cond_enc.perceiver.pre_attention_query.normal_(0.0, 0.02, generator=g)
    plant_chatterbox(model, seed=seed)
    s3tok = S3TokenizerV2(config=ModelConfig(), device=device, seed=seed + 3)
    return model, s3tok


def chatterbox_launches(cfg, prompt_rows: int, steps: int) -> dict:
    """The quantized launches of one int4 T3 decode from the code: the CFG
    pair's prompt (M = 2·T0 rows: q/k/v fused, o_proj, gate/up fused, down
    on the tensor-core GEMM, the fused MLP's guard refusing M > 16), then
    each step's pair (M = 2: q/k/v and o_proj on the GEMV, the MLP one
    fused launch); the loop feeds every sampled token back, the last one
    included. Only T3's Llama layers are quantized."""
    from mlx_audio_tpu_torch.nn.quantized import fused_mlp_routable, qmm_routable

    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    got = {"qmm": 0, "qmlp": 0, "qmm_kernel": 0, "qmm_gemv": 0, "qmm_mma": 0}
    for M, n in ((2 * prompt_rows, L), (2, L * steps)):
        mlp_fused = fused_mlp_routable(4, GROUP, D, I, D, M)
        for N, K in [(3 * D, D), (D, D)] + ([] if mlp_fused else [(2 * I, D), (D, I)]):
            if qmm_routable(4, GROUP, N, K, M):
                got["qmm"] += n
                got["qmm_gemv" if M <= 4 else "qmm_mma"] += n
        got["qmlp"] += n if mlp_fused else 0
    return got


def chatterbox_split(model, ref, seed: int = 1) -> dict:
    """One generate's parts, each timed apart: the conditioning (the
    mels, two S3Tokenizer windows, CAM++, the voice encoder), T3, the flow
    (the conformer and ten estimator calls at batch 2) and HiFT."""
    from mlx_audio_tpu_torch.tts.models.chatterbox import drop_invalid_tokens

    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conds = model.prepare_conditionals(ref, 24000, exaggeration=0.5)
        torch.cuda.synchronize()
        out["conditioning_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # `generate`'s defaults (its top-p is 1.0; `T3.inference`'s is 0.95)
        toks = model.t3.inference(conds.t3, model.text_ids(CHATTERBOX_TEXT),
                                  max_new_tokens=1000, temperature=0.8, top_p=1.0, min_p=0.05,
                                  repetition_penalty=1.2, cfg_weight=0.5, seed=seed)
        out["t3_s"] = time.perf_counter() - t0
        tokens = drop_invalid_tokens(toks, sos=model.t3.hp.start_speech_token,
                                     eos=model.t3.hp.stop_speech_token)
        t0 = time.perf_counter()
        mel = model.s3gen.flow_inference(tokens[None], conds.gen)
        torch.cuda.synchronize()
        out["flow_s"] = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t0 = time.perf_counter()
        wav, _ = model.s3gen.hift_inference(mel, generator=gen)
        torch.cuda.synchronize()
        out["hift_s"] = time.perf_counter() - t0
    return out, conds, tokens, mel


def chatterbox_generate(model, ref, smi) -> dict:
    """The float32 run: a warm-up, then `generate` from the 10 s reference
    at the defaults (temperature 0.8, CFG 0.5, min-p 0.05, repetition
    penalty 1.2) to the planted stop, timed; its parts apart; a profiled
    prefill and CHATTERBOX_PROFILE_STEPS steps, and the flow's and HiFT's
    device time. No kernel of the port is on this path."""
    with torch.inference_mode():
        list(model.generate(CHATTERBOX_TEXT, ref_audio=ref, audio_prompt_sr=24000,
                            max_new_tokens=4, seed=0))
        torch.cuda.synchronize()
        zero_port_launches()
        t0 = time.perf_counter()
        res = list(model.generate(CHATTERBOX_TEXT, ref_audio=ref, audio_prompt_sr=24000,
                                  exaggeration=0.5, seed=1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = no_port_launches("Chatterbox's float32 generate")
    want = CHATTERBOX_STOP * 2 * 480
    if len(res) != 1 or res[0].samples != want:
        raise SystemExit(f"chip_smoke: Chatterbox generated {[r.samples for r in res]} "
                         f"samples; the planted stop gives {want}")
    audio = res[0].audio
    if not np.isfinite(audio).all() or not np.abs(audio).max() > 0:
        raise SystemExit("chip_smoke: Chatterbox's waveform is not finite, or silent")
    audio_s = res[0].samples / model.sample_rate
    split, conds, tokens, mel = chatterbox_split(model, ref)
    if tokens.size != CHATTERBOX_STOP or mel.shape[1] != 2 * CHATTERBOX_STOP:
        raise SystemExit(f"chip_smoke: Chatterbox's split run took {tokens.size} tokens and "
                         f"{mel.shape[1]} mel frames")
    with torch.inference_mode():
        emb = model.t3.build_prefill_embeds(conds.t3, model.text_ids(CHATTERBOX_TEXT))
        args = (1.0, 1.0, 0.05, 1.2, 0.5, 0)
        profile_one_run(lambda: model.t3.decode(emb, 0, *args), "T3's CFG prefill")
        pre = dict(profile_one_run.last)
        steps = CHATTERBOX_PROFILE_STEPS
        profile_one_run(lambda: model.t3.decode(emb, steps, *args),
                        f"T3's CFG prefill and {steps} steps")
        prof = dict(profile_one_run.last)
        profile_one_run(lambda: model.s3gen.flow_inference(tokens[None], conds.gen),
                        "S3Gen's flow (the conformer, ten estimator calls at batch 2)")
        flow = dict(profile_one_run.last)
        profile_one_run(lambda: model.s3gen.hift_inference(mel), f"HiFT on {mel.shape[1]} frames")
        hift = dict(profile_one_run.last)
    per_step = {k: (prof[k] - pre[k]) / steps for k in ("launches", "device_ms", "wall_ms")}
    per_step["idle_share"] = 1 - per_step["device_ms"] / per_step["wall_ms"]
    log(f"[chatterbox] generate from a {CHATTERBOX_REF_S:.0f} s reference (temperature 0.8, CFG "
        f"0.5, min-p 0.05, repetition 1.2; {CHATTERBOX_STOP} speech tokens, {audio_s:.3f} s of "
        f"audio): wall {wall:.4f} s, RTF {wall / audio_s:.4f}; apart: conditioning "
        f"{split['conditioning_s']:.4f} s, T3 {split['t3_s']:.4f} s, flow {split['flow_s']:.4f} s "
        f"({flow['device_ms']:.2f} ms of device time, {flow['launches']} launches), HiFT "
        f"{split['hift_s']:.4f} s ({hift['device_ms']:.2f} ms, {hift['launches']} launches); a "
        f"T3 step (the CFG pair): {per_step['launches']:.0f} launches, "
        f"{per_step['device_ms']:.3f} ms of device time in {per_step['wall_ms']:.3f} ms of wall "
        f"(idle {100 * per_step['idle_share']:.1f}%); the port's kernels launched {launches} "
        f"({smi})")
    return {"wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
            "speech_tokens": CHATTERBOX_STOP, "samples": res[0].samples, "launches": launches,
            "split": split, "step": per_step, "prompt_rows": emb.shape[1],
            "flow": {k: flow[k] for k in ("device_ms", "launches", "wall_ms")},
            "hift": {k: hift[k] for k in ("device_ms", "launches", "wall_ms")}}


def chatterbox_batched(model, ref) -> dict:
    """T3Batcher with four requests at temperature 0, each capped at
    CHATTERBOX_BATCH_TOKENS, each equal to `T3.decode` of the same request
    alone (the argmax); the speedup over the four alone one after another;
    then `generate` through the installed batcher (the serving infer hook)
    against the direct route."""
    from mlx_audio_tpu_torch.serving import get_infer_hook

    n_b = CHATTERBOX_BATCH_TOKENS
    greedy = dict(temperature=0.0, top_p=1.0, min_p=0.0, repetition_penalty=1.2,
                  cfg_weight=0.5)
    with torch.inference_mode():
        conds = model.prepare_conditionals(ref, 24000, exaggeration=0.5)
        embs = [model.t3.build_prefill_embeds(conds.t3, model.text_ids(t))
                for t in CHATTERBOX_TEXTS]

        def alone(e, n):
            return model.t3.decode(e, n, 0.0, 1.0, 0.0, 1.2, 0.5, 0,
                                   sampler=lambda lg, g: lg.argmax(-1))

        alone(embs[0], 4)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [alone(e, n_b) for e in embs]
        seq_s = time.perf_counter() - t0
    b = model.make_batcher(slots=4, max_len=512, tick_frames=16)
    try:
        b.warmup()
        t0 = time.perf_counter()
        futs = [b.submit(e.cpu().numpy(), max_tokens=n_b, seed=i, **greedy)
                for i, e in enumerate(embs)]
        got = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        batch_s = time.perf_counter() - t0
        ticks = b.dispatch_count
        b.install()
        kw = dict(ref_audio=ref, audio_prompt_sr=24000, max_new_tokens=16, seed=3,
                  temperature=1e-5, min_p=0.05)
        served = list(model.generate(CHATTERBOX_TEXTS[1], **kw))[0]
        served_ticks = b.dispatch_count - ticks
    finally:
        b.close()
    if get_infer_hook(model) is not None or served_ticks < 1:
        raise SystemExit("chip_smoke: generate did not take the installed T3Batcher")
    direct = list(model.generate(CHATTERBOX_TEXTS[1], **kw))[0]
    rel = held_close("generate through the installed T3Batcher against the direct route",
                     served.audio, direct.audio)
    for w, g in zip(want, got):
        if w.tolist() != np.asarray(g).tolist():
            raise SystemExit(f"chip_smoke: a batched T3 request's tokens {list(g)[:8]}... part "
                             f"from its run alone {w.tolist()[:8]}...")
    log(f"[chatterbox] T3Batcher, 4 requests x {n_b} tokens at temperature 0: {batch_s:.3f} s "
        f"batched ({ticks} ticks), {seq_s:.3f} s alone one after another: "
        f"{seq_s / batch_s:.2f}x; tokens identical; generate through the installed batcher "
        f"({served_ticks} ticks) equals the direct route's audio")
    return {"wall_s": batch_s, "sequential_s": seq_s, "speedup": seq_s / batch_s,
            "ticks": ticks, "served_ticks": served_ticks, "served_audio_rel": rel}


def chatterbox_cut_copy(flat: dict, s3flat: dict, ref) -> dict:
    """A copy at full width cut in depth (T3 2 layers, S3Tokenizer 1, the
    conformer 1 + 1 blocks, the estimator 1 mid block), card against CPU
    in float32 on a CHATTERBOX_CPU_REF_S reference: the S3Tokenizer's codes
    (a code may part only where its digit is within TOKEN_TIE_BAR of the
    rounding boundary), CAM++'s x-vector, the voice encoder, T3's prompt and
    CHATTERBOX_CPU_STEPS steps' logits (the card replays the CPU's argmax),
    the flow's mel (the same noise) and HiFT on its first second (the same
    draws)."""
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import (ModelConfig, S3TokenizerV2,
                                                              log_mel_spectrogram, padding)
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.tts.models.chatterbox import Model

    t0 = time.perf_counter()
    deep = re.compile(r"^(t3\.tfmr\.layers|s3gen\.flow\.encoder\.(?:up_)?encoders|"
                      r"encoder\.blocks)\.(\d+)\.")

    def kept(k):
        m = deep.match(k)
        return m is None or int(m.group(2)) < (2 if m.group(1).startswith("t3") else 1)

    two = {k: v for k, v in flat.items()
           if kept(k) and (".mid_blocks_" not in k or ".mid_blocks_0." in k)}
    s3two = {k: v for k, v in s3flat.items() if kept(k)}
    ref = ref[: int(CHATTERBOX_CPU_REF_S * 24000)]
    noise = draws = None
    rec = {}

    def run(dev):
        nonlocal noise, draws
        m = Model(chatterbox_config(t3_layers=2), device=dev, s3gen_sizes=CHATTERBOX_CUT_SIZES)
        load_weights(m, two)
        s3 = S3TokenizerV2(config=ModelConfig(n_audio_layer=1), device=dev)
        load_weights(s3, s3two)
        out = {}
        with torch.inference_mode():
            mel, mel_len = padding([log_mel_spectrogram(ref[:32000], device=dev)])
            h, _ = s3.encoder(torch.as_tensor(mel, device=dev), torch.as_tensor(mel_len,
                                                                                 device=dev))
            out["fsq"] = s3.fsq_codebook.project(h).cpu()
            m.set_runtime(s3_tokenizer=s3)
            conds = m.prepare_conditionals(ref, 24000)
            out["xvector"] = conds.gen["embedding"].cpu()
            out["speaker"] = conds.t3.speaker_emb.cpu()
            out["prompt_tokens"] = conds.gen["prompt_token"].cpu()
            emb = m.t3.build_prefill_embeds(conds.t3, np.array([[255, 5, 6, 7, 8, 0]]))
            out["prompt"] = emb.cpu()
            rows, taken = [], []
            it = iter(rec["codes"]) if "codes" in rec else None

            def sampler(logits, gen):
                rows.append(logits[0].float().cpu())
                tok = int(logits[0].argmax()) if it is None else next(it)
                taken.append(tok)
                return torch.tensor([tok], device=logits.device)

            m.t3.decode(emb, CHATTERBOX_CPU_STEPS, 0.8, 1.0, 0.05, 1.2, 0.5, 0, sampler)
            out["rows"], rec["codes"] = rows, taken
            tokens = np.array([t for t in taken if t < 6561] or [1])
            T = 2 * (conds.gen["prompt_token"].shape[1] + tokens.size)
            if noise is None:
                g = torch.Generator().manual_seed(5)
                noise = torch.randn(1, T, 80, generator=g)
            out["mel"] = m.s3gen.flow_inference(tokens[None], conds.gen,
                                                noise=noise.to(dev)).cpu()
            out["prompt_mel"] = conds.gen["prompt_feat"].cpu()
            frames = conds.gen["prompt_feat"][:, :50]  # 1 s
            sg = m.s3gen.mel2wav.m_source.l_sin_gen
            if draws is None:
                draws = sg.draws(1, 50 * m.s3gen.mel2wav.f0_upsample_scale, "cpu",
                                 torch.Generator().manual_seed(6))
            wav, _ = m.s3gen.hift_inference(frames, draws=tuple(d.to(dev) for d in draws))
            out["wav"] = wav.cpu()
        return out

    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    card = run("cuda")
    f_cpu, f_card = cpu["fsq"].numpy(), card["fsq"].numpy()
    codes_cpu = (np.round(f_cpu) + 1)
    codes_card = (np.round(f_card) + 1)
    parted = codes_cpu != codes_card
    margin = np.abs(np.abs(f_cpu) - 0.5)
    rec["fsq_rel"] = held_close("cut copy, S3Tokenizer (1 layer) pre-round projection, card "
                                "against CPU", f_card, f_cpu)
    if parted.any() and margin[parted].max() > TOKEN_TIE_BAR:
        raise SystemExit("chip_smoke: the cut copy's S3Tokenizer digits part away from a "
                         f"rounding tie (margin {margin[parted].max():.3e})")
    rec["fsq_digits_parted"] = int(parted.sum())
    for key, label in (("xvector", "CAM++ x-vector"), ("speaker", "voice encoder embedding"),
                       ("prompt_mel", "the 24 kHz prompt mel"), ("prompt", "T3 prompt pair"),
                       ("mel", "the flow's mel"), ("wav", "HiFT on 1 s")):
        rec[f"{key}_rel"] = held_close(f"cut copy, {label}, card against CPU", card[key],
                                       cpu[key])
    if not torch.equal(card["prompt_tokens"], cpu["prompt_tokens"]):
        raise SystemExit("chip_smoke: the cut copy's S3Tokenizer prompt tokens part card "
                         "from CPU")
    worst = max(close_to(a, b)[0] / close_to(a, b)[1]
                for a, b in zip(card["rows"], cpu["rows"]))
    log(f"[chatterbox] cut copy (T3 2 layers, S3Tokenizer 1, conformer 1 + 1, estimator 1 mid "
        f"block), {CHATTERBOX_CPU_STEPS} T3 steps' logits card against CPU: worst {worst:.2e} "
        f"of the peak (bar {CARD_VS_CPU_ATOL:g}); FSQ digits parted at ties: "
        f"{rec['fsq_digits_parted']}; CPU side {cpu_s:.1f} s, all {time.perf_counter() - t0:.1f} s")
    if worst > CARD_VS_CPU_ATOL:
        raise SystemExit("chip_smoke: the cut copy's T3 logits part card from CPU")
    rec.update(logits_worst_rel=worst, cpu_s=cpu_s, wall_s=time.perf_counter() - t0)
    return rec


def chatterbox_int4(src: Path, tmp: Path, ref, smi) -> dict:
    """The release files through `chatterbox.convert --quantize` (T3's Llama
    layers int4 g64), loaded by `tts.load_model` and run by
    `tts.generate.generate_audio` for CHATTERBOX_INT4_STEPS steps, the
    quantized launches held to the code's count; then the prompt's and
    every step's logits held to the float32 port on the dequantized
    weights (which replays the int4 model's tokens)."""
    from mlx_audio_tpu_torch import convert
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.tts import generate as tts_generate
    from mlx_audio_tpu_torch.tts import utils as tts_utils
    from mlx_audio_tpu_torch.tts.models.chatterbox import Model
    from mlx_audio_tpu_torch.tts.models.chatterbox.convert import convert as cb_convert
    from mlx_audio_tpu_torch.utils import load_weight_files

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        q = cb_convert(str(src), str(tmp / "chatterbox-int4"), quantize=True)
    convert_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q4 = tts_utils.load_model(str(q))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    steps = CHATTERBOX_INT4_STEPS
    kw = dict(ref_audio=ref, audio_prompt_sr=24000, lang_code="en", verbose=False,
              output_path=str(tmp / "int4-out"))
    with torch.inference_mode(), contextlib.redirect_stdout(sys.stderr):
        tts_generate.generate_audio(CHATTERBOX_TEXT, model=q4, max_new_tokens=4, seed=0, **kw)
        torch.cuda.synchronize()
        qk.reset_launches()
        t0 = time.perf_counter()
        res = tts_generate.generate_audio(CHATTERBOX_TEXT, model=q4, max_new_tokens=steps,
                                          seed=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = quant_counts(4)
        conds = q4.prepare_conditionals(ref, 24000, exaggeration=0.5)
        emb = q4.t3.build_prefill_embeds(conds.t3, q4.text_ids(CHATTERBOX_TEXT))
    predicted = chatterbox_launches(q4.t3.cfg, emb.shape[1], steps)

    def replay(model, codes_in=None):
        rows, taken = [], []
        it = iter(codes_in) if codes_in is not None else None

        def sampler(logits, gen):
            rows.append(logits[0].float().cpu())
            tok = int(logits[0].argmax()) if it is None else next(it)
            taken.append(tok)
            return torch.tensor([tok], device=logits.device)

        model.t3.decode(model.t3.build_prefill_embeds(conds.t3, q4.text_ids(CHATTERBOX_TEXT)),
                        steps, 1.0, 1.0, 0.0, 1.2, 0.5, 0, sampler)
        return rows, taken

    with torch.inference_mode():
        rows4, codes = replay(q4)
    deq = Model(chatterbox_config(), device="cuda")
    load_weights(deq, deq.sanitize(convert.dequantize_weights(load_weight_files(q), 4, GROUP)),
                 strict=False)
    with torch.inference_mode():
        rowsd, _ = replay(deq, codes)
    del deq
    worst = max(close_to(a, b)[0] / close_to(a, b)[1] for a, b in zip(rows4, rowsd))
    argmax_same = [int(a.argmax()) for a in rowsd] == codes
    log(f"[chatterbox] int4 g64 by chatterbox.convert --quantize in {convert_s:.1f} s, loaded "
        f"by tts.load_model in {load_s:.1f} s; generate_audio of {steps} steps {wall:.4f} s "
        f"({res[0].samples} samples): launches {got}, from the code {predicted}; the prompt's "
        f"and {steps} steps' logits against "
        f"the float32 port on the dequantized weights: worst {worst:.2e} of the peak (bar "
        f"{BARK_INT4_BAR:g}), its argmax the int4 tokens: {argmax_same} ({smi})")
    if got != predicted:
        raise SystemExit(f"chip_smoke: the int4 T3 launched {got}, the code says {predicted}")
    if worst > BARK_INT4_BAR or not argmax_same or not np.isfinite(res[0].audio).all():
        raise SystemExit("chip_smoke: the int4 Chatterbox parts from the dequantized model")
    rec = {"convert_s": convert_s, "load_s": load_s, "wall_s": wall,
           "launches": got, "logits_worst_rel": worst, "prompt_rows": emb.shape[1],
           "samples": res[0].samples}
    del q4
    shutil.rmtree(q, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_chatterbox(smi: str) -> dict:
    """Phase 19 (see the module docstring)."""
    import dataclasses

    from mlx_audio_tpu_torch.nn.module import flatten_params
    from mlx_audio_tpu_torch.tts.models.chatterbox import EnTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[slice19] {time.perf_counter() - t_phase:.1f} s into phase 19 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="slice19-"))
    rec = {}
    try:
        t0 = time.perf_counter()
        model, s3tok = chatterbox_seeded()
        parts = {"t3": model.t3, "s3gen": model.s3gen, "ve": model.ve, "s3tokenizer": s3tok,
                 "campplus": model.s3gen.speaker_encoder, "flow": model.s3gen.flow,
                 "hift": model.s3gen.mel2wav}
        n_par = {k: sum(p.numel() for p in m.parameters()) for k, m in parts.items()}
        src = write_chatterbox_upstream(tmp / "chatterbox-release", model, s3tok)
        model.set_runtime(tokenizer=EnTokenizer(src / "tokenizer.json"), s3_tokenizer=s3tok)
        write_s = time.perf_counter() - t0
        log(f"[chatterbox] Chatterbox (T3 at T3Config.english_only() on Llama-520M: 1024 x 30, "
            f"16 heads of 64, MLP 4096, 704 text and 8,194 speech tokens; S3Token2Wav(): the "
            f"conformer 512 x (6 + 4), the estimator 256 channels x 12 mid blocks, HiFT [8, 5, "
            f"3], CAM++; VoiceEncoder()), float32, seeded, the stop planted after "
            f"{CHATTERBOX_STOP} tokens; S3TokenizerV2 at {dataclasses.asdict(s3tok.config)}: "
            f"parameters (M) " + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in n_par.items())
            + f"; the release files written in {write_s:.1f} s")
        rec.update(parameters=n_par, write_s=write_s)
        ref = csm_reference(CHATTERBOX_REF_S, seed=29)
        rec["generate"] = chatterbox_generate(model, ref, smi)
        if rec["generate"]["prompt_rows"] != CHATTERBOX_PROMPT_ROWS:
            raise SystemExit(f"chip_smoke: T3's prompt has {rec['generate']['prompt_rows']} rows; "
                             f"phase 2 times {CHATTERBOX_PROMPT_ROWS}")
        mark("the float32 generate")
        rec["batched"] = chatterbox_batched(model, ref)
        mark("T3Batcher")
        flat, s3flat = flatten_params(model), flatten_params(s3tok)
        del model, s3tok
        gc.collect()
        torch.cuda.empty_cache()
        rec["card_vs_cpu"] = chatterbox_cut_copy(flat, s3flat, ref)
        del flat, s3flat
        mark("the copy cut in depth")
        rec["int4"] = chatterbox_int4(src, tmp, ref, smi)
        mark("int4")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice19] phase 19 wall {rec['phase_s']:.1f} s")
    return rec


COSY_REF_S = 10.0  # the reference clip at 16 kHz: 250 prompt tokens at 25 Hz
COSY_TEXT_TOKENS = 4  # x max_token_text_ratio 20: the decode's cap, 80 steps
COSY_TEXTS = ("Hello world.", "The quick brown fox.", "Hi there.", "Hello.", "The lazy dog.",
              "Jumps over the dog.", "Quick brown dog.")
COSY_BATCH_TEXTS = ("Hello world.", "The quick brown fox jumps.", "Hi.",
                    "The model turns text into speech.")
COSY_BATCH_RATIO = 5.0  # the batched requests' caps: 5 steps a text token
COSY_PROFILE_STEPS = 32
COSY_ARGMAX_SCALE = 1e4  # the LM head scaled: every draw takes the argmax
COSY_CPU_REF_S = 2.0  # the copies cut in depth: a 2 s reference, HiFT on 1 s
COSY_CPU_STEPS = 8
COSY_INT4_BAR = 1e-3  # int4 logits against the float32 port on the dequantized weights
COSY3_FLOW_TOKENS = 400  # seeded tokens after the 250 prompt tokens: N = 1300 frames
COSY3_FLASH = 22 * 10  # the DiT's blocks times the Euler steps
TURBO_TOKENS = 75  # the decode's cap (max_gen_len): 3.0 s of audio
TURBO_TEXT = HTTP_TEXT
TURBO_TEXTS = (TURBO_TEXT, "Hello world.", "The model turns text into speech.",
               "A seeded reference line that the model never heard.")
TURBO_PROFILE_STEPS = 32
TURBO_BATCH_TOKENS = 32  # two ticks of 16
TURBO_REF_S = 10.0


def cosy_text(tok, n: int = COSY_TEXT_TOKENS) -> str:
    """The first of COSY_TEXTS that the tokenizer cuts into n tokens."""
    for text in COSY_TEXTS:
        if len(tok.encode(text)) == n:
            return text
    raise SystemExit(f"chip_smoke: none of {COSY_TEXTS} is {n} tokens long")


def seeded_campplus(device, seed: int):
    from mlx_audio_tpu_torch.codec.models.s3gen import CAMPPlus
    from mlx_audio_tpu_torch.nn.module import init_weights

    return init_weights(CAMPPlus(device=device),
                        torch.Generator(device=device).manual_seed(seed))


def cosy_config(family: str, cut: bool = False):
    """The family's published configuration, cut in depth where `cut`: the
    LM 2 layers, the conformer 1 + 1 blocks and the U-Net 1 mid block
    (CosyVoice2), the DiT 2 blocks (CosyVoice3)."""
    from mlx_audio_tpu_torch.tts.models.cosyvoice2 import CosyVoice2Config
    from mlx_audio_tpu_torch.tts.models.cosyvoice3 import CosyVoice3Config

    cfg = CosyVoice2Config() if family == "cosyvoice2" else CosyVoice3Config()
    if cut:
        cfg.llm.num_hidden_layers = 2
        if family == "cosyvoice2":
            cfg.flow.encoder_num_blocks = cfg.flow.encoder_num_up_blocks = 1
            cfg.flow.decoder_num_mid_blocks = 1
        else:
            cfg.flow.dit.depth = 2
    return cfg


def s3_config(version: int):
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import ModelConfig

    return ModelConfig() if version == 2 else ModelConfig(n_audio_layer=12)


def write_cosyvoice_release(path: Path, model, s3tok, campplus, model_type: str) -> Path:
    """`model` (a CosyVoice Model of the port) as a consolidated checkpoint:
    model.safetensors with the LM under its upstream `llm.model.model.*`
    names and CAM++ under `campplus.*`, config.json, a Qwen2-style
    tokenizer.json, and the S3Tokenizer with its widths in s3tokenizer/."""
    import dataclasses

    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import flatten_params

    path = Path(path)
    weights = {k.replace("model.llm.llm.model.", "model.llm.llm.model.model.", 1): v
               for k, v in flatten_params(model).items()}
    weights.update({f"campplus.{k}": v for k, v in flatten_params(campplus).items()})
    cfg = {"model_type": model_type, "sample_rate": 24000}
    if model_type == "cosyvoice2":  # its loader reads the widths (CosyVoice3's does not)
        cfg.update(dataclasses.asdict(model.model.config))
    save_model(path, weights, cfg)
    write_tokenizer_json(path, "qwen2")
    save_model(path / "s3tokenizer", flatten_params(s3tok), dataclasses.asdict(s3tok.config))
    return path


def cosy_runtime(model, src: Path, s3tok, campplus) -> None:
    """The checkpoint's tokenizer (the port's reader with the family's added
    tokens), and the S3Tokenizer and CAM++ in memory."""
    model.config.model_path = str(src)
    model.set_runtime(tokenizer=model._runtime_part("tokenizer"), s3_tokenizer=s3tok,
                      speaker_encoder=campplus)


@contextlib.contextmanager
def cosy_split(model):
    """Each stage of the `generate` run inside timed apart: the reference
    (the S3Tokenizer, CAM++ and the prompt mel), the LM, the flow and the
    vocoder, each call wrapped on the instance and synchronised; yields the
    dict of seconds, and what each stage last returned under "last"."""
    out = {"last": {}}
    stages = ((model, "prompt", "reference_s"), (model.model, "generate_tokens", "llm_s"),
              (model.model, "tokens_to_mel", "flow_s"), (model.model, "mel_to_audio",
                                                           "vocoder_s"))

    def timed(fn, key):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            out[key] = out.get(key, 0.0) + time.perf_counter() - t0
            out["last"][key] = r
            return r
        return call

    for obj, name, key in stages:
        setattr(obj, name, timed(getattr(obj, name), key))
    try:
        yield out
    finally:
        for obj, name, _ in stages:
            delattr(obj, name)


def cosy_generate(model, ref, text, label: str, smi) -> dict:
    """A warm-up and a timed zero-shot `generate` from the 10 s reference; its
    parts timed apart; a profiled prefill and COSY_PROFILE_STEPS LM steps;
    the flow's and the vocoder's device time."""
    from mlx_audio_tpu_torch.tts.models.cosyvoice2.llm import decode_loop

    ref_text = "A seeded reference line."
    lm = model.model.llm
    tok = model._runtime_part("tokenizer")
    with torch.inference_mode():
        # warm each stage on a short input (the eager path compiles nothing)
        prompt = model.prompt(ref[:16000])
        lm.inference(np.asarray(tok.encode(text), np.int32), None, prompt[0],
                     max_token_text_ratio=1.0, seed=0)
        model.model.mel_to_audio(model.model.tokens_to_mel(np.arange(4), *prompt))
        torch.cuda.synchronize()
        zero_port_launches()
        with cosy_split(model) as split:
            t0 = time.perf_counter()
            res = list(model.generate(text, ref_audio=ref, ref_text=ref_text, seed=1,
                                      verbose=False))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    launches = port_kernel_launches()
    audio = np.concatenate([r.audio for r in res])
    if not np.isfinite(audio).all() or not np.abs(audio).max() > 0:
        raise SystemExit(f"chip_smoke: {label}'s waveform is not finite, or silent")
    audio_s = audio.size / model.sample_rate
    last = split.pop("last")
    prompt, tokens, mel = last["reference_s"], last["llm_s"], last["flow_s"]
    ids = np.asarray(tok.encode(text), np.int32)
    prompt_ids = np.asarray(tok.encode(model.prompt_text(ref_text)), np.int32)
    with torch.inference_mode():
        emb = lm.build_prompt_embeds(ids, prompt_ids, prompt[0])
        profile_one_run(lambda: decode_loop(lm, emb, 0, 0, 0, v3=lm.V3),
                        f"{label}'s LM prefill ({emb.shape[1]} rows)")
        pre = dict(profile_one_run.last)
        steps = COSY_PROFILE_STEPS
        profile_one_run(lambda: decode_loop(lm, emb, steps, steps, 0, v3=lm.V3),
                        f"{label}'s LM prefill and {steps} steps")
        prof = dict(profile_one_run.last)
        profile_one_run(lambda: model.model.tokens_to_mel(tokens, *prompt, seed=1),
                        f"{label}'s flow on {tokens.size} tokens")
        flow = dict(profile_one_run.last)
        profile_one_run(lambda: model.model.mel_to_audio(mel, seed=1),
                        f"{label}'s vocoder on {mel.shape[1]} frames")
        voc = dict(profile_one_run.last)
    per_step = {k: (prof[k] - pre[k]) / steps for k in ("launches", "device_ms", "wall_ms")}
    per_step["idle_share"] = 1 - per_step["device_ms"] / per_step["wall_ms"]
    log(f"[{label.lower()}] zero-shot generate from a {COSY_REF_S:.0f} s reference "
        f"({prompt[0].shape[1]} prompt tokens), {len(ids)} text tokens: {audio_s:.3f} s of audio "
        f"in {wall:.4f} s, RTF {wall / audio_s:.4f}; apart: reference {split['reference_s']:.4f} "
        f"s, LM {split['llm_s']:.4f} s ({tokens.size} tokens), flow {split['flow_s']:.4f} s "
        f"({flow['device_ms']:.2f} ms of device time, {flow['launches']} launches), vocoder "
        f"{split['vocoder_s']:.4f} s ({voc['device_ms']:.2f} ms, {voc['launches']} launches); an "
        f"LM step: {per_step['launches']:.0f} launches, {per_step['device_ms']:.3f} ms of device "
        f"time in {per_step['wall_ms']:.3f} ms of wall (idle {100 * per_step['idle_share']:.1f}%);"
        f" the port's kernels launched {launches} ({smi})")
    return {"wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
            "speech_tokens": int(tokens.size), "prompt_rows": int(emb.shape[1]),
            "launches": launches, "split": split, "step": per_step,
            "flow": {k: flow[k] for k in ("device_ms", "launches", "wall_ms")},
            "vocoder": {k: voc[k] for k in ("device_ms", "launches", "wall_ms")}}, prompt


@contextlib.contextmanager
def argmax_head(lm, scale: float = COSY_ARGMAX_SCALE):
    """The LM's head scaled so every RAS draw takes the argmax (the
    batcher's comparison at the argmax settings); restored after."""
    w = lm.llm_decoder.weight
    b = getattr(lm.llm_decoder, "bias", None)
    with torch.no_grad():
        w.mul_(scale)
        if b is not None:
            b.mul_(scale)
    try:
        yield
    finally:
        with torch.no_grad():
            w.div_(scale)
            if b is not None:
                b.div_(scale)


def cosy_batched(model, ref, prompt, label: str) -> dict:
    """RASBatcher with four requests of different texts at the argmax
    settings, each capped at COSY_BATCH_RATIO steps a text token and equal
    to the decode of the same request alone; the speedup over the four
    alone one after another; then `generate` through the installed batcher
    against the direct route."""
    from mlx_audio_tpu_torch.serving import get_infer_hook
    from mlx_audio_tpu_torch.tts.models.cosyvoice2.llm import decode_loop, step_limits

    lm = model.model.llm
    tok = model._runtime_part("tokenizer")
    ptok = prompt[0]
    reqs = []
    with torch.inference_mode():
        for i, text in enumerate(COSY_BATCH_TEXTS):
            ids = np.asarray(tok.encode(text), np.int32)
            emb = lm.build_prompt_embeds(ids, None, ptok)
            reqs.append((emb, *step_limits(ids.size, emb.shape[1], COSY_BATCH_RATIO, 2.0),
                         40 + i))
    with argmax_head(lm):
        with torch.inference_mode():
            decode_loop(lm, reqs[0][0], 0, 4, 0, v3=lm.V3)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = [decode_loop(lm, e, lo, hi, s, v3=lm.V3) for e, lo, hi, s in reqs]
            seq_s = time.perf_counter() - t0
        b = model.make_batcher(slots=4, max_len=512, tick_frames=16)
        try:
            b.warmup()
            t0 = time.perf_counter()
            futs = [b.submit(e.float().cpu().numpy(), min_tokens=lo, max_steps=hi, seed=s)
                    for e, lo, hi, s in reqs]
            got = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
            batch_s = time.perf_counter() - t0
            ticks = b.dispatch_count
            b.install()
            kw = dict(ref_audio=ref, ref_text="A seeded reference line.", seed=3, verbose=False)
            served = list(model.generate(COSY_BATCH_TEXTS[2], **kw))[0]
            served_ticks = b.dispatch_count - ticks
        finally:
            b.close()
        if get_infer_hook(model.model) is not None or served_ticks < 1:
            raise SystemExit(f"chip_smoke: {label}'s generate did not take the installed "
                             "RASBatcher")
        direct = list(model.generate(COSY_BATCH_TEXTS[2], **kw))[0]
    rel = held_close(f"{label}'s generate through the installed RASBatcher against the direct "
                     "route", served.audio, direct.audio)
    for w, g in zip(want, got):
        if w.tolist() != np.asarray(g).tolist():
            raise SystemExit(f"chip_smoke: a batched {label} request's tokens {list(g)[:8]}... "
                             f"part from its run alone {w.tolist()[:8]}...")
    n_tok = sum(len(w) for w in want)
    log(f"[{label.lower()}] RASBatcher, 4 requests at the argmax settings ({n_tok} tokens in "
        f"all): {batch_s:.3f} s batched ({ticks} ticks), {seq_s:.3f} s alone one after another: "
        f"{seq_s / batch_s:.2f}x; tokens identical; generate through the installed batcher "
        f"({served_ticks} ticks) equals the direct route's audio")
    return {"wall_s": batch_s, "sequential_s": seq_s, "speedup": seq_s / batch_s,
            "tokens": n_tok, "ticks": ticks, "served_ticks": served_ticks,
            "served_audio_rel": rel}


def record_logits(module):
    """A forward hook on `module` keeping each call's output, float32 on the
    host; returns (rows, handle)."""
    rows = []
    handle = module.register_forward_hook(
        lambda m, a, out: rows.append(out.detach().float().reshape(-1, out.shape[-1]).cpu()))
    return rows, handle


def cosy_cut_copy(build, label: str, ref, hift_draws) -> dict:
    """A copy at full width cut in depth (`build(device)` makes it from its
    seed), card against CPU in float32 on a COSY_CPU_REF_S reference: the
    LM's prompt and COSY_CPU_STEPS steps' logits (the card replays the
    CPU's argmax), the flow's mel (the same noise) and the vocoder on one
    second (the same draws)."""
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.nn.module import flatten_params
    from mlx_audio_tpu_torch.tts.models.cosyvoice2.llm import decode_loop

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    ptok = rng.integers(0, 6561, (1, int(COSY_CPU_REF_S * 25)))
    pmel = rng.standard_normal((1, 2 * ptok.shape[1], 80)).astype(np.float32)
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    ids = rng.integers(0, 150000, 6).astype(np.int32)
    flat, rec, noise = None, {}, None

    def run(dev):
        nonlocal flat, noise
        m = build(dev)
        if flat is None:
            flat = flatten_params(m)
        else:
            load_weights(m, flat)
        out = {}
        lm = m.model.llm
        rows, handle = record_logits(lm.llm_decoder)
        it = iter(rec["codes"]) if "codes" in rec else None
        taken = []

        def sampler(logp, hist, gen):
            tok = int(logp[0].argmax()) if it is None else next(it)
            taken.append(tok)
            return torch.tensor([tok], device=logp.device)

        with torch.inference_mode():
            emb = lm.build_prompt_embeds(ids, None, ptok)
            out["prompt"] = emb.cpu()
            decode_loop(lm, emb, 0, COSY_CPU_STEPS, 0, v3=lm.V3, sampler=sampler)
            handle.remove()
            out["rows"], rec["codes"] = rows, taken
            tokens = np.array([t for t in taken if t < 6561] or [1])
            T = 2 * (ptok.shape[1] + 50)
            if noise is None:
                noise = torch.randn(1, T, 80, generator=torch.Generator().manual_seed(5))
            out["mel"] = m.model.tokens_to_mel(tokens, ptok, pmel, spk,
                                               noise=noise.to(dev)).float().cpu()
            voc = m.model.hifigan
            out["wav"] = torch.as_tensor(m.model.mel_to_audio(
                pmel[:, :50], draws=tuple(d.to(dev) for d in hift_draws(voc))))
        return out

    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    card = run("cuda")
    for key, what in (("prompt", "the LM's prompt"), ("mel", "the flow's mel"),
                      ("wav", "the vocoder on 1 s")):
        rec[f"{key}_rel"] = held_close(f"{label} cut copy, {what}, card against CPU", card[key],
                                       cpu[key])
    worst = max(close_to(a, b)[0] / close_to(a, b)[1] for a, b in zip(card["rows"], cpu["rows"]))
    log(f"[{label.lower()}] cut copy, the prompt's and {COSY_CPU_STEPS} LM steps' logits card "
        f"against CPU: worst {worst:.2e} of the peak (bar {CARD_VS_CPU_ATOL:g}); CPU side "
        f"{cpu_s:.1f} s, all {time.perf_counter() - t0:.1f} s")
    if worst > CARD_VS_CPU_ATOL:
        raise SystemExit(f"chip_smoke: the {label} cut copy's LM logits part card from CPU")
    rec.pop("codes")
    rec.update(logits_worst_rel=worst, cpu_s=cpu_s, wall_s=time.perf_counter() - t0)
    return rec


def cosyvoice2_launches(cfg, prompt_rows: int, steps: int) -> dict:
    """The quantized launches of one int4 CosyVoice2 LM decode from the code:
    the prompt (M = T0: q/k/v fused, o_proj, gate/up fused and down on the
    tensor-core GEMM; the fused MLP's guard refuses I = 4864), the head on
    its last row, then each step (M = 1, the GEMV) and its head. The tables
    (the text, speech and flow embeddings) dequantize rows, no kernel."""
    from mlx_audio_tpu_torch.nn.quantized import fused_mlp_routable, qmm_routable

    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, D // cfg.num_attention_heads
    head = (cfg.speech_token_size + 3, D)
    got = {"qmm": 0, "qmlp": 0, "qmm_kernel": 0, "qmm_gemv": 0, "qmm_mma": 0}

    def add(M, n, N, K):
        if qmm_routable(4, GROUP, N, K, M):
            got["qmm"] += n
            got["qmm_gemv" if M <= 4 else "qmm_mma"] += n

    for M, n in ((prompt_rows, L), (1, L * steps)):
        mlp_fused = fused_mlp_routable(4, GROUP, D, I, D, M)
        for N, K in [((H + 2 * KV) * hd, D), (D, D)] + ([] if mlp_fused
                                                        else [(2 * I, D), (D, I)]):
            add(M, n, N, K)
        got["qmlp"] += n if mlp_fused else 0
    add(1, 1 + steps, *head)
    return got


def cosy_int4(src: Path, tmp: Path, ref, text, smi) -> dict:
    """The consolidated checkpoint through `convert --quantize` (every 2-D
    weight whose rows are a multiple of 64: the LM, its head and tables,
    the flow's linears and tables), loaded by `tts.load_model` and run by
    `tts.generate.generate_audio` on the checkpoint's S3Tokenizer and
    CAM++; then the LM decode alone with the quantized launches held to the
    code's count, its prompt's and every step's logits held to the float32
    port on the dequantized weights (which replays the int4 model's
    tokens)."""
    from mlx_audio_tpu_torch import convert
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.ops.cuda import quant_matmul as qk
    from mlx_audio_tpu_torch.tts import generate as tts_generate
    from mlx_audio_tpu_torch.tts import utils as tts_utils
    from mlx_audio_tpu_torch.tts.models.cosyvoice2 import Model, ModelConfig
    from mlx_audio_tpu_torch.tts.models.cosyvoice2.llm import decode_loop, step_limits
    from mlx_audio_tpu_torch.utils import load_weight_files

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        q = convert.convert(str(src), str(tmp / "cosyvoice2-int4"), quantize=True)
    convert_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q4 = tts_utils.load_model(str(q))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    kinds = {type(q4.model.llm.llm.model.layers[0].mlp.down_proj).__name__,
             type(q4.model.llm.llm_decoder).__name__,
             type(q4.model.llm.speech_embedding).__name__,
             type(q4.model.flow.encoder_proj).__name__}
    if kinds != {"QuantizedLinear", "QuantizedEmbedding"}:
        raise SystemExit(f"chip_smoke: the int4 CosyVoice2 loaded as {kinds}")
    kw = dict(ref_audio=ref, ref_text="A seeded reference line.", verbose=False,
              output_path=str(tmp / "int4-out"))
    with torch.inference_mode(), contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        res = tts_generate.generate_audio(text, model=q4, seed=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gen_launches = quant_counts(4)
        tok = q4._runtime_part("tokenizer")
        ids = np.asarray(tok.encode(text), np.int32)
        ptok, _, _ = q4.prompt(ref)
        emb = q4.model.llm.build_prompt_embeds(ids, None, ptok)
        lo, hi = step_limits(ids.size, emb.shape[1], 20.0, 2.0)
    lm4 = q4.model.llm

    def replay(lm, codes_in=None):
        rows, handle = record_logits(lm.llm_decoder)
        it = iter(codes_in) if codes_in is not None else None
        taken = []

        def sampler(logp, hist, gen):
            tok_ = int(logp[0].argmax()) if it is None else next(it)
            taken.append(tok_)
            return torch.tensor([tok_], device=logp.device)

        with torch.inference_mode():
            decode_loop(lm, emb, lo, hi, 0, sampler=sampler)
        handle.remove()
        return rows, taken

    torch.cuda.synchronize()
    qk.reset_launches()
    rows4, codes = replay(lm4)
    torch.cuda.synchronize()
    got = quant_counts(4)
    steps = len(codes)  # the sampler is called once a step
    predicted = cosyvoice2_launches(lm4.config, emb.shape[1], steps)
    deq = Model(ModelConfig(cosyvoice2=cosy_config("cosyvoice2")), device="cuda")
    load_weights(deq, deq.sanitize(convert.dequantize_weights(load_weight_files(q), 4, GROUP)),
                 strict=False)
    rowsd, _ = replay(deq.model.llm, codes)
    del deq
    worst = max(close_to(a, b)[0] / close_to(a, b)[1] for a, b in zip(rows4, rowsd))
    log(f"[cosyvoice2] int4 g64 by convert --quantize in {convert_s:.1f} s, loaded by "
        f"tts.load_model in {load_s:.1f} s; generate_audio {wall:.4f} s ({res[0].samples} "
        f"samples, quantized launches {gen_launches}); the LM decode alone ({emb.shape[1]}-row "
        f"prompt, {steps} steps): launches {got}, from the code {predicted}; the prompt's and "
        f"{steps} steps' logits against the float32 port on the dequantized weights: worst "
        f"{worst:.2e} of the peak (bar {COSY_INT4_BAR:g}) ({smi})")
    if got != predicted:
        raise SystemExit(f"chip_smoke: the int4 CosyVoice2 LM launched {got}, the code says "
                         f"{predicted}")
    if worst > COSY_INT4_BAR or not np.isfinite(res[0].audio).all():
        raise SystemExit("chip_smoke: the int4 CosyVoice2 parts from the dequantized model")
    rec = {"convert_s": convert_s, "load_s": load_s, "wall_s": wall, "samples": res[0].samples,
           "generate_launches": gen_launches, "launches": got, "steps": steps,
           "prompt_rows": int(emb.shape[1]), "logits_worst_rel": worst}
    del q4
    shutil.rmtree(q, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def cosy_vc(model, ref, label: str) -> dict:
    """One voice-conversion call: 4 s of source audio through the S3Tokenizer
    into the flow, no LM."""
    src = csm_reference(4.0, seed=33, sr=16000)
    with torch.inference_mode():
        t0 = time.perf_counter()
        res = list(model.generate("", ref_audio=ref, source_audio=src, seed=2, verbose=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    audio = res[0].audio
    n_src = model.source_tokens(src).shape[1]
    if audio.size != n_src * 2 * 480 or not np.isfinite(audio).all():
        raise SystemExit(f"chip_smoke: {label}'s voice conversion gave {audio.size} samples for "
                         f"{n_src} source tokens")
    log(f"[{label.lower()}] voice conversion of 4 s ({n_src} source tokens): {wall:.4f} s")
    return {"wall_s": wall, "source_tokens": int(n_src), "samples": int(audio.size)}


def phase_cosyvoice2(smi: str) -> dict:
    """Phase 20 (see the module docstring)."""
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import S3TokenizerV2
    from mlx_audio_tpu_torch.tts.models.cosyvoice2 import Model, ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[slice20] {time.perf_counter() - t_phase:.1f} s into phase 20 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="slice20-"))
    rec = {}
    try:
        t0 = time.perf_counter()
        model = Model(ModelConfig(cosyvoice2=cosy_config("cosyvoice2")), device="cuda", seed=34)
        s3tok = S3TokenizerV2(config=s3_config(2), device="cuda", seed=35)
        campplus = seeded_campplus("cuda", 36)
        src = write_cosyvoice_release(tmp / "cosyvoice2-release", model, s3tok, campplus,
                                      "cosyvoice2")
        cosy_runtime(model, src, s3tok, campplus)
        text = cosy_text(model._runtime_part("tokenizer"))
        parts = {"llm": model.model.llm, "flow": model.model.flow, "hift": model.model.hifigan,
                 "s3tokenizer": s3tok, "campplus": campplus}
        n_par = {k: sum(p.numel() for p in m.parameters()) for k, m in parts.items()}
        write_s = time.perf_counter() - t0
        log(f"[cosyvoice2] CosyVoice2 at CosyVoice2Config() (Qwen2-0.5B 896 x 24, 14 heads, "
            f"2 kv heads, MLP 4864, 151,936 text and 6,564 speech rows; the flow's conformer "
            f"512 x (6 + 4), the U-Net 256 channels x 12 mid blocks; HiFT [8, 5, 3]), float32, "
            f"seeded; S3TokenizerV2 and CAM++ seeded: parameters (M) "
            + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in n_par.items())
            + f"; the checkpoint written in {write_s:.1f} s; the text {text!r}")
        rec.update(parameters=n_par, write_s=write_s)
        ref = csm_reference(COSY_REF_S, seed=37, sr=16000)
        rec["generate"], prompt = cosy_generate(model, ref, text, "CosyVoice2", smi)
        if rec["generate"]["launches"] != dict.fromkeys(rec["generate"]["launches"], 0):
            raise SystemExit("chip_smoke: the float32 CosyVoice2 launched the port's kernels")
        mark("the float32 generate")
        rec["vc"] = cosy_vc(model, ref, "CosyVoice2")
        rec["batched"] = cosy_batched(model, ref, prompt, "CosyVoice2")
        mark("RASBatcher")
        del model, s3tok, campplus
        gc.collect()
        torch.cuda.empty_cache()

        def build(dev):
            return Model(ModelConfig(cosyvoice2=cosy_config("cosyvoice2", cut=True)), device=dev,
                         seed=38)

        def draws(voc):
            return voc.m_source.l_sin_gen.draws(1, 50 * voc.f0_upsample_scale, "cpu",
                                                torch.Generator().manual_seed(6))

        rec["card_vs_cpu"] = cosy_cut_copy(build, "CosyVoice2", ref, draws)
        mark("the copy cut in depth")
        rec["int4"] = cosy_int4(src, tmp, ref, text, smi)
        if rec["int4"]["prompt_rows"] != COSY2_PROMPT_ROWS:
            raise SystemExit(f"chip_smoke: the int4 CosyVoice2 prompt has "
                             f"{rec['int4']['prompt_rows']} rows; phase 2 times "
                             f"{COSY2_PROMPT_ROWS}")
        mark("int4")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice20] phase 20 wall {rec['phase_s']:.1f} s")
    return rec


def cosy3_suppress_stop(model) -> None:
    """The decode run to its cap: the LM head's rows past the speech tokens
    (the stop and the other extended tokens) zero, the speech rows five
    times their draw (their logits' spread about 3), so an extended token
    is neither in the top-25 nucleus nor, but at ~3e-4 a step, drawn by the
    repetition resample."""
    lm = model.model.llm
    V = lm.speech_token_size
    with torch.no_grad():
        lm.llm_decoder.weight[V:] = 0.0
        lm.llm_decoder.weight[:V] *= 5.0


def cosy3_long_flow(model, prompt) -> dict:
    """`tokens_to_mel` plus `mel_to_audio` on the 10 s reference's 250 prompt
    tokens and COSY3_FLOW_TOKENS seeded tokens (N = 1300 frames): the DiT
    launches `flash_fwd_f32` once a block an Euler step, counted through the
    wrapper; the flow's and the vocoder's times."""
    from mlx_audio_tpu_torch.ops.cuda.flash_attention import flash_attention

    ptok, pmel, emb = prompt
    tokens = np.random.default_rng(39).integers(0, 6561, COSY3_FLOW_TOKENS)
    m = model.model
    # the code's count: one launch a DiT block an Euler step (22 x 10 at the
    # published depth)
    want = len(m.flow.decoder.estimator.transformer_blocks) * m.flow.n_timesteps
    if want != COSY3_FLASH:
        raise SystemExit(f"chip_smoke: CosyVoice3's DiT has {want} block-steps, not "
                         f"{COSY3_FLASH}")
    with torch.inference_mode():
        m.tokens_to_mel(tokens[:50], ptok, pmel, emb, seed=0)  # warm (N < 1280: no flash)
        torch.cuda.synchronize()
        zero_port_launches()
        t0 = time.perf_counter()
        mel = m.tokens_to_mel(tokens, ptok, pmel, emb, seed=0)
        torch.cuda.synchronize()
        flow_s = time.perf_counter() - t0
        n_flash = flash_attention.launches
        launches = port_kernel_launches()
        t0 = time.perf_counter()
        wav = m.mel_to_audio(mel, seed=0)
        voc_s = time.perf_counter() - t0
        _, kernels = profile_one_run(lambda: m.tokens_to_mel(tokens, ptok, pmel, emb, seed=0),
                                     f"CosyVoice3's flow at N = {2 * (ptok.shape[1] + 400)}")
        flow_prof = dict(profile_one_run.last)
    N = 2 * (ptok.shape[1] + tokens.size)
    flash_dev = {k: v for k, v in kernels.items() if "flash_fwd" in k}
    log(f"[cosyvoice3] the flow on {ptok.shape[1]} prompt + {tokens.size} seeded tokens (N = "
        f"{N}, the CFG pair B = 2, 16 heads of 64): {flow_s:.4f} s, flash launches {n_flash} "
        f"(the code: {want}), the port's kernels {launches}; profiled: "
        f"{flow_prof['device_ms']:.2f} ms of device time, the flash kernels {flash_dev}; the "
        f"vocoder on {mel.shape[1]} frames {voc_s:.4f} s ({wav.shape[-1]} samples)")
    if n_flash != want or launches["flash"] != want:
        raise SystemExit(f"chip_smoke: CosyVoice3's DiT launched flash {n_flash} times at N = "
                         f"{N}; the code says {want}")
    if mel.shape[1] != 2 * tokens.size or not torch.isfinite(mel).all() \
            or not np.isfinite(wav).all():
        raise SystemExit("chip_smoke: CosyVoice3's long flow gave a bad mel or waveform")
    return {"N": N, "flow_s": flow_s, "vocoder_s": voc_s, "flash_launches": n_flash,
            "launches": launches, "flow_device_ms": flow_prof["device_ms"],
            "flash_device": {k: list(v) for k, v in flash_dev.items()}}


def phase_cosyvoice3(smi: str) -> dict:
    """Phase 21 (see the module docstring)."""
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import S3TokenizerV3
    from mlx_audio_tpu_torch.tts.models.cosyvoice3 import Model, ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[slice21] {time.perf_counter() - t_phase:.1f} s into phase 21 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="slice21-"))
    rec = {}
    try:
        t0 = time.perf_counter()
        model = Model(ModelConfig(cosyvoice3=cosy_config("cosyvoice3")), device="cuda", seed=40)
        cosy3_suppress_stop(model)
        s3tok = S3TokenizerV3(config=s3_config(3), device="cuda", seed=41)
        campplus = seeded_campplus("cuda", 42)
        write_tokenizer_json(tmp, "qwen2")
        model.config.model_path = str(tmp)
        model.set_runtime(tokenizer=model._runtime_part("tokenizer"), s3_tokenizer=s3tok,
                          speaker_encoder=campplus)
        text = cosy_text(model._runtime_part("tokenizer"))
        parts = {"llm": model.model.llm, "flow": model.model.flow, "hift": model.model.hifigan,
                 "s3tokenizer": s3tok, "campplus": campplus}
        n_par = {k: sum(p.numel() for p in m.parameters()) for k, m in parts.items()}
        log(f"[cosyvoice3] CosyVoice3 at CosyVoice3Config() (Qwen2-0.5B, 6,761 speech rows; "
            f"the DiT 1024 x 22, 16 heads of 64; the causal HiFT), float32, seeded, the rows "
            f"past the speech tokens pushed down (the decode runs to its cap); S3TokenizerV3 "
            f"and CAM++ seeded: parameters (M) "
            + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in n_par.items())
            + f" in {time.perf_counter() - t0:.1f} s; the text {text!r}")
        rec["parameters"] = n_par
        ref = csm_reference(COSY_REF_S, seed=43, sr=16000)
        rec["generate"], prompt = cosy_generate(model, ref, text, "CosyVoice3", smi)
        if rec["generate"]["launches"] != dict.fromkeys(rec["generate"]["launches"], 0):
            raise SystemExit("chip_smoke: the float32 CosyVoice3 launched the port's kernels "
                             "(its N is under flash's 1280)")
        mark("the float32 generate")
        rec["long_flow"] = cosy3_long_flow(model, prompt)
        mark("the long flow")
        del model, s3tok, campplus
        gc.collect()
        torch.cuda.empty_cache()

        def build(dev):
            return Model(ModelConfig(cosyvoice3=cosy_config("cosyvoice3", cut=True)), device=dev,
                         seed=44)

        def draws(voc):
            return voc.m_source.l_sin_gen.draws(1, 50 * voc.f0_upsample_scale, "cpu",
                                                torch.Generator().manual_seed(6))

        rec["card_vs_cpu"] = cosy_cut_copy(build, "CosyVoice3", ref, draws)
        mark("the copy cut in depth")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice21] phase 21 wall {rec['phase_s']:.1f} s")
    return rec


def turbo_suppress_stop(model) -> None:
    """The decode run to max_gen_len: the stop's head row zero, so its logit
    (0) stays under the 1000th largest (about one spread up) and top-k
    1000 never keeps it."""
    with torch.no_grad():
        model.t3.speech_head.weight[model.t3.hp.stop_speech_token] = 0.0


def turbo_seeded(device="cuda", seed: int = 45, cut: bool = False):
    """Chatterbox-Turbo at the published widths from `seed`, cut in depth
    where `cut`: GPT-2 2 layers, the
    conformer 1 + 1 blocks, the estimator 1 mid block."""
    from mlx_audio_tpu_torch.tts.models.chatterbox_turbo import Model, ModelConfig, T3TurboConfig

    hp = T3TurboConfig(gpt2_overrides={"n_layer": 2} if cut else None)
    sizes = {part: dict(over) for part, over in CHATTERBOX_CUT_SIZES.items()} if cut else None
    return Model(ModelConfig(t3_config=hp), device=device, seed=seed, s3gen_sizes=sizes)


def turbo_generate(model, ref, smi) -> dict:
    """A warm-up and a timed `generate` from the 10 s reference to the cap
    (TURBO_TOKENS); its parts timed apart; a profiled prefill and
    TURBO_PROFILE_STEPS steps; the flow's and HiFT's device time."""
    kw = dict(sample_rate=24000, temperature=0.8, top_k=1000, top_p=0.95,
              repetition_penalty=1.2)
    with torch.inference_mode():
        list(model.generate(TURBO_TEXT, ref_audio=ref, max_tokens=8, seed=0, **kw))
        torch.cuda.synchronize()
        zero_port_launches()
        t0 = time.perf_counter()
        res = list(model.generate(TURBO_TEXT, ref_audio=ref, max_tokens=TURBO_TOKENS, seed=1,
                                  **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = no_port_launches("Chatterbox-Turbo's float32 generate")
    want = (TURBO_TOKENS + 3) * 2 * 480
    if len(res) != 1 or res[0].samples != want:
        raise SystemExit(f"chip_smoke: Chatterbox-Turbo generated {[r.samples for r in res]} "
                         f"samples; {TURBO_TOKENS} tokens and 3 of silence give {want}")
    audio = res[0].audio
    if not np.isfinite(audio).all() or not np.abs(audio).max() > 0:
        raise SystemExit("chip_smoke: Chatterbox-Turbo's waveform is not finite, or silent")
    audio_s = res[0].samples / model.sample_rate
    split = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conds = model.prepare_conditionals(ref, 24000)
        torch.cuda.synchronize()
        split["conditioning_s"] = time.perf_counter() - t0
        ids = model._tokenize_text(TURBO_TEXT)
        t0 = time.perf_counter()
        toks = model.t3.inference_turbo(conds.t3, ids, max_gen_len=TURBO_TOKENS, seed=1,
                                        **{k: v for k, v in kw.items() if k != "sample_rate"})
        split["t3_s"] = time.perf_counter() - t0
        tokens = model._filter_speech_tokens(toks)
        t0 = time.perf_counter()
        mel = model.tokens_to_mel(tokens)
        torch.cuda.synchronize()
        split["flow_s"] = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(1)
        t0 = time.perf_counter()
        model.s3gen.hift_inference(mel, generator=gen)
        torch.cuda.synchronize()
        split["hift_s"] = time.perf_counter() - t0
        emb = model.t3.prefill_embeds(conds.t3, ids)
        args = (0.8, 1000, 0.95, 1.2, 0)
        profile_one_run(lambda: list(model.t3.decode_chunks(emb, 0, *args)), "T3Turbo's prefill")
        pre = dict(profile_one_run.last)
        steps = TURBO_PROFILE_STEPS
        profile_one_run(lambda: list(model.t3.decode_chunks(emb, steps, *args)),
                        f"T3Turbo's prefill and {steps} steps")
        prof = dict(profile_one_run.last)
        profile_one_run(lambda: model.tokens_to_mel(tokens), "the meanflow flow (two steps)")
        flow = dict(profile_one_run.last)
        profile_one_run(lambda: model.s3gen.hift_inference(mel), f"HiFT on {mel.shape[1]} frames")
        hift = dict(profile_one_run.last)
    per_step = {k: (prof[k] - pre[k]) / steps for k in ("launches", "device_ms", "wall_ms")}
    per_step["idle_share"] = 1 - per_step["device_ms"] / per_step["wall_ms"]
    log(f"[turbo] generate from a {TURBO_REF_S:.0f} s reference (temperature 0.8, top-k 1000, "
        f"top-p 0.95, repetition 1.2; {TURBO_TOKENS} speech tokens and 3 of silence, "
        f"{audio_s:.3f} s of audio): wall {wall:.4f} s, RTF {wall / audio_s:.4f}; apart: "
        f"conditioning {split['conditioning_s']:.4f} s, T3 {split['t3_s']:.4f} s, flow "
        f"{split['flow_s']:.4f} s ({flow['device_ms']:.2f} ms of device time, {flow['launches']} "
        f"launches), HiFT {split['hift_s']:.4f} s ({hift['device_ms']:.2f} ms, "
        f"{hift['launches']} launches); a T3 step: {per_step['launches']:.0f} launches, "
        f"{per_step['device_ms']:.3f} ms of device time in {per_step['wall_ms']:.3f} ms of wall "
        f"(idle {100 * per_step['idle_share']:.1f}%); the port's kernels launched {launches} "
        f"({smi})")
    return {"wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
            "speech_tokens": TURBO_TOKENS, "samples": res[0].samples, "launches": launches,
            "split": split, "step": per_step, "prompt_rows": int(emb.shape[1]),
            "flow": {k: flow[k] for k in ("device_ms", "launches", "wall_ms")},
            "hift": {k: hift[k] for k in ("device_ms", "launches", "wall_ms")}}


def turbo_batched(model, ref) -> dict:
    """TurboBatcher with four requests at temperature 0, each capped at
    TURBO_BATCH_TOKENS, each equal to the decode of the same request alone;
    the speedup; then `generate` through the installed batcher against the
    direct route."""
    from mlx_audio_tpu_torch.serving import get_infer_hook

    n_b = TURBO_BATCH_TOKENS
    greedy = dict(temperature=0.0, top_k=1000, top_p=0.95, repetition_penalty=1.2)
    with torch.inference_mode():
        conds = model.prepare_conditionals(ref, 24000)
        embs = [model.t3.prefill_embeds(conds.t3, model._tokenize_text(t)) for t in TURBO_TEXTS]

        def alone(e, n, seed):
            return np.concatenate([t for t, _ in model.t3.decode_chunks(
                e, n, 0.0, 1000, 0.95, 1.2, seed)])

        alone(embs[0], 4, 0)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [alone(e, n_b, i) for i, e in enumerate(embs)]
        seq_s = time.perf_counter() - t0
    b = model.make_batcher(slots=4, max_len=512, tick_frames=16)
    try:
        b.warmup()
        t0 = time.perf_counter()
        futs = [b.submit(e.float().cpu().numpy(), max_tokens=n_b, seed=i, **greedy)
                for i, e in enumerate(embs)]
        got = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        batch_s = time.perf_counter() - t0
        ticks = b.dispatch_count
        b.install()
        kw = dict(ref_audio=ref, sample_rate=24000, max_tokens=16, seed=3, **greedy)
        served = list(model.generate(TURBO_TEXTS[1], **kw))[0]
        served_ticks = b.dispatch_count - ticks
    finally:
        b.close()
    if get_infer_hook(model) is not None or served_ticks < 1:
        raise SystemExit("chip_smoke: generate did not take the installed TurboBatcher")
    direct = list(model.generate(TURBO_TEXTS[1], **kw))[0]
    rel = held_close("Chatterbox-Turbo's generate through the installed TurboBatcher against "
                     "the direct route", served.audio, direct.audio)
    for w, g in zip(want, got):
        if w.tolist() != np.asarray(g).tolist():
            raise SystemExit(f"chip_smoke: a batched T3Turbo request's tokens {list(g)[:8]}... "
                             f"part from its run alone {w.tolist()[:8]}...")
    log(f"[turbo] TurboBatcher, 4 requests x {n_b} tokens at temperature 0: {batch_s:.3f} s "
        f"batched ({ticks} ticks), {seq_s:.3f} s alone one after another: "
        f"{seq_s / batch_s:.2f}x; tokens identical; generate through the installed batcher "
        f"({served_ticks} ticks) equals the direct route's audio")
    return {"wall_s": batch_s, "sequential_s": seq_s, "speedup": seq_s / batch_s,
            "ticks": ticks, "served_ticks": served_ticks, "served_audio_rel": rel}


def turbo_cut_copy(ref) -> dict:
    """A copy at full width cut in depth (GPT-2 2 layers, the conformer 1 + 1
    blocks, the estimator 1 mid block), card against CPU in float32 on a
    COSY_CPU_REF_S reference with a 1-layer S3TokenizerV2: the
    conditioning, T3's prompt and COSY_CPU_STEPS steps' logits (the card
    replays the CPU's argmax), the meanflow mel (the same noise) and HiFT on
    1 s (the same draws)."""
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import ModelConfig as S3Config
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import S3TokenizerV2
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.nn.module import flatten_params

    t0 = time.perf_counter()
    ref = ref[: int(COSY_CPU_REF_S * 24000)]
    flat = s3flat = noise = draws = None
    rec = {}

    def run(dev):
        nonlocal flat, s3flat, noise, draws
        m = turbo_seeded(dev, 46, cut=True)
        s3 = S3TokenizerV2(config=S3Config(n_audio_layer=1), device=dev,
                           seed=47)
        if flat is None:
            flat, s3flat = flatten_params(m), flatten_params(s3)
        else:
            load_weights(m, flat)
            load_weights(s3, s3flat)
        m.set_runtime(s3_tokenizer=s3)
        out = {}
        with torch.inference_mode():
            conds = m.prepare_conditionals(ref, 24000)
            out["xvector"] = conds.gen["embedding"].cpu()
            out["speaker"] = conds.t3.speaker_emb.cpu()
            out["prompt_tokens"] = conds.gen["prompt_token"].cpu()
            emb = m.t3.prefill_embeds(conds.t3, np.array([[255, 5, 6, 7, 8, 0]]))
            out["prompt"] = emb.cpu()
            rows, taken = [], []
            it = iter(rec["codes"]) if "codes" in rec else None

            def sampler(logits, gen):
                rows.append(logits[0].float().cpu())
                tok = int(logits[0].argmax()) if it is None else next(it)
                taken.append(tok)
                return torch.tensor([tok], device=logits.device)

            list(m.t3.decode_chunks(emb, COSY_CPU_STEPS, 0.8, 1000, 0.95, 1.2, 0,
                                    sampler=sampler))
            out["rows"], rec["codes"] = rows, taken
            tokens = m._filter_speech_tokens(np.array(taken))
            T = 2 * (conds.gen["prompt_token"].shape[1] + tokens.size)
            if noise is None:
                noise = torch.randn(1, T, 80, generator=torch.Generator().manual_seed(5))
            out["mel"] = m.tokens_to_mel(tokens, noise=noise.to(dev)).cpu()
            frames = conds.gen["prompt_feat"][:, :50]
            sg = m.s3gen.mel2wav.m_source.l_sin_gen
            if draws is None:
                draws = sg.draws(1, 50 * m.s3gen.mel2wav.f0_upsample_scale, "cpu",
                                 torch.Generator().manual_seed(6))
            wav, _ = m.s3gen.hift_inference(frames, draws=tuple(d.to(dev) for d in draws))
            out["wav"] = wav.cpu()
        return out

    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    card = run("cuda")
    if not torch.equal(card["prompt_tokens"], cpu["prompt_tokens"]):
        raise SystemExit("chip_smoke: the Turbo cut copy's S3Tokenizer prompt tokens part card "
                         "from CPU")
    for key, label in (("xvector", "CAM++ x-vector"), ("speaker", "voice encoder embedding"),
                       ("prompt", "T3Turbo prompt"), ("mel", "the meanflow mel"),
                       ("wav", "HiFT on 1 s")):
        rec[f"{key}_rel"] = held_close(f"Turbo cut copy, {label}, card against CPU", card[key],
                                       cpu[key])
    worst = max(close_to(a, b)[0] / close_to(a, b)[1] for a, b in zip(card["rows"], cpu["rows"]))
    log(f"[turbo] cut copy (GPT-2 2 layers, S3Tokenizer 1, conformer 1 + 1, estimator 1 mid "
        f"block), {COSY_CPU_STEPS} T3 steps' logits card against CPU: worst {worst:.2e} of the "
        f"peak (bar {CARD_VS_CPU_ATOL:g}); CPU side {cpu_s:.1f} s, all "
        f"{time.perf_counter() - t0:.1f} s")
    if worst > CARD_VS_CPU_ATOL:
        raise SystemExit("chip_smoke: the Turbo cut copy's T3 logits part card from CPU")
    rec.pop("codes")
    rec.update(logits_worst_rel=worst, cpu_s=cpu_s, wall_s=time.perf_counter() - t0)
    return rec


def phase_turbo(smi: str) -> dict:
    """Phase 22 (see the module docstring)."""
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import S3TokenizerV2
    from mlx_audio_tpu_torch.tokenizer_json import load

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def mark(what):
        log(f"[slice22] {time.perf_counter() - t_phase:.1f} s into phase 22 after {what}")

    tmp = Path(tempfile.mkdtemp(prefix="slice22-"))
    rec = {}
    try:
        t0 = time.perf_counter()
        model = turbo_seeded()
        turbo_suppress_stop(model)
        s3tok = S3TokenizerV2(config=s3_config(2), device="cuda", seed=48)
        model.set_runtime(tokenizer=load(write_tokenizer_json(tmp, "whisper")),
                          s3_tokenizer=s3tok)
        parts = {"t3": model.t3, "s3gen": model.s3gen, "ve": model.ve, "s3tokenizer": s3tok}
        n_par = {k: sum(p.numel() for p in m.parameters()) for k, m in parts.items()}
        log(f"[turbo] Chatterbox-Turbo (T3 on GPT-2 medium: 1024 x 24, 16 heads, 50,276 text "
            f"and 6,563 speech rows; S3Gen with the meanflow estimator, two steps; "
            f"VoiceEncoder()), float32, seeded, the stop's row pushed down (the decode runs to "
            f"max_gen_len); S3TokenizerV2 seeded: parameters (M) "
            + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in n_par.items())
            + f" in {time.perf_counter() - t0:.1f} s")
        rec["parameters"] = n_par
        ref = csm_reference(TURBO_REF_S, seed=49)
        rec["generate"] = turbo_generate(model, ref, smi)
        mark("the float32 generate")
        rec["batched"] = turbo_batched(model, ref)
        mark("TurboBatcher")
        del model, s3tok
        gc.collect()
        torch.cuda.empty_cache()
        rec["card_vs_cpu"] = turbo_cut_copy(ref)
        mark("the copy cut in depth")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice22] phase 22 wall {rec['phase_s']:.1f} s")
    return rec


QUANT_SOURCE = "mlx_audio_tpu_torch/csrc/quant_matmul.cu"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(str(p) for p in range(1, 23)),
                    help="comma-separated subset to run (12 runs 10 first for its checkpoint "
                         "directories); a subset prints no result")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}
    if 12 in phases:
        phases.add(10)
    smi = phase_device()
    keep = {}  # the models phases 11 and 12 reuse
    ckpt = tempfile.TemporaryDirectory()  # phase 10's directories, served by phase 12
    try:
        run_phases(phases, smi, keep, Path(ckpt.name))
    finally:
        ckpt.cleanup()


def run_phases(phases, smi, keep, ckpt: Path) -> None:
    clock = [time.perf_counter()]

    def took(phase) -> None:  # each phase's wall, for the 1200 s budget
        now = time.perf_counter()
        log(f"[time] phase {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    if 2 in phases:
        errs, timing = phase_kernels()
        qerrs, qtiming = phase_quant_kernels()
        rerrs, rtiming = phase_relu2_kernel()
        took(2)
    if 3 in phases:
        phase_card_vs_cpu()
        phase_qwen_card_vs_cpu()
        phase_moss_card_vs_cpu()
        took(3)
    if 4 in phases:
        launches, launches_f32 = phase_slice()
        took(4)
    if 5 in phases:
        qlaunches = phase_qwen_slice(keep)
        qwen_bf16 = phase_qwen_bf16(keep)
        took(5)
    if 6 in phases:
        q6_launches = phase_qwen_6bit()
        took(6)
    if 7 in phases:
        r2_launches = phase_moss_slice(keep)
        took(7)
    if 8 in phases:
        kokoro = {"card_vs_cpu_f32": phase_kokoro_card_vs_cpu(keep), "bf16": phase_kokoro(keep)}
        took(8)
    if 9 in phases:
        rest = phase_whisper_rest(keep)
        took(9)
    if 10 in phases:
        loaded = phase_loaded(smi, ckpt)
        took(10)
    if 11 in phases:
        serving = phase_serving(keep)
        took(11)
    if 12 in phases:
        served = phase_http(smi, ckpt, keep)
        took(12)
    if 13 in phases:
        orpheus = phase_orpheus(smi, keep)
        took(13)
    if 14 in phases:
        csm = phase_csm(smi, keep)
        took(14)
    if 15 in phases:
        dia_outetts = phase_dia_outetts(smi)
        took(15)
    if 16 in phases:
        bark = phase_bark(smi)
        took(16)
    if 17 in phases:
        spark_soprano = phase_spark_soprano(smi)
        took(17)
    if 18 in phases:
        indextts = phase_indextts(smi)
        took(18)
    if 19 in phases:
        chatterbox = phase_chatterbox(smi)
        took(19)
    if 20 in phases:
        cosyvoice2 = phase_cosyvoice2(smi)
        took(20)
    if 21 in phases:
        cosyvoice3 = phase_cosyvoice3(smi)
        took(21)
    if 22 in phases:
        turbo = phase_turbo(smi)
        took(22)
    if phases != set(range(1, 23)):
        log(f"[device] {smi}")
        sys.exit(f"chip_smoke: ran phases {sorted(phases)} only; no result")
    record = {"kernels": [{
        "name": name, "route": "cuda",
        "source": "mlx_audio_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mlx_audio_tpu/ops/pallas/flash_attention.py:22",
        "launches": n, "max_abs_err": errs[case], **timing[case],
    } for name, case, n in (("flash_attention", "whisper_bf16", launches),
                            ("flash_attention_f32", "whisper_f32", launches_f32))]}
    # B = 1, one 30 s window: the seek loop's, streaming's and word timing's
    # encoder passes (phase 9 runs them in bf16)
    for entry, case in zip(record["kernels"], ("whisper_b1_bf16", "whisper_b1_f32")):
        entry["b1"] = {"max_abs_err": errs[case], **timing[case]}
    record["kernels"][0]["b1"]["launches"] = {
        "seek_loop_120s": rest["seek_loop"]["flash_launches"],
        "seek_word_timing_30s": 2 * TURBO["n_audio_layer"] * rest["word_timing"]["seek_windows"],
        "streaming_10s": TURBO["n_audio_layer"] * int(REST_STREAM_S)}
    # B = 8: the serving batcher's encode of eight windows (phase 11)
    record["kernels"][0]["server"] = {  # phase 12: one served upload, then HTTP_STREAMS
        "launches": served["whisper"]["flash_launches"],
        "concurrent_launches": served["whisper"]["concurrent_flash_launches"]}
    record["kernels"][0]["serving"] = {
        "launches": serving["whisper"]["flash_launches"][-1],
        "b8": {"max_abs_err": errs["whisper_b8_bf16"], **timing["whisper_b8_bf16"]}}
    # Wav2Vec2 on 30 s (phase 17), float32: one launch a layer, B = 1
    w2v = spark_soprano["spark"]["wav2vec2"]
    record["kernels"][1]["wav2vec2"] = {
        "launches": {"base_ctc_30s": w2v["base_flash_launches"],
                     "xlsr53_30s": w2v["xlsr_flash_launches"]},
        **{key: {"max_abs_err": errs[f"w2v_{key}_f32"], **timing[f"w2v_{key}_f32"]}
           for key in ("base", "xlsr")}}
    for name, replaces, n, err in (
            ("qmm", "mlx_audio_tpu/ops/pallas/quant_matmul.py:64", qlaunches["qmm"],
             qerrs["qkv_m1_f32"]),
            ("qmlp", "mlx_audio_tpu/ops/pallas/quant_matmul.py:72", qlaunches["qmlp"],
             qerrs["mlp_m1_f32"]),
            ("qmm6", "mlx_audio_tpu/ops/pallas/quant_matmul.py:126", q6_launches["qmm6"],
             qerrs["q6_qkv_m1_f32"])):
        record["kernels"].append({"name": name, "route": "cuda", "source": QUANT_SOURCE,
                                  "replaces": replaces, "launches": n, "max_abs_err": err,
                                  **qtiming[name]})
    qmm6 = next(k for k in record["kernels"] if k["name"] == "qmm6")
    qmm6["shapes"] = {  # the talker's four 6-bit shapes, M = 1
        shape: {k: qtiming[key][k] for k in ("ms", "bound_ms", "plain_ms")}
        for shape, key in (("qkv", "qmm6"), ("o_proj", "qmm6_oproj"),
                           ("gate_up", "qmm6_gateup"), ("down", "qmm6_down"))}
    # the M > 4 route, the tensor-core GEMM: its launches per run of phases
    # 5 and 6 and its times at the prefill shapes (bf16 x)
    for name, counts, tag, case in (("qmm", qlaunches, "qmm", "qkv_prefill_bf16"),
                                    ("qmm6", q6_launches, "qmm6", "q6_qkv_prefill_bf16")):
        entry = next(k for k in record["kernels"] if k["name"] == name)
        entry["m_gt_4"] = {
            "kernel": "qmm_mma", "launches": counts["qmm_mma"], "max_abs_err": qerrs[case],
            "shapes": {key[len(tag) + 1:]: {k: qtiming[key][k] for k in (
                "ms", "bound_ms", "bound_by", "plain_ms", "tiled_ms", "yardstick_ms")}
                for key in qtiming if key.startswith(f"{tag}_") and "_m" in key
                and "tiled_ms" in qtiming[key]}}
    # the serving batcher's int4 run (phase 11): launches by kernel, and the
    # tick's M = 8 shapes
    pool = serving["qwen3_int4"]["launches"]
    qmm = next(k for k in record["kernels"] if k["name"] == "qmm")
    qmm["serving"] = {
        "launches": {k: pool[k] for k in ("qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")},
        "max_abs_err": qerrs["qkv_m8_f32"],
        "m8": {key[len("qmm_"):]: qtiming[key] for key in qtiming
               if key.startswith("qmm_") and f"_m{SERVE_M}" in key}}
    # a quantized Whisper's fused self-attention q/k/v (phase 12): one
    # launch a layer a decoder step, N = 3 x 1280
    w4 = served["whisper_int4"]
    qmm["whisper_qkv"] = {
        "launches_per_served_transcription": {k: w4["launches"][k] for k in (
            "qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")},
        "fused_qkv_launches_per_served_transcription": w4["fused_qkv_launches"],
        "unfused_minus_fused_qmm_per_decode": w4["unfused_qmm"] - w4["fused_qmm"],
        "max_abs_err": qerrs["whisper_qkv_m1_bf16"], "m1": qtiming["qmm_whisper_qkv"],
        "m8": {"max_abs_err": qerrs["whisper_qkv_m8_bf16"],
               **qtiming[f"qmm_whisper_qkv_m{SERVE_M}"]}}
    qmm["server"] = {"launches": {k: served["qwen3_int4"]["launches"][k] for k in (
        "qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")}}  # phase 12's 8 requests
    qmlp = next(k for k in record["kernels"] if k["name"] == "qmlp")
    qmlp["server"] = {"launches": served["qwen3_int4"]["launches"]["qmlp"]}
    # Orpheus-3B int4 (phase 13): launches of one greedy generate and of the
    # batched wave, and the kernels' times at its shapes (phase 2, bf16 x)
    qmm["orpheus"] = {
        "launches": {k: orpheus["launches"][k] for k in ("qmm", "qmm_gemv", "qmm_mma",
                                                          "qmm_kernel")},
        "batched_launches": {k: orpheus["batched"]["launches"][k]
                             for k in ("qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")},
        "max_abs_err": qerrs["orpheus_lm_head_m1_bf16"],
        "shapes": {key[len("orpheus_"):]: qtiming[key] for key in qtiming
                   if key.startswith("orpheus_") and "qmlp" not in key}}
    qmlp["orpheus"] = {
        "launches": orpheus["launches"]["qmlp"],
        "batched_launches": orpheus["batched"]["launches"]["qmlp"],
        "max_abs_err": qerrs["orpheus_mlp_m1_bf16"],
        "shapes": {f"m{M}": qtiming[f"orpheus_qmlp_m{M}"] for M in (1, 4)}}
    # CSM-1B int4 (phase 14): the direct loop's launches (a prompt and 16
    # frames) and the kernels' times at its shapes (phase 2, float32 x)
    qmm["csm"] = {
        "launches": {k: csm["int4"]["launches"][k] for k in ("qmm", "qmm_gemv", "qmm_mma",
                                                              "qmm_kernel")},
        "max_abs_err": qerrs["csm_cb0_head_m1_f32"],
        "shapes": {key[len("csm_"):]: qtiming[key] for key in qtiming
                   if key.startswith("csm_") and "mlp" not in key}}
    qmlp["csm"] = {
        "launches": csm["int4"]["launches"]["qmlp"], "max_abs_err": qerrs["csm_mlp_m1_f32"],
        "shapes": {key[len("csm_"):]: qtiming[key] for key in qtiming
                   if key.startswith("csm_") and "mlp" in key}}
    # Llama-OuteTTS-1.0-1B int4 (phase 15): a prompt and 16 greedy tokens; the
    # tied head dequantizes and takes F.linear, no kernel
    o4 = dia_outetts["outetts"]["int4"]
    qmm["outetts"] = {"launches": {k: o4["launches"][k] for k in (
        "qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")}, "head": o4["head"],
        "head_ms": o4["head_ms"], "max_abs_err": qerrs["outetts_qkv_m19_f32"],
        "shapes": {key[len("outetts_"):]: qtiming[key] for key in qtiming
                   if key.startswith("outetts_")},
        "m1_shapes": "the CSM backbone's (csm_qkv_m1, csm_o_proj_m1)"}
    qmlp["outetts"] = {"launches": o4["launches"]["qmlp"], "m1_shape": "csm_mlp_m1"}
    # Bark-small int4 (phase 16): 16 semantic steps, a coarse window and a
    # fine chunk, float32 x; the MLP is not gated, so no qmlp
    b4 = bark["int4"]
    qmm["bark"] = {"launches": {k: b4["launches"][k] for k in (
        "qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")}, "max_abs_err": qerrs["bark_sem_head_m1_f32"],
        "shapes": {key[len("bark_"):]: qtiming[key] for key in qtiming
                   if key.startswith("bark_")}}
    # Spark-TTS-0.5B int4 (phase 17): the control prompt and 16 greedy tokens,
    # float32 x; its MLP takes qmm (I = 4864 fails the fused kernel's guard)
    s4 = spark_soprano["spark"]["int4"]
    qmm["spark"] = {"launches": {k: s4["launches"][k] for k in (
        "qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")}, "head": s4["head"],
        "head_ms": s4["head_ms"], "max_abs_err": qerrs["spark_qkv_m1_f32"],
        "shapes": {key[len("spark_"):]: qtiming[key] for key in qtiming
                   if key.startswith("spark_")}}
    # IndexTTS int4 (phase 18): the conditioning, the 44-row prompt and 16
    # steps at top-k 1, float32 x; the MLP is GELU, so no qmlp
    i4 = indextts["int4"]
    qmm["indextts"] = {"launches": {k: i4["launches"][k] for k in (
        "qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")},
        "max_abs_err": qerrs["indextts_mel_head_m1_f32"],
        "shapes": {key[len("indextts_"):]: qtiming[key] for key in qtiming
                   if key.startswith("indextts_")}}
    # Chatterbox T3 int4 (phase 19): a generate of 16 steps, float32 x; the
    # CFG pair's decode step on the GEMV and the fused MLP, its prompt on
    # the tensor-core GEMM
    c4 = chatterbox["int4"]
    qmm["chatterbox"] = {"launches": {k: c4["launches"][k] for k in (
        "qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")},
        "max_abs_err": qerrs["chatterbox_qkv_m2_f32"],
        "mma_max_abs_err": qerrs["chatterbox_qkv_m114_f32"],
        "shapes": {key[len("chatterbox_"):]: qtiming[key] for key in qtiming
                   if key.startswith("chatterbox_") and "mlp" not in key}}
    qmlp["chatterbox"] = {
        "launches": c4["launches"]["qmlp"], "max_abs_err": qerrs["chatterbox_mlp_m2_f32"],
        "shapes": {key[len("chatterbox_"):]: qtiming[key] for key in qtiming
                   if key.startswith("chatterbox_") and "mlp" in key}}
    qmlp["spark"] = {"launches": s4["launches"]["qmlp"],
                     "routing": "I = 4864 is not a multiple of 1024: the guard sends the MLP "
                                "through qmm"}
    qmlp["serving"] = {"launches": serving["qwen3_int4"]["launches"]["qmlp"],
                       "m8": {"max_abs_err": qerrs["mlp_m8_f32"], **qtiming["qmlp_m8"]}}
    # CosyVoice3's DiT (phase 21): the CFG pair B = 2, 16 heads of 64, at
    # N = 1300 (the long flow call) and 1500; the f32 kernel launched once a
    # block an Euler step, the bf16 one checked and timed at the same shapes
    for entry, dt in zip(record["kernels"][:2], ("bf16", "f32")):
        entry["cosyvoice3"] = {
            "launches": cosyvoice3["long_flow"]["flash_launches"] if dt == "f32" else 0,
            **{f"t{T}": {"max_abs_err": errs[f"cv3_dit{T}_{dt}"], **timing[f"cv3_dit{T}_{dt}"]}
               for T in (1300, 1500)}}
    # CosyVoice2 int4 (phase 20): the LM decode alone (its prompt on the
    # tensor-core GEMM, each step on the GEMV; the MLP takes qmm: I = 4864),
    # and generate_audio's launches with the flow's linears
    c2 = cosyvoice2["int4"]
    qmm["cosyvoice2"] = {
        "launches": {k: c2["launches"][k] for k in ("qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")},
        "generate_launches": {k: c2["generate_launches"][k] for k in (
            "qmm", "qmm_gemv", "qmm_mma", "qmm_kernel")},
        "max_abs_err": qerrs["cv2_llm_decoder_m1_f32"],
        "mma_max_abs_err": qerrs["cv2_qkv_prompt_f32"],
        "shapes": {key[len("cosyvoice2_"):]: qtiming[key] for key in qtiming
                   if key.startswith("cosyvoice2_")}}
    record["kernels"].append({
        "name": "relu2_attention", "route": "cuda",
        "source": "mlx_audio_tpu_torch/csrc/relu2_attention.cu",
        "replaces": "mlx_audio_tpu/ops/pallas/relu2_attention.py:33",
        "launches": r2_launches, "max_abs_err": rerrs["merged20s_f32"],
        **rtiming["merged20s_f32"],
        "bf16": {"max_abs_err": rerrs["merged20s_bf16"],
                 **{f"G{G}": {k: rtiming[case][k] for k in ("ms", "bound_ms", "plain_ms")}
                    for G, case in ((10, "merged20s_bf16"), (2, "merged4s_bf16"))}},
        "serving": {"launches": serving["mossformer2_se"]["relu2_launches"],
                    "b8_g2": {"max_abs_err": rerrs["merged4s_b8_f32"],
                              **rtiming["merged4s_b8_f32"]}}})
    log(f"[device] {smi}")
    print(json.dumps({"kokoro": kokoro}), flush=True)
    print(json.dumps({"qwen3_bf16": qwen_bf16}), flush=True)
    print(json.dumps({"whisper_rest": rest}), flush=True)
    print(json.dumps({"loaded": loaded}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"server": served}), flush=True)
    print(json.dumps({"orpheus": orpheus}), flush=True)
    print(json.dumps({"csm": csm}), flush=True)
    print(json.dumps({"dia_outetts": dia_outetts}), flush=True)
    print(json.dumps({"bark": bark}), flush=True)
    print(json.dumps({"spark_soprano": spark_soprano}), flush=True)
    print(json.dumps({"indextts": indextts}), flush=True)
    print(json.dumps({"chatterbox": chatterbox}), flush=True)
    print(json.dumps({"cosyvoice2": cosyvoice2}), flush=True)
    print(json.dumps({"cosyvoice3": cosyvoice3}), flush=True)
    print(json.dumps({"chatterbox_turbo": turbo}), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
