"""Word-level timestamps for Whisper by cross-attention DTW (counterpart of
`mlx_audio_tpu/stt/models/whisper/timing.py`).

Only the score capture (`forward_with_cross_qk` / `decoder_cross_qk`) runs
on the model's device; the median filter and the DTW run on host numpy,
the same code as the JAX module's, so equal scores give equal timings.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .audio import HOP_LENGTH, SAMPLE_RATE

TOKENS_PER_SECOND = 50  # encoder frames/2 per second

__all__ = ["WordTiming", "find_alignment", "add_word_timestamps",
           "merge_punctuations", "dtw", "median_filter"]


def median_filter(x: np.ndarray, filter_width: int) -> np.ndarray:
    """Median filter along the last axis with reflect padding."""
    pad = filter_width // 2
    if x.shape[-1] <= pad:
        return x
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, filter_width,
                                                       axis=-1)
    return np.median(windows, axis=-1)


def backtrace(trace: np.ndarray):
    i = trace.shape[0] - 1
    j = trace.shape[1] - 1
    trace[0, :] = 2
    trace[:, 0] = 1
    result = []
    while i > 0 or j > 0:
        result.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        elif t == 2:
            j -= 1
        else:
            raise ValueError("Unexpected trace[i, j]")
    result = np.array(result)
    return result[::-1, :].T


def dtw(x: np.ndarray):
    """Monotonic DTW over a cost matrix (-attention)."""
    N, M = x.shape
    cost = np.full((N + 1, M + 1), np.inf)
    trace = np.full((N + 1, M + 1), -1, dtype=np.int32)
    cost[0, 0] = 0
    for j in range(1, M + 1):
        for i in range(1, N + 1):
            c0 = cost[i - 1, j - 1]
            c1 = cost[i - 1, j]
            c2 = cost[i, j - 1]
            if c0 <= c1 and c0 <= c2:
                c, t = c0, 0
            elif c1 <= c0 and c1 <= c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i, j] = x[i - 1, j - 1] + c
            trace[i, j] = t
    return backtrace(trace)


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def find_alignment(model, tokenizer, text_tokens: List[int], mel,
                   num_frames: int, *, medfilt_width: int = 7,
                   qk_scale: float = 1.0, cross_kv=None) -> List[WordTiming]:
    """Align `text_tokens` to encoder frames. `cross_kv` reuses an already
    encoded window (chunked mode) instead of running the encoder on `mel`.

    The token row is not padded to a length bucket, as the JAX package pads
    it for its compile cache: self-attention is causal, so trailing pad
    tokens leave the rows read here unchanged."""
    if len(text_tokens) == 0:
        return []
    token_list = [*tokenizer.sot_sequence, tokenizer.no_timestamps,
                  *text_tokens, tokenizer.eot]
    L = len(token_list)
    tokens = np.asarray(token_list)[None]
    if cross_kv is not None:
        logits, cross_qk = model.decoder_cross_qk(cross_kv, tokens)
    else:
        mel = torch.as_tensor(mel)
        if mel.ndim == 2:
            mel = mel[None]
        logits, cross_qk = model.forward_with_cross_qk(mel, tokens)

    sot_len = len(tokenizer.sot_sequence)
    sampled = logits[0, sot_len:L - 2, : tokenizer.eot].float().cpu().numpy()
    probs = np.exp(sampled - sampled.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    text_token_probs = probs[np.arange(len(text_tokens)), text_tokens]

    # the alignment heads' scores, gathered on the device: one host read
    weights = torch.stack([cross_qk[l][0, h] for l, h in model.alignment_heads])
    weights = weights[:, :L, : num_frames // 2].float().cpu().numpy()
    w = np.exp(weights * qk_scale
               - (weights * qk_scale).max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    mean = w.mean(-2, keepdims=True)
    std = w.std(-2, keepdims=True) + 1e-9
    w = (w - mean) / std
    w = median_filter(w, medfilt_width)
    matrix = w.mean(axis=0)[sot_len:-1]

    text_indices, time_indices = dtw(-matrix)

    words, word_tokens = tokenizer.split_to_word_tokens(
        list(text_tokens) + [tokenizer.eot])
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]),
                             (1, 0))
    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1
                   ).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probs = [float(np.mean(text_token_probs[i:j]))
                  for i, j in zip(word_boundaries[:-1], word_boundaries[1:])]
    return [WordTiming(word, toks, float(s), float(e), p)
            for word, toks, s, e, p in zip(words, word_tokens, start_times,
                                           end_times, word_probs)]


def merge_punctuations(alignment: List[WordTiming], prepended: str,
                       appended: str) -> None:
    """Attach leading punctuation to the following word and trailing
    punctuation to the preceding one, in place."""
    i = len(alignment) - 2
    j = len(alignment) - 1
    while i >= 0:
        prev, foll = alignment[i], alignment[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepended:
            foll.word = prev.word + foll.word
            foll.tokens = prev.tokens + foll.tokens
            prev.word = ""
            prev.tokens = []
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(alignment):
        prev, foll = alignment[i], alignment[j]
        if not prev.word.endswith(" ") and foll.word in appended:
            prev.word = prev.word + foll.word
            prev.tokens = prev.tokens + foll.tokens
            foll.word = ""
            foll.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(*, segments: List[dict], model, tokenizer, mel,
                        num_frames: int,
                        prepend_punctuations: str = "\"'“¿([{-",
                        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
                        last_speech_timestamp: float = 0.0,
                        **kwargs) -> None:
    """Annotate `segments` in place with per-word timings."""
    if len(segments) == 0:
        return
    tokens_per_segment = [[t for t in seg["tokens"] if t < tokenizer.eot]
                          for seg in segments]
    text_tokens = list(itertools.chain.from_iterable(tokens_per_segment))
    alignment = find_alignment(model, tokenizer, text_tokens, mel,
                               num_frames, **kwargs)
    word_durations = np.array([t.end - t.start for t in alignment])
    word_durations = word_durations[word_durations.nonzero()]
    median_duration = (float(np.median(word_durations))
                       if len(word_durations) else 0.0)
    median_duration = min(0.7, median_duration)
    max_duration = median_duration * 2

    if len(word_durations) > 0:
        enders = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in enders:
                    alignment[i].end = alignment[i].start + max_duration
                elif alignment[i - 1].word in enders:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0
    for segment, seg_tokens in zip(segments, tokens_per_segment):
        saved = 0
        words = []
        while word_index < len(alignment) and saved < len(seg_tokens):
            timing = alignment[word_index]
            if timing.word:
                words.append(dict(
                    word=timing.word,
                    start=round(time_offset + timing.start, 2),
                    end=round(time_offset + timing.end, 2),
                    probability=timing.probability))
            saved += len(timing.tokens)
            word_index += 1

        if words:
            if (words[0]["end"] - last_speech_timestamp > median_duration * 4
                    and (words[0]["end"] - words[0]["start"] > max_duration
                         or (len(words) > 1
                             and words[1]["end"] - words[0]["start"]
                             > max_duration * 2))):
                if (len(words) > 1
                        and words[1]["end"] - words[1]["start"] > max_duration):
                    boundary = max(words[1]["end"] / 2,
                                   words[1]["end"] - max_duration)
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0, words[0]["end"] - max_duration)

            if (segment["start"] < words[0]["end"]
                    and segment["start"] - 0.5 > words[0]["start"]):
                words[0]["start"] = max(
                    0, min(words[0]["end"] - median_duration,
                           segment["start"]))
            else:
                segment["start"] = words[0]["start"]

            if (segment["end"] > words[-1]["start"]
                    and segment["end"] + 0.5 < words[-1]["end"]):
                words[-1]["end"] = max(words[-1]["start"] + median_duration,
                                       segment["end"])
            else:
                segment["end"] = words[-1]["end"]

            last_speech_timestamp = segment["end"]

        segment["words"] = words
