"""AlignAtt streaming transcription for Whisper (counterpart of
`mlx_audio_tpu/stt/models/whisper/streaming.py`).

Each chunk re-encodes the accumulated audio, zero-padded to one 30 s
window, and decodes it greedily. A token is emitted while the encoder frame
its cross-attention looks at most (the alignment heads' mean) stays at
least `frame_threshold` frames from the end of the audio heard so far. The
JAX package runs that loop as one `lax.while_loop`; here the steps are
eager and the stop test is the one host read a step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .audio import N_FRAMES, TOKENS_PER_SECOND

__all__ = ["StreamingConfig", "StreamingResult", "StreamingDecoder"]


@dataclass
class StreamingConfig:
    frame_threshold: int = 25
    min_chunk_duration: float = 0.5
    emit_partial: bool = True


@dataclass
class StreamingResult:
    text: str
    tokens: List[int]
    is_final: bool
    start_time: float
    end_time: float
    progress: float = 0.0
    audio_position: float = 0.0
    audio_duration: float = 0.0
    language: Optional[str] = None


@torch.inference_mode()
def _alignatt_decode(model, mel, sot_tokens, suppress_mask, content_frames: int,
                     frame_threshold: int, max_tokens: int, eot: int,
                     heads) -> List[int]:
    """Greedy decode with the AlignAtt stop; returns the emitted tokens.

    mel (1, N_FRAMES, n_mels) and sot_tokens (1, sot_len) on the model's
    device. A step stops on EOT (not emitted) or after emitting a token
    whose most-attended frame lies within `frame_threshold` frames of
    `content_frames`."""
    _xa, cross_kv = model._encode(mel)
    sot_len = sot_tokens.shape[1]
    cap = -(-(sot_len + max_tokens + 1) // 64) * 64
    caches = model._make_caches(1, cap)
    layers = torch.tensor([l for l, _ in heads], device=mel.device)
    head_idx = torch.tensor([h for _, h in heads], device=mel.device)

    logits, caches = model.decoder(sot_tokens, 0, caches, cross_kv)
    logits = logits[:, -1].float()
    out: List[int] = []
    pos = sot_len
    while len(out) < max_tokens:
        tok = logits[0].masked_fill(suppress_mask, float("-inf")).argmax()
        # decode the new token and capture its cross-attention in one pass
        new_logits, caches, qks = model.decoder.step_with_qk(
            tok.view(1, 1), pos, caches, cross_kv)
        w = torch.stack([q[0, :, -1] for q in qks])[layers, head_idx]  # (n_heads, S)
        att_frame = torch.softmax(w.float(), dim=-1).mean(dim=0).argmax()
        tok_i, att_i = torch.stack([tok, att_frame]).tolist()
        if tok_i == eot:
            break
        out.append(tok_i)
        if content_frames - att_i <= frame_threshold:
            break
        logits = new_logits[:, -1].float()
        pos += 1
    return out


class StreamingDecoder:
    """Feeds chunks of log-mel and returns the newly stable tokens of each."""

    def __init__(self, model, config: Optional[StreamingConfig] = None,
                 language: Optional[str] = None, task: str = "transcribe",
                 tokenizer=None):
        self.model = model
        self.config = config or StreamingConfig()
        if tokenizer is None:
            if not hasattr(model, "get_tokenizer"):
                raise ValueError("pass a tokenizer or use a model with "
                                 "get_tokenizer()")
            tokenizer = model.get_tokenizer(language=language or "en",
                                            task=task)
        self.tokenizer = tokenizer
        self._emitted_tokens: List[int] = []
        self._accumulated_mel: Optional[torch.Tensor] = None
        self._sot = list(tokenizer.sot_sequence_including_notimestamps)

        n_vocab = model.dims.n_vocab
        suppress = np.zeros((n_vocab,), bool)
        for t in tokenizer.non_speech_tokens:
            suppress[t] = True
        for t in (tokenizer.sot, tokenizer.sot_prev, tokenizer.no_speech,
                  tokenizer.transcribe, tokenizer.translate):
            suppress[t] = True
        suppress[tokenizer.timestamp_begin:] = True
        self._suppress = torch.from_numpy(suppress).to(model.device)

    def reset(self):
        self._emitted_tokens = []
        self._accumulated_mel = None

    def decode_chunk(self, mel, is_last: bool = False) -> StreamingResult:
        """mel: (frames, n_mels) chunk, numpy or a tensor → newly stable
        tokens."""
        dev = self.model.device
        if not isinstance(mel, torch.Tensor):
            mel = torch.tensor(np.asarray(mel))
        mel = mel.to(dev, torch.float32)
        if self._accumulated_mel is None:
            self._accumulated_mel = mel
        else:
            self._accumulated_mel = torch.cat([self._accumulated_mel, mel], dim=0)
        if self._accumulated_mel.shape[0] > N_FRAMES:
            self._accumulated_mel = self._accumulated_mel[-N_FRAMES:]

        n_acc = self._accumulated_mel.shape[0]
        content_frames = n_acc // 2
        padded = torch.zeros((N_FRAMES, mel.shape[1]), dtype=torch.float32, device=dev)
        padded[:n_acc] = self._accumulated_mel

        threshold = 4 if is_last else self.config.frame_threshold
        tokens = _alignatt_decode(
            self.model, padded[None],
            torch.tensor([self._sot], dtype=torch.long, device=dev), self._suppress,
            content_frames, threshold,
            max_tokens=self.model.dims.n_text_ctx // 2,
            eot=self.tokenizer.eot, heads=tuple(self.model.alignment_heads))
        text_tokens = [t for t in tokens if t < self.tokenizer.eot]

        new_tokens = text_tokens[len(self._emitted_tokens):]
        if len(text_tokens) >= len(self._emitted_tokens):
            self._emitted_tokens = text_tokens
        start = ((len(self._emitted_tokens) - len(new_tokens))
                 / TOKENS_PER_SECOND)
        end = len(self._emitted_tokens) / TOKENS_PER_SECOND
        return StreamingResult(
            text=self.tokenizer.decode(new_tokens), tokens=new_tokens,
            is_final=is_last, start_time=start, end_time=end)
