"""T3, Chatterbox's Llama-backed text-to-speech-token model (counterpart of
`mlx_audio_tpu/tts/models/chatterbox/t3.py`).

The JAX package decodes in one `lax.while_loop` over a prompt padded to a
multiple of 32 (decode step s at cache row Tp + s, the padding masked).
Here the decode is an eager loop on the card over a compact cache: the
prompt is prefilled unpadded and step s lands at row T0 + s, so the rope
positions (T0 + s) and the learned speech positions (s + 1) are the JAX
loop's and the tokens are the same. With CFG the pair (cond, uncond) runs
as a batch of two, the uncond row's text embedding zeroed, positions
included, and the logits combine as cond + w·(cond − uncond). The loop
reads its done flag every `POLL_STEPS` steps and the tokens once at its
end; steps past the stop are dropped on the host.

The sampler (`sample_rows`, shared with `T3Batcher`) is the JAX package's
order (repetition penalty, 1/max(temp, 1e-5), min-p on the probabilities,
top-p with its cutoff rule), its draw Gumbel-max from a `torch.Generator`
seeded by the request: sampled tokens match in distribution only, and at
temperature 1e-5 with min-p > 0 (only the argmax survives) they are the
JAX package's. At temperature 0 it takes the argmax, as the JAX
`T3Batcher` does (the JAX decode draws at 1e-5 there). Every table is read
through its embedding's call, so ids past a table clamp as the JAX gather
does."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ....lm.cache import make_caches
from ....lm.generate import POLL_STEPS
from ....lm.sample import apply_repetition_penalty
from ....lm.transformer import LMConfig, Transformer
from ....nn import Embedding, LayerNorm, Linear
from .config import T3Config

__all__ = ["T3", "T3Cond", "T3CondEnc", "Perceiver", "LearnedPositionEmbeddings",
           "sample_rows", "REP_HIST"]

REP_HIST = 64  # the repetition penalty's window of recent tokens


@dataclass
class T3Cond:
    """The conditioning bundle."""

    speaker_emb: torch.Tensor
    cond_prompt_speech_tokens: Optional[torch.Tensor] = None
    cond_prompt_speech_emb: Optional[torch.Tensor] = None
    emotion_adv: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.emotion_adv is None:
            self.emotion_adv = torch.full((1, 1, 1), 0.5, device=self.speaker_emb.device)


class LearnedPositionEmbeddings(nn.Module):
    def __init__(self, seq_len: int, model_dim: int, device=None):
        super().__init__()
        self.emb = Embedding(seq_len, model_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The first x.shape[1] rows."""
        return self.emb.weight[: x.shape[1]]

    def get_fixed_embedding(self, idx) -> torch.Tensor:
        """Row idx (clamped into the table) as (1, 1, D)."""
        return self.emb(torch.as_tensor(idx, device=self.emb.weight.device))[None, None]


class AttentionBlock(nn.Module):
    """Cross attention with one LayerNorm shared by queries and keys."""

    def __init__(self, channels: int, num_heads: int = 4, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = LayerNorm(channels, device=device)
        self.to_q = Linear(channels, channels, device=device)
        self.to_k = Linear(channels, channels, device=device)
        self.to_v = Linear(channels, channels, device=device)
        self.proj_out = Linear(channels, channels, device=device)

    def forward(self, x1, x2):
        B, T1, C = x1.shape
        hd = C // self.num_heads
        q = self.to_q(self.norm(x1)).reshape(B, T1, self.num_heads, hd).transpose(1, 2)
        kv = self.norm(x2)
        k = self.to_k(kv).reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        v = self.to_v(kv).reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-1, -2) * hd ** -0.5).float(), dim=-1)
        h = (attn.to(x1.dtype) @ v).transpose(1, 2).reshape(B, T1, C)
        return x1 + self.proj_out(h)


class Perceiver(nn.Module):
    """A fixed-length resampler: 32 learned queries, one attention block
    used twice."""

    def __init__(self, pre_attention_query_token: int = 32, pre_attention_query_size: int = 1024,
                 embedding_dim: int = 1024, num_attn_heads: int = 4, device=None):
        super().__init__()
        self.pre_attention_query = nn.Parameter(torch.empty(
            1, pre_attention_query_token, pre_attention_query_size, device=device))
        self.attn = AttentionBlock(embedding_dim, num_attn_heads, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.pre_attention_query.data.zero_()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        query = self.pre_attention_query.expand(h.shape[0], -1, -1).to(h.dtype)
        pre = self.attn(query, h)
        return self.attn(pre, pre)


class T3CondEnc(nn.Module):
    """Speaker, prompt-speech and emotion conditioning → (B, Lc, D)."""

    def __init__(self, hp: T3Config, device=None):
        super().__init__()
        self.hp = hp
        self.spkr_enc = Linear(hp.speaker_embed_size, hp.n_channels, device=device)
        if hp.emotion_adv:
            self.emotion_adv_fc = Linear(1, hp.n_channels, bias=False, device=device)
        if hp.use_perceiver_resampler:
            self.perceiver = Perceiver(pre_attention_query_size=hp.n_channels,
                                       embedding_dim=hp.n_channels, device=device)

    def forward(self, cond: T3Cond) -> torch.Tensor:
        B = cond.speaker_emb.shape[0]
        parts = [self.spkr_enc(cond.speaker_emb.reshape(B, self.hp.speaker_embed_size))[:, None]]
        emb = cond.cond_prompt_speech_emb
        if emb is not None:
            if self.hp.use_perceiver_resampler:
                emb = self.perceiver(emb)
            parts.append(emb)
        if self.hp.emotion_adv:
            ea = torch.as_tensor(cond.emotion_adv, dtype=torch.float32,
                                 device=cond.speaker_emb.device).reshape(-1, 1, 1)
            parts.append(self.emotion_adv_fc(ea))
        return torch.cat(parts, dim=1)


def sample_rows(logits: torch.Tensor, generators: List[Optional[torch.Generator]], hist,
                temps, top_ps, min_ps, rep_pens) -> torch.Tensor:
    """T3's sampler, row by row, over (B, V) logits → (B,): every parameter
    a (B,) tensor, `hist` (B, W) the recent tokens, -1 padded; `rep_pens`
    may be one float, and `top_ps` None where no row filters by top-p (the
    sort is then skipped). The JAX package's order: the repetition
    penalty, 1/max(temp, 1e-5), min-p on the probabilities, top-p keeping
    the tokens at least as likely as the nucleus's smallest, then a
    Gumbel-max draw from the row's generator. A row at temperature 0, or
    with no generator, takes the argmax of the penalised logits
    (`T3Batcher`'s rule)."""
    V = logits.shape[-1]
    z = apply_repetition_penalty(logits.float(), hist, rep_pens)
    greedy = torch.argmax(z, dim=-1)
    rows = [b for b, g in enumerate(generators) if g is not None]
    if not rows:
        return greedy
    x = z / temps.float().clamp(min=1e-5)[:, None]
    probs = torch.softmax(x, dim=-1)
    cut_minp = min_ps[:, None] * probs.amax(-1, keepdim=True)
    x = torch.where((min_ps[:, None] > 0.0) & (probs < cut_minp), float("-inf"), x)
    if top_ps is not None:
        sort = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(sort, dim=-1)
        cutoff_idx = (cum < top_ps[:, None]).sum(-1, keepdim=True).clamp(max=V - 1)
        cutoff = torch.gather(sort, -1, cutoff_idx)
        x = torch.where((top_ps[:, None] < 1.0) & (probs < cutoff), float("-inf"), x)
    e = torch.ones_like(x)
    for b in rows:
        e[b:b + 1].exponential_(generator=generators[b])
    sampled = torch.argmax(x - torch.log(e), dim=-1)
    return torch.where(temps == 0, greedy, sampled)


class T3(nn.Module):
    """T3 on an explicit device (None: the card); the caller fills the
    weights (the family's Model draws them from its seed)."""

    def __init__(self, hp: Optional[T3Config] = None, device=None):
        super().__init__()
        hp = hp or T3Config.english_only()
        self.hp = hp
        self.cfg = LMConfig(**{k: v for k, v in hp.llama_config.items()
                               if k in LMConfig.__dataclass_fields__})
        self.tfmr = Transformer(self.cfg, device=device)
        self.dim = self.cfg.hidden_size
        self.cond_enc = T3CondEnc(hp, device=device)
        self.text_emb = Embedding(hp.text_tokens_dict_size, self.dim, device=device)
        self.speech_emb = Embedding(hp.speech_tokens_dict_size, self.dim, device=device)
        if hp.input_pos_emb == "learned":
            self.text_pos_emb = LearnedPositionEmbeddings(hp.max_text_tokens + 2, self.dim,
                                                          device=device)
            self.speech_pos_emb = LearnedPositionEmbeddings(hp.max_speech_tokens + 4, self.dim,
                                                            device=device)
        self.text_head = Linear(self.dim, hp.text_tokens_dict_size, bias=False, device=device)
        self.speech_head = Linear(self.dim, hp.speech_tokens_dict_size, bias=False,
                                  device=device)

    @property
    def device(self) -> torch.device:
        return self.speech_head.weight.device

    def prepare_conditioning(self, t3_cond: T3Cond) -> torch.Tensor:
        if (t3_cond.cond_prompt_speech_tokens is not None
                and t3_cond.cond_prompt_speech_emb is None):
            toks = torch.as_tensor(t3_cond.cond_prompt_speech_tokens, device=self.device)
            t3_cond.cond_prompt_speech_emb = self.speech_emb(toks) + self.speech_pos_emb(toks)
        return self.cond_enc(t3_cond)

    def build_prefill_embeds(self, t3_cond: T3Cond, text_tokens,
                             cfg_on: bool = True) -> torch.Tensor:
        """The [cond | text | bos] prompt (B, T0, D); with CFG the uncond
        row's text embedding is zero, positions included. Shared by
        `inference` and the serving batcher."""
        text_tokens = np.asarray(text_tokens.cpu() if isinstance(text_tokens, torch.Tensor)
                                 else text_tokens)
        if text_tokens.ndim == 1:
            text_tokens = text_tokens[None]
        cond_emb = self.prepare_conditioning(t3_cond)  # (1, Lc, D)
        text_ids = torch.as_tensor(text_tokens[:1], dtype=torch.long, device=self.device)
        text_emb = self.text_emb(text_ids)
        if self.hp.input_pos_emb == "learned":
            text_emb = text_emb + self.text_pos_emb(text_ids)[None]
        bos = torch.tensor([[self.hp.start_speech_token]], device=self.device)
        bos_emb = self.speech_emb(bos) + self.speech_pos_emb.get_fixed_embedding(0)
        if cfg_on:
            text_emb = torch.cat([text_emb, torch.zeros_like(text_emb)], dim=0)
            cond_emb = cond_emb.expand(2, -1, -1)
            bos_emb = bos_emb.expand(2, -1, -1)
        return torch.cat([cond_emb, text_emb.to(cond_emb.dtype), bos_emb.to(cond_emb.dtype)],
                         dim=1)

    def cfg_logits(self, h_last: torch.Tensor, cfg_weight: float, cfg_on: bool) -> torch.Tensor:
        """The speech head over the last hidden state(s) → (1, V) float32,
        the pair combined under CFG."""
        logits = self.speech_head(h_last).float()
        if cfg_on:
            return logits[0:1] + cfg_weight * (logits[0:1] - logits[1:2])
        return logits[0:1]

    def step_embedding(self, tok: torch.Tensor, step) -> torch.Tensor:
        """A decode step's input (1, D): token tok at learned speech position
        step + 1 (the bos took position 0)."""
        pos = torch.as_tensor(step, device=tok.device).reshape(1) + 1
        return self.speech_emb(tok.reshape(1)) + self.speech_pos_emb.emb(pos)

    @torch.inference_mode()
    def decode(self, embeds: torch.Tensor, max_new_tokens: int, temperature: float,
               top_p: float, min_p: float, repetition_penalty: float, cfg_weight: float,
               seed: int, sampler=None) -> np.ndarray:
        """The CFG decode over a prompt (B, T0, D), B = 2 under CFG → the
        speech tokens before the stop (n,) on the host. `sampler(logits (1,
        V), generator) → (1,)` replaces the draw after the repetition
        penalty (the tests and the chip check replay tokens through it)."""
        cfg_on = embeds.shape[0] == 2
        dev = embeds.device
        stop = self.hp.stop_speech_token
        T0 = embeds.shape[1]
        caches = make_caches(self.cfg.num_hidden_layers, embeds.shape[0],
                             self.cfg.num_key_value_heads, T0 + max_new_tokens + 1,
                             self.cfg.head_dim, dtype=torch.float32, device=dev)
        hidden, _ = self.tfmr(embeds, caches)
        h_last = hidden[:, -1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        temps, top_ps, min_ps = (torch.tensor([p], dtype=torch.float32, device=dev)
                                 for p in (temperature, top_p, min_p))
        top_ps = top_ps if top_p < 1.0 else None
        hist = torch.full((1, REP_HIST), -1, dtype=torch.long, device=dev)
        out = torch.empty(max_new_tokens, dtype=torch.long, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        done_at = torch.full((), max_new_tokens, dtype=torch.long, device=dev)
        i = 0
        while i < max_new_tokens:
            logits = self.cfg_logits(h_last, cfg_weight, cfg_on)
            if sampler is not None:
                tok = sampler(apply_repetition_penalty(logits, hist, repetition_penalty), gen)
            else:
                tok = sample_rows(logits, [gen], hist, temps, top_ps, min_ps,
                                  repetition_penalty)
            out[i] = tok[0]
            newly = (tok[0] == stop) & ~done
            done_at = torch.where(newly, i, done_at)
            done = done | newly
            hist = torch.cat([hist[:, 1:], tok.reshape(1, 1)], dim=1)
            emb = self.step_embedding(tok, i)[None].expand(embeds.shape[0], -1, -1)
            hidden, _ = self.tfmr(emb.to(embeds.dtype), caches)
            h_last = hidden[:, -1]
            i += 1
            if i % POLL_STEPS == 0 and i < max_new_tokens and bool(done):
                break
        n = int(done_at) if bool(done) else max_new_tokens
        return out[:n].cpu().numpy()

    def inference(self, t3_cond: T3Cond, text_tokens: np.ndarray, max_new_tokens: int = 1024,
                  temperature: float = 0.8, top_p: float = 0.95, min_p: float = 0.05,
                  repetition_penalty: float = 1.2, cfg_weight: float = 0.5,
                  seed: Optional[int] = None) -> np.ndarray:
        """Speech tokens (1, n) ending before the stop."""
        cfg_on = cfg_weight > 0.0
        with torch.inference_mode():
            embeds = self.build_prefill_embeds(t3_cond, text_tokens, cfg_on)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        toks = self.decode(embeds, min(max_new_tokens, self.hp.max_speech_tokens),
                           float(temperature), float(top_p), float(min_p),
                           float(repetition_penalty), float(cfg_weight), seed)
        return toks[None]

    def sanitize(self, weights: dict) -> dict:
        """`tfmr.model.` → `tfmr.`; the unused `embed_tokens` dropped (the
        inputs are T3's own embeddings)."""
        out = {}
        for key, value in weights.items():
            k = key.replace("tfmr.model.", "tfmr.")
            if not k.startswith("tfmr.embed_tokens."):
                out[k] = value
        return out
