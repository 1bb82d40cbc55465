"""CosyVoice2's speech-token LM on a Qwen2 backbone (counterpart of
`mlx_audio_tpu/tts/models/cosyvoice2/llm.py`).

The JAX package decodes in one `lax.while_loop` over a prompt padded to a
bucket (decode step s at cache row Tp + s, rope position T0 + s, the
padding masked). Here the decode is an eager loop on the card over a
compact float32 cache: the prompt is prefilled unpadded and step s lands at
row T0 + s, so the positions and the tokens are the JAX loop's. The loop
reads its done flag every `POLL_STEPS` steps and the tokens once at its
end; the step cap (`max_len`) and the length floor (`min_len`) come from
the text's length as there, the cap reckoned with the JAX package's prompt
bucket.

`ras_sample` is the JAX package's `nucleus_sample` and `ras_sample` as one
function over rows: top-p with a top-k cap over the sorted probabilities,
then, where the token already fills `win_size · tau_r` of the recent
window, a draw from the whole distribution. Its two draws are Gumbel-max
over a row's generator (`torch.Generator`, seeded by the request), so
sampled tokens match the JAX package's in distribution; `gumbels` passes
draws in (the JAX package's are `jax.random.gumbel` of its two keys).
Every table is read through its embedding's call, so ids past a table
clamp as the JAX gather does."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ....lm.cache import make_caches
from ....lm.generate import POLL_STEPS
from ....lm.transformer import CausalLM, LMConfig
from ....nn import Embedding, Linear
from .config import LLMConfig

__all__ = ["Qwen2LM", "ras_sample", "decode_loop", "step_limits", "WIN_SIZE", "TAU_R", "TOP_P",
           "TOP_K"]

# the JAX package's prefill buckets: only the step cap reads them here
PROMPT_BUCKETS = [64, 128, 256, 512, 1024, 2048]

WIN_SIZE = 10  # the repetition window
TAU_R = 0.1
TOP_P = 0.8
TOP_K = 25


def _bucket(n: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def gumbel_rows(generators: Sequence[Optional[torch.Generator]], V: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's two Gumbel draws of V values from its own generator (one
    launch a row): -log of an exponential draw; zeros for a row with no
    generator (a free slot)."""
    e = torch.ones(len(generators), 2, V, device=device)
    for b, g in enumerate(generators):
        if g is not None:
            e[b].exponential_(generator=g)
    g = -torch.log(e)
    return g[:, 0], g[:, 1]


def ras_sample(logp: torch.Tensor, hist: torch.Tensor,
               generators: Optional[Sequence[torch.Generator]] = None,
               top_p: float = TOP_P, top_k: int = TOP_K, win_size: int = WIN_SIZE,
               tau_r: float = TAU_R, gumbels=None) -> torch.Tensor:
    """Repetition-aware sampling over rows: logp (B, V) float32 log-probs,
    hist (B, W) the recent emitted tokens (-1 padded) → tokens (B,).
    `gumbels` (g1, g2), each (B, V), replaces the generators' draws: g1
    picks within the nucleus (over the sorted order), g2 from the whole
    distribution."""
    B, V = logp.shape
    probs = torch.softmax(logp, dim=-1)
    neg, order = torch.sort(-probs, dim=-1, stable=True)  # the JAX argsort(-probs)
    sp = -neg
    cum = torch.cumsum(sp, dim=-1)
    n = ((cum < top_p).sum(-1) + 1).clamp(max=top_k)
    keep = torch.arange(V, device=logp.device)[None, :] < n[:, None]
    nucleus = torch.where(keep, torch.log(sp.clamp(min=1e-12)), float("-inf"))
    g1, g2 = gumbels if gumbels is not None else gumbel_rows(generators, V, logp.device)
    idx = torch.argmax(nucleus + g1.to(logp.device), dim=-1)
    tok = torch.gather(order, 1, idx[:, None])[:, 0]
    rep = (hist == tok[:, None]).sum(-1)
    resampled = torch.argmax(logp + g2.to(logp.device), dim=-1)
    return torch.where(rep >= win_size * tau_r, resampled, tok)


@torch.inference_mode()
def decode_loop(lm, embeds: torch.Tensor, min_len: int, max_len: int, seed: int,
                v3: bool = False, sampler=None) -> np.ndarray:
    """The speech-token decode over a prompt (1, T0, D) → the emitted tokens
    (n,) on the host. CosyVoice2 (`v3` False) stops on the EOS token V,
    feeds the fill tokens (V + 1, V + 2) without emitting them; CosyVoice3
    stops on any token ≥ V. Below `min_len` steps index V is masked. The
    recent-token window follows emitted tokens only. `sampler(logp (1, V),
    hist (1, W), generator) → (1,)` replaces the draw (the tests and the
    chip check replay tokens through it)."""
    dev = embeds.device
    cfg = lm.llm.config
    eos = lm.speech_token_size
    T0 = embeds.shape[1]
    caches = make_caches(cfg.num_hidden_layers, 1, cfg.num_key_value_heads, T0 + max_len + 1,
                         cfg.head_dim, dtype=torch.float32, device=dev)
    h, _ = lm.llm.hidden_states(embeds, caches)
    logits = lm.llm_decoder(h[:, -1]).float()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hist = torch.full((1, WIN_SIZE), -1, dtype=torch.long, device=dev)
    toks = torch.empty(max_len, dtype=torch.long, device=dev)
    emitted = torch.zeros(max_len, dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    col = torch.arange(logits.shape[-1], device=dev)
    step = 0
    while step < max_len:
        logp = torch.log_softmax(logits, dim=-1)
        if step < min_len:
            logp = torch.where(col == eos, float("-inf"), logp)
        tok = (sampler(logp, hist, gen) if sampler is not None
               else ras_sample(logp, hist, [gen]))
        stop = tok[0] >= eos if v3 else tok[0] == eos
        done = done | stop
        emit = ~done & (tok[0] < eos)
        toks[step] = tok[0]
        emitted[step] = emit
        hist = torch.where(emit, torch.cat([hist[:, 1:], tok[:, None]], dim=1), hist)
        nxt = lm.speech_embedding(tok)[None]
        h, _ = lm.llm.hidden_states(nxt, caches)
        logits = lm.llm_decoder(h[:, -1]).float()
        step += 1
        if step % POLL_STEPS == 0 and step < max_len and bool(done):
            break
    toks, emitted = toks[:step].cpu().numpy(), emitted[:step].cpu().numpy()
    return toks[emitted]


class Qwen2LM(nn.Module):
    """The speech-token LM over a Qwen2 `CausalLM`, on an explicit device
    (None: the card); the family's Model draws the weights."""

    def __init__(self, config: Optional[LLMConfig] = None, device=None):
        super().__init__()
        config = config or LLMConfig()
        self.config = config
        self.speech_token_size = config.speech_token_size
        self.sos_eos = 0
        self.task_id = 1
        self.fill_token = 2
        self.mix_ratio = list(config.mix_ratio)
        self.llm = CausalLM(_lm_config(config), device=device)
        self._build_tables(config, self.llm.device)

    def _build_tables(self, config, dev) -> None:
        self.llm_embedding = Embedding(2, config.llm_input_size, device=dev)
        self.llm_decoder = Linear(config.llm_output_size, config.speech_token_size + 3,
                                  device=dev)
        self.speech_embedding = Embedding(config.speech_token_size + 3, config.llm_input_size,
                                          device=dev)
        self.n_out = config.speech_token_size + 3  # the decoder's rows

    V3 = False  # the stop rule: CosyVoice2 stops on the token V alone

    @property
    def device(self) -> torch.device:
        return self.llm.model.norm.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.llm.model.norm.weight.dtype

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids).reshape(1, -1), dtype=torch.long,
                               device=self.device)

    def _text_and_speech(self, text, prompt_text, prompt_speech_token) -> list:
        """[prompt_text + text] and the prompt speech's embeddings."""
        ids = []
        if prompt_text is not None and np.asarray(prompt_text).size:
            ids.append(np.asarray(prompt_text).reshape(1, -1))
        ids.append(np.asarray(text).reshape(1, -1))
        parts = [self.llm.model.embed_tokens(self._ids(np.concatenate(ids, axis=1)))]
        if prompt_speech_token is not None and np.asarray(prompt_speech_token).size:
            parts.append(self.speech_embedding(self._ids(prompt_speech_token)))
        return parts

    def build_prompt_embeds(self, text, prompt_text=None, prompt_speech_token=None
                            ) -> torch.Tensor:
        """[sos, prompt_text + text, task_id, prompt_speech] → (1, T0, D)."""
        text_part, *speech = self._text_and_speech(text, prompt_text, prompt_speech_token)
        sos = self.llm_embedding(self._ids([self.sos_eos]))
        task = self.llm_embedding(self._ids([self.task_id]))
        return torch.cat([sos, text_part, task] + speech, dim=1)

    def inference(self, text, prompt_text=None, prompt_speech_token=None, sampling: int = 25,
                  max_token_text_ratio: float = 20.0, min_token_text_ratio: float = 2.0,
                  seed: Optional[int] = None, max_kv: int = 4096, sampler=None
                  ) -> Tuple[np.ndarray, int]:
        """The speech tokens (n,) and n."""
        del sampling  # RAS's top-k and top-p are fixed, as in the JAX package
        with torch.inference_mode():
            embeds = self.build_prompt_embeds(text, prompt_text, prompt_speech_token)
        min_len, max_len = step_limits(np.asarray(text).size, embeds.shape[1],
                                       max_token_text_ratio, min_token_text_ratio, max_kv)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        toks = decode_loop(self, embeds, min_len, max_len, seed, v3=self.V3, sampler=sampler)
        return toks.astype(np.int32), int(toks.size)

    def sanitize(self, weights: dict) -> dict:
        """`llm.model.model.*` → `llm.model.*`, `llm.model.lm_head.*` →
        `llm.lm_head.*`."""
        out = {}
        for key, value in weights.items():
            k = key
            if k.startswith("llm.model.model."):
                k = "llm.model." + k[len("llm.model.model."):]
            elif k.startswith("llm.model.lm_head."):
                k = "llm.lm_head." + k[len("llm.model.lm_head."):]
            out[k] = value
        return out


def step_limits(n_text: int, prompt_len: int, max_ratio: float, min_ratio: float,
                max_kv: int = 4096) -> Tuple[int, int]:
    """(min_len, max_len) from the text's length, the cap with the JAX
    package's prompt bucket as it reckons it."""
    min_len = int(n_text * min_ratio)
    max_len = max(1, min(int(n_text * max_ratio), max_kv - _bucket(prompt_len) - 1))
    return min_len, max_len


def _lm_config(config) -> LMConfig:
    return LMConfig(model_type="qwen2", hidden_size=config.hidden_size,
                    num_hidden_layers=config.num_hidden_layers,
                    intermediate_size=config.intermediate_size,
                    num_attention_heads=config.num_attention_heads,
                    num_key_value_heads=config.num_key_value_heads,
                    rms_norm_eps=config.rms_norm_eps, vocab_size=config.vocab_size,
                    rope_theta=config.rope_theta, attention_bias=True,
                    tie_word_embeddings=config.tie_word_embeddings)
