"""Bark: three nanoGPT stacks and EnCodec (counterpart of
`mlx_audio_tpu/tts/models/bark/bark.py`). Text (WordPiece ids) → a causal
semantic GPT → 10,000 semantic tokens at 49.9 Hz; a causal coarse GPT
writes EnCodec's first two codebooks interleaved, in sliding windows of 60
steps; a non-causal fine GPT infills codebooks 2-7 over 512-frame chunks;
EnCodec 24 kHz decodes the eight.

The JAX package runs the semantic stage and each coarse window as one
`lax.while_loop`. Here they are eager loops over rows (one row, or a
`BarkBatcher`'s fused requests): the semantic loop reads its all-stopped
flag every `POLL_STEPS` steps (the JAX loop's tokens, up to 7 steps past
the stop computed and dropped); a coarse window runs to its step budget
(the JAX window runs all 60 steps with the dead ones masked to -inf and
drops their tokens) and comes to the host once. The caches are float32,
of the JAX package's capacities: 257 + 768 + 1 rows for the semantic
stage, 317 + 61 for a coarse window.

Every table is read through its embedding's own call, whose ids clamp as
the JAX package's gather clamps them: the semantic stage's 768th step reads
position 1024 of the 1024-row position table, as the JAX loop does, and
gets row 1023. A quantized Bark therefore reads its quantized tables, where
the JAX package indexes the packed words (`.weight[...]`) and raises
(ROADMAP Queue 3).

Sampling differs by design: every draw is Gumbel-max with noise from a
`torch.Generator` (the semantic stage seeded by the request's `seed`; each
coarse window and fine chunk by a seed drawn in turn from a host generator
seeded by the stage's seed, 0 for both, as in the JAX package), so sampled
tokens match the JAX package's in distribution only. The stages take a
`noise_fn(index, shape)` that replaces those draws (the tests pass the JAX
package's Gumbel draws through it, and the tokens are then the JAX
package's); `index` is (step,) in the semantic stage, (window, step) in the
coarse stage and (chunk, codebook) in the fine stage. A temperature is
floored at 1e-6, as in the JAX batcher.

The tokenizer is `set_runtime`'s, else the checkpoint's `tokenizer.json`,
else its `vocab.txt` (`tokenizer_json.WordPieceTokenizer`); EnCodec is
`set_runtime`'s, else the checkpoint's `encodec/` directory. The JAX
package downloads both; here a hub id raises.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....device import resolve_device
from ....lm.cache import KVCache
from ....lm.generate import POLL_STEPS
from ....nn import Embedding, LayerNorm, Linear
from ....nn.module import init_weights
from ....ops.attention import make_causal_mask, scaled_dot_product_attention
from ....serving import get_infer_hook
from ..base import GenerationResult, format_duration

__all__ = ["Model", "ModelConfig", "GPTConfig"]

TEXT_ENCODING_OFFSET = 10_048
SEMANTIC_PAD_TOKEN = 10_000
TEXT_PAD_TOKEN = 129_595
SEMANTIC_INFER_TOKEN = 129_599
SEMANTIC_RATE_HZ = 49.9
SEMANTIC_VOCAB_SIZE = 10_000
CODEBOOK_SIZE = 1024
N_COARSE_CODEBOOKS = 2
N_FINE_CODEBOOKS = 8
COARSE_RATE_HZ = 75
COARSE_SEMANTIC_PAD_TOKEN = 12_048
COARSE_INFER_TOKEN = 12_050
SAMPLE_RATE = 24_000

SEMANTIC_MAX_STEPS = 768
WINDOW_LEN = 60
FINE_CHUNK = 512

# noise_fn(index, shape) -> Gumbel noise of `shape` (any device, float32)
NoiseFn = Callable[[Tuple[int, ...], Tuple[int, ...]], torch.Tensor]


@dataclass
class GPTConfig(BaseModelArgs):
    block_size: int = 1024
    input_vocab_size: int = 129600
    output_vocab_size: int = 129600
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    bias: bool = False
    model_type: str = "semantic"
    n_codes_total: int = 8
    n_codes_given: int = 1


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "bark"
    semantic_config: dict = None
    coarse_acoustics_config: dict = None
    fine_acoustics_config: dict = None
    codec_path: str = "mlx-community/encodec-24khz-float32"
    tokenizer_path: str = "bert-base-multilingual-cased"
    sample_rate: int = SAMPLE_RATE
    model_path: str = ""

    def __post_init__(self):
        for name in ("semantic_config", "coarse_acoustics_config", "fine_acoustics_config"):
            v = getattr(self, name)
            if isinstance(v, dict):
                setattr(self, name, GPTConfig.from_dict(v))
            elif v is None:
                setattr(self, name, GPTConfig())


def _additive(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, torch.zeros((), device=ok.device), float("-inf"))


class Attention(nn.Module):
    """Multi-head attention; causality is the caller's mask (the fine stack
    passes none)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.att_proj = Linear(cfg.n_embd, 3 * cfg.n_embd, bias=cfg.bias, device=device)
        self.out_proj = Linear(cfg.n_embd, cfg.n_embd, bias=cfg.bias, device=device)
        self.n_head = cfg.n_head

    def forward(self, x, mask=None, cache: Optional[KVCache] = None):
        B, T, D = x.shape
        hd = D // self.n_head
        q, k, v = (z.reshape(B, T, self.n_head, hd).transpose(1, 2)
                   for z in self.att_proj(x).split(D, dim=-1))
        if cache is not None:
            k, v, _ = cache.update(k, v)
        out = scaled_dot_product_attention(q, k, v, mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.in_proj = Linear(cfg.n_embd, 4 * cfg.n_embd, bias=cfg.bias, device=device)
        self.out_proj = Linear(4 * cfg.n_embd, cfg.n_embd, bias=cfg.bias, device=device)

    def forward(self, x):
        return self.out_proj(F.gelu(self.in_proj(x)))  # the exact (erf) GELU


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.layernorm_1 = LayerNorm(cfg.n_embd, bias=cfg.bias, device=device)
        self.attn = Attention(cfg, device=device)
        self.layernorm_2 = LayerNorm(cfg.n_embd, bias=cfg.bias, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, mask=None, cache=None):
        x = x + self.attn(self.layernorm_1(x), mask, cache)
        return x + self.mlp(self.layernorm_2(x))


class GPT(nn.Module):
    """The causal stack of the semantic and coarse stages."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.input_embeds_layer = Embedding(cfg.input_vocab_size, cfg.n_embd, device=device)
        self.position_embeds_layer = Embedding(cfg.block_size, cfg.n_embd, device=device)
        self.layers = nn.ModuleList(Block(cfg, device=device) for _ in range(cfg.n_layer))
        self.layernorm_final = LayerNorm(cfg.n_embd, bias=False, device=device)
        self.lm_head = Linear(cfg.n_embd, cfg.output_vocab_size, bias=False, device=device)
        self.config = cfg

    def make_caches(self, batch: int, max_len: int) -> List[KVCache]:
        cfg = self.config
        dev = self.lm_head.weight.device
        return [KVCache(batch, cfg.n_head, max_len, cfg.n_embd // cfg.n_head,
                        dtype=torch.float32, device=dev) for _ in range(cfg.n_layer)]

    def forward_embeds(self, tok_emb, caches, positions):
        """Embeddings (B, T, D) at `positions` (T,) → the last position's
        logits (B, 1, V); the caches advance in place."""
        x = tok_emb + self.position_embeds_layer(positions)
        T = x.shape[1]
        if caches is not None:
            mask = caches[0].attention_mask(T)
        else:
            mask = make_causal_mask(T, T, device=x.device) if T > 1 else None
        for i, blk in enumerate(self.layers):
            x = blk(x, mask, caches[i] if caches is not None else None)
        return self.lm_head(self.layernorm_final(x)[:, -1:])


class FineBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.layernorm_1 = LayerNorm(cfg.n_embd, device=device)
        self.attn = Attention(cfg, device=device)
        self.layernorm_2 = LayerNorm(cfg.n_embd, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x):
        x = x + self.attn(self.layernorm_1(x))
        return x + self.mlp(self.layernorm_2(x))


class FineGPT(nn.Module):
    """The non-causal stack of the fine stage: codebook `pred_idx` from the
    sum of the embeddings of codebooks 0..pred_idx."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.input_embeds_layers = nn.ModuleList(
            Embedding(cfg.input_vocab_size, cfg.n_embd, device=device)
            for _ in range(cfg.n_codes_total))
        self.position_embeds_layer = Embedding(cfg.block_size, cfg.n_embd, device=device)
        self.layers = nn.ModuleList(FineBlock(cfg, device=device) for _ in range(cfg.n_layer))
        self.layernorm_final = LayerNorm(cfg.n_embd, device=device)
        self.lm_heads = nn.ModuleList(
            Linear(cfg.n_embd, cfg.output_vocab_size, bias=False, device=device)
            for _ in range(cfg.n_codes_given, cfg.n_codes_total))
        self.config = cfg

    def forward(self, pred_idx: int, idx):
        """idx (B, T, n_codes_total) → logits (B, T, V) of codebook pred_idx."""
        T = idx.shape[1]
        x = sum(self.input_embeds_layers[i](idx[:, :, i]) for i in range(pred_idx + 1))
        x = x + self.position_embeds_layer(torch.arange(T, device=idx.device))
        for blk in self.layers:
            x = blk(x)
        return self.lm_heads[pred_idx - self.config.n_codes_given](self.layernorm_final(x))


# ---------------------------------------------------------------------------
# The stages over rows (one request, or a batcher's fused requests)
# ---------------------------------------------------------------------------


def gumbel_rows(generators: List[torch.Generator], shape, device) -> torch.Tensor:
    """One Gumbel draw of `shape` a row, each from its row's generator →
    (rows, *shape)."""
    return torch.stack([-torch.log(torch.empty(shape, device=device).exponential_(generator=g))
                        for g in generators])


def semantic_prefill(gpt: GPT, ids: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Text ids and semantic history (B, 256) → the merged prefill (B, 257,
    D): their embeddings summed, then the infer token's."""
    emb = gpt.input_embeds_layer
    infer = torch.full((ids.shape[0], 1), SEMANTIC_INFER_TOKEN, device=ids.device)
    return torch.cat([emb(ids) + emb(hist), emb(infer)], dim=1)


def semantic_rows(gpt: GPT, prefill: torch.Tensor, temps: torch.Tensor,
                  draw: Callable[[int], torch.Tensor], max_steps: int = SEMANTIC_MAX_STEPS):
    """The semantic loop of `bark._semantic_loop` / `batcher._semantic_loop_rows`
    over B rows: each step draws one token a row over the 10,000 semantic
    tokens and the stop (`draw(i)` gives the (B, 10001) noise), a row's
    tokens end at its first stop, and every step feeds its tokens back at
    position 257 + i (the 768th reads position 1024, clamped to the table's
    last row as in the JAX loop). The all-stopped flag is read every
    POLL_STEPS steps. → (tokens (B, max_steps), counts (B,)) on the card."""
    B, Tp, _ = prefill.shape
    dev = prefill.device
    caches = gpt.make_caches(B, Tp + max_steps + 1)
    positions = torch.arange(Tp + max_steps, device=dev)
    logits = gpt.forward_embeds(prefill, caches, positions[:Tp])
    out = torch.zeros(B, max_steps, dtype=torch.long, device=dev)
    n = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    temps = temps.clamp(min=1e-6)[:, None]
    for i in range(max_steps):
        last = logits[:, -1]
        lg = torch.cat([last[:, :SEMANTIC_VOCAB_SIZE],
                        last[:, SEMANTIC_PAD_TOKEN:SEMANTIC_PAD_TOKEN + 1]], dim=-1) / temps
        tok = torch.argmax(lg + draw(i).to(lg.device), dim=-1)
        done = done | (tok == SEMANTIC_VOCAB_SIZE)
        out[:, i] = torch.where(done, 0, tok)
        n = n + (~done).long()
        emb = gpt.input_embeds_layer(tok.clamp(0, SEMANTIC_VOCAB_SIZE - 1))[:, None]
        logits = gpt.forward_embeds(emb, caches, positions[Tp + i:Tp + i + 1])
        if (i + 1) % POLL_STEPS == 0 and bool(done.all()):
            break
    return out, n


def coarse_window_rows(gpt: GPT, prefill: torch.Tensor, prefill_len: torch.Tensor,
                       start_steps: torch.Tensor, n_steps: torch.Tensor, temps: torch.Tensor,
                       draw: Callable[[int], torch.Tensor], steps: int,
                       window_len: int = WINDOW_LEN) -> torch.Tensor:
    """One coarse sliding window over B rows (`bark._coarse_window_loop` /
    `batcher._coarse_window_rows`): a prefill of Tp tokens of which each row's
    first prefill_len are real, the pad rows between prefill_len and Tp
    masked out; then `steps` decode steps (at most window_len), codebook 0's
    and 1's 1024 logits in turn by each row's step count, every logit
    masked past a row's step budget (its tokens there are dropped).
    `draw(i)` gives the (B, V) noise. → tokens (B, steps) on the card."""
    B, Tp = prefill.shape
    dev = prefill.device
    S = Tp + window_len + 1
    caches = gpt.make_caches(B, S)
    q_idx = torch.arange(Tp, device=dev)[None, :, None]
    k_idx = torch.arange(S, device=dev)
    pl = prefill_len[:, None, None]
    mask = _additive((k_idx[None, None] <= q_idx) & (k_idx[None, None] < pl))[:, None]
    x = gpt.input_embeds_layer(prefill) + gpt.position_embeds_layer(torch.arange(Tp, device=dev))
    for i, blk in enumerate(gpt.layers):
        x = blk(x, mask, caches[i])
    x = gpt.layernorm_final(x)
    last = (prefill_len - 1).clamp(0, Tp - 1)
    logits = gpt.lm_head(x[torch.arange(B, device=dev), last][:, None])  # (B, 1, V)
    idxs = torch.arange(logits.shape[-1], device=dev)[None]
    temps = temps.clamp(min=1e-6)[:, None]
    out = torch.zeros(B, steps, dtype=torch.long, device=dev)
    for i in range(steps):
        n_step = start_steps + i
        lo = SEMANTIC_VOCAB_SIZE + torch.where(n_step % N_COARSE_CODEBOOKS == 0, 0,
                                               CODEBOOK_SIZE)[:, None]
        valid = (idxs >= lo) & (idxs < lo + CODEBOOK_SIZE) & (n_step < n_steps)[:, None]
        lg = torch.where(valid, logits[:, -1], float("-inf")) / temps
        tok = torch.argmax(lg + draw(i).to(lg.device), dim=-1)
        out[:, i] = tok
        if i == steps - 1:
            break  # the JAX window's last step computes logits it never reads
        dmask = _additive((k_idx[None] < prefill_len[:, None])
                          | ((k_idx[None] >= Tp) & (k_idx[None] <= Tp + i)))[:, None, None]
        x = (gpt.input_embeds_layer(tok)[:, None]
             + gpt.position_embeds_layer(prefill_len + i)[:, None])
        for j, blk in enumerate(gpt.layers):
            x = blk(x, dmask, caches[j])
        logits = gpt.lm_head(gpt.layernorm_final(x))
    return out


def fine_chunk_rows(fine: FineGPT, idx: torch.Tensor, temps: torch.Tensor,
                    draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """Codebooks 2-7 of B chunks idx (B, 512, 8) infilled in turn (in
    place): the argmax at temperature <= 0, else a Gumbel-max draw over the
    first 1024 logits / temperature (`draw(cb)` gives the (B, 512, 1024)
    noise)."""
    sampled_rows = temps > 0
    any_sampled = bool(sampled_rows.any())
    t = temps.clamp(min=1e-6)[:, None, None]
    for cb in range(N_COARSE_CODEBOOKS, N_FINE_CODEBOOKS):
        logits = fine(cb, idx)[..., :CODEBOOK_SIZE]
        pred = torch.argmax(logits, dim=-1)
        if any_sampled:
            drawn = torch.argmax(logits / t + draw(cb).to(logits.device), dim=-1)
            pred = torch.where(sampled_rows[:, None], drawn, pred)
        idx[:, :, cb] = pred
    return idx


def stage_seeds(seed: int):
    """The seeds of a stage's windows or chunks, in turn, from a host
    generator seeded by the stage's seed."""
    g = torch.Generator().manual_seed(int(seed))
    while True:
        yield int(torch.randint(0, 2 ** 62, (1,), generator=g))


def _row_draws(noise_fn: Optional[NoiseFn], index, shape, generator, device):
    """draw(i) for one row: `noise_fn` at (*index, i) where one is given,
    else the row generator's Gumbel draw."""
    if noise_fn is not None:
        return lambda i: noise_fn((*index, i), shape)[None].float()
    return lambda i: gumbel_rows([generator], shape, device)


class Model(nn.Module):
    """Bark on an explicit device (None: the card), weights drawn from
    `seed`, in float32 (the published checkpoints' dtype; the loader casts
    to another)."""

    _tokenizer = None
    _codec = None

    def __init__(self, config, device=None, seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        self.semantic = GPT(config.semantic_config, device=self.device)
        self.coarse_acoustics = GPT(config.coarse_acoustics_config, device=self.device)
        self.fine_acoustics = FineGPT(config.fine_acoustics_config, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def _checkpoint_dir(self) -> Optional[Path]:
        root = getattr(self.config, "model_path", "") or ""
        return Path(root) if root and Path(root).is_dir() else None

    @property
    def tokenizer(self):
        """`set_runtime`'s tokenizer, else the checkpoint's tokenizer.json,
        else its vocab.txt (BertTokenizer's reading of
        `bert-base-multilingual-cased`); a hub id raises."""
        if Model._tokenizer is None:
            from ....tokenizer_json import WordPieceTokenizer, load
            from ....utils import NO_DOWNLOAD

            d = self._checkpoint_dir()
            local = Path(self.config.tokenizer_path).expanduser()
            for where in ([d] if d else []) + ([local] if local.is_dir() else []):
                if (where / "tokenizer.json").exists():
                    Model._tokenizer = load(where / "tokenizer.json")
                    break
                if (where / "vocab.txt").exists():
                    Model._tokenizer = WordPieceTokenizer.from_vocab_txt(where / "vocab.txt")
                    break
            else:
                raise ValueError(NO_DOWNLOAD.format(self.config.tokenizer_path))
        return Model._tokenizer

    @property
    def codec(self):
        """`set_runtime`'s EnCodec, else the checkpoint's `encodec/` directory,
        else `codec_path` where it is a local directory; a hub id raises."""
        if Model._codec is None:
            from ....codec.models import Encodec

            d = self._checkpoint_dir()
            where = d / "encodec" if d is not None and (d / "encodec").is_dir() else None
            Model._codec = Encodec.from_pretrained(str(where or self.config.codec_path),
                                                   device=self.device)
        return Model._codec

    def set_runtime(self, tokenizer=None, codec=None):
        if tokenizer is not None:
            Model._tokenizer = tokenizer
        if codec is not None:
            Model._codec = codec

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)

    # ---- stages ----

    def text_ids(self, text: str) -> np.ndarray:
        """The semantic stage's 256 text ids: WordPiece ids past the
        semantic vocabulary, padded with TEXT_PAD_TOKEN."""
        ids = np.asarray(self.tokenizer.encode(text, add_special_tokens=False),
                         np.int64) + TEXT_ENCODING_OFFSET
        ids = ids[:256]
        return np.pad(ids, (0, 256 - len(ids)), constant_values=TEXT_PAD_TOKEN)

    @torch.inference_mode()
    def generate_text_semantic(self, text: str, voice_prompt: Optional[dict],
                               temperature: float = 0.7, seed: int = 0,
                               noise_fn: Optional[NoiseFn] = None) -> np.ndarray:
        ids = self.text_ids(text)
        if voice_prompt is not None:
            hist = np.asarray(voice_prompt["semantic_prompt"])[-256:]
            hist = np.pad(hist, (0, 256 - len(hist)), constant_values=SEMANTIC_PAD_TOKEN)
        else:
            hist = np.full(256, SEMANTIC_PAD_TOKEN)
        # under a running server a BarkBatcher may be installed: concurrent
        # requests' semantic loops then run as one batched loop
        hook = get_infer_hook(self)
        if hook is not None and noise_fn is None:
            return hook.semantic(ids, hist, temperature, seed)
        gpt = self.semantic
        prefill = semantic_prefill(gpt, self._ids(ids[None]), self._ids(hist[None]))
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        draw = _row_draws(noise_fn, (), (SEMANTIC_VOCAB_SIZE + 1,), gen, self.device)
        out, n = semantic_rows(gpt, prefill, torch.full((1,), float(temperature),
                                                        device=self.device), draw)
        return out[0, :int(n[0])].cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def generate_coarse(self, x_semantic: np.ndarray, voice_prompt: Optional[dict],
                        temperature: float = 0.7, max_coarse_history: int = 60,
                        sliding_window_len: int = 60, seed: int = 0,
                        noise_fn: Optional[NoiseFn] = None) -> np.ndarray:
        ratio = COARSE_RATE_HZ / SEMANTIC_RATE_HZ * N_COARSE_CODEBOOKS
        max_sem_hist = int(math.floor(max_coarse_history / ratio))
        if voice_prompt is not None:
            sem_hist = np.asarray(voice_prompt["semantic_prompt"])
            coarse_hist = np.asarray(voice_prompt["coarse_prompt"])
            coarse_flat = (coarse_hist.T + np.arange(N_COARSE_CODEBOOKS) * CODEBOOK_SIZE
                           ).reshape(-1) + SEMANTIC_VOCAB_SIZE
            n_sem = min(max_sem_hist, len(sem_hist) - len(sem_hist) % 2,
                        int(math.floor(len(coarse_flat) / ratio)))
            n_coarse = int(round(n_sem * ratio))
            sem_hist = sem_hist[-n_sem:]
            coarse_flat = coarse_flat[-n_coarse:][:-2]
        else:
            sem_hist = np.zeros(0, np.int32)
            coarse_flat = np.zeros(0, np.int32)

        n_steps = int(round(math.floor(len(x_semantic) * ratio / N_COARSE_CODEBOOKS)
                            * N_COARSE_CODEBOOKS))
        x_sem = np.concatenate([sem_hist, x_semantic]).astype(np.int32)
        x_coarse = list(coarse_flat.astype(np.int32))
        base_idx = len(sem_hist)
        n_windows = int(round(n_steps / sliding_window_len))
        n_step = 0
        seeds = stage_seeds(seed)
        hook = get_infer_hook(self)
        for w in range(max(n_windows, 1)):
            if n_step >= n_steps:
                break
            sem_idx = base_idx + int(round(n_step / ratio))
            x_in = x_sem[max(0, sem_idx - max_sem_hist):][:256]
            x_in = np.pad(x_in, (0, 256 - len(x_in)), constant_values=COARSE_SEMANTIC_PAD_TOKEN)
            ctx = np.concatenate([x_in, [COARSE_INFER_TOKEN],
                                  np.asarray(x_coarse[-max_coarse_history:], np.int32)]
                                 ).astype(np.int32)
            Tp = 256 + 1 + max_coarse_history
            prefill = np.full(Tp, COARSE_SEMANTIC_PAD_TOKEN, np.int32)
            prefill[: len(ctx)] = ctx
            take = min(sliding_window_len, n_steps - n_step)
            wseed = next(seeds)
            if hook is not None and sliding_window_len == hook.WINDOW_LEN and noise_fn is None:
                # concurrent requests' windows fuse into one batched decode
                out = hook.coarse_window(prefill, len(ctx), n_step, n_steps, wseed, temperature)
            else:
                gen = torch.Generator(device=self.device).manual_seed(wseed)
                draw = _row_draws(noise_fn, (w,), (self.coarse_acoustics.config.output_vocab_size,),
                                  gen, self.device)
                out = coarse_window_rows(
                    self.coarse_acoustics, self._ids(prefill[None]), self._ids([len(ctx)]),
                    self._ids([n_step]), self._ids([n_steps]),
                    torch.full((1,), float(temperature), device=self.device), draw, take,
                    int(sliding_window_len))[0].cpu().numpy()
            x_coarse.extend(out[:take].tolist())
            n_step += take

        gen = np.asarray(x_coarse[len(coarse_flat):])
        n = (len(gen) // N_COARSE_CODEBOOKS) * N_COARSE_CODEBOOKS
        coarse_audio = gen[:n].reshape(-1, N_COARSE_CODEBOOKS).T - SEMANTIC_VOCAB_SIZE
        coarse_audio = coarse_audio - np.arange(N_COARSE_CODEBOOKS)[:, None] * CODEBOOK_SIZE
        return np.clip(coarse_audio, 0, CODEBOOK_SIZE - 1)

    @torch.inference_mode()
    def generate_fine(self, coarse: np.ndarray, voice_prompt: Optional[dict],
                      temperature: float = 0.5, seed: int = 0,
                      noise_fn: Optional[NoiseFn] = None) -> np.ndarray:
        """Non-causal infill of codebooks 2-7 over 512-frame chunks (each
        after the first starts 256 frames on)."""
        T = coarse.shape[1]
        full = np.full((N_FINE_CODEBOOKS, T), CODEBOOK_SIZE, np.int32)
        full[:N_COARSE_CODEBOOKS] = coarse
        chunk = FINE_CHUNK
        seeds = stage_seeds(seed)
        hook = get_infer_hook(self)
        for c, start in enumerate(range(0, T, chunk - 256 if T > chunk else chunk)):
            end = min(start + chunk, T)
            seg = np.pad(full[:, start:end], ((0, 0), (0, chunk - (end - start))),
                         constant_values=CODEBOOK_SIZE)
            cseed = next(seeds)
            if hook is not None and noise_fn is None:
                # concurrent requests' chunks infill as one batched call
                seg_out = hook.fine_chunk(seg.T.astype(np.int32), temperature, cseed).T
            else:
                gen = torch.Generator(device=self.device).manual_seed(cseed)
                draw = _row_draws(noise_fn, (c,), (chunk, CODEBOOK_SIZE), gen, self.device)
                idx = fine_chunk_rows(self.fine_acoustics, self._ids(seg.T[None]),
                                      torch.full((1,), float(temperature), device=self.device),
                                      draw)
                seg_out = idx[0].cpu().numpy().T
            full[:, start:end] = seg_out[:, : end - start]
            if end >= T:
                break
        return np.clip(full, 0, CODEBOOK_SIZE - 1)

    # ---- top level ----

    def make_batcher(self, max_batch: int = 4, window_ms: float = 10.0, **kwargs):
        """Stage-stacked batching over the three stages (batcher.BarkBatcher)."""
        from .batcher import BarkBatcher

        return BarkBatcher(self, max_batch=max_batch, window_ms=window_ms, **kwargs)

    def decode_codes(self, fine: np.ndarray) -> np.ndarray:
        """The eight codebooks (8, T) → EnCodec's samples (T · 320,)."""
        return self.codec.decode(fine[None, None]).float().cpu().numpy().reshape(-1)

    def generate(self, text: str, voice: Optional[str] = None, temperature: float = 0.7,
                 fine_temperature: float = 0.5, split_pattern: str = "\n", **kwargs):
        """One GenerationResult a non-empty segment of `text` split at
        `split_pattern`. `voice`: a speaker prompt `.npz` (semantic_prompt,
        coarse_prompt) or its dict; kwargs: seed (the semantic stage's)."""
        voice_prompt = None
        if voice is not None and isinstance(voice, str) and voice.endswith(".npz"):
            with np.load(voice) as d:
                voice_prompt = {k: d[k] for k in d.files}
        elif isinstance(voice, dict):
            voice_prompt = voice

        for segment_idx, segment in enumerate(s for s in text.split(split_pattern) if s.strip()):
            t0 = time.perf_counter()
            semantic = self.generate_text_semantic(segment, voice_prompt, temperature,
                                                   seed=kwargs.get("seed", 0))
            if len(semantic) == 0:
                continue
            coarse = self.generate_coarse(semantic, voice_prompt, temperature)
            fine = self.generate_fine(coarse, voice_prompt, fine_temperature)
            audio = self.decode_codes(fine)
            elapsed = time.perf_counter() - t0
            dur = len(audio) / self.sample_rate
            yield GenerationResult(
                audio=audio, samples=len(audio), sample_rate=self.sample_rate,
                segment_idx=segment_idx, token_count=int(len(semantic)),
                audio_duration=format_duration(dur),
                real_time_factor=round(elapsed / max(dur, 1e-9), 3),
                prompt={"tokens": int(len(semantic)),
                        "tokens-per-sec": round(len(semantic) / elapsed, 2)},
                audio_samples={"samples": len(audio),
                               "samples-per-sec": round(len(audio) / elapsed, 2)},
                processing_time_seconds=elapsed, peak_memory_usage=0.0)

    def sanitize(self, weights: dict) -> dict:
        out = {}
        for k, v in weights.items():
            k = k.replace("_orig_mod.", "")
            k = k.replace("transformer.wte.", "input_embeds_layer.")
            k = k.replace("transformer.wpe.", "position_embeds_layer.")
            k = k.replace("transformer.h.", "layers.")
            k = k.replace("transformer.ln_f.", "layernorm_final.")
            k = k.replace(".ln_1.", ".layernorm_1.")
            k = k.replace(".ln_2.", ".layernorm_2.")
            k = k.replace(".attn.c_attn.", ".attn.att_proj.")
            k = k.replace(".attn.c_proj.", ".attn.out_proj.")
            k = k.replace(".mlp.c_fc.", ".mlp.in_proj.")
            k = k.replace(".mlp.c_proj.", ".mlp.out_proj.")
            out[k] = v
        return out
