"""Sesame / CSM-1B: voice-cloning TTS, a Llama backbone over 12.5 Hz frames
and a depth decoder across the 32 Mimi codebooks (counterpart of
`mlx_audio_tpu/tts/models/sesame/sesame.py`, with the same parameter names).

The JAX package runs the whole frame loop (backbone step, codebook 0, the
31-step depth decoder, the EOS test) as one `lax.while_loop` and fetches the
frames once. Here the loop is eager on the host and keeps every frame on the
card: the chunked loop, which resumes across calls for streaming, reads the
all-zero-frame (EOS) flag once a chunk, where the JAX package reads its
chunk; the monolithic loop runs it `POLL_FRAMES` frames at a time. Frames
computed past an EOS inside a chunk are dropped, as the JAX loop never
computes them.

Sampling differs by design: every draw is Gumbel-max with noise from one
`torch.Generator` seeded by the request (the JAX package splits PRNG keys),
so sampled frames match the JAX package's in distribution only; greedy
frames (temperature 0) are its frames. A caller's `sampler(logits,
generator)` overrides both.

The backbone and depth-decoder caches are float32 whatever the weights'
dtype, as in the JAX package: bf16 queries meet them in the wider type
(`ops.attention`). The hosted speaker prompts and the published Mimi and
tokenizer repositories need the hub: the port takes local directories
(`set_runtime`, or files in the checkpoint directory) and raises otherwise.
"""

from __future__ import annotations

import copy
import json
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....device import resolve_device
from ....lm.cache import KVCache
from ....lm.sample import top_k_filter
from ....lm.transformer import LMConfig, Transformer
from ....nn import Embedding, Linear
from ....nn.module import cast_floats, init_weights
from ....serving import get_infer_hook, stream_chunks
from ..base import GenerationResult, format_duration

__all__ = ["Model", "ModelConfig", "SesameModel", "Segment", "DepthDecoderConfig"]

MIMI_REPO = "kyutai/moshiko-pytorch-bf16"
TOKENIZER_REPO = "unsloth/Llama-3.2-1B"

# the frames between two reads of the all-zero-frame flag in `_generate_frames`
POLL_FRAMES = 8

_HUB = ("needs the published {} from the hub; the PyTorch port does not download: pass "
        "ref_audio + ref_text or context segments")


@dataclass
class DepthDecoderConfig(BaseModelArgs):
    backbone_hidden_size: int = 2048
    head_dim: int = 128
    hidden_size: int = 1024
    intermediate_size: int = 8192
    max_position_embeddings: int = 33
    num_attention_heads: int = 8
    num_codebooks: int = 32
    num_hidden_layers: int = 4
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-5
    rope_scaling: Optional[dict] = None
    rope_theta: float = 500000
    vocab_size: int = 2051
    attention_bias: bool = False
    mlp_bias: bool = False


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "sesame"
    text_vocab_size: int = 128256
    audio_vocab_size: int = 2051
    audio_num_codebooks: int = 32
    attention_bias: bool = False
    audio_eos_token_id: int = 0
    codebook_eos_token_id: int = 0
    depth_decoder_config: DepthDecoderConfig = None
    head_dim: int = 64
    hidden_size: int = 2048
    intermediate_size: int = 8192
    max_position_embeddings: int = 2048
    mlp_bias: bool = False
    num_attention_heads: int = 32
    num_hidden_layers: int = 16
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_scaling: Optional[dict] = None
    rope_theta: float = 500000
    vocab_size: int = 128256
    text_tokenizer: Optional[str] = None
    model_path: str = ""

    def __post_init__(self):
        if self.depth_decoder_config is None:
            self.depth_decoder_config = DepthDecoderConfig()
        elif isinstance(self.depth_decoder_config, dict):
            self.depth_decoder_config = DepthDecoderConfig.from_dict(self.depth_decoder_config)
        if self.rope_scaling is None:
            self.rope_scaling = {
                "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192, "rope_type": "llama3",
            }


def _backbone_lm_config(cfg: ModelConfig) -> LMConfig:
    return LMConfig(
        model_type="llama", hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, intermediate_size=cfg.intermediate_size,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps, vocab_size=8, rope_theta=cfg.rope_theta,
        rope_scaling=cfg.rope_scaling, attention_bias=cfg.attention_bias,
        mlp_bias=cfg.mlp_bias)


def _decoder_lm_config(d: DepthDecoderConfig) -> LMConfig:
    return LMConfig(
        model_type="llama", hidden_size=d.hidden_size, num_hidden_layers=d.num_hidden_layers,
        intermediate_size=d.intermediate_size, num_attention_heads=d.num_attention_heads,
        num_key_value_heads=d.num_key_value_heads, head_dim=d.head_dim,
        rms_norm_eps=d.rms_norm_eps, vocab_size=8, rope_theta=d.rope_theta,
        rope_scaling=d.rope_scaling, attention_bias=d.attention_bias, mlp_bias=d.mlp_bias)


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator], temp: float,
            top_k: int, sampler=None) -> torch.Tensor:
    """(B, V) → (B,) ids: a caller's sampler, the argmax at temperature 0,
    else temperature and top-k and one Gumbel-max draw from `generator`."""
    if sampler is not None:
        return sampler(logits, generator).long()
    if temp == 0.0:
        return torch.argmax(logits, dim=-1)
    x = logits.float() / temp
    if top_k:
        x = top_k_filter(x, top_k)
    e = torch.empty_like(x).exponential_(generator=generator)
    return torch.argmax(x - torch.log(e), dim=-1)


class SesameModel(nn.Module):
    def __init__(self, config, device=None):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.args = config
        self.backbone = Transformer(_backbone_lm_config(config), device=device)
        self.decoder = Transformer(_decoder_lm_config(config.depth_decoder_config),
                                   device=device)
        # the embeddings are outside: the backbone and the decoder take
        # hidden states
        del self.backbone.embed_tokens
        del self.decoder.embed_tokens
        backbone_dim = config.hidden_size
        decoder_dim = config.depth_decoder_config.hidden_size
        self.text_embeddings = Embedding(config.text_vocab_size, backbone_dim, device=device)
        self.audio_embeddings = Embedding(config.audio_vocab_size * config.audio_num_codebooks,
                                          backbone_dim, device=device)
        self.projection = Linear(backbone_dim, decoder_dim, bias=False, device=device)
        self.codebook0_head = Linear(backbone_dim, config.audio_vocab_size, bias=False,
                                     device=device)
        # a raw (K - 1, D_dec, V) array, not a Linear, as in the checkpoint
        self.audio_head = nn.Parameter(torch.empty(
            config.audio_num_codebooks - 1, decoder_dim, config.audio_vocab_size,
            device=device))
        self._head_f32 = (None, None)

    def reset_parameters(self, generator=None) -> None:
        self.audio_head.data.zero_()  # the JAX package's constant

    @property
    def device(self) -> torch.device:
        return self.audio_head.device

    def audio_head_f32(self) -> torch.Tensor:
        """`audio_head` in float32, made once per set of weights: the depth
        decoder's logits take float32 products of its operands, as the JAX
        package's preferred_element_type=float32 einsum."""
        w = self.audio_head
        if w.dtype == torch.float32:
            return w
        key = (w.data_ptr(), w._version)
        if self._head_f32[0] != key:
            self._head_f32 = (key, w.detach().float())
        return self._head_f32[1]

    # ---- embeddings ----

    def embed_frames(self, tokens: torch.Tensor, tokens_mask: torch.Tensor) -> torch.Tensor:
        """tokens (B, T, K + 1): K audio columns and the text column; the
        masked sum of their embeddings → (B, T, D). Codebook i reads rows
        i·V .. i·V + V - 1 of the one shared audio table."""
        K = self.args.audio_num_codebooks
        V = self.args.audio_vocab_size
        text = self.text_embeddings(tokens[:, :, -1])[:, :, None, :]
        offsets = (torch.arange(K, device=tokens.device) * V)[None, None, :]
        audio = self.audio_embeddings(tokens[:, :, :K] + offsets)
        embeds = torch.cat([audio, text], dim=2)  # (B, T, K + 1, D)
        return (embeds * tokens_mask[..., None].to(embeds.dtype)).sum(dim=2)

    def make_backbone_caches(self, batch: int, max_len: int) -> List[KVCache]:
        cfg = self.args
        return [KVCache(batch, cfg.num_key_value_heads, max_len, cfg.head_dim,
                        dtype=torch.float32, device=self.device)
                for _ in range(cfg.num_hidden_layers)]

    def _decoder_caches(self, batch: int) -> List[KVCache]:
        d = self.args.depth_decoder_config
        return [KVCache(batch, d.num_key_value_heads, self.args.audio_num_codebooks + 1,
                        d.head_dim, dtype=torch.float32, device=self.device)
                for _ in range(d.num_hidden_layers)]

    # ---- one frame ----

    def sample_frame(self, h_last: torch.Tensor, generator: Optional[torch.Generator],
                     temp: float, top_k: int, sampler=None) -> torch.Tensor:
        """h_last (B, D) → frame (B, K): codebook 0 from `codebook0_head`,
        then the depth decoder's K - 1 steps, codebook i from
        `audio_head[i - 1]`. `sampler(logits, generator)` overrides the
        built-in temperature / top-k sampling."""
        B = h_last.shape[0]
        K = self.args.audio_num_codebooks
        V = self.args.audio_vocab_size
        head = self.audio_head_f32()
        c0 = _sample(self.codebook0_head(h_last), generator, temp, top_k, sampler)
        c0_embed = self.audio_embeddings(c0)  # codebook 0's offset is 0
        dec_caches = self._decoder_caches(B)
        seq = torch.stack([h_last, c0_embed.to(h_last.dtype)], dim=1)  # (B, 2, D)
        h, _ = self.decoder(self.projection(seq), dec_caches)
        codes = [c0]
        for i in range(1, K):
            logits = torch.matmul(h[:, -1].float(), head[i - 1])
            ci = _sample(logits, generator, temp, top_k, sampler)
            codes.append(ci)
            ci_embed = self.audio_embeddings(ci + i * V)
            h, _ = self.decoder(self.projection(ci_embed[:, None].to(h_last.dtype)), dec_caches)
        return torch.stack(codes, dim=1)

    def frame_embedding(self, frame: torch.Tensor) -> torch.Tensor:
        """The backbone's next input for frames (B, K): the audio columns,
        the text column masked out → (B, 1, D)."""
        B, K = frame.shape
        tokens = torch.cat([frame, frame.new_zeros(B, 1)], dim=1)[:, None]
        mask = torch.ones(B, 1, K + 1, dtype=torch.bool, device=frame.device)
        mask[..., -1] = False
        return self.embed_frames(tokens, mask)


@dataclass
class Segment:
    speaker: int
    text: str
    audio: np.ndarray


def _generate_frames_chunk(model: SesameModel, caches, h_last, generator, budget: int,
                           chunk: int, temp: float, top_k: int, sampler=None):
    """Up to min(chunk, budget) frames, resumable: the caches (in place),
    h_last and the generator carry across calls, so streamed frames equal
    a monolithic decode's. → (frames (1, chunk, K), n, h_last, done), read
    once: n frames precede the first all-zero frame (EOS), whose frame and
    those after it are dropped."""
    K = model.args.audio_num_codebooks
    dev = h_last.device
    frames = torch.zeros(1, chunk, K, dtype=torch.long, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n = torch.zeros((), dtype=torch.long, device=dev)
    for i in range(min(chunk, budget)):
        frame = model.sample_frame(h_last, generator, temp, top_k, sampler)
        frames[:, i] = frame
        done = done | (frame == 0).all()
        n = n + (~done).long()
        h, _ = model.backbone(model.frame_embedding(frame), caches)
        h_last = h[:, -1]
    return frames, int(n), h_last, bool(done)


def _generate_frames(model: SesameModel, caches, h_last, generator, max_frames: int,
                     temp: float, top_k: int, sampler=None):
    """The whole frame loop, POLL_FRAMES frames a chunk (one read of the
    EOS flag each) → (frames (1, max_frames, K) on the card, n)."""
    K = model.args.audio_num_codebooks
    frames = torch.zeros(1, max_frames, K, dtype=torch.long, device=h_last.device)
    n = 0
    while n < max_frames:
        chunk, m, h_last, done = _generate_frames_chunk(
            model, caches, h_last, generator, max_frames - n, POLL_FRAMES, temp, top_k, sampler)
        frames[:, n:n + m] = chunk[:, :m]
        n += m
        if done:
            break
    return frames, n


def _prefill(model: SesameModel, caches, tokens, tokens_mask):
    emb = model.embed_frames(tokens, tokens_mask)
    h, _ = model.backbone(emb, caches)
    return h[:, -1]


def _audio_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().reshape(-1)
    return np.asarray(x, np.float32).reshape(-1)


class _TemplateTokenizer:
    """A `tokenizer.json` reader whose encode wraps the text as
    `bos $A eos`, the template the JAX package sets on its tokenizer."""

    def __init__(self, tok, bos: str, eos: str):
        self._tok = tok
        self.bos_token, self.eos_token = bos, eos
        self.bos_token_id = tok.token_to_id(bos)
        self.eos_token_id = tok.token_to_id(eos)
        if self.bos_token_id is None or self.eos_token_id is None:
            raise ValueError(f"{tok.path}: no id for {bos!r} or {eos!r}")

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        return [self.bos_token_id] + ids + [self.eos_token_id] if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)


def _special_name(entry, default: str) -> str:
    if isinstance(entry, dict):
        return entry.get("content", default)
    return entry or default


class Model(nn.Module):
    """CSM on an explicit device (None: the card); weights drawn from `seed`
    and cast to `dtype`."""

    def __init__(self, config: Union[ModelConfig, dict], device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        self.model = SesameModel(config, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)
        if dtype != torch.float32:
            cast_floats(self, dtype)

    # a text tokenizer and a Mimi set by `set_runtime`, shared by every
    # instance, as in the JAX package
    _text_tokenizer = None
    _mimi = None

    @property
    def sample_rate(self) -> int:
        return 24000

    @property
    def text_tokenizer(self):
        """`set_runtime`'s tokenizer, else the `tokenizer.json` of
        `config.text_tokenizer` where that is a local directory, else of the
        checkpoint directory, encoding `bos $A eos` (bos / eos from its
        `tokenizer_config.json`, Llama-3's by default)."""
        if Model._text_tokenizer is not None:
            return Model._text_tokenizer
        from ....tokenizer_json import load

        where = self.config.text_tokenizer
        if not where or not Path(where).is_dir():
            where = self.config.model_path
        path = Path(where or "") / "tokenizer.json"
        if not where or not path.is_file():
            raise RuntimeError(
                f"no text tokenizer: {path} does not exist (the JAX package downloads "
                f"{TOKENIZER_REPO}); load the model from a checkpoint directory that has "
                "one, or call set_runtime(text_tokenizer=...)")
        bos, eos = "<|begin_of_text|>", "<|end_of_text|>"
        tc = path.parent / "tokenizer_config.json"
        if tc.is_file():
            spec = json.loads(tc.read_text())
            bos = _special_name(spec.get("bos_token"), bos)
            eos = _special_name(spec.get("eos_token"), eos)
        return _TemplateTokenizer(copy.copy(load(path)), bos, eos)

    @property
    def audio_tokenizer(self):
        """`set_runtime`'s Mimi, else one read from the checkpoint directory
        (its Mimi safetensors file, or a `mimi/` directory that holds it)."""
        if Model._mimi is None:
            from ....codec.models.mimi.mimi import DEFAULT_FILENAME, Mimi

            root = Path(self.config.model_path or "")
            for where in (root, root / "mimi"):
                if self.config.model_path and (where / DEFAULT_FILENAME).is_file():
                    Model._mimi = Mimi.from_pretrained(str(where), device=self.device)
                    break
            else:
                raise RuntimeError(
                    f"no Mimi codec: {root / DEFAULT_FILENAME} does not exist (the JAX "
                    f"package downloads {MIMI_REPO}); call set_runtime(mimi="
                    "Mimi.from_pretrained(<dir>))")
        return Model._mimi

    def set_runtime(self, text_tokenizer=None, mimi=None):
        if text_tokenizer is not None:
            Model._text_tokenizer = text_tokenizer
        if mimi is not None:
            Model._mimi = mimi

    def model_quant_predicate(self, p, m=None):
        return not p.startswith("_audio_tokenizer")

    def make_batcher(self, **kwargs):
        """Serving batcher: slot-based continuous batching of concurrent
        frame loops, every live request advanced by each tick (see
        batcher.SesameBatcher)."""
        from .batcher import SesameBatcher

        return SesameBatcher(self, **kwargs)

    # ---- tokenization (host) ----

    def _tokenize_text_segment(self, text: str, speaker: int):
        ids = np.asarray(self.text_tokenizer.encode(f"[{speaker}]{text}"))
        K = self.config.audio_num_codebooks
        frame = np.zeros((len(ids), K + 1), np.int64)
        mask = np.zeros((len(ids), K + 1), bool)
        frame[:, -1] = ids
        mask[:, -1] = True
        return frame, mask

    def _tokenize_audio(self, audio: np.ndarray, add_eos: bool = True):
        codes = self.audio_tokenizer.encode(np.asarray(audio, np.float32).reshape(1, 1, -1))
        codes = (codes.cpu().numpy() if isinstance(codes, torch.Tensor)
                 else np.asarray(codes))[0]  # (K, T)
        if add_eos:
            codes = np.concatenate([codes, np.zeros((codes.shape[0], 1), codes.dtype)], axis=1)
        K = self.config.audio_num_codebooks
        frame = np.zeros((codes.shape[1], K + 1), np.int64)
        mask = np.zeros((codes.shape[1], K + 1), bool)
        frame[:, :-1] = codes.T
        mask[:, :-1] = True
        return frame, mask

    def _tokenize_segment(self, segment: Segment, add_eos: bool = True):
        tf, tm = self._tokenize_text_segment(segment.text, segment.speaker)
        af, am = self._tokenize_audio(segment.audio, add_eos=add_eos)
        return np.concatenate([tf, af]), np.concatenate([tm, am])

    # ---- loading ----

    def sanitize(self, weights: dict) -> dict:
        """Upstream names (`attn`, `output_proj`, `w1`-`w3`, `sa_norm`,
        `mlp_norm`, `.scale`) → the JAX package's."""
        out = {}
        for k, v in weights.items():
            if not k.startswith("model."):
                k = "model." + k
            if "attn" in k and "self_attn" not in k:
                k = k.replace("attn", "self_attn").replace("output_proj", "o_proj")
            if "mlp" in k:
                k = k.replace("w1", "gate_proj").replace("w2", "down_proj").replace(
                    "w3", "up_proj")
            k = k.replace("sa_norm", "input_layernorm")
            k = k.replace("mlp_norm", "post_attention_layernorm")
            if k.endswith(".scale"):
                k = k[: -len(".scale")] + ".weight"
            out[k] = v
        return out

    # ---- generation ----

    def default_speaker_prompt(self, voice: str, repo_id: str = "sesame/csm-1b"):
        """The hosted speaker prompt of a named voice: it lives in the
        checkpoint repository on the hub, which the port does not reach."""
        raise ValueError(f"voice {voice!r} " + _HUB.format(f"speaker prompt of {repo_id}"))

    def _result(self, audio, n, segment_idx, elapsed, prompt):
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=segment_idx, token_count=n, audio_duration=format_duration(dur),
            real_time_factor=round(elapsed / dur, 3) if dur else 0.0, prompt=prompt,
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / max(elapsed, 1e-9), 2)},
            processing_time_seconds=elapsed, peak_memory_usage=0.0)

    def _watermarked(self, audio: np.ndarray, watermarker) -> np.ndarray:
        if watermarker is None:
            return audio
        from .watermarking import CSM_1B_GH_WATERMARK, watermark

        return watermark(watermarker, audio, self.sample_rate, CSM_1B_GH_WATERMARK)

    def generate(self, text: Union[str, List[str]], voice: Optional[str] = None,
                 speaker: int = 0, context: Optional[List[Segment]] = None,
                 split_pattern: Optional[str] = r"\n+", max_audio_length_ms: float = 90_000,
                 temperature: float = 0.9, top_k: int = 50, ref_audio=None,
                 ref_text: Optional[str] = None, stream: bool = False,
                 streaming_interval: float = 0.5, sampler=None, voice_match: bool = True,
                 **kwargs):
        """One result a prompt piece (`split_pattern`), or with stream=True
        partial audio every ~streaming_interval seconds of frames, decoded
        through the Mimi streaming decoder. `sampler(logits, generator)`
        overrides temperature / top-k. The output is watermarked unless
        apply_watermark=False. Under an installed `SesameBatcher` (without a
        sampler) the frames come from the batcher."""
        from ....utils import load_audio

        context = list(context or [])
        if ref_audio is not None and isinstance(ref_audio, str):
            ref_audio = load_audio(ref_audio, sample_rate=self.sample_rate)
        if not context and ref_audio is not None and ref_text is not None:
            context = [Segment(speaker=speaker, text=ref_text, audio=ref_audio)]
        if not context and voice is not None:
            context = self.default_speaker_prompt(voice)
        if not context:
            raise ValueError("CSM requires a reference: pass ref_audio+ref_text or context "
                             "segments (the hosted speaker prompts need the hub)")
        seed = kwargs.get("seed", 0)
        apply_watermark = kwargs.get("apply_watermark", True)
        max_frames = int(max_audio_length_ms / 80)
        if isinstance(text, str):
            prompts = re.split(split_pattern, text.strip()) if split_pattern else [text]
        else:
            prompts = list(text)

        for segment_idx, prompt in enumerate(p for p in prompts if p.strip()):
            t0 = time.perf_counter()
            if voice_match:
                gen_text = (context[0].text + " " + prompt).strip()
                cur = [Segment(speaker=speaker, text=gen_text, audio=context[0].audio)]
                toks, masks = zip(*[self._tokenize_segment(s, add_eos=False) for s in cur])
            else:
                parts = [self._tokenize_segment(s) for s in context]
                parts.append(self._tokenize_text_segment(prompt, speaker))
                toks, masks = zip(*parts)
            tokens = np.concatenate(toks)[None]
            tokens_mask = np.concatenate(masks)[None]
            T = tokens.shape[1]
            hook = get_infer_hook(self)
            if hook is not None and sampler is None:
                if stream:
                    yield from self._generate_streaming_batched(
                        hook, tokens, tokens_mask, max_frames, float(temperature), int(top_k),
                        seed, streaming_interval, segment_idx, T, t0, apply_watermark)
                    continue
                codes_nk = hook.submit(tokens, tokens_mask, max_frames=max_frames,
                                       temp=float(temperature), top_k=int(top_k),
                                       seed=seed).result()  # (n, K)
                n = int(codes_nk.shape[0])
                if n == 0:
                    continue
                codes = codes_nk.T[None]
            else:
                dev = self.device
                with torch.inference_mode():
                    caches = self.model.make_backbone_caches(1, T + max_frames + 1)
                    h_last = _prefill(self.model, caches,
                                      torch.as_tensor(tokens, device=dev),
                                      torch.as_tensor(tokens_mask, device=dev))
                generator = torch.Generator(device=dev)
                generator.manual_seed(seed)
                if stream:
                    yield from self._generate_streaming(
                        caches, h_last, generator, max_frames, float(temperature),
                        int(top_k), sampler, streaming_interval, segment_idx, T, t0,
                        apply_watermark)
                    continue
                with torch.inference_mode():
                    frames, n = _generate_frames(self.model, caches, h_last, generator,
                                                 max_frames, float(temperature), int(top_k),
                                                 sampler)
                if n == 0:
                    continue
                codes = frames[0, :n].T[None].cpu().numpy()  # (1, K, n)
            audio = _audio_numpy(self.audio_tokenizer.decode(codes))
            if apply_watermark:
                from .watermarking import load_watermarker

                audio = self._watermarked(audio, load_watermarker())
            elapsed = time.perf_counter() - t0
            yield self._result(audio, n, segment_idx, elapsed,
                               {"tokens": int(T), "tokens-per-sec": round(T / elapsed, 2)})

    def _generate_streaming(self, caches, h_last, generator, max_frames, temp, top_k,
                            sampler, streaming_interval, segment_idx, prompt_tokens, t0,
                            apply_watermark=True):
        """Every ~streaming_interval seconds of frames, decode incrementally
        through the Mimi streaming decoder and yield a partial result. The
        frame loop resumes across chunks, so the streamed frames equal a
        monolithic decode with the same seed."""
        from ....codec.models.mimi.mimi import MimiStreamingDecoder
        from .watermarking import load_watermarker

        interval = max(1, int(streaming_interval * 12.5))
        decoder = MimiStreamingDecoder(self.audio_tokenizer)
        watermarker = load_watermarker() if apply_watermark else None
        produced = 0
        start = t0
        while produced < max_frames:
            with torch.inference_mode():
                frames, n, h_last, done = _generate_frames_chunk(
                    self.model, caches, h_last, generator, max_frames - produced, interval,
                    temp, top_k, sampler)
            produced += n
            if n:
                audio = _audio_numpy(decoder.decode_frames(frames[0, :n].T[None]))
                audio = self._watermarked(audio, watermarker)
                elapsed = time.perf_counter() - start
                yield self._result(audio, n, segment_idx, elapsed,
                                   {"tokens": int(prompt_tokens)})
                start = time.perf_counter()
            if done:
                break

    def _generate_streaming_batched(self, hook, tokens, tokens_mask, max_frames, temp, top_k,
                                    seed, streaming_interval, segment_idx, prompt_tokens, t0,
                                    apply_watermark=True):
        """The streaming tail under an installed SesameBatcher: its frames
        arrive one by one through `on_frame`, regroup into
        ~streaming_interval chunks and decode through the Mimi streaming
        decoder, as `_generate_streaming` decodes."""
        from ....codec.models.mimi.mimi import MimiStreamingDecoder
        from .watermarking import load_watermarker

        interval = max(1, int(streaming_interval * 12.5))
        decoder = MimiStreamingDecoder(self.audio_tokenizer)
        watermarker = load_watermarker() if apply_watermark else None
        start = t0
        for chunk in stream_chunks(hook.submit, tokens, tokens_mask, chunk_size=interval,
                                   callback_kw="on_frame", max_frames=max_frames, temp=temp,
                                   top_k=top_k, seed=seed):
            codes = np.stack(chunk).T[None]  # (1, K, n)
            audio = _audio_numpy(decoder.decode_frames(codes))
            audio = self._watermarked(audio, watermarker)
            elapsed = time.perf_counter() - start
            yield self._result(audio, len(chunk), segment_idx, elapsed,
                               {"tokens": int(prompt_tokens)})
            start = time.perf_counter()
