"""Qwen3-TTS for PyTorch/CUDA (counterpart of
`mlx_audio_tpu/tts/models/qwen3_tts/qwen3_tts.py`): a talker LLM over
12.5 Hz codec frames, a per-frame code predictor across the 16 codebooks,
and the RVQ codec decoder.

The JAX package runs the nested AR loop as one `lax.while_loop`; here it is
an eager Python loop over frames. Each frame is one talker step, 16 code
predictor calls (the two-token seed, then 15 steps, the last computed and
unused, as in JAX) and 16 samples. The loop reads no value back from the
card, except once a frame to see whether EOS was drawn, and not at all
while `min_tokens` keeps EOS out.

Ported: `generate` with the base, custom_voice and voice_design routes,
streaming and not, alone or through an installed serving batcher
(`make_batcher`, `batcher.py`); x-vector voice cloning on Base checkpoints
(`ref_audio` without `ref_text`: the ECAPA-TDNN speaker encoder of
`speaker_encoder.py` over `mel_spectrogram`); and ICL voice cloning
(`ref_audio` + `ref_text`): the reference codes from the speech tokenizer's
Mimi-based encoder go into the prefill, with the stronger repetition
penalty. The JAX package always builds that encoder; the port builds it
where a checkpoint carries its weights (`sanitize`) or a caller asks
(`speech_tokenizer.build_encoder()`), and ICL without it raises.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ....device import resolve_device
from ....dsp import hanning, mel_filters, stft
from ....lm.sample import apply_repetition_penalty, top_k_filter, top_p_filter
from ....nn.module import cast_floats, init_weights
from ....nn.sanitize import orient_weights_to_model
from ....serving import get_infer_hook, stream_chunks
from ..base import GenerationResult, format_duration
from .config import ModelConfig
from .speaker_encoder import Qwen3TTSSpeakerEncoder
from .speech_tokenizer import Qwen3TTSSpeechTokenizer
from .talker import Qwen3TTSTalkerForConditionalGeneration

__all__ = ["Model", "ModelConfig", "checkpoint_quant_predicate", "mel_spectrogram"]

# the JAX parameter prefix of the speech-tokenizer encoder, which the port
# builds only where a checkpoint carries it or a caller asks
NOT_BUILT = ("speech_tokenizer.encoder.",)

_ICL_NEEDS_ENCODER = (
    "ICL voice cloning (ref_audio + ref_text) needs the speech tokenizer's encoder: load a "
    "checkpoint that carries its weights (speech_tokenizer.encoder.*), or call "
    "model.speech_tokenizer.build_encoder() and load them")


def mel_spectrogram(audio, n_fft: int = 1024, num_mels: int = 128, sample_rate: int = 24000,
                    hop_size: int = 256, win_size: int = 1024, fmin: float = 0.0,
                    fmax: float = 12000.0, device=None) -> torch.Tensor:
    """The speaker encoder's BigVGAN-style log mel → (1, T, num_mels) float32:
    reflect padding of (n_fft - hop)/2 a side, an uncentred STFT under a
    symmetric Hann window, magnitudes through slaney mel filters, the log of
    values clipped at 1e-5."""
    x = torch.as_tensor(np.asarray(audio, np.float32).reshape(-1), device=device)
    pad = (n_fft - hop_size) // 2
    x = torch.nn.functional.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    spec = stft(x, n_fft=n_fft, hop_length=hop_size, win_length=win_size,
                window=hanning(win_size, device=x.device), center=False)
    mag = torch.sqrt(spec.abs() ** 2 + 1e-9)
    fb = mel_filters(sample_rate, n_fft, num_mels, f_min=fmin, f_max=fmax, norm="slaney",
                     mel_scale="slaney", device=x.device)
    mel = torch.matmul(mag, fb.T)
    return torch.log(mel.clamp(min=1e-5))[None]


def checkpoint_quant_predicate(key: str, w=None) -> bool:
    """`convert.quantize_weights`' predicate for Qwen3-TTS: a `.weight` key
    is quantized iff the loader quantizes its layer
    (`Model.model_quant_predicate`), so the checkpoint's `.scales` are
    exactly where the loader looks for them."""
    return key.endswith(".weight") and Model.model_quant_predicate(key[: -len(".weight")])


def _sample(logits: torch.Tensor, generator: torch.Generator, temp: float,
            top_k: int, top_p: float) -> torch.Tensor:
    """(B, V) → (B,) token ids. temp <= 0 is the argmax; otherwise
    Gumbel-max over the filtered logits, with noise from `generator` on the
    logits' device (no host sync; not the bits of jax.random.categorical)."""
    if temp <= 0:
        return torch.argmax(logits, dim=-1)
    x = logits.float() / temp
    if top_k > 0:
        x = top_k_filter(x, top_k)
    if top_p < 1.0:
        x = top_p_filter(x, top_p)
    e = torch.empty_like(x).exponential_(generator=generator)
    return torch.argmax(x - torch.log(e), dim=-1)


def _bucket(n: int, step: int = 32) -> int:
    return ((n + step - 1) // step) * step


def _additive(ok: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), device=ok.device)
    return torch.where(ok, zero, float("-inf"))


class Model(nn.Module):
    """Qwen3-TTS on an explicit device: `Model(config)` builds on the card
    and raises when there is none; tests pass `device="cpu"`. Weights are
    drawn from `seed` and cast to `dtype`."""

    def __init__(self, config: Union[ModelConfig, dict], device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        self.talker = Qwen3TTSTalkerForConditionalGeneration(config.talker_config,
                                                             device=self.device)
        self.speech_tokenizer = Qwen3TTSSpeechTokenizer(config.tokenizer_config,
                                                        device=self.device)
        # Base checkpoints carry the x-vector encoder; the other types do not
        self.speaker_encoder = (
            Qwen3TTSSpeakerEncoder(config.speaker_encoder_config, device=self.device)
            if config.speaker_encoder_config is not None else None)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)
        if dtype != torch.float32:
            cast_floats(self, dtype)
        self._heads = (None, None)

    # ---- runtime ----

    # a text tokenizer set by `set_runtime`, shared by every instance as in
    # the JAX package, so that one set before a loader call reaches the model
    # it loads; without one, each model reads its checkpoint's tokenizer.json
    _tokenizer = None

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def tokenizer(self):
        """`set_runtime`'s tokenizer, else the reader of the checkpoint's
        `tokenizer.json` (where the JAX package builds `AutoTokenizer`)."""
        if Model._tokenizer is not None:
            return Model._tokenizer
        from ....tokenizer_json import load

        where = getattr(self.config, "model_path", None)
        path = Path(where or "") / "tokenizer.json"
        if not where or not path.is_file():
            raise RuntimeError(
                f"no text tokenizer: {path} does not exist; load the model from a "
                "checkpoint directory that has one, or call set_runtime(tokenizer=...)")
        return load(path)

    def set_runtime(self, tokenizer=None):
        if tokenizer is not None:
            Model._tokenizer = tokenizer

    @property
    def supported_speakers(self) -> List[str]:
        return sorted((self.config.talker_config.spk_id or {}).keys())

    # speaker and language discovery, as in the JAX package

    def load_generate_config(self, generate_config: dict) -> None:
        self.config.generate_config = generate_config

    @property
    def generate_config(self) -> Optional[dict]:
        return getattr(self.config, "generate_config", None)

    @property
    def supported_languages(self) -> List[str]:
        langs = ["auto"]
        for lang_id in (self.config.talker_config.codec_language_id or {}):
            if "dialect" not in lang_id:
                langs.append(lang_id)
        return langs

    def get_supported_speakers(self) -> List[str]:
        return self.supported_speakers

    def get_supported_languages(self) -> List[str]:
        return self.supported_languages

    # ---- loading (utils.base_load_model) ----

    @property
    def NOT_BUILT(self):
        """Checkpoint prefixes the loader drops: the speech-tokenizer encoder
        where none is built, and the speaker encoder where the config builds
        none."""
        enc = () if hasattr(self.speech_tokenizer, "encoder") else NOT_BUILT
        return enc + (("speaker_encoder.",) if self.speaker_encoder is None else ())

    @classmethod
    def post_load_hook(cls, model, model_path):
        """Record the checkpoint directory and read its
        `generation_config.json`, as the JAX package's hook does."""
        model.config.model_path = str(model_path)
        gen_cfg = Path(model_path) / "generation_config.json"
        if gen_cfg.exists():
            model.load_generate_config(json.loads(gen_cfg.read_text()))
        return model

    @staticmethod
    def model_quant_predicate(path: str, module=None) -> bool:
        """The layers a quantized checkpoint may hold quantized: the talker's
        and the code predictor's transformer layers. The JAX package's
        predicate also admits the code predictor's embeddings and heads,
        which its decode loop (and this port's) reads as raw float weights:
        a checkpoint that holds them quantized does not run (ROADMAP,
        Queue 3). Write a quantized checkpoint with
        `convert(..., q_recipe=checkpoint_quant_predicate)`."""
        if path.startswith("talker.model.layers"):
            return True
        return path.startswith("talker.code_predictor") and not (
            ".lm_head" in path or ".codec_embedding" in path)

    def sanitize(self, weights: dict) -> dict:
        """Checkpoint keys → the JAX package's names, convolution weights
        oriented to its layouts (what the JAX sanitize returns), for
        `nn.load_weights`."""
        out = {}
        for k, v in weights.items():
            if k.startswith(("talker.", "speaker_encoder.", "speech_tokenizer.")):
                out[k] = v
            elif k.startswith("tokenizer."):
                out["speech_tokenizer." + k[len("tokenizer."):]] = v
            else:
                out["talker." + k] = v
        # a checkpoint that carries the speech-tokenizer encoder gets it
        # built here, in the model's dtype, so the loader fills it
        if any(k.startswith(NOT_BUILT) for k in out):
            self.speech_tokenizer.build_encoder()
        return orient_weights_to_model(self, out)

    def _stacked_heads(self) -> torch.Tensor:
        """The code predictor's heads as one float32 (G-1, V, D) tensor,
        made once per set of weights (the loop reads them raw, with float32
        products, as the JAX package does)."""
        heads = self.talker.code_predictor.lm_head
        key = tuple((h.weight.data_ptr(), h.weight._version) for h in heads)
        if self._heads[0] != key:
            self._heads = (key, torch.stack([h.weight.detach() for h in heads]).float())
        return self._heads[1]

    # ---- inputs ----

    @torch.inference_mode()
    def extract_speaker_embedding(self, ref_audio) -> torch.Tensor:
        """A reference waveform at the speaker encoder's rate → its x-vector
        (1, 1, enc_dim)."""
        cfg = self.config.speaker_encoder_config
        mel = mel_spectrogram(ref_audio, num_mels=cfg.mel_dim, sample_rate=cfg.sample_rate,
                              device=self.device)
        return self.speaker_encoder(mel)[:, None]

    def _text_embed(self, ids) -> torch.Tensor:
        t = torch.as_tensor(list(ids), dtype=torch.long, device=self.device)[None]
        return self.talker.text_projection(self.talker.model.text_embedding(t))

    def _codec_embed(self, ids) -> torch.Tensor:
        t = torch.as_tensor([list(ids)], dtype=torch.long, device=self.device)
        return self.talker.model.codec_embedding(t)

    @torch.inference_mode()
    def _prepare_generation_inputs(self, text: str, language: str = "auto",
                                   speaker: Optional[str] = None, ref_audio=None,
                                   instruct: Optional[str] = None):
        cfg = self.config.talker_config
        chat = f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n"
        text_embed = self._text_embed(self.tokenizer.encode(chat))
        tts = self._text_embed([self.config.tts_bos_token_id, self.config.tts_eos_token_id,
                                self.config.tts_pad_token_id])
        tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]

        speaker_embed = None
        if ref_audio is not None and self.speaker_encoder is not None:
            speaker_embed = self.extract_speaker_embedding(ref_audio)
        elif speaker and speaker.lower() in (cfg.spk_id or {}):
            speaker_embed = self._codec_embed([cfg.spk_id[speaker.lower()]])

        language_id = None
        if language.lower() != "auto" and cfg.codec_language_id:
            language_id = cfg.codec_language_id.get(language.lower())
        if (language.lower() in ("chinese", "auto") and speaker
                and (cfg.spk_is_dialect or {}).get(speaker.lower())):
            dialect = cfg.spk_is_dialect[speaker.lower()]
            language_id = (cfg.codec_language_id or {}).get(dialect, language_id)

        if language_id is None:
            prefill = [cfg.codec_nothink_id, cfg.codec_think_bos_id, cfg.codec_think_eos_id]
        else:
            prefill = [cfg.codec_think_id, cfg.codec_think_bos_id, language_id,
                       cfg.codec_think_eos_id]
        parts = [self._codec_embed(prefill)]
        if speaker_embed is not None:
            parts.append(speaker_embed.reshape(1, 1, -1))
        parts.append(self._codec_embed([cfg.codec_pad_id, cfg.codec_bos_id]))
        codec_embed = torch.cat(parts, dim=1)

        instruct_embed = None
        if instruct:
            instruct_embed = self._text_embed(
                self.tokenizer.encode(f"<|im_start|>user\n{instruct}<|im_end|>\n"))

        role_embed = text_embed[:, :3]
        pad_count = codec_embed.shape[1] - 2
        combined = torch.cat([tts_pad.expand(1, pad_count, tts_pad.shape[-1]), tts_bos],
                             dim=1) + codec_embed[:, :-1]
        pieces = ([instruct_embed] if instruct_embed is not None else []) + [
            role_embed, combined, text_embed[:, 3:4] + codec_embed[:, -1:]]
        input_embeds = torch.cat(pieces, dim=1)
        trailing = torch.cat([text_embed[:, 4:-5], tts_eos], dim=1)
        return input_embeds, trailing, tts_pad

    # ---- the AR core ----

    def _prefill(self, caches, inp, prefill_len: int):
        """The prompt (bucketed to inp's length) through the talker →
        (float32 logits, hidden) of the last real position."""
        Tp = inp.shape[1]
        S = caches[0].max_len
        q = torch.arange(Tp, device=inp.device)[:, None]
        k = torch.arange(S, device=inp.device)[None, :]
        mask = _additive((k <= q) & (k < prefill_len))[None, None]
        logits, hidden = self.talker(inp, caches, mask)
        last = min(max(prefill_len - 1, 0), Tp - 1)
        return logits[:, last].float(), hidden[:, last]

    def _code_predictor_frame(self, hidden_last, c0, generator, heads, caches, tables,
                              sampling):
        """The inner AR over the codebooks of one frame → (codes (G,),
        sum of the frame's codec embeddings (1, D))."""
        talker = self.talker
        cp = talker.code_predictor
        G = talker.config.num_code_groups
        cos, sin, tri = tables
        for c in caches:  # stale entries past `pos` are masked out
            c.pos = 0
        c0_embed = talker.model.codec_embedding(c0)[None]  # (1, 1, D)
        dt = torch.promote_types(hidden_last.dtype, c0_embed.dtype)
        seq = torch.cat([hidden_last[:, None].to(dt), c0_embed.to(dt)], dim=1)
        h = cp.model(cp.project(seq), caches, mask=tri[None, None, 0:2],
                     cos_sin=(cos[:, 0:2], sin[:, 0:2]))
        codes = [c0[0]]
        emb_sum = c0_embed[:, 0]
        for i in range(1, G):
            logits = torch.matmul(h[:, -1].float(), heads[i - 1].T)
            ci = _sample(logits, generator, *sampling)
            codes.append(ci[0])
            emb_i = cp.codec_embedding[i - 1](ci)  # (1, D)
            emb_sum = emb_sum + emb_i
            p = i + 1  # the cache slot this token takes
            h = cp.model(cp.project(emb_i[None]), caches, mask=tri[None, None, p:p + 1],
                         cos_sin=(cos[:, p:p + 1], sin[:, p:p + 1]))
        return torch.stack(codes), emb_sum

    @torch.inference_mode()
    def _run_codes(self, input_embeds, trailing, tts_pad, *, max_tokens: int,
                   chunk_tokens: int, temperature: float, top_k: int, top_p: float,
                   repetition_penalty: float, seed: int = 0, min_tokens: int = 0):
        """Yield codes (n, G) as numpy, `chunk_tokens` frames at a time,
        until EOS or `max_tokens`."""
        talker = self.talker
        cfg = talker.config
        dev = input_embeds.device
        G, eos, V = cfg.num_code_groups, cfg.codec_eos_token_id, cfg.vocab_size
        Tp, D = input_embeds.shape[1], input_embeds.shape[-1]
        Tp_pad = _bucket(Tp)
        inp = input_embeds.new_zeros(1, Tp_pad, D)
        inp[:, :Tp] = input_embeds
        Ttr = trailing.shape[1]

        S = Tp_pad + max_tokens + 2
        caches = talker.model.make_caches(1, S)
        logits, hidden = self._prefill(caches, inp, Tp)

        # decode tables, made once: rope of every position the decode takes,
        # and the mask, which admits the prompt and, step by step, the
        # frames written after the bucket's pad hole [Tp, Tp_pad)
        cos_t, sin_t = talker.model.rotary_emb(
            torch.arange(Tp + max_tokens + 1, device=dev)[None])
        k_idx = torch.arange(S, device=dev)
        dec_mask = _additive(k_idx < Tp)[None, None, None, :].clone()

        # suppress the specials block at the top of the vocab except EOS;
        # for vocabularies of 1024 or less the block starts at the lowest
        # special id, as in the JAX package
        specials_lo = V - 1024
        if specials_lo <= 0:
            specials_lo = min(eos, cfg.codec_think_id, cfg.codec_nothink_id,
                              cfg.codec_think_bos_id, cfg.codec_think_eos_id,
                              cfg.codec_pad_id, cfg.codec_bos_id)
        vocab_idx = torch.arange(V, device=dev)
        suppress = (vocab_idx >= specials_lo) & (vocab_idx != eos)
        is_eos = vocab_idx == eos

        cp = talker.code_predictor
        heads = self._stacked_heads()
        cp_caches = cp.model.make_caches(1, G + 2)
        cp_cos, cp_sin = cp.model.rope(torch.arange(G + 2, device=dev)[None])
        j = torch.arange(G + 2, device=dev)
        cp_tables = (cp_cos, cp_sin, _additive(j[None, :] <= j[:, None]))

        sampling = (float(temperature), int(top_k), float(top_p))
        hist = torch.full((1, 64), -1, dtype=torch.long, device=dev)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        step = 0
        done = False
        while True:
            frames = []
            while len(frames) < chunk_tokens and step < max_tokens:
                lg = logits.masked_fill(suppress, float("-inf"))
                if step < min_tokens:  # EOS unreachable before min_tokens frames
                    lg = lg.masked_fill(is_eos, float("-inf"))
                if repetition_penalty != 1.0:
                    lg = apply_repetition_penalty(lg, hist, repetition_penalty)
                c0 = _sample(lg, generator, *sampling)  # (1,)
                codes, emb_sum = self._code_predictor_frame(
                    hidden, c0, generator, heads, cp_caches, cp_tables, sampling)
                hist = torch.cat([hist[:, 1:], c0[:, None]], dim=1)

                # next input: the trailing text (then the pad) plus the frame's
                # codec embeddings; positions continue from the true prompt
                # length while the cache writes after the bucket
                text_embed = trailing[:, step:step + 1] if step < Ttr else tts_pad
                q_pos = Tp + step
                dec_mask[..., Tp_pad + step] = 0.0
                new_logits, new_hidden = talker(
                    text_embed + emb_sum[:, None], caches, dec_mask,
                    cos_sin=(cos_t[:, q_pos:q_pos + 1], sin_t[:, q_pos:q_pos + 1]))
                if step >= min_tokens and bool(c0[0] == eos):
                    done = True  # the EOS frame is not kept
                    break
                frames.append(codes)
                step += 1
                logits, hidden = new_logits[:, -1].float(), new_hidden[:, -1]
            if frames:
                yield torch.stack(frames).cpu().numpy()
            if done or step >= max_tokens or not frames:
                return

    def _decode_codes(self, codes_nk: np.ndarray) -> np.ndarray:
        """codes (n, G) → waveform (samples,)."""
        codes = torch.as_tensor(np.ascontiguousarray(codes_nk.T[None]), device=self.device)
        return self.speech_tokenizer.chunked_decode(codes).reshape(-1)

    def _result(self, audio, n_tokens, segment_idx, elapsed, **flags):
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=np.asarray(audio), samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=segment_idx, token_count=n_tokens,
            audio_duration=format_duration(dur),
            real_time_factor=round(elapsed / max(dur, 1e-9), 3),
            prompt={"tokens": n_tokens,
                    "tokens-per-sec": round(n_tokens / max(elapsed, 1e-9), 2)},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / max(elapsed, 1e-9), 2)},
            processing_time_seconds=elapsed, peak_memory_usage=0.0, **flags)

    def _generate_segment(self, input_embeds, trailing, tts_pad, *, segment_idx: int,
                          stream: bool, streaming_interval: float, max_tokens: int,
                          temperature: float, top_k: int, top_p: float,
                          repetition_penalty: float, seed: int = 0, min_tokens: int = 0,
                          ref_codes=None):
        """One AR segment: one final result, or streaming chunks decoded with
        25 frames of left context. `ref_codes` (ICL, (1, K, Tref)) are
        decoded ahead of the generated codes, and their share of the audio
        cut off in proportion to their frames."""
        t0 = time.perf_counter()
        context = 25
        up = self.speech_tokenizer.decode_upsample_rate
        chunk_size = max(1, int(streaming_interval * 12.5)) if stream else max_tokens
        sampling = dict(max_tokens=max_tokens, min_tokens=min_tokens, temperature=temperature,
                        top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
                        seed=seed)
        # under a running server a Qwen3TTSBatcher may be installed:
        # concurrent requests' frame loops then decode in lock-step
        hook = get_infer_hook(self)
        codes = None
        if hook is not None and not stream:
            codes = hook.submit(input_embeds, trailing, **sampling).result()  # (n, G)
        elif hook is not None:
            # batched and streaming: the batcher emits each frame through
            # `on_frame` as its tick completes; chunk_size frames regroup here,
            # so the chunked codec decode below is the single-stream path's
            run = (np.stack(c) for c in stream_chunks(
                hook.submit, input_embeds, trailing, chunk_size=chunk_size,
                callback_kw="on_frame", **sampling))
        else:
            run = self._run_codes(input_embeds, trailing, tts_pad, chunk_tokens=chunk_size,
                                  **sampling)
        if not stream:
            if codes is None:
                chunks = list(run)
                codes = np.concatenate(chunks, axis=0) if chunks else None
            if codes is None or codes.shape[0] == 0:
                return
            if ref_codes is not None:
                ref_t = np.asarray(ref_codes)[0].T  # (Tref, K)
                full = np.concatenate([ref_t, codes], axis=0)
                audio = self._decode_codes(full)
                cut = int(ref_t.shape[0] / max(full.shape[0], 1) * len(audio))
                audio = audio[cut:] if 0 < cut < len(audio) else audio
            else:
                audio = self._decode_codes(codes)
            yield self._result(audio, codes.shape[0], segment_idx, time.perf_counter() - t0)
            return

        all_codes: List[np.ndarray] = []
        decoded = 0
        pending = None
        for chunk in run:
            all_codes.append(chunk)
            total = sum(c.shape[0] for c in all_codes)
            start = max(0, decoded - context)
            audio = self._decode_codes(np.concatenate(all_codes, axis=0)[start:])
            trim = (decoded - start) * up
            if 0 < trim < len(audio):
                audio = audio[trim:]
            new_tokens = total - decoded
            decoded = total
            if pending is not None:
                yield pending
            pending = self._result(audio, new_tokens, segment_idx, time.perf_counter() - t0,
                                   is_streaming_chunk=True)
        if pending is not None:
            pending.is_final_chunk = True
            yield pending

    # ---- public generation ----

    def generate(self, text: str, voice: Optional[str] = None, speed: float = 1.0,
                 verbose: bool = False, lang_code: str = "auto",
                 instruct: Optional[str] = None, temperature: float = 0.9,
                 top_k: int = 50, top_p: float = 1.0, repetition_penalty: float = 1.05,
                 max_tokens: int = 4096, split_pattern: str = "\n", ref_audio=None,
                 ref_text: Optional[str] = None, stream: bool = False,
                 streaming_interval: float = 2.0, **kwargs):
        """Routes by model type as the JAX package does: voice_design (voice
        described by `instruct`), custom_voice (a named speaker, optional
        `instruct`), base: ICL voice cloning with `ref_audio` + `ref_text`,
        else one segment per `split_pattern` piece, with the x-vector of
        `ref_audio` as the speaker where the checkpoint has the speaker
        encoder."""
        if ref_audio is not None and isinstance(ref_audio, str):
            from ....utils import load_audio

            ref_audio = load_audio(ref_audio, sample_rate=self.sample_rate)
        common = dict(
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, max_tokens=max_tokens, stream=stream,
            streaming_interval=streaming_interval, seed=kwargs.get("seed", 0),
            min_tokens=int(kwargs.get("min_tokens", 0)))
        tts_model_type = getattr(self.config, "tts_model_type", "base")
        if tts_model_type == "voice_design":
            if not instruct:
                raise ValueError("VoiceDesign model requires 'instruct' to describe the "
                                 "voice (e.g. 'A cheerful young female voice')")
            yield from self.generate_voice_design(text=text, instruct=instruct,
                                                  language=lang_code, **common)
            return
        if tts_model_type == "custom_voice":
            if not voice:
                raise ValueError("CustomVoice model requires 'voice' (speaker name); "
                                 f"available: {self.supported_speakers}")
            yield from self.generate_custom_voice(text=text, speaker=voice,
                                                  language=lang_code, instruct=instruct,
                                                  **common)
            return

        if ref_audio is not None and ref_text is not None:
            # ICL voice cloning, with the stronger repetition penalty that keeps
            # codes from degenerating after a long reference prefill
            if not hasattr(self.speech_tokenizer, "encoder"):
                raise ValueError(_ICL_NEEDS_ENCODER)
            common["repetition_penalty"] = max(repetition_penalty, 1.5)
            yield from self._generate_icl(text=text, ref_audio=ref_audio, ref_text=ref_text,
                                          language=lang_code, **common)
            return

        segments = [s.strip() for s in text.split(split_pattern) if s.strip()]
        for segment_idx, segment in enumerate(segments):
            input_embeds, trailing, tts_pad = self._prepare_generation_inputs(
                segment, language=lang_code, speaker=voice, ref_audio=ref_audio,
                instruct=instruct)
            yield from self._generate_segment(input_embeds, trailing, tts_pad,
                                              segment_idx=segment_idx, **common)

    def _effective_max_tokens(self, text: str, max_tokens: int) -> int:
        """Cap the decode by the text's length (~3-5 frames per text token;
        factor 6 for margin), bucketed to 128 as in the JAX package."""
        n_text = len(self.tokenizer.encode(text))
        cap = min(max_tokens, max(75, n_text * 6))
        return min(-(-cap // 128) * 128, max_tokens)

    def generate_custom_voice(self, text: str, speaker: str, language: str = "auto",
                              instruct: Optional[str] = None, **kw):
        if self.config.tts_model_type != "custom_voice":
            raise ValueError(f"Model type '{self.config.tts_model_type}' does not support "
                             "generate_custom_voice (use a CustomVoice checkpoint).")
        if speaker.lower() not in [s.lower() for s in self.supported_speakers]:
            raise ValueError(f"Speaker '{speaker}' not supported. "
                             f"Available: {self.supported_speakers}")
        yield from self._generate_with_instruct(text=text, speaker=speaker,
                                                language=language, instruct=instruct, **kw)

    def generate_voice_design(self, text: str, instruct: str, language: str = "auto", **kw):
        if self.config.tts_model_type != "voice_design":
            raise ValueError(f"Model type '{self.config.tts_model_type}' does not support "
                             "generate_voice_design (use a VoiceDesign checkpoint).")
        yield from self._generate_with_instruct(text=text, speaker=None, language=language,
                                                instruct=instruct, **kw)

    def _generate_with_instruct(self, text: str, speaker: Optional[str], language: str,
                                instruct: Optional[str], temperature: float = 0.9,
                                top_k: int = 50, top_p: float = 1.0,
                                repetition_penalty: float = 1.05, max_tokens: int = 4096,
                                stream: bool = False, streaming_interval: float = 2.0,
                                seed: int = 0, **_):
        input_embeds, trailing, tts_pad = self._prepare_generation_inputs(
            text, language=language, speaker=speaker, instruct=instruct)
        yield from self._generate_segment(
            input_embeds, trailing, tts_pad, segment_idx=0, stream=stream,
            streaming_interval=streaming_interval,
            max_tokens=self._effective_max_tokens(text, max_tokens),
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, seed=seed)

    @torch.inference_mode()
    def _prepare_icl_generation_inputs(self, text: str, ref_audio, ref_text: str,
                                       language: str = "auto"):
        """The ICL voice-cloning prefill: role, the codec prefix (think /
        speaker / pad / bos), then all the text (the reference's and the
        target's, plus tts_eos) over codec_pad, then codec_bos and the sum
        over codebooks of the reference codes' embeddings over tts_pad →
        (input_embeds, trailing, tts_pad, ref_codes (1, K, Tref) numpy)."""
        cfg = self.config.talker_config
        ra = np.asarray(ref_audio, np.float32).reshape(-1)
        ref_codes = self.speech_tokenizer.encode(ra[None, None, :]).cpu().numpy()

        ref_ids = self.tokenizer.encode(f"<|im_start|>assistant\n{ref_text}<|im_end|>\n")
        ref_text_ids = ref_ids[3:-2]
        target_ids = self.tokenizer.encode(
            f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n")
        text_ids = target_ids[3:-5]
        tts = self._text_embed([self.config.tts_bos_token_id, self.config.tts_eos_token_id,
                                self.config.tts_pad_token_id])
        tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]
        text_embed = torch.cat([self._text_embed(list(ref_text_ids) + list(text_ids)),
                                tts_eos], dim=1)
        D = text_embed.shape[-1]

        # the codec side: the sum over codebooks of the reference codes' embeddings
        codes = torch.as_tensor(ref_codes, dtype=torch.long, device=self.device)
        cp = self.talker.code_predictor
        ref_codec_embed = self.talker.model.codec_embedding(codes[:, 0])
        for i in range(cfg.num_code_groups - 1):
            ref_codec_embed = ref_codec_embed + cp.codec_embedding[i](codes[:, i + 1])
        codec_embed_icl = torch.cat([self._codec_embed([cfg.codec_bos_id]), ref_codec_embed],
                                    dim=1)
        codec_pad = self._codec_embed([cfg.codec_pad_id])
        # the non-streaming overlay: all the text over codec_pad, then all
        # the codec over tts_pad
        icl_embed = torch.cat([text_embed + codec_pad.expand(1, text_embed.shape[1], D),
                               codec_embed_icl + tts_pad.expand(1, codec_embed_icl.shape[1], D)],
                              dim=1)

        language_id = None
        if language.lower() != "auto" and cfg.codec_language_id:
            language_id = cfg.codec_language_id.get(language.lower())
        speaker_embed = (self.extract_speaker_embedding(ra)
                         if self.speaker_encoder is not None else None)
        if language_id is None:
            prefill = [cfg.codec_nothink_id, cfg.codec_think_bos_id, cfg.codec_think_eos_id]
        else:
            prefill = [cfg.codec_think_id, cfg.codec_think_bos_id, language_id,
                       cfg.codec_think_eos_id]
        parts = [self._codec_embed(prefill)]
        if speaker_embed is not None:
            parts.append(speaker_embed.reshape(1, 1, -1).to(parts[0].dtype))
        parts.append(self._codec_embed([cfg.codec_pad_id, cfg.codec_bos_id]))
        codec_prefix = torch.cat(parts, dim=1)

        role_embed = self._text_embed(list(target_ids[:3]))
        pad_count = codec_prefix.shape[1] - 2
        combined_prefix = torch.cat([tts_pad.expand(1, pad_count, D), tts_bos],
                                    dim=1) + codec_prefix[:, :-1]
        input_embeds = torch.cat([role_embed, combined_prefix, icl_embed], dim=1)
        return input_embeds, tts_pad, tts_pad, ref_codes

    def _generate_icl(self, text: str, ref_audio, ref_text: str, language: str = "auto",
                      temperature: float = 0.9, top_k: int = 50, top_p: float = 1.0,
                      repetition_penalty: float = 1.5, max_tokens: int = 4096,
                      stream: bool = False, streaming_interval: float = 2.0, seed: int = 0,
                      **_):
        """ICL voice cloning: the reference codes in the prefill; the
        non-streamed decode puts them ahead of the generated codes and cuts
        their audio off. `min_tokens` is not taken, as in the JAX package."""
        input_embeds, trailing, tts_pad, ref_codes = self._prepare_icl_generation_inputs(
            text=text, ref_audio=ref_audio, ref_text=ref_text, language=language)
        yield from self._generate_segment(
            input_embeds, trailing, tts_pad, segment_idx=0, stream=stream,
            streaming_interval=streaming_interval,
            max_tokens=self._effective_max_tokens(text, max_tokens),
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, seed=seed,
            ref_codes=None if stream else ref_codes)

    def make_batcher(self, **kwargs):
        """Serving batcher: continuous (slot-based) batching of concurrent
        talker + code-predictor frame loops, every live request advanced by
        each tick (see batcher.Qwen3TTSBatcher)."""
        from .batcher import Qwen3TTSBatcher

        return Qwen3TTSBatcher(self, **kwargs)
