"""CosyVoice2: the Qwen2 speech-token LM, the flow (upsampling conformer,
causal U-Net, CFG Euler solve) and HiFT (counterpart of
`mlx_audio_tpu/tts/models/cosyvoice2/cosyvoice2.py`).

The modes are the JAX package's: zero-shot (a reference clip and its
transcript), cross-lingual (the clip only), instruct (style text) and voice
conversion (source audio, no LM), and `synthesize_streaming`, which vocodes
the tokens chunk by chunk with the flow's chunk masks. Tokens go into the
flow padded to a multiple of `TOKEN_BUCKET`, as there.

A request's seed seeds each stage's own `torch.Generator`: the LM's draws,
the flow's initial noise and HiFT's source. They match the JAX package's
key-driven draws in distribution only; `noise` and `draws` pass draws in.
The S3TokenizerV2 comes from `set_runtime` or the checkpoint's
`s3tokenizer/` directory, CAM++ from the checkpoint's `campplus.*` keys or
its `campplus.safetensors` (the port downloads nothing); the text tokenizer
is the port's `tokenizer_json` reader on the checkpoint's `tokenizer.json`
with the control tokens added. `set_runtime` objects live on the instance,
not in a class-level table."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Generator, Optional

import numpy as np
import torch
from torch import nn

from ....codec.models.s3gen import (CAMPPlus, CausalMaskedDiffWithXvec, CFMParams,
                                    ConditionalCFM, ConditionalDecoder, HiFTGenerator,
                                    UpsampleConformerEncoder)
from ....codec.models.s3gen.mel import mel_spectrogram
from ....device import resolve_device
from ....nn.module import init_weights
from .config import CosyVoice2Config, ModelConfig
from .llm import Qwen2LM

__all__ = ["CosyVoice2", "Model", "build_cosyvoice2", "TOKEN_BUCKET", "S3TOKENIZER_DIR"]

TOKEN_BUCKET = 50  # the flow's token-length granularity (2 s at 25 Hz)
S3TOKENIZER_DIR = "s3tokenizer"  # the S3Tokenizer's weights inside a checkpoint


def _pad_tokens(tokens: np.ndarray, bucket: int = TOKEN_BUCKET) -> np.ndarray:
    n = tokens.shape[1]
    target = max(bucket, ((n + bucket - 1) // bucket) * bucket)
    return np.pad(tokens, ((0, 0), (0, target - n)))


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def build_cosyvoice2(config: CosyVoice2Config, device=None) -> "CosyVoice2":
    """The three stages from a CosyVoice2Config, on `device` (None: the
    card); their weights are drawn by the caller."""
    dev = resolve_device(device)
    f = config.flow
    encoder = UpsampleConformerEncoder(
        input_size=f.input_size, output_size=f.encoder_output_size,
        attention_heads=f.encoder_attention_heads, linear_units=f.encoder_linear_units,
        num_blocks=f.encoder_num_blocks, num_up_blocks=f.encoder_num_up_blocks,
        static_chunk_size=f.encoder_static_chunk_size, pre_lookahead_len=f.pre_lookahead_len,
        upsample_stride=f.encoder_upsample_stride, device=dev)
    estimator = ConditionalDecoder(
        in_channels=f.decoder_in_channels, out_channels=f.decoder_out_channel,
        channels=list(f.decoder_channels), attention_head_dim=f.decoder_attention_head_dim,
        n_blocks=f.decoder_n_blocks, num_mid_blocks=f.decoder_num_mid_blocks,
        num_heads=f.decoder_num_heads, static_chunk_size=f.decoder_static_chunk_size,
        num_decoding_left_chunks=f.decoder_num_decoding_left_chunks, device=dev)
    cfm = ConditionalCFM(in_channels=f.cfm_in_channels,
                         cfm_params=CFMParams(sigma_min=f.cfm_sigma_min,
                                              t_scheduler=f.cfm_t_scheduler,
                                              inference_cfg_rate=f.cfm_inference_cfg_rate),
                         estimator=estimator)
    cfm.MEL_CHANNELS = f.output_size
    flow = CausalMaskedDiffWithXvec(
        input_size=f.input_size, output_size=f.output_size, spk_embed_dim=f.spk_embed_dim,
        vocab_size=f.vocab_size, input_frame_rate=f.input_frame_rate,
        token_mel_ratio=f.token_mel_ratio, pre_lookahead_len=f.pre_lookahead_len,
        n_timesteps=f.n_timesteps, encoder=encoder, decoder=cfm, device=dev)
    h = config.hifigan
    hifigan = HiFTGenerator(
        in_channels=h.in_channels, base_channels=h.base_channels, nb_harmonics=h.nb_harmonics,
        sampling_rate=h.sampling_rate, nsf_alpha=h.nsf_alpha, nsf_sigma=h.nsf_sigma,
        nsf_voiced_threshold=h.nsf_voiced_threshold, upsample_rates=list(h.upsample_rates),
        upsample_kernel_sizes=list(h.upsample_kernel_sizes),
        istft_params={"n_fft": h.istft_n_fft, "hop_len": h.istft_hop_len},
        resblock_kernel_sizes=list(h.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(d) for d in h.resblock_dilation_sizes],
        source_resblock_kernel_sizes=list(h.source_resblock_kernel_sizes),
        source_resblock_dilation_sizes=[list(d) for d in h.source_resblock_dilation_sizes],
        use_interpolation=h.use_interpolation, device=dev)
    return CosyVoice2(config, Qwen2LM(config.llm, device=dev), flow, hifigan)


class CosyVoice2(nn.Module):
    """The composite model; CosyVoice3 keeps its shape and its modes."""

    def __init__(self, config: Optional[CosyVoice2Config] = None, llm=None, flow=None,
                 hifigan=None):
        super().__init__()
        self.config = config or CosyVoice2Config()
        self.llm = llm
        self.flow = flow
        self.hifigan = hifigan

    @property
    def device(self) -> torch.device:
        return next(self.flow.parameters()).device

    # ------------------------------------------------------------------
    def generate_tokens(self, text, prompt_text=None, prompt_speech_token=None,
                        sampling: int = 25, max_token_text_ratio: float = 20.0,
                        min_token_text_ratio: float = 2.0, seed: Optional[int] = None
                        ) -> np.ndarray:
        """The speech tokens (n,) int32, through an installed `RASBatcher`
        where there is one (concurrent requests' decodes then run in
        lock-step)."""
        from ....serving import get_infer_hook

        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        hook = get_infer_hook(self)
        if hook is not None:
            from .llm import step_limits

            with torch.inference_mode():
                embeds = self.llm.build_prompt_embeds(np.asarray(text), prompt_text,
                                                      prompt_speech_token)
            min_len, max_len = step_limits(np.asarray(text).size, embeds.shape[1],
                                           max_token_text_ratio, min_token_text_ratio)
            return np.asarray(hook.submit(embeds.float().cpu().numpy(), min_tokens=min_len,
                                          max_steps=max_len, seed=seed).result(), np.int32)
        tokens, _ = self.llm.inference(
            text=text, prompt_text=prompt_text, prompt_speech_token=prompt_speech_token,
            sampling=sampling, max_token_text_ratio=max_token_text_ratio,
            min_token_text_ratio=min_token_text_ratio, seed=seed)
        return tokens

    def make_batcher(self, **kwargs):
        """Serving batcher: concurrent requests' RAS decodes run in
        lock-step (CosyVoice2's stop rule: the token V; fill tokens fed, not
        emitted); the flow and HiFT stay per request."""
        from .batcher import RASBatcher

        return RASBatcher(self, lm=self.llm, v3=False, **kwargs)

    @torch.inference_mode()
    def tokens_to_mel(self, tokens, prompt_token, prompt_feat, embedding,
                      n_timesteps: Optional[int] = None, seed: int = 0, streaming: bool = False,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (1, T) → mel (1, 2T, 80) of the region past the prompt."""
        dev = self.device
        tokens = np.asarray(tokens, np.int64).reshape(1, -1)
        prompt_token = np.asarray(prompt_token, np.int64).reshape(1, -1)
        n_new = tokens.shape[1]
        padded = _pad_tokens(tokens)
        feat, _ = self.flow.inference(
            token=torch.as_tensor(padded, device=dev),
            token_len=torch.tensor([n_new], device=dev),
            prompt_token=torch.as_tensor(prompt_token, device=dev),
            prompt_token_len=torch.tensor([prompt_token.shape[1]], device=dev),
            prompt_feat=torch.as_tensor(np.asarray(prompt_feat), device=dev),
            embedding=torch.as_tensor(np.asarray(embedding), device=dev),
            generator=_generator(dev, seed), n_timesteps=n_timesteps or self.flow.n_timesteps,
            streaming=streaming, noise=noise)
        return feat[:, : n_new * self.flow.token_mel_ratio]

    @torch.inference_mode()
    def mel_to_audio(self, mel, seed: int = 0, draws=None) -> np.ndarray:
        """mel (1, T, 80) → waveform (1, T·480) on the host."""
        mel = torch.as_tensor(mel, device=self.device)
        gen = None if draws is not None else _generator(self.device, seed)
        wav, _ = self.hifigan(mel, generator=gen, draws=draws)
        return wav.float().cpu().numpy()

    # ------------------------------------------------------------------
    def _pipeline(self, text, lm_prompt_text, lm_prompt_speech, prompt_speech_token, prompt_mel,
                  speaker_embedding, sampling, n_timesteps, max_token_text_ratio,
                  min_token_text_ratio, seed) -> np.ndarray:
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        tokens = self.generate_tokens(text, lm_prompt_text, lm_prompt_speech, sampling=sampling,
                                      max_token_text_ratio=max_token_text_ratio,
                                      min_token_text_ratio=min_token_text_ratio, seed=seed)
        if tokens.size == 0:
            raise RuntimeError("No tokens generated")
        mel = self.tokens_to_mel(tokens, prompt_speech_token, prompt_mel, speaker_embedding,
                                 n_timesteps, seed=seed)
        return self.mel_to_audio(mel, seed=seed)

    def synthesize(self, text, prompt_text, prompt_speech_token, prompt_mel,
                   speaker_embedding, sampling: int = 25, n_timesteps: int = 10,
                   max_token_text_ratio: float = 20.0, min_token_text_ratio: float = 2.0,
                   seed: Optional[int] = None) -> np.ndarray:
        """Zero-shot: the LM sees the transcript and the prompt speech."""
        return self._pipeline(text, prompt_text, prompt_speech_token, prompt_speech_token,
                              prompt_mel, speaker_embedding, sampling, n_timesteps,
                              max_token_text_ratio, min_token_text_ratio, seed)

    def synthesize_zero_shot(self, *args, **kwargs):
        return self.synthesize(*args, **kwargs)

    def synthesize_cross_lingual(self, text, prompt_speech_token, prompt_mel,
                                 speaker_embedding, sampling: int = 25, n_timesteps: int = 10,
                                 max_token_text_ratio: float = 20.0,
                                 min_token_text_ratio: float = 2.0,
                                 seed: Optional[int] = None) -> np.ndarray:
        """The LM sees no prompt; the flow keeps the speaker."""
        return self._pipeline(text, None, None, prompt_speech_token, prompt_mel,
                              speaker_embedding, sampling, n_timesteps, max_token_text_ratio,
                              min_token_text_ratio, seed)

    def synthesize_instruct(self, text, instruct_text, prompt_speech_token, prompt_mel,
                            speaker_embedding, sampling: int = 25, n_timesteps: int = 10,
                            max_token_text_ratio: float = 20.0,
                            min_token_text_ratio: float = 2.0,
                            seed: Optional[int] = None) -> np.ndarray:
        """The instruct text as the LM's prompt, no prompt speech there."""
        return self._pipeline(text, instruct_text, None, prompt_speech_token, prompt_mel,
                              speaker_embedding, sampling, n_timesteps, max_token_text_ratio,
                              min_token_text_ratio, seed)

    def synthesize_vc(self, source_speech_token, prompt_speech_token, prompt_mel,
                      speaker_embedding, n_timesteps: int = 10, seed: int = 0) -> np.ndarray:
        """Voice conversion: the source's tokens straight into the flow."""
        mel = self.tokens_to_mel(source_speech_token, prompt_speech_token, prompt_mel,
                                 speaker_embedding, n_timesteps, seed=seed)
        return self.mel_to_audio(mel, seed=seed)

    STREAM_CHUNK = 50

    def synthesize_streaming(self, text, prompt_text, prompt_speech_token, prompt_mel,
                             speaker_embedding, chunk_tokens: Optional[int] = None,
                             seed: Optional[int] = None, **kwargs
                             ) -> Generator[np.ndarray, None, None]:
        """All the tokens first, then a chunk of `chunk_tokens` at a time: the
        flow over the tokens so far with its chunk masks (streaming), the
        new chunk's mel vocoded."""
        chunk_tokens = chunk_tokens or self.STREAM_CHUNK
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        tokens = self.generate_tokens(text, prompt_text, prompt_speech_token, seed=seed,
                                      **kwargs)
        for i, start in enumerate(range(0, len(tokens), chunk_tokens)):
            chunk = tokens[start: start + chunk_tokens]
            mel = self.tokens_to_mel(np.concatenate([tokens[:start], chunk])[None],
                                     prompt_speech_token, prompt_mel, speaker_embedding,
                                     seed=seed + 1 + i, streaming=True)
            yield self.mel_to_audio(mel[:, start * self.flow.token_mel_ratio:],
                                    seed=seed + 1 + i)


class Model(nn.Module):
    """The `generate` wrapper on an explicit device (None: the card), the
    weights drawn from `seed`."""

    _SPECIAL_TOKENS = [
        "<|endofprompt|>", "[breath]", "<strong>", "</strong>", "[noise]", "[laughter]",
        "[cough]", "[clucking]", "[accent]", "[quick_breath]", "<laughter>", "</laughter>",
        "[hissing]", "[sigh]", "[vocalized-noise]", "[lipsmack]", "[mn]",
    ]
    FAMILY = "CosyVoice2"

    def __init__(self, config: Any = None, device=None, seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config or ModelConfig()
        self.sample_rate = self.config.sample_rate
        self.device = resolve_device(device)
        self.model = self._build(self.device)
        init_weights(self, _generator(self.device, seed))
        # host objects and the S3Tokenizer and CAM++: a plain dict, so their
        # weights are neither this model's parameters nor in its state dict
        self._runtime: dict = {}

    def _build(self, device):
        return build_cosyvoice2(self.config.cosyvoice2 or CosyVoice2Config(), device)

    def make_batcher(self, **kwargs):
        """Serving batcher: the inner model's (its `generate_tokens` checks
        the hook)."""
        return self.model.make_batcher(**kwargs)

    def set_runtime(self, tokenizer=None, s3_tokenizer=None, speaker_encoder=None):
        for name, obj in (("tokenizer", tokenizer), ("s3_tokenizer", s3_tokenizer),
                          ("speaker_encoder", speaker_encoder)):
            if obj is not None:
                self._runtime[name] = obj

    def _tokenizer(self, mp: Path):
        from ....tokenizer_json import load

        tok_dir = mp / "tokenizer"
        return load(tok_dir if tok_dir.is_dir() else mp).with_added_tokens(
            self._SPECIAL_TOKENS)

    def _s3_tokenizer(self, mp: Optional[Path]):
        from ....codec.models.s3tokenizer import S3TokenizerV2

        return S3TokenizerV2.from_pretrained("speech_tokenizer_v2_25hz", repo_id=str(mp),
                                             device=self.device)

    def _runtime_part(self, name: str):
        """The object `set_runtime` set, else the checkpoint's: the text
        tokenizer from `tokenizer/` or the root, the S3Tokenizer from
        `s3tokenizer/`, CAM++ from the `campplus.*` keys or
        `campplus.safetensors`; else this raises."""
        rt = self._runtime
        if name in rt:
            return rt[name]
        mp = getattr(self.config, "model_path", None)
        mp = Path(mp) if mp else None
        if name == "tokenizer" and mp is not None:
            rt[name] = self._tokenizer(mp)
        elif name == "s3_tokenizer" and mp is not None and (mp / S3TOKENIZER_DIR).is_dir():
            rt[name] = self._s3_tokenizer(mp / S3TOKENIZER_DIR)
        elif name == "speaker_encoder":
            enc = CAMPPlus(device=self.device)
            weights = campplus_weights(mp) if mp is not None else None
            if weights:
                from ....nn.module import load_weights

                load_weights(enc, enc.sanitize(weights), strict=False)
            rt[name] = enc.eval()
        else:
            raise RuntimeError(
                f"{self.FAMILY} needs its {name}: pass it with set_runtime() or load the "
                f"model from a checkpoint directory that holds it (the S3Tokenizer's weights "
                f"in its {S3TOKENIZER_DIR}/ directory; the port downloads nothing)")
        return rt[name]

    def sanitize(self, weights: dict) -> dict:
        """`hift.` → `hifigan.`; CAM++'s keys dropped (the speaker encoder
        loads them); the LM's own key map under `model.llm.`."""
        out = {}
        for key, value in weights.items():
            k = "hifigan." + key[5:] if key.startswith("hift.") else key
            if not k.startswith("campplus."):
                out[k] = value
        llm = {k[len("model.llm."):]: v for k, v in out.items() if k.startswith("model.llm.")}
        out = {k: v for k, v in out.items() if not k.startswith("model.llm.")}
        out.update({f"model.llm.{k}": v for k, v in self.model.llm.sanitize(llm).items()})
        return out

    # ------------------------------------------------------------------
    PROMPT_MEL: dict = {}  # the prompt mel's settings past `mel_spectrogram`'s defaults

    def reference(self, ref_audio):
        """A 16 kHz reference clip → (prompt speech tokens (1, n), the 24 kHz
        prompt mel (1, T, 80), the x-vector (1, 192)), on the host."""
        from ....codec.models.s3tokenizer import log_mel_spectrogram, padding
        from ....utils import resample_audio

        s3 = self._runtime_part("s3_tokenizer")
        spk = self._runtime_part("speaker_encoder")
        ref_audio = np.asarray(ref_audio, np.float32).reshape(-1)
        with torch.inference_mode():
            mel, mel_len = padding([log_mel_spectrogram(ref_audio, device=self.device)])
            tokens, _ = s3.quantize(mel, mel_len)
            embedding = spk.inference(torch.as_tensor(ref_audio, device=self.device))
            prompt_mel = mel_spectrogram(resample_audio(ref_audio, 16000, 24000),
                                         num_mels=self.model.flow.output_size,
                                         device=self.device, **self.PROMPT_MEL)
        return tokens, prompt_mel.float().cpu().numpy(), embedding.float().cpu().numpy()

    def prompt(self, ref_audio):
        """`reference`, the prompt mel padded or cut to twice the tokens."""
        tokens, prompt_mel, embedding = self.reference(ref_audio)
        want = tokens.shape[1] * 2
        if prompt_mel.shape[1] >= want:
            prompt_mel = prompt_mel[:, :want]
        else:
            prompt_mel = np.pad(prompt_mel, ((0, 0), (0, want - prompt_mel.shape[1]), (0, 0)))
        return tokens, prompt_mel, embedding

    def prompt_text(self, ref_text: str) -> str:
        """The reference's transcript as the LM's prompt text reads it."""
        return ref_text

    def source_tokens(self, source_audio) -> np.ndarray:
        """A 16 kHz source clip's speech tokens (1, n), for voice conversion."""
        from ....codec.models.s3tokenizer import log_mel_spectrogram, padding

        src = np.asarray(source_audio, np.float32).reshape(-1)
        with torch.inference_mode():
            mel, mel_len = padding([log_mel_spectrogram(src, device=self.device)])
            return self._runtime_part("s3_tokenizer").quantize(mel, mel_len)[0]

    def generate(self, text: str, ref_audio=None, ref_text: Optional[str] = None,
                 instruct_text: Optional[str] = None, source_audio=None,
                 voice: Optional[str] = None, speed: float = 1.0, lang_code: str = "a",
                 temperature: float = 0.7, max_tokens: int = 2000, verbose: bool = True,
                 stream: bool = False, streaming_interval: float = 2.0, seed: int = 0,
                 **kwargs):
        """Zero-shot (ref_text), cross-lingual, instruct (instruct_text) or
        voice conversion (source_audio); ref_audio 16 kHz mono. `voice`,
        `speed`, `lang_code`, `temperature`, `stream` and
        `streaming_interval` are accepted and ignored, as in the JAX
        package: one result."""
        from ..base import GenerationResult

        if ref_audio is None:
            raise ValueError("ref_audio is required for CosyVoice2")
        start = time.time()
        tokenizer = self._runtime_part("tokenizer")
        prompt_speech_token, prompt_mel, embedding = self.prompt(ref_audio)
        text_ids = np.asarray(tokenizer.encode(text), np.int32)
        if verbose:
            mode = ("vc" if source_audio is not None else "instruct"
                    if instruct_text is not None else "zero-shot" if ref_text else
                    "cross-lingual")
            print(f"CosyVoice2 {mode}: {len(text_ids)} text tokens, "
                  f"{prompt_speech_token.shape[1]} prompt speech tokens")
        m = self.model
        if source_audio is not None:
            audio = m.synthesize_vc(self.source_tokens(source_audio), prompt_speech_token,
                                    prompt_mel, embedding, seed=seed)
        elif instruct_text is not None:
            it = np.asarray(tokenizer.encode(instruct_text + "<|endofprompt|>"), np.int32)
            audio = m.synthesize_instruct(text_ids, it, prompt_speech_token, prompt_mel,
                                          embedding, seed=seed)
        elif ref_text:
            pt = np.asarray(tokenizer.encode(self.prompt_text(ref_text)), np.int32)
            audio = m.synthesize(text_ids, pt, prompt_speech_token, prompt_mel, embedding,
                                 seed=seed)
        else:
            audio = m.synthesize_cross_lingual(text_ids, prompt_speech_token, prompt_mel,
                                               embedding, seed=seed)
        audio = np.asarray(audio).reshape(-1)
        elapsed = time.time() - start
        dur = len(audio) / self.sample_rate
        if verbose:
            print(f"CosyVoice2: {dur:.2f}s audio in {elapsed:.2f}s")
        yield GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate, segment_idx=0,
            token_count=int(text_ids.size), audio_duration=f"{dur:.2f}s",
            real_time_factor=elapsed / max(dur, 1e-9), prompt={"tokens": int(text_ids.size)},
            audio_samples={"samples-per-sec": len(audio) / max(elapsed, 1e-9)},
            processing_time_seconds=elapsed, peak_memory_usage=0.0)


def campplus_weights(model_path) -> Optional[dict]:
    """CAM++'s weights: the checkpoint's `campplus.*` keys, else its
    `campplus.safetensors` or `campplus.npz`; None where there are none."""
    from ....utils import load_weight_files

    mp = Path(model_path)
    try:
        consolidated = load_weight_files(mp)
    except FileNotFoundError:
        consolidated = {}
    spk = {k[len("campplus."):]: v for k, v in consolidated.items()
           if k.startswith("campplus.")}
    if spk:
        return spk
    for fname in ("campplus.safetensors", "campplus.npz"):
        if (mp / fname).exists():
            return load_weight_files(mp / fname)
    return None
