"""S3Gen: S3 speech tokens → waveform by flow matching and HiFT, under
Chatterbox and the CosyVoice families (counterpart of
`mlx_audio_tpu/codec/models/s3gen/s3gen.py`).

The flow's initial noise comes from a generator seeded 42 on each call
(the JAX package's fixed PRNGKey(42)); HiFT's source draws from the
generator the caller passes (the JAX package's key), else from one seeded
0. Both match the JAX package in distribution only; `noise` and `draws`
pass its draws in."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ....device import resolve_device
from ....nn.module import init_weights
from .decoder import ConditionalDecoder
from .encoder import UpsampleConformerEncoder
from .flow import CausalMaskedDiffWithXvec
from .flow_matching import CFMParams, ConditionalCFM
from .hifigan import ConvRNNF0Predictor, HiFTGenerator
from .mel import mel_spectrogram
from .xvector import CAMPPlus

S3_SR = 16_000
S3GEN_SR = 24_000
FLOW_NOISE_SEED = 42

__all__ = ["S3Token2Mel", "S3Token2Wav", "CausalConditionalCFM", "S3_SR", "S3GEN_SR"]


class CausalConditionalCFM(ConditionalCFM):
    """The CFM whose noise is fixed: a generator seeded FLOW_NOISE_SEED on
    each call, whatever the caller passes."""

    def forward(self, mu, mask, n_timesteps, generator=None, temperature=1.0, spks=None,
                cond=None, streaming=False, meanflow=False, noise=None):
        if noise is None:
            generator = torch.Generator(device=mu.device)
            generator.manual_seed(FLOW_NOISE_SEED)
        return super().forward(mu, mask, n_timesteps, generator, temperature, spks, cond,
                               streaming, meanflow, noise)


class S3Token2Mel(nn.Module):
    """Speech tokens → mel, conditioned on a reference clip; on an explicit
    device (None: the card), the weights drawn from `seed`. `sizes`
    overrides the encoder's and the estimator's widths and depths (small
    test models; None: the published ones)."""

    def __init__(self, device=None, seed: int = 0, sizes: Optional[dict] = None):
        super().__init__()
        self.device = resolve_device(device)
        dev = self.device
        sizes = sizes or {}
        self.speaker_encoder = CAMPPlus(device=dev, **sizes.get("campplus", {}))
        encoder = UpsampleConformerEncoder(**{
            **dict(input_size=512, output_size=512, attention_heads=8, linear_units=2048,
                   num_blocks=6, num_up_blocks=4), **sizes.get("encoder", {})}, device=dev)
        estimator = ConditionalDecoder(**{
            **dict(in_channels=320, out_channels=80, causal=True, channels=[256],
                   attention_head_dim=64, n_blocks=4, num_mid_blocks=12, num_heads=8),
            **sizes.get("estimator", {})}, device=dev)
        decoder = CausalConditionalCFM(in_channels=240, cfm_params=CFMParams(), spk_emb_dim=80,
                                       estimator=estimator)
        self.flow = CausalMaskedDiffWithXvec(
            input_size=encoder.output_size(), encoder=encoder, decoder=decoder,
            device=dev, **sizes.get("flow", {}))
        self._build_vocoder(sizes)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def _build_vocoder(self, sizes: dict) -> None:
        pass

    @torch.inference_mode()
    def embed_ref(self, ref_wav, ref_sr: int, ref_speech_tokens,
                  ref_speech_token_lens=None) -> Dict:
        """A reference waveform and its speech tokens → the prompt dict
        (tokens and mels trimmed to the 2:1 ratio), on the model's device."""
        from ....utils import resample_audio

        ref_wav = np.asarray(ref_wav, np.float32).reshape(-1)
        wav_24 = ref_wav if ref_sr == S3GEN_SR else resample_audio(ref_wav, ref_sr, S3GEN_SR)
        mels = mel_spectrogram(wav_24, num_mels=self.flow.output_size, device=self.device)
        wav_16 = ref_wav if ref_sr == S3_SR else resample_audio(ref_wav, ref_sr, S3_SR)
        x_vector = self.speaker_encoder.inference(torch.as_tensor(wav_16, device=self.device))

        tokens = torch.as_tensor(np.asarray(ref_speech_tokens), device=self.device).reshape(1, -1)
        n_tok = tokens.shape[1]
        want_tok = mels.shape[1] // 2
        if n_tok < want_tok:
            mels = mels[:, : 2 * n_tok]
        elif n_tok > want_tok:
            tokens = tokens[:, :want_tok]
            n_tok = want_tok
        return dict(prompt_token=tokens.long(),
                    prompt_token_len=torch.tensor([n_tok], device=self.device),
                    prompt_feat=mels, embedding=x_vector)

    @torch.inference_mode()
    def flow_inference(self, speech_tokens, ref_dict: Dict, finalize: bool = True,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """→ mel (1, T_new, 80)."""
        dev = self.device
        tokens = torch.as_tensor(speech_tokens).to(dev).reshape(1, -1).long()
        feat, _ = self.flow.inference(
            token=tokens, token_len=torch.tensor([tokens.shape[1]], device=dev),
            prompt_token=torch.as_tensor(ref_dict["prompt_token"], device=dev).long(),
            prompt_token_len=torch.as_tensor(ref_dict["prompt_token_len"], device=dev),
            prompt_feat=torch.as_tensor(ref_dict["prompt_feat"], device=dev),
            embedding=torch.as_tensor(ref_dict["embedding"], device=dev),
            finalize=finalize, noise=noise)
        return feat

    def forward(self, speech_tokens, ref_dict: Dict, finalize: bool = True) -> torch.Tensor:
        return self.flow_inference(speech_tokens, ref_dict, finalize)


class S3Token2Wav(S3Token2Mel):
    """S3Token2Mel, then HiFT at 24 kHz and the fade-in over the first
    2 × 480 samples (zeros, then a raised cosine)."""

    def _build_vocoder(self, sizes: dict) -> None:
        self.mel2wav = HiFTGenerator(**{
            **dict(sampling_rate=S3GEN_SR, upsample_rates=[8, 5, 3],
                   upsample_kernel_sizes=[16, 11, 7], source_resblock_kernel_sizes=[7, 7, 11],
                   source_resblock_dilation_sizes=[[1, 3, 5]] * 3),
            **sizes.get("hift", {})},
            f0_predictor=ConvRNNF0Predictor(device=self.device, **sizes.get("f0", {})),
            device=self.device)
        n_trim = S3GEN_SR // 50
        fade = (torch.cos(torch.linspace(np.pi, 0.0, n_trim)) + 1) / 2
        self.register_buffer("trim_fade", torch.cat([torch.zeros(n_trim), fade]).to(self.device),
                             persistent=False)

    @torch.inference_mode()
    def hift_inference(self, speech_feat, cache_source=None, generator=None, draws=None):
        return self.mel2wav.inference(speech_feat, generator=generator,
                                      cache_source=cache_source, draws=draws)

    @torch.inference_mode()
    def inference(self, speech_tokens, ref_dict, cache_source: Optional[torch.Tensor] = None,
                  finalize: bool = True, generator: Optional[torch.Generator] = None,
                  noise=None, draws=None):
        """→ (wav (1, T_wav), source)."""
        mels = self.flow_inference(speech_tokens, ref_dict, finalize, noise=noise)
        if generator is None and draws is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        wavs, sources = self.hift_inference(mels, cache_source, generator, draws)
        fade_len = self.trim_fade.shape[0]
        if wavs.shape[1] >= fade_len:
            wavs = torch.cat([wavs[:, :fade_len] * self.trim_fade, wavs[:, fade_len:]], dim=1)
        return wavs, sources

    def forward(self, speech_tokens, ref_dict, finalize: bool = True, generator=None,
                noise=None, draws=None) -> torch.Tensor:
        return self.inference(speech_tokens, ref_dict, finalize=finalize, generator=generator,
                              noise=noise, draws=draws)[0]
