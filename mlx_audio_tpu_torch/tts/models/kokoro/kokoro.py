"""Kokoro-82M text-to-speech (counterpart of
`mlx_audio_tpu/tts/models/kokoro/kokoro.py`).

Two stages, as in the JAX package. The frontend (ALBERT → duration
predictor, and the text encoder) gives each phoneme its frame count; the
host reads that one small int vector; the synthesis (interval alignment →
F0 and energy → iSTFTNet decoder → int16 waveform) runs at the frame count
rounded up to a bucket. Eager PyTorch needs no buckets, but they decide the
tail of the waveform: the convolutions see the padded positions near the
end of the valid region. So `_bucket`, both tables and `valid_frac` are
kept exactly, and the output equals the JAX package's at the same bucket.

The sine source's noise comes from a `torch.Generator` seeded per call
(`seed`), deterministic per call as the JAX package's PRNGKey(0) but not
the same numbers; `noise` passes the draws in. The serving path
(`batch_synthesize`, `make_batcher`) fuses concurrent requests into one
frontend and one synthesis, each row with its sequential call's draws.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....device import resolve_device
from ....nn import Conv1d, ConvTranspose1d, LayerNorm, Linear
from ....nn.module import init_weights, jax_param_shapes
from ....nn.sanitize import as_float32, readings_of
from ..base import GenerationResult, format_duration, orient_to
from .albert import AlbertModelArgs, CustomAlbert
from .istftnet import Decoder, Noise
from .modules import ProsodyPredictor, TextEncoder

__all__ = ["Model", "ModelConfig", "torch_checkpoint"]


@dataclass
class ModelConfig(BaseModelArgs):
    istftnet: dict = None
    dim_in: int = 64
    dropout: float = 0.2
    hidden_dim: int = 512
    max_conv_dim: int = 512
    max_dur: int = 50
    multispeaker: bool = True
    n_layer: int = 3
    n_mels: int = 80
    n_token: int = 178
    style_dim: int = 128
    text_encoder_kernel_size: int = 5
    plbert: dict = None
    vocab: Dict[str, int] = None
    sample_rate: int = 24000
    model_path: str = ""


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    # beyond the table: round up (never truncate: clamping would cut audio
    # mid-utterance and corrupt the masked norms' valid fractions)
    step = buckets[-1] // 2 or buckets[-1]
    return -(-n // step) * step


TEXT_BUCKETS = (64, 128, 256, 512)
FRAME_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 3072)

_LSTM_KEYS = {  # torch nn.LSTM names → the forward/backward submodules
    "weight_ih_l0_reverse": "backward.Wx",
    "weight_hh_l0_reverse": "backward.Wh",
    "bias_ih_l0_reverse": "backward.bias_ih",
    "bias_hh_l0_reverse": "backward.bias_hh",
    "weight_ih_l0": "forward.Wx",
    "weight_hh_l0": "forward.Wh",
    "bias_ih_l0": "forward.bias_ih",
    "bias_hh_l0": "forward.bias_hh",
}


class Model(nn.Module):
    """Kokoro on an explicit device: `Model(config)` builds on the card and
    raises when there is none; tests pass `device="cpu"`. Weights are drawn
    from `seed`; `nn.load_weights` (after `sanitize` for a torch-layout
    checkpoint) replaces them."""

    REPO_ID = "prince-canuma/Kokoro-82M"

    @dataclass
    class Output:
        audio: np.ndarray
        pred_dur: Optional[np.ndarray] = None

    def __init__(self, config: ModelConfig, repo_id: Optional[str] = None, device=None,
                 seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config
        self.vocab = config.vocab or {}
        self.device = dev = resolve_device(device)
        plbert = dict(config.plbert or {})
        plbert.pop("vocab_size", None)
        self.bert = CustomAlbert(
            AlbertModelArgs.from_dict({"vocab_size": config.n_token, **plbert}), device=dev)
        self.bert_encoder = Linear(self.bert.config.hidden_size, config.hidden_dim, device=dev)
        self.context_length = self.bert.config.max_position_embeddings
        self.predictor = ProsodyPredictor(style_dim=config.style_dim, d_hid=config.hidden_dim,
                                          nlayers=config.n_layer, max_dur=config.max_dur,
                                          dropout=config.dropout, device=dev)
        self.text_encoder = TextEncoder(channels=config.hidden_dim,
                                        kernel_size=config.text_encoder_kernel_size,
                                        depth=config.n_layer, n_symbols=config.n_token,
                                        device=dev)
        self.decoder = Decoder(dim_in=config.hidden_dim, style_dim=config.style_dim,
                               dim_out=config.n_mels, sample_rate=config.sample_rate,
                               device=dev, **(config.istftnet or {}))
        self.repo_id = repo_id
        self._pipelines: dict = {}  # lang_code → KokoroPipeline
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)

    # ------------------------------------------------------------------
    # The two stages
    # ------------------------------------------------------------------

    def _frontend(self, input_ids, text_mask, ref_s, speed: float):
        """input_ids (1, T) padded, text_mask (1, T) True = pad, ref_s
        (1, 256) → pred_dur (1, T) int32, d (1, T, C + sty), t_en (1, T, C)."""
        sd = self.config.style_dim
        lengths = (~text_mask).sum(dim=-1)
        bert_out, _ = self.bert(input_ids, attention_mask=(~text_mask).int())
        d_en = self.bert_encoder(bert_out)
        s = ref_s[:, sd:]
        d = self.predictor.text_encoder(d_en, s, lengths, text_mask)
        x = self.predictor.lstm(d, valid_len=lengths)
        duration = torch.sigmoid(self.predictor.duration_proj(x)).sum(dim=-1) / speed
        pred_dur = torch.round(duration).clamp(min=1).int().masked_fill(text_mask, 0)
        t_en = self.text_encoder(input_ids, lengths, text_mask)
        return pred_dur, d, t_en

    def _synthesize(self, d, t_en, pred_dur, ref_s, num_frames: int, noise: Noise):
        """Alignment + prosody + decoder → int16 waveform
        (B, num_frames · samples a frame), batch-polymorphic."""
        # the synthesis runs in the decoder's parameter dtype
        ddt = self.decoder.F0_conv.weight.dtype
        d, t_en, ref_s = d.to(ddt), t_en.to(ddt), ref_s.to(ddt)
        ends = torch.cumsum(pred_dur, dim=1)  # (B, T)
        starts = ends - pred_dur
        frame_idx = torch.arange(num_frames, device=d.device)
        # (B, T_text, num_frames) one-hot interval alignment
        aln = ((frame_idx[None, None, :] >= starts[..., None])
               & (frame_idx[None, None, :] < ends[..., None])).to(d.dtype)
        # the norms' statistics and the reversed LSTM carries ignore the
        # bucket padding through each row's valid fraction
        valid_frac = ends[:, -1].float() / num_frames
        en = torch.einsum("btc,btf->bfc", d, aln)
        sd = self.config.style_dim
        F0_pred, N_pred = self.predictor.F0Ntrain(en, ref_s[:, sd:], valid_frac)
        asr = torch.einsum("btc,btf->bfc", t_en, aln)
        audio = self.decoder(asr, F0_pred, N_pred, ref_s[:, :sd], noise, valid_frac)
        return (audio.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)

    # ------------------------------------------------------------------
    # Phonemes → audio
    # ------------------------------------------------------------------

    def forward(self, phonemes: str, ref_s, speed: float = 1.0, return_output: bool = False,
                seed: int = 0, fused_frames: Optional[int] = None, noise=None):
        """Phoneme string and style vector (256,) or (1, 256) → float32
        audio at `sample_rate` (an `Output` with the frame counts when
        `return_output`). `fused_frames` synthesises at that bucket before
        reading the durations, and redoes the synthesis at the exact bucket
        if they overflow it. `noise` = (rand_ini (1, 9), normal (1, L, 9))
        replaces the sine source's draws from `seed` (L = the bucket's frame
        count × 2 × the generator's total upsampling)."""
        input_ids = [self.vocab.get(p) for p in phonemes]
        input_ids = [i for i in input_ids if i is not None]
        if len(input_ids) + 2 > self.context_length:
            raise ValueError(f"{len(input_ids)} phonemes exceed the context of "
                             f"{self.context_length - 2}")
        ids = [0, *input_ids, 0]
        T = len(ids)
        Tpad = _bucket(T, TEXT_BUCKETS)
        dev = self.device
        ids_arr = torch.tensor([ids + [0] * (Tpad - T)], device=dev)
        mask = torch.tensor([[False] * T + [True] * (Tpad - T)], device=dev)
        # activations follow the parameter dtype (bf16 after cast_floats);
        # the NSF source and the iSTFT head pin themselves to float32
        cdtype = self.bert_encoder.weight.dtype
        ref_s = torch.as_tensor(np.asarray(ref_s)).to(dev, cdtype)
        if ref_s.ndim == 1:
            ref_s = ref_s[None]
        samples_per_frame = self.decoder.generator.total_upsample * 2

        def source_noise():  # the same draws for every synthesis of this call
            if noise is not None:
                return noise
            return torch.Generator(device=dev).manual_seed(seed)

        with torch.inference_mode():
            pred_dur, d, t_en = self._frontend(ids_arr, mask, ref_s, float(speed))
            if fused_frames is not None:
                # synthesis before the durations reach the host
                num_frames = _bucket(fused_frames, FRAME_BUCKETS)
                audio = self._synthesize(d, t_en, pred_dur, ref_s, num_frames, source_noise())
            pred_dur_np = pred_dur.cpu().numpy()  # the durations reach the host
            total_frames = int(pred_dur_np.sum())
            if fused_frames is None or total_frames > num_frames:  # exact bucket
                num_frames = _bucket(total_frames, FRAME_BUCKETS)
                audio = self._synthesize(d, t_en, pred_dur, ref_s, num_frames, source_noise())
            audio_np = (audio[0, : total_frames * samples_per_frame].cpu().numpy()
                        .astype(np.float32) / 32767.0)
        if return_output:
            return self.Output(audio=audio_np, pred_dur=pred_dur_np[0][:T])
        return audio_np

    def batch_synthesize(self, phonemes_list, ref_s_list, speed: float = 1.0, seed: int = 0,
                         noise=None):
        """Several requests as ONE frontend and ONE synthesis (the serving
        path): rows share the text bucket of the longest and the frame
        bucket of the longest, the batch is padded to a power of two by
        repeating the last row. Returns one `Output` a request (audio
        trimmed to its own frames).

        Each row's sine-source noise is the draw a sequential call on that
        row makes (a generator seeded `seed`, at the row's own frame
        bucket; zeros past it), so a row in a group of its own frame bucket
        gets its sequential audio. `noise` = (rand_ini (Bpad, 9), normal
        (Bpad, L, 9)) replaces the draws."""
        B = len(phonemes_list)
        idseqs = []
        for ph in phonemes_list:
            ids = [i for i in (self.vocab.get(p) for p in ph) if i is not None]
            if len(ids) + 2 > self.context_length:
                raise ValueError(f"{len(ids)} phonemes exceed the context of "
                                 f"{self.context_length - 2}")
            idseqs.append([0, *ids, 0])
        Tpad = _bucket(max(len(r) for r in idseqs), TEXT_BUCKETS)
        Bpad = 1 << (B - 1).bit_length()
        rows = idseqs + [idseqs[-1]] * (Bpad - B)
        dev = self.device
        ids_arr = torch.tensor([r + [0] * (Tpad - len(r)) for r in rows], device=dev)
        mask = torch.tensor([[False] * len(r) + [True] * (Tpad - len(r)) for r in rows],
                            device=dev)
        refs = [np.asarray(r, np.float32).reshape(-1) for r in ref_s_list]
        refs = refs + [refs[-1]] * (Bpad - B)
        ref_s = torch.from_numpy(np.stack(refs)).to(dev, self.bert_encoder.weight.dtype)
        spf = self.decoder.generator.total_upsample * 2
        with torch.inference_mode():
            pred_dur, d, t_en = self._frontend(ids_arr, mask, ref_s, float(speed))
            pred_dur_np = pred_dur.cpu().numpy()  # the durations reach the host
            totals = pred_dur_np.sum(axis=1)
            num_frames = _bucket(int(totals.max()), FRAME_BUCKETS)
            if noise is None:
                noise = self._row_noise(totals, num_frames * spf, seed)
            audio = self._synthesize(d, t_en, pred_dur, ref_s, num_frames, noise)
            out = audio.cpu().numpy().astype(np.float32) / 32767.0
        return [self.Output(audio=out[i][: int(totals[i]) * spf],
                            pred_dur=pred_dur_np[i][: len(idseqs[i])])
                for i in range(B)]

    def _row_noise(self, totals, L: int, seed: int):
        """Per row, the sine source's draws of a sequential call on that row
        (`SineGen` draws rand_ini, then the normals at its frame bucket),
        zero past its bucket, stacked to (rows, L, dim)."""
        dim = self.decoder.generator.m_source.l_sin_gen.dim
        spf = self.decoder.generator.total_upsample * 2
        dev = self.device
        rand_ini = torch.empty(len(totals), dim, device=dev)
        normal = torch.zeros(len(totals), L, dim, device=dev)
        for i, total in enumerate(totals):
            own = _bucket(int(total), FRAME_BUCKETS) * spf
            gen = torch.Generator(device=dev).manual_seed(seed)
            rand_ini[i] = torch.randn(1, dim, generator=gen, device=dev)[0]
            normal[i, :own] = torch.randn(1, own, dim, generator=gen, device=dev)[0]
        return rand_ini, normal

    def make_batcher(self, **kwargs):
        """Serving batcher: fuses concurrent requests into one frontend and
        one synthesis (`serving.KokoroBatcher`)."""
        from ....serving import KokoroBatcher

        return KokoroBatcher(self, **kwargs)

    # ------------------------------------------------------------------

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def _get_pipeline(self, lang_code: str):
        if lang_code not in self._pipelines:
            from .pipeline import KokoroPipeline

            self._pipelines[lang_code] = KokoroPipeline(
                model=self, repo_id=self.repo_id or self.config.model_path or self.REPO_ID,
                lang_code=lang_code)
        return self._pipelines[lang_code]

    def generate(self, text: str, voice: Optional[str] = None, speed: float = 1.0,
                 lang_code: str = "a", split_pattern: str = r"\n+", **kwargs):
        """Text → one `GenerationResult` per segment, through the G2P
        pipeline and the voice pack `voice` (under `repo_id`/voices)."""
        pipeline = self._get_pipeline(lang_code)
        if voice is None:
            voice = "af_heart"
        start_time = time.time()
        for segment_idx, (graphemes, phonemes, audio) in enumerate(
                pipeline(text, voice=voice, speed=speed, split_pattern=split_pattern)):
            now = time.time()
            segment_time = now - start_time
            start_time = now
            samples = int(audio.shape[-1]) if audio is not None else 0
            if samples <= 0:
                raise RuntimeError("No audio generated")
            token_count = len(phonemes) if phonemes else 0
            sr = self.config.sample_rate
            audio_duration = samples / sr
            rtf = segment_time / audio_duration if audio_duration > 0 else 0
            yield GenerationResult(
                audio=np.asarray(audio).reshape(-1),
                samples=samples,
                sample_rate=sr,
                segment_idx=segment_idx,
                token_count=token_count,
                audio_duration=format_duration(audio_duration),
                real_time_factor=round(rtf, 2),
                prompt={"tokens": token_count,
                        "tokens-per-sec": (round(token_count / segment_time, 2)
                                           if segment_time > 0 else 0)},
                audio_samples={"samples": samples,
                               "samples-per-sec": (round(samples / segment_time, 2)
                                                   if segment_time > 0 else 0)},
                processing_time_seconds=segment_time,
                peak_memory_usage=0.0,
            )

    # ------------------------------------------------------------------
    # Checkpoint sanitize: torch layouts → the JAX package's, weight norm folded
    # ------------------------------------------------------------------

    def sanitize(self, weights: dict) -> dict:
        """A torch-layout Kokoro checkpoint → the JAX package's key names and
        layouts (`nn.load_weights` takes the result): weight_g / weight_v
        pairs folded, nn.LSTM keys and gamma / beta renamed, conv weights
        oriented by shape."""
        expected = jax_param_shapes(self)
        modules = dict(self.named_modules())
        weights = dict(weights)
        for gkey in [k for k in weights if k.endswith("weight_g")]:
            v = as_float32(weights[gkey[:-1] + "v"])
            g = as_float32(weights[gkey])
            norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            weights[gkey.rsplit(".", 1)[0] + ".weight"] = g * v / np.maximum(norm, 1e-12)
        out = {}
        for key, w in weights.items():
            if "position_ids" in key or key.endswith(("weight_g", "weight_v")):
                continue
            if not isinstance(w, torch.Tensor):
                w = np.asarray(w)
            suffix = next((s for s in _LSTM_KEYS if key.endswith(s)), None)
            if suffix is not None:
                out[key[: -len(suffix)] + _LSTM_KEYS[suffix]] = w
            elif key.endswith(".gamma"):
                out[key[: -len(".gamma")] + ".weight"] = w
            elif key.endswith(".beta"):
                out[key[: -len(".beta")] + ".bias"] = w
            elif key.endswith(".weight") and w.ndim == 3 and key in expected:
                out[key] = orient_to(w, expected[key],
                                     readings_of(modules[key.rpartition(".")[0]]))
            else:
                out[key] = w  # snake alphas keep their (1, C, 1) shape
        return out


def torch_checkpoint(model: Model) -> dict:
    """The model's weights as an upstream PyTorch Kokoro checkpoint holds
    them, the inverse of `Model.sanitize`: float32 numpy arrays, every
    convolution weight in torch's layout under weight norm (`weight_g` the
    norm over all axes but the first, `weight_v` the weight, so that
    sanitize's fold gives the weight back), nn.LSTM names, gamma / beta for
    the text encoder's layer norms, and ALBERT's `position_ids`."""
    to_torch = {v: k for k, v in _LSTM_KEYS.items()}
    modules = dict(model.named_modules())
    out = {"bert.embeddings.position_ids": np.arange(model.context_length)[None]}
    for key, p in model.named_parameters():
        owner, _, name = key.rpartition(".")
        mod = modules[owner]
        w = p.detach().to("cpu", torch.float32).numpy()
        lstm = next((s for s in to_torch if key.endswith("." + s)), None)
        if isinstance(mod, (Conv1d, ConvTranspose1d)) and name == "weight":
            out[key + "_g"] = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)),
                                                   keepdims=True))
            out[key + "_v"] = w
        elif lstm is not None:
            out[key[: -len(lstm)] + to_torch[lstm]] = w
        elif isinstance(mod, LayerNorm) and owner.startswith("text_encoder."):
            out[owner + (".gamma" if name == "weight" else ".beta")] = w
        else:
            out[key] = w
    return out
