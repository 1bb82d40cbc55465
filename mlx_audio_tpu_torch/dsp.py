"""Audio DSP front-end (counterpart of `mlx_audio_tpu/dsp.py`): Hann and
Hamming windows, STFT (centered and reflect-padded for Whisper, or uncentered
with a shorter window), ISTFT with the JAX module's window-sum semantics,
the htk or slaney mel filterbank, the Whisper-normalised log-mel, and the
Kaldi-compatible fbank with its deltas and mel banks, and the BS.1770-4
loudness meter (`integrated_loudness`, `normalize_loudness`).

The other windows and `BatchISTFT` are not ported yet.
`torch.fft.rfft` takes the place of the JAX module's DFT-by-matmul.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hanning", "hamming", "STR_TO_WINDOW_FN", "stft", "istft", "mel_filters",
           "log_mel_spectrogram", "compute_deltas_kaldi", "get_mel_banks_kaldi",
           "kaldi_dither", "compute_fbank_kaldi", "compute_fbank_kaldi_rows",
           "integrated_loudness", "normalize_loudness"]


@lru_cache(maxsize=None)
def _hanning_np(size: int, periodic: bool) -> np.ndarray:
    denom = size if periodic else size - 1
    n = np.arange(size)
    return (0.5 * (1 - np.cos(2 * np.pi * n / denom))).astype(np.float32)


def hanning(size: int, periodic: bool = False, device=None) -> torch.Tensor:
    return torch.from_numpy(_hanning_np(size, periodic)).to(device)


@lru_cache(maxsize=None)
def _hamming_np(size: int, periodic: bool) -> np.ndarray:
    denom = size if periodic else size - 1
    n = np.arange(size)
    return (0.54 - 0.46 * np.cos(2 * np.pi * n / denom)).astype(np.float32)


def hamming(size: int, periodic: bool = False, device=None) -> torch.Tensor:
    return torch.from_numpy(_hamming_np(size, periodic)).to(device)


STR_TO_WINDOW_FN = {"hann": hanning, "hanning": hanning, "hamming": hamming}


def _window_fn(name: str):
    fn = STR_TO_WINDOW_FN.get(name.lower())
    if fn is None:
        raise ValueError(f"Unknown window function: {name}")
    return fn


def _resolve_window(window, win_length: int, n_fft: int, device) -> torch.Tensor:
    """A named window of `win_length`, or the tensor given, zero-padded on
    the right to `n_fft` (as the JAX module pads, not centred)."""
    w = _window_fn(window)(win_length, device=device) if isinstance(window, str) else window
    if w.shape[0] < n_fft:
        w = F.pad(w, (0, n_fft - w.shape[0]))
    return w


def stft(x: torch.Tensor, n_fft: int = 800, hop_length: Optional[int] = None,
         window: Union[torch.Tensor, str] = "hann", win_length: Optional[int] = None,
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """STFT of the last axis → complex (..., num_frames, n_fft//2 + 1).
    `center` pads n_fft//2 on both sides, reflecting (`pad_mode`
    "reflect") or with zeros ("constant")."""
    if hop_length is None:
        hop_length = n_fft // 4
    w = _resolve_window(window, win_length or n_fft, n_fft, x.device)
    if center:
        pad = n_fft // 2
        if pad_mode not in ("reflect", "constant"):
            raise ValueError(f"pad_mode {pad_mode!r}: 'reflect' or 'constant'")
        if pad_mode == "reflect" and x.shape[-1] <= pad:
            raise ValueError(f"Input too short (length={x.shape[-1]}) to reflect-pad by {pad}")
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
        x = x.reshape(*lead, x.shape[-1])
    if x.shape[-1] < n_fft:
        raise ValueError(f"Input too short (length={x.shape[-1]}) for frame_length="
                         f"{n_fft} with hop={hop_length}.")
    frames = (x.unfold(-1, n_fft, hop_length) * w).float()
    return torch.fft.rfft(frames, dim=-1)


def _ola(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add the last two axes (..., num_frames, frame_length) →
    (..., (num_frames-1)*hop + frame_length). `F.fold` gathers each output
    sample from its frames, so the sum is deterministic on the card."""
    *batch, num_frames, frame_length = frames.shape
    t = (num_frames - 1) * hop + frame_length
    cols = frames.reshape(-1, num_frames, frame_length).transpose(1, 2)
    out = F.fold(cols, output_size=(1, t), kernel_size=(1, frame_length), stride=(1, hop))
    return out.reshape(*batch, t)


def istft(x: torch.Tensor, hop_length: Optional[int] = None,
          win_length: Optional[int] = None, window: Union[torch.Tensor, str] = "hann",
          center: bool = True, length: Optional[int] = None,
          normalized: bool = False) -> torch.Tensor:
    """Inverse STFT of complex (freq, num_frames), or batched (..., freq,
    num_frames), with the JAX module's semantics (not torch.istft's): the
    overlap-added window sum (Σw, or Σw² when `normalized`) is divided out
    wherever it exceeds 1e-10; `center` strips win_length//2 samples;
    `length` cuts or zero-pads the end."""
    if win_length is None:
        win_length = (x.shape[-2] - 1) * 2
    if hop_length is None:
        hop_length = win_length // 4
    if isinstance(window, str):
        w = _window_fn(window)(win_length + 1, device=x.device)[:-1]
    else:
        w = window
    if w.shape[0] < win_length:
        w = F.pad(w, (0, win_length - w.shape[0]))

    frames_time = torch.fft.irfft(x.transpose(-2, -1), dim=-1)  # (..., F, win)
    num_frames = frames_time.shape[-2]
    out = _ola((frames_time * w).float(), hop_length)
    window_norm = (w * w) if normalized else w
    wsum = _ola(window_norm.float().expand(num_frames, win_length), hop_length)
    out = torch.where(wsum > 1e-10, out / wsum, out)

    if center:
        end = None if length is None else win_length // 2 + length
        out = out[..., win_length // 2:end]
        if length is None:
            out = out[..., :-(win_length // 2)]
    elif length is not None:
        out = out[..., :length]
    if length is not None and out.shape[-1] < length:
        out = F.pad(out, (0, length - out.shape[-1]))
    return out


@lru_cache(maxsize=None)
def _mel_filters_np(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                    f_max: Optional[float] = None, norm: Optional[str] = None,
                    mel_scale: str = "htk") -> np.ndarray:
    """Triangular mel filterbank over [f_min, f_max] (default: up to
    Nyquist), shape (n_mels, n_fft//2 + 1), on the "htk" or "slaney" mel
    scale, with slaney area normalisation where `norm` is "slaney"
    (torchaudio's semantics, and the JAX module's)."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(freq: float) -> float:
        if mel_scale == "htk":
            return 2595.0 * math.log10(1.0 + freq / 700.0)
        if freq >= min_log_hz:
            return min_log_mel + math.log(freq / min_log_hz) / logstep
        return freq / f_sp

    def mel_to_hz(mels: np.ndarray) -> np.ndarray:
        if mel_scale == "htk":
            return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
        return np.where(
            mels >= min_log_mel,
            min_log_hz * np.exp(logstep * (mels - min_log_mel)),
            f_sp * mels,
        )

    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max or sample_rate / 2), n_mels + 2)
    f_pts = mel_to_hz(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.T.astype(np.float32)


def mel_filters(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                f_max: Optional[float] = None, norm: Optional[str] = None,
                mel_scale: str = "htk", device=None) -> torch.Tensor:
    """The JAX module's signature and defaults: htk scale, no norm. Whisper
    and Qwen3-TTS ask for slaney with slaney norm (librosa's), Vocos for
    the defaults, BiCodec for slaney from 10 Hz."""
    return torch.from_numpy(_mel_filters_np(sample_rate, n_fft, n_mels, f_min, f_max, norm,
                                            mel_scale)).to(device)


def log_mel_spectrogram(
    audio: torch.Tensor,
    n_mels: int = 80,
    n_fft: int = 400,
    hop_length: int = 160,
    sample_rate: int = 16000,
    padding: int = 0,
) -> torch.Tensor:
    """Whisper-style log-mel: log10(clip(mel @ |stft|^2)), normalised.

    audio (..., N) → (..., frames, n_mels). The dynamic-range clip takes the
    max over each signal's own spectrogram, so a batch of chunks gives each
    row what the single-chunk call would."""
    if padding > 0:
        audio = F.pad(audio, (0, padding))
    window = hanning(n_fft + 1, periodic=False, device=audio.device)[:-1]
    spec = stft(audio, n_fft, hop_length, window=window)
    magnitudes = spec[..., :-1, :].abs() ** 2  # drop the last frame, as whisper
    fb = mel_filters(sample_rate, n_fft, n_mels, norm="slaney", mel_scale="slaney",
                     device=audio.device)
    mel_spec = torch.matmul(magnitudes, fb.T)
    log_spec = torch.log10(torch.clamp(mel_spec, min=1e-10))
    row_max = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, row_max - 8.0)
    return (log_spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# Kaldi-compatible features
# ---------------------------------------------------------------------------


def compute_deltas_kaldi(specgram: torch.Tensor, win_length: int = 5) -> torch.Tensor:
    """Delta coefficients d_t = Σ n (c_{t+n} − c_{t−n}) / (2 Σ n²) over the
    last (time) axis, the edges padded by repetition."""
    if win_length < 3:
        raise ValueError(f"win_length should be >= 3, got {win_length}")
    n = (win_length - 1) // 2
    denom = float(n * (n + 1) * (2 * n + 1)) / 3.0
    T = specgram.shape[-1]
    idx = torch.arange(-n, T + n, device=specgram.device).clamp(0, T - 1)
    padded = specgram[..., idx]
    out = torch.zeros_like(specgram)
    for k in range(-n, n + 1):
        if k:
            out = out + k * padded[..., k + n:k + n + T]
    return out / denom


def _next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


@lru_cache(maxsize=None)
def get_mel_banks_kaldi(num_bins: int, window_length_padded: int, sample_freq: float,
                        low_freq: float, high_freq: float):
    """Kaldi mel filterbank → (bins (num_bins, n_fft/2), center_freqs), as
    numpy float32."""
    if num_bins <= 3:
        raise ValueError("Must have at least 3 mel bins")
    if window_length_padded % 2:
        raise ValueError(f"window_length_padded {window_length_padded} is odd")
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq += nyquist
    if not (0.0 <= low_freq < nyquist and 0.0 < high_freq <= nyquist):
        raise ValueError(f"bad band [{low_freq}, {high_freq}] for nyquist {nyquist}")

    fft_bin_width = sample_freq / window_length_padded
    mel_low = 1127.0 * math.log(1.0 + low_freq / 700.0)
    mel_high = 1127.0 * math.log(1.0 + high_freq / 700.0)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    center_freqs = 700.0 * (np.exp(center_mel / 1127.0) - 1.0)
    mel = (1127.0 * np.log(1.0 + fft_bin_width * np.arange(num_fft_bins) / 700.0))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    bins = np.maximum(0.0, np.minimum(up_slope, down_slope))
    return bins.astype(np.float32), center_freqs.squeeze().astype(np.float32)


def kaldi_dither(shape, device) -> torch.Tensor:
    """The fbank's dither draw: standard normal noise from a generator
    seeded 0 on `device`, drawn anew for each call, so that every chunk of
    one length gets the same draw (as the JAX module's PRNGKey(0) does).
    The numbers differ from JAX's, and between the CPU and the card."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return torch.randn(shape, generator=gen, device=device)


def compute_fbank_kaldi(
    waveform: torch.Tensor,
    sample_rate: int = 48000,
    win_len: int = 1920,
    win_inc: int = 384,
    num_mels: int = 60,
    win_type: str = "hamming",
    preemphasis: float = 0.97,
    dither: float = 1.0,
    snip_edges: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kaldi-compatible log mel-filterbank features → (time, num_mels).

    With `dither` != 0, `dither · noise` is added to the frames; `noise`
    (frames, win_len) defaults to `kaldi_dither`'s draw."""
    if waveform.dim() == 2:
        waveform = waveform[0]
    window_shift, window_size = win_inc, win_len

    num_samples = waveform.shape[0]
    if snip_edges:
        if num_samples < window_size:
            return waveform.new_zeros((0, num_mels))
        frames = waveform.unfold(0, window_size, window_shift)
    else:
        m = (num_samples + (window_shift // 2)) // window_shift
        pad = window_size // 2 - window_shift // 2
        if pad > 0:
            left = waveform[1:pad + 1].flip(0)
            right = waveform[-pad:].flip(0) if pad > 1 else waveform[1:].flip(0)
            waveform = torch.cat([left, waveform, right])
        else:
            waveform = torch.cat([waveform[-pad:], waveform.flip(0)])
        frames = waveform.unfold(0, window_size, window_shift)[:m]

    return _fbank_of_frames(frames, sample_rate, num_mels, win_type, preemphasis, dither,
                            low_freq, high_freq, noise)


def compute_fbank_kaldi_rows(
    waveforms: torch.Tensor,
    sample_rate: int = 48000,
    win_len: int = 1920,
    win_inc: int = 384,
    num_mels: int = 60,
    win_type: str = "hamming",
    preemphasis: float = 0.97,
    dither: float = 1.0,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`compute_fbank_kaldi` (snip_edges) of each row of waveforms (B, T) →
    (B, time, num_mels), as one batched computation. Every row takes the
    same dither: `noise` (frames, win_len), by default `kaldi_dither`'s draw
    for one row, which is what the row alone would take."""
    if waveforms.shape[-1] < win_len:
        return waveforms.new_zeros((waveforms.shape[0], 0, num_mels))
    frames = waveforms.unfold(-1, win_len, win_inc)
    return _fbank_of_frames(frames, sample_rate, num_mels, win_type, preemphasis, dither,
                            low_freq, high_freq, noise)


def _fbank_of_frames(frames, sample_rate, num_mels, win_type, preemphasis, dither,
                     low_freq, high_freq, noise):
    """Log mel-filterbank of framed samples (..., time, window_size)."""
    window_size = frames.shape[-1]
    padded_window_size = _next_power_of_2(window_size)
    frames = frames.float()
    if dither != 0.0:
        if noise is None:
            noise = kaldi_dither(frames.shape[-2:], frames.device)
        frames = frames + dither * noise

    frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        frames = torch.cat([frames[..., :1], frames[..., 1:] - preemphasis * frames[..., :-1]],
                           dim=-1)

    n = np.arange(window_size)
    if win_type == "hamming":
        window = 0.54 - 0.46 * np.cos(2 * np.pi * n / (window_size - 1))
    elif win_type == "hanning":
        window = 0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))
    elif win_type == "povey":
        window = (0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))) ** 0.85
    else:
        window = np.ones(window_size)
    frames = frames * torch.from_numpy(window.astype(np.float32)).to(frames.device)

    spectrum = torch.fft.rfft(frames, n=padded_window_size, dim=-1).abs() ** 2.0
    mel_banks, _ = get_mel_banks_kaldi(num_mels, padded_window_size, float(sample_rate),
                                       low_freq, high_freq)
    mel_banks = F.pad(torch.from_numpy(mel_banks).to(frames.device), (0, 1))
    feats = torch.matmul(spectrum, mel_banks.T)
    return torch.log(torch.clamp(feats, min=1e-8))


# ---------------------------------------------------------------------------
# Loudness (BS.1770-4), Chatterbox-Turbo's normalisation of its reference
# clip: the JAX package's dependency-free meter, copied (host numpy and
# scipy; the K-weighting biquads designed for any sample rate)
# ---------------------------------------------------------------------------

def _k_weighting_coeffs(sample_rate: float):
    """Biquad coefficients for the two K-weighting stages (high shelf +
    high pass), designed parametrically so any sample rate works."""
    import math as _math

    # bilinear-transform designs that reproduce the standard's 48 kHz
    # coefficient tables exactly and generalize to any sample rate
    def shelf(fc, q, gain_db):
        K = _math.tan(_math.pi * fc / sample_rate)
        Vh = 10.0 ** (gain_db / 20.0)
        Vb = Vh ** 0.4996667741545416
        d = 1.0 + K / q + K * K
        b = [(Vh + Vb * K / q + K * K) / d,
             2.0 * (K * K - Vh) / d,
             (Vh - Vb * K / q + K * K) / d]
        a = [1.0, 2.0 * (K * K - 1.0) / d, (1.0 - K / q + K * K) / d]
        return b, a

    def highpass(fc, q):
        K = _math.tan(_math.pi * fc / sample_rate)
        d = 1.0 + K / q + K * K
        b = [1.0, -2.0, 1.0]
        a = [1.0, 2.0 * (K * K - 1.0) / d, (1.0 - K / q + K * K) / d]
        return b, a

    stage1 = shelf(1681.974450955533, 0.7071752369554196, 3.999843853973347)
    stage2 = highpass(38.13547087602444, 0.5003270373238773)
    return stage1, stage2


def integrated_loudness(wav, sample_rate: int) -> float:
    """BS.1770-4 gated integrated loudness (LUFS) of a mono/multi-channel
    host array shaped (T,) or (T, C)."""
    import numpy as _np
    from scipy.signal import lfilter

    x = _np.asarray(wav, _np.float64)
    if x.ndim == 1:
        x = x[:, None]
    (b1, a1), (b2, a2) = _k_weighting_coeffs(float(sample_rate))
    y = lfilter(b2, a2, lfilter(b1, a1, x, axis=0), axis=0)

    block = int(round(0.400 * sample_rate))
    step = int(round(0.100 * sample_rate))
    if y.shape[0] < block:
        return -float("inf")
    n_blocks = 1 + (y.shape[0] - block) // step
    # per-block mean square, per channel, then channel-weighted sum
    # (weights 1.0 for up to two channels; surround weighting out of scope)
    z = _np.empty((n_blocks, y.shape[1]))
    sq = y * y
    csum = _np.concatenate([_np.zeros((1, y.shape[1])), _np.cumsum(sq, axis=0)])
    for j in range(n_blocks):
        s = j * step
        z[j] = (csum[s + block] - csum[s]) / block
    zj = z.sum(axis=1)
    with _np.errstate(divide="ignore"):
        lj = -0.691 + 10.0 * _np.log10(zj)
    keep = lj > -70.0
    if not keep.any():
        return -float("inf")
    rel_gate = -0.691 + 10.0 * _np.log10(zj[keep].mean()) - 10.0
    keep &= lj > rel_gate
    if not keep.any():
        return -float("inf")
    return float(-0.691 + 10.0 * _np.log10(zj[keep].mean()))


def normalize_loudness(wav, sample_rate: int, target_lufs: float = -27.0):
    """Scale `wav` so its integrated loudness hits `target_lufs`; returns the
    input unchanged when loudness is unmeasurable (silence / too short)."""
    import math as _math

    import numpy as _np

    loudness = integrated_loudness(wav, sample_rate)
    if not _math.isfinite(loudness):
        return wav
    gain = 10.0 ** ((target_lufs - loudness) / 20.0)
    if not _math.isfinite(gain) or gain <= 0.0:
        return wav
    return _np.asarray(wav) * gain
