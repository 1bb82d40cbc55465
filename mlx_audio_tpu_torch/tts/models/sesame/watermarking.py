"""Audio watermarking for Sesame/CSM output (counterpart of
`mlx_audio_tpu/tts/models/sesame/watermarking.py`, a host copy in numpy):
`load_watermarker`, `watermark`, `verify`, `CSM_1B_GH_WATERMARK` and
`check_audio_from_file`, carrying a 5-byte message through the audio.

The JAX package's own scheme, not the reference's `silentcipher` model:
each of the 40 message bits modulates the log-magnitude of mid-band STFT
bins with a seeded ±1 chip pattern, and decoding correlates the received
log-magnitude against the same chips. Embedding runs at 44.1 kHz. The
resampling to and from it is the port's `utils.resample_audio` (scipy's
`resample_poly`); the JAX package takes its native C resampler where that
is built, whose samples differ from scipy's in the last bits, so the two
packages' watermarked audio agree to ~1e-6 of full scale, not bit for bit.

Not cryptographically secure, as the public reference key says itself.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# This watermark key is public, it is not secure (reference watermarking.py:11).
CSM_1B_GH_WATERMARK = [212, 211, 146, 56, 201]

_N_FFT = 1024
_HOP = 512
_WM_SR = 44100  # embed domain, matching the reference's 44.1k model
_BAND_LO_HZ = 1000.0
_BAND_HI_HZ = 8000.0
_N_BITS = 40  # 5 bytes
_ALPHA = 0.2  # per-slot excursion in log-magnitude (~1.7 dB)
_SLOT_FRACTION = 2  # 1/2 of band slots carry chips; the rest stay null
_CHIP_PERIOD = 64  # chip pattern repeats every 64 frames (alignment-free-ish)
# Null sets land at mean|z| ≈ 0.8 (half-normal) with sem ≈ 0.1 over 40 bits;
# watermarked audio measures ≥ 4 — threshold 2.0 sits >10σ from the null.
_Z_THRESHOLD = 2.0  # mean |z| for "a watermark is present"


@dataclass
class Watermarker:
    """PRNG-keyed chip bank; stateless stand-in for silentcipher's model."""

    seed: int = 0xC5A11B

    def chips(self, n_bins: int) -> np.ndarray:
        """(2*bits, period, band_bins) sparse ±1 chip patterns.

        The (period × band) grid is partitioned into 2*_N_BITS disjoint slot
        sets with random signs. Sets 0.._N_BITS-1 carry the message (each bin
        is touched by at most ONE bit, so the embedded excursion is a single
        ±alpha in log-magnitude — imperceptible yet cleanly separable).
        Sets _N_BITS..2*_N_BITS-1 are never embedded: at decode they provide
        a matched NULL distribution for self-calibrated noise estimation."""
        lo = int(np.ceil(_BAND_LO_HZ / _WM_SR * _N_FFT))
        hi = int(np.floor(_BAND_HI_HZ / _WM_SR * _N_FFT))
        hi = min(hi, n_bins - 1)
        rng = np.random.default_rng(self.seed)
        assign = rng.integers(0, _N_BITS * _SLOT_FRACTION,
                              size=(_CHIP_PERIOD, hi - lo))
        sign = (2 * rng.integers(0, 2, size=(_CHIP_PERIOD, hi - lo)) - 1)
        n_sets = _N_BITS * _SLOT_FRACTION
        chips = (sign[None] * (assign[None] == np.arange(n_sets)[:, None,
                                                          None]))
        return chips.astype(np.float32), lo, hi


def load_watermarker() -> Watermarker:
    return Watermarker()


def resample_audio(audio: np.ndarray, orig_sr: int,
                   target_sr: int) -> np.ndarray:
    from ....utils import resample_audio as _resample

    return _resample(np.asarray(audio, np.float32), orig_sr, target_sr)


def _stft(x: np.ndarray) -> np.ndarray:
    win = np.hanning(_N_FFT + 1)[:-1].astype(np.float32)
    n = 1 + max(0, (len(x) - _N_FFT)) // _HOP
    frames = np.lib.stride_tricks.as_strided(
        np.ascontiguousarray(x, dtype=np.float32),
        shape=(n, _N_FFT), strides=(x.itemsize * _HOP, x.itemsize))
    return np.fft.rfft(frames * win, axis=-1)


def _istft(spec: np.ndarray, length: int) -> np.ndarray:
    win = np.hanning(_N_FFT + 1)[:-1].astype(np.float32)
    frames = np.fft.irfft(spec, n=_N_FFT, axis=-1) * win
    out = np.zeros(length + _N_FFT, np.float64)
    norm = np.zeros(length + _N_FFT, np.float64)
    w2 = win * win
    for i in range(frames.shape[0]):
        s = i * _HOP
        out[s: s + _N_FFT] += frames[i]
        norm[s: s + _N_FFT] += w2
    out = out / np.maximum(norm, 1e-8)
    return out[:length].astype(np.float32)


def _key_bits(watermark_key: List[int]) -> np.ndarray:
    b = np.asarray(watermark_key, np.uint8)
    return np.unpackbits(b)[:_N_BITS].astype(np.float32) * 2 - 1  # ±1


def watermark(watermarker: Watermarker, audio_array, sample_rate: int,
              watermark_key: List[int]):
    """Embed `watermark_key` (5 bytes) into audio; returns watermarked audio
    at the input sample rate (reference watermarking.py:37-57)."""
    x = np.asarray(audio_array, np.float32).reshape(-1)
    orig_len = len(x)
    x44 = x if sample_rate == _WM_SR else resample_audio(
        x, sample_rate, _WM_SR)

    # Pad so every sample has full hann² window coverage: without this the
    # OLA normalization at the edges amplifies the first/last partial frames.
    pad = _N_FFT
    x44p = np.pad(x44, (pad, pad), mode="reflect")

    spec = _stft(x44p)
    n_frames, n_bins = spec.shape
    chips, lo, hi = watermarker.chips(n_bins)
    bits = _key_bits(watermark_key)

    # carrier(t, f) = alpha * sum_i bit_i * chip_i(t mod P, f)
    # (only the first _N_BITS slot sets are embedded; the rest stay null)
    # Short clips have fewer chip instances per bit, so scale alpha up to
    # hold detection power roughly constant (louder watermark, like
    # silentcipher's fixed message-SDR target); >=3 s clips use base alpha.
    alpha = _ALPHA * max(1.0, float(np.sqrt(256.0 / max(n_frames, 8))))
    carrier = np.einsum("i,ipf->pf", bits, chips[:_N_BITS]) * alpha
    t_idx = np.arange(n_frames) % _CHIP_PERIOD
    mag = np.abs(spec)
    phase = np.angle(spec)
    band = mag[:, lo:hi]
    band = np.exp(np.log(np.maximum(band, 1e-10)) + carrier[t_idx])
    mag[:, lo:hi] = band
    out44 = _istft(mag * np.exp(1j * phase), len(x44p))[pad: pad + len(x44)]

    if sample_rate != _WM_SR:
        out = resample_audio(out44, _WM_SR, sample_rate)
        out = out[:orig_len]
        if len(out) < orig_len:
            out = np.pad(out, (0, orig_len - len(out)))
        return out.astype(np.float32)
    return out44


def _decode(watermarker: Watermarker, audio44: np.ndarray
            ) -> Tuple[bool, List[int]]:
    # Same reflect padding as `watermark` keeps the chip phase (frame index
    # mod _CHIP_PERIOD) aligned between embed and decode.
    spec = _stft(np.pad(audio44, (_N_FFT, _N_FFT), mode="reflect"))
    n_frames, n_bins = spec.shape
    if n_frames < 2:
        return False, []
    chips, lo, hi = watermarker.chips(n_bins)
    logmag = np.log(np.maximum(np.abs(spec[:, lo:hi]), 1e-10))
    # two-way centering: remove the audio's spectral envelope (per-bin mean)
    # and broadband loudness variation (per-frame mean)
    logmag = logmag - logmag.mean(axis=0, keepdims=True)
    logmag = logmag - logmag.mean(axis=1, keepdims=True)
    t_idx = np.arange(n_frames) % _CHIP_PERIOD
    tiled = chips[:, t_idx, :]  # (sets, frames, band)
    # corr_i = mean over set i's slots of logmag * sign
    corr = np.einsum("tf,itf->i", logmag, tiled)
    nnz = np.abs(tiled).sum(axis=(1, 2)) + 1e-9  # slots per set
    corr = corr / np.sqrt(nnz)
    # the never-embedded null sets give a matched noise scale
    noise = np.std(corr[_N_BITS:]) + 1e-9
    z = corr[:_N_BITS] / noise
    present = bool(np.mean(np.abs(z)) > _Z_THRESHOLD)
    bits = (z > 0).astype(np.uint8)
    message = list(np.packbits(bits)[: _N_BITS // 8])
    return present, [int(m) for m in message]


def verify(watermarker: Watermarker, watermarked_audio, sample_rate: int,
           watermark_key: List[int]) -> bool:
    """True iff audio carries this exact key (reference watermarking.py:60-81)."""
    x = np.asarray(watermarked_audio, np.float32).reshape(-1)
    x44 = x if sample_rate == _WM_SR else resample_audio(
        x, sample_rate, _WM_SR)
    present, message = _decode(watermarker, x44)
    return present and message == list(watermark_key)


def check_audio_from_file(audio_path: str) -> None:
    from ....audio_io import read as audio_read

    audio, sr = audio_read(audio_path)
    audio = np.asarray(audio, np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=-1)
    ok = verify(load_watermarker(), audio, int(sr), CSM_1B_GH_WATERMARK)
    print(f"{'Watermarked' if ok else 'Not watermarked'}: {audio_path}")


def cli_check_audio() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--audio_path", type=str, required=True)
    check_audio_from_file(parser.parse_args().audio_path)


if __name__ == "__main__":
    cli_check_audio()
