"""The port's Whisper log-mel front-end against the JAX package's.

f32 bar 1e-4: torch.fft.rfft replaces the JAX module's DFT-by-matmul, so
the power spectrum differs by float32 rounding (~1e-6 relative), which
log10 turns into < 1e-6 absolute, far inside the bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu import dsp as jdsp
from mlx_audio_tpu_torch import dsp

ATOL = 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_one_second(n_mels):
    x = (np.random.default_rng(n_mels).standard_normal(16000) * 0.1).astype(np.float32)
    ref = np.asarray(jdsp.log_mel_spectrogram(jnp.asarray(x), n_mels=n_mels))
    out = dsp.log_mel_spectrogram(torch.from_numpy(x), n_mels=n_mels).numpy()
    assert out.shape == ref.shape == (100, n_mels)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_batch_takes_max_per_row(n_mels):
    """Three 30 s chunks, the middle one near-silent: each row is clipped
    against its own max, as the JAX model's vmap over chunks does."""
    rng = np.random.default_rng(7)
    chunks = (rng.standard_normal((3, 480000)) * 0.05).astype(np.float32)
    chunks[1] *= 1e-4  # 80 dB down: a batch-wide max would clip half of it
    ref = np.asarray(jax.vmap(
        lambda c: jdsp.log_mel_spectrogram(c, n_mels=n_mels))(jnp.asarray(chunks)))
    out = dsp.log_mel_spectrogram(torch.from_numpy(chunks), n_mels=n_mels).numpy()
    assert out.shape == (3, 3000, n_mels)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    alone = dsp.log_mel_spectrogram(torch.from_numpy(chunks[1]), n_mels=n_mels)
    np.testing.assert_allclose(out[1], alone.numpy(), atol=1e-6)


def test_mel_filters_and_window_match():
    np.testing.assert_array_equal(
        dsp.mel_filters(16000, 400, 80).numpy(),
        np.asarray(jdsp.mel_filters(16000, 400, 80, norm="slaney", mel_scale="slaney")))
    np.testing.assert_array_equal(dsp.hanning(401).numpy(),
                                  np.asarray(jdsp.hanning(401)))


def test_stft_matches():
    x = np.random.default_rng(1).standard_normal((2, 4000)).astype(np.float32)
    ref = np.asarray(jdsp.stft(jnp.asarray(x), 400, 160))
    out = dsp.stft(torch.from_numpy(x), 400, 160).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-4)
