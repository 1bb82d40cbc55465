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
        dsp.mel_filters(16000, 400, 80, norm="slaney", mel_scale="slaney").numpy(),
        np.asarray(jdsp.mel_filters(16000, 400, 80, norm="slaney", mel_scale="slaney")))
    np.testing.assert_array_equal(dsp.hanning(401).numpy(),
                                  np.asarray(jdsp.hanning(401)))


def test_stft_matches():
    x = np.random.default_rng(1).standard_normal((2, 4000)).astype(np.float32)
    ref = np.asarray(jdsp.stft(jnp.asarray(x), 400, 160))
    out = dsp.stft(torch.from_numpy(x), 400, 160).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-4)


# ---- MossFormer2-SE's front-end: uncentered STFT, ISTFT, Kaldi fbank ----
# f32 bars: 1e-4 on log features and spectra of O(1) inputs (two FFT
# libraries, ~1e-6 relative); 1e-5 on waveforms out of the ISTFT.


@pytest.mark.parametrize("window", ["hamming", "tensor"])
def test_stft_uncentered_short_window(window):
    x = np.random.default_rng(2).standard_normal((2, 5000)).astype(np.float32)
    w_np = np.array(jdsp.hanning(400))
    jw = "hamming" if window == "hamming" else jnp.asarray(w_np)
    pw = "hamming" if window == "hamming" else torch.from_numpy(w_np)
    ref = np.asarray(jdsp.stft(jnp.asarray(x), 512, 128, win_length=400, window=jw,
                               center=False))
    out = dsp.stft(torch.from_numpy(x), 512, 128, window=pw, win_length=400,
                   center=False).numpy()
    assert out.shape == ref.shape == (2, 36, 257)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize(
    "center,normalized,length",
    [(False, False, 4000), (False, False, 5000), (True, False, None), (True, True, 3000),
     (False, True, None)],
    ids=["cut", "zero_padded", "centered", "centered_normalized_cut", "normalized"])
def test_istft_matches(center, normalized, length):
    rng = np.random.default_rng(3)
    spec = (rng.standard_normal((2, 161, 40)) + 1j * rng.standard_normal((2, 161, 40))
            ).astype(np.complex64)
    w = np.array(jdsp.hamming(320))
    kw = dict(hop_length=80, win_length=320, center=center, length=length,
              normalized=normalized)
    ref = np.asarray(jdsp.istft(jnp.asarray(spec), window=jnp.asarray(w), **kw))
    out = dsp.istft(torch.from_numpy(spec), window=torch.from_numpy(w), **kw).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_istft_of_the_uncentered_stft():
    """MossFormer2-SE's round trip: 1920-point Hamming frames at hop 384,
    uncentered. Dividing by Σw (the model's setting) matches the JAX
    module; dividing by Σw² gives the input back."""
    x = np.random.default_rng(4).standard_normal(48000).astype(np.float32)
    w = dsp.hamming(1920)
    spec = dsp.stft(torch.from_numpy(x), 1920, 384, window=w, win_length=1920, center=False)
    kw = dict(hop_length=384, win_length=1920, center=False, length=48000)
    y = dsp.istft(spec.T, window=w, **kw).numpy()
    ref = np.asarray(jdsp.istft(jnp.asarray(spec.T.numpy()), window=jnp.asarray(w.numpy()),
                                **kw))
    np.testing.assert_allclose(y, ref, atol=1e-5)
    back = dsp.istft(spec.T, window=w, normalized=True, **kw).numpy()
    np.testing.assert_allclose(back, x, atol=1e-4)


def test_kaldi_mel_banks_and_window_match():
    bins, centers = dsp.get_mel_banks_kaldi(60, 2048, 48000.0, 20.0, 0.0)
    jbins, jcenters = jdsp.get_mel_banks_kaldi(60, 2048, 48000.0, 20.0, 0.0)
    np.testing.assert_array_equal(bins, jbins)
    np.testing.assert_array_equal(centers, jcenters)
    np.testing.assert_array_equal(dsp.hamming(1920).numpy(), np.asarray(jdsp.hamming(1920)))
    with pytest.raises(ValueError, match="3 mel bins"):
        dsp.get_mel_banks_kaldi(3, 2048, 48000.0, 20.0, 0.0)


@pytest.mark.parametrize("win", [3, 5, 9])
def test_deltas_match(win):
    x = np.random.default_rng(5).standard_normal((3, 60, 37)).astype(np.float32)
    ref = np.asarray(jdsp.compute_deltas_kaldi(jnp.asarray(x), win))
    out = dsp.compute_deltas_kaldi(torch.from_numpy(x), win).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize(
    "dither,snip_edges,kw",
    [(1.0, True, {}), (0.0, True, {}), (1.0, False, {}),
     (0.0, False, dict(win_len=400, win_inc=160, num_mels=23, sample_rate=16000,
                       win_type="povey"))],
    ids=["dither_noise_given", "no_dither", "no_snip_edges", "no_snip_povey_16k"])
def test_fbank_kaldi_matches(dither, snip_edges, kw):
    """The JAX function draws its dither from PRNGKey(0); the port takes that
    very draw through `noise`."""
    x = (np.random.default_rng(6).standard_normal(30000) * 3000).astype(np.float32)
    ref = np.asarray(jdsp.compute_fbank_kaldi(jnp.asarray(x), dither=dither,
                                              snip_edges=snip_edges, **kw))
    win = kw.get("win_len", 1920)
    noise = jax.random.normal(jax.random.PRNGKey(0), (ref.shape[0], win))
    out = dsp.compute_fbank_kaldi(torch.from_numpy(x), dither=dither, snip_edges=snip_edges,
                                  noise=torch.from_numpy(np.array(noise)), **kw).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_fbank_kaldi_dither_is_one_draw_per_length():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(20000).astype(np.float32))
    a, b = dsp.compute_fbank_kaldi(x), dsp.compute_fbank_kaldi(x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), dsp.compute_fbank_kaldi(x, dither=0.0).numpy())
    assert dsp.compute_fbank_kaldi(x[:1000]).shape == (0, 60)
