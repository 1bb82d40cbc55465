"""The port's audio I/O (`audio_io`, `utils.load_audio` / `resample_audio`,
`stt.utils.load_audio`, `ensure_waveform`) against the JAX package's, on
seeded numpy signals.

Decoding is exact: the JAX package decodes WAV through its native C library
where it can, the port in numpy, and both convert every sample format to the
same float32. Encoding is byte for byte. Resampling differs in route: the
JAX package's first choice is its native polyphase resampler, the port takes
scipy's `resample_poly` (the JAX package's second route); the two sum the
same Kaiser filter in other orders, ~5e-7 apart on signals within ±1, held
here at RESAMPLE_ATOL = 2e-6.
"""

import io
import struct
import sys

import numpy as np
import pytest

from mlx_audio_tpu import audio_io as jio
from mlx_audio_tpu import utils as jutils
from mlx_audio_tpu.stt import utils as jstt
from mlx_audio_tpu.stt.models.base import ensure_waveform as jensure
from mlx_audio_tpu_torch import audio_io as pio
from mlx_audio_tpu_torch import utils as putils
from mlx_audio_tpu_torch.stt import utils as pstt
from mlx_audio_tpu_torch.stt.models.base import ensure_waveform as pensure

RESAMPLE_ATOL = 2e-6


def _signal(n, channels, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if channels == 1 else (n, channels)
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def _extensible(x, sr, bits, sub_tag):
    """A WAVE_FORMAT_EXTENSIBLE file: the 40-byte fmt chunk whose sub-format
    GUID starts with `sub_tag` (1 PCM, 3 IEEE float)."""
    channels = 1 if x.ndim == 1 else x.shape[1]
    if sub_tag == 3:
        payload = x.astype("<f4").tobytes()
    elif bits == 16:
        payload = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2").tobytes()
    else:  # 24-bit
        v = np.clip(np.round(x.astype(np.float64) * (1 << 23)), -(1 << 23),
                    (1 << 23) - 1).astype(np.int32).reshape(-1)
        payload = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(
            np.uint8).tobytes()
    block = channels * bits // 8
    guid = struct.pack("<H", sub_tag) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sr, sr * block, block, bits, 22, bits,
                      0) + guid
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + \
        struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT"])
def test_read_matches_jax(tmp_path, subtype, channels):
    path = tmp_path / "x.wav"
    jio.write(path, _signal(1001, channels), 22050, subtype=subtype)
    ref, ref_sr = jio.read(path)
    out, sr = pio.read(path)
    assert sr == ref_sr == 22050 and out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(pio.read(path, dtype="int16")[0], jio.read(path, dtype="int16")[0])
    assert pio._decode_wav(path.read_bytes())[2] == subtype


@pytest.mark.parametrize("bits,sub_tag", [(16, 1), (24, 1), (32, 3)])
def test_read_extensible_matches_jax(bits, sub_tag):
    data = _extensible(_signal(777, 2, seed=3), 48000, bits, sub_tag)
    ref, ref_sr = jio.read(data)
    out, sr = pio.read(data)
    assert sr == ref_sr == 48000 and out.shape == ref.shape == (777, 2)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT"])
def test_write_is_byte_identical(tmp_path, subtype, channels):
    x = _signal(999, channels, seed=1) * 1.2  # some samples clip
    jio.write(tmp_path / "j.wav", x, 16000, subtype=subtype)
    pio.write(tmp_path / "p.wav", x, 16000, subtype=subtype)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_write_int16_and_encode_bytes(tmp_path):
    x = np.random.default_rng(2).integers(-32768, 32767, 501).astype(np.int16)
    jio.write(tmp_path / "j.wav", x, 24000)
    pio.sf_write(tmp_path / "p.wav", x, 24000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    np.testing.assert_array_equal(pio.sf_read(tmp_path / "p.wav", dtype="int16")[0], x)
    for fmt in ("wav", "pcm"):
        assert pio.encode_bytes(x, 24000, fmt) == jio.encode_bytes(x, 24000, fmt)


@pytest.mark.parametrize("head,fmt", [
    (b"RIFF\x00\x00\x00\x00WAVEfmt ", "wav"), (b"fLaC" + bytes(8), "flac"),
    (b"OggS" + bytes(8), "ogg"), (b"ID3\x03" + bytes(8), "mp3"),
    (b"\xff\xfb\x90\x00" + bytes(8), "mp3"), (b"\x00\x00\x00\x20ftypM4A ", "m4a"),
    (b"hello world!", None), (b"short", None)])
def test_detect_format(head, fmt):
    assert pio.detect_format(head) == jio.detect_format(head) == fmt


def test_ffmpeg_absent_raises(monkeypatch):
    """A compressed format without ffmpeg on PATH: a clear error, in both
    directions."""
    monkeypatch.setattr(pio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="requires ffmpeg"):
        pio.read(b"fLaC" + bytes(64))
    with pytest.raises(RuntimeError, match="requires ffmpeg"):
        pio.encode_bytes(np.zeros(8, np.float32), 16000, "mp3")


def test_malformed_wav_raises():
    with pytest.raises(ValueError, match="missing fmt or data"):
        pio.read(b"RIFF\x04\x00\x00\x00WAVE")


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("orig", [44100, 24000, 48000])
def test_resample_matches_jax(orig, channels):
    x = _signal(orig * 2 + 17, channels, seed=orig)
    ref = jutils.resample_audio(x, orig, 16000)
    out = putils.resample_audio(x, orig, 16000)
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=RESAMPLE_ATOL)
    assert putils.resample_audio(x, 16000, 16000) is x


def test_load_audio_downmix_and_resample(tmp_path):
    """A 44.1 kHz stereo PCM-16 file: mono by the channels' mean, then
    16 kHz; the options (length, volume normalisation) as in the JAX
    package."""
    path = tmp_path / "s.wav"
    pio.write(path, _signal(44100, 2, seed=5), 44100)
    for kw in ({}, {"length": 20000}, {"length": 9000}, {"volume_normalize": True}):
        ref = jutils.load_audio(path, sample_rate=16000, **kw)
        out = putils.load_audio(path, sample_rate=16000, **kw)
        assert out.shape == ref.shape and out.dtype == ref.dtype, kw
        np.testing.assert_allclose(out, ref, rtol=0, atol=RESAMPLE_ATOL, err_msg=str(kw))
    # without resampling the downmix is exact
    np.testing.assert_array_equal(putils.load_audio(path), jutils.load_audio(path))
    np.testing.assert_array_equal(putils.load_audio(path, mono=False),
                                  jutils.load_audio(path, mono=False))


def test_volume_normalize_and_segment():
    x = _signal(4000, 1, seed=6) * 0.05
    np.testing.assert_array_equal(putils.audio_volume_normalize(x),
                                  jutils.audio_volume_normalize(x))
    import random

    random.seed(3)
    a = putils.random_select_audio_segment(x, 1000)
    random.seed(3)
    np.testing.assert_array_equal(a, jutils.random_select_audio_segment(x, 1000))
    assert putils.random_select_audio_segment(x[:10], 16).shape == (16,)


def test_stt_load_audio_and_stdin(tmp_path, monkeypatch):
    path = tmp_path / "s.wav"
    pio.write(path, _signal(24000, 2, seed=7), 24000)
    np.testing.assert_allclose(pstt.load_audio(str(path)), jstt.load_audio(str(path)),
                               rtol=0, atol=RESAMPLE_ATOL)

    class Stdin:
        buffer = io.BytesIO(path.read_bytes())

    monkeypatch.setattr(sys, "stdin", Stdin)
    out = pstt.load_audio(from_stdin=True)
    Stdin.buffer.seek(0)
    np.testing.assert_allclose(out, jstt.load_audio(from_stdin=True), rtol=0,
                               atol=RESAMPLE_ATOL)
    assert pstt.SAMPLE_RATE == jstt.SAMPLE_RATE == 16000


def test_ensure_waveform(tmp_path):
    path = tmp_path / "s.wav"
    pio.write(path, _signal(8000, 2, seed=8), 8000)
    for audio in (str(path), path, path.read_bytes()):
        np.testing.assert_allclose(pensure(audio, 16000), jensure(audio, 16000), rtol=0,
                                   atol=RESAMPLE_ATOL)
    x = _signal(100, 1)
    np.testing.assert_array_equal(pensure(x[None], 16000), x)
