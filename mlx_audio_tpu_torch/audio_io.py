"""Audio file I/O with numpy alone (counterpart of `mlx_audio_tpu/audio_io.py`).

read/write, soundfile-style sf_read/sf_write, magic-byte format detection,
and an ffmpeg subprocess bridge for compressed formats. WAV is decoded and
encoded here (PCM 8/16/24/32, IEEE float 32/64, WAVE_FORMAT_EXTENSIBLE);
MP3/FLAC/M4A/AAC/OGG go through ffmpeg when it is on PATH, with a clear
error otherwise. The JAX package decodes WAV through its native C library
first; this module does not load it. Its decoder takes the same decisions
as that library: an extensible file's sample format comes from its fmt
extension, and every sample converts to the same float32.
"""

from __future__ import annotations

import io
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["read", "write", "sf_read", "sf_write", "detect_format", "AudioData"]

PathLike = Union[str, Path]


# ---------------------------------------------------------------------------
# Format detection (magic bytes)
# ---------------------------------------------------------------------------


def detect_format(data: bytes) -> Optional[str]:
    if len(data) < 12:
        return None
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:4] == b"OggS":
        return "ogg"
    if data[:3] == b"ID3" or (data[0] == 0xFF and (data[1] & 0xE0) == 0xE0):
        return "mp3"
    if data[4:8] == b"ftyp":
        return "m4a"
    return None


# ---------------------------------------------------------------------------
# Native WAV codec
# ---------------------------------------------------------------------------

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_wav(data: bytes) -> Tuple[np.ndarray, int, str]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and len(body) >= 26:
                # the sub-format GUID's first two bytes are the format tag
                (sub,) = struct.unpack("<H", body[24:26])
                fmt = (sub,) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or raw is None:
        raise ValueError("Malformed WAV: missing fmt or data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:  # no extension to read
        audio_format = _WAVE_FORMAT_PCM if bits != 32 else _WAVE_FORMAT_IEEE_FLOAT

    if audio_format == _WAVE_FORMAT_IEEE_FLOAT and bits in (32, 64):
        x = np.frombuffer(raw[: len(raw) // (bits // 8) * (bits // 8)],
                          dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
        subtype = "FLOAT" if bits == 32 else "DOUBLE"
    elif audio_format != _WAVE_FORMAT_PCM:
        raise ValueError(f"Unsupported WAV format {audio_format} bits={bits}")
    elif bits == 16:
        x = np.frombuffer(raw[: len(raw) // 2 * 2], dtype="<i2").astype(np.float32) / 32768.0
        subtype = "PCM_16"
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
        subtype = "PCM_24"
    elif bits == 32:
        x = np.frombuffer(raw[: len(raw) // 4 * 4], dtype="<i4").astype(np.float32) \
            / 2147483648.0
        subtype = "PCM_32"
    elif bits == 8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        subtype = "PCM_U8"
    else:
        raise ValueError(f"Unsupported WAV format {audio_format} bits={bits}")

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    return x, sample_rate, subtype


def _encode_wav(x: np.ndarray, sample_rate: int, subtype: str = "PCM_16") -> bytes:
    x = np.asarray(x)
    if x.ndim == 1:
        channels = 1
    else:
        channels = x.shape[1]
    if subtype == "FLOAT":
        payload = x.astype("<f4").tobytes()
        bits, afmt = 32, _WAVE_FORMAT_IEEE_FLOAT
    elif subtype == "PCM_24":
        v = np.clip(np.round(np.asarray(x, np.float64) * (1 << 23)), -(1 << 23), (1 << 23) - 1).astype(
            np.int32
        )
        b = np.empty((v.size, 3), dtype=np.uint8)
        flat = v.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
        bits, afmt = 24, _WAVE_FORMAT_PCM
    elif subtype == "PCM_32":
        payload = (
            np.clip(np.asarray(x, np.float64) * 2147483648.0, -2147483648, 2147483647)
            .astype("<i4")
            .tobytes()
        )
        bits, afmt = 32, _WAVE_FORMAT_PCM
    else:  # PCM_16
        payload = (
            np.clip(np.round(np.asarray(x, np.float64) * 32768.0), -32768, 32767)
            .astype("<i2")
            .tobytes()
        )
        bits, afmt = 16, _WAVE_FORMAT_PCM

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    fmt_chunk = struct.pack(
        "<HHIIHH", afmt, channels, sample_rate, byte_rate, block_align, bits
    )
    out = io.BytesIO()
    out.write(b"RIFF")
    out.write(struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(payload)))
    out.write(b"WAVE")
    out.write(b"fmt ")
    out.write(struct.pack("<I", len(fmt_chunk)))
    out.write(fmt_chunk)
    out.write(b"data")
    out.write(struct.pack("<I", len(payload)))
    out.write(payload)
    if len(payload) & 1:
        out.write(b"\x00")
    return out.getvalue()


# ---------------------------------------------------------------------------
# ffmpeg bridge (optional)
# ---------------------------------------------------------------------------


def _have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _decode_ffmpeg(data: bytes) -> Tuple[np.ndarray, int]:
    if not _have_ffmpeg():
        raise RuntimeError(
            "Decoding this format requires ffmpeg on PATH (not found). "
            "WAV decoding is native."
        )
    probe = subprocess.run(
        [
            "ffprobe", "-v", "error", "-print_format", "csv=p=0",
            "-show_entries", "stream=sample_rate,channels",
            "-select_streams", "a:0", "-",
        ],
        input=data,
        capture_output=True,
    )
    try:
        sr_s, ch_s = probe.stdout.decode().strip().split(",")[:2]
        sr, ch = int(sr_s), int(ch_s)
    except Exception:
        # ffprobe can fail on non-seekable stdin (late headers) while
        # ffmpeg still decodes fine. Falling back is NOT a silent guess:
        # ffmpeg is invoked below with -ar/-ac, so the output really is
        # resampled to these values and the returned rate matches the
        # data. Warn loudly so misdetected containers are diagnosable.
        sr, ch = 44_100, 2
        import logging

        logging.getLogger(__name__).warning(
            "ffprobe could not determine sample_rate/channels "
            "(stderr: %r); decoding via ffmpeg resample to %d Hz / %d ch",
            probe.stderr.decode(errors="replace")[:200], sr, ch,
        )
    proc = subprocess.run(
        ["ffmpeg", "-v", "quiet", "-i", "pipe:0", "-f", "f32le", "-acodec",
         "pcm_f32le", "-ac", str(ch), "-ar", str(sr), "pipe:1"],
        input=data,
        capture_output=True,
    )
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(
            f"ffmpeg decode failed (rc={proc.returncode}, "
            f"{len(proc.stdout)} bytes out)"
        )
    x = np.frombuffer(proc.stdout, dtype="<f4").astype(np.float32)
    if ch > 1:
        x = x[: (len(x) // ch) * ch].reshape(-1, ch)
    return x, sr


def _encode_ffmpeg(x: np.ndarray, sample_rate: int, fmt: str) -> bytes:
    if not _have_ffmpeg():
        raise RuntimeError(
            f"Encoding {fmt} requires ffmpeg on PATH (not found). "
            "WAV encoding is native."
        )
    channels = 1 if x.ndim == 1 else x.shape[1]
    proc = subprocess.run(
        ["ffmpeg", "-v", "quiet", "-f", "f32le", "-ar", str(sample_rate), "-ac",
         str(channels), "-i", "pipe:0", "-f", fmt, "pipe:1"],
        input=np.asarray(x, "<f4").tobytes(),
        capture_output=True,
    )
    return proc.stdout


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class AudioData:
    """Simple (samples, sample_rate) holder used by the server layer."""

    def __init__(self, samples: np.ndarray, sample_rate: int):
        self.samples = samples
        self.sample_rate = sample_rate


def read(
    path_or_bytes: Union[PathLike, bytes],
    dtype: str = "float32",
) -> Tuple[np.ndarray, int]:
    """Read an audio file → (samples float32/int16, sample_rate).

    Mono files return shape (n,), multi-channel (n, channels).
    """
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = path_or_bytes
    fmt = detect_format(data)
    if fmt == "wav":
        x, sr, _ = _decode_wav(data)
    else:
        x, sr = _decode_ffmpeg(data)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return x, sr


def write(
    path: PathLike,
    samples: np.ndarray,
    sample_rate: int,
    subtype: Optional[str] = None,
) -> None:
    """Write audio to a file; format inferred from the extension."""
    path = Path(path)
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        samples = samples.astype(np.float32) / 32768.0
    ext = path.suffix.lower().lstrip(".")
    if ext in ("wav", ""):
        path.write_bytes(_encode_wav(samples, sample_rate, subtype or "PCM_16"))
    elif ext in ("mp3", "flac", "ogg", "adts", "aac", "m4a"):
        fmt = {"aac": "adts", "m4a": "ipod"}.get(ext, ext)
        path.write_bytes(_encode_ffmpeg(samples, sample_rate, fmt))
    else:
        raise ValueError(f"Unsupported output format: {ext}")


def encode_bytes(samples: np.ndarray, sample_rate: int, fmt: str = "wav") -> bytes:
    """Encode samples to bytes in the given format (server streaming path)."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        samples = samples.astype(np.float32) / 32768.0
    if fmt == "wav":
        return _encode_wav(samples, sample_rate, "PCM_16")
    if fmt == "pcm":
        return (
            np.clip(np.round(samples * 32768.0), -32768, 32767).astype("<i2").tobytes()
        )
    return _encode_ffmpeg(samples, sample_rate, {"aac": "adts", "m4a": "ipod"}.get(fmt, fmt))


# soundfile-compatible aliases -------------------------------------------------


def sf_read(path: PathLike, dtype: str = "float32"):
    x, sr = read(path, dtype=dtype)
    return x, sr


def sf_write(path: PathLike, samples: np.ndarray, sample_rate: int, subtype=None):
    write(path, samples, sample_rate, subtype=subtype)
