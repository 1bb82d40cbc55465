"""Buffered realtime audio playback (a copy of
`mlx_audio_tpu/tts/audio_player.py`, the contract of the reference
tts/audio_player.py:9-120). Plays through `sounddevice` where it is
installed (imported only when playback starts); without it the buffering
and arrival-rate logic still works (tests, draining to a file) and `play`
is a no-op, as in the JAX package. `check_output_device` says up front
whether playback can happen at all.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np


class AudioPlayer:
    def __init__(self, sample_rate: int = 24000, buffer_size: int = 2048,
                 verbose: bool = False):
        self.sample_rate = sample_rate
        self.buffer_size = buffer_size
        self.verbose = verbose
        self.audio_buffer = np.zeros(0, np.float32)
        self.buffer_lock = threading.Lock()
        self.playing = False
        self.drained = threading.Event()
        self.drained.set()
        # EMA of chunk arrival rate: wait until enough audio is buffered to
        # avoid underruns (reference :47-70)
        self._arrival_rate = None
        self._last_arrival = None
        self._min_buffer_sec = 0.5
        self._stream = None

    # ---- buffering ----

    def queue_audio(self, samples) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        now = time.perf_counter()
        if self._last_arrival is not None:
            dt = max(now - self._last_arrival, 1e-4)
            rate = len(samples) / dt
            self._arrival_rate = (
                rate if self._arrival_rate is None
                else 0.8 * self._arrival_rate + 0.2 * rate
            )
        self._last_arrival = now
        with self.buffer_lock:
            self.audio_buffer = np.concatenate([self.audio_buffer, samples])
            self.drained.clear()
        if not self.playing and self._buffered_seconds() >= self._min_buffer_sec:
            self.play()

    def _buffered_seconds(self) -> float:
        with self.buffer_lock:
            return len(self.audio_buffer) / self.sample_rate

    def _callback(self, outdata, frames, time_info, status):
        with self.buffer_lock:
            n = min(frames, len(self.audio_buffer))
            out = self.audio_buffer[:n]
            self.audio_buffer = self.audio_buffer[n:]
            if len(self.audio_buffer) == 0:
                self.drained.set()
        outdata[:n, 0] = out
        if n < frames:
            outdata[n:, 0] = 0

    # ---- playback ----

    def play(self) -> None:
        if self.playing:
            return
        try:
            import sounddevice as sd
        except ImportError:
            if self.verbose:
                print("sounddevice not available; AudioPlayer is buffering only")
            return
        self._stream = sd.OutputStream(
            samplerate=self.sample_rate, channels=1, dtype="float32",
            blocksize=self.buffer_size, callback=self._callback,
        )
        self._stream.start()
        self.playing = True

    def wait_for_drain(self, timeout: Optional[float] = None) -> bool:
        return self.drained.wait(timeout)

    def stop(self) -> None:
        if self._stream is not None:
            self.wait_for_drain(timeout=30)
            self._stream.stop()
            self._stream.close()
            self._stream = None
        self.playing = False

    def flush(self) -> np.ndarray:
        """Drain the buffer without a device (testing / file output)."""
        with self.buffer_lock:
            out = self.audio_buffer
            self.audio_buffer = np.zeros(0, np.float32)
            self.drained.set()
        return out


def check_output_device(sample_rate: int = 24000) -> None:
    """Raise RuntimeError unless `sounddevice` imports and its default
    output device takes mono float32 at `sample_rate`."""
    try:
        import sounddevice as sd
    except (ImportError, OSError) as e:  # OSError: no PortAudio library
        raise RuntimeError(f"playback needs the `sounddevice` package and PortAudio "
                           f"({e}); write the audio and play the file instead") from e
    try:
        sd.check_output_settings(channels=1, dtype="float32", samplerate=sample_rate)
    except (sd.PortAudioError, ValueError) as e:
        raise RuntimeError(f"no usable audio output device ({e}); write the audio and "
                           "play the file instead") from e
