"""OpenAI-compatible audio server on the port (counterpart of
`mlx_audio_tpu/server.py`'s stdlib transport).

An in-process `ModelProvider` cache with a lock, `POST /v1/audio/speech`
(streamed encoded audio), `POST /v1/audio/transcriptions` (multipart upload,
NDJSON with `stream=true`), model CRUD under `/v1/models`, CORS, the studio
UI at `/ui`, and two WebSocket routes: `/v1/audio/speech/stream` (streaming
TTS) and `/v1/audio/transcriptions/realtime` (realtime STT). The transport
is the standard library's `ThreadingHTTPServer` with `ws.py`'s RFC 6455
codec, so nothing outside the standard library is needed to serve.

    python -m mlx_audio_tpu_torch.server --device cuda --port 8000

Models load on the card unless the provider names another device
(`--device cpu`, `serve_stdlib(device="cpu")`); with no card, loading a
model raises rather than run on the host. The JAX package's FastAPI app
(`create_app`) and its uvicorn branch are not ported: neither `fastapi` nor
`uvicorn` is installed where the port runs.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import queue
import re
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, unquote, urlsplit

import numpy as np

from . import audio_io

NUM_WORKERS = int(os.environ.get("MLX_AUDIO_NUM_WORKERS", "1"))
ALLOWED_ORIGINS = os.environ.get("MLX_AUDIO_ALLOWED_ORIGINS", "*")
BATCHING = os.environ.get("MLX_AUDIO_BATCHING", "1") != "0"

log = logging.getLogger(__name__)


class _Warmup:
    """A batcher's warm-up on a daemon thread. Best-effort, as in the JAX
    package (a failure leaves the batcher serving, only colder), but the
    exception is kept for `ModelProvider.wait_warmup` and logged."""

    def __init__(self, fn):
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, args=(fn,), daemon=True,
                                       name="batcher-warmup")
        self.thread.start()

    def _run(self, fn) -> None:
        try:
            fn()
        except Exception as e:  # a boundary that must not take the server down
            self.error = e
            log.warning("batcher warm-up failed", exc_info=True)


class ModelProvider:
    """Thread-safe cache of loaded models (reference server.py:74-94). Models
    load through `utils.load_model` on `device` (None: the card) in `dtype`
    (None: the checkpoint's)."""

    def __init__(self, device=None, dtype=None):
        self.device = device
        self.dtype = dtype
        self._models: Dict[str, Any] = {}
        self._warmups: Dict[str, _Warmup] = {}
        self._lock = threading.Lock()

    def load_model(self, model_name: str):
        with self._lock:
            if model_name not in self._models:
                from .utils import load_model

                if int(os.environ.get("MLX_AUDIO_TPU_DP", "0") or 0) > 1:
                    raise NotImplementedError(
                        "MLX_AUDIO_TPU_DP > 1 asks for the data-parallel replica pool, "
                        "which goes with parallel/: not ported yet")
                model = load_model(model_name, device=self.device, dtype=self.dtype)
                # per-card request batching: concurrent requests fuse into one
                # batched forward (serving.py)
                if BATCHING and hasattr(model, "make_batcher"):
                    batcher = model.make_batcher().install()
                    if hasattr(batcher, "warmup"):
                        self._warmups[model_name] = _Warmup(
                            lambda: self._warm(model, batcher))
                self._models[model_name] = model
            return self._models[model_name]

    @staticmethod
    def _warm(model, batcher) -> None:
        """Run every batch bucket once before live traffic (batcher.warmup).
        Whisper batchers get the two option sets the transcription endpoints
        produce (with and without timestamps, each with its own prompt);
        every other batcher takes no arguments."""
        import torch

        from .device import pinned, thread_setup

        thread_setup(pinned(getattr(model, "device", None)))
        if hasattr(model, "dims") and hasattr(model, "get_tokenizer"):
            from .stt.models.whisper.decoding import DecodingOptions

            tok = model.get_tokenizer()
            window = torch.zeros(3000, model.dims.n_mels, device=model.device)
            for without_ts in (False, True):
                opts = DecodingOptions(task="transcribe", language=tok.language or "en",
                                       temperature=0.0, without_timestamps=without_ts)
                prompt = (tok.sot_sequence_including_notimestamps if without_ts
                          else tok.sot_sequence)
                batcher.warmup(window, list(prompt), opts, tok)
        else:
            batcher.warmup()

    def wait_warmup(self, model_name: str, timeout: Optional[float] = None
                    ) -> Optional[BaseException]:
        """Wait for a model's batcher warm-up; the exception it raised, or
        None (also when there was no warm-up)."""
        with self._lock:
            w = self._warmups.get(model_name)
        if w is None:
            return None
        w.thread.join(timeout)
        if w.thread.is_alive():
            raise TimeoutError(f"the warm-up of {model_name} outlasted {timeout} s")
        return w.error

    def list_models(self) -> List[str]:
        with self._lock:
            return list(self._models)

    def unload(self, model_name: str) -> bool:
        with self._lock:
            model = self._models.pop(model_name, None)
            self._warmups.pop(model_name, None)
            if model is None:
                return False
            # tear down the serving batcher installed at load time (its
            # scheduler thread and infer-hook entry hold the model alive)
            from .serving import get_infer_hook

            hook = get_infer_hook(model)
            if hook is not None and hasattr(hook, "close"):
                hook.close()
            return True


model_provider = ModelProvider()


# ---------------------------------------------------------------------------
# Core request handlers (transport-independent)
# ---------------------------------------------------------------------------


def _ui_html() -> str:
    """The built-in single-file studio UI, served in-process at /ui."""
    return (Path(__file__).parent / "ui" / "index.html").read_text()


def _wav_stream_header(sample_rate: int) -> bytes:
    """WAV header with unknown (max) data size: lets PCM frames stream
    chunk by chunk; players treat 0xFFFFFFFF as 'read until EOF'."""
    byte_rate = sample_rate * 2
    fmt_chunk = struct.pack("<HHIIHH", 1, 1, sample_rate, byte_rate, 2, 16)
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def _pcm16(audio) -> bytes:
    """float samples → little-endian int16 bytes, as the JAX server writes
    them (clip, scale by 32767, truncate)."""
    x = np.clip(np.asarray(audio, np.float32).reshape(-1), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()


def _signature(fn):
    """(accepted parameter names, whether it takes **kwargs)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return set(), True
    return set(params), any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _speech_results(model, payload: dict, streamable: bool):
    """The model's `generate` results for a speech request: the text and the
    SpeechRequest fields the model's signature takes, and `stream=True` (with
    the request's `streaming_interval`) for a model with a streaming decode
    (Qwen3-TTS) when the transport can send audio as it comes, under a
    serving batcher too."""
    gen_kwargs = {
        k: v
        for k, v in dict(
            text=payload.get("input", payload.get("text", "")),
            voice=payload.get("voice"),
            speed=payload.get("speed", 1.0),
            lang_code=payload.get("lang_code", "a"),
            # the remaining SpeechRequest fields (reference server.py:154-169),
            # filtered below against the model's generate() signature
            instruct=payload.get("instruct"),
            gender=payload.get("gender"),
            pitch=payload.get("pitch"),
            ref_audio=payload.get("ref_audio"),
            ref_text=payload.get("ref_text"),
            temperature=payload.get("temperature"),
            top_p=payload.get("top_p"),
            top_k=payload.get("top_k"),
            repetition_penalty=payload.get("repetition_penalty"),
        ).items()
        if v is not None
    }
    accepted, var_kw = _signature(model.generate)
    if streamable and "stream" in accepted:
        gen_kwargs["stream"] = True
        if payload.get("streaming_interval") is not None and "streaming_interval" in accepted:
            gen_kwargs["streaming_interval"] = float(payload["streaming_interval"])
    if not var_kw:
        gen_kwargs = {k: v for k, v in gen_kwargs.items() if k in accepted}
    return model.generate(**gen_kwargs)


def generate_speech(payload: dict, provider: Optional[ModelProvider] = None):
    """Yield encoded audio chunks for a TTS request (reference :256-316).

    wav/pcm responses stream per generated segment or streamed chunk
    (header first for wav), so time to first byte is one chunk's synthesis.
    Formats that need the whole signal (mp3/flac/ogg) buffer and encode once
    at the end."""
    provider = provider or model_provider
    fmt = payload.get("response_format", "wav")
    model = provider.load_model(payload.get("model", "prince-canuma/Kokoro-82M"))
    streamable = fmt in ("wav", "pcm")
    sample_rate = None
    pcm = []
    sent_header = False
    for result in _speech_results(model, payload, streamable):
        sample_rate = result.sample_rate
        chunk = np.asarray(result.audio).reshape(-1)
        if not streamable:
            pcm.append(chunk)
            continue
        if fmt == "wav" and not sent_header:
            yield _wav_stream_header(sample_rate)
            sent_header = True
        yield _pcm16(chunk)
    if streamable:
        if fmt == "wav" and not sent_header:
            yield _wav_stream_header(sample_rate or 24000)
        return
    audio = np.concatenate(pcm) if pcm else np.zeros(1, np.float32)
    yield audio_io.encode_bytes(audio, sample_rate or 24000, fmt)


def _read_16k(file_bytes: bytes) -> np.ndarray:
    """An uploaded file → mono float32 at 16 kHz (channels averaged)."""
    from .utils import resample_audio

    x, sr = audio_io.read(file_bytes)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if sr != 16000:
        x = resample_audio(x.astype(np.float32), sr, 16000)
    return x


def transcribe_audio(file_bytes: bytes, payload: dict,
                     provider: Optional[ModelProvider] = None) -> dict:
    """Handle a transcription request (reference :364-412)."""
    provider = provider or model_provider
    model = provider.load_model(payload.get("model", "mlx-community/whisper-large-v3-turbo"))
    x = _read_16k(file_bytes)
    kwargs = {}
    if payload.get("language"):
        kwargs["language"] = payload["language"]
    # pass-through options the reference form accepts (server.py:364-392),
    # filtered against this model's generate() signature; frame_threshold is
    # an AlignAtt streaming knob, not forwarded on this path
    accepted, var_kw = _signature(model.generate)
    for opt in ("verbose", "max_tokens", "chunk_duration", "context", "prefill_step_size"):
        if payload.get(opt) is not None and (var_kw or opt in accepted):
            kwargs[opt] = payload[opt]
    result = model.generate(x, **kwargs)
    out = {"text": result.text}
    if payload.get("response_format") == "verbose_json":
        out["segments"] = result.segments
        out["language"] = result.language
        out["duration"] = result.duration
    return out


def transcribe_audio_stream(file_bytes: bytes, payload: dict,
                            provider: Optional[ModelProvider] = None):
    """NDJSON streaming transcription: one JSON line per decoded segment as
    the seek loop produces it, then a final line with the full text.

    The upload is decoded EAGERLY (before the first yield), so the transport
    can surface a bad upload as a clean HTTP status instead of corrupting an
    already-started chunked body."""
    provider = provider or model_provider
    model = provider.load_model(payload.get("model", "mlx-community/whisper-large-v3-turbo"))
    return _stream_transcription(model, _read_16k(file_bytes), payload)


def _stream_transcription(model, x, payload):
    q: "queue.Queue" = queue.Queue()
    done = object()
    streams_segments = "on_segment" in inspect.signature(model.generate).parameters

    def run():
        try:
            kwargs = {}
            if payload.get("language"):
                kwargs["language"] = payload["language"]
            if streams_segments:
                kwargs["on_segment"] = q.put
            result = model.generate(x, **kwargs)
            if not streams_segments:
                for seg in result.segments or []:
                    q.put(seg)
            q.put({"type": "done", "text": result.text,
                   "language": getattr(result, "language", None),
                   "duration": getattr(result, "duration", None)})
        except Exception as e:  # reported to the client as the last line
            log.warning("streamed transcription failed", exc_info=True)
            q.put({"type": "error", "error": f"{type(e).__name__}: {e}"})
        finally:
            q.put(done)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            break
        yield (json.dumps(item) + "\n").encode()


class EnergyGate:
    """RMS-energy speech gate: the dependency-free fallback when webrtcvad
    is not installed."""

    def __init__(self, threshold: float = 0.01, sample_rate: int = 16000):
        self.threshold = threshold
        self.sample_rate = sample_rate

    def has_speech(self, frame: np.ndarray) -> bool:
        if not len(frame):
            return False
        return float(np.sqrt((frame ** 2).mean() + 1e-12)) > self.threshold


class WebRTCGate:
    """webrtcvad speech gate matching the reference's WS endpoint
    (reference server.py:439-508): Vad(mode=3), 30 ms frames, a chunk counts
    as speech if ANY frame does, and VAD errors conservatively assume
    speech."""

    FRAME_MS = 30

    def __init__(self, sample_rate: int = 16000, mode: int = 3, vad=None):
        if vad is None:
            import webrtcvad  # optional dependency

            vad = webrtcvad.Vad(mode)
        self.vad = vad
        self.sample_rate = sample_rate
        self.frame_size = int(sample_rate * self.FRAME_MS / 1000)

    def has_speech(self, frame: np.ndarray) -> bool:
        pcm16 = (np.clip(frame, -1.0, 1.0) * 32767.0).astype("<i2")
        n = len(pcm16) // self.frame_size
        for i in range(n):
            chunk = pcm16[i * self.frame_size:(i + 1) * self.frame_size]
            try:
                if self.vad.is_speech(chunk.tobytes(), self.sample_rate):
                    return True
            except (ValueError, OSError):
                return True  # conservative, like the reference
        # a tail shorter than one VAD frame falls back to energy, so very
        # small chunks are not silently dropped
        if n == 0 and len(pcm16):
            return EnergyGate(sample_rate=self.sample_rate).has_speech(frame)
        return False


def make_vad_gate(sample_rate: int = 16000, energy_threshold: float = 0.01):
    """webrtcvad when importable (the reference's gating), else the energy
    fallback."""
    try:
        return WebRTCGate(sample_rate=sample_rate)
    except ImportError:
        return EnergyGate(threshold=energy_threshold, sample_rate=sample_rate)


class RealtimeSTTSession:
    """Transport-independent realtime STT state machine (reference
    server.py:415-706): 16 kHz int16 PCM frames in → partial transcripts
    every `partial_interval` s of buffered speech, finals on `silence_gap` s
    of silence or at `max_buffer` s. Speech gating uses webrtcvad when
    available, else RMS energy (`make_vad_gate`)."""

    def __init__(self, model, partial_interval: float = 1.5,
                 silence_gap: float = 0.5, max_buffer: float = 30.0,
                 energy_threshold: float = 0.01, sample_rate: int = 16000,
                 vad_gate=None):
        self.model = model
        self.partial_interval = partial_interval
        self.silence_gap = silence_gap
        self.max_buffer = max_buffer
        self.energy_threshold = energy_threshold
        self.sample_rate = sample_rate
        self.vad_gate = vad_gate or make_vad_gate(sample_rate, energy_threshold)
        self.buffer = np.zeros(0, np.float32)
        self.silence_run = 0.0
        self.last_partial = 0.0
        self.speech_seen = False

    def _decode(self) -> str:
        return self.model.generate(self.buffer).text

    def feed(self, pcm16: bytes) -> List[dict]:
        """Feed raw int16 PCM; returns 0+ events {type: partial|final, text}."""
        frame = np.frombuffer(pcm16, np.int16).astype(np.float32) / 32768.0
        if self.vad_gate.has_speech(frame):
            self.silence_run = 0.0
            self.speech_seen = True
        else:
            self.silence_run += len(frame) / self.sample_rate
        self.buffer = np.concatenate([self.buffer, frame])
        buffered = len(self.buffer) / self.sample_rate

        events: List[dict] = []
        if not self.speech_seen:
            # an idle microphone: no decodes on pure silence (no wasted
            # launches, no silence hallucinations); cap the buffer
            if buffered >= self.max_buffer:
                self.buffer = self.buffer[-self.sample_rate:]
            return events
        final = (self.silence_run >= self.silence_gap and buffered > self.silence_gap
                 ) or buffered >= self.max_buffer
        if final or buffered - self.last_partial >= self.partial_interval:
            if len(self.buffer) >= self.sample_rate // 10:
                events.append({"type": "final" if final else "partial",
                               "text": self._decode()})
            if final:
                self.buffer = np.zeros(0, np.float32)
                self.silence_run = 0.0
                self.last_partial = 0.0
                self.speech_seen = False
            else:
                self.last_partial = buffered
        return events

    def finalize(self) -> Optional[dict]:
        """Flush the remaining buffer as a final transcript."""
        if self.speech_seen and len(self.buffer) >= self.sample_rate // 10:
            text = self._decode()
            self.buffer = np.zeros(0, np.float32)
            return {"type": "final", "text": text}
        return None


# ---------------------------------------------------------------------------
# Stdlib HTTP transport
# ---------------------------------------------------------------------------


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser → (fields dict, files dict)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("missing multipart boundary")
    boundary = m.group(1).encode()
    fields: Dict[str, str] = {}
    files: Dict[str, bytes] = {}
    for part in body.split(b"--" + boundary):
        # strip exactly the single delimiting CRLF on each side: a blanket
        # strip would eat trailing 0x0D/0x0A bytes of binary file content
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part == b"--" or b"\r\n\r\n" not in part:
            continue
        header_blob, content = part.split(b"\r\n\r\n", 1)
        headers = header_blob.decode(errors="replace")
        name_m = re.search(r'name="([^"]+)"', headers)
        if not name_m:
            continue
        if 'filename="' in headers:
            files[name_m.group(1)] = content
        else:
            fields[name_m.group(1)] = content.decode(errors="replace")
    return fields, files


class _Handler(BaseHTTPRequestHandler):
    provider: ModelProvider = None
    protocol_version = "HTTP/1.1"

    REALTIME_WS_PATHS = ("/v1/audio/transcriptions/realtime", "/v1/audio/speech/stream")

    def log_message(self, fmt, *args):  # quiet
        pass

    def _cors_origin(self) -> str:
        """One origin per response: the request's Origin when allowed (a
        comma-joined list is not a valid Access-Control-Allow-Origin)."""
        allowed = [o.strip() for o in ALLOWED_ORIGINS.split(",")]
        if "*" in allowed:
            return "*"
        origin = self.headers.get("Origin", "")
        return origin if origin in allowed else allowed[0]

    def _send(self, code: int, body: bytes, content_type="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", self._cors_origin())
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode())

    def _read_body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def do_OPTIONS(self):
        self.send_response(204)
        self.send_header("Access-Control-Allow-Origin", self._cors_origin())
        self.send_header("Access-Control-Allow-Methods", "GET, POST, DELETE, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        ws_path = self.path.split("?")[0]
        if (ws_path in self.REALTIME_WS_PATHS
                and "websocket" in self.headers.get("Upgrade", "").lower()):
            if ws_path == "/v1/audio/speech/stream":
                self._tts_stream_ws()
            else:
                self._realtime_ws()
        elif self.path == "/":
            self._json(200, {
                "name": "mlx_audio_tpu server",
                "endpoints": [
                    "/v1/audio/speech", "/v1/audio/transcriptions",
                    "/v1/audio/transcriptions/realtime (ws stt)",
                    "/v1/audio/speech/stream (ws tts)", "/v1/models", "/ui",
                ],
            })
        elif self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/ui":
            self._send(200, _ui_html().encode(), content_type="text/html; charset=utf-8")
        elif self.path == "/v1/models":
            self._json(200, {
                "object": "list",
                "data": [{"id": m, "object": "model", "created": int(time.time()),
                          "owned_by": "mlx_audio_tpu"}
                         for m in self.provider.list_models()],
            })
        else:
            self._json(404, {"error": "not found"})

    def _ws_handshake(self):
        """Complete the RFC 6455 upgrade: a WebSocketConnection, or None if
        the request is malformed."""
        from .ws import WebSocketConnection, accept_key

        key = self.headers.get("Sec-WebSocket-Key")
        if not key:
            self._json(400, {"error": "missing Sec-WebSocket-Key"})
            return None
        self.send_response(101)
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", accept_key(key))
        self.end_headers()
        return WebSocketConnection(self.rfile, self.wfile, auto_close_reply=False)

    def _tts_stream_ws(self):
        """Streaming TTS over WebSocket: each JSON text message
        {"input": ..., "model": ..., "voice": ...} (the speech endpoint's
        fields) streams back {"type": "start", "sample_rate": N}, binary int16
        PCM frames per generated segment or streamed chunk, then {"type":
        "done", "segments": K}. Several requests may share one connection.
        Unlike the JAX package's route, which forwards only voice and speed
        and never asks for streaming, a model with a streaming decode streams
        here as on the HTTP route, so the frames are the HTTP body's
        samples."""
        from .ws import OP_BINARY, OP_CLOSE

        conn = self._ws_handshake()
        if conn is None:
            return
        default_model = parse_qs(urlsplit(self.path).query).get("model", [None])[0]
        try:
            while True:
                msg = conn.recv()
                if msg is None:
                    break
                opcode, payload = msg
                if opcode == OP_CLOSE:
                    conn.close()
                    break
                if opcode == OP_BINARY:
                    continue  # TTS requests are JSON text frames
                try:
                    req = json.loads(payload or b"{}")
                except ValueError:
                    conn.send_text(json.dumps({"type": "error", "error": "invalid JSON"}))
                    continue
                text = req.get("input") or req.get("text")
                if not text:
                    conn.send_text(json.dumps({"type": "error", "error": "missing 'input'"}))
                    continue
                model_name = req.get("model") or default_model
                if not model_name:
                    conn.send_text(json.dumps({"type": "error", "error": "missing 'model'"}))
                    continue
                try:
                    model = self.provider.load_model(model_name)
                    n_seg = 0
                    for seg in _speech_results(model, dict(req, input=text), True):
                        if n_seg == 0:
                            conn.send_text(json.dumps(
                                {"type": "start", "sample_rate": int(seg.sample_rate)}))
                        conn.send_binary(_pcm16(seg.audio))
                        n_seg += 1
                    conn.send_text(json.dumps({"type": "done", "segments": n_seg}))
                except Exception as e:  # model errors go to the client
                    log.warning("streamed speech failed", exc_info=True)
                    conn.send_text(json.dumps({"type": "error", "error": str(e)}))
        finally:
            conn.close()
        self.close_connection = True

    def _realtime_ws(self):
        """Realtime STT over WebSocket (reference server.py:415-706)."""
        from .ws import OP_BINARY, OP_CLOSE

        conn = self._ws_handshake()
        if conn is None:
            return
        model_name = parse_qs(urlsplit(self.path).query).get(
            "model", ["mlx-community/whisper-large-v3-turbo"])[0]
        session = None

        def flush_final():
            final = session.finalize() if session is not None else None
            if final:
                try:
                    conn.send_text(json.dumps(final))
                except OSError:  # the client is gone
                    pass

        try:
            while True:
                msg = conn.recv()
                if msg is None:
                    break
                opcode, payload = msg
                if opcode == OP_CLOSE:
                    # flush the remaining transcript BEFORE completing the
                    # close handshake (data after our Close would be lost)
                    flush_final()
                    session = None
                    conn.close()
                    break
                if opcode != OP_BINARY:
                    # a JSON control message: the initial config (config
                    # first, then {"status": "ready"}) or a finalize command;
                    # unknown commands are ignored
                    try:
                        cmd = json.loads(payload or b"{}")
                    except ValueError:
                        cmd = {}
                    if payload == b"finalize" or cmd.get("command") == "finalize":
                        if session is not None:
                            event = session.finalize()
                            if event:
                                conn.send_text(json.dumps(event))
                        continue
                    if cmd.get("command") is not None:
                        continue  # an unknown command: keep the live session
                    if session is None:
                        model_name = cmd.get("model", model_name)
                        session = RealtimeSTTSession(self.provider.load_model(model_name))
                        conn.send_text(json.dumps({"status": "ready",
                                                   "message": "Ready to transcribe"}))
                    # config while live: ignored (a new session would drop the
                    # buffered audio)
                    continue
                if session is None:
                    session = RealtimeSTTSession(self.provider.load_model(model_name))
                for event in session.feed(payload):
                    conn.send_text(json.dumps(event))
        finally:
            flush_final()
            conn.close()
        self.close_connection = True

    def do_POST(self):
        try:
            if self.path == "/v1/audio/speech":
                payload = json.loads(self._read_body() or b"{}")
                self._stream_speech(payload)
            elif self.path == "/v1/audio/transcriptions":
                ctype = self.headers.get("Content-Type", "")
                if "multipart/form-data" not in ctype:
                    self._json(400, {"error": "expected multipart/form-data"})
                    return
                fields, files = _parse_multipart(self._read_body(), ctype)
                blob = files.get("file", b"")
                if fields.get("stream") in ("true", "1"):
                    # decoded BEFORE the 200, so errors surface as a clean
                    # JSON status, not a corrupted chunked body
                    stream = transcribe_audio_stream(blob, fields, self.provider)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("Access-Control-Allow-Origin", self._cors_origin())
                    self.end_headers()
                    for line in stream:  # NDJSON: one line per segment as it decodes
                        self._chunk(line)
                    self.wfile.write(b"0\r\n\r\n")
                    return
                self._json(200, transcribe_audio(blob, fields, self.provider))
            elif self.path.split("?")[0] == "/v1/models":
                # the reference passes model_name as a query parameter
                # (server.py:219-231); a JSON body works too
                q = parse_qs(urlsplit(self.path).query)
                payload = json.loads(self._read_body() or b"{}")
                name = (q.get("model_name", [None])[0]
                        or payload.get("model_name") or payload.get("model"))
                if not name:
                    self._json(400, {"error": "model_name required"})
                    return
                self.provider.load_model(name)
                self._json(200, {"status": "success",
                                 "message": f"Model {name} added successfully"})
            else:
                self._json(404, {"error": "not found"})
        except FileNotFoundError as e:
            self._json(404, {"error": str(e)})
        except Exception as e:  # errors as JSON; the server keeps running
            log.warning("request failed: %s %s", self.command, self.path, exc_info=True)
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _stream_speech(self, payload: dict) -> None:
        """The speech body as chunked transfer encoding, each chunk written
        as it is synthesised (as the reference's StreamingResponse does; the
        JAX package's stdlib transport buffers the whole body). The model's
        load and the first chunk come before the status line, so their
        errors still answer with a JSON status; a failure after that ends
        the connection with the chunked body unterminated."""
        fmt = payload.get("response_format", "wav")
        chunks = generate_speech(payload, self.provider)
        first = next(chunks, b"")
        self.send_response(200)
        self.send_header("Content-Type", f"audio/{fmt}")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Access-Control-Allow-Origin", self._cors_origin())
        self.end_headers()
        try:
            if first:
                self._chunk(first)
            for c in chunks:
                self._chunk(c)
            self.wfile.write(b"0\r\n\r\n")
        except Exception:  # the status is sent: log it and drop the connection
            log.warning("speech stream failed after its first chunk", exc_info=True)
            self.close_connection = True

    def do_DELETE(self):
        bare = self.path.split("?")[0]
        m = re.match(r"^/v1/models/(.+)$", bare)
        name = None
        query_style = False
        if m:
            name = m.group(1)
        elif bare == "/v1/models":
            # reference server.py:234-252: a ?model_name= query parameter (204
            # on success); a JSON body works too (JSON response, as the path
            # style)
            name = parse_qs(urlsplit(self.path).query).get("model_name", [None])[0]
            query_style = name is not None
            if name is None:
                try:
                    payload = json.loads(self._read_body() or b"{}")
                except ValueError:
                    payload = {}
                name = payload.get("model_name") or payload.get("model")
        if not name:
            self._json(404, {"error": "not found"})
            return
        name = unquote(name).strip('"')
        if not self.provider.unload(name):
            self._json(404, {"error": f"Model '{name}' not found"})
        elif query_style:  # the reference's query style answers 204 No Content
            self._send(204, b"")
        else:
            self._json(200, {"status": "unloaded", "model": name})


def serve_stdlib(host: str = "127.0.0.1", port: int = 8000,
                 provider: Optional[ModelProvider] = None,
                 device=None) -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it (`shutdown()` and
    `server_close()` stop it). `provider` is the model cache; without one,
    the module's (models on the card), or with `device` a new cache that
    loads models there (`device="cpu"` for the plain PyTorch path)."""
    if provider is None:
        provider = model_provider if device is None else ModelProvider(device=device)
    handler = type("Handler", (_Handler,), {"provider": provider})
    httpd = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True, name="http").start()
    return httpd


def main(argv=None):
    import argparse

    global ALLOWED_ORIGINS
    p = argparse.ArgumentParser(description="mlx_audio_tpu_torch server (stdlib HTTP + "
                                            "WebSocket)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--workers", type=int, default=NUM_WORKERS)
    p.add_argument("--allowed-origins", nargs="+", default=None,
                   help="CORS origins (overrides MLX_AUDIO_ALLOWED_ORIGINS)")
    p.add_argument("--reload", action="store_true",
                   help="uvicorn auto-reload (not available: uvicorn is not ported)")
    p.add_argument("--start-ui", action="store_true",
                   help="Print the built-in studio UI URL (served at /ui)")
    p.add_argument("--log-dir", default="logs", help="Directory for server.log")
    p.add_argument("--device", default=None,
                   help="torch device for the models (default: the card; 'cpu' for the "
                        "plain path)")
    args = p.parse_args(argv)
    if args.reload or args.workers > 1:
        p.error("--reload and --workers > 1 need uvicorn, which the port does not "
                "serve with; run one stdlib server per process")
    if args.log_dir:
        Path(args.log_dir).mkdir(parents=True, exist_ok=True)
        logging.getLogger().addHandler(logging.FileHandler(Path(args.log_dir) / "server.log"))
    if args.allowed_origins:
        ALLOWED_ORIGINS = ",".join(args.allowed_origins)
        os.environ["MLX_AUDIO_ALLOWED_ORIGINS"] = ALLOWED_ORIGINS
    if args.start_ui:
        print(f"studio UI: http://{args.host}:{args.port}/ui")
    from .device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: fail now, not per request
    provider = ModelProvider(device=args.device)
    httpd = serve_stdlib(args.host, args.port, provider)
    print(f"stdlib server on {args.host}:{args.port} (models on "
          f"{args.device or 'the card'})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
