"""The port's server (`mlx_audio_tpu_torch.server`, `ws.py`) on the CPU.

- The JAX package's endpoint-contract cases (tests/test_server.py,
  tests/test_ws.py) on the port with fake providers: health, `/`, `/ui`,
  speech, multipart transcription, model CRUD in both styles, 400 and 404,
  per-segment speech streaming, NDJSON transcription and its clean error on
  a bad upload, CORS, and both WebSocket routes through `ws.py`.
- `RealtimeSTTSession`'s events held to the JAX class's on the same frames,
  and the two `ws.py` frame codecs byte for byte.
- Parity: one tiny Whisper and one tiny Qwen3-TTS checkpoint directory, each
  with a trained `tokenizer.json`, served by `mlx_audio_tpu.server` and by
  the port's `serve_stdlib(device="cpu")` (with its serving batchers): the
  same requests give the same transcription JSON and the same speech body
  (greedy; int16 samples within one step). The JAX side reads Qwen3-TTS's
  text through `AutoTokenizer`, the port's through its own reader. Both
  Whisper classes decode at temperature 0 here: the HTTP form has no
  temperature field, and the fallback's sampled decodes draw from JAX's and
  torch's generators, which differ.
"""

import copy
import functools
import io
import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from tokenizers import Regex, decoders, models, normalizers, pre_tokenizers, processors
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import trainers

from mlx_audio_tpu import audio_io as jio
from mlx_audio_tpu import convert as jconvert
from mlx_audio_tpu import server as jsrv
from mlx_audio_tpu import ws as jws
from mlx_audio_tpu.nn.module import flatten_params as jflat
from mlx_audio_tpu.nn.module import load_weights as jload_weights
from mlx_audio_tpu.stt.models.base import STTOutput as JaxSTTOutput
from mlx_audio_tpu.stt.models.whisper import Model as JaxWhisper
from mlx_audio_tpu.stt.models.whisper import ModelDimensions as JaxDims
from mlx_audio_tpu.tts.models.qwen3_tts import Model as JaxQwen
from mlx_audio_tpu.tts.models.qwen3_tts import ModelConfig as JaxQwenConfig
from mlx_audio_tpu_torch import audio_io
from mlx_audio_tpu_torch import server as srv
from mlx_audio_tpu_torch import ws as wsmod
from mlx_audio_tpu_torch.serving import get_infer_hook
from mlx_audio_tpu_torch.stt.models.base import STTOutput
from mlx_audio_tpu_torch.stt.models.whisper import Model as Whisper
from mlx_audio_tpu_torch.tokenizer_json import QWEN2_PATTERN
from mlx_audio_tpu_torch.tts.models.base import GenerationResult
from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model as Qwen
from test_torch_qwen3_tts import CFG as QWEN_CFG
from test_torch_qwen3_tts import _moved
from test_torch_tokenizer_json import _chip_smoke
from test_torch_whisper import DIMS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _serve(provider=None, **kw):
    httpd = srv.serve_stdlib("127.0.0.1", 0, provider, **kw)
    host, port = httpd.server_address
    return httpd, f"http://{host}:{port}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def _post_json(url, obj, method="POST"):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read(), dict(r.headers)


def _multipart(url, fields: dict, wav: bytes, timeout=300):
    boundary = "BOUNDARYXYZ"
    body = b""
    for name, val in fields.items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"\r\n\r\n{val}\r\n').encode()
    body += (f"--{boundary}\r\nContent-Disposition: form-data; "
             'name="file"; filename="a.wav"\r\nContent-Type: audio/wav\r\n\r\n').encode()
    body += wav + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url + "/v1/audio/transcriptions", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), dict(r.headers)


def _http_error(fn) -> urllib.error.HTTPError:
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value


def _ws_connect(base_url, path, module=wsmod):
    host, port = base_url.rsplit("/", 1)[-1].split(":")
    sock = socket.create_connection((host, int(port)), timeout=120)
    req, expect = module.client_handshake_headers(f"{host}:{port}", path)
    sock.sendall(req)
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    head = resp.split(b"\r\n\r\n")[0].decode()
    assert "101" in head.splitlines()[0] and expect in head
    return sock, module.WebSocketConnection(sock.makefile("rb"), sock.makefile("wb"),
                                            mask_outgoing=True)


def _pcm(seconds, amp, sr=16000, seed=0):
    x = np.random.default_rng(seed).standard_normal(int(sr * seconds)) * amp
    return (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()


# ---------------------------------------------------------------------------
# fake providers: the JAX package's endpoint contract on the port
# ---------------------------------------------------------------------------


class FakeTTS:
    def generate(self, text, **kwargs):
        yield GenerationResult(audio=np.zeros(2400, np.float32), samples=2400,
                               sample_rate=24000)


class FakeSTT:
    def generate(self, audio, **kwargs):
        return STTOutput(text="hello world", segments=[], language="en",
                         duration=len(audio) / 16000)


class FakeProvider(srv.ModelProvider):
    def load_model(self, name):
        with self._lock:
            if name not in self._models:
                tts = "tts" in name.lower() or "kokoro" in name.lower()
                self._models[name] = FakeTTS() if tts else FakeSTT()
            return self._models[name]


class SegmentedSTT:
    """A fake STT with `on_segment`, as Whisper's seek loop."""

    def generate(self, audio, on_segment=None, **kw):
        segs = [{"id": 0, "start": 0.0, "end": 1.0, "text": "hello"},
                {"id": 1, "start": 1.0, "end": 2.0, "text": " world"}]
        for s in segs:
            if on_segment:
                on_segment(s)
        return STTOutput(text="hello world", segments=segs, language="en", duration=2.0)


class SlowSTT:
    def __init__(self, out=STTOutput):
        self.calls = 0
        self.out = out

    def generate(self, audio, **kw):
        self.calls += 1
        return self.out(text=f"t{self.calls}:{len(audio)}", segments=[], language="en",
                        duration=len(audio) / 16000)


def _provider_of(model):
    class P(srv.ModelProvider):
        def load_model(self, name):
            return model

    return P()


@pytest.fixture(scope="module")
def server_url():
    httpd, url = _serve(FakeProvider())
    yield url
    _stop(httpd)


def test_health_root_and_ui(server_url):
    with urllib.request.urlopen(server_url + "/health") as r:
        assert json.loads(r.read()) == {"status": "ok"}
    with urllib.request.urlopen(server_url + "/") as r:
        body = json.loads(r.read())
    assert r.status == 200 and "/v1/audio/speech" in body["endpoints"]
    with urllib.request.urlopen(server_url + "/ui") as r:
        html = r.read().decode()
        assert r.headers.get_content_type() == "text/html"
    assert "mlx_audio_tpu studio" in html and "/v1/audio/speech" in html


def test_speech_endpoint_returns_wav(server_url):
    status, body, headers = _post_json(server_url + "/v1/audio/speech",
                                       {"model": "kokoro-test", "input": "Hello!"})
    assert status == 200 and body[:4] == b"RIFF" and "audio/wav" in headers["Content-Type"]


def test_transcription_endpoint_multipart(server_url):
    wav = audio_io.encode_bytes(np.zeros(16000, np.float32), 16000, "wav")
    body, _ = _multipart(server_url, {"model": "whisper-test"}, wav)
    assert json.loads(body)["text"] == "hello world"


def test_model_crud_both_styles(server_url):
    status, body, _ = _post_json(server_url + "/v1/models", {"model_name": "kokoro-crud"})
    assert status == 200 and json.loads(body)["status"] == "success"
    with urllib.request.urlopen(server_url + "/v1/models") as r:
        assert "kokoro-crud" in [m["id"] for m in json.loads(r.read())["data"]]
    req = urllib.request.Request(server_url + "/v1/models/kokoro-crud", method="DELETE")
    with urllib.request.urlopen(req) as r:
        assert json.loads(r.read()) == {"status": "unloaded", "model": "kokoro-crud"}
    # the reference's query style: POST / DELETE ?model_name=, 204 on delete
    req = urllib.request.Request(f"{server_url}/v1/models?model_name=test-tts-q",
                                 method="POST")
    with urllib.request.urlopen(req) as r:
        assert json.loads(r.read())["status"] == "success"
    req = urllib.request.Request(f"{server_url}/v1/models?model_name=test-tts-q",
                                 method="DELETE")
    with urllib.request.urlopen(req) as r:
        assert r.status == 204
    assert _http_error(lambda: urllib.request.urlopen(req)).code == 404
    # a JSON body on DELETE /v1/models
    _post_json(server_url + "/v1/models", {"model": "m-body"})
    status, body, _ = _post_json(server_url + "/v1/models", {"model_name": "m-body"},
                                 method="DELETE")
    assert json.loads(body)["status"] == "unloaded"


def test_missing_model_name_400_and_unknown_route_404(server_url):
    req = urllib.request.Request(server_url + "/v1/models", data=b"{}", method="POST",
                                 headers={"Content-Type": "application/json"})
    assert _http_error(lambda: urllib.request.urlopen(req)).code == 400
    assert _http_error(lambda: urllib.request.urlopen(server_url + "/nope")).code == 404
    req = urllib.request.Request(server_url + "/nope", data=b"{}", method="POST")
    assert _http_error(lambda: urllib.request.urlopen(req)).code == 404


def test_options_answers_cors(server_url):
    req = urllib.request.Request(server_url + "/v1/audio/speech", method="OPTIONS")
    with urllib.request.urlopen(req) as r:
        assert r.status == 204
        assert r.headers["Access-Control-Allow-Origin"] == "*"
        assert "POST" in r.headers["Access-Control-Allow-Methods"]


def test_generate_speech_streams_per_segment():
    class MultiSegTTS:
        def generate(self, text, **kwargs):
            for _ in range(3):
                yield GenerationResult(audio=np.full(1200, 0.5, np.float32), samples=1200,
                                       sample_rate=24000)

    p = _provider_of(MultiSegTTS())
    chunks = list(srv.generate_speech({"model": "m", "input": "x"}, p))
    assert len(chunks) == 4 and chunks[0][:4] == b"RIFF"  # header + 3 segments
    x, sr = audio_io.read(b"".join(chunks))
    assert sr == 24000 and x.shape[0] == 3600 and np.allclose(x, 0.5, atol=1e-3)
    chunks = list(srv.generate_speech({"model": "m", "input": "x", "response_format": "pcm"},
                                      p))
    assert len(chunks) == 3 and np.frombuffer(b"".join(chunks), "<i2").shape[0] == 3600
    # identical bytes to the JAX package's handler for the same segments
    jchunks = list(jsrv.generate_speech({"model": "m", "input": "x"}, _jax_provider_of(
        MultiSegTTS())))
    assert jchunks == list(srv.generate_speech({"model": "m", "input": "x"}, p))


def _jax_provider_of(model):
    class P(jsrv.ModelProvider):
        def load_model(self, name):
            return model

    return P()


def test_transcribe_audio_stream_ndjson():
    wav = audio_io.encode_bytes(np.zeros(16000, np.float32), 16000, "wav")
    lines = list(srv.transcribe_audio_stream(wav, {"model": "m"}, _provider_of(SegmentedSTT())))
    objs = [json.loads(line) for line in lines]
    assert [o.get("text") for o in objs[:2]] == ["hello", " world"]
    assert objs[-1]["type"] == "done" and objs[-1]["text"] == "hello world"


def test_transcription_endpoint_streaming_and_bad_audio():
    httpd, url = _serve(_provider_of(SegmentedSTT()))
    try:
        wav = audio_io.encode_bytes(np.zeros(16000, np.float32), 16000, "wav")
        body, headers = _multipart(url, {"model": "m", "stream": "true"}, wav)
        assert "ndjson" in headers["Content-Type"]
        objs = [json.loads(line) for line in body.splitlines() if line.strip()]
        assert len(objs) == 3 and objs[-1]["type"] == "done"
        # a corrupt upload with stream=true: a clean JSON error status, not a
        # corrupted chunked body
        err = _http_error(lambda: _multipart(url, {"stream": "true"}, b"NOTAWAVFILE"))
        assert err.code == 500 and "error" in json.loads(err.read())
        # not multipart: 400
        req = urllib.request.Request(url + "/v1/audio/transcriptions", data=b"{}",
                                     method="POST",
                                     headers={"Content-Type": "application/json"})
        assert _http_error(lambda: urllib.request.urlopen(req)).code == 400
    finally:
        _stop(httpd)


# ---------------------------------------------------------------------------
# WebSocket routes and codec
# ---------------------------------------------------------------------------


def test_ws_codec_matches_jax_byte_for_byte(monkeypatch):
    """The same messages with the same masks: identical frames, each side
    reads the other's, pings answered with the same pong."""
    masks = iter(range(1 << 20))

    def urandom(n):
        return bytes((next(masks) * 37 + i) % 256 for i in range(n))

    monkeypatch.setattr(jws.os, "urandom", urandom)
    monkeypatch.setattr(wsmod.os, "urandom", urandom)
    assert wsmod.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    out = {}
    for name, mod in (("jax", jws), ("port", wsmod)):
        masks = iter(range(1 << 20))
        buf = io.BytesIO()
        conn = mod.WebSocketConnection(io.BytesIO(), buf, mask_outgoing=True)
        conn.send_text("hello")
        conn.send_binary(b"\x00" * 200)
        conn.send_binary(bytes(range(256)) * 300)
        conn._send_frame(mod.OP_PING, b"hi")
        conn.close(1001)
        out[name] = buf.getvalue()
    assert out["jax"] == out["port"]
    for reader in (jws, wsmod):
        server = reader.WebSocketConnection(io.BytesIO(out["jax"]), io.BytesIO())
        assert server.recv() == (reader.OP_TEXT, b"hello")
        assert server.recv() == (reader.OP_BINARY, b"\x00" * 200)
        assert server.recv() == (reader.OP_BINARY, bytes(range(256)) * 300)
        assert server.recv() is None  # the ping answered, then the close
    # a fragmented message reassembles; server frames are unmasked
    frames = (bytes([0x01, 3]) + b"abc" + bytes([0x00, 2]) + b"de"
              + bytes([0x80, 1]) + b"f")
    for reader in (jws, wsmod):
        conn = reader.WebSocketConnection(io.BytesIO(frames), io.BytesIO())
        assert conn.recv() == (reader.OP_TEXT, b"abcdef")


def test_realtime_session_events_match_jax():
    """The same frames through both packages' sessions, with the energy gate
    and with a webrtcvad-style gate: the same events in the same order."""

    class FakeVad:
        def is_speech(self, chunk, sr):
            return float(np.abs(np.frombuffer(chunk, "<i2")).mean()) > 1000

    frames = ([_pcm(0.25, 0.0, seed=i) for i in range(6)]
              + [_pcm(0.25, 0.2, seed=10 + i) for i in range(9)]
              + [_pcm(0.25, 0.0, seed=20 + i) for i in range(3)]
              + [_pcm(0.1, 0.5, seed=30)] + [_pcm(0.25, 0.6, seed=40 + i) for i in range(5)])
    for gate in ("energy", "webrtc"):
        events = {}
        for name, mod, out in (("jax", jsrv, JaxSTTOutput), ("port", srv, STTOutput)):
            kw = {"vad_gate": mod.WebRTCGate(vad=FakeVad())} if gate == "webrtc" else {}
            s = mod.RealtimeSTTSession(SlowSTT(out), partial_interval=1.0, silence_gap=0.5,
                                       max_buffer=3.0, **kw)
            ev = [e for f in frames for e in s.feed(f)]
            ev.append(s.finalize())
            events[name] = ev
        assert events["port"] == events["jax"], gate
        assert any(e and e["type"] == "partial" for e in events["port"])
        assert any(e and e["type"] == "final" for e in events["port"])


def test_realtime_ws_routes():
    httpd, url = _serve(_provider_of(SlowSTT()))
    try:
        # frames straight away
        sock, conn = _ws_connect(url, "/v1/audio/transcriptions/realtime?model=test")
        conn.send_binary(_pcm(2.0, 0.2))
        op, payload = conn.recv()
        assert json.loads(payload)["type"] == "partial"
        conn.send_binary(_pcm(1.0, 0.0))
        op, payload = conn.recv()
        assert json.loads(payload)["type"] == "final"
        conn.close()
        sock.close()
        # config first, then frames, then finalize
        sock, conn = _ws_connect(url, "/v1/audio/transcriptions/realtime")
        conn.send_text(json.dumps({"model": "test-model"}))
        assert json.loads(conn.recv()[1])["status"] == "ready"
        conn.send_binary(_pcm(2.0, 0.2))
        assert json.loads(conn.recv()[1])["type"] == "partial"
        conn.send_text(json.dumps({"command": "finalize"}))
        assert json.loads(conn.recv()[1])["type"] == "final"
        sock.close()
        # a close without finalize: the final transcript comes BEFORE the
        # server's Close frame
        sock, conn = _ws_connect(url, "/v1/audio/transcriptions/realtime?model=m")
        conn.auto_close_reply = False
        conn.send_binary(_pcm(0.5, 0.2))
        conn.close()
        op, payload = conn.recv()
        assert op == wsmod.OP_TEXT and json.loads(payload)["type"] == "final"
        nxt = conn.recv()
        assert nxt is None or nxt[0] == wsmod.OP_CLOSE
        sock.close()
    finally:
        _stop(httpd)


def test_streaming_tts_ws_route():
    class TwoSegTTS:
        def generate(self, text, **kw):
            for i in range(2):
                yield GenerationResult(audio=np.full(2400, 0.25, np.float32), samples=2400,
                                       sample_rate=24000, segment_idx=i)

    httpd, url = _serve(_provider_of(TwoSegTTS()))
    try:
        sock, conn = _ws_connect(url, "/v1/audio/speech/stream")
        conn.send_text(json.dumps({"model": "k", "input": "hello"}))
        start = json.loads(conn.recv()[1])
        assert start == {"type": "start", "sample_rate": 24000}
        pcm, done = _ws_audio(conn)
        assert done == {"type": "done", "segments": 2}
        x = np.frombuffer(pcm, "<i2")
        assert len(x) == 4800 and abs(x[0] / 32767.0 - 0.25) < 1e-3
        conn.send_text(json.dumps({"model": "k"}))  # errors keep the connection
        assert json.loads(conn.recv()[1])["type"] == "error"
        conn.send_text("not json")
        assert json.loads(conn.recv()[1]) == {"type": "error", "error": "invalid JSON"}
        sock.close()
    finally:
        _stop(httpd)


def _ws_audio(conn):
    pcm = b""
    while True:
        op, payload = conn.recv()
        if op == wsmod.OP_TEXT:
            return pcm, json.loads(payload)
        pcm += payload


def test_webrtc_gate_and_factory(monkeypatch):
    class FakeVad:
        def __init__(self):
            self.calls = []

        def is_speech(self, chunk, sr):
            self.calls.append((len(chunk), sr))
            if sr != 16000:
                raise ValueError("bad rate")
            return float(np.abs(np.frombuffer(chunk, "<i2")).mean()) > 1000

    vad = FakeVad()
    gate = srv.WebRTCGate(sample_rate=16000, vad=vad)
    assert gate.frame_size == 480
    assert gate.has_speech(np.full(960, 0.5, np.float32)) is True
    assert gate.has_speech(np.zeros(960, np.float32)) is False
    assert all(n == 960 and sr == 16000 for n, sr in vad.calls)
    assert srv.WebRTCGate(sample_rate=8000, vad=FakeVad()).has_speech(
        np.zeros(8000, np.float32)) is True  # VAD errors assume speech
    assert gate.has_speech(np.full(100, 0.5, np.float32)) is True  # energy tail
    assert gate.has_speech(np.zeros(100, np.float32)) is False
    monkeypatch.setitem(__import__("sys").modules, "webrtcvad", None)
    assert isinstance(srv.make_vad_gate(), srv.EnergyGate)


def test_provider_refuses_the_dp_pool_and_main_refuses_uvicorn_flags(monkeypatch, tmp_path):
    monkeypatch.setenv("MLX_AUDIO_TPU_DP", "2")
    with pytest.raises(NotImplementedError, match="parallel"):
        srv.ModelProvider(device="cpu").load_model(str(tmp_path))
    for flags in (["--reload"], ["--workers", "2"]):
        with pytest.raises(SystemExit):
            srv.main(flags + ["--log-dir", str(tmp_path / "logs")])


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    """`main` without --device asks for the card, and raises before serving
    when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srv.main(["--port", "0", "--log-dir", str(tmp_path / "logs")])


# ---------------------------------------------------------------------------
# parity: the JAX server and the port's on the same checkpoint directories
# ---------------------------------------------------------------------------

QWEN_TEXT = "Hello there, world."
QWEN_SPEAKER = "vivian"


def _qwen_tokenizer(d):
    """A Qwen2-style byte-level BPE trained here, small enough for the tiny
    model's text vocabulary, with `assistant` one token (the model slices
    the chat prompt by position)."""
    tok = HFTokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    trainer = trainers.BpeTrainer(vocab_size=400, show_progress=False,
                                  special_tokens=["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["assistant user hello there world"] * 50, trainer)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2TokenizerFast", "clean_up_tokenization_spaces": False,
        "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>", "unk_token": None,
        "bos_token": None}))
    assert len(tok.encode("<|im_start|>assistant\n").ids) == 3
    assert tok.get_vocab_size() < QWEN_CFG["talker_config"]["text_vocab_size"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A tiny Whisper (biases and norms moved) with chip_smoke.py's
    Whisper-large-v3 tokenizer.json, and a tiny CustomVoice Qwen3-TTS (its
    decode capped by the text's length) with a trained Qwen2 tokenizer."""
    root = tmp_path_factory.mktemp("served")
    jm = JaxWhisper(JaxDims(**DIMS))
    rng = np.random.default_rng(0)
    flat = {}
    for k, v in jflat(jm).items():
        v = np.asarray(v)
        if k.endswith((".bias", ".weight")) and v.ndim == 1:
            v = v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
        flat[k] = v
    wdir = root / "whisper-tiny"
    jconvert.save_model(wdir, flat, dict(DIMS, model_type="whisper"))
    _chip_smoke().write_tokenizer_json(wdir, "whisper")

    cfg = copy.deepcopy(QWEN_CFG)
    cfg["tts_model_type"] = "custom_voice"
    cfg["talker_config"]["spk_id"] = {QWEN_SPEAKER: 220}
    jcfg = JaxQwenConfig.from_dict(cfg)
    jcfg.tokenizer_config.encoder_config = None
    jq = _moved(JaxQwen(jcfg), np.random.default_rng(0))
    qdir = root / "qwen3-tts-tiny"
    jconvert.save_model(qdir, {k: np.asarray(v) for k, v in jflat(jq).items()},
                        dict(cfg, model_type="qwen3_tts"))
    _qwen_tokenizer(qdir)
    return wdir, qdir


def _greedy(cls):
    orig = cls.generate

    @functools.wraps(orig)
    def generate(self, audio, **kw):
        kw.setdefault("temperature", 0.0)
        return orig(self, audio, **kw)

    return generate


@pytest.fixture(scope="module")
def servers(checkpoints):
    """The JAX package's stdlib server (no batcher: its warm-up compiles
    every bucket, minutes on the CPU) and the port's, on the CPU with its
    batchers installed and warmed."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jsrv, "BATCHING", False)
    mp.setattr(JaxWhisper, "generate", _greedy(JaxWhisper))
    mp.setattr(Whisper, "generate", _greedy(Whisper))
    mp.setattr(JaxQwen, "_tokenizer", None)
    mp.setattr(Qwen, "_tokenizer", None)
    jhttpd = jsrv.serve_stdlib("127.0.0.1", 0, jsrv.ModelProvider())
    host, port = jhttpd.server_address
    provider = srv.ModelProvider(device="cpu")
    phttpd, purl = _serve(provider)
    try:
        for url in (f"http://{host}:{port}", purl):
            for d in checkpoints:
                status, body, _ = _post_json(url + "/v1/models", {"model_name": str(d)})
                assert status == 200, body
        for d in checkpoints:
            assert provider.wait_warmup(str(d), timeout=600) is None
        yield f"http://{host}:{port}", purl, provider
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
        _stop(phttpd)
        for d in checkpoints:
            provider.unload(str(d))
        mp.undo()


def _same_json(got, want, where="$"):
    """Equal JSON, floats within FLOAT_REL: tokens, text and timestamps are
    exact; a probability or a mean log-probability is a float32 softmax or
    sum taken in another order by XLA and torch (1 float32 ulp seen)."""
    if isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= FLOAT_REL * abs(want), where
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same_json(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


FLOAT_REL = 1e-5


def _noise_wav(seconds=4.0, sr=16000, seed=3):
    x = (np.random.default_rng(seed).standard_normal(int(sr * seconds)) * 0.05).astype(
        np.float32)
    return audio_io.encode_bytes(x, sr, "wav")


def test_served_models_listed_and_batched(servers, checkpoints):
    jurl, purl, provider = servers
    for url in (jurl, purl):
        with urllib.request.urlopen(url + "/v1/models") as r:
            assert sorted(m["id"] for m in json.loads(r.read())["data"]) == sorted(
                map(str, checkpoints))
    for d in checkpoints:  # MLX_AUDIO_BATCHING defaults on: a batcher each
        assert get_infer_hook(provider.load_model(str(d))) is not None


@pytest.mark.parametrize("fields", [{"language": "en"}, {"language": "en",
                                                          "response_format": "verbose_json"}],
                         ids=["json", "verbose_json"])
def test_transcription_matches_jax_server(servers, checkpoints, fields):
    jurl, purl, _ = servers
    wav = _noise_wav()
    got = [json.loads(_multipart(url, dict(fields, model=str(checkpoints[0])), wav)[0])
           for url in (jurl, purl)]
    _same_json(got[1], got[0])
    assert got[0]["text"]  # the reader decoded some text
    # the text is the reader's decode of the in-memory model's tokens
    model = servers[2].load_model(str(checkpoints[0]))
    x, _ = audio_io.read(wav)
    assert model.generate(x, language="en").text == got[1]["text"]


def test_streamed_transcription_matches_jax_server(servers, checkpoints):
    jurl, purl, _ = servers
    wav = _noise_wav(seed=4)
    bodies = [_multipart(url, {"model": str(checkpoints[0]), "stream": "true",
                               "language": "en"}, wav)[0] for url in (jurl, purl)]
    objs = [[json.loads(line) for line in b.splitlines() if line.strip()] for b in bodies]
    _same_json(objs[1], objs[0])
    assert objs[1][-1]["type"] == "done"


@pytest.mark.parametrize("fmt", ["wav", "pcm"])
def test_speech_matches_jax_server(servers, checkpoints, fmt):
    """Greedy CustomVoice speech: the same header, int16 samples within one
    step (float32 on both sides, summed in other orders)."""
    jurl, purl, _ = servers
    payload = {"model": str(checkpoints[1]), "input": QWEN_TEXT, "voice": QWEN_SPEAKER,
               "temperature": 0.0, "response_format": fmt}
    bodies = [_post_json(url + "/v1/audio/speech", payload)[1] for url in (jurl, purl)]
    skip = 44 if fmt == "wav" else 0
    assert bodies[1][:skip] == bodies[0][:skip]
    a, b = (np.frombuffer(x[skip:], "<i2").astype(np.int32) for x in bodies)
    assert a.shape == b.shape and a.size > 0
    assert np.abs(a - b).max() <= 1


def test_speech_ws_equals_http_body(servers, checkpoints):
    """The port's /v1/audio/speech/stream: the binary frames concatenate to
    the HTTP body's samples (both stream the decode, greedy)."""
    _, purl, _ = servers
    req = {"model": str(checkpoints[1]), "input": QWEN_TEXT, "voice": QWEN_SPEAKER,
           "temperature": 0.0, "streaming_interval": 0.8}
    body = _post_json(purl + "/v1/audio/speech", dict(req, response_format="pcm"))[1]
    sock, conn = _ws_connect(purl, "/v1/audio/speech/stream")
    try:
        conn.send_text(json.dumps(req))
        assert json.loads(conn.recv()[1])["type"] == "start"
        pcm, done = _ws_audio(conn)
    finally:
        sock.close()
    assert done["type"] == "done" and done["segments"] > 1  # streamed in chunks
    assert pcm == body


def test_realtime_ws_final_equals_generate(servers, checkpoints):
    """/v1/audio/transcriptions/realtime on the served Whisper: a burst then
    silence gives a `final` whose text is `generate` on the same buffer."""
    _, purl, provider = servers
    burst = _pcm(1.0, 0.3, seed=7)
    silence = _pcm(0.25, 0.0)
    sock, conn = _ws_connect(purl, "/v1/audio/transcriptions/realtime?model="
                             + str(checkpoints[0]))
    try:
        for i in range(0, len(burst), 6400):
            conn.send_binary(burst[i:i + 6400])
        events = []
        for _ in range(3):
            conn.send_binary(silence)
        while not any(e["type"] == "final" for e in events):
            events.append(json.loads(conn.recv()[1]))
    finally:
        sock.close()
    buf = np.frombuffer(burst + silence * 2, np.int16).astype(np.float32) / 32768.0
    model = provider.load_model(str(checkpoints[0]))
    assert events[-1]["text"] == model.generate(buf).text


def test_delete_closes_the_batcher(checkpoints, tmp_path):
    """DELETE /v1/models/<id> closes the model's batcher: its scheduler
    thread ends and the infer hook goes."""
    provider = srv.ModelProvider(device="cpu")
    httpd, url = _serve(provider)
    try:
        name = str(checkpoints[1])
        _post_json(url + "/v1/models", {"model_name": name})
        assert provider.wait_warmup(name, timeout=600) is None
        model = provider.load_model(name)
        batcher = get_infer_hook(model)
        assert batcher is not None and batcher._thread.is_alive()
        req = urllib.request.Request(f"{url}/v1/models/{name}", method="DELETE")
        with urllib.request.urlopen(req) as r:
            assert json.loads(r.read())["status"] == "unloaded"
        batcher._thread.join(30)
        assert not batcher._thread.is_alive() and get_infer_hook(model) is None
    finally:
        _stop(httpd)


def test_warmup_records_its_exception(monkeypatch):
    class Batcher:
        def install(self):
            return self

        def warmup(self):
            raise RuntimeError("no warm-up today")

    class M:
        def make_batcher(self):
            return Batcher()

    monkeypatch.setattr("mlx_audio_tpu_torch.utils.load_model", lambda name, **kw: M())
    p = srv.ModelProvider(device="cpu")
    p.load_model("x")
    err = p.wait_warmup("x", timeout=30)
    assert isinstance(err, RuntimeError) and "no warm-up" in str(err)
    assert p.wait_warmup("not loaded") is None
