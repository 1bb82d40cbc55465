"""The port's AlignAtt streaming (streaming.py, `Model.generate_streaming`,
`generate(stream=True)`) against the JAX package's, on the tiny
shared-weight pair of test_torch_whisper.py.

Greedy decoding: the tokens and text of every chunk identical. The JAX side
runs with `jax_residual` (see test_torch_whisper.py), since each streamed
step is its score-capturing decoder pass. The seeded weights attend
anywhere in the 1500 frames, so a threshold of -1400 frames (stop only when
the newest token looks 1400 frames past the audio heard) lets a chunk emit
several tokens before the AlignAtt stop.
"""

import numpy as np
import pytest
from test_torch_whisper import jax_residual, one_torch_thread, pair  # noqa: F401 (fixtures)

from mlx_audio_tpu.stt.models.whisper import Model as JaxModel
from mlx_audio_tpu.stt.models.whisper import streaming as jax_streaming
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu_torch.stt.models.whisper import Model, streaming
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

V = 51866
THRESHOLD = -1400


@pytest.fixture(scope="module")
def audio():
    return (np.random.default_rng(31).standard_normal(16000 * 3) * 0.05).astype(np.float32)


def _fields(r):
    return (r.text, list(r.tokens), r.is_final, r.start_time, r.end_time, r.progress,
            r.audio_position, r.audio_duration, r.language)


def test_decode_chunk_three_chunks(pair, audio, jax_residual):
    jm, pm = pair
    ours = streaming.StreamingDecoder(pm, streaming.StreamingConfig(frame_threshold=THRESHOLD),
                                      tokenizer=DummyTokenizer(n_vocab=V))
    theirs = jax_streaming.StreamingDecoder(
        jm, jax_streaming.StreamingConfig(frame_threshold=THRESHOLD),
        tokenizer=JaxTok(n_vocab=V))
    n_tokens = 0
    for i in range(3):
        chunk = audio[16000 * i:16000 * (i + 1)]
        mel = np.asarray(JaxModel._mel_chunk(chunk, 80))[:100]
        got = ours.decode_chunk(mel, is_last=i == 2)
        ref = theirs.decode_chunk(mel, is_last=i == 2)
        assert _fields(got) == _fields(ref), i
        n_tokens += len(got.tokens)
    assert n_tokens >= 3


@pytest.mark.parametrize("route", ["generate_streaming", "stream=True", "detect_language"])
def test_generate_streaming_matches_jax(pair, audio, jax_residual, monkeypatch, route):
    jm, pm = pair
    kw = dict(chunk_duration=0.75, language="en")
    if route == "generate_streaming":
        ref = jm.generate_streaming(audio, tokenizer=JaxTok(n_vocab=V),
                                    frame_threshold=THRESHOLD, **kw)
        got = pm.generate_streaming(audio, tokenizer=DummyTokenizer(n_vocab=V),
                                    frame_threshold=THRESHOLD, **kw)
    elif route == "stream=True":
        ref = jm.generate(audio, tokenizer=JaxTok(n_vocab=V), stream=True, **kw)
        got = pm.generate(audio, tokenizer=DummyTokenizer(n_vocab=V), stream=True, **kw)
    else:  # no language and no tokenizer: detected on the first 30 s
        monkeypatch.setattr(JaxModel, "get_tokenizer",
                            lambda self, language="en", task="transcribe": JaxTok(n_vocab=V))
        monkeypatch.setattr(Model, "get_tokenizer",
                            lambda self, language="en", task="transcribe":
                            DummyTokenizer(n_vocab=V))
        ref = jm.generate_streaming(audio, chunk_duration=0.75)
        got = pm.generate_streaming(audio, chunk_duration=0.75)
    ref, got = list(ref), list(got)
    assert [_fields(r) for r in got] == [_fields(r) for r in ref]
    assert got[-1].is_final and got[-1].progress == 1.0
    assert got[-1].language in ("en", "es")
