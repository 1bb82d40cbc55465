"""The port's sequential seek loop (`Model.generate`) against the JAX
package's, on the tiny shared-weight pair of test_torch_whisper.py.

Greedy decoding (t = 0, or a temperature tuple whose thresholds are off, so
that the fallback stops at its first temperature): tokens, texts, segment
bounds and word lists identical, word times equal to 0.01 s, log-probs
within the f32 bar 1e-4. The JAX side runs with `jax_residual` (see
test_torch_whisper.py), since word timing reads its score pass.
"""

import numpy as np
import pytest
from test_torch_whisper import ATOL, jax_residual, one_torch_thread, pair  # noqa: F401 (fixtures)

from mlx_audio_tpu.stt.models.whisper import whisper as jax_whisper
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu_torch.stt.models.whisper import whisper
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

V = 51866
GREEDY = dict(language="en", temperature=0.0, sample_len=12)


@pytest.fixture(scope="module")
def audio():
    return (np.random.default_rng(21).standard_normal(16000 * 40) * 0.05).astype(np.float32)


def _same_transcript(out, ref):
    assert out.text == ref.text and out.language == ref.language
    assert len(out.segments) == len(ref.segments) > 0
    for s, r in zip(out.segments, ref.segments):
        assert s["tokens"] == r["tokens"] and s["text"] == r["text"]
        assert (s["id"], s["seek"], s["start"], s["end"]) == (r["id"], r["seek"], r["start"],
                                                               r["end"])
        assert s["temperature"] == r["temperature"]
        assert abs(s["avg_logprob"] - r["avg_logprob"]) < ATOL
        assert abs(s["no_speech_prob"] - r["no_speech_prob"]) < ATOL
        assert [w["word"] for w in s.get("words", [])] == [w["word"] for w in r.get("words", [])]
        for a, b in zip(s.get("words", []), r.get("words", [])):
            assert abs(a["start"] - b["start"]) <= 0.01 and abs(a["end"] - b["end"]) <= 0.01
            assert abs(a["probability"] - b["probability"]) < ATOL
    assert out.generation_tokens == ref.generation_tokens


CASES = {
    "no_timestamps": (40, dict(GREEDY, without_timestamps=True)),
    "timestamps": (40, dict(GREEDY)),
    "conditioned": (40, dict(GREEDY, condition_on_previous_text=True)),
    "initial_prompt": (40, dict(GREEDY, initial_prompt="hello there")),
    "clip_0_20": (40, dict(GREEDY, clip_timestamps="0,20", without_timestamps=True)),
    "no_speech_skip": (40, dict(GREEDY, no_speech_threshold=0.0, logprob_threshold=None)),
    # the seeded weights' timestamp segments hold no text (blanked), so
    # the word cases decode without timestamps; one case keeps them
    "word_timestamps": (10, dict(GREEDY, word_timestamps=True, without_timestamps=True)),
    "word_timestamps_blank": (10, dict(GREEDY, word_timestamps=True)),
    "hallucination_skip": (10, dict(GREEDY, word_timestamps=True, without_timestamps=True,
                                    hallucination_silence_threshold=0.5)),
    "temperature_tuple": (40, dict(language="en", temperature=(0.0, 0.2), sample_len=12,
                                   compression_ratio_threshold=None, logprob_threshold=None)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax(pair, audio, jax_residual, case):
    jm, pm = pair
    seconds, kw = CASES[case]
    clip = audio[:16000 * seconds]
    ref = jm.generate(clip, tokenizer=JaxTok(n_vocab=V), **kw)
    seen = []
    out = pm.generate(clip, tokenizer=DummyTokenizer(n_vocab=V), on_segment=seen.append, **kw)
    if case == "no_speech_skip":
        assert out.segments == ref.segments == [] and out.text == ref.text == ""
        return
    _same_transcript(out, ref)
    assert seen == out.segments
    if case == "clip_0_20":
        assert out.segments[-1]["end"] <= 20.0
    if case in ("word_timestamps", "hallucination_skip"):
        assert sum(len(s["words"]) for s in out.segments) > 0


SEGMENTS = [
    [],
    [{"start": 0.0, "end": 1.0, "words": []}],
    [{"start": 0.0, "end": 2.0, "words": [
        {"word": " a", "start": 0.0, "end": 0.05, "probability": 0.1},
        {"word": " b", "start": 0.05, "end": 3.5, "probability": 0.9}]},
     {"start": 2.0, "end": 4.0, "words": [
         {"word": ",", "start": 2.0, "end": 2.01, "probability": 0.01},
         {"word": " c", "start": 2.0, "end": 2.5, "probability": 0.5}]}],
    [{"start": 1.0, "end": 3.0}, {"start": 3.0, "end": 6.0, "words": [
        {"word": " d", "start": 3.0, "end": 3.3, "probability": 0.9}]}],
]


@pytest.mark.parametrize("i", range(len(SEGMENTS)))
def test_seek_helpers_match_jax(i):
    segs = SEGMENTS[i]
    assert whisper._get_end(segs) == jax_whisper._get_end(segs)
    assert whisper._next_words_segment(segs) == jax_whisper._next_words_segment(segs)
    for s in segs + [None]:
        assert whisper._is_segment_anomaly(s) == jax_whisper._is_segment_anomaly(s)
        for w in (s or {}).get("words") or []:
            assert whisper._word_anomaly_score(w) == jax_whisper._word_anomaly_score(w)
