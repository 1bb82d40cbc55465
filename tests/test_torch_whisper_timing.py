"""The port's Whisper word timing (timing.py and the score-capturing decoder
passes) against the JAX package's, on the tiny shared-weight pair of
test_torch_whisper.py.

The DTW, the median filter and the punctuation merge are host numpy on both
sides: identical on identical input. Scores and logits at the f32 bar 1e-4;
words identical and their times equal to 0.01 s. The JAX side runs with
`jax_residual` (see test_torch_whisper.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_whisper import ATOL, jax_residual, one_torch_thread, pair  # noqa: F401 (fixtures)

from mlx_audio_tpu.stt.models.whisper import Model as JaxModel
from mlx_audio_tpu.stt.models.whisper import timing as jax_timing
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu_torch.stt.models.whisper import timing
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

V = 51866


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dtw_and_median_filter_identical(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 12, 40)).astype(np.float32)
    np.testing.assert_array_equal(timing.median_filter(x, 7), jax_timing.median_filter(x, 7))
    cost = -rng.random((9, 30))
    got, ref = timing.dtw(cost.copy()), jax_timing.dtw(cost.copy())
    np.testing.assert_array_equal(got, ref)
    assert got.shape[0] == 2 and got[0, -1] == 8 and got[1, -1] == 29


def test_merge_punctuations_identical():
    def words():
        return [timing.WordTiming(w, [i], i * 0.1, i * 0.1 + 0.1, 0.5) for i, w in
                enumerate([" (", " Hello", ",", " world", "!", " \"", " again", "."])]

    ours = words()
    theirs = [jax_timing.WordTiming(w.word, list(w.tokens), w.start, w.end, w.probability)
              for w in words()]
    timing.merge_punctuations(ours, "\"'“¿([{-", "\"'.。,，!！?？:：”)]}、")
    jax_timing.merge_punctuations(theirs, "\"'“¿([{-", "\"'.。,，!！?？:：”)]}、")
    assert [(w.word, w.tokens) for w in ours] == [(w.word, w.tokens) for w in theirs]
    assert ours[1].word == " ( Hello," and ours[-2].word == " \" again."


@pytest.fixture(scope="module")
def encoded(pair):
    jm, pm = pair
    mel = np.random.default_rng(5).standard_normal((1, 3000, 80)).astype(np.float32)
    _, jkv = JaxModel._encode(jm, jnp.asarray(mel))
    _, kv = pm._encode(torch.from_numpy(mel))
    return mel, jkv, kv


def test_call_with_qk(pair, encoded):
    jm, pm = pair
    _, jkv, kv = encoded
    x = np.random.default_rng(6).standard_normal((1, 5, 64)).astype(np.float32)
    jout, jqk = jm.decoder.blocks[1].cross_attn.call_with_qk(jnp.asarray(x), jkv[1])
    with torch.inference_mode():
        out, qk = pm.decoder.blocks[1].cross_attn.call_with_qk(torch.from_numpy(x), kv[1])
    assert qk.dtype == torch.float32 and tuple(qk.shape) == (1, 2, 5, 1500)
    np.testing.assert_allclose(qk.numpy(), np.asarray(jqk), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)


def test_forward_with_cross_qk(pair, encoded, jax_residual):
    """Scores and logits of the whole-sequence pass equal the JAX one's, and
    its logits equal the decoder's own forward."""
    jm, pm = pair
    mel, jkv, kv = encoded
    toks = np.random.default_rng(7).integers(0, 50000, (1, 11))
    jl, jqks = jm.forward_with_cross_qk(mel, toks)
    lg, qks = pm.forward_with_cross_qk(mel, toks)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL)
    for qk, jqk in zip(qks, jqks):
        np.testing.assert_allclose(qk.numpy(), np.asarray(jqk), atol=ATOL)
    with torch.inference_mode():
        plain, _ = pm.decoder(torch.from_numpy(toks), 0, None, kv)
        via_kv, _ = pm.decoder_cross_qk(kv, toks)
        np.testing.assert_allclose(lg.numpy(), plain.numpy(), atol=1e-5)
        np.testing.assert_allclose(via_kv.numpy(), lg.numpy(), atol=1e-5)
        np.testing.assert_allclose(pm.logits(toks, pm.embed_audio(mel)).numpy(), lg.numpy(),
                                   atol=1e-5)


def test_step_with_qk(pair, encoded, jax_residual):
    """A 4-token prefill, then two steps that return their scores."""
    jm, pm = pair
    _, jkv, kv = encoded
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, 50000, (1, 4))
    jc, caches = jm._make_caches(1, 64), pm._make_caches(1, 64)
    _, jc = JaxModel._decoder_step(jm, jnp.asarray(prompt, jnp.int32), 0, jc, jkv)
    with torch.inference_mode():
        Model = type(pm)
        _, caches = Model._decoder_step(pm, torch.from_numpy(prompt), 0, caches, kv)
        for pos in (4, 5):
            tok = rng.integers(0, 50000, (1, 1))
            jl, jc, jqks = jm.decoder.step_with_qk(jnp.asarray(tok, jnp.int32), pos, jc, jkv)
            lg, caches, qks = pm.decoder.step_with_qk(torch.from_numpy(tok), pos, caches, kv)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL)
            for qk, jqk in zip(qks, jqks):
                np.testing.assert_allclose(qk.numpy(), np.asarray(jqk), atol=ATOL)


def _same_words(got, ref):
    assert [w.word for w in got] == [w.word for w in ref]
    assert [w.tokens for w in got] == [list(w.tokens) for w in ref]
    for a, b in zip(got, ref):
        assert abs(a.start - b.start) <= 0.01 and abs(a.end - b.end) <= 0.01
        assert abs(a.probability - b.probability) < ATOL


@pytest.mark.parametrize("route", ["mel", "cross_kv"])
def test_find_alignment(pair, encoded, jax_residual, route):
    """Both routes of find_alignment; the JAX package pads the token row to
    a bucket of 64, the port does not, and the words agree."""
    jm, pm = pair
    mel, jkv, kv = encoded
    text = [int(t) for t in np.random.default_rng(9).integers(0, 50000, 13)]
    jtok, tok = JaxTok(n_vocab=V), DummyTokenizer(n_vocab=V)
    if route == "mel":
        ref = jax_timing.find_alignment(jm, jtok, text, mel[0], 2400)
        got = timing.find_alignment(pm, tok, text, mel[0], 2400)
    else:
        ref = jax_timing.find_alignment(jm, jtok, text, None, 2400, cross_kv=jkv)
        got = timing.find_alignment(pm, tok, text, None, 2400, cross_kv=kv)
    assert len(got) == 6  # 13 tokens and EOT, two a word; the EOT word has no end
    _same_words(got, ref)


def _words(out):
    return [[(w["word"], w["start"], w["end"], w["probability"]) for w in s["words"]]
            for s in out.segments]


@pytest.mark.parametrize("conditioned", [False, True], ids=["unconditioned", "conditioned"])
def test_generate_chunked_word_timestamps(pair, jax_residual, conditioned):
    jm, pm = pair
    audio = (np.random.default_rng(3).standard_normal(16000 * 40) * 0.05).astype(np.float32)
    kw = dict(language="en", temperature=0.0, sample_len=12, without_timestamps=True,
              word_timestamps=True, condition_on_previous_text=conditioned)
    ref = jm.generate_chunked(audio, tokenizer=JaxTok(n_vocab=V), **kw)
    out = pm.generate_chunked(audio, tokenizer=DummyTokenizer(n_vocab=V), **kw)
    assert len(out.segments) == len(ref.segments) == 2
    assert [s["tokens"] for s in out.segments] == [s["tokens"] for s in ref.segments]
    got, want = _words(out), _words(ref)
    assert [[w[0] for w in s] for s in got] == [[w[0] for w in s] for s in want]
    assert sum(map(len, got)) >= 8
    for s, r in zip(got, want):
        for a, b in zip(s, r):
            assert abs(a[1] - b[1]) <= 0.01 and abs(a[2] - b[2]) <= 0.01
            assert abs(a[3] - b[3]) < ATOL
    for s, r in zip(out.segments, ref.segments):
        assert abs(s["start"] - r["start"]) <= 0.01 and abs(s["end"] - r["end"]) <= 0.01
