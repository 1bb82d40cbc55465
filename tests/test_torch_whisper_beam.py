"""The port's Whisper beam search (decoding.py `_beam_decode_loop`,
`_run_beam`) against the JAX package's, on the tiny shared-weight pair of
test_torch_whisper.py.

The seeded weights give distinct finite candidate scores, so `torch.topk`
and `jax.lax.top_k` rank them alike; tokens must be identical, log-probs
within the f32 bar 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_whisper import ATOL, one_torch_thread, pair  # noqa: F401 (fixtures)

from mlx_audio_tpu.stt.models.whisper import Model as JaxModel
from mlx_audio_tpu.stt.models.whisper import decoding as jax_decoding
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu_torch.lm.cache import KVCache
from mlx_audio_tpu_torch.stt.models.whisper import decoding
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

V = 51866


@pytest.fixture(scope="module")
def encoded(pair):
    """Two windows' encoder K/V on both sides."""
    jm, pm = pair
    mel = (np.random.default_rng(11).standard_normal((2, 3000, 80)) * 0.5).astype(np.float32)
    _, jkv = JaxModel._encode(jm, jnp.asarray(mel))
    _, kv = pm._encode(torch.from_numpy(mel))
    return jkv, kv


def _decode_both(pair, encoded, rows=(0,), sample_len=20, **opts):
    jm, pm = pair
    jkv, kv = encoded
    sel = np.asarray(rows)
    jkv = [(k[sel], v[sel]) for k, v in jkv]
    kv = [(k[sel], v[sel]) for k, v in kv]
    jtok, tok = JaxTok(n_vocab=V), DummyTokenizer(n_vocab=V)
    ref = jax_decoding.decode_window_batch(
        jm, jkv, jtok, [list(jtok.sot_sequence)] * len(rows),
        jax_decoding.DecodingOptions(language="en", **opts), n_ctx=448, n_vocab=V,
        decoder_step=JaxModel._decoder_step, make_caches=jm._make_caches,
        sample_len=sample_len)
    got = decoding.decode_window_batch(
        pm, kv, tok, [list(tok.sot_sequence)] * len(rows),
        decoding.DecodingOptions(language="en", **opts), n_ctx=448, n_vocab=V,
        decoder_step=type(pm)._decoder_step, make_caches=pm._make_caches,
        sample_len=sample_len)
    return got, ref


def _same(got, ref):
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    for a, b in zip(got, ref):
        assert abs(a.avg_logprob - b.avg_logprob) < ATOL
        assert abs(a.no_speech_prob - b.no_speech_prob) < ATOL
        assert a.text == b.text and a.temperature == b.temperature == 0.0


@pytest.mark.parametrize("without_timestamps", [False, True], ids=["timestamps", "no_timestamps"])
def test_beam1_equals_greedy(pair, encoded, without_timestamps):
    greedy, _ = _decode_both(pair, encoded, temperature=0.0,
                             without_timestamps=without_timestamps)
    beam1, ref = _decode_both(pair, encoded, temperature=0.0, beam_size=1,
                              without_timestamps=without_timestamps)
    assert beam1[0].tokens == greedy[0].tokens
    assert abs(beam1[0].avg_logprob - greedy[0].avg_logprob) < ATOL
    _same(beam1, ref)


@pytest.mark.parametrize("opts", [
    dict(beam_size=3), dict(beam_size=3, without_timestamps=True),
    dict(beam_size=3, patience=2.0), dict(beam_size=4, length_penalty=0.5),
], ids=["k3", "k3_no_timestamps", "k3_patience2", "k4_length_penalty"])
def test_beam_matches_jax(pair, encoded, opts):
    got, ref = _decode_both(pair, encoded, temperature=0.0, **opts)
    assert got[0].tokens
    _same(got, ref)


def test_beam_batch_of_two_equals_per_window(pair, encoded):
    both, ref = _decode_both(pair, encoded, rows=(0, 1), temperature=0.0, beam_size=3)
    _same(both, ref)
    for i in (0, 1):
        one, _ = _decode_both(pair, encoded, rows=(i,), temperature=0.0, beam_size=3)
        assert one[0].tokens == both[i].tokens
        assert abs(one[0].avg_logprob - both[i].avg_logprob) < ATOL


def test_generate_chunked_beam(pair):
    jm, pm = pair
    audio = (np.random.default_rng(12).standard_normal(16000 * 40) * 0.05).astype(np.float32)
    kw = dict(language="en", temperature=0.0, sample_len=12, beam_size=3)
    ref = jm.generate_chunked(audio, tokenizer=JaxTok(n_vocab=V), **kw)
    out = pm.generate_chunked(audio, tokenizer=DummyTokenizer(n_vocab=V), **kw)
    assert len(out.segments) == len(ref.segments) == 2
    assert out.text == ref.text
    for s, r in zip(out.segments, ref.segments):
        assert s["tokens"] == r["tokens"]
        assert (s["start"], s["end"]) == (r["start"], r["end"])
        assert abs(s["avg_logprob"] - r["avg_logprob"]) < ATOL


def test_kv_cache_reorder():
    """Rows gather their written part; the rest of the buffer stays."""
    cache = KVCache(3, 2, 8, 4, dtype=torch.float32, device="cpu")
    k = torch.arange(3 * 2 * 5 * 4, dtype=torch.float32).view(3, 2, 5, 4)
    cache.update(k, -k)
    cache.reorder(torch.tensor([2, 2, 0]))
    assert torch.equal(cache.k[:, :, :5], k[[2, 2, 0]])
    assert torch.equal(cache.v[:, :, :5], -k[[2, 2, 0]])
    assert not cache.k[:, :, 5:].any() and cache.pos == 5


def _port_decode(pm, kv, rows, **opts):
    kv = [(k[list(rows)], v[list(rows)]) for k, v in kv]
    tok = DummyTokenizer(n_vocab=V)
    return decoding.decode_window_batch(
        pm, kv, tok, [list(tok.sot_sequence)] * len(rows),
        decoding.DecodingOptions(language="en", **opts), n_ctx=448, n_vocab=V,
        decoder_step=type(pm)._decoder_step, make_caches=pm._make_caches, sample_len=40)


@pytest.mark.parametrize("best_of", [1, 2])
def test_sampled_windows_draw_alone_what_they_draw_batched(pair, encoded, best_of):
    """At t > 0 each sample row draws its Gumbel noise from a generator of
    its own (the window's seed + j), so a window batched beside another
    decodes the tokens it decodes alone, across more than one
    `uniform_noise` draw (40 steps, 16 a draw)."""
    _, pm = pair
    kv = encoded[1]
    opts = dict(temperature=0.7, best_of=best_of, without_timestamps=True)
    both = _port_decode(pm, kv, (0, 1), **opts)
    alone = [_port_decode(pm, kv, (i,), **opts)[0] for i in (0, 1)]
    assert [r.tokens for r in both] == [r.tokens for r in alone]
    assert max(len(r.tokens) for r in both) > decoding.NOISE_STEPS
