"""CosyVoice3 in the port against the JAX package on the CPU at
`tests/test_cosyvoice3.py`'s tiny sizes (the LM of two layers of 32 with 8
extended tokens, a DiT of two blocks of 32, a two-stage causal HiFT):

- the DiT, unmasked and chunk-masked (streaming);
- `tokens_to_mel` with the JAX package's noise, offline and streaming; the
  port pads the tokens to 50 as the JAX package does (the offline DiT
  attends over the padding rows there too), and under the chunk mask every
  chunk before the first padded one is padding-invariant;
- the causal HiFT with the JAX draws, finalized and not (the streaming
  cut);
- the LM's prompt and its decode with the JAX loop's draws replayed (the
  stop on any token ≥ V);
- the text frontend (`normalize_text`, `split_text`);
- `Model.generate` end to end (zero-shot, cross-lingual and voice
  conversion) with the JAX package's draws, `synthesize_streaming` chunk by
  chunk, and `generate_tokens` through the installed `RASBatcher`.

float32 bar: 1e-5 of each output's peak, 1e-4 for waveforms (HiFT's ISTFT
head); tokens identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.nn.module import flatten_params as jax_flatten
from mlx_audio_tpu.tts.models.cosyvoice3 import cosyvoice3 as jcv
from mlx_audio_tpu.tts.models.cosyvoice3 import dit as jdit
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.tts.models.cosyvoice3 import cosyvoice3 as pcv
from mlx_audio_tpu_torch.tts.models.cosyvoice3 import dit as pdit
from mlx_audio_tpu_torch.tts.models.cosyvoice3 import flow as pflow
from mlx_audio_tpu_torch.tts.models.cosyvoice3 import hifigan as phift
from mlx_audio_tpu_torch.tts.models.cosyvoice3.config import ModelConfig

from test_cosyvoice3 import tiny_config
from test_torch_cosyvoice2 import (WAV_BAR, FakeS3, FakeSpk, FakeTok, JaxDraws, _close, _t,
                                   interp_draws, jit_front_ends)
from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

V = 40


@pytest.fixture(scope="module")
def pair():
    with numpy_init(1):
        jm = jcv.build_cosyvoice3(tiny_config())
    jm = _moved(jm, np.random.default_rng(1))
    pm = pcv.build_cosyvoice3(tiny_config(), device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in jax_flatten(jm).items()})
    return jm, pm


@pytest.fixture
def draws(monkeypatch):
    return JaxDraws(monkeypatch, cfm=pflow.CosyVoice3ConditionalCFM, sine=phift.SineGen2)


def _rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


@pytest.mark.parametrize("streaming", [False, True])
def test_dit(pair, streaming):
    jm, pm = pair
    jd, pd = jm.flow.decoder.estimator, pm.flow.decoder.estimator
    x, mu, cond = (_rand((2, 12, 16), s) for s in (2, 3, 4))
    t, spk = np.array([0.3, 0.8], np.float32), _rand((2, 16), 5)
    args = (x, mu, t, spk, cond)
    want = jax.jit(lambda m, *a: m(*a, streaming=streaming))(jd, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = pd(*(_t(a) for a in args), streaming=streaming)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(pdit.chunk_attention_mask(10, 4).numpy(),
                                  np.asarray(jdit.chunk_attention_mask(10, 4)))


def _flow_inputs(seed=6, n=10):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (1, n)), rng.integers(0, V, (1, 4)), _rand((1, 8, 16), seed + 1,
                                                                         0.1),
            _rand((1, 8), seed + 2))


@pytest.mark.parametrize("streaming", [False, True])
def test_tokens_to_mel_with_the_jax_noise(pair, streaming):
    jm, pm = pair
    tokens, ptok, pmel, spk = _flow_inputs()
    key = jax.random.PRNGKey(7)
    want = jm.tokens_to_mel(tokens, ptok, pmel, spk, key=key, streaming=streaming)
    noise = _t(np.asarray(jax.random.normal(key, (1, 2 * (4 + 50), 16))))
    got = pm.tokens_to_mel(tokens, ptok, pmel, spk, streaming=streaming, noise=noise)
    assert got.shape == (1, 20, 16)
    _close(got.numpy(), want)


def test_streaming_flow_is_padding_invariant_before_the_padding(pair):
    """Tokens padded to 50 and to 100 with the same noise on the common
    rows: under the chunk mask (chunks of 4 frames) the mel of every chunk
    that ends before the first padded token's frames is the same."""
    _, pm = pair
    tokens, ptok, pmel, spk = _flow_inputs(8, n=14)
    noise = torch.randn(1, 2 * (4 + 100), 16, generator=torch.Generator().manual_seed(9))
    a = pm.tokens_to_mel(tokens, ptok, pmel, spk, streaming=True, noise=noise[:, : 2 * 54])
    from mlx_audio_tpu_torch.tts.models.cosyvoice2 import cosyvoice2 as pcv2

    orig = pcv2._pad_tokens
    try:
        pcv2._pad_tokens = lambda t: orig(t, 100)
        b = pm.tokens_to_mel(tokens, ptok, pmel, spk, streaming=True, noise=noise)
    finally:
        pcv2._pad_tokens = orig
    # frames 0 .. 2·(4 + 14) − 1 are real; the pre-lookahead layer looks 3
    # tokens (6 frames) right, so the chunks ending by frame 36 − 6 = 30
    # see no padding: the prompt's 8 frames and the first 20 new ones
    _close(a.numpy()[:, :20], b.numpy()[:, :20], bar=1e-6)


@pytest.mark.parametrize("finalize", [True, False])
def test_causal_hift_with_the_jax_draws(pair, finalize):
    jm, pm = pair
    mel = _rand((1, 14, 16), 10)
    key = jax.random.PRNGKey(11)
    want, want_s = jax.jit(lambda m, x, k: m(x, key=k, finalize=finalize))(
        jm.hifigan, jnp.asarray(mel), key)
    sg = pm.hifigan.m_source.l_sin_gen
    frames = 14 if finalize else 14 - pm.hifigan.f0_predictor.condnet_0.causal_padding
    with torch.no_grad():
        got, got_s = pm.hifigan(_t(mel), finalize=finalize,
                                draws=interp_draws(sg, 1, frames * pm.hifigan.f0_upsample_scale,
                                                   key))
    _close(got_s.numpy(), want_s)
    _close(got.numpy(), want, bar=WAV_BAR)
    with torch.no_grad():
        _close(pm.hifigan.f0_predictor(_t(mel), finalize=finalize).numpy(),
               jm.hifigan.f0_predictor(jnp.asarray(mel), finalize=finalize))


def test_lm_prompt_and_tokens_with_the_jax_draws(pair, draws, monkeypatch):
    """The extended rows of the decoder biased up: the stop on a token past
    the speech tokens comes within a few steps."""
    jm, pm = pair
    jlm, plm = jm.llm, pm.llm
    rng = np.random.default_rng(12)
    text, ptext, pspeech = (rng.integers(1, 100, 5), rng.integers(1, 100, 3),
                            rng.integers(0, V, (1, 6)))
    with torch.no_grad():
        _close(plm.build_prompt_embeds(text, ptext, pspeech).numpy(),
               jlm.build_prompt_embeds(text, ptext, pspeech))
    lens = []
    for bias in (0.0, 2.0):
        w = np.asarray(jlm.llm_decoder.weight).copy()
        w[V + 4:] += bias * 0.05
        jl = jlm.replace(llm_decoder=jlm.llm_decoder.replace(weight=jnp.asarray(w)))
        monkeypatch.setattr(plm.llm_decoder, "weight", torch.nn.Parameter(_t(w)))
        for seed in range(2):
            key = jax.random.PRNGKey(seed)
            want, n = jl.inference(text, ptext, pspeech, key=key, max_token_text_ratio=5.0,
                                   min_token_text_ratio=1.0)
            draws.lm_key = key
            got, m = plm.inference(text, ptext, pspeech, max_token_text_ratio=5.0,
                                   min_token_text_ratio=1.0, seed=0)
            np.testing.assert_array_equal(got, want)
            assert m == n
            lens.append(n)
    assert min(lens) < 25 and max(lens) > 0


TEXTS = ["Hello world. It is 42 degrees; the 3 dogs ran 1250 meters!",
         "你好，世界。今天是2024年。天气很好！",
         "<|endofprompt|>Already tagged text.", "   ", "no punctuation here",
         "A fairly long sentence that goes on and on. " * 6 + "Short.",
         "Number 7 and 19 and 1000000 and 123456789."]


def test_text_frontend():
    for text in TEXTS:
        assert pcv.normalize_text(text) == jcv.normalize_text(text)
        assert pcv.split_text(text) == jcv.split_text(text)
        assert pcv.split_text(text, FakeTok().encode) == jcv.split_text(text, FakeTok().encode)


def _models(pair):
    jm, pm = pair
    jmodel = jcv.Model.__new__(jcv.Model)
    jmodel.config = jcv.ModelConfig(sample_rate=24000)
    jmodel.sample_rate, jmodel.model = 24000, jm
    jmodel.set_runtime(tokenizer=FakeTok(), s3_tokenizer=FakeS3(), speaker_encoder=FakeSpk(False))
    pmodel = pcv.Model(ModelConfig(sample_rate=24000, cosyvoice3=tiny_config()), device="cpu")
    pmodel.model = pm
    pmodel.set_runtime(tokenizer=FakeTok(), s3_tokenizer=FakeS3(), speaker_encoder=FakeSpk(True))
    return jmodel, pmodel


@pytest.mark.parametrize("mode", ["zero-shot", "cross-lingual", "vc"])
def test_generate_end_to_end_with_the_jax_draws(pair, mode, draws, monkeypatch):
    """`Model.generate` on a 2 s reference: the waveform within 1e-4 of the
    peak of the JAX package's (its resampler scipy's, the port's)."""
    from mlx_audio_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    jit_front_ends(monkeypatch, jcv)
    jmodel, pmodel = _models(pair)
    rng = np.random.default_rng(13)
    ref = rng.standard_normal(32000).astype(np.float32) * 0.1
    kw = {"zero-shot": dict(ref_text="a line"), "cross-lingual": {},
          "vc": dict(source_audio=rng.standard_normal(24000).astype(np.float32) * 0.1)}[mode]
    want = list(jmodel.generate("hello there", ref_audio=ref, seed=14, **kw))
    draws.set(jax.random.split(jax.random.PRNGKey(14))[1], lm=mode != "vc")
    got = list(pmodel.generate("hello there", ref_audio=ref, seed=14, **kw))
    assert len(got) == len(want) == 1 and got[0].samples == want[0].samples > 0
    _close(got[0].audio, want[0].audio, bar=WAV_BAR)


def test_synthesize_streaming_with_the_jax_draws(pair, draws, monkeypatch):
    """The decoder's rows past the speech tokens pushed down, so the decode
    runs to its cap: 20 tokens, five chunks of 4."""
    jm, pm = pair
    w = np.asarray(jm.llm.llm_decoder.weight).copy()
    w[V:] -= 1.0
    jm = jm.replace(llm=jm.llm.replace(llm_decoder=jm.llm.llm_decoder.replace(
        weight=jnp.asarray(w))))
    monkeypatch.setattr(pm.llm.llm_decoder, "weight", torch.nn.Parameter(_t(w)))
    rng = np.random.default_rng(15)
    text, pspeech = rng.integers(1, 100, 5), rng.integers(0, V, (1, 4))
    pmel, spk = _rand((1, 8, 16), 16, 0.1), _rand((1, 8), 17)
    key = jax.random.PRNGKey(18)
    kw = dict(max_token_text_ratio=4.0, min_token_text_ratio=3.0)
    want = list(jm.synthesize_streaming(text, None, pspeech, pmel, spk, chunk_tokens=4, key=key,
                                        **kw))
    k1, key = jax.random.split(key)
    draws.lm_key, draws.flow_keys, draws.hift_keys = k1, [], []
    for _ in want:
        key, k2, k3 = jax.random.split(key, 3)
        draws.flow_keys.append(k2)
        draws.hift_keys.append(k3)
    got = list(pm.synthesize_streaming(text, None, pspeech, pmel, spk, chunk_tokens=4, **kw))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        _close(g, w, bar=WAV_BAR)


def test_generate_tokens_through_the_installed_batcher(pair):
    """CosyVoice3's batcher takes the stop on any token ≥ V: its tokens are
    the direct decode's for the same seed."""
    _, pm = pair
    rng = np.random.default_rng(19)
    text, pspeech = rng.integers(1, 100, 4), rng.integers(0, V, (1, 5))
    direct = pm.generate_tokens(text, None, pspeech, max_token_text_ratio=6.0, seed=3)
    b = pm.make_batcher(slots=2, max_len=64, tick_frames=4).install()
    try:
        assert b.v3
        served = pm.generate_tokens(text, None, pspeech, max_token_text_ratio=6.0, seed=3)
        assert b.dispatch_count >= 1
    finally:
        b.close()
    np.testing.assert_array_equal(served, direct)
