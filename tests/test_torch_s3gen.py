"""S3Gen in the port against the JAX package on the CPU at the sizes of
`tests/test_s3gen.py` and `tests/test_chatterbox.py`'s tiny model:

- the 24 kHz prompt mel, `kaldi_fbank` and CAM++;
- the chunk masks, the relative-position conformer and the upsampling
  encoder (full and chunked attention);
- one estimator call (the causal U-Net, and the non-causal one with
  GroupNorm);
- both solvers (the CFG Euler solve and the meanflow one) with the JAX
  package's noise passed in;
- `flow.inference` with the JAX package's PRNGKey(42) noise;
- `SineGen` / the NSF source with the JAX draws passed in, the F0
  predictor, HiFT, and `S3Token2Wav` with its fade.

Weights go across with `load_jax_params`, every constant-initialised
parameter moved off its constant first. float32 bar: 1e-5 of each output's
peak (1e-4 where an output runs through the ISTFT head's exp of a
float32 sum, stated at each)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models import s3gen as js
from mlx_audio_tpu.codec.models.s3gen import encoder as jenc
from mlx_audio_tpu.codec.models.s3gen import s3gen as js3
from mlx_audio_tpu.nn.module import flatten_params as jax_flatten
from mlx_audio_tpu_torch.codec.models import s3gen as ps
from mlx_audio_tpu_torch.codec.models.s3gen import encoder as penc
from mlx_audio_tpu_torch.nn import load_jax_params

from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

BAR = 1e-5
ENC = dict(input_size=16, output_size=16, attention_heads=2, linear_units=32, num_blocks=1,
           num_up_blocks=1)
EST = dict(in_channels=32, out_channels=8, channels=[16], attention_head_dim=8, n_blocks=1,
           num_mid_blocks=1, num_heads=2)
HIFT = dict(in_channels=8, base_channels=16, nb_harmonics=1, upsample_rates=[4, 2],
            upsample_kernel_sizes=[8, 4], resblock_kernel_sizes=[3],
            resblock_dilation_sizes=[[1]], source_resblock_kernel_sizes=[3, 3],
            source_resblock_dilation_sizes=[[1], [1]])
# the tiny S3Gen's CAM++ (80 fbank bins, the flow's 192-wide x-vector): the
# JAX constructor's per-shape programs compile once for both tests
CAM = dict(feat_dim=80, embedding_size=192, growth_rate=4, bn_size=2, init_channels=8)


# the JAX modules' calls, compiled once a shape: eager dispatch compiles
# every operation anew
_jit_call = jax.jit(lambda m, *a: m(*a))
# CAM++'s x-vector from 16 kHz audio, shared by `test_campplus` and the
# S3Token2Wav test (one compile at the one-second shape both take)
_cam_inference = jax.jit(js.CAMPPlus.inference)


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _carry(jm, pm, seed=0):
    jm = _moved(jm, np.random.default_rng(seed))
    load_jax_params(pm, {k: np.asarray(v) for k, v in jax_flatten(jm).items()})
    return jm


def _pair(jcls, pcls, seed=0, **kw):
    with numpy_init(seed):
        jm = jcls(**kw)
    pm = pcls(**kw, device="cpu")
    return _carry(jm, pm, seed), pm


def _rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


def _t(x):
    return torch.from_numpy(np.array(x))


def sine_draws(sg, B, T, key):
    """The JAX SineGen's draws from `key`, in `SineGen.draws`' layout."""
    H = sg.harmonic_num + 1
    k_phase, k_noise = jax.random.split(key)
    phase = jax.random.uniform(k_phase, (B, H, 1), minval=-math.pi, maxval=math.pi)
    phase = phase.at[:, 0].set(0.0)
    return _t(np.asarray(phase)), _t(np.asarray(jax.random.normal(k_noise, (B, T, H))))


def test_prompt_mel_and_kaldi_fbank():
    y = _rand(24000, 1, 0.1)
    _close(ps.mel_spectrogram(y).numpy(), js.mel_spectrogram(y))
    a = _rand(16000, 2, 0.1)
    _close(ps.kaldi_fbank(_t(a), num_mel_bins=16).numpy(),
           js.kaldi_fbank(jnp.asarray(a), num_mel_bins=16))


def test_campplus():
    pm = ps.CAMPPlus(**CAM, device="cpu")
    jm = _carry(_jax_parts()[1], pm, 3)
    x = _rand((2, 130, 80), 4)  # past one 100-frame pooling segment
    a = _rand(16000, 5, 0.1)  # the shape embed_ref gives it: 1 s at 16 kHz
    with torch.no_grad():
        _close(pm(_t(x)).numpy(), _jit_call(jm, jnp.asarray(x)))
        _close(pm.inference(_t(a)).numpy(), _cam_inference(jm, jnp.asarray(a)))


def test_chunk_masks():
    for size, chunk, left in ((6, 2, -1), (7, 3, 1), (5, 1, 0)):
        np.testing.assert_array_equal(penc.subsequent_chunk_mask(size, chunk, left).numpy(),
                                      np.asarray(jenc.subsequent_chunk_mask(size, chunk, left)))
    pad = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)
    for chunk in (0, 2):
        np.testing.assert_array_equal(penc.chunk_attention_bias(_t(pad), chunk).numpy(),
                                      np.asarray(jenc.chunk_attention_bias(jnp.asarray(pad),
                                                                           chunk)))


@pytest.mark.parametrize("streaming", [False, True])
def test_upsample_conformer_encoder(streaming):
    """The upsampling encoder, a conv module and a macaron feed-forward
    included, over two rows of different lengths."""
    kw = dict(ENC, static_chunk_size=3, macaron_style=True, use_cnn_module=True)
    jm, pm = _pair(js.UpsampleConformerEncoder, ps.UpsampleConformerEncoder, seed=6, **kw)
    x = _rand((2, 9, 16), 7)
    lens = np.array([9, 6])
    want, want_len = jax.jit(lambda m, x, n: m(x, n, streaming=streaming))(
        jm, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got, got_len = pm(_t(x), _t(lens), streaming=streaming)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    _close(got.numpy(), want)


def test_rel_shift():
    x = _rand((1, 2, 4, 7), 8)
    np.testing.assert_array_equal(
        penc.RelPositionMultiHeadedAttention._rel_shift(_t(x)).numpy(),
        np.asarray(jenc.RelPositionMultiHeadedAttention._rel_shift(jnp.asarray(x))))


def _estimator_inputs(B=2, T=10, seed=9):
    x, mu, cond = (_rand((B, T, 8), seed + i) for i in range(3))
    mask = np.ones((B, T, 1), np.float32)
    mask[B - 1, 7:] = 0.0
    t = np.array([0.3, 0.7], np.float32)[:B]
    spks = _rand((B, 8), seed + 3)
    return x, mask, mu, t, spks, cond


@pytest.mark.parametrize("causal", [True, False])
def test_estimator_call(causal):
    jm, pm = _pair(js.ConditionalDecoder, ps.ConditionalDecoder, seed=10,
                   **dict(EST, causal=causal))
    args = _estimator_inputs()
    want = _jit_call(jm, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = pm(*(_t(a) for a in args))
    _close(got.numpy(), want)


@pytest.mark.parametrize("meanflow", [False, True])
def test_solvers_with_the_jax_noise(meanflow):
    jest, pest = _pair(js.ConditionalDecoder, ps.ConditionalDecoder, seed=11,
                       **dict(EST, meanflow=meanflow))
    jcfm = js.ConditionalCFM(estimator=jest)
    pcfm = ps.ConditionalCFM(estimator=pest)
    jcfm.MEL_CHANNELS = pcfm.MEL_CHANNELS = 8
    _, mask, mu, _, spks, cond = _estimator_inputs(B=1)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (1, 10, 8), jnp.float32))
    want, _ = jcfm(jnp.asarray(mu), jnp.asarray(mask), 3, key, spks=jnp.asarray(spks),
                   cond=jnp.asarray(cond), meanflow=meanflow)
    with torch.no_grad():
        got, _ = pcfm(_t(mu), _t(mask), 3, spks=_t(spks), cond=_t(cond), meanflow=meanflow,
                      noise=_t(noise))
    _close(got.numpy(), want)


@functools.cache
def _jax_parts():
    """The JAX package's tiny flow, CAM++ and HiFT, built once: its
    constructors run eagerly (seconds each on the CPU), and nothing changes
    its modules in place (`load_weights` returns a copy), so the tests of a
    file share them."""
    with numpy_init(12):
        jest = js.ConditionalDecoder(**EST)
        jenc_ = js.UpsampleConformerEncoder(**ENC)
        jcfm = js3.CausalConditionalCFM(estimator=jest, cfm_params=js.CFMParams())
        jcfm.MEL_CHANNELS = 8
        jf = js.CausalMaskedDiffWithXvec(input_size=16, output_size=8, spk_embed_dim=192,
                                         vocab_size=70, n_timesteps=2, encoder=jenc_,
                                         decoder=jcfm)
        return jf, js.CAMPPlus(**CAM), js.HiFTGenerator(**HIFT)


def _flows(seed=12):
    """(JAX flow, port flow) at the tiny model's sizes."""
    jf = _jax_parts()[0]
    pcfm = ps.CausalConditionalCFM(estimator=ps.ConditionalDecoder(**EST, device="cpu"),
                                   cfm_params=ps.CFMParams())
    pcfm.MEL_CHANNELS = 8
    pf = ps.CausalMaskedDiffWithXvec(input_size=16, output_size=8, spk_embed_dim=192,
                                     vocab_size=70, n_timesteps=2,
                                     encoder=ps.UpsampleConformerEncoder(**ENC, device="cpu"),
                                     decoder=pcfm, device="cpu")
    return _carry(jf, pf, seed), pf


def test_flow_inference_with_the_jax_noise():
    """Prompt tokens and mel, then new tokens (one past the table and one
    negative: clipped into it) → the mel of the new region; the noise the
    JAX package's PRNGKey(42) draw."""
    jf, pf = _flows()
    token = np.array([[3, 9, 69, 70, -4, 12]], np.int64)
    ptok = np.array([[5, 6, 7]], np.int64)
    pfeat = _rand((1, 6, 8), 13)
    emb = _rand((1, 192), 14)
    args = (token, np.array([6]), ptok, np.array([3]), pfeat, emb)
    want, _ = jax.jit(lambda m, *a: m.inference(*a))(jf, *(jnp.asarray(a) for a in args))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (1, 18, 8), jnp.float32))
    with torch.no_grad():
        got, _ = pf.inference(*(_t(a) for a in args), noise=_t(noise))
    assert got.shape == (1, 12, 8)
    _close(got.numpy(), want)


def test_sine_source_with_the_jax_draws():
    sg_j = js.SineGen(24000, harmonic_num=2, voiced_threshold=10.0)
    sg_p = ps.SineGen(24000, harmonic_num=2, voiced_threshold=10.0)
    f0 = np.abs(_rand((2, 1, 400), 15)) * 200.0
    f0[:, :, 100:150] = 0.0  # an unvoiced stretch
    key = jax.random.PRNGKey(3)
    want, want_uv = sg_j(jnp.asarray(f0), key)
    got, got_uv = sg_p(_t(f0), draws=sine_draws(sg_p, 2, 400, key))
    np.testing.assert_array_equal(got_uv.numpy(), np.asarray(want_uv))
    _close(got.numpy(), want)
    jsrc, psrc = _pair(js.SourceModuleHnNSF, ps.SourceModuleHnNSF, seed=16, sampling_rate=24000,
                       upsample_scale=4, harmonic_num=2, voiced_threshod=10.0)
    f0_up = f0.transpose(0, 2, 1)
    with torch.no_grad():
        _close(psrc(_t(f0_up), draws=sine_draws(psrc.l_sin_gen, 2, 400, key)).numpy(),
               jsrc(jnp.asarray(f0_up), key))


def test_f0_predictor_and_hift_with_the_jax_draws():
    """HiFT's waveform through the ISTFT head (exp of a float32 sum), at
    1e-4 of the peak; the F0 predictor and the source at 1e-5."""
    pm = ps.HiFTGenerator(**HIFT, device="cpu")
    jm = _carry(_jax_parts()[2], pm, 17)
    mel = _rand((1, 10, 8), 18)
    with torch.no_grad():
        _close(pm.f0_predictor(_t(mel)).numpy(), jm.f0_predictor(jnp.asarray(mel)))
    key = jax.random.PRNGKey(4)
    want, want_src = jax.jit(lambda m, x, k: m(x, key=k))(jm, jnp.asarray(mel), key)
    draws = sine_draws(pm.m_source.l_sin_gen, 1, 10 * pm.f0_upsample_scale, key)
    with torch.no_grad():
        got, got_src = pm(_t(mel), draws=draws)
        assert got.shape == (1, 10 * 4 * 2 * 4)
        _close(got_src.numpy(), want_src)
        _close(got.numpy(), want, bar=1e-4)
        again, _ = pm(_t(mel), cache_source=got_src)  # the source handed back as cache
    _close(again.numpy(), got.numpy(), bar=1e-6)


def jax_token2wav():
    """The JAX S3Token2Wav with the tiny model's parts (built without its
    full-size ones)."""
    jm = js3.S3Token2Wav.__new__(js3.S3Token2Wav)
    jm.flow, jm.speaker_encoder, jm.mel2wav = _jax_parts()
    n_trim = js3.S3GEN_SR // 50
    jm._trim_fade = jnp.concatenate([jnp.zeros(n_trim),
                                     (jnp.cos(jnp.linspace(jnp.pi, 0.0, n_trim)) + 1) / 2])
    return jm


def _tiny_token2wav(seed=19):
    """`jax_token2wav()` and the port's S3Token2Wav at the same sizes, on
    the same weights (the constants moved by `seed`)."""
    jm = jax_token2wav()
    sizes = {"campplus": CAM,
             "encoder": ENC, "estimator": EST,
             "flow": dict(output_size=8, spk_embed_dim=192, vocab_size=70, n_timesteps=2),
             "hift": dict(HIFT, sampling_rate=22050), "f0": dict(in_channels=8)}
    pm = ps.S3Token2Wav(device="cpu", sizes=sizes)
    pm.flow.decoder.MEL_CHANNELS = 8
    jm = _carry(jm, pm, seed)
    jm.flow.decoder.MEL_CHANNELS = 8
    return jm, pm


def test_s3token2wav_with_fade(monkeypatch):
    """The prompt dict (x-vector, mel, tokens trimmed to 2:1), then tokens
    → waveform with the fade over its first 2 × 480 samples (zeros, then
    a raised cosine). The JAX package's CAM++, flow and HiFT run compiled
    (its S3Token2Wav calls them eagerly)."""
    monkeypatch.setattr(js.CAMPPlus, "inference", _cam_inference)
    for cls, static in ((js.HiFTGenerator, ()),
                        (js.CausalMaskedDiffWithXvec,
                         ("finalize", "n_timesteps", "streaming", "meanflow"))):
        monkeypatch.setattr(cls, "inference", jax.jit(cls.inference, static_argnames=static))
    jm, pm = _tiny_token2wav()
    ref = _rand(24000, 20, 0.1)
    ref_tokens = np.arange(30) % 60  # more than the 2:1 ratio takes
    jref = jm.embed_ref(ref, 24000, ref_tokens)
    pref = pm.embed_ref(ref, 24000, ref_tokens)
    for k in ("prompt_token", "prompt_token_len"):
        np.testing.assert_array_equal(pref[k].numpy(), np.asarray(jref[k]))
    assert pref["prompt_token"].shape[1] == pref["prompt_feat"].shape[1] // 2 == 25
    _close(pref["prompt_feat"].numpy(), jref["prompt_feat"])
    _close(pref["embedding"].numpy(), jref["embedding"])
    tokens = np.array([[4, 8, 15, 16, 23, 42, 1, 2, 3, 5, 7, 11, 13, 17, 19, 29, 31, 37]])
    key = jax.random.PRNGKey(7)
    want = np.asarray(jm(tokens, jref, key=key))
    n_mel = 2 * tokens.shape[1]
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(42),
                                         (1, 2 * (25 + tokens.shape[1]), 8), jnp.float32))
    draws = sine_draws(pm.mel2wav.m_source.l_sin_gen, 1, n_mel * pm.mel2wav.f0_upsample_scale,
                       key)
    got = pm(tokens, pref, noise=_t(noise), draws=draws).numpy()
    assert got.shape == want.shape == (1, n_mel * 32)
    _close(got, want, bar=1e-4)
    assert np.all(got[0, :480] == 0.0) and got.shape[1] >= 960
    fade = pm.trim_fade.numpy()
    _close(fade, np.asarray(jm._trim_fade), bar=1e-6)
