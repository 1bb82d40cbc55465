"""Kokoro-82M: the port against the JAX package on the CPU, module by module
and end to end, on the same weights (carried by load_jax_params) and the
same seeded numpy inputs.

Bars:
- float32: each module within 1e-5 of its output's peak (the same float32
  operations in another summation order); the whole model with identical
  `pred_dur` and audio within 2/32767 a sample (the int16 quantisation may
  round one step either way, twice).
- bf16 (`cast_floats` on both sides): identical `pred_dur` where the
  float32 durations lie at least 0.05 from a rounding boundary, and audio
  correlated above 0.99 with the JAX bf16 audio (the JAX package's own
  bf16-vs-f32 test asks for 0.98).

The sine source's noise is the JAX package's `jax.random` draw, made here
as `istftnet.py` makes it and passed to the port. The NSF analysis's first
STFT frame is symmetric (reflect padding), so its DFT is real and its phase
below Nyquist is 0 or π: the port sets it exactly, the JAX package leaves
±π to the sign of a rounding residue that changes with the summation order.
Tests that run the generator give the JAX side the exact phase there
(`exact_first_frame`); the STFT test holds the phases modulo 2π and the
first frame on its own.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mlx_audio_tpu.tts.models.kokoro.istftnet as jist
import mlx_audio_tpu.tts.models.kokoro.kokoro as jkok
import mlx_audio_tpu_torch.tts.models.kokoro.kokoro as pkok
from mlx_audio_tpu.nn.module import cast_floats as jcast
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu.tts.models import base as jbase
from mlx_audio_tpu.tts.models.interpolate import interpolate as jinterp
from mlx_audio_tpu.tts.models.kokoro import albert as jalb
from mlx_audio_tpu.tts.models.kokoro import modules as jmod
from mlx_audio_tpu_torch.nn import cast_floats, load_jax_params
from mlx_audio_tpu_torch.tts.models import base as pbase
from mlx_audio_tpu_torch.tts.models.interpolate import interpolate as pinterp
from mlx_audio_tpu_torch.tts.models.kokoro import albert as palb
from mlx_audio_tpu_torch.tts.models.kokoro import istftnet as pist
from mlx_audio_tpu_torch.tts.models.kokoro import modules as pmod

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

REL = 1e-5
LSB = 1 / 32767
VOCAB = {c: i + 1 for i, c in enumerate(
    "abcdefghijklmnopqrstuvwxyzæɑɔɛɪʊʌəɹŋθðʃʒʧʤˈˌAIOW !\"(),.:;?")}
TINY = dict(  # tests/test_kokoro.py's configuration
    istftnet=dict(resblock_kernel_sizes=[3], upsample_rates=[4, 2],
                  upsample_initial_channel=512, resblock_dilation_sizes=[[1, 3, 5]],
                  upsample_kernel_sizes=[8, 4], gen_istft_n_fft=16, gen_istft_hop_size=4),
    dim_in=32, hidden_dim=64, style_dim=32, n_layer=1, max_dur=10, n_token=178,
    text_encoder_kernel_size=5,
    plbert=dict(hidden_size=64, num_attention_heads=2, intermediate_size=128,
                max_position_embeddings=512, num_hidden_layers=1, embedding_size=32,
                dropout=0.0),
    vocab=VOCAB)
SMALL_FRAME_BUCKETS = (64, 128, 256)
PHONEMES = "ðə kwˈɪk bɹˈWn fˈɑks"  # the frame bucket of generate's text


def close(out, ref, rel=REL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


def t(a):
    return torch.from_numpy(np.array(a))


def bridge(jax_mod, rng, scale=0.3):
    """Random values for every parameter of the JAX module (a flat dict)."""
    flat = {}
    for name, val in flatten_params(jax_mod).items():
        flat[name] = (rng.standard_normal(val.shape) * scale).astype(np.float32)
    return flat


def load_both(jax_mod, port_mod, flat):
    """The flat dict into the port (load_jax_params) and into a copy of the
    JAX module, which is returned."""
    load_jax_params(port_mod, flat)
    return load_weights(jax_mod, {k: jnp.asarray(v) for k, v in flat.items()})


def jrun(module, *args):
    """The JAX module's call, jitted (eager JAX dispatches op by op)."""
    return jax.jit(lambda m, *a: m(*a))(module, *args)


def jax_noise(L: int, dim: int = 9, batch: int = 1):
    """The sine source's draws as istftnet.py makes them from PRNGKey(0)."""
    keys = jnp.broadcast_to(jax.random.PRNGKey(0)[None], (batch, 2))
    split = jax.vmap(jax.random.split)(keys)
    rand_ini = jax.vmap(lambda k: jax.random.normal(k, (dim,)))(split[:, 0])
    normal = jax.vmap(lambda k: jax.random.normal(k, (L, dim)))(split[:, 1])
    return keys, (t(rand_ini), t(normal))


@pytest.fixture
def exact_first_frame(monkeypatch):
    """The JAX analysis with the first frame's phase below Nyquist set to
    the exact 0 or π of its real DFT (see the module docstring)."""
    orig = jist.STFTHead.transform

    def transform(self, x):
        mag, ph = orig(self, x)
        h = (self.filter_length + 1) // 2
        return mag, ph.at[:, :h, 0].set(jnp.where(jnp.cos(ph[:, :h, 0]) < 0, jnp.pi, 0.0))

    monkeypatch.setattr(jist.STFTHead, "transform", transform)


# ----------------------------------------------------------------------
# Helpers shared with the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode,size,scale", [
    ("nearest", None, 3), ("nearest", None, 0.37), ("nearest", 5, None),
    ("linear", None, 4), ("linear", None, 1 / 3), ("linear", None, 2.5), ("linear", 11, None)])
def test_interpolate(mode, size, scale):
    x = np.random.default_rng(0).standard_normal((2, 3, 17)).astype(np.float32)
    ref = jinterp(jnp.asarray(x), size=size, scale_factor=scale, mode=mode)
    out = pinterp(t(x), size=size, scale_factor=scale, mode=mode)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if mode == "linear":
        ref = jinterp(jnp.asarray(x), size=9, mode=mode, align_corners=True)
        out = pinterp(t(x), size=9, mode=mode, align_corners=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_interpolate_at_the_sine_source_size():
    """The float32 index arithmetic at bench.py's bucket (13,824 frames:
    27,648 F0 samples, x300 to 8,294,400 and back down), exactly."""
    rng = np.random.default_rng(1)
    f0 = rng.standard_normal((1, 1, 27648)).astype(np.float32)
    up = pinterp(t(f0), scale_factor=300, mode="linear")
    np.testing.assert_array_equal(
        up.numpy(), np.asarray(jinterp(jnp.asarray(f0), scale_factor=300, mode="linear")))
    down = pinterp(up, scale_factor=1 / 300, mode="linear")
    np.testing.assert_array_equal(
        down.numpy(), np.asarray(jinterp(jnp.asarray(up.numpy()), scale_factor=1 / 300,
                                         mode="linear")))
    near = pinterp(t(f0), scale_factor=300, mode="nearest")
    np.testing.assert_array_equal(
        near.numpy(), np.asarray(jinterp(jnp.asarray(f0), scale_factor=300, mode="nearest")))


@pytest.mark.parametrize("shape", [(8, 3, 3), (8, 3, 16), (2, 3, 3), (4, 4), (16, 5, 5)])
def test_check_array_shape(shape):
    w = np.zeros(shape, np.float32)
    assert pbase.check_array_shape(w) == jbase.check_array_shape(w)


def test_bucket_table():
    for n in (1, 64, 65, 512, 3072, 3073, 5000, 13000):
        assert pkok._bucket(n, pkok.FRAME_BUCKETS) == jkok._bucket(n, jkok.FRAME_BUCKETS)
        assert pkok._bucket(n, pkok.TEXT_BUCKETS) == jkok._bucket(n, jkok.TEXT_BUCKETS)
    assert pkok.FRAME_BUCKETS == jkok.FRAME_BUCKETS
    assert pkok.TEXT_BUCKETS == jkok.TEXT_BUCKETS


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------

def test_custom_albert_padding_mask():
    cfg = dict(num_hidden_layers=2, num_attention_heads=2, hidden_size=32,
               intermediate_size=64, max_position_embeddings=32, embedding_size=16,
               vocab_size=20)
    j = jalb.CustomAlbert(jalb.AlbertModelArgs(**cfg))
    p = palb.CustomAlbert(palb.AlbertModelArgs(**cfg), device="cpu")
    rng = np.random.default_rng(2)
    j = load_both(j, p, bridge(j, rng))
    ids = rng.integers(0, 20, (2, 10))
    att = np.ones((2, 10), np.int32)
    att[1, 6:] = 0
    jseq, jpool = jax.jit(lambda m, i, a: m(i, attention_mask=a))(j, jnp.asarray(ids),
                                                                    jnp.asarray(att))
    with torch.no_grad():
        pseq, ppool = p(t(ids), attention_mask=t(att))
    close(pseq, jseq)
    close(ppool, jpool)


@pytest.mark.parametrize("upsample", [False, True])
def test_adain_resblk1d(upsample):
    j = jmod.AdainResBlk1d(16, 8, style_dim=8, upsample=upsample)
    p = pmod.AdainResBlk1d(16, 8, style_dim=8, upsample=upsample, device="cpu")
    rng = np.random.default_rng(3)
    j = load_both(j, p, bridge(j, rng))
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    s = rng.standard_normal((2, 8)).astype(np.float32)
    vf = np.array([1.0, 0.6], np.float32)
    ref = jrun(j, jnp.asarray(x), jnp.asarray(s), jnp.asarray(vf))
    with torch.no_grad():
        out = p(t(x), t(s), t(vf))
    assert out.shape == (2, 24 if upsample else 12, 8)
    close(out, ref)


def test_duration_and_text_encoders():
    """DurationEncoder (BiLSTMs with AdaLayerNorm) and TextEncoder over a
    padded batch."""
    rng = np.random.default_rng(4)
    jd, pd = jmod.DurationEncoder(8, 16, 2), pmod.DurationEncoder(8, 16, 2, device="cpu")
    jd = load_both(jd, pd, bridge(jd, rng))
    jt, pt = jmod.TextEncoder(16, 5, 2, 30), pmod.TextEncoder(16, 5, 2, 30, device="cpu")
    jt = load_both(jt, pt, bridge(jt, rng))
    lengths = np.array([9, 5], np.int32)
    mask = np.arange(9)[None] >= lengths[:, None]
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    s = rng.standard_normal((2, 8)).astype(np.float32)
    ids = rng.integers(0, 30, (2, 9))
    with torch.no_grad():
        close(pd(t(x), t(s), t(lengths), t(mask)),
              jrun(jd, jnp.asarray(x), jnp.asarray(s), jnp.asarray(lengths), jnp.asarray(mask)))
        close(pt(t(ids), t(lengths), t(mask)),
              jrun(jt, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(mask)))


def test_resblock_adain_snake():
    j = jist.ResBlockAdaINSnake(8, 3, [1, 3, 5], 8)
    p = pist.ResBlockAdaINSnake(8, 3, [1, 3, 5], 8, device="cpu")
    rng = np.random.default_rng(5)
    flat = bridge(j, rng)
    for k in flat:  # snake alphas away from 0
        if ".alpha" in k or k.startswith("alpha"):
            flat[k] = 0.5 + np.abs(flat[k])
    j = load_both(j, p, flat)
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    s = rng.standard_normal((2, 8)).astype(np.float32)
    vf = np.array([1.0, 0.55], np.float32)
    with torch.no_grad():
        close(p(t(x), t(s), t(vf)), jrun(j, jnp.asarray(x), jnp.asarray(s), jnp.asarray(vf)))


@pytest.mark.parametrize("n_fft,hop", [(16, 4), (20, 5), (12, 5)])
def test_stft_head(n_fft, hop):
    """transform: magnitudes within the bar, phases modulo 2π, and the first
    frame's phase below Nyquist exactly 0 or π; inverse on the same input.
    (12, 5) takes the gather / scatter path."""
    j = jist.STFTHead(n_fft, hop, n_fft)
    p = pist.STFTHead(n_fft, hop, n_fft, device="cpu")
    x = (np.random.default_rng(6).standard_normal((2, 400)) * 0.1).astype(np.float32)
    jmag, jph = j.transform(jnp.asarray(x))
    pmag, pph = p.transform(t(x))
    close(pmag, jmag)
    d = pph.numpy() - np.asarray(jph)
    np.testing.assert_allclose(np.angle(np.exp(1j * d)), 0.0, atol=REL * math.pi)
    h = (n_fft + 1) // 2
    assert set(np.unique(np.abs(pph[:, :h, 0].numpy()))) <= {0.0, np.float32(math.pi)}
    mag = np.abs(np.random.default_rng(7).standard_normal(jmag.shape)).astype(np.float32)
    ph = np.random.default_rng(8).uniform(-3, 3, jmag.shape).astype(np.float32)
    close(p.inverse(t(mag), t(ph)), j.inverse(jnp.asarray(mag), jnp.asarray(ph)))


def test_generator_with_the_jax_noise(exact_first_frame, monkeypatch):
    """The sine source's phase reaches thousands of radians here (summed
    per-sample increments, scaled by the upsampling), where a float32 ulp is
    5e-4 rad: the source is held at 1e-4 of its peak. End to end that
    rounding grows where the analysis takes the phase of a small bin, so
    the generator is held at 5e-3 of its peak; given the port's source, the
    rest of the JAX generator agrees at the module bar."""
    args = (8, [3], [4, 2], 16, [[1, 3, 5]], [8, 4], 16, 4)
    j, p = jist.Generator(*args), pist.Generator(*args, device="cpu")
    # the JAX initialisers' weights (random weights of another scale make the
    # exponential magnitude head amplify rounding past any bar)
    load_jax_params(p, {k: np.asarray(v) for k, v in flatten_params(j).items()})
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 24, 16)).astype(np.float32)
    s = rng.standard_normal((1, 8)).astype(np.float32)
    f0 = rng.uniform(0, 300, (1, 24)).astype(np.float32)  # voiced and unvoiced
    vf = np.array([0.75], np.float32)
    L = 24 * p.total_upsample
    keys, noise = jax_noise(L)
    f0_up = np.repeat(f0, p.total_upsample, axis=1)[..., None]
    with torch.no_grad():
        out = p(t(x), t(s), t(f0), noise, t(vf))
        src = p.m_source(t(f0_up), noise)
    assert out.shape == (1, L)
    close(src[0], jrun(j.m_source, jnp.asarray(f0_up), keys)[0], rel=1e-4)
    jargs = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(f0), keys, jnp.asarray(vf))
    close(out, jrun(j, *jargs), rel=5e-3)
    monkeypatch.setattr(jist.SourceModuleHnNSF, "__call__",
                        lambda self, f0, keys: tuple(jnp.asarray(a.numpy()) for a in src))
    close(out, jrun(j, *jargs))


# ----------------------------------------------------------------------
# The whole model
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_buckets():
    saved = jkok.FRAME_BUCKETS, pkok.FRAME_BUCKETS
    jkok.FRAME_BUCKETS = pkok.FRAME_BUCKETS = SMALL_FRAME_BUCKETS
    yield
    jkok.FRAME_BUCKETS, pkok.FRAME_BUCKETS = saved


@pytest.fixture(scope="module")
def models(small_buckets):
    # the JAX initialiser drawing from numpy: `jax.random` compiles a program
    # for every weight shape
    with numpy_init(0):
        jm = jkok.Model(jkok.ModelConfig.from_dict(TINY))
    pm = pkok.Model(TINY, device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm, pm


def model_noise(pm, pred_dur):
    frames = pkok._bucket(int(np.sum(pred_dur)), pkok.FRAME_BUCKETS)
    return jax_noise(frames * 2 * pm.decoder.generator.total_upsample)[1]


@jax.jit
def _jax_durations(jm, ids, mask, ref_s):
    sd = jm.config.style_dim
    bert_out, _ = jm.bert(ids, attention_mask=(~mask).astype(jnp.int32))
    lengths = jnp.sum(~mask, axis=-1)
    d = jm.predictor.text_encoder(jm.bert_encoder(bert_out), ref_s[:, sd:], lengths, mask)
    x = jm.predictor.lstm(d, valid_len=lengths)
    return jax.nn.sigmoid(jm.predictor.duration_proj(x)).sum(axis=-1)


def jax_durations(jm, ps, ref_s):
    """The JAX frontend's float durations (before rounding), as `_frontend`
    computes them."""
    ids = [0] + [VOCAB[c] for c in ps if c in VOCAB] + [0]
    Tp = jkok._bucket(len(ids), jkok.TEXT_BUCKETS)
    mask = jnp.asarray([[False] * len(ids) + [True] * (Tp - len(ids))])
    dur = _jax_durations(jm, jnp.asarray([ids + [0] * (Tp - len(ids))], jnp.int32), mask,
                         jnp.asarray(ref_s))
    return np.asarray(dur)[0, : len(ids)]


def test_model_f32_matches_jax(models, exact_first_frame):
    jm, pm = models
    assert pm.device.type == "cpu"
    ref_s = np.random.default_rng(1).standard_normal((1, 64)).astype(np.float32) * 0.1
    ref = jm(PHONEMES, ref_s, return_output=True)
    out = pm(PHONEMES, ref_s, return_output=True, noise=model_noise(pm, ref.pred_dur))
    np.testing.assert_array_equal(out.pred_dur, ref.pred_dur)
    assert out.audio.dtype == np.float32 and out.audio.shape == ref.audio.shape
    assert out.audio.shape[0] == ref.pred_dur.sum() * 64
    np.testing.assert_allclose(out.audio, ref.audio, rtol=0, atol=2 * LSB)


def test_model_bf16_matches_jax(models, exact_first_frame):
    jm, pm = models
    ref_s = np.random.default_rng(1).standard_normal((1, 64)).astype(np.float32) * 0.1
    ps = PHONEMES
    dur = jax_durations(jm, ps, ref_s)
    margin = np.abs(dur - np.floor(dur) - 0.5)
    assert margin.min() >= 0.05, "the durations lie too close to a rounding boundary"
    jb = jax.jit(jcast)(jm)
    pb = pkok.Model(TINY, device="cpu")
    pb.load_state_dict(pm.state_dict())
    cast_floats(pb)
    assert pb.bert_encoder.weight.dtype == torch.bfloat16
    assert pb.decoder.generator.stft._fwd_re.dtype == torch.bfloat16
    ref = jb(ps, ref_s, return_output=True)
    out = pb(ps, ref_s, return_output=True, noise=model_noise(pb, ref.pred_dur))
    np.testing.assert_array_equal(out.pred_dur, ref.pred_dur)
    assert out.audio.shape == ref.audio.shape and np.isfinite(out.audio).all()
    corr = np.corrcoef(out.audio, ref.audio)[0, 1]
    assert corr > 0.99, corr


def test_fused_frames_and_fallback(models):
    """`fused_frames` at the exact bucket gives the two-stage audio; a
    bucket too small falls back to the exact one."""
    _, pm = models
    ref_s = np.random.default_rng(4).standard_normal((1, 64)).astype(np.float32) * 0.1
    two = pm(PHONEMES[:12], ref_s, return_output=True)
    frames = pkok._bucket(int(two.pred_dur.sum()), pkok.FRAME_BUCKETS)
    fused = pm(PHONEMES[:12], ref_s, return_output=True, fused_frames=frames)
    fallback = pm(PHONEMES[:12], ref_s, return_output=True, fused_frames=1)
    assert frames > SMALL_FRAME_BUCKETS[0]  # the fallback did overflow
    for o in (fused, fallback):
        np.testing.assert_array_equal(o.pred_dur, two.pred_dur)
        np.testing.assert_array_equal(o.audio, two.audio)


def test_repeat_calls_are_deterministic(models):
    _, pm = models
    ref_s = np.random.default_rng(5).standard_normal(64).astype(np.float32) * 0.1
    a, b = pm("həlˈO", ref_s, seed=3), pm("həlˈO", ref_s, seed=3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, pm("həlˈO", ref_s, seed=4))


def test_sanitize_matches_jax(models):
    """A torch-layout checkpoint: weight-norm pairs (a conv and the depthwise
    transposed pool), nn.LSTM keys, gamma / beta, position ids, a torch
    ConvTranspose1d (I, O, K) and a snake alpha. The same keys and arrays as
    the JAX sanitize, and the port loads them."""
    jm, pm = models
    rng = np.random.default_rng(6)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    weights = {
        "decoder.encode.conv1.weight_v": r(1024, 66, 3),
        "decoder.encode.conv1.weight_g": np.abs(r(1024, 1, 1)),
        "decoder.decode.3.pool.weight_v": r(1090, 1, 3),
        "decoder.decode.3.pool.weight_g": np.abs(r(1090, 1, 1)),
        "decoder.generator.ups.0.weight": r(512, 256, 8),
        "predictor.lstm.weight_ih_l0": r(128, 96),
        "predictor.lstm.weight_hh_l0_reverse": r(128, 32),
        "predictor.lstm.bias_ih_l0": r(128),
        "bert.embeddings.LayerNorm.gamma": r(32),
        "bert.embeddings.LayerNorm.beta": r(32),
        "bert.embeddings.position_ids": np.arange(5),
        "decoder.generator.resblocks.0.alpha1.0": r(1, 256, 1),
    }
    ref = jm.sanitize(dict(weights))
    out = pm.sanitize(weights)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]), err_msg=k)
    assert "decoder.decode.3.pool.weight" in out and "predictor.lstm.forward.Wx" in out
    load_jax_params(pm, {**{k: np.asarray(v) for k, v in flatten_params(jm).items()}, **out})


def test_generate_end_to_end(models, tmp_path, monkeypatch):
    """`generate` through the copied pipeline with a seeded voice pack and a
    two-word lexicon file (the G2P fallback's MLX_AUDIO_TPU_LEXICON): the
    JAX package's GenerationResult fields, and the audio of a direct call
    with the pack's style row."""
    jm, pm = models
    lexicon = tmp_path / "lexicon.json"
    lexicon.write_text('{"hello": "həlˈO", "world": "wˈɜɹld"}', encoding="utf-8")
    monkeypatch.setenv("MLX_AUDIO_TPU_LEXICON", str(lexicon))
    voices = tmp_path / "voices"
    voices.mkdir()
    pack = np.random.default_rng(1).standard_normal((510, 1, 64)).astype(np.float32) * 0.1
    np.savez(voices / "af_heart.npz", voice=pack)
    jm.repo_id = pm.repo_id = str(tmp_path)
    ref = list(jm.generate("Hello world.", voice="af_heart"))
    out = list(pm.generate("Hello world.", voice="af_heart"))
    assert len(out) == len(ref) == 1
    r, o = ref[0], out[0]
    assert [f.name for f in dataclasses.fields(o)] == [f.name for f in dataclasses.fields(r)]
    for name in ("samples", "sample_rate", "segment_idx", "token_count", "audio_duration"):
        assert getattr(o, name) == getattr(r, name), name
    assert o.peak_memory_usage == r.peak_memory_usage == 0.0 and o.real_time_factor > 0
    ps = next(iter(pm._get_pipeline("a")("Hello world.", voice="af_heart"))).phonemes
    np.testing.assert_array_equal(o.audio, pm(ps, pack[len(ps) - 1]))


def test_too_many_phonemes_raise(models):
    _, pm = models
    with pytest.raises(ValueError, match="exceed the context"):
        pm("a" * 511, np.zeros(64, np.float32))
