"""Mimi and `RingKVCache` in the port against the JAX package on the CPU at
tiny widths: the ring past its window (k, v, slot positions and masks
identical), the streamable convolutions' steps against their offline calls,
codes identical and waveforms within 1e-5 (float32), streaming encode and
decode against the JAX steps and against offline, and both checkpoint
layouts through `sanitize` (kyutai's torch names and transformers'
`MimiModel`).

Bars: float32 waveforms and convolution outputs 1e-5 absolute on values of
O(0.1-1); codes and masks identical. The streaming encoder's `edge`-padded
downsample starts from a zero tail where the offline call repeats the first
sample, so streamed codes match offline ones from the second frame on (as
in the JAX package's own test); against the JAX steps they are identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models.mimi import mimi as jmimi
from mlx_audio_tpu.lm import cache as jcache
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu_torch.codec.models import Mimi, MimiStreamingDecoder
from mlx_audio_tpu_torch.codec.models.mimi import mimi as pmimi
from mlx_audio_tpu_torch.lm.cache import RingKVCache
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.module import flatten_params as pflat

import chip_smoke as cs
from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-5


def tiny_cfg(mod, ratios=(2, 2), nq=4):
    """Mimi's structure at a few channels: two SEANet ratios, a 2-layer
    transformer with context 8, 4 codebooks of 16; 8 samples a frame."""
    return mod.MimiConfig(
        sample_rate=1600.0, frame_rate=200.0,
        seanet=mod.SeanetConfig(dimension=16, nfilters=4, ratios=list(ratios)),
        transformer=mod.TransformerConfig(d_model=16, num_heads=2, num_layers=2,
                                          dim_feedforward=32, context=8),
        quantizer_nq=nq, quantizer_bins=16, quantizer_dim=8)


def moved(jm, rng):
    """Every constant-initialised parameter moved off its constant (the
    codebooks start at zero, the usages and layer scales at one)."""
    flat = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v, np.float32)
        if v.size and np.all(v == v.flat[0]):
            noise = rng.standard_normal(v.shape).astype(np.float32)
            v = v + (0.1 * np.abs(noise) if k.endswith("cluster_usage") else 0.1 * noise)
        flat[k] = v
    return load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})


def mimi_pair(ratios=(2, 2), seed=0):
    with numpy_init(seed):
        jm = moved(jmimi.Mimi(tiny_cfg(jmimi, ratios)), np.random.default_rng(seed))
    pm = Mimi(tiny_cfg(pmimi, ratios), device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return mimi_pair()


def _audio(n_frames, seed=1, fs=8):
    return (0.3 * np.random.default_rng(seed).standard_normal((1, 1, n_frames * fs))
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# RingKVCache
# ---------------------------------------------------------------------------


def test_ring_cache_past_its_window():
    """Writes of 3, 2, 4, 1, 3 and 5 rows into a ring of 5 slots (20 rows,
    four times round): k, v, the slot positions and the context-3 masks
    equal the JAX cache's after every write."""
    rng = np.random.default_rng(0)
    W, context = 5, 3
    jc = jcache.RingKVCache(1, 2, W, 4)
    pc = RingKVCache(1, 2, W, 4, device="cpu")
    pos = 0
    for t in (3, 2, 4, 1, 3, 5):
        k = rng.standard_normal((1, 2, t, 4)).astype(np.float32)
        v = rng.standard_normal((1, 2, t, 4)).astype(np.float32)
        jk, jv, jc = jc.update(jnp.asarray(k), jnp.asarray(v))
        pk, pv, pc = pc.update(torch.from_numpy(k), torch.from_numpy(v))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pc.pos_buf.numpy(), np.asarray(jc.pos_buf))
        jmask = np.asarray(jc.attention_mask(t, context, jnp.asarray(pos)))
        np.testing.assert_array_equal(pc.attention_mask(t, context, pos).numpy(), jmask)
        pos += t
        assert pc.pos == int(jc.pos) == pos
    # the last write's queries see at most `context` slots, all written
    seen = np.isfinite(pc.attention_mask(5, context, pos - 5).numpy()[0, 0])
    assert seen.sum(-1).tolist() == [1, 2, 3, 3, 3]
    with pytest.raises(ValueError, match="exceeds"):
        pc.update(torch.zeros(1, 2, W + 1, 4), torch.zeros(1, 2, W + 1, 4))


# ---------------------------------------------------------------------------
# the streamable convolutions
# ---------------------------------------------------------------------------

CONVS = {
    # name: (transposed, in, out, ksize, stride, dilation or groups, bias, pad_mode)
    "conv_constant": (False, 4, 6, 3, 1, 2, True, "constant"),
    "downsample_edge": (False, 6, 6, 4, 2, 1, False, "edge"),
    "convtr": (True, 6, 4, 4, 2, 1, True, None),
    "convtr_depthwise": (True, 6, 6, 4, 2, 6, False, None),
}


def _conv_pair(name):
    tr, cin, cout, k, s, dg, bias, pad = CONVS[name]
    rng = np.random.default_rng(3)
    with numpy_init(3):
        if tr:
            jm = jmimi.StreamableConvTranspose1d(cin, cout, k, s, dg, bias, True)
            pm = pmimi.StreamableConvTranspose1d(cin, cout, k, s, dg, bias, True,
                                                 device="cpu")
        else:
            jm = jmimi.StreamableConv1d(cin, cout, k, s, dg, 1, bias, True, pad)
            pm = pmimi.StreamableConv1d(cin, cout, k, s, dg, 1, bias, True, pad, device="cpu")
    flat = {key: np.asarray(v) + (0.1 * rng.standard_normal(v.shape).astype(np.float32)
                                  if key.endswith("bias") else 0)
            for key, v in flatten_params(jm).items()}
    jm = load_weights(jm, {key: jnp.asarray(v) for key, v in flat.items()})
    load_jax_params(pm, flat)
    return jm, pm, cin


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_step_against_offline(name):
    """Six steps of 2 rows against one offline call: each equal to the JAX
    module's (offline and stepped, 1e-5), and the port's steps equal to its
    offline call (the `edge` downsample from its second step on: its
    zero-initialised tail stands where the offline call repeats the first
    row)."""
    jm, pm, cin = _conv_pair(name)
    x = np.random.default_rng(4).standard_normal((1, 12, cin)).astype(np.float32)
    offline = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(offline, np.asarray(jm(jnp.asarray(x))), rtol=0, atol=ATOL)
    js = jm.init_state(1) if CONVS[name][0] else jm.init_state(1, cin)
    ps = pm.init_state(1) if CONVS[name][0] else pm.init_state(1, cin)
    jouts, pouts = [], []
    for i in range(6):
        xi = x[:, 2 * i:2 * i + 2]
        jy, js = jm.step(jnp.asarray(xi), js)
        py, ps = pm.step(torch.from_numpy(xi), ps)
        jouts.append(np.asarray(jy))
        pouts.append(py.detach().numpy())
        np.testing.assert_allclose(ps.detach().numpy(), np.asarray(js), rtol=0, atol=ATOL)
    stepped = np.concatenate(pouts, axis=1)
    np.testing.assert_allclose(stepped, np.concatenate(jouts, axis=1), rtol=0, atol=ATOL)
    skip = 1 if name == "downsample_edge" else 0
    np.testing.assert_allclose(stepped[:, skip:], offline[:, skip:stepped.shape[1]], rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def test_codes_identical_and_waveform(pair):
    """Offline encode of 12 frames: codes identical, the decode of those
    codes within 1e-5, both the JAX model's."""
    jm, pm = pair
    audio = _audio(12)
    jcodes = np.asarray(jm.encode(jnp.asarray(audio)))
    pcodes = pm.encode(audio).numpy()
    assert pcodes.shape == (1, 4, 12)
    np.testing.assert_array_equal(pcodes, jcodes)
    assert len(np.unique(pcodes[0, 0])) > 2  # the codebooks are in use
    jwav = np.asarray(jm.decode(jnp.asarray(jcodes)))
    pwav = pm.decode(pcodes).numpy()
    assert pwav.shape == jwav.shape == (1, 1, 12 * 8)
    np.testing.assert_allclose(pwav, jwav, rtol=0, atol=ATOL)
    assert np.abs(pwav).max() > 1e-2


def test_decode_clamps_codes_past_the_bins(pair):
    """Codes past the 16 bins (16-18, as CSM's 2051-way heads draw 2048-2050
    over Mimi's 2048), offline and streamed: the JAX package's gather
    clamps them to the last row, and the port's decode equals it (1e-5)
    and equals the decode of the clamped codes."""
    jm, pm = pair
    codes = np.random.default_rng(9).integers(0, 16, (1, 4, 6)).astype(np.int32)
    codes[0, :, 1], codes[0, 0, 3], codes[0, 2, 5] = 16, 18, 17
    jwav = np.asarray(jm.decode(jnp.asarray(codes)))
    pwav = pm.decode(codes).numpy()
    np.testing.assert_allclose(pwav, jwav, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pwav, pm.decode(np.minimum(codes, 15)).numpy())
    js, ps = jm.init_decode_state(1), pm.init_decode_state(1)
    for t in range(0, 6, 2):
        jy, js = jm.decode_step(jnp.asarray(codes[:, :, t:t + 2]), js)
        py, ps = pm.decode_step(codes[:, :, t:t + 2], ps)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def wide_context(pair):
    """The port's Mimi with the pair's weights and a context of 32 rows:
    the ring then never drops a key a query needs within these tests."""
    jm, _ = pair
    cfg = tiny_cfg(pmimi)
    cfg.transformer.context = 32
    pm = Mimi(cfg, device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return pm


def test_streaming_decode_against_offline(pair, wide_context):
    """Twelve frames decoded in steps of 1, 2 and 3 frames (24 rows at the
    transformer, three times round its 8-slot ring): each step equal to the
    JAX step (1e-5). Against offline: a step of t rows writes t slots before
    its first query reads, so once the ring wraps that query misses the key
    `context - 1` rows back, as in the JAX package; the samples of the
    steps before the wrap (3 frames) equal offline (1e-5), and with a context of 32 rows the
    whole stream does, also through `MimiStreamingDecoder`."""
    jm, pm = pair
    codes = np.random.default_rng(5).integers(0, 16, (1, 4, 12)).astype(np.int32)
    offline = pm.decode(codes).numpy()
    js, ps = jm.init_decode_state(1), pm.init_decode_state(1)
    outs, t = [], 0
    for n in (1, 2, 3, 1, 2, 3):
        c = codes[:, :, t:t + n]
        jy, js = jm.decode_step(jnp.asarray(c), js)
        py, ps = pm.decode_step(c, ps)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
        outs.append(py.numpy())
        t += n
    assert ps["pos"] == int(js["pos"]) == 24
    streamed = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(streamed[..., :24], offline[..., :24], rtol=0, atol=ATOL)
    assert np.abs(streamed - offline).max() > ATOL  # the window's edge shows

    wide = wide_context
    offline = wide.decode(codes).numpy()
    dec = MimiStreamingDecoder(wide)
    streamed = np.concatenate([dec.decode_frames(codes[0, :, i:i + 1]).numpy()
                               for i in range(12)], axis=-1)
    np.testing.assert_allclose(streamed, offline, rtol=0, atol=ATOL)


def test_streaming_encode_against_offline(pair, wide_context):
    """Twelve frames encoded a frame a step: codes identical to the JAX
    steps'; with a context of 32 rows, identical to the offline codes from
    the second frame on."""
    jm, pm = pair
    audio = _audio(12, seed=6)
    js, ps = jm.init_encode_state(1), pm.init_encode_state(1)
    ws = wide_context.init_encode_state(1)
    cols = []
    for i in range(12):
        chunk = audio[:, :, 8 * i:8 * (i + 1)]
        jc, js = jm.encode_step(jnp.asarray(chunk), js)
        pc, ps = pm.encode_step(chunk, ps)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        wc, ws = wide_context.encode_step(chunk, ws)
        cols.append(wc.numpy())
    streamed = np.concatenate(cols, axis=-1)
    offline = wide_context.encode(audio).numpy()
    np.testing.assert_array_equal(streamed[..., 1:], offline[..., 1:])


# ---------------------------------------------------------------------------
# checkpoint layouts
# ---------------------------------------------------------------------------


def test_sanitize_kyutai_layout():
    """A kyutai-named, torch-layout state dict (`chip_smoke`'s writer of
    phase 14's checkpoint) of the published four-ratio
    SEANet (a few channels; no conv weight with as many input channels as
    taps, whose layout the port refuses to guess): the port's `sanitize` returns what the JAX
    package's returns, key for key and bit for bit, and loads strictly into
    parameters equal to the source's."""
    with numpy_init(7):
        cfg = tiny_cfg(jmimi, ratios=(2, 2, 2, 2))
        cfg.seanet.nfilters, cfg.frame_rate = 5, 50.0
        jm = moved(jmimi.Mimi(cfg), np.random.default_rng(7))
    src = {k: np.asarray(v) for k, v in flatten_params(jm).items()}
    sd = {cs.mimi_kyutai_key(k): np.asarray(cs.mimi_torch_layout(k, v))
          for k, v in src.items()}
    assert any(".convtr.convtr." in k for k in sd) and any("._codebook." in k for k in sd)
    pcfg = tiny_cfg(pmimi, ratios=(2, 2, 2, 2))
    pcfg.seanet.nfilters, pcfg.frame_rate = 5, 50.0
    pm = Mimi(pcfg, device="cpu")
    ours, theirs = pm.sanitize(sd), jm.sanitize(sd)
    assert sorted(ours) == sorted(theirs) == sorted(src)
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]), err_msg=k)
    load_jax_params(pm, ours)
    for k, v in pflat(pm).items():
        np.testing.assert_array_equal(v, src[k], err_msg=k)


def test_sanitize_transformers_layout_and_from_pretrained(tmp_path):
    """A tiny transformers `MimiModel`'s state dict (split q/k/v, 1×1
    quantizer convolutions, `.conv` transposed convolutions): the port's
    `sanitize` equals the JAX package's; written as safetensors it loads
    through `Mimi.from_pretrained(<dir>)`'s reader into the same
    parameters, and the port's codes equal transformers' own. A hub id
    raises."""
    transformers = pytest.importorskip("transformers")
    from mlx_audio_tpu_torch import safetensors_io

    hf_cfg = transformers.MimiConfig(
        sampling_rate=24000, frame_rate=12.5, audio_channels=1, hidden_size=32,
        num_filters=6, num_residual_layers=1, upsampling_ratios=[8, 6, 5, 4],
        codebook_size=32, codebook_dim=16, num_quantizers=4, num_semantic_quantizers=1,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=64, head_dim=8, vector_quantization_hidden_dimension=16,
        sliding_window=8, max_position_embeddings=64, upsample_groups=32)
    torch.manual_seed(13)
    hf = transformers.MimiModel(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}

    def cfg(mod):
        return mod.MimiConfig(
            seanet=mod.SeanetConfig(dimension=32, nfilters=6),
            transformer=mod.TransformerConfig(d_model=32, num_heads=4, num_layers=2,
                                              layer_scale=0.01, context=8,
                                              dim_feedforward=64),
            quantizer_nq=4, quantizer_bins=32, quantizer_dim=16)

    with numpy_init(8):
        jm = jmimi.Mimi(cfg(jmimi))
    pm = Mimi(cfg(pmimi), device="cpu")
    ours, theirs = pm.sanitize(sd), jm.sanitize(sd)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]), err_msg=k)
    load_jax_params(pm, ours)

    safetensors_io.save_file(sd, tmp_path / "model.safetensors")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pmimi, "mimi_202407", lambda n: cfg(pmimi))
        loaded = Mimi.from_pretrained(str(tmp_path), filename="model.safetensors",
                                      num_codebooks=4, device="cpu")
    for k, v in pflat(loaded).items():
        np.testing.assert_array_equal(v, pflat(pm)[k], err_msg=k)
    audio = (0.1 * np.random.default_rng(17).standard_normal((1, 1, 3 * 1920))
             ).astype(np.float32)
    with torch.no_grad():
        ref = hf.encode(torch.from_numpy(audio)).audio_codes.numpy()
    np.testing.assert_array_equal(loaded.encode(audio).numpy(), ref)
    with pytest.raises(ValueError, match="download"):
        Mimi.from_pretrained("kyutai/moshiko-pytorch-bf16", device="cpu")
