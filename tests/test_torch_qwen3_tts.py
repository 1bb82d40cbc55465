"""Qwen3-TTS in the port against the JAX package on a tiny configuration,
and the layers, rope and sampling filters it uses.

Weights go across with load_jax_params; every parameter whose JAX
initialiser gives a constant (norms, biases, SnakeBeta, LayerScale,
ConvNeXt gamma) is moved off it first, so the parity covers it. float32
bars: 1e-5 for single layers, 1e-4 for the talker, the code predictor, the
codec decoder and the waveform (the same float32 math in other summation
orders leaves ~1e-6). Greedy codes must be identical, unquantized and int4.
The widths are multiples of the group size 64 so that every Linear
quantizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.lm import sample as jsample
from mlx_audio_tpu.nn import layers as jl
from mlx_audio_tpu.nn import quantized as jq
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu.ops import rope as jrope
from mlx_audio_tpu.tts.models.qwen3_tts import Model as JaxModel
from mlx_audio_tpu.tts.models.qwen3_tts import ModelConfig as JaxConfig
from mlx_audio_tpu_torch.lm import sample as psample
from mlx_audio_tpu_torch.nn import ConvTranspose1d, Conv1d, RMSNorm, Linear, load_jax_params
from mlx_audio_tpu_torch.nn import quantized as pq
from mlx_audio_tpu_torch.ops import rope as prope
from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import NOT_BUILT

ATOL_LAYER = 1e-5
ATOL = 1e-4

CFG = dict(
    talker_config=dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, text_hidden_size=128,
        text_vocab_size=512, num_code_groups=4,
        codec_eos_token_id=200, codec_think_id=210, codec_nothink_id=211,
        codec_think_bos_id=212, codec_think_eos_id=213, codec_pad_id=214, codec_bos_id=215,
        rope_scaling={"mrope_section": [4, 2, 2]},
        code_predictor_config=dict(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_code_groups=4),
    ),
    tts_pad_token_id=500, tts_bos_token_id=501, tts_eos_token_id=502,
    tokenizer_config=dict(
        decoder_config=dict(
            latent_dim=64, codebook_dim=32, codebook_size=256, decoder_dim=64,
            hidden_size=64, intermediate_size=128, head_dim=16, num_attention_heads=4,
            num_hidden_layers=1, num_key_value_heads=4, num_quantizers=4,
            num_semantic_quantizers=1, sliding_window=8, upsample_rates=[4, 2],
            upsampling_ratios=[2])),
)
TEXT = "Hello there, world."


class Tok:
    def encode(self, text, **kw):
        return [(ord(c) % 97) + 3 for c in text[:48]]


def _bench_predicate(path, m):
    """What `bench.py` quantizes: every Linear but the code predictor's heads."""
    return isinstance(m, (jl.Linear, Linear)) and "code_predictor.lm_head" not in path


def _moved(jm, rng):
    """The JAX model with every constant-initialised parameter moved."""
    flat = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v)
        if v.size and np.all(v == v.flat[0]):
            v = v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
        flat[k] = v
    return load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})


def _pair(fresh, bits=None):
    jm = _moved(fresh, np.random.default_rng(0))
    pm = Model(CFG, device="cpu", seed=1)
    if bits:
        jm = jq.quantize_module(jm, bits=bits, predicate=_bench_predicate)
        pq.quantize_module(pm, bits=bits, predicate=_bench_predicate)
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()},
                    not_built=NOT_BUILT)
    if bits:
        assert jq.fuse_quantized_projections(jm) == pq.fuse_quantized_projections(pm) > 0
    jm.set_runtime(tokenizer=Tok())
    pm.set_runtime(tokenizer=Tok())
    return jm, pm


@pytest.fixture(scope="module")
def jax_fresh():
    # without the speech-tokenizer encoder (ICL only, tests/test_torch_qwen3_icl.py):
    # the config object skips it, the dict would fill in a default one
    cfg = JaxConfig.from_dict(CFG)
    cfg.tokenizer_config.encoder_config = None
    return JaxModel(cfg)


@pytest.fixture(scope="module")
def pair(jax_fresh):
    return _pair(jax_fresh)


@pytest.fixture(scope="module")
def pair_int4(jax_fresh):
    return _pair(jax_fresh, bits=4)


# ---- layers, rope, filters ----


def _bridged(jax_layer, port_layer, rng):
    for name, val in flatten_params(jax_layer).items():
        setattr(jax_layer, name, jnp.asarray(
            rng.standard_normal(val.shape).astype(np.float32) * 0.3))
    load_jax_params(port_layer, {k: np.asarray(v) for k, v in flatten_params(jax_layer).items()})
    return jax_layer, port_layer


def _same(jax_layer, port_layer, x, atol=ATOL_LAYER):
    with torch.no_grad():
        out = port_layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_layer(jnp.asarray(x))), atol=atol)


def test_rmsnorm():
    rng = np.random.default_rng(1)
    j, p = _bridged(jl.RMSNorm(24, eps=1e-6), RMSNorm(24, eps=1e-6, device="cpu"), rng)
    _same(j, p, rng.standard_normal((2, 5, 24)).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(dilation=3, groups=4, bias=False),
                                dict(stride=2, padding=2, groups=2),
                                dict(dilation=9)])
def test_conv1d_grouped_dilated(kw):
    rng = np.random.default_rng(2)
    j, p = _bridged(jl.Conv1d(8, 12, 3, **kw), Conv1d(8, 12, 3, device="cpu", **kw), rng)
    _same(j, p, rng.standard_normal((2, 40, 8)).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(stride=4), dict(stride=2, padding=1, output_padding=1),
                                dict(stride=3, bias=False)])
def test_conv_transpose1d(kw):
    rng = np.random.default_rng(3)
    j, p = _bridged(jl.ConvTranspose1d(6, 10, 8, **kw),
                    ConvTranspose1d(6, 10, 8, device="cpu", **kw), rng)
    assert tuple(p.weight.shape) == (6, 10, 8)
    _same(j, p, rng.standard_normal((2, 9, 6)).astype(np.float32))


@pytest.mark.parametrize("traditional", [False, True])
def test_rope(traditional):
    rng = np.random.default_rng(4)
    pos = np.arange(3, 14)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 12, base=500.0)
    pc, ps = prope.rope_cos_sin(torch.from_numpy(pos), 12, base=500.0)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)
    x = rng.standard_normal((2, 3, 11, 16)).astype(np.float32)  # 4 features pass through
    np.testing.assert_allclose(
        prope.apply_rope(torch.from_numpy(x), pc, ps, traditional).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js, traditional)), atol=1e-6)


def test_sample_filters_and_repetition_penalty():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 40)).astype(np.float32) * 3
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(psample.top_k_filter(t, 7).numpy(),
                                  np.asarray(jsample.top_k_filter(jnp.asarray(logits), 7)))
    for p in (0.3, 0.9):
        np.testing.assert_array_equal(psample.top_p_filter(t, p).numpy(),
                                      np.asarray(jsample.top_p_filter(jnp.asarray(logits), p)))
    # -1 pads must not touch the last token (a torch index of -1 would)
    hist = np.full((2, 10), -1, np.int32)
    hist[0, -3:] = [4, 39, 4]
    hist[1, -1] = 0
    got = psample.apply_repetition_penalty(t, torch.from_numpy(hist), 1.3).numpy()
    ref = np.asarray(jsample.apply_repetition_penalty(jnp.asarray(logits),
                                                      jnp.asarray(hist), 1.3))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got[1, 39] == logits[1, 39]


# ---- the model ----


def test_constant_initialisers_match_jax(jax_fresh):
    """The port's own initialisers give what the JAX package's give wherever
    those are constant: norms 1, biases 0, SnakeBeta 0, LayerScale 0.01,
    ConvNeXt gamma 1e-6."""
    jflat = {k: np.asarray(v) for k, v in flatten_params(jax_fresh).items()}
    params = dict(Model(CFG, device="cpu").named_parameters())
    checked = 0
    for k, v in jflat.items():
        if k.startswith(NOT_BUILT) or not np.all(v == v.flat[0]):
            continue
        np.testing.assert_array_equal(params[k].detach().numpy().reshape(-1),
                                      np.full(v.size, v.flat[0]), err_msg=k)
        checked += 1
    assert checked > 40


def test_talker_prefill_and_decode_step(pair):
    jm, pm = pair
    rng = np.random.default_rng(6)
    jc = jm.talker.model.make_caches(1, 16)
    pc = pm.talker.model.make_caches(1, 16)
    for T in (5, 1, 1):
        x = rng.standard_normal((1, T, 64)).astype(np.float32)
        jl_, jh, jc = jm.talker(jnp.asarray(x), jc)
        with torch.no_grad():
            pl_, ph = pm.talker(torch.from_numpy(x), pc)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl_), atol=ATOL)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=ATOL)


def test_code_predictor(pair):
    jm, pm = pair
    rng = np.random.default_rng(7)
    jc = jm.talker.code_predictor.model.make_caches(1, 6)
    pc = pm.talker.code_predictor.model.make_caches(1, 6)
    for T in (2, 1, 1):
        x = rng.standard_normal((1, T, 64)).astype(np.float32)
        jh, jc = jm.talker.code_predictor.model(jnp.asarray(x), jc)
        with torch.no_grad():
            ph = pm.talker.code_predictor.model(torch.from_numpy(x), pc)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=ATOL)


def test_codec_decoder_and_chunks(pair):
    jm, pm = pair
    codes = np.random.default_rng(8).integers(0, 256, (1, 4, 13)).astype(np.int32)
    ref = np.asarray(jm.speech_tokenizer.decode(codes))
    got = pm.speech_tokenizer.decode(torch.from_numpy(codes)).numpy()
    assert got.shape == (1, 13 * 16)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    ref_c = jm.speech_tokenizer.chunked_decode(codes, chunk_size=5, left_context_size=2)
    got_c = pm.speech_tokenizer.chunked_decode(torch.from_numpy(codes), chunk_size=5,
                                               left_context_size=2)
    np.testing.assert_allclose(got_c, ref_c, atol=ATOL)


def _codes(model, **kw):
    """Greedy codes of one generate call, read back from the decoder's input."""
    seen = []
    orig = model._decode_codes

    def spy(codes_nk):
        seen.append(np.asarray(codes_nk))
        return orig(codes_nk)

    model._decode_codes = spy
    try:
        results = list(model.generate(TEXT, temperature=0.0, max_tokens=8, min_tokens=8, **kw))
    finally:
        del model._decode_codes
    return seen, results


@pytest.mark.parametrize("which", ["f32", "int4"])
def test_greedy_generate_matches_jax(which, request):
    jm, pm = request.getfixturevalue("pair" if which == "f32" else "pair_int4")
    (jcodes,), (jres,) = _codes(jm)
    (pcodes,), (pres,) = _codes(pm)
    assert pcodes.shape == (8, 4)
    np.testing.assert_array_equal(pcodes, jcodes)
    assert pres.token_count == jres.token_count == 8
    assert pres.samples == jres.samples == 8 * 16
    np.testing.assert_allclose(pres.audio, jres.audio, atol=ATOL)


def test_streaming_gives_the_same_codes(pair_int4):
    """Sampled, not greedy: the generator carries across chunks, so chunking
    is invisible in the codes; the same seed gives the same codes."""
    _, pm = pair_int4
    kw = dict(temperature=0.9, top_k=20, max_tokens=10, min_tokens=10, seed=3)
    full = [pm._run_codes(*pm._prepare_generation_inputs(TEXT), chunk_tokens=10,
                          top_p=1.0, repetition_penalty=1.05, **kw)]
    a = np.concatenate(list(full[0]))
    b = np.concatenate(list(pm._run_codes(*pm._prepare_generation_inputs(TEXT),
                                          chunk_tokens=3, top_p=1.0,
                                          repetition_penalty=1.05, **kw)))
    assert a.shape == (10, 4)
    np.testing.assert_array_equal(a, b)
    chunks = list(pm.generate(TEXT, stream=True, streaming_interval=0.25, **kw))
    assert [c.token_count for c in chunks] == [3, 3, 3, 1]
    assert all(c.is_streaming_chunk for c in chunks) and chunks[-1].is_final_chunk
    assert sum(c.samples for c in chunks) == 10 * 16


def test_unported_routes_raise(pair):
    """ICL (ref_audio with ref_text) raises on a model built without the
    speech tokenizer's encoder (tests/test_torch_qwen3_icl.py holds the ICL
    route). ref_audio alone does not: a config without the speaker encoder
    ignores it, as the JAX package does (tests/test_torch_qwen3_speaker.py
    holds the Base route)."""
    jm, pm = pair
    with pytest.raises(ValueError, match="ICL"):
        list(pm.generate(TEXT, ref_audio=np.zeros(2400, np.float32), ref_text="hi"))
    assert pm.speaker_encoder is None
    (with_ref,), _ = _codes(pm, ref_audio=np.zeros(2400, np.float32))
    (jax_ref,), _ = _codes(jm, ref_audio=np.zeros(2400, np.float32))
    (plain,), _ = _codes(pm)
    np.testing.assert_array_equal(with_ref, plain)
    np.testing.assert_array_equal(with_ref, jax_ref)


# ---- the result type and the discovery API ----


@pytest.mark.parametrize("peak", [3 * 2**30, 1_234_567_890])
def test_peak_memory_reads_gib_as_jax_does(monkeypatch, peak):
    """`GenerationResult` fills in the card's peak in GiB rounded to 3
    places, through `profiling.peak_memory_gb` in both packages: 3·2³⁰
    bytes read 3.0 (1e9-byte GB would read 3.221)."""
    from mlx_audio_tpu import profiling as jprof
    from mlx_audio_tpu.tts.models.base import GenerationResult as JaxResult
    from mlx_audio_tpu_torch import profiling as pprof
    from mlx_audio_tpu_torch.tts.models import base as pbase

    monkeypatch.setattr(jprof, "memory_stats", lambda device=None: {"peak_bytes_in_use": peak})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: peak)
    assert pprof.peak_memory_gb() == jprof.peak_memory_gb()
    kw = dict(audio=np.zeros(4, np.float32), samples=4, sample_rate=24000)
    got = pbase.GenerationResult(**kw).peak_memory_usage
    assert got == JaxResult(**kw).peak_memory_usage
    if peak == 3 * 2**30:
        assert got == 3.0


def test_language_and_generate_config_match_jax():
    """`supported_languages` leaves the dialect ids out in both packages;
    `load_generate_config` stores the dict that `generate_config` reads."""
    talker = dict(CFG["talker_config"],
                  codec_language_id={"english": 220, "chinese": 221, "sichuan_dialect": 222},
                  spk_id={"vivian": 230, "eric": 231}, spk_is_dialect={"eric": "sichuan_dialect"})
    cfg = dict(CFG, talker_config=talker)
    jcfg = JaxConfig.from_dict(cfg)
    jcfg.tokenizer_config.encoder_config = None
    jm, pm = JaxModel(jcfg), Model(cfg, device="cpu")
    assert pm.supported_languages == jm.supported_languages == ["auto", "english", "chinese"]
    assert pm.get_supported_languages() == jm.get_supported_languages()
    assert pm.get_supported_speakers() == jm.get_supported_speakers() == ["eric", "vivian"]
    assert pm.generate_config is None and jm.generate_config is None
    gen = {"temperature": 0.9, "top_k": 50, "repetition_penalty": 1.05}
    pm.load_generate_config(gen)
    jm.load_generate_config(gen)
    assert pm.generate_config == jm.generate_config == gen
