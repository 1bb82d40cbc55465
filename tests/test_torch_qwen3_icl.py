"""Qwen3-TTS ICL voice cloning in the port against the JAX package on the
CPU at tiny widths: the speech tokenizer's Mimi-based encoder (reference
codes identical), the ICL prefill embeddings, greedy ICL codes and audio
through `generate(ref_audio=..., ref_text=...)`, and the loader building
the encoder where the checkpoint carries its weights.

The encoder runs the published SEANet ratios (8, 6, 5, 4: 1920 samples a
frame) at a few channels, with 4 quantizers of 32 (the talker's four code
groups). Bars: the prefill embeddings 1e-5 (float32, values of O(1));
codes identical; audio 1e-4 absolute, the bar of
`tests/test_torch_qwen3_tts.py` for this decoder.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu.tts.models.qwen3_tts import Model as JaxModel
from mlx_audio_tpu.tts.models.qwen3_tts import ModelConfig as JaxConfig
from mlx_audio_tpu_torch import convert as pconvert
from mlx_audio_tpu_torch import utils as putils
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.module import flatten_params as pflat
from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)
from test_torch_qwen3_speaker import SPK
from test_torch_qwen3_tts import CFG, TEXT, Tok, _codes

ATOL = 1e-4
EMB_ATOL = 1e-5
ENCODER = dict(hidden_size=32, intermediate_size=64, num_filters=4, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2, head_dim=16, codebook_dim=16,
               codebook_size=32, num_quantizers=4, sliding_window=8)
ICL = dict(CFG, speaker_encoder_config=SPK,
           tokenizer_config=dict(CFG["tokenizer_config"], encoder_config=ENCODER))
REF_TEXT = "A reference line."


def _moved_icl(jm, rng):
    """The JAX model with every constant-initialised parameter moved: the
    codebooks start at zero, the usages and layer scales at one."""
    from mlx_audio_tpu.nn.module import load_weights

    flat = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v, np.float32)
        if v.size and np.all(v == v.flat[0]):
            noise = rng.standard_normal(v.shape).astype(np.float32)
            v = v + (0.1 * np.abs(noise) if k.endswith("cluster_usage") else 0.1 * noise)
        flat[k] = v
    return load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})


def _ref(seconds=0.5, seed=3):
    t = np.arange(int(24000 * seconds)) / 24000
    noise = 0.05 * np.random.default_rng(seed).standard_normal(t.size)
    return (0.3 * np.sin(2 * np.pi * 180 * t) + noise).astype(np.float32)


@pytest.fixture(scope="module")
def icl_pair():
    with numpy_init(4):
        jm = _moved_icl(JaxModel(JaxConfig.from_dict(ICL)), np.random.default_rng(4))
    pm = Model(ICL, device="cpu", seed=1)
    pm.speech_tokenizer.build_encoder()
    assert "speech_tokenizer.encoder." not in pm.NOT_BUILT
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    jm.set_runtime(tokenizer=Tok())
    pm.set_runtime(tokenizer=Tok())
    return jm, pm


def test_reference_codes_identical(icl_pair):
    """The encoder's codes of 0.5 s (6.25 frames: the edge-padded
    downsample rounds up to 7): the JAX encoder's, 4 codebooks."""
    jm, pm = icl_pair
    audio = _ref()[None, None]
    want = np.asarray(jm.speech_tokenizer.encode(jnp.asarray(audio)))
    got = pm.speech_tokenizer.encode(audio).numpy()
    assert got.shape == want.shape == (1, 4, 7)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[0, 0])) > 1


def test_icl_prefill_embeddings(icl_pair):
    """`_prepare_icl_generation_inputs`: the prefill (role, codec prefix
    with the x-vector, text over codec_pad, reference codes over tts_pad)
    within 1e-5, the trailing and pad embeddings too, and the reference
    codes identical; with a language id the prefix takes the think
    tokens."""
    jm, pm = icl_pair
    for lang in ("auto", "english"):
        want = jm._prepare_icl_generation_inputs(TEXT, _ref(), REF_TEXT, language=lang)
        got = pm._prepare_icl_generation_inputs(TEXT, _ref(), REF_TEXT, language=lang)
        for g, w in zip(got[:3], want[:3]):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=EMB_ATOL)
        np.testing.assert_array_equal(got[3], np.asarray(want[3]))
    n_text = len(Tok().encode(f"<|im_start|>assistant\n{REF_TEXT}<|im_end|>\n")) - 5 + len(
        Tok().encode(f"<|im_start|>assistant\n{TEXT}<|im_end|>\n<|im_start|>assistant\n")) - 8
    # role 3, prefix (nothink, think_bos, think_eos, x-vector, pad) 5, text + tts_eos,
    # codec_bos + 7 reference frames
    assert got[0].shape[1] == 3 + 5 + (n_text + 1) + 8


def test_icl_greedy_codes_and_audio(icl_pair):
    """`generate(ref_audio=..., ref_text=...)` greedy, 8 frames: the codes
    the decoder sees (the 7 reference frames, then the generated ones) are
    the JAX package's, and so is the audio with the reference's share cut
    off (1e-4)."""
    jm, pm = icl_pair
    (jcodes,), (jres,) = _codes(jm, ref_audio=_ref(), ref_text=REF_TEXT)
    (pcodes,), (pres,) = _codes(pm, ref_audio=_ref(), ref_text=REF_TEXT)
    np.testing.assert_array_equal(pcodes, jcodes)
    assert pcodes.shape[0] == 7 + pres.token_count and pres.token_count == jres.token_count
    assert pres.samples == jres.samples
    np.testing.assert_allclose(pres.audio, np.asarray(jres.audio), rtol=0, atol=ATOL)
    ref_codes = pm.speech_tokenizer.encode(_ref()[None, None]).numpy()[0].T
    np.testing.assert_array_equal(pcodes[:7], ref_codes)


def test_loader_builds_the_encoder_where_the_checkpoint_has_it(icl_pair, tmp_path):
    """A checkpoint with the speech tokenizer's encoder: the loader builds
    it and fills it (the parameters equal the source's), and ICL runs; the
    same checkpoint without those keys loads without it, and ICL raises."""
    _, pm = icl_pair
    cfg = dict(ICL, model_type="qwen3_tts")
    flat = pflat(pm)
    pconvert.save_model(tmp_path / "with", flat, cfg)
    pconvert.save_model(tmp_path / "without",
                        {k: v for k, v in flat.items()
                         if not k.startswith("speech_tokenizer.encoder.")}, cfg)
    loaded = putils.load_model(tmp_path / "with", device="cpu")
    assert hasattr(loaded.speech_tokenizer, "encoder")
    got = pflat(loaded)
    assert sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    loaded.set_runtime(tokenizer=Tok())
    (codes,), _ = _codes(loaded, ref_audio=_ref(), ref_text=REF_TEXT)
    (want,), _ = _codes(pm, ref_audio=_ref(), ref_text=REF_TEXT)
    np.testing.assert_array_equal(codes, want)
    bare = putils.load_model(tmp_path / "without", device="cpu")
    assert not hasattr(bare.speech_tokenizer, "encoder")
    with pytest.raises(ValueError, match="ICL"):
        list(bare.generate(TEXT, ref_audio=_ref(), ref_text=REF_TEXT))
    assert json.loads((tmp_path / "with" / "config.json").read_text())[
        "tokenizer_config"]["encoder_config"]["num_quantizers"] == 4
