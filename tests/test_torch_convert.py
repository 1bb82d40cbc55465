"""The port's converter (`convert.py`) against the JAX package's, on seeded
numpy weights written to checkpoint directories by the tests.

Quantized words are bit for bit the JAX package's at 4, 6 and 8 bits (and
2 and 3), scales and biases equal; dequantization within 1e-6 (both compute
q·s + b in float32). Whole conversions (a dtype cast, a quantization with a
mixed recipe, a dequantization) write the same safetensors bytes and the
same config.json.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from mlx_audio_tpu import convert as jconvert
from mlx_audio_tpu_torch import convert as pconvert
from mlx_audio_tpu_torch import safetensors_io as sio
from mlx_audio_tpu_torch import utils as putils


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "model.layers.0.self_attn.q_proj.weight": rng.standard_normal((64, 128)).astype(
            np.float32),
        "model.layers.0.mlp.down_proj.weight": rng.standard_normal((128, 256)).astype(
            np.float32) * 0.02,
        "model.embed_tokens.weight": rng.standard_normal((96, 64)).astype(np.float32),
        "lm_head.weight": rng.uniform(-3, 3, (32, 192)).astype(np.float32),
        "model.norm.weight": np.ones(64, np.float32),
        "model.small.weight": rng.standard_normal((4, 64)).astype(np.float32),
        "model.conv.weight": rng.standard_normal((8, 3, 64)).astype(np.float32),
        "model.ragged.weight": rng.standard_normal((16, 100)).astype(np.float32),
        "model.layers.0.self_attn.q_proj.bias": rng.standard_normal(64).astype(np.float32),
        "model.ids": np.arange(10, dtype=np.int64),
    }


def _equal_dicts(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        o, t = np.asarray(ours[k]), np.asarray(theirs[k])
        assert o.dtype == t.dtype and o.shape == t.shape, k
        np.testing.assert_array_equal(o, t, err_msg=k)


@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_quantize_weights_is_bit_identical(bits, group):
    w = _weights(bits)
    ref = jconvert.quantize_weights(w, bits=bits, group_size=group)
    out = pconvert.quantize_weights(w, bits=bits, group_size=group)
    _equal_dicts(out, ref)
    assert any(k.endswith(".scales") for k in out)
    assert "model.small.weight" in out and "model.small.scales" not in out


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_dequantize_weights_matches_jax(bits):
    q = jconvert.quantize_weights(_weights(10 + bits), bits=bits, group_size=64)
    ref = jconvert.dequantize_weights(q, bits, 64)
    out = pconvert.dequantize_weights(q, bits, 64)
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_predicate_and_recipe_choices():
    """A predicate(key, w) narrows what is quantized; a recipe sets bits by
    path; both as the JAX package's."""
    w = _weights(3)

    def pred(k, v):
        return "layers" in k

    _equal_dicts(pconvert.quantize_weights(w, 4, 64, predicate=pred),
                 jconvert.quantize_weights(w, 4, 64, predicate=pred))
    _equal_dicts(pconvert.quantize_weights(w, 4, 64, recipe="mixed_4_6"),
                 jconvert.quantize_weights(w, 4, 64, recipe="mixed_4_6"))
    with pytest.raises(ValueError, match="unsupported bits"):
        pconvert.quantize_weights(w, bits=5)


def _source(tmp_path, dtype=np.float32, name="src-model"):
    d = tmp_path / name
    weights = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
               for k, v in _weights(7).items()}
    jconvert.save_model(d, weights, {"model_type": "qwen3_tts", "hidden_size": 64})
    (d / "tokenizer_config.json").write_text('{"x": 1}')
    (d / "voices").mkdir()
    (d / "voices" / "a.npy").write_bytes(b"voice")
    return d


@pytest.mark.parametrize("kw", [
    dict(dtype="bfloat16"), dict(dtype="float16"),
    dict(quantize=True, q_bits=4, q_group_size=64),
    dict(quantize=True, q_bits=8, q_group_size=32),
    dict(quantize=True, q_bits=4, q_group_size=64, q_recipe="mixed_4_6"),
    dict(dtype="bfloat16", quantize=True, q_bits=6, q_group_size=64),
], ids=["bf16", "f16", "q4", "q8g32", "mixed_4_6", "bf16_q6"])
def test_convert_writes_what_jax_writes(tmp_path, kw):
    """The same checkpoint bytes (bf16 through the port's own writer, the
    JAX package's through ml_dtypes), config.json, copied tokenizer files
    and voices; the port reads its output back."""
    src = _source(tmp_path)
    ref = jconvert.convert(str(src), str(tmp_path / "j" / "out"), **kw)
    out = pconvert.convert(str(src), str(tmp_path / "p" / "out"), **kw)
    assert (out / "model.safetensors").read_bytes() == (ref / "model.safetensors").read_bytes()
    assert json.loads((out / "config.json").read_text()) == \
        json.loads((ref / "config.json").read_text())
    assert (out / "tokenizer_config.json").read_text() == '{"x": 1}'
    assert (out / "voices" / "a.npy").read_bytes() == b"voice"
    readme = (out / "README.md").read_text()
    assert readme.replace("mlx_audio_tpu_torch", "mlx_audio_tpu") == \
        (ref / "README.md").read_text()
    back = putils.load_weight_files(out)
    assert sorted(back) == sorted(sio.load_file(ref / "model.safetensors"))


def test_dequantize_conversion(tmp_path):
    """A mixed-recipe 4/6-bit checkpoint converted back to float32: the
    per-path overrides in config.json choose each layer's bits; the result
    within 1e-6 of the JAX package's, and the quantization block gone."""
    src = _source(tmp_path)
    q = pconvert.convert(str(src), str(tmp_path / "q"), quantize=True, q_recipe="mixed_4_6")
    cfg = json.loads((q / "config.json").read_text())
    assert cfg["quantization"]["lm_head"] == {"bits": 6, "group_size": 64}
    ref = jconvert.convert(str(q), str(tmp_path / "j"), dequantize=True)
    out = pconvert.convert(str(q), str(tmp_path / "p"), dequantize=True)
    assert "quantization" not in json.loads((out / "config.json").read_text())
    a, b = sio.load_file(out / "model.safetensors"), sio.load_file(ref / "model.safetensors")
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


def test_main_and_the_refusals(tmp_path, capsys):
    """`main(argv)` takes the JAX package's flags; a hub id and
    --upload-repo raise, since the port neither downloads nor uploads."""
    src = _source(tmp_path)
    pconvert.main(["--model", str(src), "--output-path", str(tmp_path / "p"), "-q",
                   "--q-bits", "8"])
    jconvert.main(["--model", str(src), "--output-path", str(tmp_path / "j"), "-q",
                   "--q-bits", "8"])
    assert (tmp_path / "p" / "model.safetensors").read_bytes() == \
        (tmp_path / "j" / "model.safetensors").read_bytes()
    assert "converted (tts)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="does not upload"):
        pconvert.convert(str(src), str(tmp_path / "u"), upload_repo="me/model")
    with pytest.raises(ValueError, match="does not download"):
        pconvert.convert("someone/some-model", str(tmp_path / "h"))


@pytest.mark.parametrize("path,config", [
    ("x/model", {"model_type": "whisper"}), ("x/model", {"model_type": "Qwen3-TTS"}),
    ("x/model", {"model_type": "sortformer"}), ("a/kokoro-82m", {}),
    ("a/my-asr", {}), ("a/diarizer", {}), ("a/snac-24khz", {}),
    ("a/model", {"n_audio_ctx": 1500, "n_text_ctx": 448}),
    ("a/model", {"istftnet": {}, "style_dim": 128}),
    ("a/model", {"codebook_size": 1024, "upsampling_ratios": [8]}), ("a/model", {}),
])
def test_detect_model_domain(path, config):
    assert pconvert.detect_model_domain(Path(path), config) == \
        jconvert.detect_model_domain(Path(path), config)


def test_save_model_writes_strided_views_by_value(tmp_path):
    """A transposed (non-contiguous) array goes out by value. (The JAX
    package's `save_model` hands such a view to safetensors.numpy, which
    writes the view's underlying buffer: ROADMAP Queue 3.)"""
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    pconvert.save_model(tmp_path / "p", {"t.weight": w.T}, {"model_type": "x"})
    np.testing.assert_array_equal(putils.load_weight_files(tmp_path / "p")["t.weight"], w.T)
