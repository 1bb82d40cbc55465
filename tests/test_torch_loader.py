"""The port's loader (`utils.load_model`, `nn.load_weights` /
`flatten_params`, `safetensors_io`) against the JAX package's, on checkpoint
directories the tests write from seeded weights.

Checkpoints go both ways: the JAX package writes one (`convert.save_model`
over its `flatten_params`) and both packages' `load_model` load it; the
port writes one and the JAX package loads it. Loaded parameters must be
equal bit for bit (in the JAX package's layout), and so must greedy tokens
and codes; float32 outputs within 1e-5 (Whisper's encoder and logits),
1e-4 (Qwen3-TTS audio, the bar of tests/test_torch_qwen3_tts.py) and
2 int16 steps (Kokoro audio, the bar of tests/test_torch_kokoro.py). A
Kokoro checkpoint in the upstream torch layout (weight norm as weight_g /
weight_v) folds back to within 1 float32 ulp a weight, so its audio is
held to the same bar.

The Qwen3-TTS int4 checkpoints are written with the port's
`checkpoint_quant_predicate`: the JAX package's own `convert(quantize=True)`
quantizes layers its loader declines (ROADMAP Queue 3, shown by
`test_jax_convert_quantizes_what_its_loader_declines`), and the JAX side
is given the port's predicate through the `jax_qwen3_predicate` fixture.
"""

import copy
import json

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save
from safetensors.torch import save_file as st_tsave

import mlx_audio_tpu.tts.models.kokoro.kokoro as jkok
from mlx_audio_tpu import convert as jconvert
from mlx_audio_tpu import utils as jutils
from mlx_audio_tpu.nn.module import flatten_params as jflat
from mlx_audio_tpu.nn.module import load_weights as jload_weights
from mlx_audio_tpu.stt.models.whisper import Model as JaxWhisper
from mlx_audio_tpu.stt.models.whisper import ModelDimensions as JaxDims
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu.tts.models.qwen3_tts import Model as JaxQwen
from mlx_audio_tpu.tts.models.qwen3_tts import ModelConfig as JaxQwenConfig
from mlx_audio_tpu_torch import convert as pconvert
from mlx_audio_tpu_torch import safetensors_io as sio
from mlx_audio_tpu_torch import utils as putils
from mlx_audio_tpu_torch.nn import ConvTranspose1d, flatten_params, load_weights
from mlx_audio_tpu_torch.nn.sanitize import orient_to
from mlx_audio_tpu_torch.stt.models.whisper import Model as Whisper
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer
from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model as Qwen
from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import torch_checkpoint
from mlx_audio_tpu_torch.tts.models.kokoro.pipeline import load_voice_tensor
from mlx_audio_tpu_torch.tts.models.qwen3_tts import checkpoint_quant_predicate
from test_torch_kokoro import LSB, PHONEMES, TINY, model_noise
from test_torch_kokoro import exact_first_frame, small_buckets  # noqa: F401  (fixtures)
from test_torch_qwen3_tts import CFG as QWEN_CFG
from test_torch_qwen3_tts import Tok, _codes, _moved
from test_torch_whisper import DIMS, jax_residual  # noqa: F401  (a fixture)

# a small speech-tokenizer encoder for the JAX package to build from
# config.json (the port does not build it: ICL only), instead of the
# published 8-layer default
QWEN_ENCODER = dict(hidden_size=32, intermediate_size=64, num_filters=4, num_hidden_layers=1,
                    num_attention_heads=2, num_key_value_heads=2, head_dim=16,
                    codebook_dim=16, codebook_size=32, num_quantizers=2,
                    upsampling_ratios=[2, 2])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(flat):
    out = {}
    for k, v in flat.items():
        out[k] = v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _same_params(port_model, jax_model, skip=()):
    """The port's parameters (JAX layout) equal the JAX model's, bit for bit."""
    ours, theirs = _np(flatten_params(port_model)), _np(jflat(jax_model))
    theirs = {k: v for k, v in theirs.items() if not k.startswith(tuple(skip))}
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

DTYPES = [np.float32, np.float16, np.float64, np.int64, np.int32, np.int16, np.int8,
          np.uint32, np.uint16, np.uint8, np.bool_]


def _tensors(dtype, seed=0):
    rng = np.random.default_rng(seed)

    def draw(shape):
        if dtype == np.bool_:
            return rng.integers(0, 2, shape).astype(bool)
        if np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            return rng.integers(info.min, info.max, shape, endpoint=True, dtype=dtype)
        return rng.standard_normal(shape).astype(dtype)

    return {"b.weight": draw((3, 5)), "a.bias": draw((7,)), "scalar": draw(()),
            "empty": draw((0, 4)), "z.last": draw((2, 2, 2))}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_safetensors_read_and_write_match_the_library(tmp_path, dtype):
    t = _tensors(dtype)
    st_save(t, str(tmp_path / "ref.safetensors"), metadata={"format": "np"})
    sio.save_file(t, tmp_path / "ours.safetensors", metadata={"format": "np"})
    assert (tmp_path / "ours.safetensors").read_bytes() == \
        (tmp_path / "ref.safetensors").read_bytes()
    ref = st_load(str(tmp_path / "ref.safetensors"))
    got = sio.load_file(tmp_path / "ref.safetensors")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k])


def test_safetensors_bf16_and_mixed_match_torch(tmp_path):
    """BF16 has no numpy dtype: it reads as a torch tensor over the file's
    bytes, and the writer's bytes equal safetensors.torch's."""
    g = torch.Generator().manual_seed(0)
    t = {"w": torch.randn(4, 6, generator=g).bfloat16(), "v": torch.randn(3, generator=g),
         "i": torch.arange(5, dtype=torch.int64), "e": torch.zeros(0, 3, dtype=torch.bfloat16)}
    st_tsave(t, str(tmp_path / "ref.safetensors"))
    sio.save_file(t, tmp_path / "ours.safetensors")
    assert (tmp_path / "ours.safetensors").read_bytes() == \
        (tmp_path / "ref.safetensors").read_bytes()
    got = sio.load_file(tmp_path / "ref.safetensors")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t["w"])
    assert got["e"].shape == (0, 3)
    np.testing.assert_array_equal(got["v"], t["v"].numpy())
    # copy-on-write: writing into a loaded array leaves the file as it was
    before = (tmp_path / "ref.safetensors").read_bytes()
    got["v"][:] = 7.0
    got["w"].zero_()
    assert (tmp_path / "ref.safetensors").read_bytes() == before


def test_safetensors_sharded_index(tmp_path, monkeypatch):
    """`convert.save_model` shards past MAX_FILE_SIZE_GB with an index in
    both packages (the same files and index); the port reads the shards
    through the index and rejects an index that disagrees with them."""
    w = {f"layer{i}.weight": np.full((64, 64), i, np.float32) for i in range(5)}
    monkeypatch.setattr(jconvert, "MAX_FILE_SIZE_GB", 20000 / 1024**3)
    monkeypatch.setattr(pconvert, "MAX_FILE_SIZE_GB", 20000 / 1024**3)
    jconvert.save_model(tmp_path / "j", w, {"model_type": "x"})
    pconvert.save_model(tmp_path / "p", w, {"model_type": "x"})
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "p").iterdir())
    assert "model-00005-of-00005.safetensors" in names
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    got = putils.load_weight_files(tmp_path / "j")
    assert sorted(got) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(got[k], w[k])
    index = json.loads((tmp_path / "p" / sio.INDEX_NAME).read_text())
    wm = index["weight_map"]
    wm["layer0.weight"], wm["layer1.weight"] = wm["layer1.weight"], wm["layer0.weight"]
    (tmp_path / "p" / sio.INDEX_NAME).write_text(json.dumps(index))
    with pytest.raises(ValueError, match="the index says"):
        putils.load_weight_files(tmp_path / "p")


def _valid(tmp_path):
    sio.save_file({"a": np.arange(4, dtype=np.float32), "b": np.ones(2, np.int64)},
                  tmp_path / "v.safetensors")
    return (tmp_path / "v.safetensors").read_bytes()


def _with_header(data, header: dict):
    head = json.dumps(header).encode()
    n = int.from_bytes(data[:8], "little")
    return len(head).to_bytes(8, "little") + head + data[8 + n:]


@pytest.mark.parametrize("case", ["empty", "short", "length", "json", "dtype", "size",
                                  "overlap", "cut", "shape"])
def test_safetensors_rejects_malformed_files(tmp_path, case):
    data = _valid(tmp_path)
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    bad = {
        "empty": b"",
        "short": data[:5],
        "length": (10**6).to_bytes(8, "little") + data[8:],
        "json": data[:8] + b"x" + data[9:],
        "dtype": _with_header(data, {**header, "a": {**header["a"], "dtype": "F8"}}),
        "size": _with_header(data, {**header, "a": {**header["a"], "shape": [5]}}),
        "overlap": _with_header(data, {**header, "a": {**header["a"],
                                                       "data_offsets": [4, 20]}}),
        "cut": data[:-3],
        "shape": _with_header(data, {**header, "a": {**header["a"], "shape": [-4]}}),
    }[case]
    path = tmp_path / f"{case}.safetensors"
    path.write_bytes(bad)
    with pytest.raises(ValueError, match=f"{case}.safetensors"):
        sio.load_file(path)


# ---------------------------------------------------------------------------
# load_weights, flatten_params and the loader's decisions
# ---------------------------------------------------------------------------


def test_load_weights_errors_match_jax():
    """An unknown key, a missing key (strict) and a shape mismatch raise the
    JAX package's errors, message for message."""
    jm, pm = JaxWhisper(JaxDims(**DIMS)), Whisper(DIMS, device="cpu")
    flat = {k: np.asarray(v) for k, v in jflat(jm).items()}
    for weights, strict in (({**flat, "decoder.nope": np.zeros(2)}, False),
                            ({k: v for k, v in flat.items() if k != "decoder.ln.bias"}, True),
                            ({**flat, "encoder.conv1.weight": np.zeros((64, 80, 3))}, False),
                            ({**flat, "decoder.ln.bias": np.zeros(3)}, False)):
        with pytest.raises(ValueError) as ref:
            jload_weights(jm, weights, strict=strict)
        with pytest.raises(ValueError) as got:
            load_weights(pm, weights, strict=strict)
        assert str(got.value) == str(ref.value)
    with pytest.raises(TypeError, match="dtype mismatch"):
        load_weights(pm, {"decoder.ln.bias": np.zeros(64, np.int32)}, strict=False)


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_flatten_params_inverts_load_weights(groups):
    """The JAX layout out and in again, through a grouped transposed conv
    whose layout map is per group; int32 words go out as uint32."""
    a = ConvTranspose1d(8, 16, 3, stride=2, padding=1, groups=groups, device="cpu")
    a.reset_parameters(torch.Generator().manual_seed(groups))
    flat = flatten_params(a)
    assert flat["weight"].shape == (16, 3, 8 // groups)
    b = ConvTranspose1d(8, 16, 3, stride=2, padding=1, groups=groups, device="cpu")
    load_weights(b, flat)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    from mlx_audio_tpu_torch.nn import Linear
    from mlx_audio_tpu_torch.nn.quantized import QuantizedLinear

    q = QuantizedLinear.from_linear(Linear(64, 8, device="cpu"), bits=4)
    assert flatten_params(q)["weight"].dtype == np.uint32


def test_orientation_that_a_shape_cannot_tell_raises():
    """Shape-driven orientation takes what fits one layout, as the JAX
    package does, and raises where a weight fits two that order it
    differently."""
    w = np.arange(2 * 3 * 5).reshape(2, 5, 3).astype(np.float32)  # torch (O, I, K)
    np.testing.assert_array_equal(orient_to(w, (2, 3, 5)), w.transpose(0, 2, 1))
    assert orient_to(w, (2, 5, 3)) is w
    with pytest.raises(ValueError, match="cannot be told"):
        orient_to(np.zeros((4, 3, 3)), (4, 3, 3))
    with pytest.raises(ValueError, match="cannot be told"):
        orient_to(np.zeros((6, 6, 1)), (6, 1, 6))  # Conv1d or ConvTranspose1d reading
    orient_to(np.zeros((6, 6, 1)), (6, 1, 6), readings=((0, 1, 2), (0, 2, 1)))


def test_model_path_and_family_errors(tmp_path):
    """A hub id raises (the port does not download); a missing local path
    and a family no package has raise the JAX package's errors; a family
    only the JAX package has raises its "not supported" error."""
    with pytest.raises(ValueError, match="does not download"):
        putils.load_model("openai/whisper-large-v3-turbo", device="cpu")
    for path in ("./nowhere", "/nowhere/model"):
        with pytest.raises(FileNotFoundError) as ref:
            jutils.get_model_path(path)
        with pytest.raises(FileNotFoundError) as got:
            putils.get_model_path(path)
        assert str(got.value) == str(ref.value)
    (tmp_path / "foo").mkdir()
    (tmp_path / "foo" / "config.json").write_text('{"model_type": "foo_tts_x"}')
    with pytest.raises(ValueError) as ref:
        jutils.load_model(tmp_path / "foo")
    with pytest.raises(ValueError) as got:
        putils.load_model(tmp_path / "foo", device="cpu")
    assert str(got.value) == str(ref.value) == "Model type foo_tts_x not supported for stt."
    (tmp_path / "foo" / "config.json").write_text('{"model_type": "parakeet"}')
    with pytest.raises(ValueError, match="Model type parakeet not supported for stt"):
        putils.load_model(tmp_path / "foo", device="cpu")


def test_category_and_name_parts():
    for path in ("a/b/whisper-large-v3-turbo", "models--x--Qwen3-TTS", "kokoro-82m/"):
        assert putils.get_model_name_parts(path) == jutils.get_model_name_parts(path)
    for mt, parts in (("whisper", None), ("qwen3_tts", None), (None, ["kokoro", "82m"]),
                      (None, ["whisper", "tiny"]), ("csm", None)):
        assert putils.get_model_category(mt, parts) == jutils.get_model_category(mt, parts)


def test_load_model_defaults_to_the_card(tmp_path, monkeypatch):
    sio.save_file({}, tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps(dict(DIMS, model_type="whisper")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        putils.load_model(tmp_path)


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def whisper_jax(tmp_path_factory):
    """A tiny JAX Whisper (biases and norms moved off their initial
    constants) and the checkpoint directory the JAX package writes for it."""
    jm = JaxWhisper(JaxDims(**DIMS))
    rng = np.random.default_rng(0)
    flat = {}
    for k, v in jflat(jm).items():
        v = np.asarray(v)
        if k.endswith((".bias", ".weight")) and v.ndim == 1:
            v = v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
        flat[k] = v
    import jax.numpy as jnp

    jm = jload_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})
    d = tmp_path_factory.mktemp("whisper") / "whisper-tiny"
    jconvert.save_model(d, flat, dict(DIMS, model_type="whisper"))
    return jm, d


def _whisper_outputs(model, tok, audio, jax_side: bool):
    out = model.generate_chunked(audio, language="en", tokenizer=tok, temperature=0.0,
                                 sample_len=12)
    mel = np.random.default_rng(2).standard_normal((1, 3000, 80)).astype(np.float32) * 0.5
    feats = np.asarray(model.embed_audio(mel) if jax_side else
                       model.embed_audio(torch.from_numpy(mel)).float())
    tokens = np.array([[50258, 50259, 50360, 400, 1000]])
    logits = np.asarray(model.logits(tokens, feats) if jax_side else
                        model.logits(tokens, torch.from_numpy(feats)).float())
    return [s["tokens"] for s in out.segments], feats, logits


def _audio():
    t = np.arange(16000 * 4) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 1.5 * t))
            ).astype(np.float32)


def test_whisper_checkpoints_both_ways(whisper_jax, tmp_path, jax_residual):  # noqa: F811
    """The JAX package's checkpoint in both loaders, and the port's own
    (from flatten_params) in the JAX loader: identical parameters and
    tokens, encoder output and logits within 1e-5."""
    jm, d = whisper_jax
    pm = putils.load_model(d, device="cpu")
    assert isinstance(pm, Whisper) and pm.dims.model_path == str(d)
    jm2 = jutils.load_model(d)
    _same_params(pm, jm)
    _same_params(pm, jm2)
    audio = _audio()
    ref = _whisper_outputs(jm2, JaxTok(n_vocab=51866), audio, True)
    got = _whisper_outputs(pm, DummyTokenizer(n_vocab=51866), audio, False)
    assert got[0] == ref[0] and any(ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-5)
    # the port writes; the JAX package loads the same parameters
    pconvert.save_model(tmp_path / "w", flatten_params(pm), dict(DIMS, model_type="whisper"))
    _same_params(pm, jutils.load_model(tmp_path / "w"))


_TO_HF = [  # native → HF transformers names (the inverse of `_hf_to_native`)
    ("decoder.positional_embedding", "decoder.embed_positions.weight"),
    ("decoder.token_embedding.", "decoder.embed_tokens."),
    ("encoder.ln_post.", "encoder.layer_norm."), ("decoder.ln.", "decoder.layer_norm."),
    (".cross_attn.query.", ".encoder_attn.q_proj."), (".cross_attn.key.", ".encoder_attn.k_proj."),
    (".cross_attn.value.", ".encoder_attn.v_proj."),
    (".cross_attn.out.", ".encoder_attn.out_proj."),
    (".cross_attn_ln.", ".encoder_attn_layer_norm."),
    (".attn.query.", ".self_attn.q_proj."), (".attn.key.", ".self_attn.k_proj."),
    (".attn.value.", ".self_attn.v_proj."), (".attn.out.", ".self_attn.out_proj."),
    (".attn_ln.", ".self_attn_layer_norm."), (".mlp1.", ".fc1."), (".mlp2.", ".fc2."),
    (".mlp_ln.", ".final_layer_norm."),
    ("encoder.blocks.", "encoder.layers."), ("decoder.blocks.", "decoder.layers."),
]


def test_whisper_hf_layout(whisper_jax, tmp_path):
    """An HF-transformers checkpoint (model.encoder.layers.*, torch's
    (O, I, K) convolutions, the encoder's positions and proj_out present)
    loads in both packages to the same parameters."""
    jm, _ = whisper_jax
    hf = {}
    for k, v in jflat(jm).items():
        v = np.asarray(v)
        if k.endswith(("conv1.weight", "conv2.weight")):
            # contiguous: safetensors.numpy writes a strided view's buffer as it lies
            v = np.ascontiguousarray(v.transpose(0, 2, 1))
        for a, b in _TO_HF:
            k = k.replace(a, b)
        hf["model." + k] = v
    hf["model.encoder.embed_positions.weight"] = np.zeros((1500, 64), np.float32)
    hf["proj_out.weight"] = hf["model.decoder.embed_tokens.weight"]
    assert "model.decoder.layers.0.encoder_attn.q_proj.weight" in hf
    jconvert.save_model(tmp_path / "hf", hf, dict(
        model_type="whisper", d_model=64, num_mel_bins=80, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
        vocab_size=51866, max_target_positions=448, max_source_positions=1500))
    pm = putils.load_model(tmp_path / "hf", device="cpu", strict=True)
    _same_params(pm, jm)
    _same_params(pm, jutils.load_model(tmp_path / "hf"))


def test_mixed_recipe_checkpoint(whisper_jax, tmp_path):
    """A `mixed_4_6` conversion (6 bits where the path holds "embed" or
    "lm_head", 4 elsewhere, as config.json's per-path overrides say): both
    loaders quantize the same layers at the same bits, to the same words."""
    _, d = whisper_jax
    out = pconvert.convert(str(d), str(tmp_path / "q"), quantize=True, q_recipe="mixed_4_6")
    pm = putils.load_model(out, device="cpu")
    assert pm.decoder.token_embedding.bits == 6 and pm.decoder.blocks[0].mlp1.bits == 4
    # both packages row-stack Whisper's quantized self-attention q/k/v after
    # loading (the cross-attention is vetoed): the stacks compare as they
    # are, the bias-less key's zero-filled bias rows included
    theirs = _np(jflat(jutils.load_model(out)))
    assert any(".attn.qkv_fused." in k for k in theirs)
    assert not any(".cross_attn.qkv_fused." in k for k in theirs)
    for k, v in theirs.items():
        if k.endswith(".attn.qkv_fused.bias"):
            n = v.shape[0] // 3
            assert not v[n:2 * n].any()  # the key's rows
    ours = _np(flatten_params(pm))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_bf16_checkpoint_loads_as_bf16(whisper_jax, tmp_path):
    """A bfloat16 checkpoint (written by the JAX package through ml_dtypes)
    gives a bfloat16 model with the same bits; `dtype=` overrides."""
    from mlx_audio_tpu.nn.module import cast_floats as jcast

    jm, _ = whisper_jax
    jb = jcast(jm)
    jconvert.save_model(tmp_path / "b", {k: np.asarray(v) for k, v in jflat(jb).items()},
                        dict(DIMS, model_type="whisper"))
    pm = putils.load_model(tmp_path / "b", device="cpu")
    assert pm.decoder.token_embedding.weight.dtype == torch.bfloat16
    assert pm.encoder._positional_embedding.dtype == torch.bfloat16
    _same_params(pm, jb)
    pf = putils.load_model(tmp_path / "b", device="cpu", dtype=torch.float32)
    assert pf.decoder.token_embedding.weight.dtype == torch.float32


# ---------------------------------------------------------------------------
# Qwen3-TTS
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_qwen3_predicate(monkeypatch):
    """The JAX loader given the port's predicate: the layers the decode loop
    reads raw (the code predictor's embeddings and heads) stay float."""
    monkeypatch.setattr(JaxQwen, "model_quant_predicate",
                        lambda self, p, m: Qwen.model_quant_predicate(p, m))


@pytest.fixture
def jax_tokenizer():
    saved = JaxQwen._tokenizer
    JaxQwen._tokenizer = Tok()
    yield
    JaxQwen._tokenizer = saved


def _qwen_config():
    cfg = copy.deepcopy(QWEN_CFG)
    cfg["tokenizer_config"]["encoder_config"] = QWEN_ENCODER
    return dict(cfg, model_type="qwen3_tts")


@pytest.fixture(scope="module")
def qwen_jax(tmp_path_factory):
    cfg = JaxQwenConfig.from_dict(QWEN_CFG)
    cfg.tokenizer_config.encoder_config = None
    jm = _moved(JaxQwen(cfg), np.random.default_rng(0))
    d = tmp_path_factory.mktemp("qwen") / "qwen3-tts-tiny"
    jconvert.save_model(d, {k: np.asarray(v) for k, v in jflat(jm).items()}, _qwen_config())
    (d / "generation_config.json").write_text('{"temperature": 0.9, "top_k": 50}')
    return jm, d


_NOT_BUILT = ("speech_tokenizer.encoder.", "speaker_encoder.")


def test_qwen3_checkpoints_both_ways(qwen_jax, tmp_path, jax_tokenizer):
    """f32: the JAX checkpoint in both loaders (identical parameters, the
    generation config read by both post_load_hooks), greedy codes
    identical and audio within 1e-4; the port's checkpoint in the JAX
    loader."""
    jm, d = qwen_jax
    pm = putils.load_model(d, device="cpu")
    jm2 = jutils.load_model(d)
    _same_params(pm, jm2, skip=_NOT_BUILT)
    assert pm.generate_config == jm2.generate_config == {"temperature": 0.9, "top_k": 50}
    assert pm.config.model_path == jm2.config.model_path == str(d)
    pm.set_runtime(tokenizer=Tok())
    (pcodes,), (pres,) = _codes(pm)
    (jcodes,), (jres,) = _codes(jm2)
    np.testing.assert_array_equal(pcodes, jcodes)
    np.testing.assert_allclose(pres.audio, np.asarray(jres.audio), rtol=0, atol=1e-4)
    pconvert.save_model(tmp_path / "p", flatten_params(pm), _qwen_config())
    _same_params(pm, jutils.load_model(tmp_path / "p"), skip=_NOT_BUILT)


def test_qwen3_int4_checkpoint(qwen_jax, tmp_path, jax_qwen3_predicate, jax_tokenizer):
    """The port's `convert` to 4 bits with `checkpoint_quant_predicate`: the
    JAX convert with the same predicate writes the same files; both loaders
    quantize exactly the talker's and the code predictor's layers and
    row-stack them; greedy codes identical, audio within 1e-4."""
    _, d = qwen_jax
    out = pconvert.convert(str(d), str(tmp_path / "p4"), quantize=True,
                           q_recipe=checkpoint_quant_predicate)
    ref = jconvert.convert(str(d), str(tmp_path / "j4"), quantize=True,
                           q_recipe=checkpoint_quant_predicate)
    assert (out / "model.safetensors").read_bytes() == (ref / "model.safetensors").read_bytes()
    assert json.loads((out / "config.json").read_text()) == \
        json.loads((ref / "config.json").read_text())
    weights = st_load(str(out / "model.safetensors"))
    quantized = sorted(k[: -len(".scales")] for k in weights if k.endswith(".scales"))
    assert quantized and all(Qwen.model_quant_predicate(k) for k in quantized)
    assert not any("lm_head" in k or "codec_embedding" in k or "speech_tokenizer" in k
                   for k in quantized)
    pm = putils.load_model(out, device="cpu")
    jm = jutils.load_model(out)
    attn = pm.talker.model.layers[0].self_attn
    assert type(attn.qkv_fused).__name__ == "QuantizedFusedLinear"
    assert type(pm.talker.code_predictor.lm_head[0]).__name__ == "Linear"
    pm.set_runtime(tokenizer=Tok())
    (pcodes,), (pres,) = _codes(pm)
    (jcodes,), (jres,) = _codes(jm)
    np.testing.assert_array_equal(pcodes, jcodes)
    np.testing.assert_allclose(pres.audio, np.asarray(jres.audio), rtol=0, atol=1e-4)


def test_jax_convert_quantizes_what_its_loader_declines(qwen_jax, tmp_path):
    """The fault of the reference (ROADMAP Queue 3): the JAX package's
    `convert(quantize=True)` quantizes every 2-D weight it can, including
    the codec's, which its loader's predicate declines, so the `.scales`
    are unknown keys. The port's own predicate writes a checkpoint both
    load (above); the port's loader rejects the JAX one the same way."""
    _, d = qwen_jax
    out = jconvert.convert(str(d), str(tmp_path / "j4"), quantize=True)
    with pytest.raises(ValueError, match="Checkpoint keys not found in model"):
        from mlx_audio_tpu.tts.utils import load_model as jload_tts

        jload_tts(out)
    with pytest.raises(ValueError, match="Checkpoint keys not found in model"):
        putils.load_model(out, device="cpu")


# ---------------------------------------------------------------------------
# Kokoro (module-scoped JAX model: its constructor compiles one draw per shape)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kokoro_jax(tmp_path_factory, small_buckets):
    jm = jkok.Model(jkok.ModelConfig.from_dict(TINY))
    d = tmp_path_factory.mktemp("kokoro") / "kokoro-tiny"
    jconvert.save_model(d, {k: np.asarray(v) for k, v in jflat(jm).items()},
                        dict(TINY, model_type="kokoro"))
    return jm, d


def _voice(d, name="af_test"):
    (d / "voices").mkdir(exist_ok=True)
    pack = (np.random.default_rng(1).standard_normal((510, 1, 64)) * 0.1).astype(np.float32)
    st_save({"voice": pack}, str(d / "voices" / f"{name}.safetensors"))
    return pack


def test_kokoro_checkpoints(kokoro_jax, tmp_path, exact_first_frame):
    """The JAX checkpoint, and the same model written in the upstream torch
    layout by the port (weight_g / weight_v, nn.LSTM names, gamma / beta,
    position_ids), in both loaders: identical parameters (within one
    float32 ulp where the weight norm folds) and audio within 2 int16
    steps; the port's JAX-layout checkpoint in the JAX loader."""
    jm, d = kokoro_jax
    pm = putils.load_model(d, device="cpu")
    _same_params(pm, jm)
    _same_params(pm, jutils.load_model(d))
    ref_s = (np.random.default_rng(3).standard_normal((1, 64)) * 0.1).astype(np.float32)
    ref = jm(PHONEMES, ref_s, return_output=True)
    out = pm(PHONEMES, ref_s, return_output=True, noise=model_noise(pm, ref.pred_dur))
    np.testing.assert_array_equal(out.pred_dur, ref.pred_dur)
    np.testing.assert_allclose(out.audio, ref.audio, rtol=0, atol=2 * LSB)

    upstream = torch_checkpoint(pm)
    assert any(k.endswith("weight_g") for k in upstream)
    assert any(k.endswith("weight_ih_l0_reverse") for k in upstream)
    assert any(k.endswith(".gamma") for k in upstream)
    pconvert.save_model(tmp_path / "t", upstream, dict(TINY, model_type="kokoro"))
    pt, jt = putils.load_model(tmp_path / "t", device="cpu"), jutils.load_model(tmp_path / "t")
    ours, theirs, orig = _np(flatten_params(pt)), _np(jflat(jt)), _np(jflat(jm))
    assert sorted(ours) == sorted(theirs) == sorted(orig)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        np.testing.assert_allclose(ours[k], orig[k], rtol=2e-7, atol=0, err_msg=k)
    got = pt(PHONEMES, ref_s, return_output=True, noise=model_noise(pt, ref.pred_dur))
    np.testing.assert_allclose(got.audio, ref.audio, rtol=0, atol=2 * LSB)

    pconvert.save_model(tmp_path / "p", flatten_params(pm), dict(TINY, model_type="kokoro"))
    _same_params(pm, jutils.load_model(tmp_path / "p"))


def test_kokoro_voice_pack_without_the_library(kokoro_jax, tmp_path, monkeypatch):
    """A .safetensors voice pack under the checkpoint's voices/ loads through
    the port's reader (the array of safetensors.numpy, and of the JAX
    pipeline); a voice that is not there raises instead of downloading."""
    _, d = kokoro_jax
    lexicon = tmp_path / "lexicon.json"  # the G2P fallback's, without nltk
    lexicon.write_text('{"hello": "həlˈO"}', encoding="utf-8")
    monkeypatch.setenv("MLX_AUDIO_TPU_LEXICON", str(lexicon))
    pack = _voice(d)
    np.testing.assert_array_equal(
        load_voice_tensor(str(d / "voices" / "af_test.safetensors")),
        st_load(str(d / "voices" / "af_test.safetensors"))["voice"])
    pm = putils.load_model(d, device="cpu")
    assert pm.config.model_path == str(d)
    pipe = pm._get_pipeline("a")
    np.testing.assert_array_equal(pipe.load_single_voice("af_test"), pack)
    from mlx_audio_tpu.tts.models.kokoro.pipeline import load_voice_tensor as jvoice

    np.testing.assert_array_equal(pipe.load_voice("af_test"),
                                  jvoice(str(d / "voices" / "af_test.safetensors")))
    with pytest.raises(ValueError, match="does not download"):
        pipe.load_single_voice("bf_missing")

