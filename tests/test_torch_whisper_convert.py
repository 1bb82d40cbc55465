"""The port's Whisper `.pt` converter, its fused quantized q/k/v and the
audio player, against the JAX package's.

- A seeded OpenAI-layout `.pt` (written with `torch.save`) through both
  packages' `convert`: config.json and the safetensors identical byte for
  byte, in each output dtype.
- `decode_alignment_heads` on every `_ALIGNMENT_HEADS` entry at its
  model's decoder shape.
- A quantized tiny Whisper loaded from a directory row-stacks q/k/v on its
  self-attention only (the cross-attention is vetoed), as the JAX package
  does, and gives the JAX package's greedy tokens.
- The audio player's buffering with `sounddevice` absent, as the JAX
  package's, and `--play`'s clean refusal.
"""

import json
import sys

import numpy as np
import pytest
import torch

from mlx_audio_tpu import utils as jutils
from mlx_audio_tpu.stt.models.whisper import convert as jwc
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu.tts import audio_player as jplayer
from mlx_audio_tpu_torch import convert as pconvert
from mlx_audio_tpu_torch import utils as putils
from mlx_audio_tpu_torch.stt.models.whisper import convert as pwc
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer
from mlx_audio_tpu_torch.stt.models.whisper.whisper import MultiHeadAttention
from mlx_audio_tpu_torch.tts import audio_player as pplayer
from mlx_audio_tpu_torch.nn import flatten_params
from mlx_audio_tpu_torch.stt.models.whisper import Model as Whisper
from test_torch_whisper import DIMS
from test_torch_whisper import jax_residual  # noqa: F401  (a fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tiny's decoder shape (4 layers, 6 heads), so the file name's alignment
# heads apply; narrow widths
TINY = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=24, n_audio_head=6, n_audio_layer=1,
            n_vocab=120, n_text_ctx=24, n_text_state=24, n_text_head=6, n_text_layer=4)


def _openai_pt(path, dims, seed=0):
    """An OpenAI release-format checkpoint: {dims, model_state_dict}, torch
    conv layout (O, I, K), the encoder's sinusoids as a buffer."""
    g = torch.Generator().manual_seed(seed)
    sd = {"encoder.conv1.weight": (dims["n_audio_state"], dims["n_mels"], 3),
          "encoder.conv1.bias": (dims["n_audio_state"],),
          "encoder.conv2.weight": (dims["n_audio_state"], dims["n_audio_state"], 3),
          "encoder.conv2.bias": (dims["n_audio_state"],),
          "encoder.positional_embedding": (dims["n_audio_ctx"], dims["n_audio_state"]),
          "decoder.token_embedding.weight": (dims["n_vocab"], dims["n_text_state"]),
          "decoder.positional_embedding": (dims["n_text_ctx"], dims["n_text_state"])}
    for side, n, width in (("encoder", dims["n_audio_layer"], dims["n_audio_state"]),
                           ("decoder", dims["n_text_layer"], dims["n_text_state"])):
        for i in range(n):
            b = f"{side}.blocks.{i}."
            attns = ["attn"] + (["cross_attn"] if side == "decoder" else [])
            for a in attns:
                for p in ("query", "key", "value", "out"):
                    sd[f"{b}{a}.{p}.weight"] = (width, width)
                    if p != "key":
                        sd[f"{b}{a}.{p}.bias"] = (width,)
                sd[f"{b}{a}_ln.weight"] = sd[f"{b}{a}_ln.bias"] = (width,)
            sd[f"{b}mlp.0.weight"], sd[f"{b}mlp.0.bias"] = (4 * width, width), (4 * width,)
            sd[f"{b}mlp.2.weight"], sd[f"{b}mlp.2.bias"] = (width, 4 * width), (width,)
            sd[f"{b}mlp_ln.weight"] = sd[f"{b}mlp_ln.bias"] = (width,)
    sd["encoder.ln_post.weight"] = sd["encoder.ln_post.bias"] = (dims["n_audio_state"],)
    sd["decoder.ln.weight"] = sd["decoder.ln.bias"] = (dims["n_text_state"],)
    state = {k: torch.randn(*shape, generator=g) * 0.1 for k, shape in sd.items()}
    state["decoder.token_embedding.weight"][0, 0] = 1e-8  # rounds in half precision
    torch.save({"dims": dims, "model_state_dict": state}, path)
    return path


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_convert_writes_the_jax_packages_files(tmp_path, dtype):
    pt = _openai_pt(tmp_path / "tiny.pt", TINY)
    jout = jwc.convert(str(pt), str(tmp_path / "jax"), dtype=dtype)
    pout = pwc.convert(str(pt), str(tmp_path / "port"), dtype=dtype)
    assert sorted(p.name for p in pout.iterdir()) == sorted(p.name for p in jout.iterdir())
    for p in jout.iterdir():
        assert (pout / p.name).read_bytes() == p.read_bytes(), p.name
    cfg = json.loads((pout / "config.json").read_text())
    assert cfg["alignment_heads"] == pwc.decode_alignment_heads(
        pwc._ALIGNMENT_HEADS["tiny"], 4, 6) and cfg["model_type"] == "whisper"
    if dtype == "float32":  # and the port loads what it wrote
        model = putils.load_model(pout, device="cpu")
        assert model.dims.n_text_layer == 4


def test_jax_loader_declines_its_converted_release_names(tmp_path):
    """A fault of the reference: both converters keep the release's MLP
    names (`mlp.0`, `mlp.2`), which the JAX package's Whisper `sanitize`
    does not map, so it cannot load what its own converter wrote; the
    port's `sanitize` maps them and loads the same files."""
    pt = _openai_pt(tmp_path / "tiny.pt", TINY)
    out = jwc.convert(str(pt), str(tmp_path / "jax"))
    with pytest.raises(ValueError, match=r"mlp\.0"):
        jutils.load_model(out)
    model = putils.load_model(out, device="cpu")
    state = torch.load(pt, weights_only=True)["model_state_dict"]
    torch.testing.assert_close(model.decoder.blocks[0].mlp1.weight,
                               state["decoder.blocks.0.mlp.0.weight"], rtol=0, atol=0)


def test_convert_cli_and_refusals(tmp_path, capsys):
    pt = _openai_pt(tmp_path / "custom.pt", dict(TINY, n_text_layer=1))
    pwc.main(["--torch-ckpt", str(pt), "--output-dir", str(tmp_path / "out")])
    cfg = json.loads((tmp_path / "out" / "config.json").read_text())
    assert "alignment_heads" not in cfg and "converted" in capsys.readouterr().out
    # a file named after a variant whose decoder it does not have: no heads
    pwc.convert(str(_openai_pt(tmp_path / "base.pt", TINY)), str(tmp_path / "b"))
    assert "alignment_heads" not in json.loads((tmp_path / "b" / "config.json").read_text())
    with pytest.raises(ValueError, match="downloads nothing"):
        pwc.convert("large-v3-turbo", str(tmp_path / "x"))
    torch.save({"model_state_dict": {}}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="not an OpenAI whisper checkpoint"):
        pwc.convert(str(tmp_path / "bad.pt"), str(tmp_path / "y"))
    assert pwc.available_models() == jwc.available_models()


# (n_text_layer, n_text_head) of each official model
_DECODERS = {"tiny": (4, 6), "base": (6, 8), "small": (12, 12), "medium": (24, 16),
             "large-v1": (32, 20), "large-v2": (32, 20), "large-v3": (32, 20),
             "large": (32, 20), "large-v3-turbo": (4, 20), "turbo": (4, 20)}


@pytest.mark.parametrize("name", sorted(jwc._ALIGNMENT_HEADS))
def test_decode_alignment_heads_matches_jax(name):
    layers, heads = _DECODERS[name.removesuffix(".en")]
    dump = jwc._ALIGNMENT_HEADS[name]
    assert pwc._ALIGNMENT_HEADS[name] == dump and pwc._MODELS[name] == jwc._MODELS[name]
    got = pwc.decode_alignment_heads(dump, layers, heads)
    assert got == jwc.decode_alignment_heads(dump, layers, heads) and got
    assert all(0 <= l < layers and 0 <= h < heads for l, h in got)


# ---------------------------------------------------------------------------
# fused q/k/v on a quantized Whisper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_q4(tmp_path_factory):
    """A tiny Whisper from seeded torch weights (independent of the JAX
    package's shared init counter), its biases and norms moved off their
    initial constants, converted to int4 in groups of 32."""
    root = tmp_path_factory.mktemp("whisper_q4")
    rng = np.random.default_rng(0)
    flat = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
                if k.endswith((".bias", ".weight")) and v.ndim == 1 else v)
            for k, v in flatten_params(Whisper(DIMS, device="cpu", seed=3)).items()}
    pconvert.save_model(root / "f32", flat, dict(DIMS, model_type="whisper"))
    return pconvert.convert(str(root / "f32"), str(root / "q4"), quantize=True, q_bits=4,
                            q_group_size=32)


@pytest.fixture
def jax_float_caches(monkeypatch):
    """The JAX package's decoder KV caches in the compute dtype: it takes
    the token embedding's dtype, which a quantized embedding makes uint32
    (a fault of the reference, ROADMAP Queue 3; the port takes the float
    positional embedding's)."""
    from mlx_audio_tpu.lm.cache import KVCache
    from mlx_audio_tpu.stt.models.whisper.whisper import Model as JaxModel

    def make_caches(self, batch=1, capacity=None):
        d = self.dims
        cap = d.n_text_ctx if capacity is None else min(capacity, d.n_text_ctx)
        return [KVCache(batch, d.n_text_head, cap, d.n_text_state // d.n_text_head,
                        dtype=self.decoder.positional_embedding.dtype)
                for _ in range(d.n_text_layer)]

    monkeypatch.setattr(JaxModel, "_make_caches", make_caches)


def test_quantized_caches_hold_floats(tiny_q4):
    """A quantized Whisper's KV caches hold its compute dtype in the port;
    the JAX package's hold its embedding's packed words (uint32), which
    truncate every cached key and value to an integer."""
    pm = putils.load_model(tiny_q4, device="cpu")
    jm = jutils.load_model(tiny_q4)
    assert all(c.k.dtype == torch.float32 for c in pm._make_caches(1, 64))
    assert str(jm._make_caches(1, 64)[0].k.dtype) == "uint32"


def test_quantized_whisper_fuses_self_attention_only(tiny_q4, jax_residual,
                                                     jax_float_caches):
    out = tiny_q4
    pm = putils.load_model(out, device="cpu")
    jm = jutils.load_model(out)
    attns = [m for m in pm.modules() if isinstance(m, MultiHeadAttention)]
    fused = [m for m in attns if hasattr(m, "qkv_fused")]
    crosses = [b.cross_attn for b in pm.decoder.blocks]
    assert len(fused) == len(attns) - len(crosses) > 0
    for m in crosses:
        assert not hasattr(m, "qkv_fused") and hasattr(m, "query")
    for m in fused:
        assert not any(hasattr(m, n) for n in ("query", "key", "value"))
        assert m.qkv_fused.split_sizes == (pm.dims.n_text_state,) * 3 or \
            m.qkv_fused.split_sizes == (pm.dims.n_audio_state,) * 3
    for jb, pb in zip(jm.decoder.blocks, pm.decoder.blocks):
        assert hasattr(jb.attn, "qkv_fused") and not hasattr(jb.cross_attn, "qkv_fused")
        assert hasattr(pb.attn, "qkv_fused")
    audio = (np.random.default_rng(4).standard_normal(16000 * 40) * 0.1).astype(np.float32)
    for no_ts in (False, True):
        kw = dict(language="en", temperature=0.0, sample_len=12, without_timestamps=no_ts)
        got = pm.generate_chunked(audio, tokenizer=DummyTokenizer(n_vocab=pm.dims.n_vocab),
                                  **kw)
        want = jm.generate_chunked(audio, tokenizer=JaxTok(n_vocab=pm.dims.n_vocab), **kw)
        assert [s["tokens"] for s in got.segments] == [s["tokens"] for s in want.segments]
    assert got.segments and got.segments[0]["tokens"]


def test_fused_attention_equals_the_three_projections(tiny_q4, monkeypatch):
    """The fused branch computes what the three quantized projections do:
    the same checkpoint loaded with and without the post-load row-stack."""
    from mlx_audio_tpu_torch.nn import quantized as nnq

    out = tiny_q4
    fused = putils.load_model(out, device="cpu")
    monkeypatch.setattr(nnq, "fuse_quantized_projections", lambda model: 0)
    unfused = putils.load_model(out, device="cpu")
    assert not any(hasattr(m, "qkv_fused") for m in unfused.modules())
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3000, 80)).astype(
        np.float32))
    tokens = torch.tensor([[50258, 50259, 50360, 400, 1000]])
    with torch.inference_mode():
        a, b = fused.embed_audio(mel), unfused.embed_audio(mel)
        la, lb = fused.logits(tokens, a), unfused.logits(tokens, b)
    # the same float32 products, summed by one GEMM of N = 3D or three of D
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    torch.testing.assert_close(la, lb, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the audio player
# ---------------------------------------------------------------------------


@pytest.fixture
def no_sounddevice(monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", None)


def test_audio_player_buffering_matches_jax(no_sounddevice):
    for mod in (jplayer, pplayer):
        p = mod.AudioPlayer(sample_rate=1000)
        p.queue_audio(np.ones(500, np.float32))
        assert p.playing is False  # sounddevice absent: buffering only
        p.queue_audio(np.full(250, 0.5, np.float32))
        assert p._buffered_seconds() == 0.75 and not p.drained.is_set()
        out = p.flush()
        assert len(out) == 750 and out[-1] == 0.5 and p.wait_for_drain(0.1)
        # the device callback drains what is buffered and pads with silence
        p.queue_audio(np.arange(6, dtype=np.float32))
        buf = np.full((4, 1), -1.0, np.float32)
        p._callback(buf, 4, None, None)
        assert buf[:, 0].tolist() == [0, 1, 2, 3]
        p._callback(buf, 4, None, None)
        assert buf[:, 0].tolist() == [4, 5, 0, 0] and p.drained.is_set()
        p.stop()


def test_play_refuses_cleanly_without_sounddevice(no_sounddevice):
    with pytest.raises(RuntimeError, match="sounddevice"):
        pplayer.check_output_device()
