"""The port's Whisper (mlx_audio_tpu_torch) against the JAX package's, on one
set of weights carried across by load_jax_params.

A tiny model at the published vocabulary (n_vocab 51866, so DummyTokenizer's
special ids exist): n_mels 80, width 64, 2 heads, 2 encoder and 2 decoder
layers. f32 bar 1e-4 for activations and logits: the two packages run the
same float32 math with other summation orders (the port's mel takes an FFT
where the JAX package multiplies by a DFT matrix), which leaves ~1e-6.
Greedy tokens and text must be identical.

`jax_residual` gives the JAX package's two score-capturing decoder passes
(`TextDecoder.step_with_qk`, `forward_with_cross_qk`) the cross-attention
residual that they drop, so that they compute what the decoder's own forward
does; the port's versions add it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu.stt.models.whisper import Model as JaxModel
from mlx_audio_tpu.stt.models.whisper import ModelDimensions as JaxDims
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu_torch import audio_io
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.module import jax_param_shapes
from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer
from mlx_audio_tpu_torch.utils import load_audio

ATOL = 1e-4
DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
            n_audio_layer=2, n_vocab=51866, n_text_ctx=448, n_text_state=64,
            n_text_head=2, n_text_layer=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's ops are too small to share out: one intra-op
    thread per test process keeps parallel test workers from contending for
    the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(JaxDims(**DIMS))
    rng = np.random.default_rng(0)
    flat = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v)
        if k.endswith(".bias") or "_ln." in k or k.endswith("ln_post.weight") \
                or k.endswith("decoder.ln.weight"):
            # biases start at zero and norms at one: move them so the
            # parity covers every parameter
            v = v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
        flat[k] = v
    from mlx_audio_tpu.nn.module import load_weights

    jm = load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})
    pm = Model(ModelDimensions(**DIMS), device="cpu")
    load_jax_params(pm, flat)
    return jm, pm


def _jax_cross_block(blk, x, kv):
    c, qk = blk.cross_attn.call_with_qk(blk.cross_attn_ln(x), kv)
    x = x + c
    return x + blk.mlp2(jax.nn.gelu(blk.mlp1(blk.mlp_ln(x)), approximate=False)), qk


def _jax_step_with_qk(self, tokens, pos0, caches, cross_kv):
    B, t = tokens.shape
    x = self.token_embedding(tokens)
    x = x + self.positional_embedding[pos0 + jnp.arange(t)].astype(x.dtype)
    mask = caches[0].attention_mask(t) if caches is not None else None
    new_caches, qks = [], []
    for i, blk in enumerate(self.blocks):
        a, nc = blk.attn(blk.attn_ln(x), mask=mask,
                         cache=caches[i] if caches is not None else None)
        new_caches.append(nc)
        x, qk = _jax_cross_block(blk, x + a, cross_kv[i])
        qks.append(qk)
    return self.token_embedding.as_linear(self.ln(x)), new_caches, qks


def _jax_forward_with_cross_qk(self, tokens, cross_kv):
    from mlx_audio_tpu.ops.attention import make_causal_mask

    B, t = tokens.shape
    x = self.token_embedding(tokens)
    x = x + self.positional_embedding[jnp.arange(t)].astype(x.dtype)
    mask = make_causal_mask(t, t) if t > 1 else None
    qks = []
    for i, blk in enumerate(self.blocks):
        a, _ = blk.attn(blk.attn_ln(x), mask=mask)
        x, qk = _jax_cross_block(blk, x + a, cross_kv[i])
        qks.append(qk)
    return self.token_embedding.as_linear(self.ln(x)), qks


@pytest.fixture(scope="module")
def jax_residual():
    """The JAX package's score-capturing passes with the cross-attention
    residual put back, for the requesting module; jit caches are cleared on
    the way in and out, so no trace of the other version is reused."""
    from mlx_audio_tpu.stt.models.whisper.whisper import TextDecoder

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TextDecoder, "step_with_qk", _jax_step_with_qk)
        mp.setattr(TextDecoder, "forward_with_cross_qk", _jax_forward_with_cross_qk)
        jax.clear_caches()
        yield
    jax.clear_caches()


def _mel(rng, b=1):
    return rng.standard_normal((b, 3000, 80)).astype(np.float32)


def test_encoder_and_cross_kv(pair):
    jm, pm = pair
    mel = _mel(np.random.default_rng(1), b=2)
    jxa, jkv = JaxModel._encode(jm, jnp.asarray(mel))
    xa, kv = pm._encode(torch.from_numpy(mel))
    assert tuple(xa.shape) == (2, 1500, 64)
    np.testing.assert_allclose(xa.numpy(), np.asarray(jxa), atol=ATOL)
    for (k, v), (jk, jv) in zip(kv, jkv):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)


def test_decoder_logits_through_kv_cache(pair):
    """Prefill of a 4-token prompt, then three single-token steps."""
    jm, pm = pair
    rng = np.random.default_rng(2)
    mel = _mel(rng, b=2)
    _, jkv = JaxModel._encode(jm, jnp.asarray(mel))
    _, kv = pm._encode(torch.from_numpy(mel))
    jcaches = jm._make_caches(2, 64)
    caches = pm._make_caches(2, 64)
    prompt = rng.integers(0, 50000, (2, 4))
    steps = [prompt] + [rng.integers(0, 50000, (2, 1)) for _ in range(3)]
    pos = 0
    for toks in steps:
        jl, jcaches = JaxModel._decoder_step(jm, jnp.asarray(toks, jnp.int32), pos,
                                             jcaches, jkv)
        pl, caches = Model._decoder_step(pm, torch.from_numpy(toks), pos, caches, kv)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
        pos += toks.shape[1]
    assert caches[0].pos == int(jcaches[0].pos) == 7


@pytest.fixture(scope="module")
def audio():
    # about 70 s: three 30 s windows
    return (np.random.default_rng(3).standard_normal(16000 * 70) * 0.05).astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [dict(without_timestamps=True), dict(without_timestamps=False),
     dict(without_timestamps=True, condition_on_previous_text=True)],
    ids=["no_timestamps", "timestamps", "conditioned"],
)
def test_generate_chunked_matches_jax(pair, audio, kw):
    jm, pm = pair
    common = dict(language="en", temperature=0.0, sample_len=16, **kw)
    ref = jm.generate_chunked(audio, tokenizer=JaxTok(n_vocab=51866), **common)
    out = pm.generate_chunked(audio, tokenizer=DummyTokenizer(n_vocab=51866), **common)
    assert len(out.segments) == len(ref.segments) == 3
    assert out.text == ref.text
    assert out.extra["mode"] == ref.extra["mode"]
    if kw.get("condition_on_previous_text"):
        assert out.extra["sweeps"] == ref.extra["sweeps"]
    for s, r in zip(out.segments, ref.segments):
        assert s["tokens"] == r["tokens"]
        assert s["text"] == r["text"]
        assert (s["seek"], s["start"], s["end"]) == (r["seek"], r["start"], r["end"])
        assert abs(s["avg_logprob"] - r["avg_logprob"]) < ATOL
        assert abs(s["no_speech_prob"] - r["no_speech_prob"]) < ATOL


def test_generate_chunked_takes_punctuation_options(pair, audio):
    """`prepend_punctuations` and `append_punctuations` are accepted with
    word_timestamps=False, as in the JAX package, and change no token."""
    jm, pm = pair
    clip = audio[:16000 * 20]
    common = dict(language="en", temperature=0.0, sample_len=8, without_timestamps=True)
    punct = dict(prepend_punctuations="\"'(", append_punctuations="\"'.,!?)")
    ref = jm.generate_chunked(clip, tokenizer=JaxTok(n_vocab=51866), word_timestamps=False,
                              **punct, **common)
    tok = DummyTokenizer(n_vocab=51866)
    out = pm.generate_chunked(clip, tokenizer=tok, word_timestamps=False, **punct, **common)
    plain = pm.generate_chunked(clip, tokenizer=tok, **common)
    tokens = [s["tokens"] for s in out.segments]
    assert tokens == [s["tokens"] for s in plain.segments] == [s["tokens"] for s in ref.segments]
    assert len(tokens) == 1 and tokens[0]


def test_sanitize_matches_jax_on_hf_names(pair):
    """An HF-named dict: both packages drop the encoder positions and
    proj_out, rename alike and turn torch's (O, I, K) conv weights into the
    JAX package's (O, K, I), the layout `nn.load_weights` takes; a weight
    whose shape fits both layouts raises."""
    jm, pm = pair
    rng = np.random.default_rng(4)
    hf = {
        "model.encoder.conv1.weight": rng.standard_normal((64, 80, 3)),
        "model.encoder.conv2.weight": rng.standard_normal((64, 64, 3)),
        "model.encoder.embed_positions.weight": rng.standard_normal((1500, 64)),
        "model.encoder.layers.0.self_attn.q_proj.weight": rng.standard_normal((64, 64)),
        "model.encoder.layers.0.fc1.bias": rng.standard_normal(256),
        "model.encoder.layer_norm.weight": rng.standard_normal(64),
        "model.decoder.embed_tokens.weight": rng.standard_normal((51866, 64)),
        "model.decoder.embed_positions.weight": rng.standard_normal((448, 64)),
        "model.decoder.layers.1.encoder_attn.k_proj.weight": rng.standard_normal((64, 64)),
        "model.decoder.layers.1.encoder_attn_layer_norm.bias": rng.standard_normal(64),
        "model.decoder.layer_norm.bias": rng.standard_normal(64),
        "proj_out.weight": rng.standard_normal((51866, 64)),
    }
    ours = pm.sanitize(dict(hf))
    theirs = jm.sanitize(dict(hf))
    assert sorted(ours) == sorted(theirs)
    assert "encoder.positional_embedding" not in ours and "proj_out.weight" not in ours
    shapes = jax_param_shapes(pm)
    for k, v in ours.items():
        assert tuple(np.shape(v)) == shapes[k], k
        np.testing.assert_array_equal(np.asarray(v), np.asarray(theirs[k]))
    # already (O, K, I): kept, as the JAX package keeps it
    mlx = {"encoder.conv1.weight": np.zeros((64, 3, 80))}
    assert pm.sanitize(mlx)["encoder.conv1.weight"].shape == (64, 3, 80)
    with pytest.raises(ValueError, match="cannot be told"):
        pm.sanitize({"encoder.conv1.weight": np.zeros((64, 3, 3))})


@pytest.mark.parametrize("entry", ["generate", "generate_chunked", "generate_streaming"])
def test_audio_path_raises(pair, tmp_path, entry):
    """A path (str or Path) no longer raises: every entry point reads it
    through utils.load_audio at 16 kHz mono, as the JAX package's do, and
    gives what it gives on the waveform read so (a 44.1 kHz stereo file)."""
    _, pm = pair
    tok = DummyTokenizer(n_vocab=51866)
    rng = np.random.default_rng(7)
    audio_io.write(tmp_path / "a.wav", rng.uniform(-0.3, 0.3, (44100 * 3, 2)), 44100)
    wave = load_audio(tmp_path / "a.wav", sample_rate=16000)

    def run(audio):
        out = getattr(pm, entry)(audio, language="en", tokenizer=tok)
        if entry == "generate_streaming":
            return [(r.tokens, r.is_final) for r in out]
        return [s["tokens"] for s in out.segments]

    want = run(wave)
    for path in (str(tmp_path / "a.wav"), tmp_path / "a.wav"):
        assert run(path) == want


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(ModelDimensions(**DIMS))
