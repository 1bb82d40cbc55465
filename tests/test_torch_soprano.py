"""Soprano in the port against the JAX package on the CPU at tiny widths: the
decoder (4x linear upsampling with aligned corners, the Vocos backbone, the
ISTFT head), the hidden-state decode loop and `generate` end to end, the
decoder-width rule, `sanitize` and loading by `utils.load_model`.

The seeded weights plant a greedy path (`chip_smoke.plant_outetts`, on the
tied Qwen3 LM): [START] leads through PATH_LEN tokens to [STOP], so both
packages' loops stop at the same step; the tokenizer.json is
`chip_smoke.write_tokenizer_json(style="soprano")`'s, read by the port's
reader and by `transformers` for the JAX side. float32 bar: 1e-5 of each
output's peak (hidden states and waveforms); greedy tokens and their count
must be identical."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mlx_audio_tpu.nn.module import load_weights
from mlx_audio_tpu.tts.models.soprano import soprano as js
from mlx_audio_tpu_torch.nn import flatten_params as pflat
from mlx_audio_tpu_torch.tokenizer_json import load as load_tok
from mlx_audio_tpu_torch.tts.models.soprano import soprano as ps

from test_torch_vocos import _close
from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

BASE_VOCAB = 300
DECODER = dict(decoder_num_layers=2, decoder_dim=32, decoder_intermediate_dim=48,
               hop_length=16, n_fft=64, upscale=4, input_kernel=1, dw_kernel=3)
CFG = dict(model_type="qwen3", hidden_size=128, num_hidden_layers=2, intermediate_size=256,
           num_attention_heads=4, num_key_value_heads=2, head_dim=32,
           vocab_size=BASE_VOCAB + len(cs.SOPRANO_ADDED), tie_word_embeddings=True,
           decoder_config=DECODER, model_path="soprano-1.1-tiny")
PATH_LEN = 9
TEXT = "Hello world. The fox jumps!"


def planted_path(tok, n: int = PATH_LEN, seed: int = 0) -> list:
    """n distinct ordinary tokens after [START], then [STOP]."""
    rng = np.random.default_rng(seed)
    body = [int(t) for t in rng.permutation(np.arange(120, 260))[:n]]
    return [tok.token_to_id("[START]")] + body + [tok.token_to_id("[STOP]")]


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    """(the port's reader, `transformers` on the same file, its directory
    with a tokenizer_config.json naming the eos)."""
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("soprano-tok")
    path = cs.write_tokenizer_json(d, "soprano", n_merges=40, base=BASE_VOCAB)
    (d / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<|endoftext|>"}))
    hf = PreTrainedTokenizerFast(tokenizer_file=str(path), eos_token="<|endoftext|>")
    return load_tok(path), hf, d


@pytest.fixture(scope="module")
def pair(toks):
    """(JAX model, port model, the planted path) on the same weights; each
    package's tokenizer set on its class (reset after the module)."""
    tok, hf, d = toks
    path = planted_path(tok)
    pm = ps.Model(CFG, device="cpu", seed=3)
    pm.config.model_path = str(d)
    cs.plant_outetts(pm.language_model, dict(zip(path, path[1:])))
    rng = np.random.default_rng(4)
    with torch.no_grad():  # the decoder's constant parameters moved
        for name, p in pm.decoder.named_parameters():
            if name.endswith(("bias", "gamma")) or "norm" in name:
                p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.1)
    with numpy_init():
        jm = js.Model(dict(CFG))
    jm = load_weights(jm, {k: jnp.asarray(np.asarray(v)) for k, v in pflat(pm).items()})
    js.Model._tokenizer = hf
    yield jm, pm, path
    js.Model._tokenizer = None


def test_decoder_width_rule():
    assert ps.ModelConfig(model_path="/x/Soprano-80M").decoder_config.decoder_dim == 512
    cfg = ps.ModelConfig(model_path="/x/soprano-1.1-80m")
    assert (cfg.decoder_config.decoder_dim, cfg.decoder_config.input_kernel) == (768, 1)
    assert ps.ModelConfig().decoder_config.decoder_intermediate_dim == 2304


@pytest.mark.parametrize("length", [1, 2, 7])
def test_decoder(pair, length):
    """Hidden states (1, L, D) → waveform; L = 1 upsamples to itself."""
    jm, pm, _ = pair
    h = np.random.default_rng(length).standard_normal((1, length, 128)).astype(np.float32)
    with torch.no_grad():
        got = pm.decoder(torch.from_numpy(h)).numpy()
    want = jax.jit(lambda m, x: m.decoder(x))(jm, jnp.asarray(h))
    assert got.shape == (1, 4 * (length - 1) * 16)
    if length > 1:
        _close(got, want)


def test_greedy_decode_with_hidden(pair, toks):
    """The planted path: identical count, hidden states within the bar; a
    cap shorter than the path stops at the cap."""
    jm, pm, path = pair
    tok = toks[0]
    s1, s2 = pm._stop_ids()
    assert (s1, s2) == (tok.token_to_id("[STOP]"), tok.token_to_id("<|endoftext|>"))
    assert (s1, s2) == jm._stop_ids()
    ids = tok.encode("[STOP][TEXT]hello world.[START]", add_special_tokens=False)
    for max_tokens in (32, 5):
        got, n = ps._decode_with_hidden(pm.language_model, ids, max_tokens, 0.0, 1.0,
                                        (s1, s2))
        caches = jm.language_model.make_caches(1, max_len=len(ids) + max_tokens + 1,
                                               dtype=jnp.float32)
        want, jn = js._decode_with_hidden(jm.language_model, caches,
                                          jnp.asarray([ids], jnp.int32),
                                          jax.random.PRNGKey(0), max_tokens, 0.0, 1.0, s1, s2)
        jn = int(jn)
        assert n == jn == min(PATH_LEN, max_tokens)
        _close(got.numpy(), np.asarray(want)[:, : jn + 1])


def test_greedy_generate(pair):
    """Two sentences, each the planted path, through both packages'
    `generate`: the same token count and the waveform within the bar."""
    jm, pm, _ = pair
    got = list(pm.generate(TEXT, temperature=0.0))
    want = list(jm.generate(TEXT, temperature=0.0))
    assert len(got) == len(want) == 1
    assert got[0].token_count == want[0].token_count == 2 * PATH_LEN
    _close(got[0].audio, want[0].audio)


def test_sampled_generate_is_seeded(pair):
    """Sampled decodes draw from a generator seeded 0: two runs agree."""
    _, pm, _ = pair
    a = list(pm.generate("Hello world.", temperature=0.7, top_p=0.9, max_tokens=12))
    b = list(pm.generate("Hello world.", temperature=0.7, top_p=0.9, max_tokens=12))
    assert [r.token_count for r in a] == [r.token_count for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.audio, y.audio)


def test_sanitize_and_load_model(pair, toks, tmp_path):
    """A checkpoint with the LM at the top level (`model.*`) and the decoder
    in torch's conv layout loads by `utils.load_model` from a directory
    named for Soprano-1.1 and decodes what the in-memory model decodes."""
    from mlx_audio_tpu_torch.safetensors_io import save_file
    from mlx_audio_tpu_torch.utils import load_model

    _, pm, _ = pair
    d = tmp_path / "soprano-1.1-tiny"
    d.mkdir()
    w = {}
    for k, v in pflat(pm).items():
        v = np.asarray(v)
        if k.startswith("language_model."):
            k = k[len("language_model."):]
        elif v.ndim == 3:
            v = np.ascontiguousarray(v.transpose(0, 2, 1))
        w[k] = v
    save_file(w, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({k: v for k, v in CFG.items()
                                               if k != "model_path"}))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        (d / name).write_text((toks[2] / name).read_text())
    loaded = load_model(str(d), device="cpu")
    assert type(loaded).__module__ == ps.__name__
    assert loaded.config.decoder_config.decoder_dim == DECODER["decoder_dim"]
    want = dict(pm.named_parameters())
    for k, p in loaded.named_parameters():
        torch.testing.assert_close(p, want[k], rtol=0, atol=0, msg=k)
    got = list(loaded.generate("Hello world.", temperature=0.0))
    ref = list(pm.generate("Hello world.", temperature=0.0))
    np.testing.assert_array_equal(got[0].audio, ref[0].audio)
