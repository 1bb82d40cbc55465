"""Wav2Vec2 in the port against the JAX package on the CPU at tiny widths:
every hidden state in Hugging Face's order (the group-norm standard encoder
and the layer-norm stable one), greedy CTC `generate` against the JAX text,
the StackBatcher, `sanitize` (the positional conv's weight norm folded, the
pretraining heads dropped), loading by `utils.load_model` under both model
types, and the `vocab.json` text.

On the CPU the attention takes the plain route in both packages; the flash
kernel it reaches on the card (1280 frames and up) is held to its plain
version by `chip_smoke.py`. float32 bar: 1e-5 of each output's peak; CTC
ids identical."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu.stt.models.wav2vec import wav2vec as jw
from mlx_audio_tpu_torch.nn import flatten_params as pflat
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.stt.models.wav2vec import wav2vec as pw

from test_torch_vocos import _close
from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

CONFIGS = {
    "base_group_norm": dict(vocab_size=12, hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=48,
                            conv_dim=[16, 16, 16], conv_stride=[5, 2, 2],
                            conv_kernel=[10, 3, 2], num_conv_pos_embeddings=6,
                            num_conv_pos_embedding_groups=4),
    "stable_layer_norm": dict(vocab_size=12, hidden_size=32, num_hidden_layers=3,
                              num_attention_heads=4, intermediate_size=48,
                              conv_dim=[16, 16, 16], conv_stride=[5, 2, 2],
                              conv_kernel=[10, 3, 2], num_conv_pos_embeddings=5,
                              num_conv_pos_embedding_groups=4, feat_extract_norm="layer",
                              do_stable_layer_norm=True, conv_bias=True),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    with numpy_init():
        jm = _moved(jw.Model(jw.ModelConfig(**cfg)), np.random.default_rng(1))
    pm = pw.Model(cfg, device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return cfg, jm, pm


def _audio(n=3200, seed=2):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def test_hidden_states_in_hf_order(pair):
    cfg, jm, pm = pair
    x = np.stack([_audio(), _audio(seed=3)])
    with torch.no_grad():
        got = pm.wav2vec2.hidden_states(torch.from_numpy(x))
    want = jax.jit(lambda m, x: m.wav2vec2.hidden_states(x))(jm, jnp.asarray(x))
    assert len(got) == len(want) == cfg["num_hidden_layers"] + 1
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    h, logits = pm(x)
    jh, jlogits = jm(jnp.asarray(x))
    _close(h.numpy(), jh)
    _close(logits.numpy(), jlogits)


def test_ctc_generate_against_the_jax_text(pair):
    _, jm, pm = pair
    for seed in (4, 5):
        a = _audio(4800, seed)
        got, want = pm.generate(a), jm.generate(a)
        assert got.text == want.text and got.generation_tokens == want.generation_tokens


def test_stack_batcher_equals_alone(pair):
    _, _, pm = pair
    audios = [_audio(3200, s) for s in range(6, 9)]
    alone = [pm.generate(a).text for a in audios]
    b = pm.make_batcher(max_batch=4, window_ms=20).install()
    try:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(3) as ex:
            served = [r.text for r in ex.map(pm.generate, audios)]
        assert b.dispatch_count >= 1
    finally:
        b.close()
    assert served == alone


def test_sanitize_load_model_and_vocab(pair, tmp_path):
    """A Hugging Face layout (torch convs, the positional conv as a weight-norm
    pair, a pretraining head) loads by `utils.load_model` under `wav2vec2`
    and `wav2vec`, and spells its CTC ids from vocab.json."""
    from mlx_audio_tpu_torch.safetensors_io import save_file
    from mlx_audio_tpu_torch.utils import load_model

    cfg, _, pm = pair
    w = {}
    for k, v in pflat(pm).items():
        v = np.asarray(v)
        if v.ndim == 3:
            v = np.ascontiguousarray(v.transpose(0, 2, 1))  # torch (O, I, K)
        if k == "wav2vec2.encoder.pos_conv_embed.conv.weight":
            norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))  # HF: dim=2
            w[k[:-len("weight")] + "weight_g"] = norm
            w[k[:-len("weight")] + "weight_v"] = v
            continue
        w[k] = v
    w["quantizer.codevectors"] = np.zeros((1, 4, 2), np.float32)
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
    vocab.update({c: 5 + i for i, c in enumerate("abcdefg")})
    for mt in ("wav2vec2", "wav2vec"):
        d = tmp_path / mt
        d.mkdir()
        save_file(w, str(d / "model.safetensors"))
        (d / "config.json").write_text(json.dumps(dict(cfg, model_type=mt)))
        (d / "vocab.json").write_text(json.dumps(vocab))
        loaded = load_model(str(d), device="cpu")
        assert type(loaded).__module__ == pw.__name__
        want = dict(pm.named_parameters())
        for k, p in loaded.named_parameters():
            torch.testing.assert_close(p, want[k], rtol=1e-6, atol=1e-6, msg=k)
    a = _audio(4800, 4)
    ids = [ord(c) - 97 for c in pm.generate(a).text]
    text = loaded.generate(a).text
    inv = {i: t for t, i in vocab.items()}
    assert text == "".join(inv[i] for i in ids if i != 0).replace("|", " ").strip()
