"""Bark in the port against the JAX package on the CPU at tiny widths (two
layers of 128, the published vocabularies and the 1024-row position
table), with the JAX package's own Gumbel draws passed in through each
stage's `noise_fn`, split in its loops' order, so that every token is
held identical:

- the semantic stage run to its 768-step cap, whose last step reads
  position 1024 (the JAX gather clamps it to row 1023; the port clamps in
  the embedding's call);
- the coarse stage over several windows, the last one's dead steps
  included, alone and with a voice prompt's history;
- the fine stage at temperature 0 and sampled, over two chunks;
- `generate` end to end through a tiny EnCodec, the semantic stop planted
  (`chip_smoke.plant_bark_stop`), the audio within 1e-5 of the peak;
- `sanitize` from nanoGPT names, and the config's key filtering;
- the JAX package's quantized Bark, which indexes its packed tables and
  raises, while the port's int4 Bark gives the tokens of the JAX float32
  Bark on the dequantized weights.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models.encodec.encodec import Encodec as JaxEncodec
from mlx_audio_tpu.codec.models.encodec.encodec import EncodecConfig as JaxEncodecConfig
from mlx_audio_tpu.nn import quantized as jq
from mlx_audio_tpu.nn.module import flatten_params as jax_flatten
from mlx_audio_tpu.nn.module import load_weights as jax_load
from mlx_audio_tpu.tts.models.bark import bark as jbark
from mlx_audio_tpu_torch.codec.models import Encodec
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn import quantized as pq
from mlx_audio_tpu_torch.nn.module import flatten_params
from mlx_audio_tpu_torch.tts.models.bark import Model
from mlx_audio_tpu_torch.tts.models.bark import bark as pbark

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
BAR = 1e-5


def _gpt(n_in, n_out):
    return dict(n_layer=2, n_head=2, n_embd=128, input_vocab_size=n_in, output_vocab_size=n_out)


CFG = dict(semantic_config=_gpt(129600, 10048), coarse_acoustics_config=_gpt(12096, 12096),
           fine_acoustics_config=_gpt(1056, 1056))
ENCODEC = dict(num_filters=8, hidden_size=16, codebook_size=1024, codebook_dim=16,
               upsampling_ratios=[8, 5, 4, 2])
TEXT = "Hello there, a tiny Bark."
PLANTED = 30  # generate's semantic tokens: the stop planted after them


class Tok:
    def encode(self, text, add_special_tokens=True):
        return [(ord(c) % 500) + 5 for c in text]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_copy(flat, cls, *args):
    """A JAX module built under `numpy_init`, then given `flat`."""
    with numpy_init():
        jm = cls(*args)
    return jax_load(jm, {k: jnp.asarray(np.asarray(v)) for k, v in flat.items()})


def _port_bark(seed, plant=None):
    pm = Model(CFG, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # the norms off their constant initialisers
        for name, p in pm.named_parameters():
            if "layernorm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    if plant is not None:
        _chip_smoke().plant_bark_stop(pm, plant, gain=1.5)
    return pm


def _encodec_pair():
    cfg = JaxEncodecConfig(**ENCODEC)
    with numpy_init(5):
        jc = JaxEncodec(cfg)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jc).items()}
    rng = np.random.default_rng(6)
    for k in [k for k in flat if k.endswith("codebook.embed")]:
        flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32)
    jc = jax_load(jc, {k: jnp.asarray(v) for k, v in flat.items()})
    pc = Encodec(dict(ENCODEC), device="cpu")
    load_jax_params(pc, flat)
    return jc, pc


@pytest.fixture(scope="module")
def pair():
    pm = _port_bark(1)
    jm = _jax_copy(flatten_params(pm), jbark.Model, jbark.ModelConfig.from_dict(CFG))
    return jm, pm


@pytest.fixture(scope="module")
def planted():
    pm = _port_bark(2, plant=PLANTED)
    jm = _jax_copy(flatten_params(pm), jbark.Model, jbark.ModelConfig.from_dict(CFG))
    return jm, pm


@pytest.fixture(scope="module", autouse=True)
def runtime():
    jc, pc = _encodec_pair()
    jbark.Model._tokenizer, jbark.Model._codec = Tok(), jc
    Model._tokenizer, Model._codec = Tok(), pc
    yield
    jbark.Model._tokenizer = jbark.Model._codec = None
    Model._tokenizer = Model._codec = None


# ---- the JAX package's draws, split in its loops' order ----


@functools.partial(jax.jit, static_argnums=(1, 2))
def _chain(key, n, shape):
    """The Gumbel draws of n successive `key, sub = split(key)` steps."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.gumbel(sub, shape)

    return jax.lax.scan(body, key, None, length=n)[1]


def semantic_noise(seed, n=pbark.SEMANTIC_MAX_STEPS):
    g = np.array(_chain(jax.random.PRNGKey(seed), n, (pbark.SEMANTIC_VOCAB_SIZE + 1,)))
    return lambda idx, shape: torch.from_numpy(g[idx[0]])


def coarse_noise(seed, windows, vocab):
    """Window w's key is the w-th split of PRNGKey(seed); its steps split
    that key in turn."""
    keys, key = [], jax.random.PRNGKey(seed)
    for _ in range(windows):
        key, sub = jax.random.split(key)
        keys.append(sub)
    g = [np.array(_chain(k, pbark.WINDOW_LEN, (vocab,))) for k in keys]
    return lambda idx, shape: torch.from_numpy(g[idx[0]][idx[1]])


def fine_noise(seed, chunks):
    """One split a codebook, the chain running on across chunks."""
    n = len(range(pbark.N_COARSE_CODEBOOKS, pbark.N_FINE_CODEBOOKS))
    g = np.array(_chain(jax.random.PRNGKey(seed), n * chunks, (1, 512, 1024)))
    return lambda idx, shape: torch.from_numpy(g[idx[0] * n + idx[1] - 2, 0])


def test_categorical_is_argmax_of_gumbel():
    """The identity the noise_fn tests rest on."""
    lg = jax.random.normal(jax.random.PRNGKey(3), (5, 1000)) * 3
    key = jax.random.PRNGKey(4)
    want = jax.random.categorical(key, lg)
    got = jnp.argmax(lg + jax.random.gumbel(key, lg.shape), axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---- stages ----


def test_semantic_to_the_cap_reads_position_1024(pair):
    jm, pm = pair
    seed = 3
    want = np.asarray(jm.generate_text_semantic(TEXT, None, 0.7, seed=seed))
    got = pm.generate_text_semantic(TEXT, None, 0.7, seed=seed, noise_fn=semantic_noise(seed))
    # the cap: step 767 fed its token back at position 257 + 767 = 1024
    assert len(want) == pbark.SEMANTIC_MAX_STEPS
    np.testing.assert_array_equal(got, want)


def test_semantic_stop_and_history(planted):
    jm, pm = planted
    rng = np.random.default_rng(8)
    voice = {"semantic_prompt": rng.integers(0, 10000, 300),
             "coarse_prompt": rng.integers(0, 1024, (2, 150))}
    for vp in (None, voice):
        want = np.asarray(jm.generate_text_semantic(TEXT, vp, 0.7, seed=4))
        got = pm.generate_text_semantic(TEXT, vp, 0.7, seed=4, noise_fn=semantic_noise(4))
        assert len(want) == PLANTED
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("voice", [False, True], ids=["alone", "voice_prompt"])
def test_coarse_windows_with_dead_steps(pair, voice):
    """35 semantic tokens: 104 coarse steps in two windows, the second
    taking 44 of its 60 (JAX samples the other 16 from all -inf logits and
    drops them)."""
    jm, pm = pair
    rng = np.random.default_rng(9)
    sem = rng.integers(0, 10000, 35)
    vp = ({"semantic_prompt": rng.integers(0, 10000, 300),
           "coarse_prompt": rng.integers(0, 1024, (2, 150))} if voice else None)
    want = jm.generate_coarse(sem, vp, 0.7)
    got = pm.generate_coarse(sem, vp, 0.7, noise_fn=coarse_noise(0, 2, 12096))
    assert want.shape == (2, 52)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [0.0, 0.5])
def test_fine_two_chunks(pair, temperature):
    jm, pm = pair
    coarse = np.random.default_rng(10).integers(0, 1024, (2, 600))
    want = jm.generate_fine(coarse, None, temperature)
    got = pm.generate_fine(coarse, None, temperature, noise_fn=fine_noise(0, 2))
    assert want.shape == (8, 600)
    np.testing.assert_array_equal(got, want)


def test_generate_end_to_end(planted, monkeypatch):
    jm, pm = planted
    want = list(jm.generate(TEXT, seed=5))
    sem = pm.generate_text_semantic
    monkeypatch.setattr(pm, "generate_text_semantic",
                        functools.partial(sem, noise_fn=semantic_noise(5)))
    n_steps = 2 * int(PLANTED * pbark.COARSE_RATE_HZ / pbark.SEMANTIC_RATE_HZ)
    monkeypatch.setattr(pm, "generate_coarse", functools.partial(
        pm.generate_coarse, noise_fn=coarse_noise(0, round(n_steps / 60), 12096)))
    monkeypatch.setattr(pm, "generate_fine",
                        functools.partial(pm.generate_fine, noise_fn=fine_noise(0, 1)))
    got = list(pm.generate(TEXT, seed=5))
    assert len(got) == len(want) == 1
    assert got[0].token_count == want[0].token_count == PLANTED
    a, b = np.asarray(want[0].audio), got[0].audio
    assert b.shape == a.shape == (n_steps // 2 * 320,)
    np.testing.assert_allclose(b, a, atol=BAR * np.abs(a).max())


def test_sanitize_and_config():
    """nanoGPT names → the JAX package's; a config in HF's key names loads
    at the defaults, as `BaseModelArgs.from_dict` drops what it does not
    know."""
    keys = ["semantic.transformer.wte.weight", "semantic.transformer.wpe.weight",
            "semantic.transformer.h.0.ln_1.weight", "semantic.transformer.h.0.attn.c_attn.weight",
            "semantic.transformer.h.0.attn.c_proj.weight", "semantic.transformer.h.0.mlp.c_fc.weight",
            "semantic.transformer.h.0.mlp.c_proj.weight", "semantic.transformer.h.0.ln_2.weight",
            "_orig_mod.coarse_acoustics.transformer.ln_f.weight", "fine_acoustics.lm_heads.0.weight"]
    w = {k: np.zeros(1, np.float32) for k in keys}
    jm = jbark.Model.__new__(jbark.Model)
    assert list(Model.sanitize(None, w)) == list(jm.sanitize(w))
    cfg = pbark.ModelConfig.from_dict({"semantic_config": {"num_layers": 3, "hidden_size": 64}})
    jcfg = jbark.ModelConfig.from_dict({"semantic_config": {"num_layers": 3, "hidden_size": 64}})
    assert cfg.semantic_config.n_layer == jcfg.semantic_config.n_layer == 12
    assert cfg.semantic_config.n_embd == jcfg.semantic_config.n_embd == 768


def test_jax_quantized_bark_fault(planted):
    """A fault of the reference: the JAX package's `quantize_module` packs
    Bark's embedding tables, which bark.py then indexes as `.weight[...]`
    (packed words), and the semantic stage raises. The port reads every
    table through its embedding's call: its int4 Bark gives the tokens of
    the JAX float32 Bark on the dequantized weights, in all three stages."""
    jm, _ = planted
    jq4 = jq.quantize_module(jm, 64, 4)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jq4.generate_text_semantic(TEXT, None, 0.7, seed=6)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jq4).items()}
    pm4 = Model(CFG, device="cpu")
    pq.quantize_module(pm4, 64, 4, quantize=False)
    load_jax_params(pm4, flat)
    assert isinstance(pm4.semantic.input_embeds_layer, pq.QuantizedEmbedding)
    deq = {}
    for k, v in flat.items():
        base = k[: -len(".weight")]
        if k.endswith(".weight") and base + ".scales" in flat:
            v = np.asarray(jq.dequantize_arrays(jnp.asarray(v), jnp.asarray(flat[base + ".scales"]),
                                                jnp.asarray(flat[base + ".biases"]), 64, 4,
                                                jnp.float32))
        if not k.endswith((".scales", ".biases")):
            deq[k] = v
    jf = _jax_copy(deq, jbark.Model, jbark.ModelConfig.from_dict(CFG))
    sem = pm4.generate_text_semantic(TEXT, None, 0.7, seed=6, noise_fn=semantic_noise(6))
    np.testing.assert_array_equal(sem, jf.generate_text_semantic(TEXT, None, 0.7, seed=6))
    assert len(sem) == PLANTED
    coarse = pm4.generate_coarse(sem[:20], None, 0.7, noise_fn=coarse_noise(0, 1, 12096))
    np.testing.assert_array_equal(coarse, jf.generate_coarse(sem[:20], None, 0.7))
    fine = pm4.generate_fine(coarse, None, 0.5, noise_fn=fine_noise(0, 1))
    np.testing.assert_array_equal(fine, jf.generate_fine(coarse, None, 0.5))


def test_hub_ids_raise(monkeypatch):
    """Without `set_runtime` or the checkpoint's files, the tokenizer and
    the codec name hub ids, which the port does not download."""
    monkeypatch.setattr(Model, "_tokenizer", None)
    monkeypatch.setattr(Model, "_codec", None)
    pm = Model(dict(CFG, **{k: dict(v, n_layer=1) for k, v in CFG.items()}), device="cpu")
    with pytest.raises(ValueError, match="does not download"):
        pm.tokenizer
    with pytest.raises(ValueError, match="does not download"):
        pm.codec
