"""Orpheus (Llama) and VyvoTTS (Qwen3), the SNAC-token LM TTS families, in
the port against the JAX package on the CPU at tiny widths. Both sides
decode through one tiny SNAC, the port's (tests/test_torch_snac.py holds it
to the JAX package's), so that what differs is the LM and the frame layout
around it.

Random weights would send greedy tokens anywhere in the vocabulary, and a
code outside its codebook would decode as the codebook's last row (the port
clamps it as the JAX package does), not as a frame of the path. So each
pair plants the path `chip_smoke.py` plants at full width: every
token's embedding is the lm_head row of its planted successor, scaled up,
so the argmax follows END_OF_HUMAN, START_OF_AI, START_OF_SPEECH, then
frames of 7 valid codes, then END_OF_SPEECH. Both packages run the same
weights; tokens, codes and prompts must be identical, audio within 1e-5.
Text goes in through each checkpoint's `tokenizer.json` (Llama-3 style for
Orpheus, Qwen2 style for VyvoTTS): `tokenizers` on the JAX side, the port's
own reader on the port's.
"""

import functools
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tokenizers import Tokenizer as HFTokenizer

from mlx_audio_tpu.nn.module import load_weights
from mlx_audio_tpu.tts.models import snac_lm as jsnac_lm
from mlx_audio_tpu.tts.models.llama import Model as JaxOrpheus
from mlx_audio_tpu.tts.models.qwen3 import Model as JaxVyvo
from mlx_audio_tpu_torch import tokenizer_json
from mlx_audio_tpu_torch import utils as putils
from mlx_audio_tpu_torch.codec.models import SNAC
from mlx_audio_tpu_torch.convert import save_model
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.module import flatten_params as pflatten
from mlx_audio_tpu_torch.tts.models import snac_lm
from mlx_audio_tpu_torch.tts.models.llama import Model as Orpheus
from mlx_audio_tpu_torch.tts.models.qwen3 import Model as Vyvo

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
TEXT = "The quick brown fox."
MAX_TOKENS = 2 + 7 * 3  # SOA, SOS, three frames
SNAC_TINY = dict(sampling_rate=24000, encoder_dim=8, encoder_rates=[2, 2], decoder_dim=32,
                 decoder_rates=[2, 2], attn_window_size=None, codebook_size=4096,
                 codebook_dim=8, vq_strides=[4, 2, 1], noise=False, depthwise=True)
FAMILIES = {
    "orpheus": (JaxOrpheus, Orpheus, "llama3",
                dict(model_type="llama", vocab_size=156940, rope_theta=500000.0,
                     rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                   "original_max_position_embeddings": 64})),
    "vyvo": (JaxVyvo, Vyvo, "qwen2", dict(model_type="qwen3", vocab_size=180352)),
}
WIDTHS = dict(hidden_size=128, num_hidden_layers=2, intermediate_size=256,
              num_attention_heads=4, num_key_value_heads=2)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _SharedCodec:
    """The port's SNAC behind the JAX package's codec calls (arrays in,
    arrays out)."""

    def __init__(self, snac):
        self.snac = snac

    def encode(self, audio):
        return [c.numpy() for c in self.snac.encode(np.asarray(audio))]

    def decode(self, codes):
        return self.snac.decode([np.asarray(c) for c in codes]).numpy()

    def decode_stream(self, codes, prev_codes=None, context_frames=8):
        prev = None if prev_codes is None else [np.asarray(c) for c in prev_codes]
        audio, ctx = self.snac.decode_stream([np.asarray(c) for c in codes], prev,
                                             context_frames)
        return audio.numpy(), [c.numpy() for c in ctx]


class _HF:
    """`tokenizers` with the call the JAX package makes: tok(text).input_ids."""

    def __init__(self, path):
        self.tok = HFTokenizer.from_file(str(path))

    def __call__(self, text):
        return SimpleNamespace(input_ids=self.tok.encode(text).ids)

    def encode(self, text):
        return self.tok.encode(text).ids


def _planted(flat: dict, succ, rng) -> dict:
    """Every embedding row 8x the lm_head row of its planted successor, the
    layers' weights scaled down, the norms off their constants."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if k.endswith("norm.weight"):
            v = v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        elif k.startswith("model.layers."):
            v = 0.1 * v
        out[k] = v
    head = rng.standard_normal(out["lm_head.weight"].shape).astype(np.float32)
    out["lm_head.weight"] = head
    out["model.embed_tokens.weight"] = 8 * head[succ]
    return out


def _port_model(name, tmp_path: Path):
    """The port's model of a family on the planted tiny weights, with its
    tokenizer.json reader and a tiny SNAC → (model, config, weights, the
    tokenizer.json path, the spoken frames' codes)."""
    _, pcls, style, cfg = FAMILIES[name]
    cfg = dict(WIDTHS, **cfg)
    cs = _chip_smoke()
    succ, spoken, _ = cs.orpheus_successors(cfg["vocab_size"], model_cls=pcls)
    pm = pcls(cfg, device="cpu")
    flat = _planted(pflatten(pm), succ, np.random.default_rng(0))
    load_jax_params(pm, flat)
    tok_path = cs.write_tokenizer_json(tmp_path / f"{name}_tokenizer.json", style)
    pm.set_runtime(tokenizer=tokenizer_json.load(tok_path), codec=SNAC(**SNAC_TINY, device="cpu"))
    return pm, cfg, flat, tok_path, spoken


def _family_pair(name, tmp_path: Path):
    """The JAX package's model and the port's on the same planted weights,
    each with its own tokenizer, and one SNAC."""
    pm, cfg, flat, tok_path, spoken = _port_model(name, tmp_path)
    with numpy_init():
        jm = FAMILIES[name][0](cfg)
    jm = load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})
    jm.set_runtime(tokenizer=_HF(tok_path), codec=_SharedCodec(pm.codec))
    return jm, pm, cfg, flat, tok_path, spoken


def port_orpheus(tmp_path: Path):
    """The port's Orpheus on the planted tiny weights (for other test
    files; its tokenizer and codec are set on the class)."""
    return _port_model("orpheus", tmp_path)[0]


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, tmp_path_factory):
    pair = _family_pair(request.param, tmp_path_factory.mktemp(request.param))
    yield (request.param,) + pair
    jcls, pcls = FAMILIES[request.param][:2]
    for cls in (jcls, pcls):
        cls._tokenizer = cls._codec = None


def test_prompts_equal(family):
    _, jm, pm, *_ = family
    assert pm.prepare_input_ids(TEXT) == jm.prepare_input_ids(TEXT)
    assert pm.prepare_input_ids(TEXT, voice="tara") == jm.prepare_input_ids(TEXT, voice="tara")


def test_generate_matches_jax(family):
    """Greedy at the defaults (repetition penalty 1.3 over 20): the planted
    frames, the same audio; then through END_OF_SPEECH (the EOS trim)."""
    name, jm, pm, cfg, flat, tok, spoken = family
    want = list(jm.generate(TEXT, temperature=0.0, max_tokens=MAX_TOKENS))
    with torch.inference_mode():
        got = list(pm.generate(TEXT, temperature=0.0, max_tokens=MAX_TOKENS))
    assert len(got) == len(want) == 1
    assert got[0].token_count == want[0].token_count == MAX_TOKENS
    assert got[0].samples == want[0].samples == 3 * 16
    np.testing.assert_allclose(got[0].audio, np.asarray(want[0].audio), rtol=0, atol=ATOL)


def test_generate_stops_at_end_of_speech(family, monkeypatch):
    """A short planted path: END_OF_SPEECH after the second frame; both
    packages stop there and decode the two frames."""
    name, jm, pm, cfg, flat, tok, spoken = family
    jcls, pcls = FAMILIES[name][:2]
    codes = []
    monkeypatch.setattr(pcls, "decode_audio",
                        lambda self, c: (codes.append(list(c)),
                                         snac_lm.SnacARModel.decode_audio(self, c))[1])
    succ = _chip_smoke().orpheus_successors(cfg["vocab_size"], model_cls=pcls)[0]
    last = pcls.AUDIO_TOKENS_START + 6 * 4096 + int(spoken[1, 6])
    assert succ[last] == pcls.AUDIO_TOKENS_START + int(spoken[2, 0])
    e = np.asarray(flat["lm_head.weight"])[pcls.END_OF_SPEECH] * 8
    emb = np.asarray(flat["model.embed_tokens.weight"]).copy()
    emb[last] = e
    jm2 = load_weights(jm, {"model.embed_tokens.weight": jnp.asarray(emb)}, strict=False)
    with torch.no_grad():
        saved = pm.model.embed_tokens.weight.clone()
        pm.model.embed_tokens.weight.copy_(torch.as_tensor(emb))
    try:
        want = list(jm2.generate(TEXT, temperature=0.0, max_tokens=40))
        with torch.inference_mode():
            got = list(pm.generate(TEXT, temperature=0.0, max_tokens=40))
    finally:
        with torch.no_grad():
            pm.model.embed_tokens.weight.copy_(saved)
    assert got[0].token_count == want[0].token_count == 2 + 14 + 1
    assert codes[-1] == _chip_smoke().frame_codes(spoken[:2])
    np.testing.assert_allclose(got[0].audio, np.asarray(want[0].audio), rtol=0, atol=ATOL)


def test_stream_matches_jax(family):
    """stream=True: audio every 7 frames' worth (interval 7/137.5 s) decoded
    with code context, chunk by chunk as the JAX package's."""
    name, jm, pm, *_ = family
    kw = dict(temperature=0.0, max_tokens=2 + 7 * 5, stream=True,
              streaming_interval=14 / 137.5)
    want = list(jm.generate(TEXT, **kw))
    with torch.inference_mode():
        got = list(pm.generate(TEXT, **kw))
    assert [g.samples for g in got] == [w.samples for w in want]
    assert len(got) >= 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), rtol=0, atol=ATOL)


def test_zeroprompt_and_codes(family):
    """Voice cloning's prefix (the reference encoded by SNAC) and the frame
    layout helpers equal the JAX package's."""
    _, jm, pm, *_ = family
    ref = 0.1 * np.random.default_rng(3).standard_normal(16 * 8).astype(np.float32)
    assert pm.prepare_zeroprompt(ref, "Hi there.") == jm.prepare_zeroprompt(ref, "Hi there.")
    flat = list(np.random.default_rng(4).integers(0, 4096, 14) + np.tile(np.arange(7), 2) * 4096)
    got = snac_lm.codes_to_layers(flat)
    want = jsnac_lm.codes_to_layers(flat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert snac_lm.layers_to_codes(got) == jsnac_lm.layers_to_codes(want) == flat
    toks = np.asarray([5, pm.START_OF_SPEECH] + [pm.AUDIO_TOKENS_START + c for c in flat]
                      + [pm.END_OF_SPEECH, 9])
    assert pm.parse_output(toks) == jm.parse_output(toks) == flat


def test_load_model_from_a_directory(family, tmp_path):
    """The port's checkpoint (config.json, safetensors, tokenizer.json)
    through `utils.load_model`: the family from the config, the same
    parameters, the tokenizer read from the directory, the same audio."""
    name, jm, pm, cfg, flat, tok, _ = family
    d = tmp_path / f"{name}-tiny"
    save_model(d, pflatten(pm), dict(cfg))
    (d / "tokenizer.json").write_bytes(Path(tok).read_bytes())
    cls = type(pm)
    want_ids = pm.prepare_input_ids(TEXT)
    with torch.inference_mode():
        want = list(pm.generate(TEXT, temperature=0.0, max_tokens=MAX_TOKENS))
    saved = cls._tokenizer
    cls._tokenizer = None
    try:
        loaded = putils.load_model(d, device="cpu")
        assert type(loaded) is cls
        for k, v in pflatten(pm).items():
            np.testing.assert_array_equal(pflatten(loaded)[k], v)
        assert loaded.prepare_input_ids(TEXT) == want_ids
        with torch.inference_mode():
            got = list(loaded.generate(TEXT, temperature=0.0, max_tokens=MAX_TOKENS))
    finally:
        cls._tokenizer = saved
    np.testing.assert_array_equal(got[0].audio, want[0].audio)


def test_load_model_int4(family, tmp_path):
    """An int4 checkpoint (every Linear and the embedding, as `convert
    --quantize` writes it): the loader quantizes them, row-stacks q/k/v and
    gate/up, and gives the logits of the model quantized in memory
    (tests/test_torch_lm.py holds int4 logits to the JAX package's)."""
    import copy

    from mlx_audio_tpu_torch.convert import quantize_weights
    from mlx_audio_tpu_torch.nn import quantized as pq

    name, jm, pm, cfg, flat, tok, _ = family
    weights = quantize_weights({k: np.asarray(v) for k, v in flat.items()}, bits=4,
                               group_size=64)
    d = tmp_path / f"{name}-tiny-int4"
    save_model(d, weights, dict(cfg, quantization={"group_size": 64, "bits": 4}))
    (d / "tokenizer.json").write_bytes(Path(tok).read_bytes())
    ids = pm.prepare_input_ids(TEXT)
    cls = type(pm)
    saved = cls._tokenizer
    cls._tokenizer = None
    try:
        loaded = putils.load_model(d, device="cpu")
        assert loaded.prepare_input_ids(TEXT) == ids
    finally:
        cls._tokenizer = saved
    assert isinstance(loaded.model.layers[0].self_attn.qkv_fused, pq.QuantizedFusedLinear)
    assert isinstance(loaded.lm_head, pq.QuantizedLinear)
    ref = pq.quantize_module(copy.deepcopy(pm), group_size=64, bits=4, quantize=False,
                             predicate=lambda p, m: f"{p}.scales" in weights)
    load_jax_params(ref, weights)
    pq.fuse_quantized_projections(ref)
    with torch.inference_mode():
        got, _ = loaded(torch.as_tensor([ids]))
        want, _ = ref(torch.as_tensor([ids]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_hub_codec_raises():
    """The codec's hub id is not downloaded: give the codec with
    set_runtime or load it from a directory."""
    with pytest.raises(ValueError, match="does not download"):
        SNAC.from_pretrained(Orpheus.SNAC_REPO, device="cpu")
