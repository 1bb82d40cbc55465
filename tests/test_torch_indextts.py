"""IndexTTS in the port against the JAX package on the CPU at
`tests/test_indextts.py`'s `tiny_args()` (a GPT of two layers of 32, a
one-block conformer of 24, a BigVGAN of two stages):

- `nn.Conv2d` (NHWC, strided, padded, grouped), ECAPA-TDNN, the conformer,
  the perceiver and the speaker-conditioned BigVGAN, module by module;
- `prepare_input_embedding`, the latent decode loop at top_k = 1 (the stop
  planted with `chip_smoke.plant_indextts_stop`, and run to its cap), and
  `generate` end to end (identical codes and counts, latents and audio
  within the bar);
- a seeded checkpoint directory through `utils.load_model`, and `sanitize`;
- the text normalizer against the JAX package's;
- int4 through the port's `convert` at a width the quantizer takes (64),
  held to the float port on the dequantized weights, and the JAX package's
  quantized IndexTTS, which reads its packed tables and raises.

Weights go across with `load_jax_params`, every constant-initialised
parameter moved off its constant first. float32 bar: 1e-5 of each output's
peak; codes identical."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.nn import layers as jl
from mlx_audio_tpu.nn import quantized as jq
from mlx_audio_tpu.nn.module import flatten_params as jax_flatten
from mlx_audio_tpu.nn.module import load_weights as jax_load
from mlx_audio_tpu.tts.models.indextts import indextts as ji
from mlx_audio_tpu.tts.models.indextts import normalize as jnorm
from mlx_audio_tpu_torch.nn import Conv2d, load_jax_params
from mlx_audio_tpu_torch.nn.module import flatten_params
from mlx_audio_tpu_torch.tts.models.indextts import indextts as pi
from mlx_audio_tpu_torch.tts.models.indextts import normalize as pnorm

from test_indextts import FakeTok, tiny_args
from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
BAR = 1e-5
PLANT = 6  # the planted stop's step: 7 latents
REF = np.random.default_rng(40).standard_normal(6000).astype(np.float32) * 0.1

_jit_call = jax.jit(lambda m, *a: m(*a))


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carry(jm, pm, seed=0):
    jm = _moved(jm, np.random.default_rng(seed))
    load_jax_params(pm, {k: np.asarray(v) for k, v in jax_flatten(jm).items()})
    return jm


def _jax_model(flat, args=None):
    with numpy_init():
        jm = ji.Model(args or tiny_args())
    return jax_load(jm, {k: jnp.asarray(np.asarray(v)) for k, v in flat.items()})


def _models(args_fn=tiny_args, plant=PLANT, seed=41):
    """(JAX model, port model) on the same weights, moved off their
    constants, the stop planted at step `plant` (None: no plant)."""
    with numpy_init(seed):
        jm = ji.Model(args_fn())
    pm = pi.Model(args_fn(), device="cpu")
    _carry(jm, pm, seed)
    with torch.no_grad():
        pm.gpt.wpe.weight.zero_()  # IndexTTS's: a checkpoint carries none
    if plant is not None:
        _chip_smoke().plant_indextts_stop(pm, plant, gain=0.5)
    return _jax_model(flatten_params(pm), args_fn()), pm


@pytest.fixture(scope="module")
def planted():
    jm, pm = _models()
    for m in (jm, pm):
        m.set_runtime(tokenizer=FakeTok())
    return jm, pm


@pytest.mark.parametrize("case", [dict(kernel_size=3, stride=2),
                                  dict(kernel_size=(3, 5), stride=(1, 2), padding=1),
                                  dict(kernel_size=3, groups=2, dilation=2)])
def test_conv2d_nhwc(case):
    with numpy_init(1):
        jc = jl.Conv2d(4, 6, **case)
    pc = Conv2d(4, 6, **case, device="cpu")
    jc = _carry(jc, pc, 1)
    x = np.random.default_rng(2).standard_normal((2, 9, 11, 4)).astype(np.float32)
    with torch.no_grad():
        got = pc(torch.from_numpy(x)).numpy()
    _close(got, _jit_call(jc, jnp.asarray(x)))


def test_ecapa_tdnn():
    args = dict(input_size=16, lin_neurons=12, channels=[16, 16, 16, 16, 48],
                attention_channels=8, res2net_scale=4, se_channels=8)
    with numpy_init(3):
        jm = ji.ECPATDNN(ji.ECPATDNNArgs(**args))
    pm = pi.ECPATDNN(pi.ECPATDNNArgs(**args), device="cpu")
    jm = _carry(jm, pm, 3)
    x = np.random.default_rng(4).standard_normal((2, 23, 16)).astype(np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1, 12)
    _close(got, _jit_call(jm, jnp.asarray(x)))


def test_conformer_and_perceiver():
    """The conv2d front's channel-major flatten, the relative-position
    attention's plain bias, the conv module; then the perceiver over it
    (its own context projection at 24 → 32)."""
    cm = ji.ConformerArgs(input_size=16, output_size=24, num_blocks=2, linear_units=48,
                          attention_heads=2)
    with numpy_init(5):
        jc = ji.Conformer(cm)
        jp = ji.PerceiverResampler(32, 24, n_heads=2, n_latents=4)
    pc = pi.Conformer(pi.ConformerArgs(**vars(cm)), device="cpu")
    pp = pi.PerceiverResampler(32, 24, n_heads=2, n_latents=4, device="cpu")
    jc, jp = _carry(jc, pc, 5), _carry(jp, pp, 6)
    mel = np.random.default_rng(7).standard_normal((1, 37, 16)).astype(np.float32)
    want = _jit_call(jc, jnp.asarray(mel))
    with torch.no_grad():
        got = pc(torch.from_numpy(mel))
        _close(got.numpy(), want)
        _close(pp(got).numpy(), _jit_call(jp, want))


def test_conditioned_bigvgan(planted):
    jm, pm = planted
    lat = np.random.default_rng(8).standard_normal((1, 5, 32)).astype(np.float32)
    mel = np.random.default_rng(9).standard_normal((1, 30, 16)).astype(np.float32)
    with torch.no_grad():
        got = pm.bigvgan(torch.from_numpy(lat), torch.from_numpy(mel)).numpy()
    assert got.shape == (1, 40, 1)
    _close(got, _jit_call(jm.bigvgan, jnp.asarray(lat), jnp.asarray(mel)))


def test_log_mel_and_prepare_input_embedding(planted):
    jm, pm = planted
    got_mel = pi.log_mel_spectrogram(REF, n_mels=16)
    want_mel = ji.log_mel_spectrogram(REF, n_mels=16)
    _close(got_mel.numpy(), want_mel)
    tokens = FakeTok().encode("hello")
    got = pm.prepare_input_embedding(tokens, want_mel)
    want = jm.prepare_input_embedding(tokens, want_mel)
    assert got.shape == (1, 4 + len(tokens) + 3, 32)
    _close(got.numpy(), want)


def _codes(model_head, latents):
    """The code each latent drew at top_k = 1: the argmax of its logits."""
    return np.argmax(np.asarray(model_head(latents)), axis=-1)


@pytest.mark.parametrize("max_tokens,n", [(20, PLANT + 1), (4, 5)])
def test_decode_latents_at_top_k_1(planted, max_tokens, n):
    """The planted stop (its latent kept: n + 1), and a cap before it (the
    JAX loop's count of max_tokens + 1 over max_tokens rows)."""
    jm, pm = planted
    mel = np.asarray(ji.log_mel_spectrogram(REF, n_mels=16))
    emb = np.asarray(jm.prepare_input_embedding(FakeTok().encode("hi there"), mel))
    T0 = emb.shape[1]
    Tp = max(16, ((T0 + 15) // 16) * 16)
    g = jm.args.gpt
    caches = [ji.KVCache(1, g.heads, Tp + max_tokens + 1, g.model_dim // g.heads,
                         jnp.float32) for _ in range(g.layers)]
    want, want_n = ji._indextts_decode(
        jm, caches, jnp.pad(jnp.asarray(emb), ((0, 0), (0, Tp - T0), (0, 0))),
        jnp.asarray(T0), jax.random.PRNGKey(0), max_tokens, 0.8, 1, None)
    got, got_n = pi._indextts_decode(pm, torch.tensor(emb), max_tokens, 0.8, 1, seed=5)
    assert got_n == int(want_n) == n
    rows = min(n, max_tokens)
    _close(got[:rows].numpy(), np.asarray(want)[:rows])
    with torch.no_grad():
        codes = _codes(lambda x: pm.mel_head(torch.from_numpy(x)).numpy(), got[:rows].numpy())
    np.testing.assert_array_equal(
        codes, _codes(lambda x: jm.mel_head(jnp.asarray(x)), np.asarray(want)[:rows]))
    assert (codes[-1] == g.stop_mel_token) == (max_tokens > PLANT)


def test_generate_end_to_end(planted):
    """`generate` from a reference clip at top_k = 1: the count, the
    prompt's token count and the audio of the JAX package's."""
    jm, pm = planted
    want = list(jm.generate("Hello there.", ref_audio=REF, max_tokens=20, top_k=1, seed=0))
    got = list(pm.generate("Hello there.", ref_audio=REF, max_tokens=20, top_k=1, seed=3))
    assert len(got) == len(want) == 1
    assert got[0].token_count == want[0].token_count == PLANT + 1
    assert got[0].prompt == want[0].prompt
    assert got[0].samples == want[0].samples == (PLANT + 1) * 8
    _close(got[0].audio, want[0].audio)


def test_sample_code_keeps_ties_and_the_top_k():
    """The sort threshold keeps every logit tied with the k-th; a draw lands
    only on the survivors; top_k = 1 is the argmax."""
    logits = torch.tensor([[0.1, 2.0, 2.0, -1.0, 0.5, 2.0]])
    g = torch.Generator().manual_seed(0)
    seen = {int(pi.sample_code(logits, g, 1.0, 2)) for _ in range(200)}
    assert seen == {1, 2, 5}
    assert int(pi.sample_code(torch.tensor([[0.3, 0.9, -2.0]]), g, 0.8, 1)) == 1


def test_loaded_from_a_seeded_directory(planted, tmp_path):
    """config.json and safetensors written by the port's `save_model`, read
    by `utils.load_model` (model_type `indextts`): the same parameters and
    the same audio as the model in memory."""
    from mlx_audio_tpu_torch import utils
    from mlx_audio_tpu_torch.convert import save_model

    _, pm = planted
    cfg = dict(model_type="indextts", gpt=_gpt_dict(tiny_args()), bigvgan=tiny_args().bigvgan,
               sample_rate=24000)
    save_model(tmp_path, flatten_params(pm), cfg)
    loaded = utils.load_model(tmp_path, device="cpu")
    assert isinstance(loaded, pi.Model)
    assert loaded.args.model_path == str(tmp_path)
    for (k, a), (_, b) in zip(pm.state_dict().items(), loaded.state_dict().items()):
        if k != "gpt.wte.weight":  # dropped by `sanitize`, as in the JAX package: unused
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    loaded.set_runtime(tokenizer=FakeTok())
    a = next(pm.generate("Hi.", ref_audio=REF, max_tokens=20, top_k=1, seed=1)).audio
    b = next(loaded.generate("Hi.", ref_audio=REF, max_tokens=20, top_k=1, seed=1)).audio
    np.testing.assert_array_equal(a, b)


def _gpt_dict(args):
    d = dict(vars(args.gpt))
    d["condition_module"] = dict(vars(d["condition_module"]))
    return d


def test_sanitize_keys_and_tokenizer_errors(planted, tmp_path):
    """The JAX package's key map (wte and wpe dropped, `.emb.` position
    tables and doubled norm / conv names folded); without a tokenizer, or
    with a `tokenizer.model` and no sentencepiece, `generate` raises the
    JAX package's RuntimeError."""
    jm, _ = planted
    keys = ["gpt.wte.weight", "gpt.wpe.weight", "mel_pos_embedding.emb.weight",
            "text_pos_embedding.emb.weight", "bigvgan.speaker_encoder.blocks.0.norm.norm.weight",
            "bigvgan.speaker_encoder.blocks.0.conv.conv.bias", "mel_head.weight"]
    w = {k: np.zeros(3, np.float32) for k in keys}
    pm = pi.Model(tiny_args(), device="cpu")
    assert list(pm.sanitize(w)) == list(jm.sanitize(w)) == [
        "mel_pos_embedding.weight", "text_pos_embedding.weight",
        "bigvgan.speaker_encoder.blocks.0.norm.weight",
        "bigvgan.speaker_encoder.blocks.0.conv.bias", "mel_head.weight"]
    with pytest.raises(RuntimeError, match="tokenizer not set"):
        next(pm.generate("Hi.", ref_audio=REF))
    (tmp_path / "tokenizer.model").write_bytes(b"\0")
    pm.args.model_path = str(tmp_path)
    if importlib.util.find_spec("sentencepiece") is None:
        with pytest.raises(RuntimeError, match="sentencepiece"):
            next(pm.generate("Hi.", ref_audio=REF))


def test_runtime_lives_on_the_instance():
    """A tokenizer set on one model is that model's alone: not in its
    state dict, freed with it, and not seen by a model built after it (a
    class-level table keyed by id() handed it to a later model at the same
    address)."""
    import gc
    import weakref

    pm = pi.Model(tiny_args(), device="cpu")
    keys = set(pm.state_dict())
    tok = FakeTok()
    pm.set_runtime(tokenizer=tok)
    assert pm._tokenizer() is tok and set(pm.state_dict()) == keys
    gone = weakref.ref(tok)
    del pm, tok
    gc.collect()
    assert gone() is None
    with pytest.raises(RuntimeError, match="tokenizer not set"):
        pi.Model(tiny_args(), device="cpu")._tokenizer()


NORMALIZE_CASES = [
    "I have $42 and 3 cats", "what's 1 2 3", "你好，世界！", "ni3 hao3", "hello world",
    "It's 1,234,567 dollars; that's $1,000,000.", "Call 5 5 5 1 2 1 2 now!",
    "【测试】“引号”——和……省略号～", "foo@bar.com", "He said (quietly): 'no'... ok?",
    "你好世界是 hello world 的中文", "ju4 xue2 qu4", "张三-李四 说：你好。", "",
    "Room 101, floor 0.", "where's the 2nd one? there's 12 of them",
]


@pytest.mark.parametrize("text", NORMALIZE_CASES)
def test_normalizer_against_the_jax_package(text):
    assert pnorm.normalize(text) == jnorm.normalize(text)
    assert pnorm.tokenize_by_CJK_char(pnorm.normalize(text)) == \
        jnorm.tokenize_by_CJK_char(jnorm.normalize(text))
    assert pnorm.use_chinese(text) == jnorm.use_chinese(text)


def test_normalizer_reference_strings():
    """`tests/test_indextts.py::test_text_normalization`'s expectations."""
    N = pnorm
    assert N.normalize("I have $42 and 3 cats") == "I have forty two dollars and three cats"
    assert N.normalize("what's 1 2 3") == "what is one two three"
    assert N.number_to_words(1234567) == \
        "one million two hundred thirty four thousand five hundred sixty seven"
    assert N.normalize_chinese("你好，世界！") == "你好,世界!"
    assert N.correct_pinyin("ju4") == "JV4" and N.correct_pinyin("ma1") == "ma1"
    assert N.tokenize_by_CJK_char("你好世界是 hello world 的中文") == \
        "你 好 世 界 是 HELLO WORLD 的 中 文"


# ---------------------------------------------------------------------------
# int4
# ---------------------------------------------------------------------------
def wide_args():
    """tiny_args at 64 wide, so that the quantizer (groups of 64) takes the
    GPT, the heads, the tables and the conditioners' projections."""
    a = tiny_args()
    a.gpt.model_dim = 64
    a.gpt.condition_module = ji.ConformerArgs(input_size=16, output_size=64, num_blocks=1,
                                              linear_units=128, attention_heads=2,
                                              perceiver_mult=2)
    a.bigvgan = dict(a.bigvgan, gpt_dim=64)
    return a


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """The port's float model at 64 wide (the stop planted), written to a
    directory and converted to int4 by the port's `convert`, loaded by
    `utils.load_model`; the JAX twin on the same float weights."""
    from mlx_audio_tpu_torch import utils
    from mlx_audio_tpu_torch.convert import convert, save_model

    jm, pm = _models(wide_args, plant=PLANT, seed=43)
    d = tmp_path_factory.mktemp("indextts")
    args = wide_args()
    save_model(d / "f32", flatten_params(pm),
               dict(model_type="indextts", gpt=_gpt_dict(args), bigvgan=args.bigvgan))
    convert(str(d / "f32"), str(d / "int4"), quantize=True, q_bits=4, q_group_size=64)
    q4 = utils.load_model(d / "int4", device="cpu")
    return jm, pm, q4, d


def test_int4_matches_the_float_port_on_the_dequantized_weights(wide):
    """Every table, head and projection the quantizer takes is int4 in the
    loaded model; its latents, logits and codes at top_k = 1 are the float
    port's on the dequantized weights."""
    from mlx_audio_tpu_torch import utils
    from mlx_audio_tpu_torch.convert import convert
    from mlx_audio_tpu_torch.nn import quantized as pq

    _, _, q4, d = wide
    for name in ("text_embedding", "mel_embedding", "mel_pos_embedding",
                 "text_pos_embedding"):
        assert isinstance(getattr(q4, name), pq.QuantizedEmbedding), name
    for m in (q4.mel_head, q4.gpt.h[0].attn.c_attn, q4.gpt.h[1].mlp.c_proj,
              q4.conditioning_encoder.embed.out[0],
              q4.conditioning_encoder.encoders[0].self_attn.linear_pos,
              q4.perceiver_encoder.layers[0][1].w_1):
        assert isinstance(m, pq.QuantizedLinear)
    convert(str(d / "int4"), str(d / "deq"), dequantize=True)
    deq = utils.load_model(d / "deq", device="cpu")
    mel = pi.log_mel_spectrogram(REF, n_mels=16)
    toks = FakeTok().encode("hello there")
    e4, ef = q4.prepare_input_embedding(toks, mel), deq.prepare_input_embedding(toks, mel)
    _close(e4.numpy(), ef.numpy())
    lat4, n4 = pi._indextts_decode(q4, e4, 20, 0.8, 1, seed=0)
    latf, nf = pi._indextts_decode(deq, ef, 20, 0.8, 1, seed=0)
    assert n4 == nf == PLANT + 1
    _close(lat4[:n4].numpy(), latf[:nf].numpy())
    with torch.no_grad():
        l4, lf = q4.mel_head(lat4[:n4]), deq.mel_head(latf[:nf])
    _close(l4.numpy(), lf.numpy())
    np.testing.assert_array_equal(l4.argmax(-1).numpy(), lf.argmax(-1).numpy())


def test_jax_quantized_indextts_fault(wide):
    """A fault of the reference: the JAX package's `quantize_module` packs
    IndexTTS's four tables, which indextts.py then reads as `.weight[...]`
    (packed words): `prepare_input_embedding` raises at the text position
    table (`indextts.py:614`). The port reads every table through its
    embedding's call, and its int4 model runs (the test above)."""
    jm, _, _, _ = wide
    jq4 = jq.quantize_module(jm, 64, 4)
    assert isinstance(jq4.text_pos_embedding, jq.QuantizedEmbedding)
    mel = ji.log_mel_spectrogram(REF, n_mels=16)
    with pytest.raises(TypeError, match="add got incompatible shapes"):
        jq4.prepare_input_embedding(FakeTok().encode("hello"), mel)
