"""CosyVoice2 in the port against the JAX package on the CPU at
`tests/test_cosyvoice2.py`'s tiny sizes (a Qwen2 LM of two layers of 32
over 40 speech tokens, a one-block conformer, a one-mid-block U-Net, a
two-stage HiFT):

- `ras_sample` with the JAX package's draws passed in (its two Gumbel
  draws, `jax.random.gumbel` of the keys `ras_sample` splits);
- the LM's prompt embeddings, and its decode with the JAX loop's draws
  replayed: the same tokens, fill tokens fed and not emitted, EOS masked
  below the minimum length, over a prompt the JAX package pads to 64 and
  the port prefills unpadded;
- `tokens_to_mel` with the JAX package's noise, full and chunk-masked
  (streaming), and padding-invariant: the tokens padded to 50 and to 100
  give the same mel;
- HiFT (the interpolating 24 kHz source) with the JAX draws;
- `Model.generate` end to end in all four modes with the JAX package's
  draws (the LM's, the flow's noise, HiFT's source, each from its key), and
  `synthesize_streaming` chunk by chunk;
- `RASBatcher`: four requests batched equal to each alone, in both stop
  rules (CosyVoice2's and CosyVoice3's), and `generate_tokens` through the
  installed batcher;
- the tokenizer's added control tokens, and a seeded checkpoint directory
  through `convert --quantize` and `utils.load_model` (int4 against the
  float port on the dequantized weights; the JAX package's int4 model
  reads packed words as its speech embedding and raises).

Weights go across with `load_jax_params`, every constant-initialised
parameter moved off its constant first. float32 bar: 1e-5 of each output's
peak, 1e-4 for waveforms (HiFT's ISTFT head); tokens identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.nn.module import flatten_params as jax_flatten
from mlx_audio_tpu.tts.models.cosyvoice2 import cosyvoice2 as jcv
from mlx_audio_tpu.tts.models.cosyvoice2 import llm as jllm
from mlx_audio_tpu_torch.codec.models import s3gen as ps
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.tts.models.cosyvoice2 import cosyvoice2 as pcv
from mlx_audio_tpu_torch.tts.models.cosyvoice2 import llm as pllm
from mlx_audio_tpu_torch.tts.models.cosyvoice2.config import ModelConfig

from test_cosyvoice2 import tiny_config
from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

BAR = 1e-5
WAV_BAR = 1e-4
V = 40  # the tiny model's speech tokens; EOS is 40, the fill tokens 41 and 42


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _t(x):
    return torch.from_numpy(np.array(x))


def ras_gumbels(key, V):
    """The draws the JAX `ras_sample` takes from `key`, as (1, V) rows."""
    k1, k2 = jax.random.split(key)
    return tuple(_t(np.asarray(jax.random.gumbel(k, (V,))))[None] for k in (k1, k2))


def interp_draws(sg, B, T, key):
    """The JAX interpolating SineGen's draws from `key`, in `SineGen.draws`'
    layout: phases (B, H) uniform in [0, 1), the fundamental's 0, and the
    noise."""
    H = sg.harmonic_num + 1
    k_phase, k_noise = jax.random.split(key)
    phase = np.array(jax.random.uniform(k_phase, (B, H)))
    phase[:, 0] = 0.0
    return _t(phase), _t(np.asarray(jax.random.normal(k_noise, (B, T, H))))


def jit_front_ends(monkeypatch, jmodule):
    """The JAX package's prompt mel (in `jmodule`) and S3Tokenizer log-mel
    compiled once a shape (its `generate` calls them eagerly)."""
    from mlx_audio_tpu.codec.models import s3tokenizer as js3tok

    monkeypatch.setattr(jmodule, "mel_spectrogram", jax.jit(
        jmodule.mel_spectrogram,
        static_argnames=("n_fft", "num_mels", "sampling_rate", "hop_size", "win_size", "fmin", "fmax")))
    monkeypatch.setattr(js3tok, "log_mel_spectrogram", jax.jit(
        js3tok.log_mel_spectrogram,
        static_argnames=("sample_rate", "n_mels", "n_fft", "hop_length", "padding")))


class JaxDraws:
    """The port's three stages drawing the JAX package's numbers: the LM's
    RAS draws from the loop's key stream, the flow's initial noise and
    HiFT's source from their keys. `set(key)` takes a request's key, split
    three ways as the JAX `synthesize` splits it (a streaming test fills
    the key lists itself). `cfm` and `sine` name the classes whose draws
    are replaced (CosyVoice3's are its own)."""

    def __init__(self, monkeypatch, cfm=ps.ConditionalCFM, sine=ps.SineGen):
        self.lm_key = self.flow_keys = self.hift_keys = None
        me = self

        def sampler(logp, hist, generators=None, **kw):
            me.lm_key, sub = jax.random.split(me.lm_key)
            return pllm_ras(logp, hist, gumbels=ras_gumbels(sub, logp.shape[-1]))

        def noise(cfm, shape, device, generator=None):
            return _t(np.asarray(jax.random.normal(me.flow_keys.pop(0), shape)))

        def draws(sg, B, T, device, generator=None):
            return interp_draws(sg, B, T, me.hift_keys.pop(0))

        pllm_ras = pllm.ras_sample
        monkeypatch.setattr(pllm, "ras_sample", sampler)
        monkeypatch.setattr(cfm, "initial_noise", noise)
        monkeypatch.setattr(sine, "draws", draws)

    def set(self, key, lm=True):
        if lm:
            k1, k2, k3 = jax.random.split(key, 3)
            self.lm_key, self.flow_keys, self.hift_keys = k1, [k2], [k3]
        else:  # voice conversion: no LM
            k2, k3 = jax.random.split(key)
            self.flow_keys, self.hift_keys = [k2], [k3]


@pytest.fixture(scope="module")
def pair():
    """(JAX CosyVoice2, port CosyVoice2) at the tiny sizes, on the same
    weights, the JAX package's flow and HiFT calls compiled."""
    cfg = tiny_config()
    with numpy_init(0):
        jm = jcv.build_cosyvoice2(cfg)
    jm = _moved(jm, np.random.default_rng(0))
    pm = pcv.build_cosyvoice2(tiny_config(), device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in jax_flatten(jm).items()})
    return jm, pm


def test_ras_sample_with_the_jax_draws():
    """Rows where the nucleus holds one token, several, or is capped at top-k;
    a window that holds the nucleus's pick (the resample from the whole
    distribution) and one that does not."""
    rng = np.random.default_rng(1)
    Vs = 60
    for scale in (0.1, 3.0, 30.0):
        logits = rng.standard_normal(Vs).astype(np.float32) * scale
        logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
        for s in range(6):
            key = jax.random.PRNGKey(s)
            pick = int(jllm.nucleus_sample(jnp.asarray(logp), jax.random.split(key)[0], 0.8, 25))
            for hist in (np.full(10, -1), np.array([pick] + [-1] * 9), np.full(10, pick)):
                want = int(jllm.ras_sample(jnp.asarray(logp), jnp.asarray(hist, jnp.int32), key))
                got = pllm.ras_sample(_t(logp)[None], _t(hist)[None].long(),
                                      gumbels=ras_gumbels(key, Vs))
                assert int(got[0]) == want


def _prompt(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 100, 5).astype(np.int32), rng.integers(1, 100, 3).astype(np.int32),
            rng.integers(0, V, (1, 7)))


def test_prompt_embeds(pair):
    jm, pm = pair
    text, ptext, pspeech = _prompt()
    for args in ((text, ptext, pspeech), (text, None, None), (text, ptext, None)):
        with torch.no_grad():
            got = pm.llm.build_prompt_embeds(*args).numpy()
        _close(got, jm.llm.build_prompt_embeds(*args))


@pytest.mark.parametrize("case", ["plain", "eos_floor", "fills"])
def test_lm_tokens_with_the_jax_draws(pair, case, monkeypatch):
    """The JAX loop's RAS draws replayed into the port's decode. `eos_floor`
    biases the decoder towards EOS (masked below the minimum length, then
    the stop); `fills` towards the fill tokens (fed and never emitted)."""
    jm, pm = pair
    jlm, plm = jm.llm, pm.llm
    if case != "plain":
        b = np.zeros(V + 3, np.float32)
        b[[V] if case == "eos_floor" else [V + 1, V + 2]] = 3.0
        b = b + np.asarray(jlm.llm_decoder.bias)
        jlm = jlm.replace(llm_decoder=jlm.llm_decoder.replace(bias=jnp.asarray(b)))
        monkeypatch.setattr(plm.llm_decoder, "bias", torch.nn.Parameter(_t(b)))
    draws = JaxDraws(monkeypatch)
    text, ptext, pspeech = _prompt(3)
    lens = []
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want, n = jlm.inference(text, ptext, pspeech, key=key, max_token_text_ratio=4.0,
                                min_token_text_ratio=1.0)
        draws.lm_key = key
        got, m = plm.inference(text, ptext, pspeech, max_token_text_ratio=4.0,
                               min_token_text_ratio=1.0, seed=0)
        np.testing.assert_array_equal(got, want)
        assert m == n and (got < V).all()
        lens.append(n)
    assert max(lens) > 0


def _flow_inputs(seed=4, n=10):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (1, n)), rng.integers(0, V, (1, 4)),
            rng.standard_normal((1, 8, 16)).astype(np.float32) * 0.1,
            rng.standard_normal((1, 8)).astype(np.float32))


@pytest.mark.parametrize("streaming", [False, True])
def test_tokens_to_mel_with_the_jax_noise(pair, streaming):
    jm, pm = pair
    tokens, ptok, pmel, spk = _flow_inputs()
    key = jax.random.PRNGKey(5)
    want = jcv._flow_infer(jm.flow, jnp.asarray(jcv._pad_tokens(tokens)), jnp.array([10]),
                           jnp.asarray(ptok), jnp.array([4]), jnp.asarray(pmel),
                           jnp.asarray(spk), key, 2, streaming)[:, :20]
    noise = _t(np.asarray(jax.random.normal(key, (1, 2 * (4 + 50), 16))))
    got = pm.tokens_to_mel(tokens, ptok, pmel, spk, streaming=streaming, noise=noise)
    assert got.shape == (1, 20, 16)
    _close(got.numpy(), want)


def test_flow_is_padding_invariant(pair):
    """The same 10 tokens padded to 50 and to 100, with the same noise on the
    first 54 token rows: the same mel (the masks keep the padding out)."""
    _, pm = pair
    tokens, ptok, pmel, spk = _flow_inputs(6)
    noise = torch.randn(1, 2 * (4 + 100), 16, generator=torch.Generator().manual_seed(7))
    a = pm.tokens_to_mel(tokens, ptok, pmel, spk, noise=noise[:, : 2 * 54])
    orig = pcv._pad_tokens
    try:
        pcv._pad_tokens = lambda t: orig(t, 100)
        b = pm.tokens_to_mel(tokens, ptok, pmel, spk, noise=noise)
    finally:
        pcv._pad_tokens = orig
    _close(a.numpy(), b.numpy(), bar=1e-6)


def test_hift_with_the_jax_draws(pair):
    jm, pm = pair
    mel = np.random.default_rng(8).standard_normal((1, 12, 16)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jcv._hift_infer(jm.hifigan, jnp.asarray(mel), key)
    sg = pm.hifigan.m_source.l_sin_gen
    got = pm.mel_to_audio(mel, draws=interp_draws(sg, 1, 12 * pm.hifigan.f0_upsample_scale,
                                                  key))
    assert got.shape == (1, 12 * 32)
    _close(got, want, bar=WAV_BAR)


class FakeTok:
    def encode(self, s):
        return [(ord(c) % 100) + 1 for c in s][:8]


class FakeS3:
    """A deterministic stand-in for the S3Tokenizer: one code per 100 mel
    frames, at least two."""

    def quantize(self, mel, mel_len):
        n = max(2, int(np.asarray(mel_len)[0]) // 100)
        return (np.arange(n)[None] * 7) % V, np.array([n])


class FakeSpk:
    def __init__(self, torch_side):
        self.torch_side = torch_side

    def inference(self, audio):
        x = np.linspace(-1, 1, 8, dtype=np.float32)[None]
        return torch.from_numpy(x) if self.torch_side else jnp.asarray(x)


def _models(pair):
    jm, pm = pair
    jmodel = jcv.Model.__new__(jcv.Model)
    jmodel.config = jcv.ModelConfig(sample_rate=24000, cosyvoice2=tiny_config())
    jmodel.sample_rate, jmodel.model = 24000, jm
    jmodel.set_runtime(tokenizer=FakeTok(), s3_tokenizer=FakeS3(), speaker_encoder=FakeSpk(False))
    pmodel = pcv.Model(ModelConfig(sample_rate=24000, cosyvoice2=tiny_config()), device="cpu")
    pmodel.model = pm
    pmodel.set_runtime(tokenizer=FakeTok(), s3_tokenizer=FakeS3(), speaker_encoder=FakeSpk(True))
    return jmodel, pmodel


@pytest.mark.parametrize("mode", ["zero-shot", "cross-lingual", "instruct", "vc"])
def test_generate_end_to_end_with_the_jax_draws(pair, mode, monkeypatch):
    """`Model.generate` on a 2 s reference in each mode: the waveform within
    1e-4 of the peak of the JAX package's. The JAX package's resampler is
    scipy's (the port's)."""
    from mlx_audio_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    jit_front_ends(monkeypatch, jcv)
    jmodel, pmodel = _models(pair)
    draws = JaxDraws(monkeypatch)
    rng = np.random.default_rng(10)
    ref = rng.standard_normal(32000).astype(np.float32) * 0.1
    kw = {"zero-shot": dict(ref_text="a line"), "cross-lingual": {},
          "instruct": dict(instruct_text="calm"),
          "vc": dict(source_audio=rng.standard_normal(24000).astype(np.float32) * 0.1)}[mode]
    want = list(jmodel.generate("hello there", ref_audio=ref, seed=11, verbose=False, **kw))
    draws.set(jax.random.PRNGKey(11), lm=mode != "vc")
    got = list(pmodel.generate("hello there", ref_audio=ref, seed=11, verbose=False, **kw))
    assert len(got) == len(want) == 1 and got[0].samples == want[0].samples > 0
    _close(got[0].audio, want[0].audio, bar=WAV_BAR)


def test_synthesize_streaming_with_the_jax_draws(pair, monkeypatch):
    """Chunks of 4 tokens, each the chunk-masked flow over the tokens so far
    and HiFT on the new chunk's mel; the keys split as the JAX package
    splits them."""
    jm, pm = pair
    draws = JaxDraws(monkeypatch)
    text, ptext, pspeech = _prompt(12)
    _, _, pmel, spk = _flow_inputs(13)
    pmel = np.concatenate([pmel, pmel[:, :6]], axis=1)  # 2 x 7 prompt tokens
    np.random.seed(14)  # the JAX package draws its key from numpy's generator
    key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
    np.random.seed(14)
    want = list(jm.synthesize_streaming(text, ptext, pspeech, pmel, spk, chunk_tokens=4,
                                        max_token_text_ratio=2.0, min_token_text_ratio=1.0))
    k1, key = jax.random.split(key)
    draws.lm_key, draws.flow_keys, draws.hift_keys = k1, [], []
    for _ in want:
        key, k2, k3 = jax.random.split(key, 3)
        draws.flow_keys.append(k2)
        draws.hift_keys.append(k3)
    got = list(pm.synthesize_streaming(text, ptext, pspeech, pmel, spk, chunk_tokens=4,
                                       max_token_text_ratio=2.0, min_token_text_ratio=1.0))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        _close(g, w, bar=WAV_BAR)


def test_jax_streaming_with_a_key_fault(pair):
    """A fault of the reference: the JAX package's
    `CosyVoice2.synthesize_streaming` takes its key as `kwargs.pop("key",
    None) or PRNGKey(...)`, and the truth value of a key array raises, so a
    caller's key is refused (the port takes a seed)."""
    jm, _ = pair
    text, ptext, pspeech = _prompt(12)
    _, _, pmel, spk = _flow_inputs(13)
    with pytest.raises(ValueError, match="truth value"):
        next(jm.synthesize_streaming(text, ptext, pspeech, pmel, spk,
                                     key=jax.random.PRNGKey(0)))


@pytest.mark.parametrize("v3", [False, True])
def test_ras_batcher_equals_each_request_alone(pair, v3):
    """Four requests of different prompts and caps batched, ticks of 3
    steps: each request's tokens are its decode alone with the same seed,
    under CosyVoice2's stop rule and CosyVoice3's (any token ≥ V stops)."""
    from mlx_audio_tpu_torch.tts.models.cosyvoice2.batcher import RASBatcher

    _, pm = pair
    lm = pm.llm
    reqs = []
    for i in range(4):
        text, ptext, pspeech = _prompt(20 + i)
        with torch.no_grad():
            emb = lm.build_prompt_embeds(text[: 2 + i], ptext if i % 2 else None, pspeech)
        reqs.append((emb, 1 + i, 6 + 3 * i, 30 + i))
    want = [pllm.decode_loop(lm, e, lo, hi, seed, v3=v3) for e, lo, hi, seed in reqs]
    b = RASBatcher(pm, lm=lm, v3=v3, slots=3, max_len=64, tick_frames=3)
    try:
        futs = [b.submit(e.numpy(), min_tokens=lo, max_steps=hi, seed=seed)
                for e, lo, hi, seed in reqs]
        got = [f.result(timeout=60) for f in futs]
    finally:
        b.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(len(w) for w in want) > 8


def test_generate_tokens_through_the_installed_batcher(pair):
    _, pm = pair
    text, ptext, pspeech = _prompt(30)
    direct = pm.generate_tokens(text, ptext, pspeech, max_token_text_ratio=3.0, seed=5)
    b = pm.make_batcher(slots=2, max_len=64, tick_frames=4).install()
    try:
        served = pm.generate_tokens(text, ptext, pspeech, max_token_text_ratio=3.0, seed=5)
        assert b.dispatch_count >= 1
    finally:
        b.close()
    np.testing.assert_array_equal(served, direct)


INT4_LLM = dict(llm_input_size=64, llm_output_size=64, hidden_size=64, intermediate_size=128,
                num_attention_heads=4, num_key_value_heads=2)


def _int4_config():
    import dataclasses

    cfg = tiny_config()
    cfg.llm = dataclasses.replace(cfg.llm, **INT4_LLM)
    return cfg


def _dequantized(flat, deq_fn):
    out = {}
    for k, v in flat.items():
        base = k[: -len(".weight")]
        if k.endswith(".weight") and base + ".scales" in flat:
            v = deq_fn(v, flat[base + ".scales"], flat[base + ".biases"])
        if not k.endswith((".scales", ".biases")):
            out[k] = v
    return out


@pytest.mark.parametrize("family", ["cosyvoice2", "cosyvoice3"])
def test_jax_quantized_lm_fault(family, monkeypatch):
    """A fault of the reference: the JAX package's `quantize_module` (the
    packing `convert --quantize` applies to every 2-D weight a multiple of
    64 wide) packs the LM's speech table, which the decode loop then
    indexes as `speech_embedding.weight[tok]` (packed words, 8 to a row of
    64), and the decode raises. The port reads its tables through the
    embeddings' calls: its int4 LM decodes the tokens of the JAX float32 LM
    on the dequantized weights, the JAX draws replayed."""
    import dataclasses

    from mlx_audio_tpu.nn import quantized as jq
    from mlx_audio_tpu_torch.nn import quantized as pq

    if family == "cosyvoice2":
        from mlx_audio_tpu.tts.models.cosyvoice2.llm import Qwen2LM as JLM
        from mlx_audio_tpu_torch.tts.models.cosyvoice2.llm import Qwen2LM as PLM

        cfg = _int4_config().llm
    else:
        from mlx_audio_tpu.tts.models.cosyvoice3.llm import CosyVoice3LM as JLM
        from mlx_audio_tpu_torch.tts.models.cosyvoice3.llm import CosyVoice3LM as PLM

        from test_cosyvoice3 import tiny_config as cv3_tiny

        cfg = dataclasses.replace(cv3_tiny().llm, **INT4_LLM)
    with numpy_init(40):
        jlm = _moved(JLM(cfg), np.random.default_rng(40))
    jq4 = jq.quantize_module(jlm, 64, 4)
    text, ptext, pspeech = _prompt(41)
    with pytest.raises(Exception):
        jq4.inference(text, ptext, pspeech, key=jax.random.PRNGKey(0),
                      max_token_text_ratio=3.0, min_token_text_ratio=1.0)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jq4).items()}
    pm4 = PLM(cfg, device="cpu")
    pq.quantize_module(pm4, 64, 4, quantize=False)
    load_jax_params(pm4, flat)
    assert isinstance(pm4.speech_embedding, pq.QuantizedEmbedding)
    deq = _dequantized(flat, lambda w, s, b: np.asarray(jq.dequantize_arrays(
        jnp.asarray(w), jnp.asarray(s), jnp.asarray(b), 64, 4, jnp.float32)))
    from mlx_audio_tpu.nn.module import load_weights as jload

    jf = jload(JLM(cfg), {k: jnp.asarray(v) for k, v in deq.items()})
    draws = JaxDraws(monkeypatch)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want, n = jf.inference(text, ptext, pspeech, key=key, max_token_text_ratio=3.0,
                               min_token_text_ratio=1.0)
        draws.lm_key = key
        got, m = pm4.inference(text, ptext, pspeech, max_token_text_ratio=3.0,
                               min_token_text_ratio=1.0, seed=0)
        np.testing.assert_array_equal(got, want)
        assert m == n


def test_convert_quantize_and_load_model(tmp_path):
    """A seeded CosyVoice2 directory (the LM under its upstream
    `llm.model.model.*` names, CAM++'s `campplus.*` keys, an S3TokenizerV2
    with its widths in s3tokenizer/) through `convert --quantize` and
    `utils.load_model`: the LM's layers, head and tables int4, the
    S3Tokenizer and CAM++ read from the directory, and the int4 LM's prompt
    and decode logits within 1e-5 of the float port's on the dequantized
    weights (the int4 model's tokens replayed)."""
    import dataclasses

    from mlx_audio_tpu_torch.codec.models.s3tokenizer import ModelConfig as S3Config
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import S3TokenizerV2
    from mlx_audio_tpu_torch.convert import convert, dequantize_weights, save_model
    from mlx_audio_tpu_torch.nn import load_weights
    from mlx_audio_tpu_torch.nn.module import flatten_params
    from mlx_audio_tpu_torch.utils import load_model, load_weight_files

    cfg = _int4_config()
    pm = pcv.Model(ModelConfig(cosyvoice2=cfg), device="cpu", seed=42)
    weights = {k.replace("model.llm.llm.model.", "model.llm.llm.model.model.", 1): v
               for k, v in flatten_params(pm).items()}
    weights["campplus.head.conv1.weight"] = np.ones((4, 1, 3, 3), np.float32)
    src = tmp_path / "release"
    save_model(src, weights, {"model_type": "cosyvoice2", **dataclasses.asdict(cfg)})
    s3 = S3TokenizerV2(config=S3Config(n_mels=128, n_audio_state=32, n_audio_head=2,
                                       n_audio_layer=1), device="cpu", seed=43)
    save_model(src / "s3tokenizer", flatten_params(s3), dataclasses.asdict(s3.config))
    out = convert(str(src), str(tmp_path / "int4"), quantize=True)
    q4 = load_model(str(out), device="cpu")
    lm4 = q4.model.llm
    assert type(lm4.llm.model.layers[0].mlp.down_proj).__name__ == "QuantizedLinear"
    assert type(lm4.llm_decoder).__name__ == "QuantizedLinear"
    assert type(lm4.speech_embedding).__name__ == "QuantizedEmbedding"
    loaded_s3 = q4._runtime_part("s3_tokenizer")
    for k, v in flatten_params(s3).items():
        np.testing.assert_array_equal(flatten_params(loaded_s3)[k], v)
    assert list(pcv.campplus_weights(out)) == ["head.conv1.weight"]
    deq = pcv.Model(ModelConfig(cosyvoice2=cfg), device="cpu")
    load_weights(deq, deq.sanitize(dequantize_weights(load_weight_files(out), 4, 64)),
                 strict=False)
    text, ptext, pspeech = _prompt(44)

    def run(lm, codes=None):
        rows = []
        handle = lm.llm_decoder.register_forward_hook(
            lambda m, a, o: rows.append(o.detach().numpy().copy()))
        it, taken = iter(codes) if codes else None, []

        def sampler(logp, hist, gen):
            tok = int(logp[0].argmax()) if it is None else next(it)
            taken.append(tok)
            return torch.tensor([tok])

        with torch.inference_mode():
            emb = lm.build_prompt_embeds(text, ptext, pspeech)
            pllm.decode_loop(lm, emb, 2, 10, 0, sampler=sampler)
        handle.remove()
        return rows, taken

    rows4, codes = run(lm4)
    rowsd, _ = run(deq.model.llm, codes)
    assert len(rows4) == len(rowsd) == 11
    for a, b in zip(rows4, rowsd):
        _close(a, b)
