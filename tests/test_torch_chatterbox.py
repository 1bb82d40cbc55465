"""Chatterbox in the port against the JAX package on the CPU at
`tests/test_chatterbox.py`'s tiny sizes (a T3 of two Llama layers of 32,
the tiny S3Gen of `test_torch_s3gen.py`, a voice encoder of 16):

- `punc_norm` and `drop_invalid_tokens`;
- the voice encoder, `T3CondEnc` and `build_prefill_embeds` with and
  without CFG;
- T3's speech tokens at the argmax settings (temperature 1e-5, min-p
  0.05: only the argmax survives), CFG on and off, the repetition
  penalty on: identical, over a prompt the JAX package pads to 32 and the
  port prefills unpadded;
- `Model.generate` end to end with the JAX package's draws passed in (the
  flow's PRNGKey(42) noise, HiFT's source from the request's key);
- the tokenizer reader against `tokenizers` on a file of Chatterbox's
  components (a character-level BPE, the `Whitespace` pre-tokenizer, no
  decoder) trained in the test;
- a seeded directory in the upstream layout through the family's
  `convert` and `utils.load_model` (its `s3tokenizer/` read from the
  checkpoint), and the missing S3Tokenizer raising;
- int4 by `convert` (T3's Llama layers at 64 wide) against the float port
  on the dequantized weights, and the JAX package's own int4 directory
  loaded and run to the same tokens.

Weights go across with `load_jax_params`, every constant-initialised
parameter moved off its constant first. float32 bar: 1e-5 of each output's
peak, 1e-4 for waveforms (HiFT's ISTFT head); tokens identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models import s3gen as js
from mlx_audio_tpu.tts.models.chatterbox import chatterbox as jcb
from mlx_audio_tpu.tts.models.chatterbox import t3 as jt3
from mlx_audio_tpu.tts.models.chatterbox import tokenizer as jtok
from mlx_audio_tpu.tts.models.chatterbox import voice_encoder as jve
from mlx_audio_tpu.tts.models.chatterbox.config import T3Config as JT3Config
from mlx_audio_tpu.nn.module import flatten_params as jax_flatten
from mlx_audio_tpu_torch.codec.models import s3gen as ps
from mlx_audio_tpu_torch.codec.models.s3tokenizer import ModelConfig as S3Config
from mlx_audio_tpu_torch.codec.models.s3tokenizer import S3TokenizerV2
from mlx_audio_tpu_torch.convert import dequantize_weights
from mlx_audio_tpu_torch.nn import load_jax_params, load_weights
from mlx_audio_tpu_torch.nn.module import flatten_params
from mlx_audio_tpu_torch.tts.models.chatterbox import chatterbox as pcb
from mlx_audio_tpu_torch.tts.models.chatterbox import t3 as pt3
from mlx_audio_tpu_torch.tts.models.chatterbox import tokenizer as ptok
from mlx_audio_tpu_torch.tts.models.chatterbox import voice_encoder as pve
from mlx_audio_tpu_torch.tts.models.chatterbox.config import ModelConfig, T3Config
from mlx_audio_tpu_torch.utils import load_weight_files

from test_chatterbox import TINY_LLAMA
from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)
from test_torch_s3gen import _tiny_token2wav, jax_token2wav, sine_draws

BAR = 1e-5
WAV_BAR = 1e-4
T3_KW = dict(text_tokens_dict_size=50, speech_tokens_dict_size=70, start_speech_token=60,
             stop_speech_token=61, max_speech_tokens=64, speaker_embed_size=16,
             llama_overrides=TINY_LLAMA)
VE_HP = dict(num_mels=8, ve_hidden_size=16, speaker_embed_size=16, ve_partial_frames=20)
ARGMAX = dict(temperature=1e-5, min_p=0.05, top_p=1.0, repetition_penalty=1.2)
S3TOK = dict(n_mels=128, n_audio_state=32, n_audio_head=4, n_audio_layer=1)


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _carry(jm, pm, seed=0):
    jm = _moved(jm, np.random.default_rng(seed))
    load_jax_params(pm, {k: np.asarray(v) for k, v in jax_flatten(jm).items()})
    return jm


def _t3_pair(seed=0, **kw):
    """(JAX T3, port T3) on the same weights; the speech head's rows past
    the codes (SOS, EOS and the rest) zero unless `stop` is kept."""
    cfg = dict(T3_KW, **kw)
    with numpy_init(seed):
        jm = jt3.T3(JT3Config(**cfg))
    pm = pt3.T3(T3Config(**cfg), device="cpu")
    return _carry(jm, pm, seed), pm


def _cond_pair(dim=16, seed=1, prompt=6):
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((1, dim)).astype(np.float32)
    toks = rng.integers(0, 60, (1, prompt))
    jc = jt3.T3Cond(speaker_emb=jnp.asarray(spk), cond_prompt_speech_tokens=jnp.asarray(toks),
                    emotion_adv=jnp.ones((1, 1, 1)) * 0.3)
    pc = pt3.T3Cond(speaker_emb=torch.from_numpy(spk),
                    cond_prompt_speech_tokens=torch.from_numpy(toks),
                    emotion_adv=torch.full((1, 1, 1), 0.3))
    return jc, pc


@pytest.mark.parametrize("text", ["hello world", "", "wait... what: yes; no — maybe",
                                  "“quoted” ‘text’ - ok", "Done!"])
def test_punc_norm(text):
    assert pcb.punc_norm(text) == jcb.punc_norm(text)


@pytest.mark.parametrize("x", [[1, 2, 6561, 5, 7, 6562, 9], [3, 4, 5], [6561, 6563, 2, 6562],
                               [6562, 1], []])
def test_drop_invalid_tokens(x):
    np.testing.assert_array_equal(pcb.drop_invalid_tokens(np.array(x, np.int64)),
                                  jcb.drop_invalid_tokens(np.array(x, np.int64)))


def test_voice_encoder(monkeypatch):
    monkeypatch.setattr(jve.VoiceEncoder, "__call__", jax.jit(jve.VoiceEncoder.__call__))
    hp = dict(VE_HP)
    with numpy_init(2):
        jm = jve.VoiceEncoder(jve.VoiceEncConfig(**hp))
    pm = pve.VoiceEncoder(pve.VoiceEncConfig(**hp), device="cpu")
    jm = _carry(jm, pm, 2)
    mels = np.random.default_rng(3).standard_normal((3, 20, 8)).astype(np.float32)
    with torch.no_grad():
        _close(pm(torch.from_numpy(mels)).numpy(), jm(jnp.asarray(mels)))
        wavs = [np.random.default_rng(4).standard_normal(16000).astype(np.float32) * 0.1,
                np.random.default_rng(5).standard_normal(9000).astype(np.float32) * 0.1]
        _close(pm.embeds_from_wavs(wavs).numpy(), jm.embeds_from_wavs(wavs))
        _close(pve.melspectrogram(wavs[0]).numpy(), jve.melspectrogram(wavs[0]))


@pytest.mark.parametrize("cfg_on", [True, False])
def test_cond_enc_and_prefill_embeds(cfg_on, monkeypatch):
    monkeypatch.setattr(jt3.Perceiver, "__call__", jax.jit(jt3.Perceiver.__call__))
    jm, pm = _t3_pair(3)
    jc, pc = _cond_pair()
    with torch.no_grad():
        _close(pm.prepare_conditioning(pc).numpy(), jm.prepare_conditioning(jc))
        jc, pc = _cond_pair()
        text = np.array([[5, 3, 4, 7, 0]])
        got = pm.build_prefill_embeds(pc, text, cfg_on=cfg_on).numpy()
    want = np.asarray(jm.build_prefill_embeds(jc, text, cfg_on=cfg_on))
    _close(got, want)
    assert got.shape[0] == (2 if cfg_on else 1)
    if cfg_on:  # the uncond row's text rows (positions included) are zero
        Lc = got.shape[1] - text.shape[1] - 1
        assert not got[1, Lc:Lc + text.shape[1]].any()


@pytest.mark.parametrize("cfg_weight", [0.5, 0.0])
def test_t3_tokens_at_the_argmax_settings(cfg_weight):
    """The JAX loop pads the prompt to 32 rows and writes step s at row
    Tp + s; the port prefills it unpadded (row T0 + s): the same rope and
    learned positions, the same tokens. The head's SOS row is zero, so a
    step never takes it; the stop may come mid-run or not at all."""
    jm, pm = _t3_pair(4)
    with torch.no_grad():
        pm.speech_head.weight[60] = 0.0
    jm = jm.replace(speech_head=jm.speech_head.replace(
        weight=jnp.asarray(pm.speech_head.weight.detach().numpy())))
    for seed, text in enumerate(([[5, 3, 4, 7, 0]], [[5, 9, 9, 12, 13, 14, 2, 0]])):
        jc, pc = _cond_pair(seed=10 + seed)
        want = jm.inference(jc, np.array(text), max_new_tokens=24, cfg_weight=cfg_weight,
                            key=jax.random.PRNGKey(seed), **ARGMAX)
        got = pm.inference(pc, np.array(text), max_new_tokens=24, cfg_weight=cfg_weight,
                           seed=seed, **ARGMAX)
        np.testing.assert_array_equal(got, want)
        assert got.shape[1] >= 1


class FakeTok:
    def text_to_tokens(self, text, language_id=None):
        return np.asarray([[(ord(c) % 40) + 1 for c in text][:6]])


class FakeS3:
    """A deterministic stand-in for the S3Tokenizer: 4 codes a second
    of 16 kHz mel frames at least."""

    def quantize(self, mel, mel_len):
        n = max(4, int(np.asarray(mel_len)[0]) // 50)
        return (np.arange(n)[None] * 7) % 60, np.array([n])


TINY_SIZES = {"campplus": dict(feat_dim=80, embedding_size=192, growth_rate=4, bn_size=2,
                               init_channels=8),
              "encoder": dict(input_size=16, output_size=16, attention_heads=2,
                              linear_units=32, num_blocks=1, num_up_blocks=1),
              "estimator": dict(in_channels=32, out_channels=8, channels=[16],
                                attention_head_dim=8, n_blocks=1, num_mid_blocks=1,
                                num_heads=2),
              "flow": dict(output_size=8, spk_embed_dim=192, vocab_size=70, n_timesteps=2),
              "hift": dict(in_channels=8, base_channels=16, nb_harmonics=1,
                           upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
                           resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]],
                           source_resblock_kernel_sizes=[3, 3],
                           source_resblock_dilation_sizes=[[1], [1]], sampling_rate=22050),
              "f0": dict(in_channels=8)}


def _tiny_models(seed=20):
    """The JAX package's tiny Chatterbox (built without its full-size
    parts) and the port's, on the same weights; both speech heads' SOS row
    zero."""
    jgen, pgen = _tiny_token2wav(seed)
    jt, pt = _t3_pair(seed)
    with numpy_init(seed):
        jv = jve.VoiceEncoder(jve.VoiceEncConfig(**VE_HP))
    pv = pve.VoiceEncoder(pve.VoiceEncConfig(**VE_HP), device="cpu")
    jv = _carry(jv, pv, seed)
    with torch.no_grad():
        pt.speech_head.weight[60] = 0.0
    jt = jt.replace(speech_head=jt.speech_head.replace(
        weight=jnp.asarray(pt.speech_head.weight.detach().numpy())))
    jm = jcb.Model.__new__(jcb.Model)
    jm.config = jcb.ModelConfig(t3_config=jt.hp)
    jm.sample_rate, jm.t3, jm.s3gen, jm.ve, jm.conds = 24000, jt, jgen, jv, None
    pm = pcb.Model(ModelConfig(t3_config=T3Config(**T3_KW)), device="cpu",
                   s3gen_sizes=TINY_SIZES)
    pm.t3, pm.s3gen, pm.ve = pt, pgen, pv
    for m in (jm, pm):
        m.set_runtime(tokenizer=FakeTok(), s3_tokenizer=FakeS3())
    return jm, pm


def tiny_port_model(seed=20):
    """The port's tiny Chatterbox alone (no JAX reference), seeded, its
    speech head's rows from SOS on zero."""
    from mlx_audio_tpu_torch.nn.module import init_weights

    pm = pcb.Model(ModelConfig(t3_config=T3Config(**T3_KW)), device="cpu", seed=seed,
                   s3gen_sizes=TINY_SIZES)
    pm.s3gen.flow.decoder.MEL_CHANNELS = 8
    pm.ve = init_weights(pve.VoiceEncoder(pve.VoiceEncConfig(**VE_HP), device="cpu"),
                         torch.Generator().manual_seed(seed))
    with torch.no_grad():
        pm.t3.speech_head.weight[60:] = 0.0
    pm.set_runtime(tokenizer=FakeTok(), s3_tokenizer=FakeS3())
    return pm


def test_runtime_lives_on_the_instance():
    """The tokenizers and the S3Tokenizer belong to the model they were set
    on: not its parameters nor its state dict, freed with it, and never
    seen by another model (a class-level table keyed by id() handed them
    to a later model at the same address)."""
    import gc
    import weakref

    pm = tiny_port_model()
    keys = set(pm.state_dict())
    s3 = S3TokenizerV2(config=S3Config(**S3TOK), device="cpu")
    pm.set_runtime(s3_tokenizer=s3)
    assert pm._s3_tokenizer() is s3 and set(pm.state_dict()) == keys
    assert not any(p is q for p in pm.parameters() for q in s3.parameters())
    gone = weakref.ref(s3)
    del pm, s3
    gc.collect()
    assert gone() is None
    fresh = pcb.Model(ModelConfig(t3_config=T3Config(**T3_KW)), device="cpu",
                      s3gen_sizes=TINY_SIZES)
    with pytest.raises(RuntimeError, match="S3Tokenizer"):
        fresh._s3_tokenizer()
    with pytest.raises(RuntimeError, match="tokenizer not initialized"):
        fresh.text_ids("Hello.")


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's flow noise and HiFT source draws replaced by the JAX
    package's (PRNGKey(42); the request key's second half), the JAX
    package's resampler by scipy's (the port's), and its CAM++, flow,
    HiFT, voice encoder and perceiver compiled (it calls them eagerly)."""
    from mlx_audio_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    key = {}

    def flow_noise(self, shape, device, generator=None):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(42), shape)))

    def hift_draws(self, B, T, device, generator=None):
        return sine_draws(self, B, T, key["hift"])

    for cls in (jve.VoiceEncoder, jt3.Perceiver):
        monkeypatch.setattr(cls, "__call__", jax.jit(cls.__call__))
    monkeypatch.setattr(ps.ConditionalCFM, "initial_noise", flow_noise)
    monkeypatch.setattr(ps.SineGen, "draws", hift_draws)
    for cls, static in ((js.CAMPPlus, ()), (js.HiFTGenerator, ()),
                        (js.CausalMaskedDiffWithXvec,
                         ("finalize", "n_timesteps", "streaming", "meanflow"))):
        monkeypatch.setattr(cls, "inference", jax.jit(cls.inference, static_argnames=static))
    return key


def test_generate_end_to_end(jax_draws):
    """`Model.generate` on a 2 s reference: the conditioning, T3's CFG
    decode at the argmax settings (at most 10 tokens), the flow and HiFT;
    the waveform within 1e-4 of the peak of the JAX package's."""
    jm, pm = _tiny_models()
    ref = np.random.default_rng(21).standard_normal(48000).astype(np.float32) * 0.1
    seed = 3
    jax_draws["hift"] = jax.random.split(jax.random.PRNGKey(seed))[1]
    kw = dict(ref_audio=ref, audio_prompt_sr=24000, max_new_tokens=10, seed=seed, **ARGMAX)
    want = list(jm.generate("hi there", **kw))
    got = list(pm.generate("hi there", **kw))
    assert len(got) == len(want) == 1
    assert got[0].token_count == want[0].token_count
    assert got[0].samples == want[0].samples > 0
    _close(got[0].audio, want[0].audio, bar=WAV_BAR)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TEXTS = ["The quick brown fox jumps over the lazy dog.", "Hello world, it's 42!",
         "Wait... what: yes; no - maybe?", "café naïve ok", "  spaced   out  "]


def test_tokenizer_reader_against_tokenizers(tmp_path):
    """A character-level BPE with the `Whitespace` pre-tokenizer and no
    decoder, trained here by `tokenizers`: EnTokenizer and MTLTokenizer
    read by the port equal the JAX package's (which calls `tokenizers`),
    [SPACE] and [UNK] included; and chip_smoke's stand-in file reads
    alike in both."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    specials = ["[STOP]", "[UNK]", "[SPACE]", "[START]", "[PAD]", "[SEP]", "[CLS]", "[MASK]",
                "[en]", "[fr]"]
    trainer = trainers.BpeTrainer(vocab_size=160, special_tokens=specials, show_progress=False)
    tok.train_from_iterator(TEXTS[:3] * 20 + ["the lazy brown fox jumps"] * 5, trainer)
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    stand_in = _chip_smoke().write_chatterbox_tokenizer(tmp_path / "stand_in.json")
    for p in (path, stand_in):
        pe, je = ptok.EnTokenizer(p), jtok.EnTokenizer(p)
        pm, jm = ptok.MTLTokenizer(p), jtok.MTLTokenizer(p)
        for text in TEXTS:
            ids = pe.text_to_tokens(text)
            np.testing.assert_array_equal(ids, je.text_to_tokens(text))
            assert pe.decode(ids) == je.decode(ids)
            np.testing.assert_array_equal(pm.text_to_tokens(text, language_id="fr"),
                                          jm.text_to_tokens(text, language_id="fr"))
        assert pe.encode("ö").tolist() == [[pe.tokenizer.token_to_id("[UNK]")]]


def _tiny_s3gen_factory(monkeypatch):
    """Both packages' Model build the tiny S3Gen where they would build the
    published one (the tests' checkpoints hold the tiny one)."""
    def port(device=None, seed=0, sizes=None):
        m = ps.S3Token2Wav(device=device, seed=seed, sizes=TINY_SIZES)
        m.flow.decoder.MEL_CHANNELS = 8
        return m

    monkeypatch.setattr(pcb, "S3Token2Wav", port)
    monkeypatch.setattr(jcb, "S3Token2Wav", jax_token2wav)


def _seeded_upstream(tmp_path, t3_kw, seed=30):
    """A port Chatterbox (the published voice encoder, a small T3, the tiny
    S3Gen) with a small S3TokenizerV2, written in the release's layout. The
    speech head's rows from SOS on are zero, so the decode takes codes to
    its cap."""
    pm = pcb.Model(ModelConfig(t3_config=T3Config(**t3_kw)), device="cpu", seed=seed,
                   s3gen_sizes=TINY_SIZES)
    pm.s3gen.flow.decoder.MEL_CHANNELS = 8
    with torch.no_grad():
        pm.t3.speech_head.weight[t3_kw["start_speech_token"]:] = 0.0
    s3tok = S3TokenizerV2(config=S3Config(**S3TOK), device="cpu", seed=seed + 1)
    src = _chip_smoke().write_chatterbox_upstream(tmp_path / "release", pm, s3tok)
    return pm, s3tok, src


LOAD_T3 = dict(T3_KW, text_tokens_dict_size=704, speaker_embed_size=256)


def test_load_model_on_a_seeded_directory(tmp_path, monkeypatch):
    """The release's files through the family's `convert` and
    `utils.load_model`: every parameter the in-memory model's, the
    tokenizer and the S3Tokenizer read from the directory, and `generate`
    the in-memory model's samples; without an S3Tokenizer it raises."""
    from mlx_audio_tpu_torch.tts.models.chatterbox.convert import convert
    from mlx_audio_tpu_torch.utils import load_model

    _tiny_s3gen_factory(monkeypatch)
    pm, s3tok, src = _seeded_upstream(tmp_path, LOAD_T3)
    out = convert(str(src), str(tmp_path / "native"),
                  model_config={"t3_config": {k: v for k, v in LOAD_T3.items()}})
    assert (out / "s3tokenizer" / "config.json").exists()
    w = load_weight_files(out)
    assert "ve.lstm.0.Wx" in w and "t3.tfmr.layers.0.mlp.up_proj.weight" in w
    assert not any("embed_tokens" in k or k.startswith("s3gen.tokenizer") for k in w)
    lm = load_model(str(out), device="cpu")
    want = flatten_params(pm)
    for k, v in flatten_params(lm).items():
        if k != "t3.tfmr.embed_tokens.weight":  # unused, and not in a checkpoint
            np.testing.assert_array_equal(v, want[k])
    pm.set_runtime(tokenizer=ptok.EnTokenizer(src / "tokenizer.json"), s3_tokenizer=s3tok)
    ref = np.random.default_rng(31).standard_normal(40000).astype(np.float32) * 0.1
    kw = dict(ref_audio=ref, audio_prompt_sr=16000, max_new_tokens=6, seed=2, **ARGMAX)
    got = list(lm.generate("Hello world.", **kw))[0]
    ref_run = list(pm.generate("Hello world.", **kw))[0]
    np.testing.assert_array_equal(got.audio, ref_run.audio)
    assert got.token_count == ref_run.token_count > 0
    bare = pcb.Model(ModelConfig(t3_config=T3Config(**LOAD_T3)), device="cpu",
                     s3gen_sizes=TINY_SIZES)
    with pytest.raises(RuntimeError, match="S3Tokenizer"):
        bare.prepare_conditionals(ref, 16000)


INT4_T3 = dict(T3_KW, llama_overrides=dict(hidden_size=64, num_hidden_layers=2,
                                           intermediate_size=128, num_attention_heads=4,
                                           num_key_value_heads=4, head_dim=16),
               speaker_embed_size=256)


def test_int4_by_convert_and_the_jax_packages_own(tmp_path, monkeypatch):
    """int4 g64 by the port's `convert --quantize` (T3's Llama layers only):
    the prompt's and every decode step's logits within 1e-5 of the peak of
    the float port on the dequantized weights, the argmax tokens identical;
    and the JAX package's `convert --quantize` of the same release files,
    loaded by its `load_model`, decodes the same tokens."""
    from mlx_audio_tpu.tts.models.chatterbox.convert import convert as jconvert
    from mlx_audio_tpu.utils import load_model as jload
    from mlx_audio_tpu_torch.tts.models.chatterbox.convert import convert
    from mlx_audio_tpu_torch.utils import load_model

    _tiny_s3gen_factory(monkeypatch)
    pm, s3tok, src = _seeded_upstream(tmp_path, INT4_T3, seed=32)
    mc = {"t3_config": dict(INT4_T3)}
    out = convert(str(src), str(tmp_path / "int4"), quantize=True, model_config=mc)
    q4 = load_model(str(out), device="cpu")
    assert type(q4.t3.tfmr.layers[0].mlp.down_proj).__name__ == "QuantizedLinear"
    assert type(q4.t3.speech_head).__name__ == "Linear"
    deq = pcb.Model(ModelConfig(t3_config=T3Config(**INT4_T3)), device="cpu",
                    s3gen_sizes=TINY_SIZES)
    load_weights(deq, deq.sanitize(dequantize_weights(load_weight_files(out), 4, 64)),
                 strict=False)
    jc, pc = _cond_pair(dim=256, seed=33)
    text = np.array([[5, 3, 4, 7, 9, 0]])

    def run(model, cond, codes=None):
        rows, taken = [], []
        it = iter(codes) if codes is not None else None

        def sampler(logits, gen):
            rows.append(logits[0].numpy().copy())
            tok = int(logits[0].argmax()) if it is None else next(it)
            taken.append(tok)
            return torch.tensor([tok])

        with torch.inference_mode():
            emb = model.t3.build_prefill_embeds(cond, text, cfg_on=True)
            model.t3.decode(emb, 12, 0.8, 1.0, 0.05, 1.2, 0.5, 0, sampler)
        return rows, taken

    rows4, codes = run(q4, pc)
    _, pc = _cond_pair(dim=256, seed=33)
    rowsd, _ = run(deq, pc, codes)
    for a, b in zip(rows4, rowsd):
        _close(a, b)
    assert [int(r.argmax()) for r in rowsd] == codes

    with numpy_init(34):
        jout = jconvert(str(src), str(tmp_path / "jax-int4"), quantize=True, model_config=mc)
        jm = jload(str(jout))
    want = jm.t3.inference(jc, text, max_new_tokens=12, cfg_weight=0.5,
                           key=jax.random.PRNGKey(0), top_p=1.0, **{
                               k: v for k, v in ARGMAX.items() if k != "top_p"})
    _, pc = _cond_pair(dim=256, seed=33)
    got = q4.t3.inference(pc, text, max_new_tokens=12, cfg_weight=0.5, seed=0, **ARGMAX)
    np.testing.assert_array_equal(got, want)
