"""Spark-TTS in the port against the JAX package on the CPU at tiny widths:
FSQ and residual FSQ round trips, the factorized VQ (a semantic id past the
codebook reads its last row), the speaker encoder, BiCodec `tokenize` and
`detokenize`, `load_bicodec` on the published layout, the prompts, and
greedy `generate` on a planted path through both routes (control, and a
voice clone on Wav2Vec2 features), directly and through the installed
`LMContinuousBatcher`, from a checkpoint directory loaded by
`utils.load_model`.

The seeded LLM plants a greedy path (`chip_smoke.spark_succ` and
`plant_outetts` on the tied Qwen2 LM): <|end_style_label|> → N_GLOBAL
global tokens → N_SEMANTIC semantic tokens → the eos; the clone prompt's
<|end_global_token|> leads onto the same semantic path. The tokenizer is
`chip_smoke.write_tokenizer_json(style="spark")`'s, read by the port's
reader and by `transformers` for the JAX side. float32 bar: 1e-5 of each
output's peak; tokens, codes and their counts identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu.stt.models.wav2vec import wav2vec as jw
from mlx_audio_tpu.tts.models.spark import spark as jsp
from mlx_audio_tpu_torch.nn import flatten_params as pflat
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.tokenizer_json import load as load_tok
from mlx_audio_tpu_torch.tts.models.spark import spark as psp

from test_spark_checkpoint import TINY_CFG, _to_reference_layout
from test_torch_vocos import _close
from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

BC = TINY_CFG["audio_tokenizer"]
N_GLOBAL = BC["speaker_encoder"]["token_num"]  # 4
N_SEMANTIC = 12
BASE_VOCAB = 300
LLM = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, tie_word_embeddings=True)
# a Wav2Vec2 wide enough for BiCodec's 16 input channels and deep enough for
# the 11th, 14th and 16th hidden states, at 320 samples a frame
W2V = dict(model_type="wav2vec2", vocab_size=0, hidden_size=16, num_hidden_layers=16,
           num_attention_heads=2, intermediate_size=32, conv_dim=[8, 8], conv_stride=[5, 64],
           conv_kernel=[10, 64], num_conv_pos_embeddings=6, num_conv_pos_embedding_groups=2,
           feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True)
TEXT = "Hello world."


def _jax_bicodec():
    return jsp.BiCodec(
        encoder=jsp.FeatEncoder(**BC["encoder"]), decoder=jsp.WaveGenerator(**BC["decoder"]),
        quantizer=jsp.FactorizedVectorQuantize(**BC["quantizer"]),
        speaker_encoder=jsp.SpeakerEncoder(**BC["speaker_encoder"]),
        prenet=jsp.FeatDecoder(**BC["prenet"]), postnet=jsp.FeatDecoder(**BC["postnet"]),
        mel_params=dict(sample_rate=16000, n_fft=256, hop_length=80, win_length=160,
                        num_mels=128, fmin=10))


@pytest.fixture(scope="module")
def bicodecs():
    """(JAX BiCodec, port BiCodec) on the same weights, every constant moved
    (BatchNorm's running statistics, the perceiver's latents, the norms)."""
    with numpy_init():
        jbc = _moved(_jax_bicodec(), np.random.default_rng(1))
    flat = {k: np.asarray(v) for k, v in flatten_params(jbc).items()}
    for k in [k for k in flat if k.endswith("running_var")]:
        flat[k] = np.abs(flat[k]) + 0.5
    jbc = load_weights(jbc, {k: jnp.asarray(v) for k, v in flat.items()})
    pbc = psp.BiCodec.from_config(BC, device="cpu")
    load_jax_params(pbc, flat)
    return jbc, pbc


def test_fsq_and_residual_fsq():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 7, 3)).astype(np.float32) * 2
    jf, pf = jsp.FSQ([4, 5, 3]), psp.FSQ([4, 5, 3])
    q = pf.quantize(torch.from_numpy(z))
    _close(q.numpy(), jf.quantize(jnp.asarray(z)))
    idx = pf.codes_to_indices(q)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jf.codes_to_indices(jnp.asarray(q))))
    np.testing.assert_allclose(pf.indices_to_codes(idx).numpy(), q.numpy(), atol=1e-6)
    with numpy_init():
        jr = jsp.ResidualFSQ(levels=[4, 4, 4], num_quantizers=2, dim=8)
    pr = psp.ResidualFSQ(levels=[4, 4, 4], num_quantizers=2, dim=8, device="cpu")
    load_jax_params(pr, {k: np.asarray(v) for k, v in flatten_params(jr).items()})
    x = rng.standard_normal((1, 6, 8)).astype(np.float32)
    with torch.no_grad():
        out, idx = pr(torch.from_numpy(x))
        back = pr.get_output_from_indices(idx)
    jout, jidx = jr(jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(out.numpy(), jout)
    _close(back.numpy(), out.numpy(), bar=1e-4)


def test_factorized_vq_reads_clamped_rows():
    with numpy_init():
        jq = jsp.FactorizedVectorQuantize(input_dim=16, codebook_size=32, codebook_dim=8)
    pq = psp.FactorizedVectorQuantize(input_dim=16, codebook_size=32, codebook_dim=8,
                                      device="cpu")
    jq = _moved(jq, np.random.default_rng(2))
    load_jax_params(pq, {k: np.asarray(v) for k, v in flatten_params(jq).items()})
    z = np.random.default_rng(3).standard_normal((2, 10, 16)).astype(np.float32)
    with torch.no_grad():
        idx = pq.tokenize(torch.from_numpy(z))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jq.tokenize(jnp.asarray(z))))
        ids = np.array([[0, 31, 32, 40, -1, -40]])
        _close(pq.detokenize(torch.from_numpy(ids)).numpy(), jq.detokenize(jnp.asarray(ids)))


def test_speaker_encoder(bicodecs):
    jbc, pbc = bicodecs
    mels = np.random.default_rng(4).standard_normal((1, 40, 128)).astype(np.float32)
    with torch.no_grad():
        x_vec, latent = pbc.speaker_encoder.speaker_encoder(torch.from_numpy(mels), True)
        jx, jl = jax.jit(lambda m, x: m(x, True))(jbc.speaker_encoder.speaker_encoder,
                                                    jnp.asarray(mels))
        _close(x_vec.numpy(), jx)
        _close(latent.numpy(), jl)
        idx = pbc.speaker_encoder.tokenize(torch.from_numpy(mels))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.jit(
            lambda m, x: m.tokenize(x))(jbc.speaker_encoder, jnp.asarray(mels))))
        _close(pbc.speaker_encoder.detokenize(idx).numpy(), jax.jit(
            lambda m, i: m.detokenize(i))(jbc.speaker_encoder, jnp.asarray(idx.numpy())))
        with pytest.raises(RuntimeError):  # not token_num tokens: the projection refuses
            pbc.speaker_encoder.detokenize(idx[:, :-1])
    with pytest.raises(TypeError):
        jbc.speaker_encoder.detokenize(jnp.asarray(idx.numpy()[:, :-1]))


def test_bicodec_tokenize_and_detokenize(bicodecs):
    jbc, pbc = bicodecs
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((1, 20, 16)).astype(np.float32)
    ref = (rng.standard_normal((1, 1600)) * 0.1).astype(np.float32)
    sem, glob = pbc.tokenize(feat, ref)
    jsem, jglob = jax.jit(lambda m, f, r: m.tokenize(f, r))(jbc, jnp.asarray(feat),
                                                           jnp.asarray(ref))
    np.testing.assert_array_equal(sem.numpy(), np.asarray(jsem))
    np.testing.assert_array_equal(glob.numpy(), np.asarray(jglob))
    semantic = rng.integers(0, 32, (1, 6))
    wav = pbc.detokenize(semantic, glob.numpy())
    assert wav.shape == (1, 6 * 2 * 8)
    _close(wav.numpy(), jax.jit(lambda m, s, g: m.detokenize(s, g))(
        jbc, jnp.asarray(semantic), jglob))


def test_load_bicodec_published_layout(bicodecs, tmp_path):
    """The published layout (weight-norm pairs, Sequential wrappers, the wave
    generator's flat list, channels-first Snake alphas, the FSQ buffers; the
    JAX package's test_spark_checkpoint writes it, and holds its own
    `load_bicodec` to it) loads to the same parameters."""
    import yaml

    from mlx_audio_tpu_torch.safetensors_io import save_file

    ours = {k: np.asarray(v) for k, v in flatten_params(bicodecs[0]).items()}
    ref = _to_reference_layout(ours, n_rates=len(BC["decoder"]["rates"]))
    ref["speaker_encoder.quantizer.layers.0._levels"] = np.asarray([4, 4], np.int32)
    save_file({k: np.ascontiguousarray(v) for k, v in ref.items()},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(TINY_CFG))
    got = pflat(psp.load_bicodec(tmp_path, device="cpu"))
    assert set(got) == set(ours)
    for k, v in got.items():
        np.testing.assert_allclose(np.asarray(v), ours[k], rtol=2e-5, atol=2e-6, err_msg=k)


# ---- the model ----


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("spark-tok")
    path = cs.write_tokenizer_json(d, "spark", n_merges=40, base=BASE_VOCAB, n_global=16,
                                   n_semantic=32)
    hf = PreTrainedTokenizerFast(tokenizer_file=str(path), eos_token=cs.SPARK_EOS)
    return load_tok(path), hf, path


@pytest.fixture(scope="module")
def w2v_dir(tmp_path_factory):
    """A tiny Wav2Vec2 encoder directory, as Spark ships XLSR-53."""
    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.stt.models.wav2vec import Model as W2VModel

    d = tmp_path_factory.mktemp("w2v") / "wav2vec2-large-xlsr-53"
    with numpy_init():
        jm = _moved(jw.Model(jw.ModelConfig.from_dict(W2V)), np.random.default_rng(7))
    pm = W2VModel(W2V, device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    save_model(d, pflat(pm), W2V)
    return d


@pytest.fixture(scope="module")
def spark(toks, bicodecs, w2v_dir, tmp_path_factory):
    """(JAX model, port model loaded by `utils.load_model` from a written
    checkpoint directory, the planted succession), each with its runtime."""
    from mlx_audio_tpu_torch.utils import load_model

    tok, hf, tok_path = toks
    jbc, pbc = bicodecs
    llm = dict(LLM, vocab_size=tok.get_vocab_size())
    succ, glob, sem = cs.spark_succ(tok, N_GLOBAL, N_SEMANTIC)
    src = psp.Model({"llm": llm}, device="cpu", seed=8)
    cs.plant_outetts(src.llm, succ)
    d = tmp_path_factory.mktemp("ckpt") / "Spark-TTS-tiny"
    cs.write_spark_dir(d, llm, {k[len("llm."):]: v for k, v in pflat(src).items()}, BC,
                       pflat(pbc), W2V, pflat(psp.SparkWav2VecFeatures(w2v_dir, "cpu").model),
                       tok_path)
    pm = load_model(str(d), device="cpu")
    assert type(pm).__module__ == psp.__name__
    with numpy_init():
        jm = jsp.Model({"llm": llm})
    jm = load_weights(jm, {k: jnp.asarray(np.asarray(v)) for k, v in pflat(src).items()})
    jm.set_runtime(tokenizer=hf, bicodec=jbc, feature_extractor=jsp.SparkWav2VecFeatures(w2v_dir))
    return jm, pm, glob, sem


def test_prompts(spark, toks):
    jm, pm, _, _ = spark
    assert pm.process_prompt_control(TEXT, "male", "high", "low") == \
        jm.process_prompt_control(TEXT, "male", "high", "low")
    g, s = np.arange(4), np.arange(5)
    for args in ((TEXT, g), (TEXT, g, s, "Ref text.")):
        p = pm.process_prompt(*args)
        assert p == jm.process_prompt(*args)
        assert toks[0].encode(p) == toks[1].encode(p)


def test_control_route_greedy(spark):
    """The planted path: N_GLOBAL global tokens, N_SEMANTIC semantic ones,
    then the eos; the waveform within the bar, directly and through the
    installed batcher."""
    jm, pm, glob, sem = spark
    got = list(pm.generate(TEXT, temperature=0.0, pitch=1.5, speed=0.4))
    want = list(jm.generate(TEXT, temperature=0.0, pitch=1.5, speed=0.4))
    assert got[0].token_count == want[0].token_count == N_SEMANTIC
    assert got[0].samples == N_SEMANTIC * 2 * 8
    _close(got[0].audio, want[0].audio)
    b = pm.make_batcher(slots=2, max_len=256).install()
    try:
        served = list(pm.generate(TEXT, temperature=0.0, pitch=1.5, speed=0.4))
        assert b.dispatch_count > 0
    finally:
        b.close()
    np.testing.assert_allclose(served[0].audio, got[0].audio, rtol=0, atol=1e-6)


def test_clone_route_greedy(spark):
    """A voice clone: the reference's semantic tokens from the Wav2Vec2
    features and its global tokens from the fixed-length clip, identical in
    both packages; then (no reference text: the prompt ends at
    <|end_global_token|>) the planted semantic path, the waveform within
    the bar."""
    jm, pm, _, _ = spark
    ref = (np.random.default_rng(9).standard_normal(4000) * 0.1).astype(np.float32)
    rt = pm._resolve_runtime()
    sem, glob = pm._reference_tokens(rt, rt["bicodec"], ref)
    wav = ref.reshape(1, -1)
    jfeat = jm._resolve_runtime()["feature_extractor"](wav)
    _close(rt["feature_extractor"](wav).numpy(), jfeat)
    jsem, jglob = jm._resolve_runtime()["bicodec"].tokenize(
        jfeat, jnp.asarray(rt["bicodec"].get_ref_clip(wav)[None]))
    np.testing.assert_array_equal(sem.numpy(), np.asarray(jsem))
    np.testing.assert_array_equal(glob.numpy(), np.asarray(jglob))
    got = list(pm.generate(TEXT, ref_audio=ref, temperature=0.0))
    want = list(jm.generate(TEXT, ref_audio=ref, temperature=0.0))
    assert got[0].token_count == want[0].token_count == N_SEMANTIC
    _close(got[0].audio, want[0].audio)


def test_clone_without_wav2vec2_raises(spark):
    """Where no Wav2Vec2 is present the port refuses the clone; the JAX
    package tokenizes zeros there (a deliberate difference)."""
    _, pm, _, _ = spark
    fe = pm._runtime.pop("feature_extractor")
    mp, pm.config.model_path = pm.config.model_path, ""
    try:
        with pytest.raises(RuntimeError, match="Wav2Vec2"):
            list(pm.generate(TEXT, ref_audio=np.zeros(4000, np.float32), temperature=0.0))
    finally:
        pm.config.model_path = mp
        pm._runtime["feature_extractor"] = fe


def test_sanitize_prefixes_the_llm():
    m = psp.Model({"llm": dict(LLM, vocab_size=64)}, device="cpu")
    out = m.sanitize({"model.norm.weight": 1, "llm.model.embed_tokens.weight": 2,
                      "lm_head.weight": 3})
    assert out == {"llm.model.norm.weight": 1, "llm.model.embed_tokens.weight": 2}
