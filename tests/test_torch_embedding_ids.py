"""Ids past a lookup table, or negative, in the port against the JAX
package's gather: a negative id counts from the end once, then every id is
clamped into the table, so the rows read are the JAX package's. On the card
an unclamped id would be a device-side assert that ends the process's CUDA
context.

Each table the port reads by id: `Embedding`, `QuantizedEmbedding` (the
packed rows, scales and biases gathered before the dequantize), SNAC's
codebooks, Qwen3-TTS's code-predictor frame (the talker's codec table
and the code predictor's), Spark's semantic codebook
(`FactorizedVectorQuantize`) and its LLM's table, the codebooks under an
EnCodec-driven Vocos's features, AdaLayerNorm's bandwidth columns, and
IndexTTS's four tables and its GPT's one-row `wpe`, Chatterbox T3's four
tables (and the decode step's learned speech position), the CosyVoice2
and CosyVoice3 LMs' tables (the prompt's sos and task rows included) and
Chatterbox-Turbo T3's, at ids -20, -1, N and N + 90, and the S3Gen and
CosyVoice3 flows, which clip their token ids into the table (0 .. N - 1)
as the JAX package does. A scan of the
port's sources holds every other direct read of a `.weight` by id to the
clamp.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.nn import layers as jl
from mlx_audio_tpu.nn import quantized as jq
from mlx_audio_tpu_torch.codec.models.snac.snac import VectorQuantize
from mlx_audio_tpu_torch.nn import Embedding, load_jax_params
from mlx_audio_tpu_torch.nn import quantized as pq

ROOT = Path(__file__).resolve().parents[1]


def _ids(n):
    return np.array([[-20, -1, n, n + 90], [3, n - 1, 0, -n]], np.int64)


def _jax_rows(table, ids):
    return np.asarray(jnp.asarray(table)[jnp.asarray(ids)])


@pytest.mark.parametrize("n", [10, 64])
def test_embedding_reads_the_jax_rows(n):
    rng = np.random.default_rng(n)
    w = rng.standard_normal((n, 8)).astype(np.float32)
    emb = Embedding(n, 8, device="cpu")
    load_jax_params(emb, {"weight": w})
    ids = _ids(n)
    with torch.no_grad():
        got = emb(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, _jax_rows(w, ids))


def test_the_jax_gather_wraps_once_then_clamps():
    """The rule itself, on a 10-row table: 5, -1, -20, 100, 10 read rows 5,
    9, 0, 9, 9."""
    w = np.arange(10, dtype=np.float32)[:, None]
    ids = np.array([5, -1, -20, 100, 10])
    np.testing.assert_array_equal(_jax_rows(w, ids)[:, 0], [5, 9, 0, 9, 9])
    emb = Embedding(10, 1, device="cpu")
    load_jax_params(emb, {"weight": w})
    with torch.no_grad():
        np.testing.assert_array_equal(emb(torch.from_numpy(ids)).numpy()[:, 0], [5, 9, 0, 9, 9])


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_embedding_reads_the_jax_rows(bits):
    n, d = 40, 128
    rng = np.random.default_rng(bits)
    jemb = jl.Embedding(n, d)
    jemb.weight = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    jqe = jq.QuantizedEmbedding.from_embedding(jemb, group_size=64, bits=bits)
    pqe = pq.QuantizedEmbedding(n, d, group_size=64, bits=bits, device="cpu")
    load_jax_params(pqe, {"weight": np.asarray(jqe.weight), "scales": np.asarray(jqe.scales),
                          "biases": np.asarray(jqe.biases)})
    ids = _ids(n)
    with torch.no_grad():
        got = pqe(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(jqe(jnp.asarray(ids))), atol=1e-6)


def test_snac_codebook_reads_the_jax_rows():
    n = 32
    rng = np.random.default_rng(1)
    vq = VectorQuantize(8, n, 4, device="cpu")
    w = rng.standard_normal((n, 4)).astype(np.float32)
    load_jax_params(vq.codebook, {"weight": w})
    ids = _ids(n)
    with torch.no_grad():
        got = vq.decode_code(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, _jax_rows(w, ids))


def test_qwen3_tts_code_predictor_frame_reads_the_jax_rows():
    """The frame's first codec embedding and the code predictor's tables:
    an id past the talker's codec table gives the frame of the row the JAX
    package reads."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
    from test_torch_qwen3_tts import CFG

    model = Model(CFG, device="cpu", seed=3)
    talker = model.talker
    cp = talker.code_predictor
    G = talker.config.num_code_groups
    n = talker.model.codec_embedding.weight.shape[0]
    j = torch.arange(G + 2)
    cos, sin = cp.model.rope(j[None])
    tri = torch.where(j[None, :] <= j[:, None], 0.0, float("-inf"))
    hidden = torch.randn(1, talker.config.hidden_size, generator=torch.Generator().manual_seed(0))

    def frame(c0):
        caches = cp.model.make_caches(1, G + 2)
        with torch.inference_mode():
            return model._code_predictor_frame(
                hidden, torch.tensor([c0]), None, model._stacked_heads(), caches,
                (cos, sin, tri), (0.0, 0, 1.0))

    for c0 in (-20, -1, n, n + 90):
        row = int(_jax_rows(np.arange(n), np.array(c0)))
        codes, emb = frame(c0)
        want_codes, want_emb = frame(row)
        torch.testing.assert_close(emb, want_emb, rtol=0, atol=0)
        torch.testing.assert_close(codes[1:], want_codes[1:], rtol=0, atol=0)


def test_spark_semantic_codebook_and_llm_table_read_the_jax_rows():
    """BiCodec's `FactorizedVectorQuantize.detokenize` reads `codebook.weight`
    by id (the JAX package indexes it directly, which clamps); Spark's LLM
    reads its table through `Embedding`."""
    from mlx_audio_tpu_torch.tts.models.spark import FactorizedVectorQuantize, Model

    n = 24
    vq = FactorizedVectorQuantize(4, n, 4, device="cpu")  # no projection: rows as read
    w = np.random.default_rng(2).standard_normal((n, 4)).astype(np.float32)
    load_jax_params(vq.codebook, {"weight": w})
    ids = _ids(n)
    with torch.no_grad():
        np.testing.assert_array_equal(vq.detokenize(torch.from_numpy(ids)).numpy(),
                                      _jax_rows(w, ids))
    spark = Model({"llm": dict(hidden_size=16, num_hidden_layers=1, intermediate_size=32,
                               num_attention_heads=2, num_key_value_heads=1,
                               vocab_size=n)}, device="cpu")
    table = spark.llm.model.embed_tokens
    with torch.no_grad():
        np.testing.assert_array_equal(table(torch.from_numpy(ids)).numpy(),
                                      _jax_rows(table.weight.numpy(), ids))


def test_vocos_encodec_features_and_bandwidth_ids_read_the_jax_rows():
    """An EnCodec-driven Vocos's features sum each codebook's row of a code
    (clamped), and an AdaLayerNorm reads the clamped id's column."""
    from mlx_audio_tpu_torch.codec.models import Encodec
    from mlx_audio_tpu_torch.codec.models.vocos.vocos import AdaLayerNorm, EncodecFeatures

    enc = Encodec(dict(target_bandwidths=[15.0, 30.0], num_filters=4, hidden_size=8,
                       upsampling_ratios=[4, 2], codebook_size=16, codebook_dim=8,
                       num_lstm_layers=1), device="cpu", seed=1)
    fe = EncodecFeatures(enc, bandwidths=[15.0, 30.0])
    n = 16
    books = [layer.codebook.embed.detach().numpy() for layer in enc.quantizer.layers[:2]]
    ids = _ids(n)
    codes = np.stack([ids[:, :2], ids[:, 2:]])  # (nq = 2, B = 2, T = 2)
    want = sum(_jax_rows(b, c) for b, c in zip(books, codes))
    np.testing.assert_array_equal(fe.get_features_from_codes(torch.from_numpy(codes)).numpy(),
                                  want)
    ada = AdaLayerNorm(4, 6, device="cpu")
    w = np.random.default_rng(3).standard_normal((6, 4)).astype(np.float32)
    load_jax_params(ada, {"scale.weight": w, "scale.bias": np.zeros(6, np.float32),
                          "shift.weight": w, "shift.bias": np.zeros(6, np.float32)})
    x = torch.zeros(4, 1, 6)
    with torch.no_grad():
        for bw in (-20, -1, 4, 94):
            got = ada._affine(ada.scale, torch.tensor([bw])).numpy()
            np.testing.assert_array_equal(got, _jax_rows(w.T, np.array([bw])))
        assert ada(x, torch.tensor([0, 9, -9, 3])).shape == (4, 1, 6)


@pytest.mark.parametrize("table", ["text_embedding", "text_pos_embedding", "mel_embedding",
                                   "mel_pos_embedding", "gpt.wpe"])
def test_indextts_tables_read_the_jax_rows(table):
    """IndexTTS reads its text and mel tables and their position tables
    through the embeddings' calls (the JAX package indexes `.weight`
    directly, which clamps), and its GPT's one-row `wpe` at every decode
    position (row 0 for all)."""
    from mlx_audio_tpu_torch.tts.models.indextts import Model

    from test_indextts import tiny_args

    model = Model(tiny_args(), device="cpu")
    emb = model.get_submodule(table)
    w = emb.weight.detach().numpy()
    n = w.shape[0]
    ids = _ids(n)
    with torch.no_grad():
        np.testing.assert_array_equal(emb(torch.from_numpy(ids)).numpy(), _jax_rows(w, ids))


@pytest.mark.parametrize("table", ["text_emb", "speech_emb", "text_pos_emb.emb",
                                   "speech_pos_emb.emb"])
def test_chatterbox_t3_tables_read_the_jax_rows(table):
    """T3 reads its text and speech tables and their learned position tables
    through the embeddings' calls (the JAX package indexes `.weight`
    directly, which clamps): the decode step's speech position and the
    fixed bos position too."""
    from mlx_audio_tpu_torch.nn.module import init_weights
    from mlx_audio_tpu_torch.tts.models.chatterbox import T3, T3Config

    from test_chatterbox import TINY_LLAMA

    t3 = T3(T3Config(text_tokens_dict_size=50, speech_tokens_dict_size=70,
                     start_speech_token=60, stop_speech_token=61, max_speech_tokens=64,
                     speaker_embed_size=16, llama_overrides=TINY_LLAMA), device="cpu")
    init_weights(t3, torch.Generator().manual_seed(4))
    emb = t3.get_submodule(table)
    w = emb.weight.detach().numpy()
    n = w.shape[0]
    ids = _ids(n)
    with torch.no_grad():
        np.testing.assert_array_equal(emb(torch.from_numpy(ids)).numpy(), _jax_rows(w, ids))
        if table == "speech_pos_emb.emb":
            for step in (-21, -2, n - 1, n + 89):  # the step's position is step + 1
                got = t3.step_embedding(torch.tensor([3]), step) - t3.speech_emb(
                    torch.tensor([3]))
                np.testing.assert_allclose(got.numpy()[0], _jax_rows(w, np.array(step + 1)),
                                           atol=1e-6)
            np.testing.assert_array_equal(t3.speech_pos_emb.get_fixed_embedding(n + 5)[0, 0],
                                          _jax_rows(w, np.array(n + 5)))


def test_s3gen_flow_clips_its_token_ids():
    """The flow clips ids into 0 .. N - 1 before its lookup, as the JAX
    package does (-1 reads row 0 there, not the last): ids -20, -1, N and
    N + 90 give the mel of ids 0, 0, N - 1 and N - 1."""
    from mlx_audio_tpu_torch.codec.models import s3gen as ps

    from test_torch_s3gen import EST, ENC

    cfm = ps.CausalConditionalCFM(estimator=ps.ConditionalDecoder(**EST, device="cpu"))
    cfm.MEL_CHANNELS = 8
    flow = ps.CausalMaskedDiffWithXvec(input_size=16, output_size=8, vocab_size=70,
                                       n_timesteps=1, decoder=cfm, device="cpu",
                                       encoder=ps.UpsampleConformerEncoder(**ENC, device="cpu"))
    for p in flow.parameters():
        p.data.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(5))
    n = 70

    def mel(tokens):
        with torch.no_grad():
            return flow.inference(torch.tensor([tokens]), torch.tensor([4]),
                                  torch.tensor([[1, 2]]), torch.tensor([2]),
                                  torch.zeros(1, 4, 8), torch.ones(1, 192))[0]

    np.testing.assert_array_equal(mel([-20, -1, n, n + 90]).numpy(),
                                  mel([0, 0, n - 1, n - 1]).numpy())


def _cosyvoice_lm(v3: bool):
    from mlx_audio_tpu_torch.nn.module import init_weights
    from mlx_audio_tpu_torch.tts.models.cosyvoice2.llm import Qwen2LM
    from mlx_audio_tpu_torch.tts.models.cosyvoice3.llm import CosyVoice3LM

    if v3:
        from test_cosyvoice3 import tiny_config
    else:
        from test_cosyvoice2 import tiny_config
    lm = (CosyVoice3LM if v3 else Qwen2LM)(tiny_config().llm, device="cpu")
    return init_weights(lm, torch.Generator().manual_seed(6))


@pytest.mark.parametrize("v3,table", [(False, "llm_embedding"), (False, "speech_embedding"),
                                      (True, "speech_embedding")])
def test_cosyvoice_lm_tables_read_the_jax_rows(v3, table):
    """The CosyVoice LMs read their tables through the embeddings' calls (the
    JAX package indexes `.weight` for the prompt's sos and task rows and the
    decode step's token): the prompt's rows are the tables' rows, and ids
    past a table read the JAX rows."""
    lm = _cosyvoice_lm(v3)
    emb = lm.get_submodule(table)
    w = emb.weight.detach().numpy()
    ids = _ids(w.shape[0])
    with torch.no_grad():
        np.testing.assert_array_equal(emb(torch.from_numpy(ids)).numpy(), _jax_rows(w, ids))
        if table != "speech_embedding" or v3:
            prompt = lm.build_prompt_embeds(np.array([1, 2]), None, np.array([[3]]))[0]
            sos, task = (lm.sos, lm.task_id) if v3 else (lm.sos_eos, lm.task_id)
            np.testing.assert_array_equal(prompt[0].numpy(), w[sos])
            np.testing.assert_array_equal(prompt[3].numpy(), w[task])


@pytest.mark.parametrize("table", ["text_emb", "speech_emb", "tfmr.wpe"])
def test_chatterbox_turbo_tables_read_the_jax_rows(table):
    """T3Turbo reads its text and speech tables and GPT-2's positions through
    the embeddings' calls (the JAX package indexes `.weight` for the decode
    step's token)."""
    from mlx_audio_tpu_torch.nn.module import init_weights
    from mlx_audio_tpu_torch.tts.models.chatterbox_turbo import T3Turbo

    from test_chatterbox_turbo import tiny_cfg

    t3 = init_weights(T3Turbo(tiny_cfg(), device="cpu"), torch.Generator().manual_seed(7))
    emb = t3.get_submodule(table)
    w = emb.weight.detach().numpy()
    ids = _ids(w.shape[0])
    with torch.no_grad():
        np.testing.assert_array_equal(emb(torch.from_numpy(ids)).numpy(), _jax_rows(w, ids))


def test_cosyvoice3_flow_clips_its_token_ids():
    """CosyVoice3's flow clips ids into 0 .. N - 1 before its lookup, as the
    JAX package does: ids -20, -1, N and N + 90 give the mel of ids 0, 0,
    N - 1 and N - 1."""
    from mlx_audio_tpu_torch.tts.models.cosyvoice3 import build_cosyvoice3

    from test_cosyvoice3 import tiny_config

    flow = build_cosyvoice3(tiny_config(), device="cpu").flow
    for p in flow.parameters():
        p.data.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(8))
    n = flow.vocab_size
    noise = torch.randn(1, 12, 16, generator=torch.Generator().manual_seed(9))

    def mel(tokens):
        with torch.no_grad():
            return flow.inference(torch.tensor([tokens]), torch.tensor([4]),
                                  torch.tensor([[1, 2]]), torch.tensor([2]),
                                  torch.zeros(1, 4, 16), torch.ones(1, 8), noise=noise)[0]

    np.testing.assert_array_equal(mel([-20, -1, n, n + 90]).numpy(),
                                  mel([0, 0, n - 1, n - 1]).numpy())


_DIRECT_READ = re.compile(r"\.(weight|embedding)\[(?!:|\.\.\.)")


def test_no_unclamped_table_read_left_in_the_port():
    """Every direct read of a table by id in the port clamps its ids (the
    JAX package's rows), on its line or the line before; a lookup through
    an `Embedding`'s own call clamps in `forward`."""
    found = []
    for path in sorted((ROOT / "mlx_audio_tpu_torch").rglob("*.py")):
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines, 1):
            # the clamp on the read's line, or on the line that makes its ids
            if _DIRECT_READ.search(line) and "clamp" not in line + lines[i - 2]:
                found.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not found, "\n".join(found)
