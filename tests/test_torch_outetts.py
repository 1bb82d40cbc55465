"""OuteTTS in the port against the JAX package on the CPU: a two-layer
Llama at hidden 128 with Llama-3.2-1B's tied embeddings and llama3 rope, over
the vocabulary `chip_smoke.write_tokenizer_json(style="outetts")` writes
(Llama-3's 128,256 plus OuteTTS's 3,370 added tokens), and a tiny 24 kHz DAC
with 2 codebooks of 1024.

The seeded weights plant a greedy path (`chip_smoke.plant_outetts`: the
head is tied, so layer 0's MLP maps each token's embedding onto its
successor's): from the prompt's last token, 6 c1/c2 pairs, <|c1_1024|>
among them (one past the codebook: the DAC clamps it), then <|audio_end|>.

The JAX package reads the same tokenizer.json through `transformers`; the
port through its own reader. Bars: prompts, token maps and greedy tokens
identical; audio within 1e-5 of the peak (float32); speaker features and
`create_speaker` codes identical; streamed chunks equal to the JAX
package's streamed chunks, their tokens the non-streamed tokens; the
batcher's tokens equal the direct loop's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mlx_audio_tpu.codec.models.descript.dac import DAC as JaxDAC
from mlx_audio_tpu.lm import generate as jgen
from mlx_audio_tpu.lm import sample as jsample
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu.tts.models.outetts import Model as JaxOute
from mlx_audio_tpu.tts.models.outetts.prompt_processor import PromptProcessor as JaxPP
from mlx_audio_tpu_torch import convert as pconvert
from mlx_audio_tpu_torch import utils as putils
from mlx_audio_tpu_torch.codec.models import DAC
from mlx_audio_tpu_torch.lm.generate import generate_tokens
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.module import flatten_params as pflat
from mlx_audio_tpu_torch.serving import get_infer_hook
from mlx_audio_tpu_torch.tokenizer_json import load as load_tok
from mlx_audio_tpu_torch.tts.models.outetts import Model
from mlx_audio_tpu_torch.tts.models.outetts.prompt_processor import PromptProcessor

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-5
TIMEOUT = 300
FRAMES = 6
CFG = dict(model_type="llama", hidden_size=128, num_hidden_layers=2, intermediate_size=256,
           num_attention_heads=4, num_key_value_heads=2, vocab_size=131626,
           tie_word_embeddings=True, rope_theta=500000.0,
           rope_scaling={"factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192, "rope_type": "llama3"})
DAC_CFG = dict(encoder_dim=8, encoder_rates=[2, 4], decoder_dim=32, decoder_rates=[4, 2],
               n_codebooks=2, codebook_size=1024, codebook_dim=4, sample_rate=24000)
TEXT = "Hello world."
GREEDY = dict(temperature=0.0, max_tokens=40)
SPEAKER = {"text": "the quick fox", "words": [
    {"word": "the", "duration": 0.2, "features": {"energy": 10, "spectral_centroid": 20,
                                                  "pitch": 30}, "c1": [1, 2], "c2": [3, 4]},
    {"word": "quick", "duration": 0.31, "features": {}, "c1": [1024, 5], "c2": [6, 7]},
    {"word": "fox", "duration": 0.4, "c1": [8], "c2": [9]}]}


def _reset():
    for cls in (Model, JaxOute):
        cls._tokenizer = cls._codec = cls._prompt_processor = None


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    """(the port's reader, `transformers` on the same file, its directory)."""
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("outetts-tok")
    path = cs.write_tokenizer_json(d, "outetts")
    return load_tok(path), PreTrainedTokenizerFast(tokenizer_file=str(path)), d


@pytest.fixture(scope="module")
def pair(toks):
    """(JAX model, port model, JAX DAC, port DAC, the planted path), each
    model's tokenizer and DAC set by `set_runtime` (reset after the module)."""
    tok, hf, _ = toks
    path = cs.outetts_path(tok, FRAMES)
    nl = tok.encode("\n", add_special_tokens=False)[-1]
    succ = {nl: path[0], tok.token_to_id("<|word_start|>"): path[0]}
    succ.update(zip(path, path[1:]))
    pm = cs.plant_outetts(Model(CFG, device="cpu"), succ)
    with numpy_init():
        jm = JaxOute(dict(CFG))
        jdac = JaxDAC(**DAC_CFG)
    jm = load_weights(jm, {k: jnp.asarray(v) for k, v in pflat(pm).items()})
    pdac = DAC(**DAC_CFG, device="cpu")
    load_jax_params(pdac, {k: np.asarray(v) for k, v in flatten_params(jdac).items()})
    jm.set_runtime(tokenizer=hf, codec=jdac)
    pm.set_runtime(tokenizer=tok, codec=pdac)
    yield jm, pm, jdac, pdac, path
    _reset()


def _ref_audio(seconds=1.0, seed=5):
    t = np.arange(int(24000 * seconds)) / 24000
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(t.size)
            ).astype(np.float32)


def test_prompts_and_token_maps(toks):
    tok, hf, _ = toks
    pp, jpp = PromptProcessor(tok), JaxPP(hf)
    assert len(pp.c1) == len(pp.c2) == 1025
    assert pp.c1 == jpp.c1 and pp.c2 == jpp.c2
    for text, speaker in (("Hello “world” – ok…", None), ("General Kenobi", SPEAKER),
                          ("日本語のテキスト", dict(SPEAKER, text="音声"))):
        prompt = pp.get_completion_prompt(text, speaker)
        assert prompt == jpp.get_completion_prompt(text, speaker)
        assert tok.encode(prompt, add_special_tokens=False) == hf.encode(
            prompt, add_special_tokens=False)
    codes = [tok.token_to_id(t) for t in ("<|c1_1024|>", "<|c2_3|>", "<|c1_5|>", "<|c2_7|>")]
    assert pp.extract_audio_from_tokens(codes + [5]) == [[1024, 5], [3, 7]]


def test_greedy_tokens_are_the_planted_path(pair):
    jm, pm, _, _, path = pair
    ids = pm.tokenizer.encode(pm.prompt_processor.get_completion_prompt(TEXT),
                              add_special_tokens=False)
    kw = dict(max_tokens=40, repetition_penalty=1.1, repetition_context_size=64,
              eos_token_ids=(path[-1],))
    with torch.inference_mode():
        got, n = generate_tokens(pm, ids, **kw)
    want, jn = jgen.generate_tokens(jm, jnp.asarray(ids, jnp.int32),
                                    sampler=jsample.make_sampler(0.0), **kw)
    assert n == jn == len(path)
    assert got[0].tolist() == np.asarray(want)[0].tolist() == path


def test_generate_audio(pair):
    jm, pm, _, _, _ = pair
    want = list(jm.generate(TEXT, **GREEDY))
    got = list(pm.generate(TEXT, **GREEDY))
    assert len(got) == len(want) == 1
    assert got[0].token_count == want[0].token_count == 2 * FRAMES + 1
    g, w = got[0].audio, np.asarray(want[0].audio)
    assert g.shape == w.shape == (FRAMES * 8,)
    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * np.abs(w).max())


def test_speaker_features_and_create_speaker(pair, tmp_path):
    """The pitch and the 0-100 features equal the JAX package's; a speaker
    made from 1 s of reference audio (DAC codes split over its words) equals
    the JAX package's, round-trips through save/load, and conditions
    `generate` as in the JAX package."""
    jm, pm, _, _, _ = pair
    ref = _ref_audio()
    np.testing.assert_array_equal(Model.calculate_pitch(ref, 24000),
                                  JaxOute.calculate_pitch(ref, 24000))
    assert Model.extract_audio_features(ref, 24000) == JaxOute.extract_audio_features(ref, 24000)
    text = "a seeded reference line"
    sp = pm.create_speaker(ref, text)
    assert sp == jm.create_speaker(ref, text)
    assert sum(len(w["c1"]) for w in sp["words"]) == 24000 // 8
    p = tmp_path / "speakers" / "ref.json"
    pm.save_speaker(sp, str(p))
    assert pm.load_speaker(str(p)) == sp
    got = list(pm.generate(TEXT, voice=str(p), **GREEDY))
    want = list(jm.generate(TEXT, voice=str(p), **GREEDY))
    assert got[0].token_count == want[0].token_count == 2 * FRAMES + 1
    np.testing.assert_allclose(got[0].audio, np.asarray(want[0].audio), rtol=0,
                               atol=ATOL * np.abs(np.asarray(want[0].audio)).max())
    with pytest.raises(ValueError, match="does not download"):
        pm.get_speaker("en-female-1-neutral")


def test_streamed_equals_the_jax_stream(pair):
    """stream=True at 0.03 s (4 tokens a chunk): each chunk (the re-decoded
    prefix's new samples) equals the JAX package's; the streamed tokens
    add up to the non-streamed run's (but its last) and the samples to its
    length."""
    jm, pm, _, _, _ = pair
    kw = dict(GREEDY, stream=True, streaming_interval=0.03)
    got = list(pm.generate(TEXT, **kw))
    want = list(jm.generate(TEXT, **kw))
    whole = list(pm.generate(TEXT, **GREEDY))[0]
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.token_count == w.token_count
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), rtol=0, atol=ATOL)
    # <|audio_end|> adds no samples, so no chunk carries it
    assert sum(g.token_count for g in got) == whole.token_count - 1
    assert sum(g.samples for g in got) == whole.samples


def test_batcher_route_and_four_prompts(pair):
    """`generate` through an installed LMContinuousBatcher gives the direct
    route's audio; four prompts entering the path at different tokens, in
    one wave, each give the direct loop's tokens."""
    _, pm, _, _, path = pair
    direct = list(pm.generate(TEXT, **GREEDY))[0]
    ids = pm.tokenizer.encode(pm.prompt_processor.get_completion_prompt(TEXT),
                              add_special_tokens=False)
    prompts = [ids + [path[k]] for k in (0, 3, 6, 9)]
    b = pm.make_batcher(slots=4, max_len=128).install()
    try:
        assert get_infer_hook(pm) is b
        served = list(pm.generate(TEXT, **GREEDY))[0]
        futs = [b.submit(p, max_tokens=40, eos_ids=(path[-1],), repetition_penalty=1.1)
                for p in prompts]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        b.close()
    np.testing.assert_allclose(served.audio, direct.audio, rtol=0, atol=ATOL)
    for p, out in zip(prompts, outs):
        with torch.inference_mode():
            want, _ = generate_tokens(pm, p, max_tokens=40, repetition_penalty=1.1,
                                      eos_token_ids=(path[-1],))
        assert out == want[0].tolist() == path[path.index(p[-1]) + 1:]


def test_create_speaker_from_whisper(pair):
    """The port's Whisper (seeded, tiny decoder) transcribes the reference
    with word timestamps; the speaker made from its words equals the JAX
    package's `create_speaker_from_dict` on the same words and audio."""
    from mlx_audio_tpu_torch.stt.models.whisper import Model as Whisper
    from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer

    jm, pm, _, _, _ = pair
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                n_audio_layer=1, n_vocab=51866, n_text_ctx=448, n_text_state=64,
                n_text_head=2, n_text_layer=1)
    whisper = Whisper(dims, device="cpu")
    seen = []

    class Stt:
        def generate(self, wav16, word_timestamps=False):
            seen.append(len(wav16))
            return whisper.generate(wav16, tokenizer=DummyTokenizer(n_vocab=51866),
                                    language="en", temperature=0.0, sample_len=12,
                                    word_timestamps=word_timestamps)

    ref = _ref_audio(2.0, seed=6)
    sp = pm.create_speaker_from_whisper(ref, Stt())
    assert seen == [32000]
    result = Stt().generate(putils.resample_audio(ref, 24000, 16000), word_timestamps=True)
    words = [{"word": str(w["word"]).strip(), "start": float(w["start"]),
              "end": float(w["end"])} for s in result.segments for w in s.get("words", [])]
    want = (jm.create_speaker_from_dict({"audio": ref, "text": result.text, "words": words})
            if words else jm.create_speaker(ref, result.text))
    assert sp == want


def test_load_model_from_a_directory(pair, toks, tmp_path):
    """A checkpoint directory named for OuteTTS whose config says `llama`
    (Llama-OuteTTS's own) resolves to OuteTTS, reads tokenizer.json and
    dac/ from the directory, and generates the in-memory model's audio; a
    hub tokenizer raises."""
    import shutil

    _, pm, _, pdac, _ = pair
    d = tmp_path / "llama-outetts-1.0-1b"
    pconvert.save_model(d, pflat(pm), dict(CFG))
    pconvert.save_model(d / "dac", pflat(pdac), dict(DAC_CFG))
    shutil.copy(toks[2] / "tokenizer.json", d / "tokenizer.json")
    want = list(pm.generate(TEXT, **GREEDY))[0].audio
    saved = Model._tokenizer, Model._codec
    _reset()
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):  # the card by default
            putils.load_model(str(d))
        loaded = putils.load_model(str(d), device="cpu")
        assert type(loaded) is Model and loaded.device.type == "cpu"
        got = list(loaded.generate(TEXT, **GREEDY))[0].audio
        assert Model._codec is not None and Model._codec is not pdac
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        _reset()
        bare = Model(CFG, device="cpu")
        with pytest.raises(ValueError, match="does not download"):
            bare.tokenizer
    finally:
        _reset()
        pm.set_runtime(tokenizer=saved[0], codec=saved[1])
