"""Sesame/CSM in the port against the JAX package on the CPU at
`tests/test_parity_csm.py`'s sizes (K = 4 codebooks of 35, text vocabulary
60, backbone 32 wide, depth decoder 16 wide, Llama-3 rope): codebook-0 and
depth-decoder logits, greedy frames, the chunked loop against the
monolithic one, a planted EOS, `sanitize` on the upstream names, `generate`
with ref_audio + ref_text (watermark off and on, streamed, voice_match off),
and the `tokenizer.json` template.

Bars: float32 logits 1e-5 on values of O(1); greedy frames identical;
waveforms 1e-5 absolute (the Mimi decode of identical codes). With the
watermark on, the JAX package resamples with its native C resampler where
that is built, the port with scipy's `resample_poly`: the two differ in the
last bits, so watermarked audio agrees to 1e-5 absolute (measured ~1e-7 on
samples of O(0.1)), and `verify` finds the key in both. Sampled frames come
from a torch generator, so they match the JAX package's only in
distribution; the tests hold them to the chunked loop's and to themselves.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models.mimi import mimi as jmimi
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu.tts.models.sesame import sesame as jses
from mlx_audio_tpu.tts.models.sesame import watermarking as jwm
from mlx_audio_tpu_torch.codec.models.mimi import mimi as pmimi
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.tts.models.sesame import sesame as pses
from mlx_audio_tpu_torch.tts.models.sesame import watermarking as pwm

import chip_smoke as cs
from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-5
K, V, TEXT_V = 4, 35, 60
ROPE_SCALING = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
CFG = dict(text_vocab_size=TEXT_V, audio_vocab_size=V, audio_num_codebooks=K,
           hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=8, rope_theta=500000.0,
           rope_scaling=ROPE_SCALING, vocab_size=TEXT_V,
           depth_decoder_config=dict(num_codebooks=K, vocab_size=V, backbone_hidden_size=32,
                                     hidden_size=16, intermediate_size=32,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     num_key_value_heads=2, head_dim=8, rope_theta=500000.0,
                                     max_position_embeddings=K + 2))


def moved(jm, rng, scale=0.1):
    """Every constant-initialised parameter moved off its constant (norms,
    the zero audio_head; Mimi's codebooks, usages and layer scales)."""
    flat = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v, np.float32)
        if v.size and np.all(v == v.flat[0]):
            noise = rng.standard_normal(v.shape).astype(np.float32)
            if k.endswith("audio_head"):
                noise *= 3.0  # logits of O(1) over the 16-wide decoder
            v = v + (scale * np.abs(noise) if k.endswith("cluster_usage") else scale * noise)
        flat[k] = v
    return load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})


def csm_pair(seed=0):
    with numpy_init(seed):
        jm = moved(jses.Model(jses.ModelConfig.from_dict(CFG)), np.random.default_rng(seed))
    pm = pses.Model(CFG, device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm, pm


def mimi_cfg(mod):
    """Mimi at 24 kHz / 12.5 Hz (1920 samples a frame, the published
    ratios) with a few channels, K codebooks of V (the CSM's codes index
    them), a 2-layer transformer with context 8."""
    return mod.MimiConfig(
        seanet=mod.SeanetConfig(dimension=16, nfilters=4),
        transformer=mod.TransformerConfig(d_model=16, num_heads=2, num_layers=2,
                                          dim_feedforward=32, context=8),
        quantizer_nq=K, quantizer_bins=V, quantizer_dim=8)


def mimi_pair(seed=1):
    with numpy_init(seed):
        jm = moved(jmimi.Mimi(mimi_cfg(jmimi)), np.random.default_rng(seed))
    pm = pmimi.Mimi(mimi_cfg(pmimi), device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm, pm


class Tok:
    """A character tokenizer inside the tiny text vocabulary, with the
    template's bos and eos."""

    def encode(self, text, **kw):
        return [1] + [(ord(c) % 50) + 5 for c in text] + [2]


@pytest.fixture(scope="module")
def pair():
    return csm_pair()


@pytest.fixture(scope="module")
def runtime(pair):
    """Both packages' class-level runtime (tokenizer and Mimi) set for the
    module, and cleared after it."""
    jm, pm = pair
    jmi, pmi = mimi_pair()
    jm.set_runtime(text_tokenizer=Tok(), mimi=jmi)
    pm.set_runtime(text_tokenizer=Tok(), mimi=pmi)
    yield jmi, pmi
    jses.Model._text_tokenizer = jses.Model._mimi = None
    pses.Model._text_tokenizer = pses.Model._mimi = None


def _prompt(T=7, seed=3):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((1, T, K + 1), np.int64)
    mask = np.zeros((1, T, K + 1), bool)
    tokens[0, :3, -1] = rng.integers(1, TEXT_V, 3)
    mask[0, :3, -1] = True
    tokens[0, 3:, :K] = rng.integers(0, V, (T - 3, K))
    mask[0, 3:, :K] = True
    return tokens, mask


_jit_embed_hidden = jax.jit(lambda m, t, k: m.backbone(m.embed_frames(t, k))[0])


def test_codebook0_and_depth_decoder_logits(pair):
    """The backbone's codebook-0 logits over a mixed text / audio prompt,
    and the depth decoder's logits at every codebook of a teacher-forced
    frame: the JAX model's within 1e-5."""
    jm, pm = pair
    tokens, mask = _prompt()
    jh = _jit_embed_hidden(jm.model, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask))
    jlog = np.asarray(jm.model.codebook0_head(jh))
    with torch.no_grad():
        ph, _ = pm.model.backbone(pm.model.embed_frames(torch.from_numpy(tokens),
                                                        torch.from_numpy(mask)))
        plog = pm.model.codebook0_head(ph).numpy()
    np.testing.assert_allclose(plog, jlog, rtol=0, atol=ATOL)
    assert np.abs(jlog).max() > 0.1

    codes = np.random.default_rng(4).integers(0, V, K - 1)
    h0 = np.asarray(jh[:, -1])
    jemb = [jnp.asarray(h0)] + [jm.model.audio_embeddings(jnp.asarray([c + i * V]))
                                for i, c in enumerate(codes)]
    jdec, _ = jm.model.decoder(jm.model.projection(jnp.stack(jemb, axis=1)))
    jl = np.stack([np.asarray(jdec[0, p] @ jm.model.audio_head[p - 1]) for p in range(1, K)])
    with torch.no_grad():
        pemb = [torch.from_numpy(h0)] + [pm.model.audio_embeddings(torch.tensor([c + i * V]))
                                         for i, c in enumerate(codes)]
        pdec, _ = pm.model.decoder(pm.model.projection(torch.stack(pemb, dim=1)))
        pl = torch.stack([pdec[0, p] @ pm.model.audio_head[p - 1] for p in range(1, K)])
    np.testing.assert_allclose(pl.numpy(), jl, rtol=0, atol=ATOL)
    assert np.abs(jl).max() > 0.1


def _jax_frames(jm, tokens, mask, n, sampler=None):
    caches = jm.model.make_backbone_caches(1, tokens.shape[1] + n + 1)
    h, caches = jses._prefill(jm.model, caches, jnp.asarray(tokens, jnp.int32),
                              jnp.asarray(mask))
    frames, m = jses._generate_frames(jm.model, caches, h, jax.random.PRNGKey(0), n, 0.0, 0,
                                      sampler)
    return np.asarray(frames)[0, :int(m)]


def _port_setup(pm, tokens, mask, n, seed=0):
    caches = pm.model.make_backbone_caches(1, tokens.shape[1] + n + 1)
    h = pses._prefill(pm.model, caches, torch.from_numpy(tokens), torch.from_numpy(mask))
    gen = torch.Generator()
    gen.manual_seed(seed)
    return caches, h, gen


@torch.inference_mode()
def _port_frames(pm, tokens, mask, n, temp=0.0, top_k=0, sampler=None, seed=0):
    caches, h, gen = _port_setup(pm, tokens, mask, n, seed)
    frames, m = pses._generate_frames(pm.model, caches, h, gen, n, temp, top_k, sampler)
    return frames[0, :m].numpy()


def test_greedy_frames_identical(pair):
    """Ten greedy frames of the direct loop: the JAX loop's, code for code
    (no EOS among them, so the poll windows run whole)."""
    jm, pm = pair
    tokens, mask = _prompt()
    jf = _jax_frames(jm, tokens, mask, 10)
    pf = _port_frames(pm, tokens, mask, 10)
    assert pf.shape == jf.shape == (10, K)
    np.testing.assert_array_equal(pf, jf)
    assert len(np.unique(pf)) > 4


@torch.inference_mode()
@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.9, 8)])
def test_chunked_frames_equal_monolithic(pair, temp, top_k):
    """Eleven frames in chunks of 3 (the last cut by the budget) equal the
    monolithic loop's with the same seed, greedy and sampled; sampled
    frames stay inside each codebook's top-k support."""
    _, pm = pair
    tokens, mask = _prompt()
    mono = _port_frames(pm, tokens, mask, 11, temp, top_k, seed=5)
    caches, h, gen = _port_setup(pm, tokens, mask, 11, seed=5)
    got, budget = [], 11
    while budget:
        frames, n, h, done = pses._generate_frames_chunk(pm.model, caches, h, gen, budget, 3,
                                                         temp, top_k)
        assert n == min(3, budget) and not done
        got.append(frames[0, :n].numpy())
        budget -= n
    np.testing.assert_array_equal(np.concatenate(got), mono)
    assert mono.shape == (11, K) and (mono < V).all()


class PlantedEOS:
    """Greedy codes, except that every codebook of frame `at` is 0 (an
    all-zero frame: EOS). Counts its calls: K a frame."""

    def __init__(self, at):
        self.at, self.calls = at, 0

    def __call__(self, logits, generator):
        frame = self.calls // K
        self.calls += 1
        out = torch.argmax(logits, dim=-1)
        return torch.zeros_like(out) if frame == self.at else out


@torch.inference_mode()
def test_planted_eos(pair):
    """A planted all-zero frame ends both loops: the monolithic loop keeps
    the 5 frames before it (greedy ones) although it computes on to its
    poll; the chunked loop stops in the chunk that drew it, with done set.
    An EOS at the first frame gives no frames in the port and in the JAX
    loop alike."""
    jm, pm = pair
    tokens, mask = _prompt()
    greedy = _port_frames(pm, tokens, mask, 12)
    planted = PlantedEOS(5)
    got = _port_frames(pm, tokens, mask, 12, sampler=planted)
    np.testing.assert_array_equal(got, greedy[:5])
    assert planted.calls == 8 * K  # on to the first poll, after frame 8

    caches, h, gen = _port_setup(pm, tokens, mask, 12)
    planted = PlantedEOS(5)
    frames, n, h, done = pses._generate_frames_chunk(pm.model, caches, h, gen, 12, 4, 0.0, 0,
                                                     planted)
    assert (n, done) == (4, False)
    frames, n, h, done = pses._generate_frames_chunk(pm.model, caches, h, gen, 8, 4, 0.0, 0,
                                                     planted)
    assert (n, done) == (1, True)
    np.testing.assert_array_equal(frames[0, :1].numpy(), greedy[4:5])

    zeros_j = jax.jit(lambda lg, key: jnp.zeros(lg.shape[:-1], jnp.int32))
    assert _jax_frames(jm, tokens, mask, 6, sampler=zeros_j).shape == (0, K)
    assert _port_frames(pm, tokens, mask, 6, sampler=PlantedEOS(0)).shape == (0, K)


def test_sanitize_upstream_names(pair):
    """An upstream-named state dict (`chip_smoke`'s writer of phase 14's
    checkpoint: attn / output_proj / w1-w3 / sa_norm / mlp_norm / .scale,
    no `model.` prefix, the raw audio_head): the port's
    `sanitize` equals the JAX package's and loads strictly into the same
    parameters."""
    jm, _ = pair
    src = {k: np.asarray(v) for k, v in flatten_params(jm).items()}
    sd = {cs.csm_upstream_key(k): v for k, v in src.items()}
    assert "backbone.layers.0.attn.output_proj.weight" in sd
    assert "decoder.layers.1.mlp.w3.weight" in sd and "backbone.norm.scale" in sd
    pm = pses.Model(CFG, device="cpu")
    ours, theirs = pm.sanitize(sd), jm.sanitize(sd)
    assert sorted(ours) == sorted(theirs) == sorted(src)
    load_jax_params(pm, ours)
    from mlx_audio_tpu_torch.nn.module import flatten_params as pflat

    for k, v in pflat(pm).items():
        np.testing.assert_array_equal(v, src[k], err_msg=k)


REF_TEXT = "a reference"
TEXT = "hello there"


def _ref_audio(frames=3, seed=9):
    return (0.2 * np.random.default_rng(seed).standard_normal(1920 * frames)
            ).astype(np.float32)


def _generate(model, **kw):
    kw = dict(dict(ref_audio=_ref_audio(), ref_text=REF_TEXT, temperature=0.0,
                   max_audio_length_ms=8 * 80, apply_watermark=False), **kw)
    return list(model.generate(TEXT, **kw))


def test_generate_ref_audio_and_text(pair, runtime):
    """`generate` with ref_audio + ref_text (the reference Mimi-encoded),
    greedy, 8 frames: the JAX model's audio within 1e-5, watermark off;
    with it on, within 1e-5 again (the resamplers differ in the last bits),
    and `verify` finds the key in the port's output and not in the
    unmarked audio."""
    jm, pm = pair
    (jr,), (pr,) = _generate(jm), _generate(pm)
    assert pr.token_count == jr.token_count == 8
    assert pr.samples == jr.samples == 8 * 1920 and pr.sample_rate == 24000
    np.testing.assert_allclose(pr.audio, np.asarray(jr.audio), rtol=0, atol=ATOL)
    assert np.abs(pr.audio).max() > 1e-3
    (jw,), (pw,) = _generate(jm, apply_watermark=True), _generate(pm, apply_watermark=True)
    np.testing.assert_allclose(pw.audio, np.asarray(jw.audio), rtol=0, atol=ATOL)
    assert np.abs(pw.audio - pr.audio).max() > 1e-4  # the mark is there
    key = pwm.CSM_1B_GH_WATERMARK
    assert pwm.verify(pwm.load_watermarker(), pw.audio, 24000, key)
    assert jwm.verify(jwm.load_watermarker(), pw.audio, 24000, key)
    assert not pwm.verify(pwm.load_watermarker(), pr.audio, 24000, key)


def test_generate_streamed_and_context(pair, runtime):
    """stream=True at 0.16 s (2 frames a chunk): four chunks whose frames
    are the monolithic decode's, and whose audio is the JAX stream's within
    1e-5 (both decode through the Mimi streaming decoder); voice_match off
    with two context segments: the JAX model's audio within 1e-5."""
    jm, pm = pair
    jmi, pmi = runtime
    seen = []
    step = pmi.decode_step
    pmi.decode_step = lambda codes, state: (seen.append(np.asarray(codes)), step(codes,
                                                                                 state))[1]
    try:
        chunks = _generate(pm, stream=True, streaming_interval=0.16)
    finally:
        del pmi.decode_step
    jchunks = _generate(jm, stream=True, streaming_interval=0.16)
    assert [c.token_count for c in chunks] == [c.token_count for c in jchunks] == [2] * 4
    for c, jc in zip(chunks, jchunks):
        np.testing.assert_allclose(c.audio, np.asarray(jc.audio), rtol=0, atol=ATOL)
    tokens, mask = _ref_tokens(pm)
    mono = _port_frames(pm, tokens, mask, 8)
    np.testing.assert_array_equal(np.concatenate(seen, axis=-1)[0].T, mono)

    ctx = [pses.Segment(speaker=0, text=REF_TEXT, audio=_ref_audio()),
           pses.Segment(speaker=1, text="another", audio=_ref_audio(2, seed=10))]
    jctx = [jses.Segment(speaker=s.speaker, text=s.text, audio=s.audio) for s in ctx]
    (pr,) = _generate(pm, ref_audio=None, ref_text=None, context=ctx, voice_match=False)
    (jr,) = _generate(jm, ref_audio=None, ref_text=None, context=jctx, voice_match=False)
    np.testing.assert_allclose(pr.audio, np.asarray(jr.audio), rtol=0, atol=ATOL)


def _ref_tokens(pm):
    seg = pses.Segment(speaker=0, text=(REF_TEXT + " " + TEXT).strip(), audio=_ref_audio())
    t, m = pm._tokenize_segment(seg, add_eos=False)
    return t[None], m[None]


def test_hub_routes_raise(pair, runtime):
    """A named voice needs the hub's speaker prompts, and no reference at
    all is refused, as in the JAX package."""
    _, pm = pair
    with pytest.raises(ValueError, match="hub"):
        list(pm.generate(TEXT, voice="conversational_a"))
    with pytest.raises(ValueError, match="hub"):
        pm.default_speaker_prompt("conversational_b")
    with pytest.raises(ValueError, match="requires a reference"):
        list(pm.generate(TEXT))


def test_text_tokenizer_template_from_the_directory(tmp_path, monkeypatch):
    """A checkpoint directory's Llama-3 style `tokenizer.json` and
    `tokenizer_config.json`: the port encodes `bos $A eos` as the JAX
    package's AutoTokenizer with its template does; `config.text_tokenizer`
    naming a directory wins over the checkpoint's."""
    pytest.importorskip("transformers")

    # no tokenizer set by set_runtime (the module's runtime fixture sets one)
    monkeypatch.setattr(pses.Model, "_text_tokenizer", None)
    monkeypatch.setattr(jses.Model, "_text_tokenizer", None)

    d = tmp_path / "ckpt"
    d.mkdir()
    cs.write_tokenizer_json(d, "llama3")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
        "tokenizer_class": "PreTrainedTokenizerFast"}))
    pm = pses.Model(CFG, device="cpu")
    pm.config.model_path = str(d)
    jm = jses.Model(jses.ModelConfig.from_dict(dict(CFG, text_tokenizer=str(d))))
    for text in ("[0]The quick brown fox.", "[1]jumps over"):
        ids = pm.text_tokenizer.encode(text)
        assert ids == list(jm.text_tokenizer.encode(text))
        assert ids[0] == 128000 and ids[-1] == 128001
    other = tmp_path / "other"
    other.mkdir()
    (other / "tokenizer.json").write_text((d / "tokenizer.json").read_text())
    (other / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|start_header_id|>", "eos_token": "<|eot_id|>"}))
    pm.config.text_tokenizer = str(other)
    ids = pm.text_tokenizer.encode("hi")
    assert ids[0] == 128006 and ids[-1] == 128009
    pm.config.model_path, pm.config.text_tokenizer = str(tmp_path / "none"), None
    with pytest.raises(RuntimeError, match="set_runtime"):
        pm.text_tokenizer
