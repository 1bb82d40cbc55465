"""Dia in the port against the JAX package on the CPU at tiny widths (the
JAX package's `tiny_dia`: one encoder and one decoder layer, 3 channels,
delays [0, 1, 2]), float32: the delay functions identical; the encoder
output and cross K/V within 1e-5; decoder logits over a prompt and 8 steps
within 1e-5; greedy frames identical to `_generate_loop`'s, with an EOS
planted so that the cascade runs; the voice-clone prefill; `generate`'s
audio within 1e-5 through a tiny DAC given by `set_runtime`; `_split_turns`.

The JAX package masks the uncond row by its own all-pad tokens: its
cross-attention then masks every key and its logits are NaN (every CFG code
0). The port gives both rows the cond text's mask; the references here are
the JAX functions called with those masks (`_encode_text` and
`_generate_loop` take masks as arguments), and `test_jax_uncond_row_fault`
records the fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models.descript.dac import DAC as JaxDAC
from mlx_audio_tpu.lm.cache import KVCache as JaxKVCache
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu.tts.models.dia import Model as JaxDia
from mlx_audio_tpu.tts.models.dia import audio as jaudio
from mlx_audio_tpu.tts.models.dia import dia as jdia
from mlx_audio_tpu_torch.codec.models import DAC
from mlx_audio_tpu_torch.lm.cache import KVCache
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.tts.models.dia import Model
from mlx_audio_tpu_torch.tts.models.dia import audio as paudio
from mlx_audio_tpu_torch.tts.models.dia import dia as pdia

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-5
CFG = {
    "model": {
        "encoder": {"n_layer": 1, "n_embd": 32, "n_hidden": 64, "n_head": 2, "head_dim": 16},
        "decoder": {"n_layer": 1, "n_embd": 32, "n_hidden": 64, "gqa_query_heads": 4,
                    "kv_heads": 2, "gqa_head_dim": 8, "cross_query_heads": 2,
                    "cross_head_dim": 16},
        "src_vocab_size": 128, "tgt_vocab_size": 1028,
    },
    "data": {"text_length": 128, "audio_length": 128, "channels": 3,
             "delay_pattern": [0, 1, 2]},
}
DAC_CFG = dict(encoder_dim=8, encoder_rates=[2, 4], decoder_dim=32, decoder_rates=[4, 2],
               n_codebooks=3, codebook_size=1024, codebook_dim=4)
TEXT = "[S1] Hello there. [S2] Hi, how are you?"
MAX_TOKENS = 16
EOS_STEP = 4  # the planted EOS: channel 0 emits it at this step

_jencode = jax.jit(jdia._encode_text)
_jdecoder = jax.jit(lambda m, tok, pos, caches, ckv, sm, cm: m.decoder(
    tok, pos, caches, ckv, self_mask=sm, cross_mask=cm))


def _redrawn(flat: dict, rng) -> dict:
    """Every parameter redrawn: the projections and embeddings N(0, 0.1²)
    (the JAX package draws every DenseGeneral from one key), the norms 1 +
    N(0, 0.1²)."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        base = 1.0 if k.endswith("norm.weight") else 0.0
        out[k] = (base + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def _masks(src, src_mask, uncond_own_mask=False):
    """The JAX package's encoder inputs; both rows take the cond mask (the
    port's), or the uncond row its own all-pad mask (the JAX package's)."""
    S = src.shape[0]
    src2 = jnp.asarray(np.stack([np.zeros_like(src), src]))
    pos = jnp.broadcast_to(jnp.arange(S)[None], (2, S))
    first = np.zeros_like(src_mask) if uncond_own_mask else src_mask
    pmask = jnp.asarray(np.stack([first, src_mask]))
    enc = jnp.where((pmask[:, :, None] == pmask[:, None, :])[:, None], 0.0, -jnp.inf)
    cross = jnp.where(pmask[:, None, None, :], 0.0, -jnp.inf).astype(jnp.float32)
    return src2, pos, enc.astype(jnp.float32), cross


def _jax_codes(jm, text, max_tokens=MAX_TOKENS, prompt=None, temperature=0.0):
    """The JAX loop's greedy frames `buf[1:n+1]` with the port's masks; a
    delayed prompt (1, Tp, C) is prefilled first, as `Model._generate` does."""
    data, dec = jm.config.data, jm.config.model.decoder
    src, src_mask = jm._prepare_text(text)
    src2, pos, enc, cross = _masks(src, src_mask)
    _, ckv = _jencode(jm.model, src2, pos, enc)
    start = jnp.full((data.channels,), data.audio_bos_value, jnp.int32)
    start_step = 0 if prompt is None else prompt.shape[1]
    kv_len = start_step + max_tokens + max(data.delay_pattern) + 64
    caches = [JaxKVCache(2, dec.kv_heads, kv_len, dec.gqa_head_dim, dtype=jnp.float32)
              for _ in range(dec.n_layer)]
    if prompt is not None:
        full = jnp.concatenate([start[None, None], jnp.asarray(prompt)], axis=1)
        Tp = full.shape[1]
        full2 = jnp.broadcast_to(full, (2, *full.shape[1:]))
        tgt = jnp.broadcast_to(jnp.arange(Tp)[None], (2, Tp))
        _, caches = jm.model.decoder(full2[:, :-1], tgt[:, :-1], caches, ckv,
                                     self_mask=caches[0].attention_mask(Tp - 1),
                                     cross_mask=cross)
        start = full[0, -1]
    buf, n = jdia._generate_loop(
        jm.model, caches, ckv, cross, start, jnp.asarray(start_step), jax.random.PRNGKey(0),
        max_tokens, 3.0, temperature, 35, int(data.audio_eos_value),
        int(data.audio_pad_value), int(data.audio_bos_value), tuple(data.delay_pattern))
    return np.asarray(buf)[1:int(n) + 1]


def _plant_eos(pm, flat, text=TEXT):
    """Plant channel 0's EOS one step after the code c* that the unplanted
    greedy loop emits on channel 0 at step EOS_STEP - 1: c*'s channel-0
    embedding gains a large direction v, and the EOS column of channel 0's
    logits reads v. v is orthogonal to the final hidden states of the steps
    before, so those steps are unchanged."""
    load_jax_params(pm, flat)
    src, mask = pm._prepare_text(text)
    seen = []
    hook = pm.model.decoder.norm.register_forward_hook(
        lambda _m, _i, out: seen.append(out[:, -1].detach().numpy().copy()))
    try:
        codes = pm._decode_codes(src, mask, MAX_TOKENS, 3.0, 0.0, 35)
    finally:
        hook.remove()
    c_star = int(codes[EOS_STEP - 1, 0])
    assert c_star not in codes[:EOS_STEP - 1, 0]
    D = flat["model.decoder.norm.weight"].shape[0]
    H = np.concatenate(seen[:EOS_STEP]).astype(np.float64)  # (2 * EOS_STEP, D)
    v = np.random.default_rng(7).standard_normal(D)
    v -= np.linalg.pinv(H) @ (H @ v)
    v = (v / np.linalg.norm(v)).astype(np.float32)
    out = dict(flat)
    emb = out["model.decoder.embeddings.0.weight"].copy()
    emb[c_star] += 20.0 * v
    out["model.decoder.embeddings.0.weight"] = emb
    dense = out["model.decoder.logits_dense.weight"].copy()
    eos = pm.config.data.audio_eos_value
    dense[:, 0, eos] = 10.0 * v
    out["model.decoder.logits_dense.weight"] = dense
    return out


def _reset_dac():
    JaxDia._dac = None
    Model._dac = None


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model, JAX DAC, port DAC), the planted EOS in both
    models; the DACs set as the runtime codecs (reset after the module)."""
    with numpy_init():
        jm = JaxDia(CFG)
        jdac = JaxDAC(**DAC_CFG)
    rng = np.random.default_rng(0)
    flat = _redrawn(flatten_params(jm), rng)
    pm = Model(CFG, device="cpu")
    flat = _plant_eos(pm, flat)
    load_jax_params(pm, flat)
    jm = load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})
    dflat = {k: np.asarray(v) for k, v in flatten_params(jdac).items()}
    pdac = DAC(**DAC_CFG, device="cpu")
    load_jax_params(pdac, dflat)
    jm.set_runtime(dac=jdac)
    pm.set_runtime(dac=pdac)
    yield jm, pm, jdac, pdac
    _reset_dac()


def test_delay_functions():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1024, (2, 20, 4))
    delay = [0, 2, 3, 5]
    want = np.asarray(jaudio.apply_audio_delay(jnp.asarray(codes), delay, 1026, 1025))
    got = paudio.apply_audio_delay(torch.as_tensor(codes), delay, 1026, 1025).numpy()
    np.testing.assert_array_equal(got, want)
    for total in (20, 17):
        want_r = np.asarray(jaudio.revert_audio_delay(jnp.asarray(want), delay, 1025, total))
        got_r = paudio.revert_audio_delay(torch.as_tensor(got), delay, 1025, total).numpy()
        np.testing.assert_array_equal(got_r, want_r)


def test_encoder_and_cross_kv(pair):
    jm, pm, _, _ = pair
    src, mask = pm._prepare_text(TEXT)
    src2, pos, enc, _ = _masks(src, mask)
    jout, jkv = _jencode(jm.model, src2, pos, enc)
    psrc2, ppos, penc, _ = pdia._text_pair(src, mask, "cpu")
    with torch.inference_mode():
        pout, pkv = pdia._encode_text(pm.model, psrc2, ppos, penc)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    for (pk, pv), (jk, jv) in zip(pkv, jkv):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=0, atol=ATOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)


def test_decoder_logits_prompt_and_steps(pair):
    """A 5-frame prompt, then 8 single steps through float32 caches: every
    call's logits within 1e-5."""
    jm, pm, _, _ = pair
    dec, C = pm.config.model.decoder, pm.config.data.channels
    src, mask = pm._prepare_text(TEXT)
    src2, pos, enc, cross = _masks(src, mask)
    _, jkv = _jencode(jm.model, src2, pos, enc)
    psrc2, ppos, penc, pcross = pdia._text_pair(src, mask, "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 1024, (2, 13, C))
    jc = [JaxKVCache(2, dec.kv_heads, 32, dec.gqa_head_dim, dtype=jnp.float32)]
    pc = [KVCache(2, dec.kv_heads, 32, dec.gqa_head_dim, dtype=torch.float32, device="cpu")]
    with torch.inference_mode():
        _, pkv = pdia._encode_text(pm.model, psrc2, ppos, penc)
        for lo, hi in [(0, 5)] + [(t, t + 1) for t in range(5, 13)]:
            tok = toks[:, lo:hi]
            tpos = np.broadcast_to(np.arange(lo, hi)[None], (2, hi - lo))
            jl, jc = _jdecoder(jm.model, jnp.asarray(tok), jnp.asarray(tpos), jc, jkv,
                               jc[0].attention_mask(hi - lo), cross)
            pl, _ = pm.model.decoder(torch.as_tensor(tok), torch.tensor(tpos), pc, pkv,
                                     self_mask=pc[0].attention_mask(hi - lo),
                                     cross_mask=pcross)
            assert pl.dtype == torch.float32 and pl.shape == (2, hi - lo, C, 1028)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_greedy_frames_with_the_eos_cascade(pair):
    """The planted EOS fires on channel 0 at EOS_STEP; each channel then
    emits EOS at its delay and PAD after, and the loop stops at EOS_STEP +
    max_delay + 1 frames: identical to the JAX loop's."""
    jm, pm, _, _ = pair
    want = _jax_codes(jm, TEXT)
    src, mask = pm._prepare_text(TEXT)
    got = pm._decode_codes(src, mask, MAX_TOKENS, 3.0, 0.0, 35)
    data = pm.config.data
    assert got.shape == (EOS_STEP + 3, 3)
    np.testing.assert_array_equal(got, want)
    eos, pad = data.audio_eos_value, data.audio_pad_value
    assert got[EOS_STEP, 0] == eos
    assert got[EOS_STEP + 1, :2].tolist() == [pad, eos]
    assert got[-1].tolist() == [pad, pad, eos]
    # channel 1 and 2 start at BOS inside their delays
    assert got[0, 1] == got[0, 2] == got[1, 2] == data.audio_bos_value


def test_sampled_frames_follow_the_rules(pair):
    """Sampled frames (a torch generator: the JAX package's draws in
    distribution only) keep the delay forcing and the seed's determinism."""
    _, pm, _, _ = pair
    src, mask = pm._prepare_text(TEXT)
    a = pm._decode_codes(src, mask, MAX_TOKENS, 3.0, 1.3, 35, seed=3)
    b = pm._decode_codes(src, mask, MAX_TOKENS, 3.0, 1.3, 35, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a[0, 1] == a[0, 2] == a[1, 2] == pm.config.data.audio_bos_value
    eos = pm.config.data.audio_eos_value
    first = int(np.argmax(a[:, 0] == eos)) if (a[:, 0] == eos).any() else len(a)
    assert (a[:first, 0] < eos).all()


def test_voice_clone_prefill(pair):
    """A 100-frame reference, DAC-encoded in each package (identical codes),
    prefilled, then 16 greedy frames: identical. The reference is longer
    than max_delay + 64 frames, which the JAX package's own cache sizing
    does not hold (ROADMAP Queue 3): the JAX loop here gets a cache sized as
    the port's."""
    jm, pm, jdac, pdac = pair
    ref = 0.2 * np.random.default_rng(4).standard_normal(800).astype(np.float32)
    jprompt = jaudio.audio_to_codebook(jdac, jnp.asarray(ref)[None, None], jm.config.data)
    pprompt = paudio.audio_to_codebook(pdac, torch.as_tensor(ref)[None, None], pm.config.data)
    np.testing.assert_array_equal(pprompt.numpy(), np.asarray(jprompt))
    text = "[S1] Reference words. " + TEXT
    want = _jax_codes(jm, text, prompt=np.asarray(jprompt))
    src, mask = pm._prepare_text(text)
    got = pm._decode_codes(src, mask, MAX_TOKENS, 3.0, 0.0, 35, ref_audio=ref)
    np.testing.assert_array_equal(got, want)


def test_generate_audio(pair):
    """`generate` (greedy) through the tiny DAC: the JAX loop's frames,
    reverted and decoded by the JAX package's `codebook_to_audio`, within
    1e-5 of the peak."""
    jm, pm, jdac, _ = pair
    want = jaudio.codebook_to_audio(_jax_codes(jm, TEXT), jdac, [0, 1, 2], C=3)
    res = list(pm.generate(TEXT, temperature=0.0, max_tokens=MAX_TOKENS))
    assert len(res) == 1 and res[0].token_count == EOS_STEP + 3
    got = res[0].audio
    assert got.shape == want.shape == ((EOS_STEP + 1) * 8,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * np.abs(want).max())


def test_split_turns():
    texts = ["[S1] a [S2] b", "[S1] one. [S2] two. [S1] three. [S2] four. [S1] five.",
             "no speakers", "[S1]x[S2]y[S1]z[S2]w[S1]u[S2]v"]
    pm = Model(CFG, device="cpu")
    for t in texts:
        assert pm._split_turns(t) == JaxDia._split_turns(None, t)
    src, mask = pm._prepare_text("[S1] é [S2]")
    jsrc, jmask = JaxDia._prepare_text(type("M", (), {"config": pm.config})(), "[S1] é [S2]")
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(mask, jmask)


def test_jax_uncond_row_fault(pair):
    """The JAX package's own masks (the uncond row masked by its all-pad
    tokens) leave every cross-attention key of the uncond row masked: its
    logits are NaN. The port's masks give finite logits for both rows."""
    jm, pm, _, _ = pair
    src, mask = pm._prepare_text(TEXT)
    src2, pos, enc, cross = _masks(src, mask, uncond_own_mask=True)
    _, jkv = _jencode(jm.model, src2, pos, enc)
    dec, C = pm.config.model.decoder, pm.config.data.channels
    jc = [JaxKVCache(2, dec.kv_heads, 8, dec.gqa_head_dim, dtype=jnp.float32)]
    tok = jnp.full((2, 1, C), pm.config.data.audio_bos_value)
    jl, _ = _jdecoder(jm.model, tok, jnp.zeros((2, 1), jnp.int32), jc, jkv,
                      jc[0].attention_mask(1), cross)
    jl = np.asarray(jl)
    assert np.isnan(jl[0]).all() and np.isfinite(jl[1]).all()
    psrc2, ppos, penc, pcross = pdia._text_pair(src, mask, "cpu")
    pc = [KVCache(2, dec.kv_heads, 8, dec.gqa_head_dim, dtype=torch.float32, device="cpu")]
    with torch.inference_mode():
        _, pkv = pdia._encode_text(pm.model, psrc2, ppos, penc)
        pl, _ = pm.model.decoder(torch.tensor(np.asarray(tok)), torch.zeros(2, 1).long(), pc,
                                 pkv, self_mask=pc[0].attention_mask(1), cross_mask=pcross)
    assert torch.isfinite(pl).all()


def test_hub_dac_raises(pair):
    """Without `set_runtime` and without a dac/ directory the DAC would come
    from the hub: it raises."""
    _, pm, _, pdac = pair
    Model._dac = None
    try:
        with pytest.raises(ValueError, match="does not download"):
            pm.dac_model
    finally:
        Model._dac = pdac
