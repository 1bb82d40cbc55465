"""`DiaBatcher` in the port on the CPU at `test_torch_dia.py`'s tiny widths
(the planted EOS included, so a slot leaves mid-tick through the cascade):
greedy batched frames against each request alone through the same pool and
against the JAX package's batcher (identical); a sampled slot against a
one-slot pool with the same seed (a request's frames depend only on its
seed); `Model.generate` through the installed hook; and a checkpoint
directory with its `dac/` loaded by `utils.load_model` and driven by
`tts.generate.generate_audio`.

The JAX batcher admits with the port's masks (both rows the cond text's:
see test_torch_dia.py); everything else is the JAX package's. Every future
is read with a timeout and every batcher closed in a `finally`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_audio_tpu.tts.models.dia import batcher as jbatch
from mlx_audio_tpu.tts.models.dia.dia import _encode_text as jencode
from mlx_audio_tpu_torch import convert as pconvert
from mlx_audio_tpu_torch import utils as putils
from mlx_audio_tpu_torch.nn.module import flatten_params as pflat
from mlx_audio_tpu_torch.serving import get_infer_hook
from mlx_audio_tpu_torch.tts.models.dia import Model

from test_torch_dia import CFG, DAC_CFG, EOS_STEP, MAX_TOKENS, TEXT, pair  # noqa: F401
from test_torch_lm import one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-5
TIMEOUT = 300
TEXTS = [TEXT, "[S1] A second, longer request. [S2] With its own words."]


class _JaxBatcher(jbatch.DiaBatcher):
    """The JAX package's batcher, admitting with both rows under the cond
    text's mask (its `_admit` otherwise)."""

    def _admit(self, req, slot):
        src2 = jnp.asarray(np.stack([np.zeros_like(req.src), req.src]))
        pos = jnp.broadcast_to(jnp.arange(self.S_text)[None], (2, self.S_text))
        pmask = np.stack([req.src_mask, req.src_mask])
        enc = jnp.where(jnp.asarray((pmask[:, :, None] == pmask[:, None, :])[:, None]),
                        0.0, -jnp.inf).astype(jnp.float32)
        _, cross_kvs = jencode(self.model, src2, pos, enc)
        for i, (k, v) in enumerate(cross_kvs):
            self.cross_ks[i] = jbatch._set_pair(self.cross_ks[i], slot, k)
            self.cross_vs[i] = jbatch._set_pair(self.cross_vs[i], slot, v)
        cmask = jnp.where(jnp.asarray(pmask)[:, None, None, :], 0.0, -jnp.inf)
        self.cross_mask = jbatch._set_pair(self.cross_mask, slot, cmask.astype(jnp.float32))
        self.pos[2 * slot:2 * slot + 2] = 0
        self.gen_step[slot] = 0
        self.eos_step[slot] = -1
        self.keys[slot] = np.asarray(jax.random.PRNGKey(req.seed), np.uint32)
        self.cur_tok[slot] = self.bos
        self.cfg_scales[slot] = req.cfg_scale
        self.temps[slot] = req.temp
        self.max_toks[slot] = req.max_tokens


def _decode(batcher, model, texts, seeds, temperature):
    futs = []
    for text, seed in zip(texts, seeds):
        src, mask = model._prepare_text(text)
        futs.append(batcher.submit(src, mask, max_tokens=MAX_TOKENS, temperature=temperature,
                                   cfg_scale=3.0, seed=seed))
    return [f.result(timeout=TIMEOUT) for f in futs]


def _run(model, texts, seeds, temperature=0.0, slots=2, cls=None):
    kw = dict(slots=slots, tick_frames=4, max_tokens_cap=64)
    b = cls(model, **kw) if cls else model.make_batcher(**kw)
    try:
        return _decode(b, model, texts, seeds, temperature), b.steps
    finally:
        b.close()


def test_batched_greedy_equals_sequential_and_the_jax_batcher(pair):
    jm, pm, _, _ = pair
    batched, steps = _run(pm, TEXTS, [0, 0])
    assert batched[0].shape == (EOS_STEP + 3, 3)  # the planted cascade, mid-tick
    assert steps <= MAX_TOKENS // 4
    for text, got in zip(TEXTS, batched):
        src, mask = pm._prepare_text(text)
        np.testing.assert_array_equal(got, _run(pm, [text], [0])[0][0])
        np.testing.assert_array_equal(got, pm._decode_codes(src, mask, MAX_TOKENS, 3.0, 0.0, 35))
    want, _ = _run(jm, TEXTS, [0, 0], cls=_JaxBatcher)
    for got, w in zip(batched, want):
        np.testing.assert_array_equal(got, w)


def test_sampled_slot_equals_a_one_slot_pool():
    """On seeded weights without the plant (its EOS column would end a
    sampled path early), each sampled request of a two-slot wave equals its
    one-slot run with the same seed, and another seed draws other frames."""
    pm = Model(CFG, device="cpu", seed=3)
    batched, _ = _run(pm, TEXTS, [5, 9], temperature=1.3)
    assert all(len(b) == MAX_TOKENS for b in batched)
    for text, seed, got in zip(TEXTS, [5, 9], batched):
        alone, _ = _run(pm, [text], [seed], temperature=1.3, slots=1)
        np.testing.assert_array_equal(got, alone[0])
    assert not np.array_equal(batched[1], _run(pm, [TEXTS[1]], [10], 1.3, slots=1)[0][0])


def test_generate_routes_through_the_hook(pair):
    _, pm, _, _ = pair
    direct = list(pm.generate(TEXT, temperature=0.0, max_tokens=MAX_TOKENS))
    b = pm.make_batcher(slots=2, tick_frames=4, max_tokens_cap=64).install()
    try:
        assert get_infer_hook(pm) is b
        served = list(pm.generate(TEXT, temperature=0.0, max_tokens=MAX_TOKENS))
        assert b.steps > 0
    finally:
        b.close()
    assert get_infer_hook(pm) is None
    assert [r.token_count for r in served] == [r.token_count for r in direct]
    np.testing.assert_allclose(served[0].audio, direct[0].audio, rtol=0, atol=ATOL)


def test_load_model_and_tts_generate(pair, tmp_path):
    """A checkpoint directory (config.json with model type dia, safetensors,
    the DAC in dac/): `utils.load_model` asks for the card unless given the
    CPU, gives the model's parameters and reads its DAC from dac/; `generate_audio` writes the direct route's
    audio."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.tts import generate as ptts

    _, pm, _, pdac = pair
    d = tmp_path / "dia-tiny"
    pconvert.save_model(d, pflat(pm), dict(CFG, model_type="dia"))
    pconvert.save_model(d / "dac", pflat(pdac), dict(DAC_CFG))
    want = list(pm.generate(TEXT, temperature=0.0, max_tokens=MAX_TOKENS))[0].audio
    Model._dac = None
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):  # the card by default
            putils.load_model(str(d))
        loaded = putils.load_model(str(d), device="cpu")
        assert isinstance(loaded, Model) and loaded.device.type == "cpu"
        for (k, a), (_, b) in zip(pm.state_dict().items(), loaded.state_dict().items()):
            assert (a == b).all(), k
        res = ptts.generate_audio(TEXT, model_path=str(d), device="cpu", temperature=0.0,
                                  max_tokens=MAX_TOKENS, output_path=str(tmp_path / "out"),
                                  verbose=False)
        assert Model._dac is not None and Model._dac is not pdac
    finally:
        Model._dac = pdac
    np.testing.assert_allclose(res[0].audio, want, rtol=0, atol=ATOL)
    wav, sr = audio_io.read(str(tmp_path / "out" / "audio_000.wav"))
    assert sr == 44100 and wav.shape[0] == want.shape[0]
