"""`SesameBatcher` in the port on the CPU at `tests/test_parity_csm.py`'s
sizes: greedy batched frames against each request alone through the same
pool, against the port's direct loop and against the JAX package's direct
loop (all identical); sampled batched frames against each request alone
(a request's frames depend only on its seed); `Model.generate` through the
installed hook, plain and streamed, against the direct route; the loader
and `tts.generate` on a CSM checkpoint directory (float32 and int4 written
by `convert`); and the server's provider installing the batcher.

Bars: frames identical; waveforms 1e-5 absolute (float32). Every future is
read with a timeout and every batcher closed in a `finally`.
"""

import json

import numpy as np
import pytest
import torch

from mlx_audio_tpu.tts.models.sesame import sesame as jses
from mlx_audio_tpu_torch import convert as pconvert
from mlx_audio_tpu_torch import utils as putils
from mlx_audio_tpu_torch.nn.module import flatten_params as pflat
from mlx_audio_tpu_torch.serving import get_infer_hook
from mlx_audio_tpu_torch.tts.models.sesame import sesame as pses
from mlx_audio_tpu_torch.tts.models.sesame.batcher import SesameBatcher

from test_torch_lm import one_torch_thread  # noqa: F401  (fixture)
from test_torch_sesame import (CFG, K, REF_TEXT, TEXT, V, Tok, _generate, _jax_frames,
                               _port_frames, _ref_audio, csm_pair, mimi_pair)

ATOL = 1e-5
TIMEOUT = 300


@pytest.fixture(scope="module")
def pair():
    return csm_pair(seed=2)


@pytest.fixture(scope="module")
def runtime(pair):
    jm, pm = pair
    jmi, pmi = mimi_pair()
    jm.set_runtime(text_tokenizer=Tok(), mimi=jmi)
    pm.set_runtime(text_tokenizer=Tok(), mimi=pmi)
    yield jmi, pmi
    jses.Model._text_tokenizer = jses.Model._mimi = None
    pses.Model._text_tokenizer = pses.Model._mimi = None


def _prompt(T, seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((1, T, K + 1), np.int64)
    tokens[:, :, -1] = rng.integers(1, 60, T)
    mask = np.zeros((1, T, K + 1), bool)
    mask[:, :, -1] = True
    return tokens, mask


PROMPTS = [_prompt(T, s) for T, s in ((5, 0), (9, 1), (20, 2))]


def _decode(model, prompts, seeds, slots=3, temp=0.0, top_k=0, max_frames=8, tick=3):
    b = SesameBatcher(model, slots=slots, max_len=128, tick_frames=tick)
    try:
        futs = [b.submit(t, m, max_frames=max_frames, temp=temp, top_k=top_k, seed=s)
                for (t, m), s in zip(prompts, seeds)]
        return [f.result(timeout=TIMEOUT) for f in futs], b.steps
    finally:
        b.close()


def test_greedy_batched_equals_sequential_and_direct(pair):
    """Three greedy prompts of 5, 9 and 20 tokens (buckets 16 and 32) in
    three slots with 3-frame ticks: each request's 8 frames equal its frames
    alone through the pool, the port's direct loop's and the JAX package's
    direct loop's."""
    jm, pm = pair
    batched, steps = _decode(pm, PROMPTS, [0, 1, 2])
    assert steps == 3  # 8 frames in ticks of 3, every request together
    for (t, m), got in zip(PROMPTS, batched):
        alone, _ = _decode(pm, [(t, m)], [0])
        direct = _port_frames(pm, t, m, 8)
        assert got.shape == (8, K) and got.dtype == np.int32
        np.testing.assert_array_equal(got, alone[0])
        np.testing.assert_array_equal(got, direct)
        np.testing.assert_array_equal(got, _jax_frames(jm, t, m, 8))


def test_sampled_batched_equals_alone(pair):
    """Sampled at temperature 0.8, top-k 8: each request's frames depend
    only on its seed, batched or alone; two seeds part."""
    _, pm = pair
    batched, _ = _decode(pm, PROMPTS, [11, 12, 13], temp=0.8, top_k=8)
    for p, s, got in zip(PROMPTS, [11, 12, 13], batched):
        alone, _ = _decode(pm, [p], [s], temp=0.8, top_k=8)
        np.testing.assert_array_equal(got, alone[0])
    other, _ = _decode(pm, PROMPTS[:1], [99], temp=0.8, top_k=8)
    assert not np.array_equal(other[0], batched[0])
    assert (batched[0] < V).all()


def test_generate_through_the_hook(pair, runtime):
    """`Model.generate` with an installed batcher, greedy: the direct
    route's audio within 1e-5 (watermark off), plain and streamed (at 0.16
    s: the direct stream's chunks); the hook is gone after `close`; a
    prompt longer than the pool refuses only its own request."""
    _, pm = pair
    want = _generate(pm)
    want_stream = _generate(pm, stream=True, streaming_interval=0.16)
    b = pm.make_batcher(slots=2, max_len=96, tick_frames=4)
    assert isinstance(b, SesameBatcher)
    b.install()
    try:
        assert get_infer_hook(pm) is b
        b.warmup()
        got = _generate(pm)
        assert [r.token_count for r in got] == [r.token_count for r in want] == [8]
        np.testing.assert_allclose(got[0].audio, want[0].audio, rtol=0, atol=ATOL)
        got_stream = _generate(pm, stream=True, streaming_interval=0.16)
        assert [r.token_count for r in got_stream] == [2] * 4
        for g, w in zip(got_stream, want_stream):
            np.testing.assert_allclose(g.audio, w.audio, rtol=0, atol=ATOL)
        too_long = _prompt(100, 5)
        with pytest.raises(ValueError, match="capacity"):
            b.submit(*too_long, max_frames=2).result(timeout=TIMEOUT)
        assert len(_generate(pm)[0].audio) == 8 * 1920
    finally:
        b.close()
    assert get_infer_hook(pm) is None


def _write_csm(d, pm):
    cfg = dict(CFG, model_type="csm")
    pconvert.save_model(d, pflat(pm), cfg)
    return d


def test_load_model_and_tts_generate_float32_and_int4(pair, runtime, tmp_path):
    """A CSM checkpoint directory (model_type "csm"): `utils.load_model`
    gives the same parameters and `tts.generate.generate_audio` the direct
    model's greedy wav within one int16 step; `convert(quantize=True)`
    writes int4 g64 (every 2-D weight whose rows split into groups of 64:
    at these widths the backbone's down projections, 64 wide), which loads
    into `QuantizedLinear`s and generates frames of the right shape."""
    from mlx_audio_tpu_torch.audio_io import read
    from mlx_audio_tpu_torch.tts import generate as ptts

    _, pm = pair
    d = _write_csm(tmp_path / "csm-tiny", pm)
    loaded = putils.load_model(d, device="cpu")
    assert isinstance(loaded, pses.Model) and loaded.config.model_path == str(d)
    for k, v in pflat(loaded).items():
        np.testing.assert_array_equal(v, pflat(pm)[k], err_msg=k)
    res = ptts.generate_audio(TEXT, model_path=str(d), ref_audio=_ref_audio(),
                              ref_text=REF_TEXT, temperature=0.0, max_audio_length_ms=640,
                              apply_watermark=False, output_path=str(tmp_path),
                              file_prefix="csm", verbose=False, device="cpu")
    (want,) = _generate(pm)
    x, sr = read(tmp_path / "csm_000.wav")
    assert sr == 24000 and len(res) == 1
    ref = np.round(np.clip(want.audio, -1, 1) * 32767) / 32767
    assert np.abs(x - ref).max() <= 1.5 / 32767

    q = pconvert.convert(str(d), str(tmp_path / "csm-int4"), quantize=True)
    cfg = json.loads((q / "config.json").read_text())
    assert cfg["quantization"] == {"bits": 4, "group_size": 64}
    scales = sorted(k for k in putils.load_weight_files(q) if k.endswith(".scales"))
    qm = putils.load_model(q, device="cpu")
    from mlx_audio_tpu_torch.nn.quantized import QuantizedLinear

    quantized = sorted(n for n, m in qm.named_modules() if isinstance(m, QuantizedLinear))
    assert quantized == [f"model.backbone.layers.{i}.mlp.down_proj" for i in range(2)]
    assert scales == [f"{n}.scales" for n in quantized]
    tokens, mask = PROMPTS[0]
    frames = _port_frames(qm, tokens, mask, 4)
    assert frames.shape == (4, K) and (frames < V).all()


def test_server_provider_installs_the_batcher(pair, runtime, tmp_path, monkeypatch):
    """The server's `ModelProvider` loads a CSM directory on the CPU and
    installs a `SesameBatcher` as it does for the other families; unloading
    removes the hook."""
    from mlx_audio_tpu_torch import server

    _, pm = pair
    d = _write_csm(tmp_path / "csm-tiny", pm)
    provider = server.ModelProvider(device="cpu")
    model = provider.load_model(str(d))
    try:
        hook = get_infer_hook(model)
        assert isinstance(hook, SesameBatcher)
        assert provider.wait_warmup(str(d)) is None
    finally:
        assert provider.unload(str(d))
    assert get_infer_hook(model) is None


def test_jax_batcher_carries_a_quantized_models_state_as_integers():
    """A fault of the JAX package, recorded: its `SesameBatcher` keeps the
    slots' last hidden states in `codebook0_head.weight`'s dtype, which
    quantization makes uint32 words, so every admitted prompt's hidden
    state is truncated to integers. The port keeps them in the float dtype
    of `audio_head`, a raw array that is never quantized."""
    from mlx_audio_tpu.nn import quantized as jq
    from mlx_audio_tpu.tts.models.sesame.batcher import SesameBatcher as JaxBatcher
    from mlx_audio_tpu_torch.nn import quantized as pq

    cfg = dict(CFG, hidden_size=64, depth_decoder_config=dict(
        CFG["depth_decoder_config"], backbone_hidden_size=64))
    jm = jses.SesameModel(jses.ModelConfig.from_dict(cfg))
    jq.quantize_module(jm, group_size=64, bits=4,
                       predicate=lambda p, m: p == "codebook0_head")
    pm = pses.SesameModel(pses.ModelConfig.from_dict(cfg), device="cpu")
    pq.quantize_module(pm, group_size=64, bits=4, predicate=lambda p, m: p == "codebook0_head")
    jb, pb = JaxBatcher(jm, slots=2, max_len=32), SesameBatcher(pm, slots=2, max_len=32)
    try:
        assert str(jb.h_last.dtype) == "uint32"
        assert pb.state.h_last.dtype == torch.float32
    finally:
        jb.close()
        pb.close()
