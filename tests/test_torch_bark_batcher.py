"""`BarkBatcher` on the CPU at tiny widths: four concurrent `generate`
calls fuse stage by stage (the semantic loop, the coarse windows, the fine
chunk each dispatched fused), and each request's audio equals its run
alone through the same pool (every group padded to the pool's rows, each
row drawing from its own seeded generators). The warm-up runs each stage
once. Every future is read with a timeout and the batcher is closed in a
`finally`.

Then the surface around it, on the same model written to a checkpoint
directory (config.json and safetensors in the JAX package's layout, a
WordPiece vocab.txt, EnCodec in encodec/): `utils.load_model` reads it,
`tts.generate.generate_audio` passes `--voice x.npz` to `Model.generate`,
the server's `ModelProvider` installs and warms a `BarkBatcher` and
answers a speech request with the samples of the in-memory model, and
`convert` writes an int4 checkpoint (every Linear and table quantized,
encodec/ carried along) that loads and synthesizes."""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mlx_audio_tpu_torch import server as srv
from mlx_audio_tpu_torch.codec.models import Encodec
from mlx_audio_tpu_torch.convert import convert, detect_model_domain, save_model
from mlx_audio_tpu_torch.nn.quantized import QuantizedEmbedding, QuantizedLinear
from mlx_audio_tpu_torch.nn.module import flatten_params
from mlx_audio_tpu_torch.serving import get_infer_hook
from mlx_audio_tpu_torch.tts.generate import generate_audio
from mlx_audio_tpu_torch.tts.models.bark import Model
from mlx_audio_tpu_torch.utils import load_model

from test_torch_bark import CFG, ENCODEC, PLANTED, Tok, _chip_smoke
from test_torch_lm import one_torch_thread  # noqa: F401  (fixture)

TIMEOUT = 300
TEXTS = ["Hello there.", "A second request.", "Third one, longer than the rest.", "Four."]


def _codec():
    codec = Encodec(dict(ENCODEC), device="cpu", seed=3)
    with torch.no_grad():
        for layer in codec.quantizer.layers:
            layer.codebook.embed.normal_(generator=torch.Generator().manual_seed(4))
    return codec


@pytest.fixture(scope="module")
def model():
    pm = Model(CFG, device="cpu", seed=7)
    _chip_smoke().plant_bark_stop(pm, PLANTED, gain=1.5)
    pm.set_runtime(tokenizer=Tok(), codec=_codec())
    yield pm
    Model._tokenizer = Model._codec = None


@pytest.fixture(scope="module")
def checkpoint(model, tmp_path_factory):
    """The planted model, a vocab.txt of letters and EnCodec in encodec/."""
    d = tmp_path_factory.mktemp("bark-tiny")
    save_model(d, flatten_params(model), dict(CFG, model_type="bark"))
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    (d / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ","] + letters
        + ["##" + c for c in letters]) + "\n")
    save_model(d / "encodec", flatten_params(Model._codec), dict(ENCODEC))
    return d


def _generate(model, i):
    with torch.inference_mode():
        out = list(model.generate(TEXTS[i], seed=10 + i, temperature=0.7))
    assert len(out) == 1
    return out[0].audio, out[0].token_count


def test_batched_equals_alone_in_the_pool(model):
    b = model.make_batcher(max_batch=4, window_ms=100.0).install()
    try:
        assert get_infer_hook(model) is b
        b.warmup()
        warm = (b.sem_sched.dispatch_count, b.coarse_sched.dispatch_count,
                b.fine_sched.dispatch_count)
        assert warm == (1, 1, 1)
        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(_generate, model, i) for i in range(4)]
            batched = [f.result(timeout=TIMEOUT) for f in futs]
        counts = (b.sem_sched.dispatch_count - warm[0], b.coarse_sched.dispatch_count - warm[1],
                  b.fine_sched.dispatch_count - warm[2])
        with ThreadPoolExecutor(1) as pool:
            alone = [pool.submit(_generate, model, i).result(timeout=TIMEOUT) for i in range(4)]
    finally:
        b.close()
    assert get_infer_hook(model) is None
    # each stage ran fused: fewer dispatches than the four requests' calls
    # (each request: one semantic call, two coarse windows, one fine chunk)
    assert all(c >= 1 for c in counts) and counts[0] < 4 and counts[1] < 8
    for (audio, n), (want, n_alone) in zip(batched, alone):
        assert n == n_alone == PLANTED
        assert audio.shape == want.shape and np.isfinite(audio).all()
        np.testing.assert_array_equal(audio, want)
    assert len({a.tobytes() for a, _ in batched}) == 4


def test_loaded_checkpoint_and_the_cli_voice(model, checkpoint, tmp_path, monkeypatch):
    """The directory loads equal to the model; its tokenizer is the
    vocab.txt, its codec the encodec/ directory; `generate_audio` with a
    voice .npz gives what `Model.generate` gives with the prompt's dict."""
    monkeypatch.setattr(Model, "_tokenizer", None)
    monkeypatch.setattr(Model, "_codec", None)
    assert detect_model_domain(checkpoint, json.loads((checkpoint / "config.json").read_text())) \
        == "tts"
    loaded = load_model(str(checkpoint), device="cpu")
    assert isinstance(loaded, Model)
    for (k, a), (_, b) in zip(flatten_params(loaded).items(), flatten_params(model).items()):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert loaded.tokenizer.encode("ab.", add_special_tokens=False) == [7, 7 + 27, 5]
    assert isinstance(loaded.codec, Encodec)
    rng = np.random.default_rng(2)
    voice = {"semantic_prompt": rng.integers(0, 10000, 120),
             "coarse_prompt": rng.integers(0, 1024, (2, 180))}
    np.savez(tmp_path / "speaker.npz", **voice)
    text = "hello there."
    with torch.inference_mode():
        out = generate_audio(text, model=loaded, voice=str(tmp_path / "speaker.npz"),
                             output_path=str(tmp_path), verbose=False, seed=3)
        want = list(loaded.generate(text, voice=voice, seed=3))
    assert len(out) == len(want) == 1 and out[0].token_count == PLANTED
    np.testing.assert_array_equal(out[0].audio, want[0].audio)
    assert (tmp_path / "audio_000.wav").is_file()


def test_served_after_the_warmup(checkpoint, monkeypatch):
    """`ModelProvider` loads the directory, installs a BarkBatcher and warms
    it; a speech request then answers with the in-memory model's samples
    (both through the installed batcher)."""
    monkeypatch.setattr(Model, "_tokenizer", None)
    monkeypatch.setattr(Model, "_codec", None)
    provider = srv.ModelProvider(device="cpu")
    name = str(checkpoint)
    model = provider.load_model(name)
    try:
        assert provider.wait_warmup(name, timeout=TIMEOUT) is None
        hook = get_infer_hook(model)
        assert hook is not None and hook.dispatch_count == 3
        body = b"".join(srv.generate_speech(
            {"model": name, "input": "hello there.", "response_format": "pcm"}, provider))
        with torch.inference_mode():
            want = list(model.generate("hello there."))
        assert body == srv._pcm16(want[0].audio)
        assert len(body) == 2 * PLANTED * 3 // 2 * 320
    finally:
        hook = get_infer_hook(model)
        if hook is not None:
            hook.close()


def test_convert_int4(checkpoint, tmp_path, monkeypatch):
    monkeypatch.setattr(Model, "_tokenizer", None)
    monkeypatch.setattr(Model, "_codec", None)
    out = convert(str(checkpoint), str(tmp_path / "bark-4bit"), quantize=True)
    assert (out / "encodec").is_dir() and (out / "vocab.txt").is_file()
    q4 = load_model(str(out), device="cpu")
    assert isinstance(q4.semantic.input_embeds_layer, QuantizedEmbedding)
    assert isinstance(q4.fine_acoustics.lm_heads[0], QuantizedLinear)
    with torch.inference_mode():
        res = list(q4.generate("hello there.", seed=1))
    assert len(res) == 1 and 0 < res[0].token_count <= 768
    assert np.isfinite(res[0].audio).all() and res[0].audio.size > 0
