"""Qwen3-TTS Base's x-vector voice cloning in the port against the JAX
package on the CPU at tiny widths: the speaker encoder's mel spectrogram and
the ECAPA-TDNN x-vector (float32, 1e-4), and `generate` with `ref_audio` and
no `ref_text` (the x-vector takes the speaker's place in the prompt: greedy
codes identical, audio within 1e-4). The loader keeps a Base checkpoint's
speaker encoder and drops it for a config without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu.tts.models.qwen3_tts import Model as JaxModel
from mlx_audio_tpu.tts.models.qwen3_tts import ModelConfig as JaxConfig
from mlx_audio_tpu.tts.models.qwen3_tts.qwen3_tts import mel_spectrogram as jmel
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import NOT_BUILT, mel_spectrogram

from test_torch_qwen3_tts import CFG, TEXT, Tok, _codes, _moved
from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-4
SPK = dict(mel_dim=32, enc_dim=64, enc_channels=[32, 32, 32, 32, 96],
           enc_kernel_sizes=[5, 3, 3, 3, 1], enc_dilations=[1, 2, 3, 4, 1],
           enc_attention_channels=16, enc_res2net_scale=4, enc_se_channels=16,
           sample_rate=24000)
BASE = dict(CFG, speaker_encoder_config=SPK)


def _ref(seconds=0.5, seed=0):
    t = np.arange(int(24000 * seconds)) / 24000
    noise = 0.05 * np.random.default_rng(seed).standard_normal(t.size)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + noise).astype(np.float32)


@pytest.mark.parametrize("mels", [32, 128])
def test_mel_spectrogram(mels):
    ref = _ref(0.4)
    want = np.asarray(jmel(ref, num_mels=mels))
    got = mel_spectrogram(ref, num_mels=mels).numpy()
    assert got.shape == want.shape == (1, (ref.size + 768 - 1024) // 256 + 1, mels)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def base_pair():
    cfg = JaxConfig.from_dict(BASE)
    cfg.tokenizer_config.encoder_config = None  # the speech-tokenizer encoder: ICL only
    with numpy_init():
        jm = _moved(JaxModel(cfg), np.random.default_rng(0))
    pm = Model(BASE, device="cpu", seed=1)
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()},
                    not_built=NOT_BUILT)
    jm.set_runtime(tokenizer=Tok())
    pm.set_runtime(tokenizer=Tok())
    return jm, pm


def test_speaker_encoder_matches_jax(base_pair):
    jm, pm = base_pair
    mel = np.asarray(jmel(_ref(), num_mels=SPK["mel_dim"]))
    want = np.asarray(jm.speaker_encoder(jnp.asarray(mel)))
    with torch.inference_mode():
        got = pm.speaker_encoder(torch.as_tensor(np.array(mel))).numpy()
    assert got.shape == (1, SPK["enc_dim"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))


def test_x_vector_and_prompt(base_pair):
    jm, pm = base_pair
    ref = _ref()
    want = np.asarray(jm.extract_speaker_embedding(ref))
    got = pm.extract_speaker_embedding(ref).numpy()
    assert got.shape == (1, 1, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    (j_in, j_tr, _), (p_in, p_tr, _) = (m._prepare_generation_inputs(TEXT, ref_audio=ref)
                                        for m in (jm, pm))
    plain = pm._prepare_generation_inputs(TEXT)[0]
    assert p_in.shape[1] == plain.shape[1] + 1  # the x-vector's position
    np.testing.assert_allclose(p_in.numpy(), np.asarray(j_in), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p_tr.numpy(), np.asarray(j_tr), rtol=0, atol=ATOL)


def test_ref_audio_without_ref_text_generates_as_jax(base_pair, tmp_path):
    """Greedy codes with the x-vector identical to the JAX package's; a wav
    path is read at the model's rate, as the JAX package reads it."""
    from mlx_audio_tpu_torch import audio_io

    jm, pm = base_pair
    ref = _ref(seed=2)
    (jcodes,), (jres,) = _codes(jm, ref_audio=ref)
    (pcodes,), (pres,) = _codes(pm, ref_audio=ref)
    np.testing.assert_array_equal(pcodes, jcodes)
    np.testing.assert_allclose(pres.audio, np.asarray(jres.audio), rtol=0, atol=ATOL)
    audio_io.write(tmp_path / "ref.wav", ref, 24000)
    (from_file,), _ = _codes(pm, ref_audio=str(tmp_path / "ref.wav"))
    (from_read,), _ = _codes(pm, ref_audio=audio_io.read(tmp_path / "ref.wav")[0])
    np.testing.assert_array_equal(from_file, from_read)


def test_icl_still_raises(base_pair):
    """Without the speech tokenizer's encoder (not in this checkpoint), ICL
    raises; tests/test_torch_qwen3_icl.py holds the route with it."""
    _, pm = base_pair
    with pytest.raises(ValueError, match="ICL"):
        list(pm.generate(TEXT, ref_audio=_ref(), ref_text="hi"))


def test_loader_keeps_or_drops_the_speaker_encoder(base_pair, tmp_path):
    """A Base checkpoint's speaker_encoder keys load into the encoder; a
    config without one drops them by name (every other key stays checked)."""
    from mlx_audio_tpu_torch import utils as putils
    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn.module import flatten_params as pflatten

    jm, pm = base_pair
    weights = pflatten(pm)
    assert any(k.startswith("speaker_encoder.") for k in weights)
    for name, cfg in (("base", BASE), ("no-encoder", CFG)):
        d = tmp_path / f"qwen3-tts-{name}"
        save_model(d, weights, dict(cfg, model_type="qwen3_tts"))
        loaded = putils.load_model(d, device="cpu")
        if name == "base":
            assert "speaker_encoder." not in loaded.NOT_BUILT
            torch.testing.assert_close(loaded.speaker_encoder.fc.weight,
                                       pm.speaker_encoder.fc.weight)
        else:
            assert loaded.speaker_encoder is None
            assert "speaker_encoder." in loaded.NOT_BUILT
