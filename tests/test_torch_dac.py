"""DAC in the port against the JAX package on the CPU at tiny widths (two
encoder and decoder stages, three codebooks of 64 entries of dim 4): encode
z and latents within 1e-5 in float32 with the codes identical; decode of
codes within 1e-5 of the peak; a code past the codebook clamped as the JAX
package's gather clamps it; weight-norm (descript) and `transformers`
(DacModel) checkpoints in the torch layout loading to the same weights in
both packages; `DACFile` compress / decompress equal to the JAX package's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models.descript.dac import DAC as JaxDAC
from mlx_audio_tpu.codec.models.descript.dac import DACFile as JaxDACFile
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu_torch.codec.models import DAC
from mlx_audio_tpu_torch.codec.models.descript.dac import DACFile
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.module import flatten_params as pflatten

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-5
CFG = dict(encoder_dim=8, encoder_rates=[2, 4], decoder_dim=32, decoder_rates=[4, 2],
           n_codebooks=3, codebook_size=64, codebook_dim=4, sample_rate=16000)

_encode = jax.jit(lambda m, x: m.quantizer(m.encoder(x)))
_decode_codes = jax.jit(lambda m, c: m.decoder(m.quantizer.from_codes(c)[0]))


def _moved(jm, rng):
    """Every parameter of the JAX model redrawn, the constant ones (Snake's
    alpha, biases) moved off their constant."""
    flat = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v, np.float32)
        if v.size and np.all(v == v.flat[0]):
            v = v + 0.2 * np.abs(rng.standard_normal(v.shape)).astype(np.float32)
        flat[k] = v
    return load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})


@pytest.fixture(scope="module")
def pair():
    with numpy_init():
        jm = _moved(JaxDAC(**CFG), np.random.default_rng(0))
    pm = DAC(**CFG, device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm, pm


def _audio(n=1200, seed=1):
    return 0.3 * np.random.default_rng(seed).standard_normal((1, 1, n)).astype(np.float32)


def test_encode_z_latents_codes(pair):
    jm, pm = pair
    audio = _audio()
    z_q, codes, latents = _encode(jm, jnp.swapaxes(jnp.asarray(audio), 1, 2))
    pz, pcodes, plat, _, _ = pm.encode(audio)
    np.testing.assert_array_equal(pcodes.numpy(), np.asarray(codes))
    np.testing.assert_allclose(pz.numpy(), np.swapaxes(np.asarray(z_q), 1, 2), rtol=0, atol=ATOL)
    np.testing.assert_allclose(plat.numpy(), np.swapaxes(np.asarray(latents), 1, 2), rtol=0,
                               atol=ATOL)
    # the module's own API agrees with the jitted cores
    assert pm(torch.as_tensor(audio))["audio"].shape == (1, 1, audio.shape[-1])


def test_decode_codes_and_the_clamp(pair):
    """Decoded codes within 1e-5 of the peak; codes at and past the
    codebook's end (64 and 1024 over 64 entries) decode as the last entry,
    as the JAX package's gather clamps them."""
    jm, pm = pair
    codes = np.random.default_rng(2).integers(0, 64, (1, 3, 12))
    want = np.swapaxes(np.asarray(_decode_codes(jm, jnp.asarray(codes))), 1, 2)
    got = pm.decode_codes(codes).numpy()
    peak = np.abs(want).max()
    assert got.shape == want.shape == (1, 1, 12 * 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * peak)
    past = codes.copy()
    past[0, 0, 3], past[0, 1, 5], past[0, 2, 0] = 64, 1024, 63
    want = np.swapaxes(np.asarray(_decode_codes(jm, jnp.asarray(past))), 1, 2)
    got = pm.decode_codes(past).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * peak)
    last = past.copy()
    last[0, 0, 3], last[0, 1, 5] = 63, 63
    np.testing.assert_array_equal(got, pm.decode_codes(last).numpy())


def _torch_layout(jm) -> dict:
    """The JAX model's weights as the descript checkpoint holds them: convs
    (O, I, K), transposed convs (I, O, K), Snake's alpha (1, C, 1), every
    conv weight as a weight-norm pair."""
    rng = np.random.default_rng(3)
    out = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v, np.float32)
        if k.endswith("alpha"):
            out[k] = np.swapaxes(v, 1, 2)
        elif v.ndim == 3:
            is_t = re.search(r"decoder\.model\.\d+\.block\.1\.weight$", k)
            w = np.transpose(v, (2, 0, 1)) if is_t else np.transpose(v, (0, 2, 1))
            g = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True))
            out[k[:-len("weight")] + "weight_g"] = g
            out[k[:-len("weight")] + "weight_v"] = w * (1 + rng.random())
        else:
            out[k] = v
    return out


def _to_hf(weights: dict, n_enc: int = 2, n_dec: int = 2) -> dict:
    """Descript names → `transformers` DacModel names (the inverse of the
    packages' `_hf_to_descript`), weight norm as parametrizations."""
    res = ("snake1", "conv1", "snake2", "conv2")
    out = {}
    for k, v in weights.items():
        nk = k
        for side, seq, first, inner in (("encoder", "block", 0, {3: "snake1", 4: "conv1"}),
                                        ("decoder", "model", 2, {0: "snake1", 1: "conv_t1"})):
            m = re.match(rf"{side}\.{seq}\.(\d+)\.(.*)$", k)
            if not m:
                continue
            i, rest = int(m.group(1)), m.group(2)
            n = n_enc if side == "encoder" else n_dec
            if i == 0:
                nk = f"{side}.conv1.{rest}"
            elif i == n + 1:
                nk = f"{side}.snake1.{rest}"
            elif i == n + 2:
                nk = f"{side}.conv2.{rest}"
            else:
                b = re.match(r"block\.(\d+)\.(.*)$", rest)
                j, leaf = int(b.group(1)), b.group(2)
                if j in inner:
                    nk = f"{side}.block.{i - 1}.{inner[j]}.{leaf}"
                else:
                    u = re.match(r"block\.(\d+)\.(.*)$", leaf)
                    nk = (f"{side}.block.{i - 1}.res_unit{j - first + 1}."
                          f"{res[int(u.group(1))]}.{u.group(2)}")
        nk = nk.replace("weight_g", "parametrizations.weight.original0")
        nk = nk.replace("weight_v", "parametrizations.weight.original1")
        out[nk] = v
    return out


@pytest.mark.parametrize("layout", ["descript", "transformers"])
def test_checkpoints_load_the_same(pair, layout):
    """A torch-layout checkpoint with weight norm, in descript's names or
    transformers' (res_unit, conv_t1, parametrizations): both packages'
    `sanitize` give the same weights, the JAX model's, and the port decodes
    the same."""
    jm, pm = pair
    ckpt = _torch_layout(jm)
    if layout == "transformers":
        ckpt = _to_hf(ckpt)
        assert any(".res_unit" in k for k in ckpt)
    want = {k: np.asarray(v) for k, v in flatten_params(jm).items()}
    got = pm.sanitize({k: torch.tensor(v) for k, v in ckpt.items()})
    jgot = jm.sanitize(dict(ckpt))
    assert sorted(got) == sorted(jgot) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(np.asarray(jgot[k], np.float32), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    loaded = DAC(**CFG, device="cpu")
    load_jax_params(loaded, got)
    codes = np.random.default_rng(4).integers(0, 64, (1, 3, 6))
    np.testing.assert_allclose(loaded.decode_codes(codes).numpy(),
                               pm.decode_codes(codes).numpy(), rtol=0, atol=ATOL)


def test_from_pretrained_and_the_hub(pair, tmp_path):
    """A local directory (config.json + safetensors in the JAX layout) loads
    equal to the source; a hub id raises."""
    from mlx_audio_tpu_torch import convert

    jm, pm = pair
    convert.save_model(tmp_path, pflatten(pm), dict(CFG))
    loaded = DAC.from_pretrained(str(tmp_path), device="cpu")
    for (k, a), (_, b) in zip(pm.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="does not download"):
        DAC.from_pretrained("mlx-community/descript-audio-codec-44khz", device="cpu")


def test_dacfile_compress_decompress(pair, tmp_path):
    """Three hop-aligned windows of 0.05 s: the codes equal the JAX
    package's, the file round-trips, and the restored waveform is within
    1e-5 of the JAX package's."""
    jm, pm = pair
    signal = 0.2 * np.sin(np.arange(2000) * 0.05).astype(np.float32)
    want = jm.compress(signal, win_duration=0.05)
    got = pm.compress(signal, win_duration=0.05)
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
    assert (got.chunk_length, got.padding, got.sample_rate) == (
        want.chunk_length, want.padding, want.sample_rate)
    assert got.input_db == pytest.approx(want.input_db, abs=1e-9)
    path = got.save(tmp_path / "x")
    back = DACFile.load(path)
    np.testing.assert_array_equal(back.codes, got.codes)
    np.testing.assert_array_equal(JaxDACFile.load(path).codes, got.codes)
    wav = pm.decompress(path)
    jwav = np.asarray(jm.decompress(want))
    assert wav.shape == jwav.shape == (1, 2000)
    np.testing.assert_allclose(wav, jwav, rtol=0, atol=ATOL * np.abs(jwav).max())
