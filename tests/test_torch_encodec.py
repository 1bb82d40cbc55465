"""EnCodec in the port against the JAX package on the CPU at
test_parity_encodec's tiny widths: both load one `transformers`
`EncodecModel`'s state dict through their own `sanitize` (weight norm
folded, the packed LSTM names mapped, the codebooks' EMA buffers dropped),
which must agree key for key; encode codes identical, decode within 1e-5 of
the peak. Also a stereo, non-causal, time-group-norm configuration with
`normalize` and chunked overlap-add (the 48 kHz model's features), a decode
of three frames (a reflect pad longer than its input), a code past the
codebook (the last bin, as the JAX gather clamps it), the reflect emulation
itself against `jnp.pad`, and a hub id, which raises."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from mlx_audio_tpu.codec.models.encodec.encodec import Encodec as JaxEncodec
from mlx_audio_tpu.codec.models.encodec.encodec import EncodecConfig as JaxConfig
from mlx_audio_tpu.nn.module import load_weights as jax_load
from mlx_audio_tpu_torch.codec.models import Encodec
from mlx_audio_tpu_torch.codec.models.encodec.encodec import _reflect_index
from mlx_audio_tpu_torch.nn import load_weights
from mlx_audio_tpu_torch.safetensors_io import save_file

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

BAR = 1e-5
CONFIGS = {
    # test_parity_encodec's: the 24 kHz model's layout (causal, weight norm)
    "24khz": dict(target_bandwidths=[1.5, 3.0], sampling_rate=24000, audio_channels=1,
                  normalize=False, num_filters=8, hidden_size=16, num_residual_layers=1,
                  upsampling_ratios=[8, 5, 4, 2], codebook_size=64, codebook_dim=16,
                  num_lstm_layers=2),
    # the 48 kHz model's features at tiny widths: stereo, non-causal, time
    # group norm, normalize, 192-sample chunks overlapping by a quarter
    "48khz_style": dict(target_bandwidths=[96.0, 192.0], sampling_rate=48000,
                        audio_channels=2, normalize=True, num_filters=8, hidden_size=16,
                        num_residual_layers=1, upsampling_ratios=[4, 2], codebook_size=64,
                        codebook_dim=16, num_lstm_layers=2, use_causal_conv=False,
                        norm_type="time_group_norm", chunk_length_s=0.004, overlap=0.25),
}
BANDWIDTH = {"24khz": 3.0, "48khz_style": 96.0}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    name = request.param
    hcfg = transformers.EncodecConfig(**CONFIGS[name])
    torch.manual_seed(21)
    hf = transformers.EncodecModel(hcfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    # codebooks away from the EMA init, so every code is distinct
    rng = np.random.default_rng(3)
    for k in [k for k in sd if k.endswith("codebook.embed")]:
        sd[k] = rng.standard_normal(sd[k].shape).astype(np.float32)
    with numpy_init():
        jm = JaxEncodec(JaxConfig.from_dict(hcfg.to_dict()))
    jw = jm.sanitize(sd)
    jm = jax_load(jm, jw, strict=True)
    pm = Encodec(hcfg.to_dict(), device="cpu")
    pw = pm.sanitize(sd)
    load_weights(pm, pw, strict=True)
    return name, jm, pm, jw, pw


def _audio(channels, n, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((1, channels, n))).astype(np.float32)


def test_sanitize_matches_jax(pair):
    _, _, _, jw, pw = pair
    assert set(jw) == set(pw)
    assert not any(k.endswith((".embed_avg", ".cluster_size", ".inited")) for k in pw)
    assert any(".lstm.1.Wh" in k for k in pw)
    for k in jw:
        np.testing.assert_array_equal(np.asarray(pw[k]), np.asarray(jw[k]), err_msg=k)


def test_encode_codes_identical_and_decode(pair):
    name, jm, pm, _, _ = pair
    cfg = pm.config
    n = 500 if cfg.chunk_length else 3200
    x = _audio(cfg.audio_channels, n, 5)
    bw = BANDWIDTH[name]
    jcodes, jscales = jm.encode(jnp.asarray(x), bandwidth=bw)
    codes, scales = pm.encode(x, bandwidth=bw)
    assert codes.shape == tuple(jcodes.shape)
    if cfg.chunk_length:
        assert codes.shape[0] == 3  # 500 samples: chunks at 0, 144, 288; the tail dropped
        for s, js in zip(scales, jscales):
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    want = np.asarray(jm.decode(jcodes, jscales))
    got = pm.decode(codes, scales).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BAR * np.abs(want).max())


def test_decode_short_and_past_the_codebook(pair):
    """Three frames (the first decoder conv's reflect pad of 6 outruns
    them), with codes at the codebook's size and past it: the last bin."""
    name, jm, pm, _, _ = pair
    n = pm.config.codebook_size
    nq = pm.quantizer.get_num_quantizers_for_bandwidth(BANDWIDTH[name])
    codes = np.random.default_rng(7).integers(0, n, (1, 1, nq, 3))
    codes[0, 0, 0, 1] = n
    codes[0, 0, -1, 2] = n + 90
    clamped = np.minimum(codes, n - 1)
    want = np.asarray(jm.decode(jnp.asarray(codes)))
    got = pm.decode(codes).numpy()
    np.testing.assert_allclose(got, want, atol=BAR * np.abs(want).max())
    np.testing.assert_array_equal(got, pm.decode(clamped).numpy())


@pytest.mark.parametrize("length", [1, 2, 3, 7])
def test_reflect_index_is_jnp_pad(length):
    x = np.arange(length, dtype=np.float32)
    for left in (0, 1, 2, 5, 6, 13):
        right = min(3, length - 1)
        want = np.asarray(jnp.pad(jnp.asarray(x), (left, right), mode="reflect"))
        np.testing.assert_array_equal(x[_reflect_index(length, left, right).numpy()], want)


def test_hub_id_raises():
    with pytest.raises(ValueError, match="does not download"):
        Encodec.from_pretrained("mlx-community/encodec-24khz-float32", device="cpu")


def test_from_pretrained_reads_a_directory(pair, tmp_path):
    name, _, pm, _, pw = pair
    (tmp_path / "config.json").write_text(json.dumps(CONFIGS[name]))
    save_file({k: np.ascontiguousarray(np.asarray(v)) for k, v in pw.items()},
              tmp_path / "model.safetensors")
    loaded = Encodec.from_pretrained(str(tmp_path), device="cpu")
    x = _audio(pm.config.audio_channels, 600, 9)
    a, _ = loaded.encode(x, bandwidth=BANDWIDTH[name])
    b, _ = pm.encode(x, bandwidth=BANDWIDTH[name])
    assert torch.equal(a, b)
