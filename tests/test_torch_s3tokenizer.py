"""S3Tokenizer in the port against the JAX package on the CPU at small
widths (32 wide, 4 heads of 8, 2 layers; the log-mel at its full 128
bins):

- the Whisper-style log-mel and `padding`;
- `FSMNAttention` with the rotate-half rope, and the `AudioEncoder`;
- V2's FSQ: the pre-round projection at the float32 bar, the codes
  identical through `quantize`'s 30 s window;
- V3's depth, and v1's Euclidean codes and sinusoidal positions;
- windowing past 30 s (three windows with 4 s of overlap) and
  `merge_tokenized_segments`;
- `sanitize`'s key map, `from_pretrained` on a local directory, a hub id
  raising.

Weights go across with `load_jax_params`, every constant-initialised
parameter moved off its constant first. float32 bar: 1e-5 of each output's
peak; codes identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models.s3tokenizer import s3tokenizer as js
from mlx_audio_tpu.nn.module import flatten_params as jax_flatten
from mlx_audio_tpu_torch.codec.models.s3tokenizer import s3tokenizer as ps
from mlx_audio_tpu_torch.convert import save_model
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.module import flatten_params

from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

BAR = 1e-5
N_MELS = 16


def small_config(layers: int = 2, **kw):
    return dict(n_mels=N_MELS, n_audio_ctx=1500, n_audio_state=32, n_audio_head=4,
                n_audio_layer=layers, **kw)


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _carry(jm, pm, seed=0):
    jm = _moved(jm, np.random.default_rng(seed))
    load_jax_params(pm, {k: np.asarray(v) for k, v in jax_flatten(jm).items()})
    return jm


def _pair(cls_name="S3TokenizerV2", seed=0, **cfg):
    with numpy_init(seed):
        jm = getattr(js, cls_name)(config=js.ModelConfig(**small_config(**cfg)))
    pm = getattr(ps, cls_name)(config=ps.ModelConfig(**small_config(**cfg)), device="cpu")
    return _carry(jm, pm, seed), pm


def _mel(frames, seed=0):
    return np.random.default_rng(seed).standard_normal((1, N_MELS, frames)).astype(np.float32)


@pytest.fixture(scope="module")
def v2():
    return _pair()


def test_log_mel_and_padding():
    audio = np.random.default_rng(1).standard_normal(16000).astype(np.float32) * 0.1
    want = np.asarray(js.log_mel_spectrogram(audio))
    got = ps.log_mel_spectrogram(audio).numpy()
    _close(got, want)
    got_p = ps.log_mel_spectrogram(audio, padding=480).numpy()
    _close(got_p, np.asarray(js.log_mel_spectrogram(audio, padding=480)))
    mels = [want[:, :50], want[:, :73]]
    for a, b in zip(ps.padding(mels), js.padding(mels)):
        np.testing.assert_array_equal(a, b)


def test_fsmn_attention_with_rope():
    with numpy_init(2):
        ja = js.FSMNAttention(32, 4)
    pa = ps.FSMNAttention(32, 4, device="cpu")
    ja = _carry(ja, pa, 2)
    x = np.random.default_rng(3).standard_normal((2, 20, 32)).astype(np.float32)
    lens = np.array([20, 13])
    pad = np.arange(20)[None] < lens[:, None]
    mask_pad = pad[..., None].astype(np.float32)
    bias = np.where(pad, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    jcos, jsin = js._s3_rope(8, 64)
    pcos, psin = ps._s3_rope(8, 64)
    _close(pcos, jcos)
    _close(psin, jsin)
    want = ja(jnp.asarray(x), jnp.asarray(bias), jnp.asarray(mask_pad), (jcos, jsin))
    with torch.no_grad():
        got = pa(torch.from_numpy(x), torch.from_numpy(bias), torch.from_numpy(mask_pad),
                 (torch.from_numpy(pcos), torch.from_numpy(psin)))
    _close(got.numpy(), want)


def test_audio_encoder(v2):
    jm, pm = v2
    mel = np.concatenate([_mel(90, 4), _mel(90, 5)])
    lens = np.array([90, 61])
    want_h, want_len = jm.encoder(jnp.asarray(mel), jnp.asarray(lens))
    with torch.no_grad():
        got_h, got_len = pm.encoder(torch.from_numpy(mel), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    _close(got_h.numpy(), want_h)


def test_v2_codes_identical(v2):
    """The pre-round projection at the float32 bar; the codes, through
    `quantize`'s padded 30 s window, identical. A code that differed would
    be reported with its margin to the rounding boundary."""
    jm, pm = v2
    mel = _mel(400, 6)
    hid_j, _ = jm.encoder(jnp.asarray(mel), jnp.asarray([400]))
    proj_j = np.asarray(jnp.tanh(jm.fsq_codebook.project_down(hid_j)) * 0.9990000128746033)
    with torch.no_grad():
        hid_p, _ = pm.encoder(torch.from_numpy(mel), torch.tensor([400]))
        proj_p = pm.fsq_codebook.project(hid_p).numpy()
    _close(proj_p, proj_j)
    want, want_len = jm.quantize(mel, np.array([400]))
    got, got_len = pm.quantize(mel, np.array([400]))
    np.testing.assert_array_equal(got_len, want_len)
    assert got_len[0] == 100
    diff = np.nonzero(got != want)[1]
    margin = np.abs(np.abs(proj_j[0, diff]) - 0.5).min() if diff.size else None
    assert diff.size == 0, f"codes differ at {diff[:8]}; the nearest digit is {margin} from .5"
    assert got.dtype == np.int64 and (got >= 0).all() and (got < 3 ** 8).all()


def test_v3_depth():
    """v3 takes 12 layers where its config says 6, as the JAX package's."""
    jv3, pv3 = _pair("S3TokenizerV3", seed=7, layers=6)
    assert len(pv3.encoder.blocks) == len(jv3.encoder.blocks) == 12
    mel = _mel(120, 8)
    want, _ = jv3.quantize(mel, np.array([120]))
    got, _ = pv3.quantize(mel, np.array([120]))
    np.testing.assert_array_equal(got, want)


def test_v1_euclidean_codes():
    """v1: sinusoidal positions, no rope or memory, the nearest of the
    L2-normalised codes (its codebook drawn: the JAX package starts it at
    zero). The position table is held over its first 100 rows: XLA's sin
    on the CPU parts from the correctly rounded one by up to 1.5e-5 at
    arguments near 1500, rows no valid frame of this mel reads."""
    jm, pm = _pair("S3Tokenizer", seed=9, n_codebook_size=64)
    assert pm.encoder.stride == 2
    _close(pm.encoder.positional_embedding.numpy()[:100],
           np.asarray(js._sinusoids(1500, 32))[:100])
    mel = _mel(80, 10)
    want, want_len = jm.quantize(mel, np.array([80]))
    got, got_len = pm.quantize(mel, np.array([80]))
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_windowing_past_30_s(v2):
    """A 70 s mel: three windows (starts 0, 2600, 5200) encoded in one batch
    and merged, beside a 20 s one in the same call."""
    jm, pm = v2
    long = _mel(7000, 11)
    short = np.pad(_mel(2000, 12), ((0, 0), (0, 0), (0, 5000)))
    mel = np.concatenate([long, short])
    lens = np.array([7000, 2000])
    want, want_len = jm.quantize(mel, lens)
    got, got_len = pm.quantize(mel, lens)
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_array_equal(got, want)
    # 750 + 750 + 450 codes, less 50 at each of the two interior boundaries
    assert got_len.tolist() == [1750, 500]
    segs = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12], [13, 14, 15]]
    assert (ps.merge_tokenized_segments(segs, 2, 1)
            == js.merge_tokenized_segments(segs, 2, 1) == [1, 2, 3, 4, 5, 8, 9, 10, 11, 14, 15])


def test_sanitize_from_pretrained_and_hub_id(tmp_path, v2):
    jm, pm = v2
    flat = flatten_params(pm)
    # the upstream names: torch's mlp.N, the quantizer's codebook, constants
    upstream = {}
    for k, v in flat.items():
        k = k.replace("fsq_codebook.", "quantizer._codebook.")
        k = k.replace(".mlp.layers.", ".mlp.")
        upstream[k] = v
    upstream["encoder.freqs_cis"] = np.zeros(3, np.float32)
    upstream["onnx::Mul_1"] = np.zeros(1, np.float32)
    got = pm.sanitize(upstream)
    want = jm.sanitize({k: jnp.asarray(v) for k, v in upstream.items()})
    assert sorted(got) == sorted(want) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    # a config.json with ModelConfig's fields sets the widths
    save_model(tmp_path / "s3tok", upstream, small_config())
    loaded = ps.S3TokenizerV2.from_pretrained(repo_id=str(tmp_path / "s3tok"), device="cpu")
    for k, v in flatten_params(loaded).items():
        np.testing.assert_array_equal(v, flat[k])
    with pytest.raises(ValueError, match="does not\\s+download"):
        ps.S3TokenizerV2.from_pretrained(device="cpu")
