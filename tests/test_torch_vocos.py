"""Vocos and its pieces in the port against the JAX package on the CPU at
tiny widths: the mel filterbank in all four combinations of scale and norm,
BatchNorm from running statistics, the log-mel features, the backbone with
and without AdaLayerNorm, the ISTFT head and `decode`; an EnCodec-driven
Vocos (`decode_from_codes`, the codebook sums of the port's EnCodec) against
the JAX module at its one-hot input; and the JAX module's integer-bandwidth
fault, which the port does not share.

Weights go across with `load_jax_params`, every constant-initialised
parameter moved off its constant first. float32 bar: 1e-5 of each output's
peak (waveforms, features and hidden states alike)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu import dsp as jdsp
from mlx_audio_tpu.codec.models.encodec.encodec import Encodec as JaxEncodec
from mlx_audio_tpu.codec.models.encodec.encodec import EncodecConfig as JaxEncodecConfig
from mlx_audio_tpu.codec.models.vocos import vocos as jv
from mlx_audio_tpu.nn import layers as jl
from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.codec.models import Encodec
from mlx_audio_tpu_torch.codec.models.vocos import vocos as pv
from mlx_audio_tpu_torch.nn import BatchNorm, load_jax_params
from mlx_audio_tpu_torch.nn.module import init_weights

from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

BAR = 1e-5


def _close(got, want, bar=BAR):
    """max|got - want| within `bar` of want's peak (the slice's float32
    parity tests share it)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _carry(jm, pm, seed=0):
    """The JAX module's parameters, moved off their constants, into the
    port's module; → the moved JAX module."""
    jm = _moved(jm, np.random.default_rng(seed))
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm


@pytest.mark.parametrize("mel_scale", ["htk", "slaney"])
@pytest.mark.parametrize("norm", [None, "slaney"])
def test_mel_filters_scale_and_norm(mel_scale, norm):
    """The JAX signature and defaults (htk, no norm), f_min and f_max too."""
    for args in ((24000, 1024, 100, 0.0, None), (16000, 1024, 128, 10.0, None),
                 (16000, 400, 40, 30.0, 7000.0)):
        got = dsp.mel_filters(*args, norm=norm, mel_scale=mel_scale).numpy()
        want = np.asarray(jdsp.mel_filters(*args, norm=norm, mel_scale=mel_scale))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(dsp.mel_filters(24000, 1024, 100).numpy(),
                                  np.asarray(jdsp.mel_filters(24000, 1024, 100)))


@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_from_running_statistics(affine):
    rng = np.random.default_rng(1)
    jb = jl.BatchNorm(12, affine=affine)
    pb = BatchNorm(12, affine=affine, device="cpu")
    flat = {"running_mean": rng.standard_normal(12).astype(np.float32),
            "running_var": rng.uniform(0.5, 2.0, 12).astype(np.float32)}
    if affine:
        flat.update(weight=rng.standard_normal(12).astype(np.float32),
                    bias=rng.standard_normal(12).astype(np.float32))
    for k, v in flat.items():
        setattr(jb, k, jnp.asarray(v))
    assert set(flatten_params(jb)) == set(flat)
    load_jax_params(pb, flat)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    with torch.no_grad():
        _close(pb(torch.from_numpy(x)).numpy(), jb(jnp.asarray(x)))


def test_log_mel_features_drop_the_last_frame():
    x = np.random.default_rng(2).standard_normal(4000).astype(np.float32) * 0.1
    jf = jv.MelSpectrogramFeatures(sample_rate=24000, n_fft=256, hop_length=64, n_mels=20)
    pf = pv.MelSpectrogramFeatures(sample_rate=24000, n_fft=256, hop_length=64, n_mels=20)
    want = np.asarray(jf(jnp.asarray(x)))
    got = pf(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 4000 // 64, 20)
    _close(got, want)
    # a batch: each row's own frames, its last dropped
    both = pf(torch.from_numpy(np.stack([x, x[::-1].copy()]))).numpy()
    _close(both[0], want[0])


def _backbone_pair(adanorm, **kw):
    cfg = dict(input_channels=10, dim=16, intermediate_dim=24, num_layers=2,
               adanorm_num_embeddings=adanorm, **kw)
    with numpy_init():
        jb = jv.VocosBackbone(**cfg)
    pb = pv.VocosBackbone(**cfg, device="cpu")
    init_weights(pb, torch.Generator().manual_seed(0))
    return _carry(jb, pb), pb


@pytest.mark.parametrize("adanorm", [None, 4])
def test_backbone(adanorm):
    """Without adanorm, and with it at each one-hot input: the port takes
    the integer id, a (B,) id tensor and the (B, E) one-hot alike."""
    jb, pb = _backbone_pair(adanorm, input_kernel_size=3, dw_kernel_size=5)
    x = np.random.default_rng(3).standard_normal((2, 9, 10)).astype(np.float32)
    call = jax.jit(lambda m, x, c: m(x, bandwidth_id=c))
    with torch.no_grad():
        if adanorm is None:
            _close(pb(torch.from_numpy(x)).numpy(), call(jb, jnp.asarray(x), None))
            return
        for bw in range(adanorm):
            onehot = np.eye(adanorm, dtype=np.float32)[[bw, bw]]
            want = call(jb, jnp.asarray(x), jnp.asarray(onehot))
            for cond in (bw, torch.tensor([bw, bw]), torch.from_numpy(onehot)):
                _close(pb(torch.from_numpy(x), bandwidth_id=cond).numpy(), want)
        # rows with their own ids
        onehot = np.eye(adanorm, dtype=np.float32)[[1, 3]]
        _close(pb(torch.from_numpy(x), bandwidth_id=torch.tensor([1, 3])).numpy(),
               call(jb, jnp.asarray(x), jnp.asarray(onehot)))


def test_reference_adalayernorm_raises_on_an_integer_bandwidth_id():
    """The JAX module applies its Linear to the id itself: an integer id
    raises AttributeError and a (B,) id array a shape error, where upstream
    Vocos looks the id up (ROADMAP Queue 3). The port reads the id's
    column."""
    with numpy_init():
        jb = jv.VocosBackbone(16, 32, 48, 2, adanorm_num_embeddings=4)
    x = jnp.zeros((1, 5, 16))
    with pytest.raises(AttributeError):
        jb(x, bandwidth_id=2)
    with pytest.raises(TypeError):
        jb(x, bandwidth_id=jnp.array([2]))
    pb = pv.VocosBackbone(16, 32, 48, 2, adanorm_num_embeddings=4, device="cpu")
    init_weights(pb, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert pb(torch.zeros(1, 5, 16), bandwidth_id=2).shape == (1, 5, 32)


def test_istft_head():
    with numpy_init():
        jh = jv.ISTFTHead(16, 64, 16)
    ph = pv.ISTFTHead(16, 64, 16, device="cpu")
    init_weights(ph, torch.Generator().manual_seed(0))
    jh = _carry(jh, ph)
    x = np.random.default_rng(4).standard_normal((2, 12, 16)).astype(np.float32) * 0.3
    with torch.no_grad():
        got = ph(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 11 * 16)
    _close(got, jh(jnp.asarray(x)))


MEL_CFG = {
    "feature_extractor": {"class_path": "vocos.feature_extractors.MelSpectrogramFeatures",
                          "init_args": {"sample_rate": 24000, "n_fft": 256,
                                        "hop_length": 64, "n_mels": 20}},
    "backbone": {"class_path": "vocos.models.VocosBackbone",
                 "init_args": {"input_channels": 20, "dim": 16, "intermediate_dim": 32,
                               "num_layers": 2}},
    "head": {"class_path": "vocos.heads.ISTFTHead",
             "init_args": {"dim": 16, "n_fft": 256, "hop_length": 64}},
}


def test_mel_vocos_decode_and_call():
    with numpy_init():
        jm = jv.Vocos.from_hparams(MEL_CFG)
    pm = pv.Vocos.from_hparams(MEL_CFG, device="cpu")
    jm = _carry(jm, pm)
    x = np.random.default_rng(5).standard_normal(6400).astype(np.float32) * 0.1
    feats = np.asarray(jm.feature_extractor(jnp.asarray(x)))
    _close(pm.decode(torch.from_numpy(feats.copy())).numpy(), jm.decode(jnp.asarray(feats)))
    _close(pm(torch.from_numpy(x)).numpy(), jm(jnp.asarray(x)))


ENCODEC = dict(target_bandwidths=[15.0, 30.0], sampling_rate=24000, audio_channels=1,
               normalize=False, num_filters=6, hidden_size=8, num_residual_layers=1,
               upsampling_ratios=[4, 2], codebook_size=32, codebook_dim=8,
               num_lstm_layers=1)


def test_encodec_vocos_at_the_one_hot_input():
    """An EnCodec-driven Vocos: the features of codes (nq, B, T) are the
    summed codebook rows of the port's EnCodec (a code past a codebook reads
    its last row), and the backbone at an integer bandwidth id equals the JAX
    module at that id's one-hot row."""
    with numpy_init():
        jenc = JaxEncodec(JaxEncodecConfig.from_dict(ENCODEC))
    penc = Encodec(ENCODEC, device="cpu")
    jenc = _carry(jenc, penc, seed=7)
    cfg = {"feature_extractor": {"class_path": "vocos.feature_extractors.EncodecFeatures",
                                 "init_args": {"encodec_model": "encodec_24khz",
                                               "bandwidths": [15.0, 30.0]}},
           "backbone": {"init_args": {"input_channels": 8, "dim": 16, "intermediate_dim": 24,
                                      "num_layers": 2, "adanorm_num_embeddings": 2}},
           "head": {"init_args": {"dim": 16, "n_fft": 64, "hop_length": 16}}}
    pm = pv.Vocos.from_hparams(cfg, device="cpu", encodec=penc)
    # the JAX EncodecFeatures downloads its codec: built around the same one
    jfe = jv.EncodecFeatures.__new__(jv.EncodecFeatures)
    jfe.encodec, jfe.bandwidths = jenc, [15.0, 30.0]
    with numpy_init():
        jm = jv.Vocos(jfe, jv.VocosBackbone(**cfg["backbone"]["init_args"]),
                      jv.ISTFTHead(**cfg["head"]["init_args"]))
    moved = _moved(jm, np.random.default_rng(8))
    flat = {k: np.asarray(v) for k, v in flatten_params(moved).items()
            if not k.startswith("feature_extractor.")}
    load_jax_params(pm, flat, not_built=("feature_extractor.",), strict=False)
    assert set(flat) == {k for k, _ in pm.named_parameters()
                         if not k.startswith("feature_extractor.")}
    jm = moved
    codes = np.random.default_rng(9).integers(0, 32, (2, 1, 12))
    codes[1, 0, 5] = 40  # past the codebook: its last row
    want_f = np.asarray(jm.feature_extractor.get_features_from_codes(
        jnp.asarray(np.minimum(codes, 31))))
    _close(pm.feature_extractor.get_features_from_codes(torch.from_numpy(codes)).numpy(),
           want_f)
    for bw in range(2):
        onehot = jnp.asarray(np.eye(2, dtype=np.float32)[[bw]])
        want = jm.decode(jnp.asarray(want_f), bandwidth_id=onehot)
        _close(pm.decode_from_codes(torch.from_numpy(codes), bandwidth_id=bw).numpy(), want)
    audio = np.random.default_rng(10).standard_normal(800).astype(np.float32) * 0.1
    got_codes = pm.get_encodec_codes(audio, 1)
    want_codes, _ = jenc.encode(jnp.asarray(audio)[None, None], bandwidth=30.0)
    np.testing.assert_array_equal(got_codes.numpy(),
                                  np.transpose(np.asarray(want_codes[0]), (1, 0, 2)))


def test_encodec_features_do_not_download():
    with pytest.raises(ValueError, match="does not download"):
        pv.EncodecFeatures("encodec_24khz")


def test_from_pretrained_reads_upstream_tables(tmp_path):
    """A local directory with upstream's config.yaml and weights, the
    AdaLayerNorm tables as `nn.Embedding`s (E, dim) and convolutions in
    torch's layout, the codec in encodec/, loads to the same model."""
    import yaml

    from mlx_audio_tpu_torch.convert import save_model
    from mlx_audio_tpu_torch.nn import flatten_params as pflat
    from mlx_audio_tpu_torch.safetensors_io import save_file

    cfg = {"feature_extractor": {"class_path": "vocos.feature_extractors.EncodecFeatures",
                                 "init_args": {"encodec_model": "encodec_24khz",
                                               "bandwidths": [15.0, 30.0]}},
           "backbone": {"init_args": {"input_channels": 8, "dim": 16, "intermediate_dim": 24,
                                      "num_layers": 1, "adanorm_num_embeddings": 2}},
           "head": {"init_args": {"dim": 16, "n_fft": 64, "hop_length": 16}}}
    penc = Encodec(ENCODEC, device="cpu", seed=3)
    src = pv.Vocos.from_hparams(cfg, device="cpu", seed=4, encodec=penc)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    up = {}
    for k, v in pflat(src).items():
        if k.startswith("feature_extractor."):
            continue
        v = np.asarray(v)
        if k.endswith((".scale.weight", ".shift.weight")):
            v = v.T.copy()  # upstream's Embedding (E, dim)
        elif k.endswith(".bias") and (".scale." in k or ".shift." in k):
            continue  # upstream's tables have no bias
        elif v.ndim == 3:
            v = np.ascontiguousarray(v.transpose(0, 2, 1))  # torch (O, I, K)
        up[k] = v
    up["head.istft.window"] = np.ones(64, np.float32)
    save_file(up, str(tmp_path / "pytorch_model.safetensors"))
    save_model(tmp_path / "encodec", pflat(penc), dict(ENCODEC))
    got = pv.Vocos.from_pretrained(str(tmp_path), device="cpu")
    want = dict(src.named_parameters())
    for k, p in got.named_parameters():
        torch.testing.assert_close(p, want[k], rtol=0, atol=0, msg=k)
