"""The port's attention (mlx_audio_tpu_torch.ops) against the JAX package.

The flash kernel's plain version is held against the TPU kernel itself, run
in Pallas interpret mode on the CPU as tests/test_pallas.py runs it. The
CUDA kernel is held against the same plain version on the card by
chip_smoke.py (the test suite imports jax, which the card's machine lacks).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mlx_audio_tpu.lm.cache import KVCache as JaxKVCache
from mlx_audio_tpu.ops.attention import scaled_dot_product_attention as jax_sdpa
from mlx_audio_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from mlx_audio_tpu_torch.lm.cache import KVCache
from mlx_audio_tpu_torch.ops.attention import scaled_dot_product_attention
from mlx_audio_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

# f32 bars: 2e-4 is the Pallas kernel's own bar against the einsum path
# (tests/test_pallas.py:27) — blockwise online softmax sums in another
# order; 1e-5 for the einsum path, which computes the same sums in the same
# float32 steps on both sides.
FLASH_ATOL = 2e-4
SDPA_ATOL = 1e-5


def _qkv(rng, B, H, T, S, D, H_kv=None):
    H_kv = H_kv or H
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "T,S,causal",
    [(256, 256, False), (300, 150, False), (200, 200, False), (200, 200, True)],
    ids=["full256", "ragged300x150", "ragged200", "causal200"],
)
def test_flash_reference_matches_pallas_kernel(T, S, causal):
    rng = np.random.default_rng(T * 7 + S + causal)
    q, k, v = _qkv(rng, 1, 2, T, S, 64)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, block_q=128, block_k=128)
    out = flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_ATOL)


def test_flash_reference_rejects_offset_causal():
    q = torch.zeros(1, 1, 4, 8)
    k = torch.zeros(1, 1, 6, 8)
    with pytest.raises(ValueError, match="T == S"):
        flash_attention_reference(q, k, k, causal=True)


def _port_and_jax(q, k, v, port_mask, jax_mask):
    out = scaled_dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), mask=port_mask)
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jax_mask)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("case", ["none", "causal", "bool", "gqa"])
def test_sdpa_matches_jax(case):
    rng = np.random.default_rng(3)
    H_kv = 2 if case == "gqa" else 4
    T, S = (12, 12) if case in ("causal", "gqa") else (5, 9)
    q, k, v = _qkv(rng, 2, 4, T, S, 16, H_kv=H_kv)
    if case == "bool":
        m = rng.random((2, 1, T, S)) > 0.3
        m[..., 0] = True  # every row attends somewhere
        port_mask, jax_mask = torch.from_numpy(m), jnp.asarray(m)
    elif case in ("causal", "gqa"):
        port_mask = jax_mask = "causal"
    else:
        port_mask = jax_mask = None
    out, ref = _port_and_jax(q, k, v, port_mask, jax_mask)
    np.testing.assert_allclose(out, ref, atol=SDPA_ATOL)


def test_sdpa_kv_cache_mask_matches_jax():
    """Decode-style attention over a partly written cache: the additive
    mask of KVCache (prefill of 5, then one step) in both packages."""
    rng = np.random.default_rng(4)
    B, H, D, cap = 2, 2, 8, 16
    pre_k, pre_v = (rng.standard_normal((B, H, 5, D)).astype(np.float32)
                    for _ in range(2))
    q, k1, v1 = _qkv(rng, B, H, 1, 1, D)

    cache = KVCache(B, H, cap, D, dtype=torch.float32, device="cpu")
    cache.update(torch.from_numpy(pre_k), torch.from_numpy(pre_v))
    mask = cache.attention_mask(1)
    kk, vv, _ = cache.update(torch.from_numpy(k1), torch.from_numpy(v1))

    jcache = JaxKVCache(B, H, cap, D, dtype=jnp.float32)
    _, _, jcache = jcache.update(jnp.asarray(pre_k), jnp.asarray(pre_v))
    jmask = jcache.attention_mask(1)
    jk, jv, jcache = jcache.update(jnp.asarray(k1), jnp.asarray(v1))

    assert cache.pos == int(jcache.pos) == 6
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    out = scaled_dot_product_attention(torch.from_numpy(q), kk, vv, mask=mask)
    ref = jax_sdpa(jnp.asarray(q), jk, jv, mask=jmask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=SDPA_ATOL)


def test_cpu_call_launches_no_kernel():
    """On the CPU both the routed attention (at a shape that passes the
    kernel's shape guard) and the wrapper itself run the plain version."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 1, 1280, 1280, 64))
    before = flash_attention.launches
    out = scaled_dot_product_attention(q, k, v)
    direct = flash_attention(q, k, v)
    assert flash_attention.launches == before == 0
    np.testing.assert_allclose(out.numpy(), direct.numpy(), atol=FLASH_ATOL)


def test_kernel_build_dir(tmp_path, monkeypatch):
    """A checkout builds into its own ignored `build/kernels/`; an installed
    package builds under the user's cache, not into site-packages."""
    from mlx_audio_tpu_torch.ops.cuda import _build

    root = Path(_build.__file__).resolve().parents[3]
    assert _build.build_dir() == root / "build" / "kernels"
    assert "build/" in (root / ".gitignore").read_text().split()

    monkeypatch.setattr(_build, "_PKG", tmp_path / "site-packages" / "mlx_audio_tpu_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir() == tmp_path / "cache" / "mlx_audio_tpu_torch" / "kernels"

