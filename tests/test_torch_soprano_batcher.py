"""`SopranoBatcher` on the CPU at test_torch_soprano's tiny widths: four
concurrent greedy requests through the slot pool, each equal to its
sequential `_decode_with_hidden` (identical counts, hidden states within
1e-5 of the peak), the planted path and a cap; sampled requests equal to
the same request alone through the pool (each row's own seeded generator);
`generate` through the installed batcher equal to the direct route; and a
bucketed B = 1 prefill (the JAX package's `_B1Cache`, the port's
`make_caches` at batch 1) equal to the unpadded prompt's."""

import pytest
import torch

from mlx_audio_tpu_torch.lm.cache import make_caches
from mlx_audio_tpu_torch.lm.continuous import _bucket
from mlx_audio_tpu_torch.tts.models.soprano import batcher as pb
from mlx_audio_tpu_torch.tts.models.soprano import soprano as ps

from test_torch_lm import one_torch_thread  # noqa: F401  (fixture)
from test_torch_soprano import PATH_LEN, _close, pair, toks  # noqa: F401  (fixtures)

TIMEOUT = 120


def _prompts(tok):
    texts = ("hello world.", "the quick brown fox.", "a b.", "over the lazy dog, again.")
    return [tok.encode(f"[STOP][TEXT]{t}[START]", add_special_tokens=False) for t in texts]


def test_bucketed_prefill_equals_the_unpadded_prompt(pair, toks):
    """The admission's prefill: the prompt padded to its bucket in batch-one
    caches of the bucket's length gives the unpadded prompt's last hidden
    state and logits, and the same keys and values in its first T rows."""
    _, pm, _ = pair
    lm, cfg = pm.language_model, pm.language_model.config
    p = _prompts(toks[0])[1]
    T = len(p)
    P = _bucket(T)
    assert P > T
    ids = torch.zeros(1, P, dtype=torch.long)
    ids[0, :T] = torch.tensor(p)
    shape = (cfg.num_hidden_layers, 1, cfg.num_key_value_heads)
    padded = make_caches(*shape, P, cfg.head_dim, torch.float32, "cpu")
    plain = make_caches(*shape, T, cfg.head_dim, torch.float32, "cpu")
    with torch.no_grad():
        logits, h = pb._prefill_b1(lm, padded, ids, T)
        h_ref, _ = lm.model(torch.tensor([p]), plain)
        logits_ref = lm.logits(h_ref[:, -1:])[0, -1].float()
    _close(h.numpy(), h_ref[0, -1].numpy())
    _close(logits.numpy(), logits_ref.numpy())
    for a, b in zip(padded, plain):
        assert a.k.shape[2] == P
        _close(a.k[:, :, :T].numpy(), b.k.numpy())
        _close(a.v[:, :, :T].numpy(), b.v.numpy())


def test_batched_greedy_equals_sequential(pair, toks):
    _, pm, _ = pair
    tok = toks[0]
    stops = pm._stop_ids()
    prompts = _prompts(tok)
    caps = (32, 32, 4, 32)  # the third stops at its cap, mid-tick
    b = pm.make_batcher(slots=4, max_len=128, tick_frames=4)
    try:
        futs = [b.submit(p, max_tokens=m, temperature=0.0, stop_ids=stops)
                for p, m in zip(prompts, caps)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        b.close()
    for p, m, g in zip(prompts, caps, got):
        want, n = ps._decode_with_hidden(pm.language_model, p, m, 0.0, 1.0, stops)
        assert g.shape == (n + 1, 128) and n == min(m, PATH_LEN)
        _close(g, want[0].numpy())


def test_batched_sampled_equals_alone(pair, toks):
    """A sampled request draws from its own generator: its hidden states are
    the same beside three others as alone in the pool."""
    _, pm, _ = pair
    prompts = _prompts(toks[0])
    kw = dict(max_tokens=10, temperature=0.8, top_p=0.9, stop_ids=())

    def run(reqs):
        b = pm.make_batcher(slots=4, max_len=128, tick_frames=4)
        try:
            futs = [b.submit(p, seed=s, **kw) for p, s in reqs]
            return [f.result(timeout=TIMEOUT) for f in futs]
        finally:
            b.close()

    together = run([(p, 10 + i) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        (alone,) = run([(p, 10 + i)])
        assert alone.shape == together[i].shape == (11, 128)
        _close(together[i], alone)


def test_generate_through_the_installed_batcher(pair):
    _, pm, _ = pair
    direct = list(pm.generate("Hello world. The fox!", temperature=0.0))
    b = pm.make_batcher(slots=2, max_len=128, tick_frames=4).install()
    try:
        served = list(pm.generate("Hello world. The fox!", temperature=0.0))
        assert b.dispatch_count > 0
    finally:
        b.close()
    assert [r.token_count for r in served] == [r.token_count for r in direct]
    _close(served[0].audio, direct[0].audio)


def test_warmup_and_a_prompt_past_the_pool(pair):
    _, pm, _ = pair
    b = pm.make_batcher(slots=2, max_len=16, tick_frames=2)
    try:
        b.warmup()
        with pytest.raises(ValueError, match="capacity"):
            b.submit(list(range(20)), max_tokens=2).result(timeout=TIMEOUT)
    finally:
        b.close()
