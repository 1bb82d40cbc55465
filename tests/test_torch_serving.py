"""The port's serving scheduler and slot-batching pieces against the JAX
package's, on the CPU.

- `BatchScheduler` and `stream_chunks`: the same tests run on both
  packages' classes (grouping, bucket keys, the max-batch split, error
  propagation to every future of a group, a failed dispatch re-raised by
  `stream_chunks`); the port's worker thread enters inference mode itself.
- `SlotKVCache`: per-row decode writes and windowed appends, buffers and
  positions equal to the JAX cache's (exact: a copy).
- `_sample_rows_core`: the filters (repetition penalty, temperature, top-k,
  top-p, min-p), not the random bits, held to the JAX package's per row: the
  JAX filtered logits are read where they reach `jax.random.categorical`;
  -inf at the same places and the survivors within 1e-6 of their peak
  (float32, other summation orders). Greedy rows identical.
- The port's draws: a sampled row draws what the single-request sampler
  (`qwen3_tts._sample`) draws with a generator of the same seed, whatever
  its row and its co-tenants.
- The launch counters stay exact when several threads launch at once.

Every future is read with a timeout and every scheduler closed in a
`finally`, so a stuck worker fails one test instead of hanging the run.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu import serving as jax_serving
from mlx_audio_tpu.lm import continuous as jcont
from mlx_audio_tpu_torch import serving as port_serving
from mlx_audio_tpu_torch.lm import continuous as pcont
from mlx_audio_tpu_torch.ops.cuda import _build
from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import _sample

TIMEOUT = 30
BOTH = pytest.mark.parametrize("mod", [jax_serving, port_serving], ids=["jax", "port"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the scheduler, both packages ----


@BOTH
def test_scheduler_groups_concurrent_submits(mod):
    calls = []

    def batch_fn(items):
        calls.append(list(items))
        return [x * 2 for x in items]

    sched = mod.BatchScheduler(batch_fn, max_batch=8, window_ms=200.0)
    try:
        results = [f.result(timeout=TIMEOUT) for f in [sched.submit(i) for i in range(5)]]
    finally:
        sched.close()
    assert results == [0, 2, 4, 6, 8]
    assert calls == [[0, 1, 2, 3, 4]] and sched.dispatch_count == 1


@BOTH
def test_scheduler_respects_bucket_keys(mod):
    calls = []

    def batch_fn(items):
        calls.append(list(items))
        return items

    sched = mod.BatchScheduler(batch_fn, bucket_fn=lambda x: x % 2, max_batch=8,
                               window_ms=200.0)
    try:
        assert [f.result(timeout=TIMEOUT) for f in [sched.submit(i) for i in range(4)]] == \
            [0, 1, 2, 3]
    finally:
        sched.close()
    assert sorted(calls) == [[0, 2], [1, 3]] and sched.dispatch_count == 2


@BOTH
def test_scheduler_max_batch_splits(mod):
    calls = []

    def batch_fn(items):
        calls.append(len(items))
        return items

    sched = mod.BatchScheduler(batch_fn, max_batch=2, window_ms=100.0)
    try:
        assert [f.result(timeout=TIMEOUT) for f in [sched.submit(i) for i in range(5)]] == \
            list(range(5))
    finally:
        sched.close()
    assert max(calls) <= 2 and sum(calls) == 5 and sched.dispatch_count >= 3


@BOTH
def test_scheduler_propagates_errors_to_the_group(mod):
    def batch_fn(items):
        raise ValueError("boom")

    sched = mod.BatchScheduler(batch_fn, window_ms=200.0)
    try:
        futs = [sched.submit(i) for i in range(3)]
        for f in futs:
            with pytest.raises(ValueError, match="boom"):
                f.result(timeout=TIMEOUT)
        # the worker lives on: the next group is served
        sched.batch_fn = lambda items: items
        assert sched.submit(7).result(timeout=TIMEOUT) == 7
    finally:
        sched.close()
    assert sched.dispatch_count == 1


@BOTH
def test_stream_chunks_regroups_and_reraises(mod):
    """Items emitted by a batcher's callback come out in chunks of
    chunk_size and a tail; a dispatch that fails after emitting re-raises
    on the consuming thread, after the chunks that arrived."""
    from concurrent.futures import Future

    def submit(n, fail, on_frame=None):
        fut = Future()

        def work():
            for i in range(n):
                on_frame(i)
            if fail:
                fut.set_exception(RuntimeError("fused dispatch failed"))
            else:
                fut.set_result(n)

        threading.Thread(target=work, daemon=True).start()
        return fut

    got = list(mod.stream_chunks(submit, 7, False, chunk_size=3, callback_kw="on_frame"))
    assert got == [[0, 1, 2], [3, 4, 5], [6]]
    seen = []
    with pytest.raises(RuntimeError, match="fused dispatch failed"):
        for chunk in mod.stream_chunks(submit, 4, True, chunk_size=3, callback_kw="on_frame"):
            seen.append(chunk)
    assert seen == [[0, 1, 2]]


def test_worker_thread_enters_inference_mode():
    """inference mode is thread-local: the worker enters it itself, so a
    fused call on the caller's inference tensors neither records autograd
    state nor refuses them."""
    w = torch.nn.Parameter(torch.ones(3))

    def batch_fn(items):
        assert torch.is_inference_mode_enabled()
        return [(x * w).sum() for x in items]

    with torch.inference_mode():
        x = torch.arange(3.0)  # an inference tensor, made on this thread
    sched = port_serving.BatchScheduler(batch_fn, window_ms=50.0, device="cpu")
    try:
        y = sched.submit(x).result(timeout=TIMEOUT)
    finally:
        sched.close()
    assert y.item() == 3.0 and not y.requires_grad and y.is_inference()
    assert not torch.is_inference_mode_enabled()


def test_infer_hook_registry():
    model, hook = object(), object()
    port_serving.register_infer_hook(model, hook)
    try:
        assert port_serving.get_infer_hook(model) is hook
    finally:
        port_serving.unregister_infer_hook(model)
    assert port_serving.get_infer_hook(model) is None


@pytest.mark.parametrize("n,max_batch,want", [(1, 8, 1), (3, 8, 4), (5, 8, 8), (5, 6, 6),
                                              (7, 6, 6)])
def test_batch_bucket_is_a_clamped_power_of_two(n, max_batch, want):
    assert port_serving._batch_bucket(n, max_batch) == want
    assert want in port_serving._bucket_sizes(max_batch)


def test_launch_counts_stay_exact_across_threads():
    """`count_launch` from eight threads with a short switch interval: no
    increment is lost (a bare `+=` on the wrapper's attribute can lose one
    when the interpreter switches threads inside it)."""
    def fn():
        pass

    fn.launches = 0
    fn.kernels = {"a": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(fn, "a")
                                                    for _ in range(2000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == fn.kernels["a"] == 16000


# ---- SlotKVCache ----


def test_slot_kv_cache_matches_jax():
    rng = np.random.default_rng(0)
    B, H, S, D = 3, 2, 12, 4
    pos = np.array([0, 5, 8])  # the last row fills the cache to its end
    jc = jcont.SlotKVCache(B, H, S, D, jnp.float32).replace(pos=jnp.asarray(pos, jnp.int32))
    pc = pcont.SlotKVCache(B, H, S, D, torch.float32, "cpu")
    pc.pos = torch.as_tensor(pos)
    for t in (1, 1, 2):  # two decode writes, then a windowed append
        k = rng.standard_normal((B, H, t, D)).astype(np.float32)
        v = rng.standard_normal((B, H, t, D)).astype(np.float32)
        jk, jv, jc = jc.update(jnp.asarray(k), jnp.asarray(v))
        pk, pv, pc = pc.update(torch.from_numpy(k), torch.from_numpy(v))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))
    assert pc.max_len == jc.max_len == S
    # past the capacity (a free slot's scratch): the JAX cache drops the
    # write, this one puts it on the last index and leaves the rest alone
    before = pc.k.clone()
    pc.update(torch.ones(B, H, 1, D), torch.ones(B, H, 1, D))
    assert torch.equal(pc.k[2, :, :S - 1], before[2, :, :S - 1])
    assert (pc.k[2, :, S - 1] == 1).all()


def test_install_slot_copies_a_prefill_into_its_row():
    from mlx_audio_tpu_torch.lm.cache import KVCache

    slot = [pcont.SlotKVCache(3, 2, 16, 4, torch.float32, "cpu")]
    one = [KVCache(1, 2, 8, 4, dtype=torch.float32, device="cpu")]
    one[0].k.normal_()
    one[0].v.normal_()
    pcont._install_slot(slot, one, 1, 5)
    assert torch.equal(slot[0].k[1, :, :8], one[0].k[0])
    assert torch.equal(slot[0].v[1, :, :8], one[0].v[0])
    assert not slot[0].k[[0, 2]].any() and not slot[0].k[1, :, 8:].any()
    assert slot[0].pos.tolist() == [0, 5, 0]


@pytest.mark.parametrize("n,want", [(1, 16), (16, 16), (17, 32), (1024, 1024),
                                    (1025, 2048), (3000, 4096)])
def test_prompt_bucket_matches_jax(n, want):
    assert pcont._bucket(n) == jcont._bucket(n) == want
    assert pcont.PROMPT_BUCKETS == jcont.PROMPT_BUCKETS


# ---- the per-row sampler ----

V = 50
# temperature, top-p, top-k, repetition penalty, its window, min-p
ROWS = [
    (0.0, 1.0, 0, 1.0, 0, 0.0),     # greedy
    (0.0, 1.0, 0, 1.4, 64, 0.0),    # greedy with a repetition penalty
    (0.7, 1.0, 5, 1.0, 0, 0.0),     # top-k
    (1.0, 0.6, 0, 1.0, 0, 0.0),     # top-p
    (0.9, 0.8, 20, 1.3, 3, 0.0),    # all three, the penalty on a short window
    (1.2, 1.0, 0, 1.0, 0, 0.05),    # min-p
]


def _rows_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((len(ROWS), V)) * 3).astype(np.float32)
    hist = rng.integers(0, V, (len(ROWS), 8)).astype(np.int32)
    hist[:, :2] = -1  # the window's padding
    cols = [np.array(c) for c in zip(*ROWS)]
    temps, top_ps = cols[0].astype(np.float32), cols[1].astype(np.float32)
    top_ks, rep_pens = cols[2].astype(np.int32), cols[3].astype(np.float32)
    rep_windows, min_ps = cols[4].astype(np.int32), cols[5].astype(np.float32)
    return logits, hist, temps, top_ps, top_ks, rep_pens, rep_windows, min_ps


def _jax_filtered(monkeypatch, args):
    """JAX `_sample_rows_core`'s tokens and the filtered logits each row
    hands to `jax.random.categorical` (its vmaps run row by row, eagerly,
    so the rows can be read)."""
    seen = []
    vmap = jax.vmap

    def rows(f):
        def run(*xs):
            return jnp.stack([f(*(x[i] for x in xs)) for i in range(xs[0].shape[0])])
        return run

    def categorical(key, logits, axis=-1):
        seen.append(np.asarray(logits))
        return jnp.argmax(logits)

    monkeypatch.setattr(jax, "vmap", rows)
    monkeypatch.setattr(jax.random, "categorical", categorical)
    keys = jnp.zeros((len(ROWS), 2), jnp.uint32)
    logits, hist, temps, top_ps, top_ks, rep_pens, rep_windows, min_ps = args
    tok, _ = jcont._sample_rows_core(
        jnp.asarray(logits), keys, jnp.asarray(hist), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(top_ks), jnp.asarray(rep_pens), jnp.asarray(rep_windows),
        jnp.asarray(min_ps))
    monkeypatch.setattr(jax, "vmap", vmap)
    return np.asarray(tok), np.stack(seen)


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_filters_match_jax(monkeypatch, seed):
    args = _rows_inputs(seed)
    jtok, jx = _jax_filtered(monkeypatch, args)
    greedy, px = pcont._filter_rows(*(torch.from_numpy(a) for a in args))
    px = px.numpy()
    np.testing.assert_array_equal(np.isinf(px), np.isinf(jx))
    fin = np.isfinite(jx)
    np.testing.assert_allclose(px[fin], jx[fin], rtol=0, atol=1e-6 * np.abs(jx[fin]).max())
    greedy_rows = args[2] == 0
    np.testing.assert_array_equal(greedy.numpy()[greedy_rows], jtok[greedy_rows])
    # each filter removed something where it was asked to, and only there
    kept = fin.sum(axis=1)
    assert kept[0] == kept[1] == V and kept[2] == 5 and 1 <= kept[3] < V
    assert kept[4] <= 20 and 1 <= kept[5] < V


def test_sampled_rows_draw_what_one_request_draws():
    """Row b of a batch with co-tenants, and the same request alone, draw
    the tokens `qwen3_tts._sample` draws with a generator of its seed, draw
    after draw; greedy rows and free slots draw nothing."""
    logits, hist, temps, top_ps, top_ks, rep_pens, rep_windows, min_ps = _rows_inputs(2)
    rep_pens[:] = 1.0
    min_ps[:] = 0.0
    t = {k: torch.from_numpy(v) for k, v in dict(
        hist=hist, temps=temps, top_ps=top_ps, top_ks=top_ks, rep_pens=rep_pens,
        rep_windows=rep_windows).items()}
    seeds = [None if temps[b] == 0 else 10 + b for b in range(len(ROWS))]
    gens = [None if s is None else torch.Generator().manual_seed(s) for s in seeds]
    alone = {b: torch.Generator().manual_seed(s) for b, s in enumerate(seeds) if s is not None}
    for step in range(4):
        x = torch.from_numpy(logits) + step
        tok = pcont._sample_rows_core(x, gens, t["hist"], t["temps"], t["top_ps"],
                                      t["top_ks"], t["rep_pens"], t["rep_windows"])
        for b in range(len(ROWS)):
            if seeds[b] is None:
                assert tok[b] == torch.argmax(x[b])
                continue
            want = _sample(x[b:b + 1], alone[b], float(temps[b]), int(top_ks[b]),
                           float(top_ps[b]))
            assert tok[b] == want[0], (step, b)


@pytest.mark.parametrize("mix", ["all_greedy", "no_penalty", "top_k_only", "everything"])
def test_skipped_stages_change_no_token(mix):
    """The stages no row uses (`stages_used`, from the host's parameters)
    are skipped; the tokens are those of the full filter chain, draw for
    draw."""
    logits, hist, temps, top_ps, top_ks, rep_pens, rep_windows, _ = _rows_inputs(3)
    if mix == "all_greedy":
        temps[:] = 0.0
    if mix in ("no_penalty", "top_k_only"):
        rep_pens[:] = 1.0
    if mix == "top_k_only":
        top_ps[:] = 1.0
    used = pcont.stages_used(temps, top_ps, top_ks, rep_pens)
    assert used < pcont.STAGES
    t = [torch.from_numpy(a) for a in (hist, temps, top_ps, top_ks, rep_pens, rep_windows)]

    def gens():
        return [None if temps[b] == 0 else torch.Generator().manual_seed(b)
                for b in range(len(ROWS))]

    ga, gb = gens(), gens()
    for step in range(3):
        x = torch.from_numpy(logits) * (1 + step)
        full = pcont._sample_rows_core(x, ga, *t)
        lean = pcont._sample_rows_core(x, gb, *t, stages=used)
        assert torch.equal(full, lean), (mix, step)
