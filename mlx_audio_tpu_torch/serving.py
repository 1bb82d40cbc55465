"""Request-batching scheduler for serving (counterpart of
`mlx_audio_tpu/serving.py`): queue → bucket → one batched call on the card.

`BatchScheduler` owns a queue and a worker thread: requests submitted within
`window_ms` of each other are grouped by a bucket key (a padded-shape class)
and handed to `batch_fn` as one list. The adapters fit it to the ported
families: `KokoroBatcher` (`Model.batch_synthesize`: one frontend and one
synthesis a group), `WhisperBatcher` (seek-loop windows encoded and decoded
as one batch), `StackBatcher` (equal-shape windows stacked into one forward,
MossFormer2-SE's chunks). `FrameBatcherBase` is the slot scheduler of the
frame-AR models (Qwen3-TTS, `tts/models/qwen3_tts/batcher.py`). A model
finds its batcher through `register_infer_hook`, so `generate()` batches
under a running server without a change of its callers.

Every worker thread does its own device setup: the current CUDA device and
`torch.inference_mode()` are thread-local, so a worker that did not enter
inference mode itself would record autograd state in every fused call (and
refuse the inference tensors its callers hand over). No fallback: a batched
call that raises sets the exception on every future of its group; nothing is
retried unbatched or on the host.

`LMContinuousBatcher` puts the token-level `lm.continuous.ContinuousBatcher`
behind the same hook for the LM families (Orpheus and VyvoTTS).

Not ported yet: `ParakeetBatcher` (waits for Parakeet).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import pinned, thread_setup

__all__ = [
    "BatchScheduler",
    "KokoroBatcher",
    "WhisperBatcher",
    "FrameBatcherBase",
    "StackBatcher",
    "LMContinuousBatcher",
    "register_infer_hook",
    "unregister_infer_hook",
    "get_infer_hook",
    "stream_chunks",
]


def stream_chunks(submit, *args, chunk_size: int = 1, callback_kw: str, **kwargs):
    """Generator bridging a batcher's streaming callback to a pull-style
    chunk iterator: calls ``submit(*args, <callback_kw>=sink, **kwargs)``
    and yields lists of ``chunk_size`` emitted items as they arrive, then
    any tail. Re-raises the request's failure (from the Future) at the end,
    so a failed fused dispatch surfaces on the consuming thread."""
    itemq: "queue.Queue" = queue.Queue()
    kwargs[callback_kw] = itemq.put
    fut = submit(*args, **kwargs)
    fut.add_done_callback(lambda _f: itemq.put(_SENTINEL))
    buf: List[Any] = []
    while True:
        item = itemq.get()
        if item is _SENTINEL:
            fut.result()  # surface a failed dispatch
            if buf:
                yield buf
            return
        buf.append(item)
        if len(buf) >= chunk_size:
            yield buf
            buf = []


_SENTINEL = object()


def _batch_bucket(n: int, max_batch: int) -> int:
    """The power-of-two batch bucket of n rows, clamped to max_batch (which
    need not be a power of two: it bounds the card's memory)."""
    return min(1 << (n - 1).bit_length(), max_batch)


def _bucket_sizes(max_batch: int) -> List[int]:
    """Every bucket `_batch_bucket` can give: 1, 2, 4, … below max_batch,
    and max_batch."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


class BatchScheduler:
    """Fuses concurrent submissions into batched calls.

    batch_fn(items: list) -> list of results (same order/length).
    bucket_fn(item) -> hashable key; only items with equal keys share a
    batch (shape-bucket + static-arg compatibility). `device`: the model's
    device, made current on the worker thread.
    """

    def __init__(
        self,
        batch_fn: Callable[[List[Any]], List[Any]],
        bucket_fn: Callable[[Any], Any] = lambda item: None,
        max_batch: int = 8,
        window_ms: float = 8.0,
        device=None,
    ):
        self.batch_fn = batch_fn
        self.bucket_fn = bucket_fn
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.device = pinned(device)
        self._q: "queue.Queue[Tuple[Any, Optional[Future]]]" = queue.Queue()
        self._stop = threading.Event()
        self.dispatch_count = 0  # batched device dispatches (for tests/metrics)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def __call__(self, item: Any, timeout: Optional[float] = None) -> Any:
        """Blocking submit."""
        return self.submit(item).result(timeout=timeout)

    def close(self):
        self._stop.set()
        self._q.put((None, None))  # wake worker
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _collect(self) -> List[Tuple[Any, Future]]:
        """Block for the first item, then drain arrivals for one window."""
        item = self._q.get()
        if item[1] is None:
            return []
        batch = [item]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt[1] is None:
                break
            batch.append(nxt)
        return batch

    def _worker(self):
        thread_setup(self.device)
        with torch.inference_mode():
            while not self._stop.is_set():
                pending = self._collect()
                if not pending:
                    continue
                # group by bucket key, preserving arrival order inside groups
                groups: Dict[Any, List[Tuple[Any, Future]]] = {}
                for item, fut in pending:
                    groups.setdefault(self.bucket_fn(item), []).append((item, fut))
                for group in groups.values():
                    items = [it for it, _ in group]
                    try:
                        results = self.batch_fn(items)
                        self.dispatch_count += 1
                        for (_, fut), res in zip(group, results):
                            fut.set_result(res)
                    except Exception as e:  # every future of the group gets it
                        for _, fut in group:
                            if not fut.done():
                                fut.set_exception(e)


# ---------------------------------------------------------------------------
# Infer-hook registry: lets pipelines route their device call through a
# batcher, keyed by the model object.
# ---------------------------------------------------------------------------

_INFER_HOOKS: Dict[int, Callable] = {}


def register_infer_hook(model, hook: Callable) -> None:
    _INFER_HOOKS[id(model)] = hook


def unregister_infer_hook(model) -> None:
    _INFER_HOOKS.pop(id(model), None)


def get_infer_hook(model) -> Optional[Callable]:
    return _INFER_HOOKS.get(id(model))


# ---------------------------------------------------------------------------
# Kokoro adapter
# ---------------------------------------------------------------------------


class KokoroBatcher:
    """Batches Kokoro phoneme-segment synthesis across concurrent requests.

    Bucket key = (text-length bucket, speed): rows in one bucket share the
    padded text width, so a group costs one frontend and one synthesis.
    Install with `.install()`; the pipeline then routes `model(ps, ref_s,
    speed)` through this scheduler for every `generate()` call.
    """

    def __init__(self, model, max_batch: int = 8, window_ms: float = 8.0):
        from .tts.models.kokoro.kokoro import TEXT_BUCKETS, _bucket

        self.model = model
        self._bucket = lambda n: _bucket(n, TEXT_BUCKETS)
        self.sched = BatchScheduler(self._run, self._key, max_batch=max_batch,
                                    window_ms=window_ms, device=model.device)

    def _key(self, item):
        ps, _ref_s, speed = item
        return (self._bucket(len(ps) + 2), float(speed))

    def _run(self, items):
        ps_list = [ps for ps, _, _ in items]
        refs = [r for _, r, _ in items]
        speed = items[0][2]
        return self.model.batch_synthesize(ps_list, refs, speed=speed)

    def __call__(self, ps: str, ref_s, speed: float = 1.0):
        return self.sched((ps, ref_s, speed))

    def warmup(self):
        """One batched call at every batch bucket for the smallest text
        bucket (the JAX package's contract; here it builds cuDNN's and
        cuBLAS's plans for each batch width before live traffic)."""
        ref = np.zeros((1, self.model.config.style_dim * 2), np.float32)
        item = ("həlˈO wˈɜɹld", ref, 1.0)
        with torch.inference_mode():
            for b in _bucket_sizes(self.sched.max_batch):
                self._run([item] * b)

    def install(self):
        register_infer_hook(self.model, self)
        return self

    def close(self):
        unregister_infer_hook(self.model)
        self.sched.close()

    @property
    def dispatch_count(self) -> int:
        return self.sched.dispatch_count


# ---------------------------------------------------------------------------
# Generic exact-shape window batching for single-dispatch models
# ---------------------------------------------------------------------------


class StackBatcher:
    """Window batching for single-dispatch encoder-style models
    (MossFormer2-SE chunks): concurrent submissions whose input arrays share
    exact shapes stack into ONE batched forward. Rows are independent, so
    batched results equal sequential ones (to the batched kernels' summation
    order); exact-shape bucketing keeps that true for conv stacks whose tail
    frames see padding inside their receptive field.

    `run_batch(items: list) -> list` receives the shape-equal group padded
    to a power-of-two batch bucket (repeat-last-row, clamped to max_batch)
    and returns per-row results in order.
    """

    def __init__(self, model, run_batch: Callable[[List[Any]], List[Any]],
                 max_batch: int = 8, window_ms: float = 10.0, device=None):
        self.model = model
        self._run_batch = run_batch
        self.sched = BatchScheduler(self._run, self._key, max_batch=max_batch,
                                    window_ms=window_ms, device=device)

    @staticmethod
    def _key(item):
        arrs = item if isinstance(item, tuple) else (item,)
        return tuple(
            (tuple(getattr(a, "shape", ())), str(getattr(a, "dtype", type(a))))
            for a in arrs
        )

    def _run(self, items):
        n = len(items)
        padded = list(items) + [items[-1]] * (_batch_bucket(n, self.sched.max_batch) - n)
        return self._run_batch(padded)[:n]

    def __call__(self, *arrs):
        return self.sched(arrs[0] if len(arrs) == 1 else arrs)

    def submit(self, *arrs):
        """Non-blocking submit → Future (lets a single request fan its own
        windows into the shared scheduler, e.g. MossFormer2-SE's chunked
        enhance)."""
        return self.sched.submit(arrs[0] if len(arrs) == 1 else arrs)

    def warmup(self, item=None) -> None:
        """One batched call at every batch bucket (1, 2, 4, …, max_batch)
        for the given example item. With no item this is a no-op:
        exact-shape bucketing has no single canonical example."""
        if item is None:
            return
        with torch.inference_mode():
            for b in _bucket_sizes(self.sched.max_batch):
                self._run_batch([item] * b)

    def install(self):
        register_infer_hook(self.model, self)
        return self

    def close(self):
        unregister_infer_hook(self.model)
        self.sched.close()

    @property
    def dispatch_count(self) -> int:
        return self.sched.dispatch_count


# ---------------------------------------------------------------------------
# Frame-AR slot batching (Qwen3-TTS: models whose decode emits a
# multi-codebook FRAME per step through nested inner loops)
# ---------------------------------------------------------------------------


class FrameBatcherBase:
    """Host-side slot scheduler for frame-AR continuous batching.

    A fixed pool of B cache slots decodes in lock-step; requests join free
    slots at tick boundaries and leave at EOS/cap. One tick = `tick_frames`
    frame steps of every live slot, each frame a full nested decode (talker
    step + code-predictor inner loop). Subclasses own the device state and
    implement:

    - `_admit(req, slot)`: prefill the request (B=1) and install its rows
      into the slot state; raise to reject (the future gets the exception).
    - `_tick(n)`: advance every live slot by n frames; consume outputs,
      append to requests, and `_finish` slots that hit EOS/cap. On failure
      the base calls `_fail_all`, which fails every live request and
      rebuilds the device state.
    """

    def __init__(self, slots: int = 4, tick_frames: int = 8, device=None):
        self.slots = slots
        self.tick_frames = max(1, int(tick_frames))
        self.device = pinned(device)
        self.active: List[Optional[Any]] = [None] * slots
        self._joinq: "queue.Queue[Any]" = queue.Queue()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self.steps = 0  # ticks (for tests/metrics)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- subclass interface -------------------------------------------

    def _admit(self, req, slot: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def _tick(self, n: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def _fail_all(self, e: Exception) -> None:  # pragma: no cover
        raise NotImplementedError

    # -----------------------------------------------------------------

    def submit_request(self, req) -> Future:
        self._joinq.put(req)
        self._wake.set()
        return req.future

    @staticmethod
    def _emit(req, item) -> None:
        """Streaming delivery: a request may carry an `on_frame` callback;
        `_tick` calls this at every output-append site, so a batched request
        streams frames as they are produced. A broken sink (e.g. a
        disconnected client) must never kill the shared worker: it is
        dropped after its first failure."""
        cb = getattr(req, "on_frame", None)
        if cb is not None:
            try:
                cb(item)
            except Exception:
                req.on_frame = None

    def warmup_requests(self, reqs) -> None:
        """Submit a full concurrent wave of (tiny) requests and wait: every
        slot's prefill, install and tick run once before live traffic.
        Subclasses expose a no-arg `warmup()` that builds suitable tiny
        requests."""
        for fut in [self.submit_request(r) for r in reqs]:
            fut.result()

    def _finish(self, slot: int, result) -> None:
        req = self.active[slot]
        self.active[slot] = None
        if req is not None and not req.future.done():
            req.future.set_result(result)

    def close(self):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)
        while True:
            try:
                req = self._joinq.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError("batcher closed"))

    def _worker(self):
        thread_setup(self.device)
        with torch.inference_mode():
            while not self._stop.is_set():
                while any(a is None for a in self.active):
                    try:
                        req = self._joinq.get_nowait()
                    except queue.Empty:
                        break
                    slot = self.active.index(None)
                    try:
                        self._admit(req, slot)
                        self.active[slot] = req
                    except Exception as e:  # the request is refused, not the pool
                        self.active[slot] = None
                        if not req.future.done():
                            req.future.set_exception(e)
                if not any(a is not None for a in self.active):
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                try:
                    # subclasses increment self.steps right after the tick's
                    # device work, BEFORE resolving futures: a caller that
                    # sees a resolved future also sees the tick count
                    self._tick(self.tick_frames)
                except Exception as e:  # every live request gets it
                    self._fail_all(e)

    @property
    def dispatch_count(self) -> int:
        return self.steps


# ---------------------------------------------------------------------------
# Token-stream LMs
# ---------------------------------------------------------------------------


class LMContinuousBatcher:
    """Continuous batching for AR token-stream models (the SNAC LMs, Orpheus
    and VyvoTTS, OuteTTS, Spark): concurrent requests decode in lock-step
    through `lm.continuous.ContinuousBatcher` over the model itself or the
    `lm` it names (Spark's `llm`); the model routes through
    `hook.submit(...)`."""

    def __init__(self, model, slots: int = 4, max_len: int = 4096, lm=None, **kwargs):
        from .lm.continuous import ContinuousBatcher

        self.model = model
        self.cb = ContinuousBatcher(lm if lm is not None else model, slots=slots,
                                    max_len=max_len, **kwargs)

    def warmup(self):
        """One concurrent wave of tiny requests, one a slot: the smallest
        prefill bucket, every slot's install and a tick run before live
        traffic."""
        n = self.cb.tick_tokens + 1
        futs = [self.cb.submit([1] * 8, max_tokens=n) for _ in range(self.cb.slots)]
        for f in futs:
            f.result()

    def submit(self, *args, **kwargs):
        return self.cb.submit(*args, **kwargs)

    def install(self):
        register_infer_hook(self.model, self)
        return self

    def close(self):
        unregister_infer_hook(self.model)
        self.cb.close()

    @property
    def dispatch_count(self) -> int:
        return self.cb.steps


# ---------------------------------------------------------------------------
# Whisper adapter
# ---------------------------------------------------------------------------


class WhisperBatcher:
    """Batches Whisper 30 s-window decodes across concurrent requests.

    Each seek-loop iteration of `Model.generate` submits (mel window,
    prompt, options, tokenizer); windows whose prompt length and decoding
    options match are encoded and decoded as ONE batch (`_encode` and
    `decode_window_batch` take any batch). Rows are independent, so batched
    results equal sequential ones, to the batched matmuls' summation order.
    """

    def __init__(self, model, max_batch: int = 8, window_ms: float = 10.0):
        self.model = model
        self.sched = BatchScheduler(self._run, self._key, max_batch=max_batch,
                                    window_ms=window_ms, device=model.device)

    def _key(self, item):
        _window, prompt, opts, _tok = item
        return (
            len(prompt),
            float(opts.temperature),
            bool(opts.without_timestamps),
            opts.task,
            opts.language,
        )

    def _run(self, items):
        from .stt.models.whisper.decoding import decode_window_batch

        model = self.model
        # pad to a power-of-two batch bucket (repeat the last row), clamped
        # to max_batch, as the JAX package does (there: one compiled program
        # a bucket; here: the kernels' shapes, flash's B among them, stay
        # within the buckets warmup ran)
        n = len(items)
        padded = list(items) + [items[-1]] * (_batch_bucket(n, self.sched.max_batch) - n)
        windows = torch.stack([torch.as_tensor(w, device=model.device)
                               for w, _, _, _ in padded])
        _xa, cross_kv = model._encode(windows)
        prompts = [list(p) for _, p, _, _ in padded]
        opts = items[0][2]
        tokenizer = items[0][3]
        return decode_window_batch(
            model, cross_kv, tokenizer, prompts, opts,
            n_ctx=model.dims.n_text_ctx, n_vocab=model.dims.n_vocab,
            decoder_step=type(model)._decoder_step,
            make_caches=model._make_caches,
        )[:n]

    def __call__(self, window, prompt, opts, tokenizer):
        return self.sched((window, prompt, opts, tokenizer))

    def warmup(self, window, prompt, opts, tokenizer):
        """One batched encode and decode at every batch bucket (1, 2, 4, …,
        max_batch) for this (prompt length, options) key, before live
        traffic."""
        item = (window, prompt, opts, tokenizer)
        with torch.inference_mode():
            for b in _bucket_sizes(self.sched.max_batch):
                self._run([item] * b)

    def install(self):
        register_infer_hook(self.model, self)
        return self

    def close(self):
        unregister_infer_hook(self.model)
        self.sched.close()

    @property
    def dispatch_count(self) -> int:
        return self.sched.dispatch_count
