"""Stage-stacked batching for Bark's three stages (counterpart of
`mlx_audio_tpu/tts/models/bark/batcher.py`).

Every stage call has a fixed shape: the semantic prefill is 257 rows (text
and history each padded to 256, then the infer token), a coarse window a
317-token prefill and up to 60 decode steps, a fine chunk 512 frames. So
concurrent requests at one stage stack into one batched call of
`bark.semantic_rows`, `coarse_window_rows` or `fine_chunk_rows`: rows
advance in lock-step from position 0, and each row's true length lives in
its attention mask, its temperature and step budget in its own row.

Each row draws from its own `torch.Generator`: the semantic stage's seeded
by the request's seed, a coarse window's and a fine chunk's by the seed the
request's stage drew for it (`bark.stage_seeds`), as the single-request
path draws. Every group is padded to `max_batch` rows by repeating its
last request (`_pad_full`), so a request's tokens do not depend on how
many shared its call: batched equals the request alone through the same
pool. A coarse window runs to the largest step budget of its rows; a row's
steps past its own budget draw from all -inf logits (token 0, dropped).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ....serving import BatchScheduler, register_infer_hook, unregister_infer_hook
from .bark import (CODEBOOK_SIZE, COARSE_INFER_TOKEN, COARSE_SEMANTIC_PAD_TOKEN,
                   N_FINE_CODEBOOKS, SEMANTIC_MAX_STEPS, SEMANTIC_PAD_TOKEN,
                   SEMANTIC_VOCAB_SIZE, WINDOW_LEN, Model, coarse_window_rows,
                   fine_chunk_rows, gumbel_rows, semantic_prefill, semantic_rows)

__all__ = ["BarkBatcher"]


def _pad_full(items: List, max_batch: int) -> List:
    """Every group padded to max_batch rows with copies of its last item:
    one row count for every load, so a request's tokens are the same alone
    or fused."""
    return list(items) + [items[-1]] * (max_batch - len(items))


class BarkBatcher:
    """Three `BatchScheduler`s (semantic, coarse window, fine chunk) fuse
    concurrent requests' same-stage work into one call each. The model's
    stage methods route through an installed instance (`install`), so
    concurrent `generate` calls batch end to end while each request's host
    loop keeps its own schedule."""

    SEMANTIC_MAX_STEPS = SEMANTIC_MAX_STEPS
    WINDOW_LEN = WINDOW_LEN

    def __init__(self, model: Model, max_batch: int = 4, window_ms: float = 10.0):
        self.model = model
        self.max_batch = max_batch
        self.device = model.device

        # only same-shape work stacks (coarse prefills of another
        # max_coarse_history must not share a call)
        def shape_key(item):
            return tuple(getattr(a, "shape", None) for a in item)

        self.sem_sched, self.coarse_sched, self.fine_sched = (
            BatchScheduler(fn, shape_key, max_batch=max_batch, window_ms=window_ms,
                           device=self.device)
            for fn in (self._run_semantic, self._run_coarse, self._run_fine))

    # -- stage entry points (blocking; called from request threads) ----

    def semantic(self, ids: np.ndarray, hist: np.ndarray, temp: float, seed: int) -> np.ndarray:
        return self.sem_sched((ids, hist, float(temp), int(seed)))

    def coarse_window(self, prefill: np.ndarray, ctx_len: int, n_step: int, n_steps: int,
                      seed: int, temp: float) -> np.ndarray:
        return self.coarse_sched((prefill, int(ctx_len), int(n_step), int(n_steps), int(seed),
                                  float(temp)))

    def fine_chunk(self, seg: np.ndarray, temp: float, seed: int) -> np.ndarray:
        return self.fine_sched((seg, float(temp), int(seed)))

    # -- batched runners ----------------------------------------------

    def _tensor(self, rows, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows), dtype=dtype, device=self.device)

    def _generators(self, seeds) -> List[torch.Generator]:
        return [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]

    def _run_semantic(self, items):
        n = len(items)
        items = _pad_full(items, self.max_batch)
        gpt = self.model.semantic
        prefill = semantic_prefill(gpt, self._tensor([it[0] for it in items]),
                                   self._tensor([it[1] for it in items]))
        gens = self._generators(it[3] for it in items)
        out, cnt = semantic_rows(
            gpt, prefill, self._tensor([it[2] for it in items], torch.float32),
            lambda i: gumbel_rows(gens, (SEMANTIC_VOCAB_SIZE + 1,), self.device),
            self.SEMANTIC_MAX_STEPS)
        out, cnt = out.cpu().numpy(), cnt.cpu().numpy()
        return [out[i, :int(cnt[i])].astype(np.int32) for i in range(n)]

    def _run_coarse(self, items):
        n = len(items)
        items = _pad_full(items, self.max_batch)
        gpt = self.model.coarse_acoustics
        steps = max(min(self.WINDOW_LEN, it[3] - it[2]) for it in items)
        gens = self._generators(it[4] for it in items)
        out = coarse_window_rows(
            gpt, self._tensor([it[0] for it in items]), self._tensor([it[1] for it in items]),
            self._tensor([it[2] for it in items]), self._tensor([it[3] for it in items]),
            self._tensor([it[5] for it in items], torch.float32),
            lambda i: gumbel_rows(gens, (gpt.config.output_vocab_size,), self.device),
            steps, self.WINDOW_LEN).cpu().numpy()
        return [out[i] for i in range(n)]

    def _run_fine(self, items):
        n = len(items)
        items = _pad_full(items, self.max_batch)
        gens = self._generators(it[2] for it in items)
        idx = fine_chunk_rows(
            self.model.fine_acoustics, self._tensor([it[0] for it in items]),
            self._tensor([it[1] for it in items], torch.float32),
            lambda cb: gumbel_rows(gens, items[0][0].shape[:1] + (CODEBOOK_SIZE,), self.device))
        out = idx.cpu().numpy()
        return [out[i] for i in range(n)]

    # -- pipeline integration -----------------------------------------

    @property
    def dispatch_count(self) -> int:
        return (self.sem_sched.dispatch_count + self.coarse_sched.dispatch_count
                + self.fine_sched.dispatch_count)

    def warmup(self):
        """One call of each stage on padding: the semantic stage runs to a
        stop or to its 768-step cap (whose last step reads position 1024,
        clamped to the table's last row), a coarse window takes two steps, a
        fine chunk infills 512 frames."""
        ids = np.full(256, SEMANTIC_PAD_TOKEN, np.int64)
        self.semantic(ids, ids.copy(), 0.7, 0)
        prefill = np.full(256 + 1 + WINDOW_LEN, COARSE_SEMANTIC_PAD_TOKEN, np.int32)
        prefill[256] = COARSE_INFER_TOKEN
        self.coarse_window(prefill, 257, 0, 2, 0, 0.7)
        seg = np.full((512, N_FINE_CODEBOOKS), CODEBOOK_SIZE, np.int32)
        self.fine_chunk(seg, 0.5, 0)

    def install(self):
        register_infer_hook(self.model, self)
        return self

    def close(self):
        unregister_infer_hook(self.model)
        self.sem_sched.close()
        self.coarse_sched.close()
        self.fine_sched.close()
