"""Whisper decoding (counterpart of
`mlx_audio_tpu/stt/models/whisper/decoding.py`).

The JAX package compiles the autoregressive loop into one on-device
`lax.while_loop`; here it is a plain Python loop over eager steps, with the
same logit rules, the same greedy and sampled choices and the same
bookkeeping. The stop test reads `done.all()` on the host once per step.
Beam search (`_beam_decode_loop`) keeps its state on the device in the same
way, with one host read a step for its own stop test.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["DecodingOptions", "DecodingResult", "decode_window", "decode_window_batch"]


@dataclass
class DecodingOptions:
    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[List[int]] = None
    prefix: Optional[str] = None
    suppress_tokens: Optional[str] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    fp16: bool = True


@dataclass
class DecodingResult:
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = float("nan")
    no_speech_prob: float = float("nan")
    temperature: float = 0.0
    compression_ratio: float = float("nan")
    language: Optional[str] = None


def compression_ratio(text: str) -> float:
    import zlib

    b = text.encode("utf-8")
    if not b:
        return 0.0
    return len(b) / len(zlib.compress(b))


def verify_options(options: DecodingOptions) -> None:
    """Inconsistent option combinations raise instead of being ignored."""
    if options.beam_size is not None and options.best_of is not None:
        raise ValueError("beam_size and best_of can't be given together")
    if options.best_of is not None and options.temperature == 0:
        raise ValueError("best_of with greedy sampling (t=0) is not compatible")
    if options.patience is not None and options.beam_size is None:
        raise ValueError("patience requires beam_size to be given")
    if options.length_penalty is not None and not (
        0 <= options.length_penalty <= 1
    ):
        raise ValueError("length_penalty (alpha) should be a value between 0 and 1")


def rank_score(
    sum_logprob: float, length: int, length_penalty: Optional[float]
) -> float:
    """Total logprob normalised by the Google-NMT length penalty (or plain
    length)."""
    if length_penalty is None:
        penalty = float(max(length, 1))
    else:
        penalty = ((5.0 + length) / 6.0) ** length_penalty
    return sum_logprob / penalty


def _apply_rules(
    logits,  # (B, V) f32
    step: int,
    last_tok,  # (B,)
    penult_tok,  # (B,)
    last_ts,  # (B,)
    *,
    suppress_mask,  # (V,) bool
    eot: int,
    timestamp_begin: int,
    no_timestamps: int,
    blank: int,
    without_timestamps: bool,
    max_initial_ts_index: int,
):
    """The logit-filter lattice (suppress tokens, suppress blank, timestamp
    rules) as one row-wise function."""
    neg = float("-inf")
    V = suppress_mask.shape[0]
    vocab_idx = torch.arange(V, device=logits.device)
    is_ts = vocab_idx >= timestamp_begin

    logits = logits.masked_fill(suppress_mask[None, :], neg)
    if step == 0:  # suppress blank at the first sampled token
        logits[:, blank] = neg
        logits[:, eot] = neg
    if without_timestamps:
        return logits.masked_fill(is_ts[None, :], neg)

    logits[:, no_timestamps] = neg
    last_was_ts = last_tok >= timestamp_begin
    penult_was_ts = penult_tok >= timestamp_begin
    # timestamps come in pairs
    logits = logits.masked_fill(
        (last_was_ts & penult_was_ts)[:, None] & is_ts[None, :], neg)
    logits = logits.masked_fill(
        (last_was_ts & ~penult_was_ts)[:, None] & (vocab_idx < eot)[None, :], neg)
    # monotonic timestamps
    ts_floor = torch.where(last_was_ts & ~penult_was_ts, last_ts, last_ts + 1)
    logits = logits.masked_fill(
        is_ts[None, :] & (vocab_idx[None, :] < ts_floor[:, None]), neg)
    if step == 0:  # first sampled token is a timestamp, capped at max_initial
        init_bad = (~is_ts) | (vocab_idx > timestamp_begin + max_initial_ts_index)
        logits = logits.masked_fill(init_bad[None, :], neg)
    # if P(timestamp) > max P(text token), force a timestamp
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts[None, :], neg), dim=-1)
    max_text = logprobs.masked_fill(is_ts[None, :], neg).amax(dim=-1)
    force_ts = ts_logprob > max_text
    return logits.masked_fill(force_ts[:, None] & ~is_ts[None, :], neg)


# The Gumbel-max sampler's uniform noise is drawn NOISE_STEPS steps ahead,
# one (NOISE_STEPS, V) draw a row from that row's own generator: a window's
# noise is the same alone or batched with others, and a batch of B rows
# costs B launches every NOISE_STEPS steps
NOISE_STEPS = 16


def uniform_noise(generators: List[torch.Generator], V: int, dev) -> torch.Tensor:
    """(B, NOISE_STEPS, V) uniform draws, row b from generators[b]; step s
    of a decode reads [:, s % NOISE_STEPS] of the draw made at the step
    NOISE_STEPS * (s // NOISE_STEPS)."""
    u = torch.empty(len(generators), NOISE_STEPS, V, device=dev)
    for row, g in zip(u, generators):
        torch.rand(NOISE_STEPS, V, generator=g, device=dev, out=row)
    return u


@torch.inference_mode()
def _decode_loop(
    model,
    caches,
    cross_kv,
    prompt,  # (B, Tp) int64
    suppress_mask,  # (V,) bool — True = suppress
    generators: Optional[List[torch.Generator]],  # one a row, for t > 0
    decoder_step,  # fn(model, tokens (B,t), pos0, caches, cross_kv) -> (logits, caches)
    sample_len: int,
    n_ctx: int,
    eot: int,
    timestamp_begin: int,
    no_timestamps: int,
    blank: int,
    no_speech: int,
    without_timestamps: bool,
    max_initial_ts_index: int,
    temperature: float,
    sot_index: int = 0,
):
    B, Tp = prompt.shape
    dev = prompt.device

    # ---- prefill ----
    logits, caches = decoder_step(model, prompt, 0, caches, cross_kv)
    last_logits = logits[:, -1, :].float()
    # P(<|nospeech|>) is read at the SOT position: the output distribution
    # after consuming <|startoftranscript|>
    sot_probs = torch.softmax(logits[:, sot_index, :].float(), dim=-1)
    no_speech_prob = sot_probs[:, no_speech]

    tokens_buf = torch.full((B, n_ctx), eot, dtype=torch.long, device=dev)
    tokens_buf[:, :Tp] = prompt
    sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    last_ts = torch.full((B,), timestamp_begin, dtype=torch.long, device=dev)

    step = 0
    while step < sample_len and not bool(done.all()):
        pos = Tp + step
        filtered = _apply_rules(
            last_logits, step, tokens_buf[:, pos - 1], tokens_buf[:, pos - 2],
            last_ts, suppress_mask=suppress_mask, eot=eot,
            timestamp_begin=timestamp_begin, no_timestamps=no_timestamps,
            blank=blank, without_timestamps=without_timestamps,
            max_initial_ts_index=max_initial_ts_index,
        )
        if temperature == 0.0:
            next_tok = torch.argmax(filtered, dim=-1)
        else:  # Gumbel-max draw from softmax(filtered / temperature)
            if step % NOISE_STEPS == 0:
                noise = uniform_noise(generators, filtered.shape[-1], dev)
            u = noise[:, step % NOISE_STEPS]
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            next_tok = torch.argmax(filtered / temperature + gumbel, dim=-1)
        logprobs = torch.log_softmax(filtered, dim=-1)
        tok_lp = logprobs.gather(-1, next_tok[:, None])[:, 0]
        sum_lp = sum_lp + torch.where(done, 0.0, tok_lp)
        next_tok = torch.where(done, eot, next_tok)
        done = done | (next_tok == eot)
        last_ts = torch.where(~done & (next_tok >= timestamp_begin), next_tok, last_ts)
        tokens_buf[:, pos] = next_tok
        logits, caches = decoder_step(model, next_tok[:, None], pos, caches, cross_kv)
        last_logits = logits[:, -1, :].float()
        step += 1
    return tokens_buf, step, sum_lp, no_speech_prob


@torch.inference_mode()
def _beam_decode_loop(
    model,
    caches,
    cross_kv,
    prompt,  # (G*K, Tp) int64: each window's prompt repeated K times
    suppress_mask,  # (V,) bool
    decoder_step,
    sample_len: int,
    n_ctx: int,
    eot: int,
    timestamp_begin: int,
    no_timestamps: int,
    blank: int,
    no_speech: int,
    without_timestamps: bool,
    max_initial_ts_index: int,
    beam_size: int,
    max_candidates: int,  # round(beam_size * patience) finished hypotheses per group
    sot_index: int = 0,
):
    """Beam search with its state on the device (openai-whisper's
    BeamSearchDecoder semantics, as the JAX package's `_beam_decode_loop`).

    Beams are extra batch rows: G windows × K beams, in contiguous blocks of
    K. Each step scores all K×V continuations per group and takes the top
    2K (EOT appears at most once per source beam, so at least K non-EOT
    survive). EOT-ending candidates with a finite score are banked, in score
    order, into fixed-capacity finished buffers; the first K non-EOT
    candidates become the next beams, and tokens and KV caches are
    reordered along the batch axis. A group is complete when
    `max_candidates` hypotheses have finished; that test is the one host
    read a step."""
    GK, Tp = prompt.shape
    K = beam_size
    G = GK // K
    C = max_candidates
    dev = prompt.device
    neg = float("-inf")

    # ---- prefill (the K rows of a group are identical; only beam 0 is
    # live at step 0, so the first expansion has no duplicates) ----
    logits, caches = decoder_step(model, prompt, 0, caches, cross_kv)
    last_logits = logits[:, -1, :].float()
    sot_probs = torch.softmax(logits[:, sot_index, :].float(), dim=-1)
    no_speech_prob = sot_probs[::K, no_speech]  # (G,)

    tokens_buf = torch.full((GK, n_ctx), eot, dtype=torch.long, device=dev)
    tokens_buf[:, :Tp] = prompt
    cum_lp = torch.full((K,), neg, device=dev)
    cum_lp[0] = 0.0
    cum_lp = cum_lp.repeat(G)  # (GK,)
    last_ts = torch.full((GK,), timestamp_begin, dtype=torch.long, device=dev)

    # finished buffers with one dump column (index C) for writes past capacity
    fin_lp = torch.full((G, C + 1), neg, device=dev)
    fin_len = torch.zeros((G, C + 1), dtype=torch.long, device=dev)
    fin_toks = torch.full((G, C + 1, n_ctx), eot, dtype=torch.long, device=dev)
    fin_count = torch.zeros((G,), dtype=torch.long, device=dev)

    group_off = torch.arange(G, device=dev)[:, None] * K  # (G, 1)
    rows = torch.arange(G, device=dev)[:, None]
    col = torch.arange(2 * K, device=dev).expand(G, 2 * K)

    step = 0
    while step < sample_len and not bool((fin_count >= C).all()):
        pos = Tp + step
        filtered = _apply_rules(
            last_logits, step, tokens_buf[:, pos - 1], tokens_buf[:, pos - 2],
            last_ts, suppress_mask=suppress_mask, eot=eot,
            timestamp_begin=timestamp_begin, no_timestamps=no_timestamps,
            blank=blank, without_timestamps=without_timestamps,
            max_initial_ts_index=max_initial_ts_index,
        )
        logprobs = torch.log_softmax(filtered, dim=-1)  # (GK, V)
        V = logprobs.shape[-1]
        cand = (cum_lp[:, None] + logprobs).reshape(G, K * V)
        # the top 2K, equal scores in index order, as jax.lax.top_k ranks
        # them (torch.topk leaves their order open; bf16 logits tie often)
        top_vals, top_idx = torch.sort(cand, dim=1, descending=True, stable=True)
        top_vals, top_idx = top_vals[:, :2 * K], top_idx[:, :2 * K]  # (G, 2K)
        tok = top_idx % V
        src = top_idx // V  # source beam within the group
        is_eot_c = tok == eot

        # ---- bank EOT-ending candidates, in score order ----
        slot = fin_count[:, None] + torch.cumsum(is_eot_c, dim=1) - 1
        write = is_eot_c & (slot < C) & torch.isfinite(top_vals)
        slot_c = torch.where(write, slot, C)
        cand_toks = tokens_buf[group_off + src]  # (G, 2K, n_ctx); pos.. is EOT
        fin_lp[rows, slot_c] = torch.where(write, top_vals, 0.0)
        fin_len[rows, slot_c] = torch.where(write, step, 0)
        fin_toks[rows, slot_c] = torch.where(write[:, :, None], cand_toks, eot)
        fin_count = fin_count + write.sum(dim=1)

        # ---- the first K non-EOT candidates become the next beams ----
        noneot_rank = torch.cumsum(~is_eot_c, dim=1) - 1
        slot_b = torch.where(~is_eot_c & (noneot_rank < K), noneot_rank, K)
        choice = torch.zeros((G, K + 1), dtype=torch.long, device=dev)
        choice[rows, slot_b] = col
        choice = choice[:, :K]  # (G, K): index into the 2K candidates
        flat_src = (group_off + src.gather(1, choice)).reshape(-1)  # (GK,)
        next_tok = tok.gather(1, choice).reshape(-1)
        cum_lp = top_vals.gather(1, choice).reshape(-1)

        # ---- reorder the beam state by source beam ----
        tokens_buf = tokens_buf[flat_src]
        tokens_buf[:, pos] = next_tok
        last_ts = torch.where(next_tok >= timestamp_begin, next_tok, last_ts[flat_src])
        for c in caches:
            c.reorder(flat_src)
        logits, caches = decoder_step(model, next_tok[:, None], pos, caches, cross_kv)
        last_logits = logits[:, -1, :].float()
        step += 1
    return (tokens_buf, step, cum_lp, fin_lp[:, :C], fin_len[:, :C], fin_toks[:, :C],
            fin_count, no_speech_prob)


def _run_beam(
    model, caches, cross_kv, prompt, suppress, tokenizer, options,
    decoder_step, *, sample_len, n_ctx, blank, max_init, sot_index,
) -> List[DecodingResult]:
    """`_beam_decode_loop`, one fetch, then openai-whisper's finalisation:
    a group short of `beam_size` finished hypotheses is topped up with its
    live beams (EOT appended, no extra logprob), and the winner is picked by
    `rank_score`."""
    K = int(options.beam_size)
    patience = options.patience if options.patience is not None else 1.0
    max_candidates = max(1, round(K * float(patience)))
    GK, Tp = prompt.shape

    state = _beam_decode_loop(
        model, caches, cross_kv, prompt, suppress, decoder_step,
        sample_len=sample_len, n_ctx=n_ctx, eot=tokenizer.eot,
        timestamp_begin=tokenizer.timestamp_begin,
        no_timestamps=tokenizer.no_timestamps, blank=blank,
        no_speech=tokenizer.no_speech,
        without_timestamps=options.without_timestamps,
        max_initial_ts_index=max_init, beam_size=K,
        max_candidates=max_candidates, sot_index=sot_index,
    )
    n_steps = state[1]
    toks, _, cum_lp, fin_lp, fin_len, fin_toks, fin_count, nsp = (
        x if isinstance(x, int) else x.cpu().numpy() for x in state)

    results = []
    for g in range(GK // K):
        # (tokens, sum_logprob) candidates: the finished ones first
        cands = []
        for c in range(int(fin_count[g])):
            ln = int(fin_len[g, c])
            seq = [int(t) for t in fin_toks[g, c, Tp : Tp + ln]]
            cands.append((seq, float(fin_lp[g, c])))
        if len(cands) < K:
            live = sorted(range(g * K, (g + 1) * K), key=lambda b: -float(cum_lp[b]))
            for b in live:
                if len(cands) >= K:
                    break
                if not np.isfinite(cum_lp[b]):
                    continue
                seq = []
                for t in toks[b, Tp : Tp + n_steps]:
                    if t == tokenizer.eot:
                        break
                    seq.append(int(t))
                cands.append((seq, float(cum_lp[b])))
        if not cands:  # degenerate (e.g. sample_len=0): empty result
            cands = [([], 0.0)]
        seq, lp = max(
            cands,
            key=lambda sl: rank_score(sl[1], len(sl[0]), options.length_penalty),
        )
        text = tokenizer.decode(seq).strip()
        results.append(
            DecodingResult(
                tokens=seq,
                text=text,
                avg_logprob=lp / (len(seq) + 1),
                no_speech_prob=float(nsp[g]),
                temperature=0.0,
                compression_ratio=compression_ratio(text),
                language=options.language,
            )
        )
    return results


def _suppress_mask(tokenizer, options: DecodingOptions, n_vocab: int) -> np.ndarray:
    suppress = np.zeros((n_vocab,), bool)
    ids: List[int] = []
    if options.suppress_tokens:
        st = options.suppress_tokens
        if isinstance(st, str):
            ids = [int(t) for t in st.split(",") if t.strip() and t != "-1"]
            if "-1" in st:
                ids.extend(tokenizer.non_speech_tokens)
        else:
            ids = list(st)
    # control tokens are ALWAYS suppressed, even when the caller passes
    # suppress_tokens=None/""
    ids.extend(
        [tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
         tokenizer.sot_prev, getattr(tokenizer, "sot_lm", tokenizer.sot_prev)]
    )
    for i in ids:
        if 0 <= i < n_vocab:
            suppress[i] = True
    suppress[tokenizer.no_speech] = True
    return suppress


def decode_window_batch(
    model,
    cross_kv,
    tokenizer,
    prompt_rows: Sequence[Sequence[int]],
    options: DecodingOptions,
    n_ctx: int,
    n_vocab: int,
    decoder_step,
    make_caches,
    sample_len: int = 224,
    seed: int = 0,
) -> List[DecodingResult]:
    """Decode B 30 s windows as one batch. All rows share the prompt length
    and the options; cross_kv carries the batched encoder output. Tokens
    come to the host once, at the end.

    With ``options.best_of=N`` (temperature > 0) each window is decoded as
    N sample rows in the same batch and the winner is picked by likelihood
    ranking with the length penalty. Sampling draws from one torch.Generator
    a row on the decode's device, the j-th sample of a window seeded with
    `seed + j`: a window's draws are the same alone or batched with others
    (a serving batcher's rows equal their sequential calls).

    With ``options.beam_size=K`` (temperature 0) each window is decoded by
    beam search (`_beam_decode_loop`), its K beams as K batch rows, and the
    winner is picked by the same ranking over the finished hypotheses."""
    verify_options(options)
    rows = [list(p) for p in prompt_rows]
    assert len({len(r) for r in rows}) == 1, "prompt rows must share a length"
    dev = cross_kv[0][0].device
    prompt = torch.tensor(rows, dtype=torch.long, device=dev)

    use_beam = options.beam_size is not None and options.temperature == 0
    n_group = 1
    if use_beam:
        n_group = int(options.beam_size)
    elif options.best_of is not None and options.temperature > 0:
        n_group = int(options.best_of)
    if n_group > 1:
        prompt = prompt.repeat_interleave(n_group, dim=0)
        cross_kv = [(k.repeat_interleave(n_group, dim=0),
                     v.repeat_interleave(n_group, dim=0)) for k, v in cross_kv]

    suppress = torch.from_numpy(_suppress_mask(tokenizer, options, n_vocab)).to(dev)
    blank_ids = tokenizer.encode(" ")
    blank = blank_ids[0] if blank_ids else tokenizer.eot
    precision = 0.02
    if options.max_initial_timestamp is None:
        max_init = n_vocab  # uncapped
    else:
        max_init = round(options.max_initial_timestamp / precision)

    Tp = prompt.shape[1]
    if options.sample_len:  # the sample_len option caps the decode
        sample_len = int(options.sample_len)
    # never write past tokens_buf/KV capacity
    sample_len = max(1, min(sample_len, n_ctx - Tp - 1))

    # KV capacity: what this decode can write (prompt + samples + 1),
    # bucketed by 64; per-step self-attention reads scale with capacity
    cap = min(n_ctx, -(-(Tp + sample_len + 1) // 64) * 64)
    caches = make_caches(len(rows) * n_group, cap)
    # index of <|startoftranscript|> in the prompt: the sot sequence sits at
    # the END (possibly followed by <|notimestamps|>)
    sot_index = max(
        0, Tp - len(list(tokenizer.sot_sequence)) - (1 if options.without_timestamps else 0))

    if use_beam:
        return _run_beam(
            model, caches, cross_kv, prompt, suppress, tokenizer, options,
            decoder_step, sample_len=sample_len, n_ctx=n_ctx, blank=blank,
            max_init=max_init, sot_index=sot_index,
        )

    generators = None
    if options.temperature > 0:
        generators = [torch.Generator(device=dev).manual_seed(seed + j)
                      for _ in rows for j in range(n_group)]
    tokens_buf, n_steps, sum_lp, no_speech_prob = _decode_loop(
        model, caches, cross_kv, prompt, suppress, generators, decoder_step,
        sample_len=sample_len, n_ctx=n_ctx, eot=tokenizer.eot,
        timestamp_begin=tokenizer.timestamp_begin,
        no_timestamps=tokenizer.no_timestamps, blank=blank,
        no_speech=tokenizer.no_speech,
        without_timestamps=options.without_timestamps,
        max_initial_ts_index=max_init, temperature=float(options.temperature),
        sot_index=sot_index,
    )
    toks = tokens_buf.cpu().numpy()
    sum_lp = sum_lp.cpu().numpy()
    nsp = no_speech_prob.cpu().numpy()

    def row_result(b: int) -> DecodingResult:
        seq = []
        for t in toks[b, Tp : Tp + n_steps]:
            if t == tokenizer.eot:
                break
            seq.append(int(t))
        text = tokenizer.decode(seq).strip()
        n_tok = len(seq) + 1
        return DecodingResult(
            tokens=seq,
            text=text,
            avg_logprob=float(sum_lp[b]) / max(n_tok, 1),
            no_speech_prob=float(nsp[b]),
            temperature=options.temperature,
            compression_ratio=compression_ratio(text),
            language=options.language,
        )

    results = []
    for g in range(len(rows)):
        idxs = range(g * n_group, (g + 1) * n_group)
        group = [(row_result(b), float(sum_lp[b])) for b in idxs]
        best, _ = max(
            group,
            key=lambda rl: rank_score(
                rl[1], len(rl[0].tokens), options.length_penalty
            ),
        )
        results.append(best)
    return results



def decode_window(
    model,
    cross_kv,
    tokenizer,
    prompt_tokens: Sequence[int],
    options: DecodingOptions,
    n_ctx: int,
    n_vocab: int,
    decoder_step,
    make_caches,
    sample_len: int = 224,
    seed: int = 0,
) -> DecodingResult:
    """Decode one 30 s window (the seek loop's call)."""
    return decode_window_batch(
        model, cross_kv, tokenizer, [list(prompt_tokens)], options,
        n_ctx, n_vocab, decoder_step, make_caches,
        sample_len=sample_len, seed=seed,
    )[0]
