"""CTC prefix beam search with LM shallow fusion.

Counterpart of the JAX package's ``ops/beam_search.py``, with its semantics:

- beams are keyed by the collapsed token sequence plus a trailing-blank
  marker; per frame a beam extends by blank (``+ am[blank] +
  blank_penalty``), by a repeat of its last token when that was not followed
  by blank (``+ repetition_penalty``), or by a new token with the fused score
  ``am + alpha·lm + beta``;
- only tokens with ``am > max + top_am_threshold`` are proposed, token id 0
  never unless ``exclude_token_zero=False``;
- equal-key beams merge by log-sum-exp, then the best ``beam_width`` are
  kept and those more than ``prune_less_than_val`` below the best drop;
- the LM advances only for beams that emitted a new token.

Two implementations with the same results: :class:`BeamSearchHost`, a plain
loop over Python beams (the reference of the tests), and
:func:`beam_search_device`, fixed-width tensors on the log-probs' device:
prefixes as 64-bit rolling hashes (one wrapping int64, as in
:mod:`..lm.ngram`), merges by a pairwise equality mask and row log-sum-exp,
the LM state carried lazily (beam reorders compose into a permutation; the
state is gathered and advanced only on frames where a kept beam emitted).

The JAX version is one ``lax.scan``; here the frame loop runs in Python.
Each frame's branch (full step, blank-only step, idle) depends on the
log-probs alone, so all branches are read to the host in one transfer per
call; a full step then reads one small tensor (whether the beams died,
whether any emitted, and the step's backpointers) to decide on the LM
advance.  Tokens are rebuilt once per call from those backpointers.

LM adapters: ``init_state(batch) -> (state, lps [batch, V])``,
``advance(state, tokens [batch], mask [batch]) -> (state, lps)``,
``gather(state, idx)``, and the ``device`` their state lives on.
``advance`` may write into the state it is given (the transformer LM's ring
cache does), so both searches pass it the output of ``gather``, never a
state that a beam still holds.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.lm.arpa_native import HASH_INC
from dynamic_asr_eval_tpu_torch.lm.ngram import roll_hash
from dynamic_asr_eval_tpu_torch.lm.transformer_lm import empty_cache, model_device

NEG = -1e30


# ---------------------------------------------------------------------------
# LM adapters
# ---------------------------------------------------------------------------


class UniformLMAdapter:
    """No-LM fusion: every next-token log-prob is 0."""

    def __init__(self, vocab_size: int, device: Optional[Union[str, torch.device]] = None):
        self.vocab_size = vocab_size
        self.device = resolve_device(device)

    def init_state(self, batch: int):
        return (torch.zeros((batch, 0), dtype=torch.int64, device=self.device),
                torch.zeros((batch, self.vocab_size), device=self.device))

    def advance(self, state, tokens, mask):
        return state, torch.zeros((tokens.shape[0], self.vocab_size), device=self.device)

    def gather(self, state, idx):
        return state[idx]


class NGramAdapter:
    """Backoff n-gram fusion over :class:`..lm.ngram.NGramLM`.  State: the
    last ``order - 1`` token ids per beam (right-aligned, -1 padded) and
    their count."""

    def __init__(self, ngram, bos_id: Optional[int] = None):
        self.lm = ngram
        self.device = ngram.device
        self.ctx = max(ngram.order - 1, 1)
        self.bos_id = bos_id

    def init_state(self, batch: int):
        toks = torch.full((batch, self.ctx), -1, dtype=torch.int64, device=self.device)
        lens = torch.zeros((batch,), dtype=torch.int64, device=self.device)
        if self.bos_id is not None:
            toks[:, -1] = self.bos_id
            lens += 1
        return (toks, lens), self.lm.score_next(toks, lens)

    def advance(self, state, tokens, mask):
        toks, lens = state
        new_toks = torch.cat([toks[:, 1:], tokens[:, None].to(torch.int64)], dim=1)
        toks = torch.where(mask[:, None], new_toks, toks)
        lens = torch.where(mask, torch.clamp(lens + 1, max=self.ctx), lens)
        return (toks, lens), self.lm.score_next(toks, lens)

    def gather(self, state, idx):
        toks, lens = state
        return toks[idx], lens[idx]


class TransformerLMAdapter:
    """Neural-LM fusion over :class:`..lm.transformer_lm.TransformerLM` with
    its fixed-size ring-buffer cache.  ``advance`` writes the emitting rows'
    ring slots into the state it is given; rows whose ``mask`` is false
    keep their cache and length."""

    def __init__(self, model, config, bos_id: int = 0):
        self.model = model.eval()
        self.config = config
        self.bos_id = bos_id
        self.device = model_device(model)

    @torch.no_grad()
    def init_state(self, batch: int):
        cache = empty_cache(self.config, batch, self.device)
        toks = torch.full((batch,), self.bos_id, dtype=torch.int64, device=self.device)
        lps, cache = self.model(toks, cache)
        return cache, lps

    @torch.no_grad()
    def advance(self, state, tokens, mask):
        lps, cache = self.model(tokens, state, write_mask=mask)
        return cache, lps

    def gather(self, state, idx):
        return {"k": state["k"][:, idx], "v": state["v"][:, idx],
                "lengths": state["lengths"][idx]}


# ---------------------------------------------------------------------------
# blank-run collapse
# ---------------------------------------------------------------------------


def collapse_blank_frames(
    log_probs: np.ndarray,  # [T, V+1]
    blank_id: Optional[int] = None,
    threshold: float = 0.995,
) -> np.ndarray:
    """Drop frames whose blank probability exceeds ``threshold``, keeping
    the first frame of each blank run so that repeats stay separated (host
    numpy)."""
    lp = np.asarray(log_probs)
    blank = lp.shape[1] - 1 if blank_id is None else blank_id
    blank_dom = lp[:, blank] > np.log(threshold)
    prev_dom = np.concatenate([[False], blank_dom[:-1]])
    return lp[~(blank_dom & prev_dom)]


def collapse_blank_frames_device(
    log_probs: torch.Tensor,  # [T, V+1]
    blank_id: Optional[int] = None,
    threshold: float = 0.995,
    valid_frames=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`collapse_blank_frames` on the log-probs' device, frames at or
    past ``valid_frames`` dropped.  Returns ``(compacted [T, V+1], zero rows
    from n_kept on; n_kept, a 0-d tensor)``."""
    lp = log_probs
    T = lp.shape[0]
    blank = lp.shape[1] - 1 if blank_id is None else blank_id
    frames = torch.arange(T, device=lp.device)
    valid = frames < (T if valid_frames is None else torch.as_tensor(valid_frames, device=lp.device))
    log_thr = torch.log(torch.tensor(threshold, dtype=torch.float32, device=lp.device))
    blank_dom = (lp[:, blank].float() > log_thr) & valid
    prev_dom = torch.cat([blank_dom.new_zeros(1), blank_dom[:-1]])
    keep = ~(blank_dom & prev_dom) & valid
    pos = torch.where(keep, torch.cumsum(keep, 0) - 1, T)  # dropped rows go to a dump row
    out = lp.new_zeros((T + 1, lp.shape[1])).index_copy_(0, pos, lp)
    return out[:T], keep.sum()


# ---------------------------------------------------------------------------
# host reference
# ---------------------------------------------------------------------------


class _HostBeam(NamedTuple):
    prefix: tuple  # collapsed token sequence
    ends_blank: bool
    score: float
    lm_state: object  # adapter state of batch 1
    lm_lps: np.ndarray  # [V]


def _logaddexp(a, b):
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


class BeamSearchHost:
    """The reference semantics as a plain loop over beams, one batch-1 LM
    state per beam (clarity over speed: the tests' reference)."""

    def __init__(
        self,
        log_probs,  # [T, V+1], numpy or a tensor
        lm_adapter,
        beam_width: int = 25,
        alpha: float = 0.45,
        beta: float = 1.53,
        blank_id: Optional[int] = None,
        blank_penalty: float = 0.0,
        repetition_penalty: float = 0.0,
        top_am_threshold: float = -6.0,
        prune_less_than_val: Optional[float] = 3.17,
        exclude_token_zero: bool = True,
    ):
        lp = log_probs.detach().float().cpu().numpy() if torch.is_tensor(log_probs) else log_probs
        self.log_probs = np.asarray(lp)
        self.V = self.log_probs.shape[1] - 1
        self.blank_id = self.V if blank_id is None else blank_id
        self.lm = lm_adapter
        self.beam_width = beam_width
        self.alpha, self.beta = alpha, beta
        self.blank_penalty = blank_penalty
        self.repetition_penalty = repetition_penalty
        self.top_am_threshold = top_am_threshold
        self.prune_less_than_val = prune_less_than_val
        self.exclude_token_zero = exclude_token_zero
        self.beams: List[_HostBeam] = []

    def run_search(self) -> List[Tuple[tuple, float]]:
        T = self.log_probs.shape[0]
        state, lps = self.lm.init_state(1)
        self.beams = [_HostBeam((), False, 0.0, state, lps[0].cpu().numpy())]
        lo = 1 if self.exclude_token_zero else 0
        for t in range(T):
            am = self.log_probs[t]
            thresh = am.max() + self.top_am_threshold
            top = [v for v in range(lo, self.V + 1) if am[v] > thresh]
            cand = {}  # key -> [score, parent beam, is_new, token]
            for beam in self.beams:
                for v in top:
                    if v == self.blank_id:
                        key, entry = (beam.prefix, True), (beam, False, -1)
                        s = beam.score + am[v] + self.blank_penalty
                    elif beam.prefix and beam.prefix[-1] == v and not beam.ends_blank:
                        key, entry = (beam.prefix, False), (beam, False, -1)
                        s = beam.score + am[v] + self.repetition_penalty
                    else:
                        key, entry = (beam.prefix + (v,), False), (beam, True, v)
                        s = beam.score + am[v] + self.alpha * beam.lm_lps[v] + self.beta
                    if key in cand:
                        cand[key][0] = _logaddexp(cand[key][0], s)
                    else:
                        cand[key] = [s, *entry]
            if not cand:
                continue  # nothing proposable: skip the frame instead of dying
            merged = sorted(cand.items(), key=lambda kv: -kv[1][0])[: self.beam_width]
            if self.prune_less_than_val is not None:
                best = merged[0][1][0]
                merged = [m for m in merged if m[1][0] >= best - self.prune_less_than_val]
            new_beams = []
            for (prefix, ends_blank), (s, parent, is_new, tok) in merged:
                if is_new and t < T - 1:
                    dev = self.lm.device
                    own = self.lm.gather(parent.lm_state, torch.zeros((1,), dtype=torch.int64,
                                                                      device=dev))
                    st, lp = self.lm.advance(own, torch.tensor([tok], device=dev),
                                             torch.ones((1,), dtype=torch.bool, device=dev))
                    new_beams.append(_HostBeam(prefix, ends_blank, s, st, lp[0].cpu().numpy()))
                else:
                    new_beams.append(_HostBeam(prefix, ends_blank, s, parent.lm_state,
                                               parent.lm_lps))
            self.beams = new_beams
        if hasattr(self.lm, "final_scores"):
            self.beams = sorted(
                (b._replace(score=b.score + self.alpha * float(self.lm.final_scores(b.lm_state)[0]))
                 for b in self.beams), key=lambda b: -b.score)
        return [(b.prefix, b.score) for b in self.beams]

    def return_text(self, idx: int, tokenizer) -> str:
        if idx >= len(self.beams):
            return ""
        return tokenizer.decode(list(self.beams[idx].prefix))


# ---------------------------------------------------------------------------
# tensorized search
# ---------------------------------------------------------------------------


class DeviceBeamState(NamedTuple):
    score: torch.Tensor  # [B] f32
    hash: torch.Tensor  # [B] int64 prefix hash (without the trailing blank)
    ends_blank: torch.Tensor  # [B] bool
    last_token: torch.Tensor  # [B] int64 (-1: none)
    tokens: torch.Tensor  # [B, Lmax] int64
    length: torch.Tensor  # [B] int64
    lm_lps: torch.Tensor  # [B, V] f32
    lm_state: object


def _merge(score: torch.Tensor, eq: torch.Tensor, alive: torch.Tensor,
           below_diag: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp of each group of equal candidates (``eq``, alive rows and
    columns only) at the group's lowest index; NEG elsewhere."""
    is_rep = alive & ~(eq & below_diag).any(dim=1)
    sc = torch.where(eq, score[None, :], NEG)
    row_max = sc.max(dim=1).values
    merged = row_max + torch.log(torch.clamp(torch.exp(sc - row_max[:, None]).sum(dim=1),
                                             min=1e-37))
    return torch.where(is_rep, merged, NEG)


def _top(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _reconstruct_tokens(init_tokens: torch.Tensor, final_length: np.ndarray,
                        parents: np.ndarray, toks: np.ndarray, news: np.ndarray):
    """Backtrace from the final beams through the full steps' backpointers
    (``[n, B]`` each, host arrays), writing emitted tokens right to left,
    then splice each beam's originating prefix from ``init_tokens``.
    Returns ``(tokens [B, Lmax] on init_tokens' device, origin [B])``."""
    B, Lmax = init_tokens.shape
    rows = np.arange(B)
    cur, pos = rows.copy(), final_length.astype(np.int64)
    buf = np.zeros((B, Lmax + 1), np.int64)  # column Lmax takes dropped writes
    for par, tk, nw in zip(parents[::-1], toks[::-1], news[::-1]):
        emitted = nw[cur]
        new_pos = pos - emitted
        buf[rows, np.where(emitted & (new_pos >= 0), new_pos, Lmax)] = tk[cur]
        cur, pos = par[cur], new_pos
    dev = init_tokens.device
    prefix = init_tokens[torch.from_numpy(cur).to(dev)]
    col = torch.arange(Lmax, device=dev)[None, :]
    tokens = torch.where(col < torch.from_numpy(pos).to(dev)[:, None], prefix,
                         torch.from_numpy(buf[:, :Lmax]).to(dev))
    return tokens, cur


def beam_search_device(
    log_probs: torch.Tensor,  # [T, V+1]
    lm_adapter,
    beam_width: int = 25,
    alpha: float = 0.45,
    beta: float = 1.53,
    blank_id: Optional[int] = None,
    blank_penalty: float = 0.0,
    repetition_penalty: float = 0.0,
    top_am_threshold: float = -6.0,
    prune_less_than_val: Optional[float] = 3.17,
    top_k_tokens: int = 32,
    max_tokens: Optional[int] = None,
    valid_frames=None,
    exclude_token_zero: bool = True,
    init_state: Optional[DeviceBeamState] = None,
    return_state: bool = False,
):
    """Tensorized beam search on the log-probs' device; returns ``(tokens
    [B, Lmax], lengths [B], scores [B])`` sorted by score, best first.

    Frames from ``valid_frames`` on are skipped.  ``init_state`` resumes
    from a previous segment's final state (whose token buffer then sets
    ``Lmax``) and ``return_state`` returns the raw final
    :class:`DeviceBeamState` instead, for :func:`beam_search_segmented`."""
    T, Vp1 = log_probs.shape
    V = Vp1 - 1
    blank = V if blank_id is None else blank_id
    B = beam_width
    dev = log_probs.device
    K = min(top_k_tokens, V - 1 if exclude_token_zero else V)
    Lmax = init_state.tokens.shape[1] if init_state is not None else (max_tokens or T)
    n_valid = T if valid_frames is None else int(valid_frames)

    # per-frame top-K non-blank candidates (blank, and optionally token 0, excluded)
    masked = log_probs.clone()
    if exclude_token_zero:
        masked[:, 0] = NEG
    masked[:, blank] = NEG
    top_vals, top_idx = _top(masked, K)  # [T, K]
    # each frame's branch, from the log-probs alone: 0 full step, 1 only blank
    # clears the threshold, 2 idle (no candidate, or past valid_frames)
    thresh = log_probs.max(dim=1).values + top_am_threshold  # the log-probs' dtype
    tok_any = (top_vals > thresh[:, None]).any(dim=1)
    blank_ok = log_probs[:, blank] > thresh
    live = torch.arange(T, device=dev) < n_valid
    branches = torch.where(live & tok_any, 0, torch.where(live & blank_ok, 1, 2)).tolist()

    if init_state is None:
        lm_state0, lm_lps0 = lm_adapter.init_state(B)
        score0 = torch.full((B,), NEG, device=dev)
        score0[0] = 0.0
        init_state = DeviceBeamState(
            score=score0,
            hash=torch.full((B,), HASH_INC, dtype=torch.int64, device=dev),
            ends_blank=torch.zeros((B,), dtype=torch.bool, device=dev),
            last_token=torch.full((B,), -1, dtype=torch.int64, device=dev),
            tokens=torch.zeros((B, Lmax), dtype=torch.int64, device=dev),
            length=torch.zeros((B,), dtype=torch.int64, device=dev),
            lm_lps=lm_lps0,
            lm_state=lm_state0,
        )
    s = init_state
    score, hsh, ends_blank, last_token = s.score, s.hash, s.ends_blank, s.last_token
    length, lm_lps, lm_state = s.length, s.lm_lps, s.lm_state
    rows = torch.arange(B, device=dev)
    perm = rows  # lm_state row of each beam (the lazy LM-state carry)
    M = B * (K + 1)
    flat = torch.arange(M, device=dev)
    below_diag = flat[None, :] < flat[:, None]
    below_diag_b = rows[None, :] < rows[:, None]
    blank_col = torch.ones((B, 1), dtype=torch.bool, device=dev)
    steps = []  # per full step: sel_parent, sel_tok, sel_new (host)

    for t, branch in enumerate(branches):
        if branch == 2:
            continue
        am_row, thr = log_probs[t], thresh[t]
        if branch == 1:
            # only blank clears the threshold: every beam extends by blank, and
            # beams with one prefix merge; no reorder, no LM
            alive = score > NEG / 2
            new_score = _merge(score + am_row[blank] + blank_penalty,
                               (hsh[:, None] == hsh[None, :]) & alive[:, None] & alive[None, :],
                               alive, below_diag_b)
            if prune_less_than_val is not None:
                best = new_score.max()
                new_score = torch.where(new_score >= best - prune_less_than_val, new_score, NEG)
            dead = new_score[0] < NEG / 2  # keep the previous state if every beam died
            score = torch.where(dead, score, new_score)
            ends_blank = ends_blank | ~dead
            continue

        vals, v = top_vals[t], top_idx[t]  # [K]
        is_repeat = (v[None, :] == last_token[:, None]) & ~ends_blank[:, None]  # [B, K]
        lm_sc = alpha * torch.gather(lm_lps, 1, v[None, :].expand(B, K)) + beta
        tok_score = score[:, None] + vals[None, :] + torch.where(is_repeat, repetition_penalty,
                                                                 lm_sc)
        tok_score = torch.where((vals > thr)[None, :], tok_score, NEG)
        blank_score = torch.where(am_row[blank] > thr, score + am_row[blank] + blank_penalty, NEG)
        cand_h = torch.where(is_repeat, hsh[:, None], roll_hash(hsh[:, None], v[None, :]))
        # candidates [B, K+1], beam-major: the K tokens, then blank
        score_f = torch.cat([tok_score, blank_score[:, None]], dim=1).reshape(-1)
        h_f = torch.cat([cand_h, hsh[:, None]], dim=1).reshape(-1)
        bf_f = torch.cat([torch.zeros_like(is_repeat), blank_col], dim=1).reshape(-1)
        tok_f = torch.cat([v[None, :].expand(B, K), v.new_full((B, 1), -1)], dim=1).reshape(-1)
        new_f = torch.cat([~is_repeat, ~blank_col], dim=1).reshape(-1)

        alive_f = score_f > NEG / 2
        eqm = ((h_f[:, None] == h_f[None, :]) & (bf_f[:, None] == bf_f[None, :])
               & alive_f[:, None] & alive_f[None, :])
        top_scores, sel = _top(_merge(score_f, eqm, alive_f, below_diag), B)
        if prune_less_than_val is not None:
            top_scores = torch.where(top_scores >= top_scores[0] - prune_less_than_val,
                                     top_scores, NEG)
        sel_parent = torch.div(sel, K + 1, rounding_mode="floor")
        sel_tok = tok_f[sel]
        sel_new = new_f[sel] & (top_scores > NEG / 2)
        dead = top_scores[0] < NEG / 2
        read = torch.cat([torch.stack([dead, sel_new.any()]).to(torch.int64), sel_parent,
                          sel_tok, sel_new.to(torch.int64)]).tolist()
        if read[0]:
            continue  # every beam died: keep the previous state (an idle frame)
        steps.append(read[2:])

        length = torch.where(sel_new, torch.clamp(length[sel_parent] + 1, max=Lmax),
                             length[sel_parent])
        ph = hsh[sel_parent]
        hsh = torch.where(sel_new, roll_hash(ph, sel_tok), ph)
        last_token = torch.where(sel_new, sel_tok, last_token[sel_parent])
        ends_blank = bf_f[sel]
        score = top_scores
        lm_lps_parent = lm_lps[sel_parent]
        if read[1]:  # some kept beam emitted: gather the LM state and advance it
            lm_state, lps_new = lm_adapter.advance(
                lm_adapter.gather(lm_state, perm[sel_parent]), torch.clamp(sel_tok, min=0),
                sel_new)
            lm_lps = torch.where(sel_new[:, None], lps_new, lm_lps_parent)
            perm = rows
        else:
            lm_lps = lm_lps_parent
            perm = perm[sel_parent]

    steps_np = np.asarray(steps, np.int64).reshape(len(steps), 3, B)
    tokens, _ = _reconstruct_tokens(s.tokens, length.cpu().numpy(), steps_np[:, 0],
                                    steps_np[:, 1], steps_np[:, 2].astype(bool))
    final = DeviceBeamState(score=score, hash=hsh, ends_blank=ends_blank, last_token=last_token,
                            tokens=tokens, length=length, lm_lps=lm_lps,
                            lm_state=lm_adapter.gather(lm_state, perm))
    if return_state:
        return final
    return _sorted(_finalize_state(final, lm_adapter, alpha))


def _finalize_state(state: DeviceBeamState, lm_adapter, alpha: float) -> DeviceBeamState:
    """End of stream: adapters with ``final_scores`` (word-boundary fusion)
    score each live beam's pending partial word."""
    if not hasattr(lm_adapter, "final_scores"):
        return state
    bonus = alpha * lm_adapter.final_scores(state.lm_state)
    return state._replace(score=torch.where(state.score > NEG / 2, state.score + bonus,
                                            state.score))


def _sorted(state: DeviceBeamState):
    order = torch.sort(-state.score, stable=True).indices
    return state.tokens[order], state.length[order], state.score[order]


def beam_search_segmented(
    log_probs: torch.Tensor,  # [T, V+1]
    lm_adapter,
    segment_frames: int = 4096,
    max_tokens: Optional[int] = None,
    **kwargs,
):
    """:func:`beam_search_device` over ``segment_frames``-frame slices with
    the beam state carried across them: the same result as one call over all
    T frames (the JAX package bounds each device program this way; here it
    bounds the backpointer lists).  The tail is zero-padded and cut by
    ``valid_frames``.  Returns ``(tokens, lengths, scores)``."""
    T = log_probs.shape[0]
    if T <= segment_frames:
        return beam_search_device(log_probs, lm_adapter, max_tokens=max_tokens, **kwargs)
    Lmax = max_tokens or T
    state = None
    for s0 in range(0, T, segment_frames):
        seg = log_probs[s0 : s0 + segment_frames]
        n = seg.shape[0]
        if n < segment_frames:
            seg = torch.nn.functional.pad(seg, (0, 0, 0, segment_frames - n))
        state = beam_search_device(seg, lm_adapter, valid_frames=n, max_tokens=Lmax,
                                   init_state=state, return_state=True, **kwargs)
    return _sorted(_finalize_state(state, lm_adapter, kwargs.get("alpha", 0.45)))


def beam_search_streams(
    log_probs: torch.Tensor,  # [S, T, V+1], ragged streams zero-padded
    lm_adapter,
    valid_frames=None,  # [S] true lengths
    segment_frames: int = 4096,
    max_tokens: Optional[int] = None,
    **kwargs,
):
    """Decode S independent streams, each by :func:`beam_search_segmented`
    over its own ``valid_frames``, every token buffer ``max_tokens or T``
    wide.  The JAX package vmaps the search over a streams axis; here the
    streams run one after another (a stream's search does not depend on the
    others).  Returns ``(tokens [S, B, Lmax], lengths [S, B], scores [S,
    B])``, each stream's beams best first."""
    S, T, _ = log_probs.shape
    vf = [T] * S if valid_frames is None else [int(n) for n in valid_frames]
    out = [beam_search_segmented(log_probs[s, : vf[s]], lm_adapter, segment_frames=segment_frames,
                                 max_tokens=max_tokens or T, **kwargs) for s in range(S)]
    return tuple(torch.stack(x) for x in zip(*out))
