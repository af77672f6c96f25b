"""Greedy and beam-search decoding (port of ``decoding/decode.py``).

HF semantics as in the JAX package: candidates are the top 2k of
``alive_logp + log_softmax(logits)`` over (beam, token); a candidate ending in
EOS joins the finished pool with its score divided by ``len ** length_penalty``;
the loop stops at ``max_len - 1`` or when no alive beam can still beat the worst
finished hypothesis (``early_stopping=False``). Greedy decoding takes the
argmax each step until every row has emitted EOS.

Two ways to follow the beams through the self-attention cache:

- the reorder-free route (no ``caches``): the KV caches are never
  reordered. The loop carries the beam-cache kernel's dense ancestry mask
  (groups, g*k, max_len*g*k), g items per group: lane block t holds, for
  every slot of the group, the one-hot of the slot whose cache row holds its
  position-t K/V. Each step marks position i as the slot's own, and a beam
  reorder composes the mask with a row gather;
- the permute route (``caches`` given): after each step every cache row is
  replaced by its new beam's parent row (:func:`_gather_beams`).

Candidates come from the blocked LM head (per-128-block max and sum-exp, or
bare blocks) or from plain logits: blockwise over a vocabulary of 4096 or
more (:func:`_batch_beam_candidates`), per beam and then over the pool below
that. The ``lax.while_loop`` of the JAX package is a Python loop here, with
one host sync per step for its condition.

The rollouts (:func:`greedy_search`, :func:`sample`,
:func:`greedy_and_sample`, :func:`constrained_greedy_search`) emit one token
per row per step until every row has emitted EOS. Sampling is the JAX
package's ``jax.random.categorical``: the argmax of the logits plus Gumbel
noise, here drawn by :func:`gumbel_noise` from an explicit
``torch.Generator`` (the formula of ``jax.random.gumbel``; the bits cannot
be JAX's, so tests replace the function to feed JAX's noise).

``lax.top_k`` breaks ties toward the lower index, and ties are certain here
(the finished pool starts as a row of ``NEG_INF``), so every top-k is a stable
descending sort.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.topk import top_k

NEG_INF = -1.0e7
PAD_NEG = -1.0e30  # block padding: below any real logit, exp() underflows to 0
BLK = 128
BLOCKWISE_MIN_VOCAB = 4096  # the JAX package's switch to blockwise top-k


class BeamResult(NamedTuple):
    sequences: torch.Tensor  # (B, max_len) best hypothesis per item
    scores: torch.Tensor  # (B,) its length-normalized score
    steps: int  # decode steps run (each one step_fn call)


class RolloutResult(NamedTuple):
    sequences: torch.Tensor  # (B, max_len), starts with BOS, pad after EOS
    lengths: torch.Tensor  # (B,) tokens including BOS and EOS
    steps: int  # decode steps run, each with one host sync for the stop test


def _pad_blocks(logits: torch.Tensor) -> torch.Tensor:
    """(n, V) logits -> (n, nb, 128) f32, padded in their own dtype with
    ``PAD_NEG`` to whole blocks (the JAX package pads, then upcasts)."""
    n, v = logits.shape
    nb = -(-v // BLK)
    return F.pad(logits, (0, nb * BLK - v), value=PAD_NEG).view(n, nb, BLK).float()


def _block_topk_lse(logits: torch.Tensor, k: int):
    """Exact top-k and logsumexp of (n, V) logits by 128-column blocks: the
    lse from the block maxima and sum-exps, the top-k from the top-2k blocks
    by their maxima (any element of the true top-k lies in a block whose max
    is at least the k-th largest block max). Returns ``(scores (n, k) f32,
    indices (n, k), lse (n,))``."""
    xp = _pad_blocks(logits)
    n, nb, _ = xp.shape
    bmax, lse = _block_max_lse(xp)
    _, bidx = top_k(bmax, min(2 * k, nb))
    cand = torch.take_along_dim(xp, bidx[..., None], dim=1).reshape(n, -1)
    scores, within = top_k(cand, k)
    block_of = torch.take_along_dim(bidx, within // BLK, dim=1)
    return scores, block_of * BLK + within % BLK, lse


def _topk_and_lse(logits: torch.Tensor, k: int):
    """Blockwise (:func:`_block_topk_lse`) from ``BLOCKWISE_MIN_VOCAB``
    columns up, plain top-k and logsumexp below."""
    if logits.shape[-1] >= BLOCKWISE_MIN_VOCAB:
        return _block_topk_lse(logits, k)
    logits = logits.float()
    scores, idx = top_k(logits, k)
    return scores, idx, torch.logsumexp(logits, dim=-1)


def _kth_largest(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(n, 1): the k-th largest value of each row (the top-k sampling
    threshold)."""
    if logits.shape[-1] >= BLOCKWISE_MIN_VOCAB:
        return _block_topk_lse(logits, k)[0][:, -1:]
    return top_k(logits, k)[0][:, -1:]


def tile_for_beams(tree, beam_size: int):
    """Repeat every tensor k times along the batch axis: b -> b*k, beam-major
    within an item (flat index = item * k + beam)."""
    if isinstance(tree, torch.Tensor):
        return tree.repeat_interleave(beam_size, dim=0)
    if isinstance(tree, dict):
        return {key: tile_for_beams(v, beam_size) for key, v in tree.items()}
    return type(tree)(tile_for_beams(v, beam_size) for v in tree)


def _lse_from_stats(bmax, bsum):
    m = bmax.amax(dim=-1)
    return torch.log((torch.exp(bmax - m[:, None]) * bsum).sum(dim=-1)) + m


def _block_max_lse(blocks):
    """(N, nb, 128) f32 blocks -> (block maxima (N, nb), row logsumexp (N,))."""
    bmax = blocks.amax(dim=-1)
    return bmax, _lse_from_stats(bmax, torch.exp(blocks - bmax[..., None]).sum(dim=-1))


def _select(logits, bmax, lse, b: int, k: int, alive_logp, r: int):
    """Shared tail of the block routes: pre-select the best ``r`` (beam,
    block) pairs by block max, then the exact top ``r`` over their lanes."""
    n, nb, blk = logits.shape
    off = alive_logp.reshape(n) - lse  # per-beam log-prob offset
    adj = (bmax + off[:, None]).reshape(b, k * nb)
    nblocks = min(r, k * nb)
    _, gbidx = top_k(adj, nblocks)  # (b, nblocks) global block ids
    beam = gbidx // nb
    blkid = gbidx % nb
    rows = torch.arange(b, device=logits.device)[:, None] * k + beam
    cand = logits[rows, blkid]  # (b, nblocks, blk)
    block_off = torch.take_along_dim(off.reshape(b, k), beam, dim=1)
    cand_flat = (cand + block_off[..., None]).reshape(b, nblocks * blk)
    scores, sel = top_k(cand_flat, r)
    chosen_block = torch.take_along_dim(gbidx, sel // blk, dim=1)
    return scores, chosen_block // nb, (chosen_block % nb) * blk + sel % blk


def _candidates_from_stats(logits, bmax, bsum, b: int, k: int, alive_logp, r: int):
    """Candidates from the blocked-stats LM head: row-major logits
    (N, nb, 128) with the per-block max and sum-exp (N, nb) computed in the
    same pass. Returns (scores, beam, token), each (b, r)."""
    return _select(logits, bmax, _lse_from_stats(bmax, bsum), b, k, alive_logp, r)


def _candidates_from_blocks(logits, b: int, k: int, alive_logp, r: int):
    """Candidates from pre-blocked logits (N, nb, 128) whose pad lanes sit at
    <= -1e30; the block stats are computed here."""
    return _select(logits, *_block_max_lse(logits), b, k, alive_logp, r)


def _batch_beam_candidates(logits, b: int, k: int, alive_logp, r: int):
    """Candidates from plain (N, V) logits, V >= ``BLOCKWISE_MIN_VOCAB``:
    padded to 128-column blocks, then one top-r per batch item over the
    blocks (:func:`_candidates_from_blocks`)."""
    return _candidates_from_blocks(_pad_blocks(logits), b, k, alive_logp, r)


def _two_stage_candidates(logits, b: int, k: int, alive_logp):
    """Candidates from plain (N, V) logits below ``BLOCKWISE_MIN_VOCAB``:
    each beam's top min(2k, V) raw logits normalized by its logsumexp, then
    the top 2k of the (b, k * r) pool."""
    r = min(2 * k, logits.shape[-1])
    row_scores, row_idx, lse = _topk_and_lse(logits, r)
    row_logp = row_scores - lse[:, None] + alive_logp.reshape(b * k)[:, None]
    pool_tokens = row_idx.reshape(b, k * r)
    pool_beams = torch.arange(k, device=logits.device).repeat_interleave(r).expand(b, -1)
    scores, sel = top_k(row_logp.reshape(b, k * r), 2 * k)
    return (scores, torch.take_along_dim(pool_beams, sel, dim=1),
            torch.take_along_dim(pool_tokens, sel, dim=1))


def _gather_beams(caches, new_beam: torch.Tensor, batch: int, k: int) -> None:
    """Reorder every (batch * k, ...) tensor of ``caches`` by the
    within-item beam indices ``new_beam`` (batch, k), in place (the step
    function keeps its references): row ``item * k + q`` becomes a copy of
    row ``item * k + new_beam[item, q]``. One source row per target row, so
    the values are exact."""
    flat = (torch.arange(batch, device=new_beam.device)[:, None] * k + new_beam).reshape(-1)
    if isinstance(caches, torch.Tensor):
        caches.copy_(caches.index_select(0, flat))
        return
    for leaf in (caches.values() if isinstance(caches, dict) else caches):
        _gather_beams(leaf, new_beam, batch, k)


def _rollout(step_fn: Callable, batch_size: int, max_len: int, bos_id: int, eos_id: int,
             pad_id: int, select_fn: Callable, device, forced_eos: bool = True,
             emitted: Optional[Callable] = None) -> RolloutResult:
    """One token per row per step from ``select_fn(logits, i)`` over
    ``step_fn(tokens (B, 1), i)``'s logits, until ``max_len - 1`` or every
    row has emitted EOS (a host sync each step); finished rows emit PAD.
    ``forced_eos`` makes the last step's token EOS for unfinished rows.
    ``emitted(token)`` sees each step's tokens as they are written."""
    seqs = torch.full((batch_size, max_len), pad_id, dtype=torch.long, device=device)
    seqs[:, 0] = bos_id
    finished = torch.zeros(batch_size, dtype=torch.bool, device=device)
    lengths = torch.ones(batch_size, dtype=torch.long, device=device)
    i = 0
    while i < max_len - 1 and not bool(finished.all()):
        logits = step_fn(seqs[:, i:i + 1], i)
        logits = logits[:, -1] if logits.ndim == 3 else logits
        token = select_fn(logits, i)
        if forced_eos and i == max_len - 2:
            token = torch.where(finished, token, torch.full_like(token, eos_id))
        token = torch.where(finished, torch.full_like(token, pad_id), token)
        seqs[:, i + 1] = token
        if emitted is not None:
            emitted(token)
        lengths += (~finished).long()
        finished |= token == eos_id
        i += 1
    return RolloutResult(seqs, lengths, i)


def greedy_search(step_fn: Callable, batch_size: int, max_len: int, bos_id: int, eos_id: int,
                  pad_id: int, device, forced_eos: bool = True) -> RolloutResult:
    """Argmax decoding (ties to the lower token, as ``jnp.argmax``)."""
    return _rollout(step_fn, batch_size, max_len, bos_id, eos_id, pad_id,
                    lambda logits, i: logits.argmax(dim=-1), device, forced_eos)


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise in f32, ``jax.random.gumbel``'s formula:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``, drawn from
    ``generator`` (on ``device``; None: the default generator)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))


def _warp(logits: torch.Tensor, bad_words: Optional[Sequence[int]], top_k: Optional[int]):
    """The sampling warp: bad words, then every logit below the k-th
    largest, set to ``NEG_INF`` (ties at the k-th value stay in)."""
    if bad_words:
        mask = torch.zeros(logits.shape[-1], dtype=torch.bool, device=logits.device)
        mask[list(bad_words)] = True
        logits = torch.where(mask, NEG_INF, logits)
    if top_k:
        logits = torch.where(logits < _kth_largest(logits, top_k), NEG_INF, logits)
    return logits


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``jax.random.categorical``: argmax of the logits plus Gumbel noise in
    the logits' dtype (the noise through the module's :func:`gumbel_noise`,
    looked up at call time)."""
    noise = gumbel_noise(tuple(logits.shape), generator, logits.device)
    return (logits + noise.to(logits.dtype)).argmax(dim=-1)


def sample(step_fn: Callable, batch_size: int, max_len: int, bos_id: int, eos_id: int,
           pad_id: int, device, generator: Optional[torch.Generator] = None,
           top_k: Optional[int] = None, bad_words: Optional[Sequence[int]] = None,
           forced_eos: bool = True) -> RolloutResult:
    """Ancestral sampling with the optional top-k warp and bad-words mask,
    one noise draw of (B, V) per step."""
    return _rollout(step_fn, batch_size, max_len, bos_id, eos_id, pad_id,
                    lambda logits, i: _categorical(_warp(logits, bad_words, top_k), generator),
                    device, forced_eos)


def stack_for_rollouts(tree):
    """Every tensor twice along the batch axis, interleaved (row 2i greedy,
    2i + 1 sampled): ``tile_for_beams(tree, 2)``, the self-cache layout of
    :func:`greedy_and_sample`. Beam-major, so a cross-attention cache left
    at batch B serves both rollouts by folding them into its queries."""
    return tile_for_beams(tree, 2)


def greedy_and_sample(step_fn: Callable, batch_size: int, max_len: int, bos_id: int,
                      eos_id: int, pad_id: int, device,
                      generator: Optional[torch.Generator] = None,
                      top_k: Optional[int] = None, bad_words: Optional[Sequence[int]] = None,
                      forced_eos: bool = True):
    """The greedy and the sampled rollout in one loop over 2B interleaved
    rows (the self cache from :func:`stack_for_rollouts`). Returns
    ``(greedy, sampled)`` RolloutResults whose sequences equal
    :func:`greedy_search`'s and :func:`sample`'s on the same noise; their
    ``steps`` are the fused loop's."""
    b = batch_size

    def select(logits, i):
        greedy = logits[0::2].argmax(dim=-1)
        sampled = _categorical(_warp(logits[1::2], bad_words, top_k), generator)
        return torch.stack([greedy, sampled], dim=1).reshape(2 * b)

    res = _rollout(step_fn, 2 * b, max_len, bos_id, eos_id, pad_id, select, device, forced_eos)
    return (RolloutResult(res.sequences[0::2], res.lengths[0::2], res.steps),
            RolloutResult(res.sequences[1::2], res.lengths[1::2], res.steps))


def constrained_greedy_search(step_fn: Callable, batch_size: int, max_len: int, bos_id: int,
                              eos_id: int, pad_id: int, force_ids: torch.Tensor, device,
                              bias: float = 8.0) -> RolloutResult:
    """Greedy decoding that must include the tokens of ``force_ids``
    ((B, K), -1 padded): each step adds ``bias`` to every forced token not
    yet emitted (once per unmet slot) and holds EOS back at ``NEG_INF``
    while some are unmet and the steps left exceed their number; EOS is
    forced at the last step."""
    force_ids = force_ids.to(device=device, dtype=torch.long)
    state = {"satisfied": force_ids < 0}  # padding slots count as met

    def select(logits, i):
        unmet = ~state["satisfied"]
        counts = torch.zeros_like(logits).scatter_add_(
            1, torch.where(unmet, force_ids, 0), unmet.to(logits.dtype))
        logits = logits + bias * counts
        hold = unmet.any(dim=1) & (max_len - 2 - i > unmet.sum(dim=1))
        logits[:, eos_id] += torch.where(hold, NEG_INF, 0.0)
        return logits.argmax(dim=-1)

    def emitted(token):
        state["satisfied"] |= force_ids == token[:, None]

    return _rollout(step_fn, batch_size, max_len, bos_id, eos_id, pad_id, select, device,
                    forced_eos=True, emitted=emitted)


def _norm(i_len: int, length_penalty: float) -> float:
    # the JAX package's f32 power, evaluated in f32
    return float(np.float32(i_len) ** np.float32(length_penalty))


def beam_search(
    step_fn: Callable,
    batch_size: int,
    beam_size: int,
    max_len: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    device: torch.device,
    length_penalty: float = 1.0,
    ancestry_group_items: int = 1,
    blocked: bool = True,
    caches=None,
) -> BeamResult:
    """Beam search whose ``step_fn`` runs one decode step, updating its
    caches in place, and returns, with ``blocked``, either ``(logits (N, nb,
    128), bmax (N, nb), bsum (N, nb))`` from the blocked-stats head or the
    bare (N, nb, 128) blocked logits; without, plain logits (N, V) or
    (N, 1, V).

    Without ``caches``: ``step_fn(tokens (B*k, 1), index, ancestry_mask)``
    over the never-permuted cache; ``ancestry_group_items=g`` sets the items
    per mask group (rows = g * k), and any g that divides the batch gives the
    same sequences. With ``caches``: ``step_fn(tokens, index)``, and every
    tensor of ``caches`` is reordered after each step (:func:`_gather_beams`)."""
    b, k, g = batch_size, beam_size, ancestry_group_items
    ancestry = caches is None
    ids = dict(dtype=torch.long, device=device)
    f32 = dict(dtype=torch.float32, device=device)

    seqs = torch.full((b, k, max_len), pad_id, **ids)
    seqs[:, :, 0] = bos_id
    alive_logp = torch.full((b, k), NEG_INF, **f32)
    alive_logp[:, 0] = 0.0
    fin_seqs = torch.full((b, k, max_len), pad_id, **ids)
    fin_scores = torch.full((b, k), NEG_INF, **f32)
    if ancestry:
        if b % g:
            raise ValueError(f"ancestry group of {g} items does not divide batch {b}")
        rows, groups = g * k, b // g
        anc = torch.zeros((groups, rows, max_len * rows), dtype=torch.bool, device=device)
        eye = torch.eye(rows, dtype=torch.bool, device=device).expand(groups, rows, rows)
        slot_base = (torch.arange(g, device=device) * k)[None, :, None]

    i = 0
    while i < max_len - 1:
        # early_stopping=False: can the best alive beam still beat the worst
        # finished hypothesis at the current length?
        best_alive = alive_logp.amax(dim=1) / _norm(i + 1, length_penalty)
        worst_fin = fin_scores.amin(dim=1)
        if not bool((worst_fin < best_alive).any()):
            break

        tokens = seqs[:, :, i].reshape(b * k, 1)
        if ancestry:
            out = step_fn(tokens, i, anc)
            # position i of every slot is its own, written this step: recorded
            # after the step, so the kernel sees t < i only
            anc[:, :, i * rows:(i + 1) * rows] = eye
        else:
            out = step_fn(tokens, i)
        if isinstance(out, tuple):
            cand_scores, cand_beam, cand_token = _candidates_from_stats(
                *out, b, k, alive_logp, 2 * k)
        elif blocked:
            cand_scores, cand_beam, cand_token = _candidates_from_blocks(
                out, b, k, alive_logp, 2 * k)
        else:
            out = out[:, -1] if out.ndim == 3 else out
            if out.shape[-1] >= BLOCKWISE_MIN_VOCAB:
                cand_scores, cand_beam, cand_token = _batch_beam_candidates(
                    out, b, k, alive_logp, 2 * k)
            else:
                cand_scores, cand_beam, cand_token = _two_stage_candidates(
                    out, b, k, alive_logp)
        is_eos = cand_token == eos_id

        # finished pool: a hypothesis ending at step i has length i + 1
        cand_norm = torch.where(is_eos, cand_scores / _norm(i + 1, length_penalty),
                                torch.full_like(cand_scores, NEG_INF))
        parent = torch.take_along_dim(seqs, cand_beam[:, :, None], dim=1)  # (b, 2k, L)
        parent[:, :, i + 1] = eos_id
        fin_scores, top_fin = top_k(torch.cat([fin_scores, cand_norm], dim=1), k)
        fin_seqs = torch.take_along_dim(torch.cat([fin_seqs, parent], dim=1),
                                        top_fin[:, :, None], dim=1)

        # alive beams: the top k candidates that are not EOS
        alive_cand = torch.where(is_eos, torch.full_like(cand_scores, NEG_INF), cand_scores)
        alive_logp, alive_idx = top_k(alive_cand, k)
        new_beam = torch.take_along_dim(cand_beam, alive_idx, dim=1)  # (b, k)
        new_token = torch.take_along_dim(cand_token, alive_idx, dim=1)
        seqs = torch.take_along_dim(seqs, new_beam[:, :, None], dim=1)
        seqs[:, :, i + 1] = new_token

        if ancestry:
            # compose the ancestry: new slot q inherits the row of slot new_beam[q]
            src = (slot_base + new_beam.reshape(groups, g, k)).reshape(groups, rows)
            anc = torch.take_along_dim(anc, src[:, :, None], dim=1)
        else:
            _gather_beams(caches, new_beam, b, k)
        i += 1

    final_alive = alive_logp / _norm(i + 1, length_penalty)
    all_scores = torch.cat([fin_scores, final_alive], dim=1)
    all_seqs = torch.cat([fin_seqs, seqs], dim=1)
    best = all_scores.argmax(dim=1)
    best_seqs = torch.take_along_dim(all_seqs, best[:, None, None], dim=1)[:, 0]
    best_scores = torch.take_along_dim(all_scores, best[:, None], dim=1)[:, 0]
    return BeamResult(best_seqs, best_scores, i)
