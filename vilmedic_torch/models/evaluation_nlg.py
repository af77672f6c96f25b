"""Ensembling beam-search and greedy generation (port of ``make_generate_fn``
of ``models/evaluation_nlg.py``).

The order is the JAX package's: per member, encode and ``init_cache``; tile
the self cache (only) for the beams; convert it to the kernel layout on the
reorder-free route; pad each member's LM head once; then one decode loop
whose per-step logits are the sum of the members' raw logits (the reference's
ensembling). Routes, by the models and the beam width:

- beam search, one member, vocab >= 4096: the blocked-stats head (K2) and
  the reorder-free beam-cache kernel (K1);
- beam search, several members, vocab >= 4096: each member's blocked f32
  head (``_head_blocked``), summed in f32 into the (N, nb, 128) blocks that
  candidate selection reads (block stats cannot be summed across members),
  each member with its own kernel cache and K1 calls, one shared ancestry
  mask;
- beam search, vocab < 4096: the plain f32 head, summed, and the two-stage
  candidate selection;
- beam search where a member's head dim is one the beam-cache kernel is not
  built for (:func:`kernel_route_ok`): the plain (N, T, H, D) self cache,
  reordered by every step's beams, as the JAX package falls back when its
  kernel cannot run;
- ``beam_width`` <= 1: greedy decoding over the plain cache and the plain
  head, without forced EOS.

``generate`` takes any model's ``encoder_inputs(batch)`` and hands them to
``module.encode`` as keywords (images for RRG, source ids and mask for
RRS); the batch size and device are the encoder output's.

On the card the port takes these kernel routes wherever the JAX package may;
the v5e routing thresholds do not apply.

:func:`evaluation` is the RRG's ``eval_func``: every batch of a loader goes
to the device, through the dataset's device preprocessing, into one
``generate``; the generated and the reference ids are decoded with the
dataset's tokenizer (``skip_special_tokens``) into ``hyps`` and ``refs``.
A ``Seq2Seq`` dataset has no ``tokenizer``: its target side gives the
references (``decoder_input_ids``), the tokenizer and the length. With
``shard_eval`` (on by default when the process has several local cards:
``parallel.mesh.eval_devices``) each card holds a replica of the models,
and every batch is padded to a multiple of the card count, split, and
generated on the cards at once (:func:`sharded_generate`).
"""

from __future__ import annotations

import torch

from typing import Any, Dict, List

from ..blocks.transformer import make_blocked_head_weights, to_kernel_cache
from ..data.image import prepare_batch
from ..decoding import beam_search, greedy_search, tile_for_beams
from ..ops.beam_cache_attention import HEAD_DIMS
from ..parallel import mesh
from .base import get_special_token_ids

# the blocked head pays off only over a large vocabulary (a model property)
BLOCKED_MIN_VOCAB = 4096


def kernel_route_ok(models, beam_width: int) -> bool:
    """Whether beam search can keep every member's self cache in the
    beam-cache kernel's never-reordered layout: a beam, and head dims the
    kernel is built for (the JAX package's ``kernel_ok``)."""
    return (bool(beam_width) and beam_width > 1
            and all(m.dec_config.head_dim in HEAD_DIMS for m in models))


def make_generate_fn(models, beam_width: int, max_len: int, bos_id: int, eos_id: int,
                     pad_id: int, length_penalty: float = 1.0,
                     ancestry_group_items: int = 1):
    """``generate(enc_inputs)`` for one model or an ensemble, where
    ``enc_inputs`` is ``models[0].encoder_inputs(batch)`` on the models'
    device (the keywords of ``module.encode``). Returns a ``BeamResult`` for beam search and a ``RolloutResult``
    for greedy decoding (``beam_width`` <= 1).

    ``ancestry_group_items`` sets the items per beam-cache mask group; any
    divisor of the batch gives the same sequences."""
    modules = [m.module for m in models]
    vocabs = {m.dec_config.vocab_size for m in models}
    beam = bool(beam_width) and beam_width > 1
    blocked = beam and len(vocabs) == 1 and min(vocabs) >= BLOCKED_MIN_VOCAB
    kernel_cache = kernel_route_ok(models, beam_width)

    @torch.inference_mode()
    def generate(enc_inputs):
        members = []
        for module in modules:
            enc_h, enc_m = module.encode(**enc_inputs)
            self_cache, cross_cache = module.init_cache(enc_h, max_len)
            # only the self cache tiles to B*beam rows; the cross K/V and mask
            # stay at batch B and the cross-attention folds the beams into its
            # queries
            if beam:
                self_cache = tile_for_beams(self_cache, beam_width)
            if kernel_cache:
                self_cache = to_kernel_cache(self_cache)
            head = None
            if blocked:
                head = make_blocked_head_weights(module.dec)
                if len(modules) == 1:
                    head += ("stats",)
            members.append((module, self_cache, cross_cache, enc_m.to(torch.int32), head))

        def step_fn(tokens, index, anc=None):
            total = None
            for module, self_cache, cross_cache, enc_m, head in members:
                out = module.decode_step(tokens, self_cache, cross_cache, enc_m, index,
                                         blocked_head=head, ancestry=anc)
                if isinstance(out, tuple):  # the blocked-stats head: one member
                    return out
                if head is None:
                    out = out[:, -1].float()
                total = out if total is None else total + out
            return total

        batch, device = enc_h.shape[0], enc_h.device
        if not beam:
            return greedy_search(step_fn, batch, max_len, bos_id, eos_id, pad_id, device,
                                 forced_eos=False)
        return beam_search(step_fn, batch, beam_width, max_len, bos_id, eos_id,
                           pad_id, device, length_penalty=length_penalty,
                           ancestry_group_items=ancestry_group_items, blocked=blocked,
                           caches=None if kernel_cache else [m[1] for m in members])

    return generate


def pipelined_decode(dl, tokenizer, prepare, launch) -> Dict[str, List[str]]:
    """``{"refs", "hyps"}`` over a loader: ``prepare(batch) -> (inputs,
    ref_ids, n)`` builds the device inputs, ``launch(inputs)`` generates;
    batch i is decoded to text after batch i + 1 is launched."""
    refs: List[str] = []
    hyps: List[str] = []

    def flush(prev):
        if prev is None:
            return
        ref_ids, seqs, n = prev
        for h, r in zip(seqs.cpu().numpy()[:n], ref_ids.cpu().numpy()):
            hyps.append(tokenizer.decode(h, skip_special_tokens=True,
                                         clean_up_tokenization_spaces=False))
            refs.append(tokenizer.decode(r, skip_special_tokens=True,
                                         clean_up_tokenization_spaces=False))

    prev = None
    for batch in dl:
        inputs, ref_ids, n = prepare(batch)
        seqs = launch(inputs)
        flush(prev)
        prev = (ref_ids, seqs, n)
    flush(prev)
    return {"refs": refs, "hyps": hyps}


def target_side(dataset):
    """``(reference key, tokenizer, max_len)`` of a dataset: its own
    tokenizer and ``input_ids``, or a ``Seq2Seq`` target's
    (``decoder_input_ids``)."""
    if hasattr(dataset, "tokenizer"):
        return "input_ids", dataset.tokenizer, int(dataset.tokenizer_max_len)
    return "decoder_input_ids", dataset.tgt_tokenizer, int(dataset.tgt_tokenizer_max_len)


def to_device(batch, device):
    """A batch's tensors on ``device``; anything else (strings) as it is."""
    return {k: v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def evaluation(models, config, dl, **kwargs) -> Dict[str, Any]:
    """The ``eval_func`` of RRG- and RRS-style models: ``make_generate_fn``
    at the config's ``beam_width`` (default 1) and ``length_penalty``
    (default 1), up to the target's ``tokenizer_max_len``, over every batch
    of ``dl`` on the models' device."""
    dataset = dl.dataset
    ref_key, tokenizer, max_len = target_side(dataset)
    bos_id, eos_id, pad_id = get_special_token_ids(models[0].dec_config, tokenizer)
    length_penalty = config.get("length_penalty", None)
    length_penalty = 1.0 if length_penalty is None else float(length_penalty)
    device = next(models[0].module.parameters()).device
    launch = sharded_generate(
        models, mesh.eval_devices(config, device),
        lambda ms: make_generate_fn(ms, config.get("beam_width", 1), max_len, bos_id, eos_id,
                                    pad_id, length_penalty))

    def prepare(batch):
        on_device = prepare_batch(to_device(batch, device), dataset)
        return models[0].encoder_inputs(on_device), batch[ref_key], batch[ref_key].shape[0]

    return pipelined_decode(dl, tokenizer, prepare, launch)


def sharded_generate(models, devices, make_generate):
    """``launch(inputs) -> sequences`` of ``make_generate(models)``; over
    several ``devices``, one replica of the models per device, each batch
    padded to a multiple of the device count and split among them (the
    sequences come back on the first device, the padding rows included)."""
    if len(devices) == 1:
        generate = make_generate(models)
        return lambda inputs: generate(inputs).sequences
    generates = [make_generate(r) for r in mesh.replicate(models, devices)]

    def launch(inputs):
        parts = mesh.sharded_call(lambda i, shard: generates[i](shard).sequences, devices,
                                  inputs)
        return torch.cat([p.to(devices[0]) for p in parts])

    return launch
