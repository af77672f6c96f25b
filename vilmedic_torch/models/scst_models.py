"""RRG_SCST and RRS_SCST: self-critical reinforcement fine-tuning of a
trained generation model (port of ``models/scst_models.py``).

The SCST model wraps its base model (``RRG`` or ``RRS``, its weights from
the port checkpoint ``ckpt`` when given) and owns the training step
(:meth:`_SCSTBase.train_iteration`, which the ``Trainor`` calls per batch).
By default it is strictly on-policy, as the JAX package's serial iteration:

1. rollouts without gradients: encode, ``init_cache`` at the target's
   ``max_len``, the self cache stacked for two interleaved rollouts, one
   ``greedy_and_sample`` loop (bad words PAD and BOS, the config's
   ``top_k``, forced EOS) over the plain cache and the plain head;
2. host rewards: each reward of the sample minus that of the greedy
   rollout, against the references. A Seq2Seq batch's references are its
   target ids (``decoder_input_ids``). The JAX package reads
   ``input_ids`` there, the source findings, for the rewards and for the
   ``use_nll`` term; the port does not copy that;
3. the gradient step: the sampled ids teacher-forced through the decoder
   without dropout, the encoder run through ``encode`` (running
   statistics, gradients still flowing into it), per-token log-probs as
   the picked logit minus the logsumexp in f32, :func:`scst_loss` plus
   the weighted NLL where ``use_nll``, and the trainer's optimizer behind
   its non-finite gate.

``overlap_rollout: true`` pipelines the iteration as the JAX package's
does: iteration i runs batch i's rollouts on the calling thread while one
worker thread computes batch i-1's rewards (decoding to text and the
scorers; the native ROUGE-L core releases the interpreter lock, and
rewards that run on the card do so on a CUDA stream of the worker's own),
joins the two, then takes batch i-1's gradient step. Both the rollouts of
batch i and the step of batch i-1 see the same parameters, so the sampled
ids are one update old when their step applies, as in JAX, whose device
runs rollout i before gradient i-1. Every launch that reads or writes the
policy's parameters stays on the calling thread, in that order: the
update starts only after the rollouts have been read to the host, and the
Gumbel draws come from ``generator`` in the serial iteration's order. The
first iteration of an epoch only rolls out and returns ``(None, "")``;
:meth:`_SCSTBase.finish_epoch` steps on the last batch. One batch's device
tensors and encoder inputs are held across an iteration.

``timing`` accumulates ``rollout_s``, ``reward_s`` and ``grad_s`` (each
ended by a host sync; in the pipelined iteration the rewards are timed on
their worker and overlap the rollouts) and counts ``iters``, the gradient
steps.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple

import numpy as np
import torch

from .. import registry
from ..blocks.rl.scst import SCST, scst_loss
from ..blocks.transformer import causal_lm_loss
from ..decoding import greedy_and_sample, stack_for_rollouts
from ..executors.checkpoint import load_checkpoint
from ..executors.train_state import gated_update
from . import rrg, rrs  # noqa: F401  (register the base protos)
from .base import get_special_token_ids
from .evaluation_nlg import evaluation, target_side


class _Rollout(NamedTuple):
    """One batch's rollouts: the batch and encoder inputs on the device, the
    greedy and sampled ids on the host and the sampled ids on the device,
    the references on the host."""
    batch: dict
    enc_inputs: dict
    greedy: np.ndarray
    sampled: np.ndarray
    sampled_dev: torch.Tensor
    refs: np.ndarray


def scst_evaluation(models, config, dl, **kwargs) -> Dict:
    """The base models' NLG ``evaluation``."""
    return evaluation([m.model for m in models], config, dl)


class _SCSTBase:
    base_proto: str = None

    def __init__(self, dl=None, scores="ROUGEL", ckpt=None, scores_args=None,
                 scores_weights=None, top_k=None, use_nll=False, overlap_rollout=False,
                 device="cuda", seed: int = 0, **base_kwargs):
        if dl is None:
            raise ValueError("SCST reads its tokenizer and references from a data loader")
        self.model = registry.get("model", self.base_proto)(dl=dl, device=device, seed=seed,
                                                            **base_kwargs)
        self.module = self.model.module
        self.dec_config = self.model.dec_config
        self.frozen_prefixes = self.model.frozen_prefixes
        if ckpt:
            self.module.load_state_dict(load_checkpoint(ckpt)["model"], strict=True)

        ref_key, tokenizer, max_len = target_side(dl.dataset)
        self.ref_key = ref_key
        self.mask_key = ref_key.replace("input_ids", "attention_mask")
        bos, eos, pad = get_special_token_ids(self.dec_config, tokenizer)
        device = next(self.module.parameters()).device
        self.scst = SCST(tokenizer=tokenizer, max_length=max_len, bos_token_id=bos,
                         eos_token_id=eos, pad_token_id=pad, scores=scores,
                         scores_args=scores_args, scores_weights=scores_weights, top_k=top_k,
                         use_nll=use_nll, device=device)
        self.eval_func = scst_evaluation
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.timing = {"rollout_s": 0.0, "reward_s": 0.0, "grad_s": 0.0, "iters": 0}
        self.last = None  # the last step's rollouts, rewards and loss
        self.overlap_rollout = bool(overlap_rollout)
        self._pending = None  # the pipelined iteration's batch awaiting its step
        self._reward_pool = None
        self._reward_stream = None

    def encoder_inputs(self, batch):
        return self.model.encoder_inputs(batch)

    @torch.no_grad()
    def rollouts(self, enc_inputs):
        """``(greedy ids, sampled ids)``, each (B, max_len), on the device."""
        module, scst = self.module, self.scst
        max_len, bos, eos, pad = (scst.max_length, scst.bos_token_id, scst.eos_token_id,
                                  scst.pad_token_id)
        enc_h, enc_m = module.encode(**enc_inputs)
        self_cache, cross_cache = module.init_cache(enc_h, max_len)
        # the cross K/V and the mask stay at batch B: the interleaved rows
        # fold into the cross-attention's queries
        self_cache = stack_for_rollouts(self_cache)
        enc_m = enc_m.to(torch.int32)

        def step_fn(tokens, index):
            return module.decode_step(tokens, self_cache, cross_cache, enc_m, index)[:, -1].float()

        greedy, sampled = greedy_and_sample(
            step_fn, enc_h.shape[0], max_len, bos, eos, pad, enc_h.device,
            generator=self.generator, top_k=scst.top_k, bad_words=(pad, bos), forced_eos=True)
        return greedy.sequences, sampled.sequences

    def policy_loss(self, batch, enc_inputs, sampled: torch.Tensor,
                    advantages: torch.Tensor) -> torch.Tensor:
        """The SCST loss of the sampled ids (B, T) under the advantages
        (n_scores, B), plus the weighted NLL of the references where
        ``use_nll``; with the graph for the backward."""
        module, scst = self.module, self.scst
        pad = scst.pad_token_id
        enc_h, enc_m = module.encode(**enc_inputs)
        enc_m = enc_m.to(torch.int32)
        logits = module.dec(sampled, (sampled != pad).to(torch.int32),
                            encoder_hidden_states=enc_h, encoder_attention_mask=enc_m)
        shift = logits[:, :-1].float()
        tok = sampled[:, 1:]
        tok_logp = shift.gather(-1, tok[..., None])[..., 0] - torch.logsumexp(shift, dim=-1)
        loss = scst_loss(tok_logp, tok, advantages, scst.reward_weights, pad)
        if scst.use_nll:
            ids, mask = batch[self.ref_key], batch[self.mask_key]
            gt = module.dec(ids, mask, encoder_hidden_states=enc_h, encoder_attention_mask=enc_m)
            loss = loss + scst.nll_weight * causal_lm_loss(gt, ids, mask)
        return loss

    def _rollout(self, batch) -> _Rollout:
        """Batch's rollouts, read to the host with its references."""
        t0 = time.perf_counter()
        enc_inputs = self.encoder_inputs(batch)
        greedy, sampled = self.rollouts(enc_inputs)
        out = _Rollout(batch, enc_inputs, greedy.cpu().numpy(), sampled.cpu().numpy(), sampled,
                       batch[self.ref_key].cpu().numpy())
        self.timing["rollout_s"] += time.perf_counter() - t0
        return out

    def _rewards(self, ro: _Rollout):
        """``(greedy rewards, sampled rewards, advantages (n_scores, B))``."""
        t0 = time.perf_counter()
        reward_greedy, _, _ = self.scst.get_reward(ro.greedy, ro.refs)
        reward_sampling, _, _ = self.scst.get_reward(ro.sampled, ro.refs)
        advantages = np.stack([rs - rg for rs, rg in zip(reward_sampling, reward_greedy)]
                              ).astype(np.float32)
        self.timing["reward_s"] += time.perf_counter() - t0
        return reward_greedy, reward_sampling, advantages

    def _worker_rewards(self, ro: _Rollout):
        """:meth:`_rewards` on the worker thread; a reward that runs on the
        card runs on the worker's stream."""
        with torch.cuda.stream(self._reward_stream):
            return self._rewards(ro)

    def _step(self, trainor, ro: _Rollout, rewards, lr: float):
        """The gradient step on a rolled-out batch. Returns ``(loss on the
        device, log text)``."""
        reward_greedy, reward_sampling, advantages = rewards
        t0 = time.perf_counter()
        trainor.zero_grads()
        loss = self.policy_loss(ro.batch, ro.enc_inputs, ro.sampled_dev,
                                torch.from_numpy(advantages).to(ro.sampled_dev.device))
        loss.backward()
        gated_update(trainor.tx, lr, loss)  # reads the loss: the step has ended
        self.timing["grad_s"] += time.perf_counter() - t0
        self.timing["iters"] += 1
        mean_sampling = float(np.mean(np.concatenate(reward_sampling)))
        self.last = {"greedy": ro.greedy, "sampled": ro.sampled, "reward_greedy": reward_greedy,
                     "reward_sampling": reward_sampling, "loss": loss.detach()}
        return loss.detach(), (f"reward_sampling {mean_sampling:.4f}, "
                               f"delta_reward: {float(np.mean(advantages)):.4f}")

    def train_iteration(self, trainor, batch, lr: float):
        """One SCST iteration on a batch already on the device: the serial
        on-policy step, or with ``overlap_rollout`` the pipelined one
        (module doc). Returns ``(loss on the device, log text)``, or
        ``(None, "")`` for the pipelined warm-up."""
        if not self.overlap_rollout:
            ro = self._rollout(batch)
            return self._step(trainor, ro, self._rewards(ro), lr)
        prev, self._pending = self._pending, None
        future = None
        if prev is not None:
            if self._reward_pool is None:
                device = prev.sampled_dev.device
                self._reward_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
                self._reward_pool = ThreadPoolExecutor(1, thread_name_prefix="scst-rewards")
            future = self._reward_pool.submit(self._worker_rewards, prev)
        try:
            self._pending = self._rollout(batch)
        finally:
            rewards = future.result() if future is not None else None
        if prev is None:
            return None, ""
        return self._step(trainor, prev, rewards, lr)

    def finish_epoch(self, trainor, lr: float):
        """The epoch-end hook: the pipelined iteration's last batch takes its
        step here, ``(loss, log text)``; None when nothing is pending."""
        prev, self._pending = self._pending, None
        if self._reward_pool is not None:
            self._reward_pool.shutdown()
            self._reward_pool, self._reward_stream = None, None
        if prev is None:
            return None
        return self._step(trainor, prev, self._rewards(prev), lr)

    def __repr__(self):
        return f"model: {type(self).__name__}\n{self.scst}"


@registry.register("model")
class RRG_SCST(_SCSTBase):
    base_proto = "RRG"

    def __init__(self, decoder, cnn, **kwargs):
        super().__init__(decoder=decoder, cnn=cnn, **kwargs)


@registry.register("model")
class RRS_SCST(_SCSTBase):
    base_proto = "RRS"

    def __init__(self, encoder, decoder, **kwargs):
        super().__init__(encoder=encoder, decoder=decoder, **kwargs)
