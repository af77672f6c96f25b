"""RRG_SCST and RRS_SCST: self-critical reinforcement fine-tuning of a
trained generation model (port of ``models/scst_models.py``).

The SCST model wraps its base model (``RRG`` or ``RRS``, its weights from
the port checkpoint ``ckpt`` when given) and owns the training step
(:meth:`_SCSTBase.train_iteration`, which the ``Trainor`` calls per batch),
strictly on-policy, as the JAX package's serial iteration:

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

``timing`` accumulates ``rollout_s``, ``reward_s`` and ``grad_s`` (each
ended by a host sync) and counts ``iters``. The JAX package's pipelined
``overlap_rollout`` is not ported and raises.
"""

from __future__ import annotations

import time
from typing import Dict

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


def scst_evaluation(models, config, dl, **kwargs) -> Dict:
    """The base models' NLG ``evaluation``."""
    return evaluation([m.model for m in models], config, dl)


class _SCSTBase:
    base_proto: str = None

    def __init__(self, dl=None, scores="ROUGEL", ckpt=None, scores_args=None,
                 scores_weights=None, top_k=None, use_nll=False, overlap_rollout=False,
                 device="cuda", seed: int = 0, **base_kwargs):
        if overlap_rollout:
            raise NotImplementedError("overlap_rollout (the pipelined SCST iteration) is not "
                                      "ported; the serial on-policy iteration is")
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
        self.scst = SCST(tokenizer=tokenizer, max_length=max_len, bos_token_id=bos,
                         eos_token_id=eos, pad_token_id=pad, scores=scores,
                         scores_args=scores_args, scores_weights=scores_weights, top_k=top_k,
                         use_nll=use_nll)
        self.eval_func = scst_evaluation
        device = next(self.module.parameters()).device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.timing = {"rollout_s": 0.0, "reward_s": 0.0, "grad_s": 0.0, "iters": 0}
        self.last = None  # the last iteration's rollouts, rewards and loss

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

    def train_iteration(self, trainor, batch, lr: float):
        """One on-policy SCST step on a batch already on the device.
        Returns ``(loss on the device, log text)``."""
        t0 = time.perf_counter()
        enc_inputs = self.encoder_inputs(batch)
        greedy, sampled = self.rollouts(enc_inputs)
        greedy_np, sampled_np = greedy.cpu().numpy(), sampled.cpu().numpy()
        t1 = time.perf_counter()
        refs = batch[self.ref_key].cpu().numpy()
        reward_greedy, _, _ = self.scst.get_reward(greedy_np, refs)
        reward_sampling, _, _ = self.scst.get_reward(sampled_np, refs)
        advantages = np.stack([rs - rg for rs, rg in zip(reward_sampling, reward_greedy)]
                              ).astype(np.float32)  # (n_scores, B)
        t2 = time.perf_counter()
        trainor.zero_grads()
        loss = self.policy_loss(batch, enc_inputs, sampled,
                                torch.from_numpy(advantages).to(sampled.device))
        loss.backward()
        gated_update(trainor.tx, lr, loss)  # reads the loss: the step has ended
        t3 = time.perf_counter()
        self.timing["rollout_s"] += t1 - t0
        self.timing["reward_s"] += t2 - t1
        self.timing["grad_s"] += t3 - t2
        self.timing["iters"] += 1
        mean_sampling = float(np.mean(np.concatenate(reward_sampling)))
        self.last = {"greedy": greedy_np, "sampled": sampled_np, "reward_greedy": reward_greedy,
                     "reward_sampling": reward_sampling, "loss": loss.detach()}
        return loss.detach(), (f"reward_sampling {mean_sampling:.4f}, "
                               f"delta_reward: {float(np.mean(advantages)):.4f}")

    def finish_epoch(self, trainor, lr: float):
        """The epoch-end hook: the serial iteration leaves nothing pending."""
        return None

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
