"""SCST, self-critical sequence training (port of ``blocks/rl/scst.py``).

The policy gradient of the JAX package: a sampled and a greedy rollout
without gradients, host rewards for both, then the sampled sequences
teacher-forced through the decoder, where per-token log-probabilities times
the advantage (reward of the sample minus reward of the greedy rollout) give
the loss (:func:`scst_loss`).

Loss semantics (the reference's ``scst_loss``): the token mask is
``token_id > pad_token_id`` (PAD and, with PAD 1 and BOS 0, BOS are out; EOS
is in); the log-probabilities are divided by the mask's total over the
batch, summed per sample, negated, and weighted per scorer by its advantage
and its weight.

:class:`SCST` is the host side: it builds the reward scorers from
``scorers.scores.REWARD_COMPLIANT`` (``scores_args`` give each its keyword
arguments; the clinical scorers' networks run on ``device``), decodes ids
to text and scores them, calling each scorer as ``scorer(refs, hyps)``, as
the JAX package does (so ``chexbert``'s ``(hyps, refs)`` sees them swapped,
which its symmetric per-sample accuracy does not notice).

One case differs from the JAX package on purpose: ``radgraph`` without
``scores_args`` takes its default ``reward_level="all"``, whose per-sample
output is the three levels' lists, a (3, B) reward. The JAX package stacks
that into (1, 3, B) advantages, which broadcast in its loss into the sum of
the three levels (alone) or fail in ``np.stack`` (beside another reward).
The port raises a ``ValueError`` naming ``scores_args`` instead, and any
reward that is not one value per sample raises in :meth:`SCST.get_reward`.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def scst_loss(token_logp: torch.Tensor, sampled_ids: torch.Tensor, advantages: torch.Tensor,
              scores_weights: Sequence[float], pad_token_id: int) -> torch.Tensor:
    """``token_logp`` (B, T) f32 log-probabilities of the sampled tokens
    ``sampled_ids`` (B, T); ``advantages`` (n_scores, B). Returns the
    scalar ``sum_k w_k sum_b adv_kb * (-sum_t logp_bt mask_bt / sum mask)``."""
    mask = (sampled_ids > pad_token_id).float()
    logp = token_logp * mask / mask.sum().clamp_min(1.0)
    per_sample = -logp.sum(dim=-1)
    weights = torch.tensor(list(scores_weights), dtype=torch.float32, device=token_logp.device)
    return (weights[:, None] * advantages * per_sample[None, :]).sum()


class SCST:
    """Reward construction and scoring on the host."""

    def __init__(self, tokenizer, max_length: int, bos_token_id: int, eos_token_id: int,
                 pad_token_id: int, scores="ROUGEL", scores_args=None, scores_weights=None,
                 top_k: Optional[int] = None, use_nll: bool = False, device="cuda"):
        from ...scorers.scores import DEVICE_REWARDS, REWARD_COMPLIANT

        self.tokenizer = tokenizer
        self.max_length = int(max_length)
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.top_k = top_k
        self.use_nll = use_nll

        if not isinstance(scores, (list, tuple)):
            scores = [scores]
        scores = [str(s).lower() for s in scores]
        unknown = [s for s in scores if s not in REWARD_COMPLIANT]
        if unknown:
            raise ValueError(f"{unknown} not in {sorted(REWARD_COMPLIANT)}")
        self.scores = scores

        if len(scores) > 1 or use_nll:
            expected = len(scores) + (1 if use_nll else 0)
            if not isinstance(scores_weights, (list, tuple)) or len(scores_weights) != expected:
                raise ValueError(f"scores_weights must be a list of {expected} weights")
            self.scores_weights = [float(w) for w in scores_weights]
        else:
            self.scores_weights = [1.0]

        if scores_args is None:
            scores_args = [None] * len(scores)
        elif not isinstance(scores_args, (list, tuple)):
            scores_args = [scores_args]
        if len(scores_args) != len(scores):
            raise ValueError("scores_args must give one entry per score")

        self.scorers, self.scorers_index = [], []
        for score, args in zip(scores, scores_args):
            args = dict(args or {})
            if score == "radgraph" and args.get("reward_level", "all") == "all":
                raise ValueError("the radgraph reward needs one level: reward_level 'all' (its "
                                 "default) gives three rewards per sample; pass scores_args "
                                 "such as {reward_level: partial}")
            if score in DEVICE_REWARDS:
                args.setdefault("device", device)
            factory, index = REWARD_COMPLIANT[score]
            self.scorers.append(factory(**args))
            self.scorers_index.append(index)

    @property
    def reward_weights(self) -> List[float]:
        """The reward terms' weights (the NLL weight, first, left out)."""
        return self.scores_weights[-len(self.scores):]

    @property
    def nll_weight(self) -> float:
        return self.scores_weights[0] if self.use_nll else 0.0

    def decode(self, ids: np.ndarray) -> List[str]:
        return [self.tokenizer.decode(row, skip_special_tokens=True,
                                      clean_up_tokenization_spaces=False) for row in ids]

    def get_reward(self, rollout_ids: np.ndarray, ref_ids: np.ndarray
                   ) -> Tuple[List[np.ndarray], List[str], List[str]]:
        """Per-scorer (B,) f32 rewards of the decoded rollouts against the
        decoded references, with both text lists."""
        hyp_list = self.decode(rollout_ids)
        ref_list = self.decode(ref_ids)
        rewards = [np.asarray(scorer(ref_list, hyp_list)[idx], np.float32)
                   for scorer, idx in zip(self.scorers, self.scorers_index)]
        for score, reward in zip(self.scores, rewards):
            if reward.shape != (len(hyp_list),):
                raise ValueError(f"the {score} reward has shape {reward.shape}, not one value "
                                 f"for each of the {len(hyp_list)} samples")
        return rewards, hyp_list, ref_list

    def __repr__(self):
        return "SCST\n" + json.dumps({
            "Scores": str(self.scores), "scores_weights": str(self.scores_weights),
            "Generate": {"top_k": self.top_k}, "use_nll": self.use_nll,
        }, indent=4)
