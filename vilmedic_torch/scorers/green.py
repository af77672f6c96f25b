"""GREEN: LLM-judge clinical error counting (port of ``scorers/green.py``).

A causal LM is prompted to count clinically (in)significant errors and
matched findings between a reference and a candidate report; the response
is regex-parsed into counts and ``green = matched / (matched + sum of
significant errors)``; a global pair -> reward memo avoids judging a pair
twice (the SCST reward use). The prompt, the chat framing, the parser, the
categories and the memo are the JAX package's, verbatim.

The judge is the port's LLaMA (:mod:`..blocks.llm.llama`) loaded from a
local checkpoint (``GREEN_MODEL``, ``$VILMEDIC_WEIGHTS_DIR/green``, or the HF
hub cache of ``StanfordAIMI/GREEN-radllama2-7b``) by
:func:`..zoo.convert_llm.build_hf_llama`, in the checkpoint's dtype, on the
card unless the caller names another device, behind the checkpoint's
``tokenizer.json`` (:mod:`..data.auto_tokenizer`) with left padding and pad
= eos when it has no pad. Prompts are truncated at ``max_length`` and
decoded greedily for ``min(1024, max_length)`` new tokens
(:func:`..blocks.llm.llama.greedy_generate`); the responses are the new
tokens' text. The JAX package's 128-multiple length buckets and fixed batch
only bound its recompiles: left padding is masked out of every score and
leaves the positions as they are, so the port drops them
(``tests/test_torch_llama.py`` holds the responses equal). The
``transformers`` route (``VILMEDIC_GREEN_BACKEND=torch``) is not ported.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

CATEGORIES = [
    "Clinically Significant Errors",
    "Clinically Insignificant Errors",
    "Matched Findings",
]

SUB_CATEGORIES = [
    "(a) False report of a finding in the candidate",
    "(b) Missing a finding present in the reference",
    "(c) Misidentification of a finding's anatomic location/position",
    "(d) Misassessment of the severity of a finding",
    "(e) Mentioning a comparison that isn't in the reference",
    "(f) Omitting a comparison detailing a change from a prior study",
]

#: global pair -> reward memo (reference green.py:10 ``pair_to_reward_dict``)
pair_to_reward_dict: Dict[Tuple[str, str], float] = {}


def make_prompt(text1: str, text2: str) -> str:
    """Reference green.py:59 verbatim prompt structure."""
    return (
        "Objective: Evaluate the accuracy of a candidate radiology report in "
        "comparison to a reference radiology report composed by expert "
        "radiologists.\n\n    Process Overview: You will be presented with:\n\n"
        "    1. The criteria for making a judgment.\n"
        "    2. The reference radiology report.\n"
        "    3. The candidate radiology report.\n"
        "    4. The desired format for your assessment.\n\n"
        "    1. Criteria for Judgment:\n\n    For each candidate report, "
        "determine:\n\n    The count of clinically significant errors.\n"
        "    The count of clinically insignificant errors.\n\n"
        "    Errors can fall into one of these categories:\n\n"
        "    a) False report of a finding in the candidate.\n"
        "    b) Missing a finding present in the reference.\n"
        "    c) Misidentification of a finding's anatomic location/position.\n"
        "    d) Misassessment of the severity of a finding.\n"
        "    e) Mentioning a comparison that isn't in the reference.\n"
        "    f) Omitting a comparison detailing a change from a prior study.\n"
        "    Note: Concentrate on the clinical findings rather than the "
        "report's writing style. Evaluate only the findings that appear in "
        "both reports.\n\n"
        f"    2. Reference Report:\n    {text1}\n\n"
        f"    3. Candidate Report:\n    {text2}\n\n"
        "    4. Reporting Your Assessment:\n\n"
        "    Follow this specific format for your output, even if no errors "
        "are found:\n    ```\n    [Explanation]:\n    <Explanation>\n\n"
        "    [Clinically Significant Errors]:\n"
        "    (a) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; "
        "...; <Error n>\n    ....\n"
        "    (f) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; "
        "...; <Error n>\n\n    [Clinically Insignificant Errors]:\n"
        "    (a) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; "
        "...; <Error n>\n    ....\n"
        "    (f) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; "
        "...; <Error n>\n\n    [Matched Findings]:\n"
        "    <The number of matched findings>. <Finding 1>; <Finding 2>; ...; "
        "<Finding n>\n    ```\n"
    )


def parse_error_counts(text: str, category: str,
                       return_0_if_no_green_score: bool = True):
    """Reference green.py:114-180 exact regex semantics."""
    if category not in CATEGORIES:
        raise ValueError(
            f"Category {category} is not a valid category. Please choose from "
            f"{CATEGORIES}."
        )
    pattern = rf"\[{category}\]:\s*(.*?)(?:\n\s*\n|\Z)"
    category_text = re.search(pattern, text, re.DOTALL)

    sum_counts = 0
    sub_counts = [0 for _ in range(6)]
    if not category_text:
        if return_0_if_no_green_score:
            return sum_counts, sub_counts
        return None, [None for _ in range(6)]
    if category_text.group(1).startswith("No"):
        return sum_counts, sub_counts

    if category == "Matched Findings":
        counts = re.findall(r"^\b\d+\b(?=\.)", category_text.group(1))
        if len(counts) > 0:
            sum_counts = int(counts[0])
        return sum_counts, sub_counts

    sub_categories = [s.split(" ", 1)[0] + " " for s in SUB_CATEGORIES]
    matches = sorted(re.findall(r"\([a-f]\) .*", category_text.group(1)))
    if len(matches) == 0:  # gpt-4 template numbers the subcategories
        matches = sorted(re.findall(r"\([1-6]\) .*", category_text.group(1)))
        sub_categories = [f"({i}) " for i in range(1, len(SUB_CATEGORIES) + 1)]

    for position, sub_category in enumerate(sub_categories):
        for match in matches:
            if match.startswith(sub_category):
                count = re.findall(r"(?<=: )\b\d+\b(?=\.)", match)
                if len(count) > 0:
                    sub_counts[position] = int(count[0])
    return sum(sub_counts), sub_counts


def compute_green(response: str,
                  return_0_if_no_green_score: bool = True) -> Optional[float]:
    """Reference green.py:166-180: matched / (matched + significant errors)."""
    sig_present, sig_errors = parse_error_counts(
        response, CATEGORIES[0], return_0_if_no_green_score
    )
    matched_findings, _ = parse_error_counts(
        response, CATEGORIES[2], return_0_if_no_green_score
    )
    if matched_findings == 0:
        return 0
    if sig_present is None or matched_findings is None:
        return None
    return matched_findings / (matched_findings + sum(sig_errors))


def _chat_wrap(prompt: str) -> str:
    """The judge chat framing (reference green.py:40 chat template's
    user-turn + generation-prompt shape) — shared by both backends."""
    return f"<|user|>\n{prompt}\n<|assistant|>"


class GREENImpl:
    """``__call__(refs, hyps) -> (mean_green, per_pair_scores)`` with the
    global memo. ``judge_fn`` (``List[prompt] -> List[response]``) is
    injectable; by default the LLaMA judge of a local checkpoint runs on
    ``device``."""

    def __init__(self, model_name: str = "StanfordAIMI/GREEN-radllama2-7b", judge_fn=None,
                 max_length: int = 2048, batch_size: int = 4,
                 return_0_if_no_green_score: bool = True, device="cuda", **kwargs):
        self.return_0 = return_0_if_no_green_score
        if judge_fn is None:
            from ..models.base import local_hf_config_dir
            from .clinical import ScorerUnavailable
            from .weights import resolve

            if os.environ.get("VILMEDIC_GREEN_BACKEND", "auto") == "torch":
                raise NotImplementedError("VILMEDIC_GREEN_BACKEND=torch (the transformers "
                                          "judge) is not ported; the port's judge is its LLaMA")
            model_name = resolve("GREEN_MODEL", model_name)
            folder = model_name if os.path.isdir(model_name) else local_hf_config_dir(model_name)
            if folder is None:
                raise ScorerUnavailable(
                    "GREEN judge weights unavailable: set GREEN_MODEL to a local HF "
                    "causal-LM directory or cache the checkpoint")
            judge_fn = self.llama_judge(folder, max_length, batch_size, device=device)
        self.judge_fn = judge_fn

    @staticmethod
    def llama_judge(model_dir: str, max_length: int, batch_size: int, tokenizer=None,
                    max_new_tokens: Optional[int] = None, device="cuda", model=None):
        """Batched greedy decoding of the judge: ``List[prompt] ->
        List[response]`` (the new tokens' text). ``tokenizer`` and
        ``model`` are injectable."""
        import torch

        from ..blocks.llm.llama import greedy_generate
        from ..data.auto_tokenizer import AutoTokenizer
        from ..models.base import resolve_device
        from ..zoo.convert_llm import build_hf_llama

        if tokenizer is None:
            tokenizer = AutoTokenizer.from_pretrained(model_dir, padding_side="left")
            if tokenizer.pad_token is None:
                tokenizer.pad_token = tokenizer.eos_token
        device = resolve_device(device)
        model = model or build_hf_llama(model_dir, device=device)
        max_new = max_new_tokens or min(1024, max_length)
        eos = tokenizer.eos_token_id
        pad = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else eos

        def judge(prompts: List[str]) -> List[str]:
            outs = []
            for start in range(0, len(prompts), batch_size):
                chunk = [_chat_wrap(p) for p in prompts[start: start + batch_size]]
                ids, mask = tokenizer.encode_batch(chunk, max_length=max_length,
                                                   padding="longest", padding_side="left")
                toks = greedy_generate(model, torch.from_numpy(ids).to(device),
                                       torch.from_numpy(mask).to(device), max_new, eos, pad)
                outs.extend(tokenizer.batch_decode(toks.cpu().numpy(), skip_special_tokens=True))
            return outs

        return judge

    def __call__(self, refs: List[str], hyps: List[str]):
        assert len(refs) == len(hyps)
        final = np.zeros((len(refs),), np.float64)
        todo, idx = [], []
        for i, (ref, hyp) in enumerate(zip(refs, hyps)):
            if (ref, hyp) in pair_to_reward_dict:
                final[i] = pair_to_reward_dict[(ref, hyp)]
            else:
                todo.append((ref, hyp))
                idx.append(i)
        if todo:
            responses = self.judge_fn([make_prompt(r, h) for r, h in todo])
            for (ref, hyp), i, resp in zip(todo, idx, responses):
                green = compute_green(resp, self.return_0)
                score = float(green) if green is not None else 0.0
                pair_to_reward_dict[(ref, hyp)] = score
                final[i] = score
        return float(final.mean()), final.tolist()
