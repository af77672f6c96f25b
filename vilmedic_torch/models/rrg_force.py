"""RRG_FORCE: report generation that must include given concepts (port of
``models/rrg_force.py``).

Trained as RRG. Its evaluation reads each sample's ``concepts`` (an
``ImSeqAny`` payload, comma-separated words), tokenizes them into forced
ids and decodes greedily under ``constrained_greedy_search`` over the plain
cache and the plain head: unmet forced tokens get a logit bias and EOS is
held back while there is room, so every forced token that fits appears.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import registry
from ..data.image import prepare_batch
from ..decoding import constrained_greedy_search
from .base import get_special_token_ids
from .evaluation_nlg import pipelined_decode, to_device
from .rrg import RRG


def _force_ids(tokenizer, concepts: List[str], max_forced: int = 16) -> np.ndarray:
    """Per-sample concept strings (comma-separated, or lists of words) ->
    a (B, max_forced) int32 id matrix padded with -1."""
    out = np.full((len(concepts), max_forced), -1, np.int32)
    for i, line in enumerate(concepts):
        words = line.split(",") if isinstance(line, str) else line
        ids: List[int] = []
        for w in words:
            ids.extend(tokenizer.encode(str(w).strip(), add_special_tokens=False))
        out[i, :min(len(ids), max_forced)] = ids[:max_forced]
    return out


def make_force_generate_fn(model, max_len: int, bos_id: int, eos_id: int, pad_id: int):
    """``generate(enc_inputs, force_ids)`` -> RolloutResult: encode,
    ``init_cache`` at ``max_len``, constrained greedy decoding."""
    module = model.module

    @torch.inference_mode()
    def generate(enc_inputs, force_ids):
        enc_h, enc_m = module.encode(**enc_inputs)
        self_cache, cross_cache = module.init_cache(enc_h, max_len)
        enc_m = enc_m.to(torch.int32)

        def step_fn(tokens, index):
            return module.decode_step(tokens, self_cache, cross_cache, enc_m, index)[:, -1].float()

        return constrained_greedy_search(step_fn, enc_h.shape[0], max_len, bos_id, eos_id,
                                         pad_id, force_ids, enc_h.device)

    return generate


def evaluation_force(models, config, dl, **kwargs) -> Dict:
    """The constrained-decoding ``eval_func``: ``{"refs", "hyps"}`` over
    ``dl``, with the first model."""
    model = models[0]
    dataset = dl.dataset
    tokenizer = dataset.tokenizer
    bos_id, eos_id, pad_id = get_special_token_ids(model.dec_config, tokenizer)
    generate = make_force_generate_fn(model, int(dataset.tokenizer_max_len), bos_id, eos_id,
                                      pad_id)
    device = next(model.module.parameters()).device

    def prepare(batch):
        n = batch["input_ids"].shape[0]
        concepts = batch.get("concepts") or [""] * n
        force = torch.from_numpy(_force_ids(tokenizer, concepts)).to(device)
        on_device = prepare_batch(to_device(batch, device), dataset)
        return (model.encoder_inputs(on_device), force), batch["input_ids"], n

    return pipelined_decode(dl, tokenizer, prepare,
                            lambda inputs: generate(*inputs).sequences)


@registry.register("model")
class RRG_FORCE(RRG):
    def __init__(self, decoder, cnn, **kwargs):
        super().__init__(decoder=decoder, cnn=cnn, **kwargs)
        self.eval_func = evaluation_force

    def __repr__(self):
        return "model: RRG_FORCE (constrained decoding)"
