"""BERTScore over a local HF encoder directory, the encoder on the card
(port of ``scorers/bertscore_impl.py``).

The semantics are the ``bert_score`` package's, as the JAX package
reimplements them (the reference: distilbert-base-uncased, ``num_layers=5``,
``idf=False``, ``rescale_with_baseline=True``):

- token embeddings from the chosen layer (:data:`DEFAULT_LAYERS` by the
  model's name; the last layer for any other name, a directory path
  included), L2-normalized, ``[CLS]`` and ``[SEP]`` dropped; pairwise cosine
  similarity; greedy max matching;
- P = the (idf-weighted) mean over hypothesis tokens of the best match, R
  the same over reference tokens, F1 their harmonic mean;
- idf weighting (off by default): ``log((N + 1) / (df + 1))`` document
  frequencies over the references, special tokens 0, unseen tokens
  ``log(N + 1)``;
- baseline rescaling ``(s - b) / (1 - b)`` per P / R / F, the baseline from
  the caller, else the ``BERTSCORE_BASELINE`` variable ("P,R,F"), else the
  ``BERTSCORE_BASELINE_TSV`` file (or ``$VILMEDIC_WEIGHTS_DIR``'s), else an
  installed ``bert_score`` package's tsv (read, not imported), in the JAX
  code's order; without any the raw scores are returned with a warning.

Where the JAX package runs ``transformers`` on the CPU, the port runs its own
encoder in f32 on the card unless the caller names another device, with
weights read from ``model.safetensors`` or ``pytorch_model.bin``:
:mod:`.bert_encoder` (BERT, DistilBERT or RoBERTa, built up to the layer
read) or, for ``model_type:
modernbert``, :mod:`.modernbert`, behind the directory's tokenizer as
``AutoTokenizer`` reads it (``data.auto_tokenizer``). Missing weights raise ``ScorerUnavailable``.
The loaded encoder is kept per (model directory, device, layer), so a Validator
that scores every epoch reads its weights once.
"""

from __future__ import annotations

import csv
import functools
import importlib.util
import json
import logging
import math
import os
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: the reference's layer per model name (bert_score's model2layers)
DEFAULT_LAYERS = {
    "distilbert-base-uncased": 5,
    "bert-base-uncased": 9,
    "roberta-large": 17,
}


def _read_tsv(path: str, layer: int) -> Optional[Tuple[float, float, float]]:
    with open(path) as fh:
        for row in csv.DictReader(fh):
            if int(row["LAYER"]) == layer:
                return float(row["P"]), float(row["R"]), float(row["F"])
    return None


def _resolve_baseline(model_type: str, layer: int) -> Optional[Tuple[float, float, float]]:
    from .weights import resolve

    env = os.environ.get("BERTSCORE_BASELINE")
    if env:
        p, r, f = (float(x) for x in env.split(","))
        return p, r, f
    tsv = resolve("BERTSCORE_BASELINE_TSV")
    if tsv and os.path.exists(tsv):
        try:
            got = _read_tsv(tsv, layer)
            if got:
                return got
        except Exception:
            pass
    try:  # an installed bert_score package ships the tsv
        spec = importlib.util.find_spec("bert_score")
        folder = os.path.dirname(spec.origin)
        return _read_tsv(os.path.join(folder, "rescale_baseline", "en", f"{model_type}.tsv"),
                         layer)
    except Exception:
        return None


def compute_idf_dict(refs: List[str], tokenizer) -> Dict[int, float]:
    """bert_score's ``get_idf_dict``: smooth idf over the references."""
    n = len(refs)
    df: Counter = Counter()
    for r in refs:
        df.update(set(tokenizer.encode_truncated(r)))
    idf = {tid: math.log((n + 1) / (c + 1)) for tid, c in df.items()}
    for special in (tokenizer.cls_token_id, tokenizer.sep_token_id, tokenizer.pad_token_id):
        if special is not None:
            idf[special] = 0.0
    return idf


def load_scorer(model_type: str, device, layer: Optional[int] = None):
    """``(tokenizer, encoder on device)`` of a local model directory or a
    name in the HF hub cache, loaded once per (directory, device, layer);
    ``ScorerUnavailable`` without its files. With ``layer`` a BERT-family
    encoder is built and read up to that layer only (the hidden states up
    to it are the full model's)."""
    from ..models.base import local_hf_config_dir, resolve_device
    from .clinical import _require

    folder = model_type if os.path.isdir(model_type) else local_hf_config_dir(model_type)
    _require(folder is not None and os.path.isfile(os.path.join(folder, "config.json")),
             "BertScore")
    return _load_scorer(os.path.abspath(folder), str(resolve_device(device)), layer)


@functools.lru_cache(maxsize=4)
def _load_scorer(folder: str, device: str, layer: Optional[int] = None):
    from ..data.auto_tokenizer import AutoTokenizer
    from .bert_encoder import BertEncoder, load_weights
    from .clinical import _require
    from .modernbert import ModernBertEncoder

    weights = load_weights(folder)
    _require(weights is not None, "BertScore")
    with open(os.path.join(folder, "config.json")) as f:
        cfg = json.load(f)
    if cfg.get("model_type") == "modernbert":
        encoder = ModernBertEncoder(cfg)
    else:
        encoder = BertEncoder(cfg, num_layers=layer)
    encoder.load_hf_state_dict(weights)
    return AutoTokenizer.from_pretrained(folder), encoder.to(device).eval()


def bert_score_prf(model_type: str, refs: List[str], hyps: List[str],
                   layer: Optional[int] = None, batch_size: int = 64, idf: bool = False,
                   rescale_with_baseline: bool = True,
                   baselines: Optional[Tuple[float, float, float]] = None, device="cuda",
                   ) -> Tuple[List[float], List[float], List[float]]:
    """Per-pair (P, R, F1) lists (module doc)."""
    if layer is None:
        layer = DEFAULT_LAYERS.get(model_type)
    tokenizer, encoder = load_scorer(model_type, device, layer)
    dev = next(encoder.parameters()).device
    idf_dict = compute_idf_dict(refs, tokenizer) if idf else None
    # an unseen token's idf: bert_score's defaultdict, log((N + 1) / 1)
    idf_default = math.log(len(refs) + 1) if idf else 1.0

    @torch.inference_mode()
    def embed(sentences):
        embs, weights = [], []
        for start in range(0, len(sentences), batch_size):
            rows = [tokenizer.encode_truncated(s) for s in sentences[start: start + batch_size]]
            width = max(len(r) for r in rows)
            ids = torch.full((len(rows), width), tokenizer.pad_token_id, dtype=torch.long)
            mask = torch.zeros((len(rows), width), dtype=torch.long)
            for i, r in enumerate(rows):
                ids[i, :len(r)] = torch.tensor(r)
                mask[i, :len(r)] = 1
            hidden = encoder(ids.to(dev), mask.to(dev))
            h = torch.nn.functional.normalize(hidden[layer] if layer is not None
                                              else hidden[-1], dim=-1)
            for i, r in enumerate(rows):
                embs.append(h[i, 1:len(r) - 1])  # [CLS] and [SEP] dropped
                weights.append(np.array([idf_dict.get(t, idf_default) for t in r[1:-1]],
                                        np.float64) if idf_dict is not None
                               else np.ones((len(r) - 2,), np.float64))
        return embs, weights

    ref_embs, ref_w = embed(refs)
    hyp_embs, hyp_w = embed(hyps)
    ps, rs, fs = [], [], []
    for r, h, rw, hw in zip(ref_embs, hyp_embs, ref_w, hyp_w):
        if len(r) == 0 or len(h) == 0:
            ps.append(0.0), rs.append(0.0), fs.append(0.0)
            continue
        sim = (h @ r.T).cpu().numpy()  # (|hyp|, |ref|)
        precision = float((sim.max(axis=1) * hw).sum() / (hw.sum() or 1.0))
        recall = float((sim.max(axis=0) * rw).sum() / (rw.sum() or 1.0))
        f1 = 2 * precision * recall / max(precision + recall, 1e-8)
        ps.append(precision), rs.append(recall), fs.append(f1)

    if rescale_with_baseline:
        base = baselines or _resolve_baseline(model_type, layer if layer is not None else -1)
        if base is None:
            logger.warning(f"BERTScore baseline for {model_type!r} layer {layer} unavailable "
                           "(no bert_score tsv / BERTSCORE_BASELINE env); returning unrescaled "
                           "scores")
        else:
            bp, br, bf = base
            ps = [(p - bp) / (1 - bp) for p in ps]
            rs = [(r - br) / (1 - br) for r in rs]
            fs = [(f - bf) / (1 - bf) for f in fs]
    return ps, rs, fs


def bert_score_f1(model_type: str, refs: List[str], hyps: List[str],
                  layer: Optional[int] = None, batch_size: int = 64, **kwargs) -> List[float]:
    return bert_score_prf(model_type, refs, hyps, layer=layer, batch_size=batch_size,
                          **kwargs)[2]
