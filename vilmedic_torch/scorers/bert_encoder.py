"""BERT and DistilBERT text encoders, and the readers of their weight
files, without ``transformers`` or ``safetensors``: the one encoder of
BERTScore (:mod:`.bertscore_impl`) and of the clinical scorers (CheXbert,
the RadNER token classifier, the BERTNLI pair classifier).

:class:`BertEncoder` is HF ``BertModel`` (word, position and token-type
embeddings, then post-LN layers: self-attention, ``attention.output``
dense + LayerNorm, ``intermediate`` dense + GELU, ``output`` dense +
LayerNorm) or ``DistilBertModel`` (word and position embeddings; layers of
``q_lin`` / ``k_lin`` / ``v_lin`` / ``out_lin``, ``sa_layer_norm``,
``ffn.lin1`` / ``lin2``, ``output_layer_norm``, LayerNorm eps 1e-12), with
HF's module names, so a checkpoint's state dict loads as it is. A RoBERTa
(``RobertaModel``: BERT's modules under ``roberta.`` or no prefix, a
one-row token-type table) takes HF's position ids, ``cumsum(mask) * mask +
padding_idx`` with the mask ``input_ids != padding_idx``, in place of BERT's
``arange``. Its forward returns every hidden state, the embeddings' first,
as HF's ``output_hidden_states`` does; ``num_layers`` builds only the first
layers, whose hidden states are the full model's (BERTScore reads one
layer and needs none above it). Padded keys get the float32 minimum added to
their scores, as HF's extended attention mask does. The activation is the
exact GELU (both models' default); another activation or ``model_type``
raises. ``token_type_ids`` give the segments (NLI's second sentence);
zeros when not given. ``pooler=True`` adds BERT's pooler (``pooler.dense``,
tanh over the [CLS] state: :meth:`BertEncoder.pooled`).

:func:`load_weights` reads ``model.safetensors`` by hand (an 8-byte
little-endian header length, a JSON header of dtypes, shapes and byte
offsets, then the raw little-endian tensors) or ``pytorch_model.bin``
through ``torch.load(weights_only=True)``; :func:`read_pth` a torch
checkpoint as the scorers ship it (a ``model_state_dict`` entry unwrapped,
DataParallel ``module.`` prefixes dropped), and
:func:`bert_config_from_state_dict` infers the encoder's configuration
from its tensors as the JAX package's loaders do (heads of 64). A scorer
module keeps the encoder as ``bert`` and its heads under the checkpoint's
names, so :func:`load_scorer_state` loads a checkpoint as it is.
"""

from __future__ import annotations

import json
import logging
import math
import os
import pickle
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)

SUPPORTED = ("bert", "distilbert", "roberta")
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        buf = bytearray(data[8 + n + begin: 8 + n + end])
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        flat = (torch.frombuffer(buf, dtype=dtype) if buf
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def load_weights(folder: str) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict in ``folder`` (``model.safetensors``, else
    ``pytorch_model.bin``), or None without either."""
    path = os.path.join(folder, "model.safetensors")
    if os.path.isfile(path):
        return read_safetensors(path)
    path = os.path.join(folder, "pytorch_model.bin")
    if os.path.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    return None


def read_pth(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint on the CPU: ``torch.load`` with
    ``weights_only=True``, or, for a file that pickles other objects, a
    full load (logged); a ``model_state_dict`` entry is unwrapped and the
    ``module.`` prefix of a DataParallel save dropped."""
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        logger.warning(f"{path} holds objects besides tensors: loading it in full")
        state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "model_state_dict" in state:
        state = state["model_state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def bert_config_from_state_dict(state: Dict[str, torch.Tensor], prefix: str = "bert.") -> Dict:
    """A BERT ``config.json`` dict from the encoder's tensors under
    ``prefix``: widths from the tables, 64-wide heads (12 for BERT-base),
    the intermediate width from the first FFN, the positions from their
    table."""
    vocab, hidden = state[f"{prefix}embeddings.word_embeddings.weight"].shape
    layers = f"{prefix}encoder.layer."
    n_layers = 1 + max(int(k[len(layers):].split(".")[0]) for k in state if k.startswith(layers))
    return {
        "model_type": "bert", "vocab_size": int(vocab), "hidden_size": int(hidden),
        "num_hidden_layers": n_layers, "num_attention_heads": max(1, int(hidden) // 64),
        "intermediate_size": int(state[f"{layers}0.intermediate.dense.weight"].shape[0]),
        "max_position_embeddings": int(
            state[f"{prefix}embeddings.position_embeddings.weight"].shape[0]),
        "type_vocab_size": int(state[f"{prefix}embeddings.token_type_embeddings.weight"].shape[0]),
    }


def load_scorer_state(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a checkpoint into ``module``: ``module.bert`` by
    :meth:`BertEncoder.load_hf_state_dict`, every other tensor by its own
    name; a tensor the checkpoint lacks raises, the checkpoint's others
    (an unused pooler, position ids) are left out."""
    module.bert.load_hf_state_dict(state)
    heads = [k for k in module.state_dict() if not k.startswith("bert.")]
    missing = [k for k in heads if k not in state]
    if missing:
        raise ValueError(f"the checkpoint lacks {missing[:5]} ({len(missing)} tensors)")
    module.load_state_dict({k: state[k].float() for k in heads}, strict=False)


def _require_gelu(act: str) -> None:
    if act != "gelu":
        raise NotImplementedError(f"BERTScore encoder activation {act!r}: the port has 'gelu'")


class _SelfAttention(nn.Module):
    """BERT's ``attention.self`` or DistilBERT's ``attention`` (by names)."""

    def __init__(self, dim: int, heads: int, names):
        super().__init__()
        self.heads, self.names = heads, names
        for name in names:
            self.add_module(name, nn.Linear(dim, dim))

    def forward(self, x, bias):
        b, t, d = x.shape
        q, k, v = (getattr(self, n)(x).view(b, t, self.heads, -1).transpose(1, 2)
                   for n in self.names[:3])
        scores = q @ k.transpose(-1, -2) / math.sqrt(d // self.heads) + bias
        out = torch.softmax(scores, dim=-1) @ v
        out = out.transpose(1, 2).reshape(b, t, d)
        return getattr(self, self.names[3])(out) if len(self.names) == 4 else out


class _BertLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h, eps = cfg["hidden_size"], cfg.get("layer_norm_eps", 1e-12)
        _require_gelu(cfg.get("hidden_act", "gelu"))
        self.attention = nn.Module()
        self.attention.self = _SelfAttention(h, cfg["num_attention_heads"],
                                             ("query", "key", "value"))
        self.attention.output = nn.Module()
        self.attention.output.dense = nn.Linear(h, h)
        self.attention.output.LayerNorm = nn.LayerNorm(h, eps=eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(h, cfg["intermediate_size"])
        self.output = nn.Module()
        self.output.dense = nn.Linear(cfg["intermediate_size"], h)
        self.output.LayerNorm = nn.LayerNorm(h, eps=eps)

    def forward(self, x, bias):
        out = self.attention.output
        x = out.LayerNorm(out.dense(self.attention.self(x, bias)) + x)
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(h + x)


class _DistilLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dim = cfg["dim"]
        _require_gelu(cfg.get("activation", "gelu"))
        self.attention = _SelfAttention(dim, cfg["n_heads"], ("q_lin", "k_lin", "v_lin",
                                                              "out_lin"))
        self.sa_layer_norm = nn.LayerNorm(dim, eps=1e-12)
        self.ffn = nn.Module()
        self.ffn.lin1 = nn.Linear(dim, cfg["hidden_dim"])
        self.ffn.lin2 = nn.Linear(cfg["hidden_dim"], dim)
        self.output_layer_norm = nn.LayerNorm(dim, eps=1e-12)

    def forward(self, x, bias):
        x = self.sa_layer_norm(self.attention(x, bias) + x)
        return self.output_layer_norm(self.ffn.lin2(F.gelu(self.ffn.lin1(x))) + x)


class BertEncoder(nn.Module):
    """HF ``BertModel`` / ``DistilBertModel`` from a ``config.json`` dict
    (module doc); f32."""

    def __init__(self, cfg: Dict, pooler: bool = False, num_layers: Optional[int] = None):
        super().__init__()
        self.model_type = cfg.get("model_type")
        if self.model_type not in SUPPORTED:
            raise NotImplementedError(f"BERTScore encoder model_type {self.model_type!r}: "
                                      f"the port has {SUPPORTED}")
        distil = self.model_type == "distilbert"
        roberta = self.model_type == "roberta"
        # RoBERTa's position ids count from its padding id (HF's padding_idx)
        self.padding_idx = int(cfg.get("pad_token_id", 1)) if roberta else None
        h = cfg["dim"] if distil else cfg["hidden_size"]
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg["vocab_size"], h)
        self.embeddings.position_embeddings = nn.Embedding(cfg["max_position_embeddings"], h)
        if not distil:
            self.embeddings.token_type_embeddings = nn.Embedding(
                cfg.get("type_vocab_size", 1 if roberta else 2), h)
        eps = 1e-12 if distil else cfg.get("layer_norm_eps", 1e-5 if roberta else 1e-12)
        self.embeddings.LayerNorm = nn.LayerNorm(h, eps=eps)
        n = cfg["n_layers"] if distil else cfg["num_hidden_layers"]
        if num_layers is not None and num_layers >= 0:
            n = min(n, int(num_layers))
        stack = nn.Module()
        stack.layer = nn.ModuleList(
            (_DistilLayer if distil else _BertLayer)(cfg) for _ in range(n))
        self.stack_name = "transformer" if distil else "encoder"
        self.add_module(self.stack_name, stack)
        if pooler:
            self.pooler = nn.Module()
            self.pooler.dense = nn.Linear(h, h)

    def load_hf_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a checkpoint's tensors: a ``bert.`` / ``distilbert.`` /
        ``roberta.`` prefix is dropped, ``gamma`` / ``beta`` read as
        LayerNorm ``weight`` / ``bias``, heads, poolers and layers past the
        built ones are left out; every tensor of the encoder must be
        there."""
        own = self.state_dict()
        got = {}
        for key, value in state.items():
            for prefix in ("bert.", "distilbert.", "roberta."):
                if key.startswith(prefix):
                    key = key[len(prefix):]
            key = key.replace("LayerNorm.gamma", "LayerNorm.weight").replace(
                "LayerNorm.beta", "LayerNorm.bias")
            if key in own:
                got[key] = value.float()
        missing = sorted(set(own) - set(got))
        if missing:
            raise ValueError(f"the checkpoint lacks {missing[:5]} ({len(missing)} tensors)")
        self.load_state_dict(got, strict=True)

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> List[torch.Tensor]:
        """Every hidden state (the embeddings', then each layer's), (B, T, H)."""
        emb = self.embeddings
        if self.padding_idx is not None:
            real = input_ids.ne(self.padding_idx).long()
            positions = torch.cumsum(real, dim=1) * real + self.padding_idx
        else:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = emb.word_embeddings(input_ids) + emb.position_embeddings(positions)
        if hasattr(emb, "token_type_embeddings"):
            x = x + emb.token_type_embeddings(torch.zeros_like(input_ids) if token_type_ids is None
                                              else token_type_ids)
        x = emb.LayerNorm(x)
        bias = (1.0 - attention_mask[:, None, None, :].float()) * torch.finfo(torch.float32).min
        hidden = [x]
        for layer in getattr(self, self.stack_name).layer:
            x = layer(x, bias)
            hidden.append(x)
        return hidden

    def pooled(self, hidden: torch.Tensor) -> torch.Tensor:
        """BERT's pooler over the last hidden state's [CLS] row: (B, H)."""
        return torch.tanh(self.pooler.dense(hidden[:, 0]))
