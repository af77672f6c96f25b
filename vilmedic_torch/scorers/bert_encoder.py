"""BERT and DistilBERT text encoders, and the reader of their HF weight
files, without ``transformers`` or ``safetensors`` (for BERTScore,
:mod:`.bertscore_impl`).

:class:`BertEncoder` is HF ``BertModel`` (word, position and token-type
embeddings, then post-LN layers: self-attention, ``attention.output``
dense + LayerNorm, ``intermediate`` dense + GELU, ``output`` dense +
LayerNorm) or ``DistilBertModel`` (word and position embeddings; layers of
``q_lin`` / ``k_lin`` / ``v_lin`` / ``out_lin``, ``sa_layer_norm``,
``ffn.lin1`` / ``lin2``, ``output_layer_norm``, LayerNorm eps 1e-12), with
HF's module names, so a checkpoint's state dict loads as it is. Its forward
returns every hidden state, the embeddings' first, as HF's
``output_hidden_states`` does. Padded keys get the float32 minimum added to
their scores, as HF's extended attention mask does. The activation is the
exact GELU (both models' default); another activation or ``model_type``
raises.

:func:`load_weights` reads ``model.safetensors`` by hand (an 8-byte
little-endian header length, a JSON header of dtypes, shapes and byte
offsets, then the raw little-endian tensors) or ``pytorch_model.bin``
through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

SUPPORTED = ("bert", "distilbert")
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

    def __init__(self, cfg: Dict):
        super().__init__()
        self.model_type = cfg.get("model_type")
        if self.model_type not in SUPPORTED:
            raise NotImplementedError(f"BERTScore encoder model_type {self.model_type!r}: "
                                      f"the port has {SUPPORTED}")
        distil = self.model_type == "distilbert"
        h = cfg["dim"] if distil else cfg["hidden_size"]
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg["vocab_size"], h)
        self.embeddings.position_embeddings = nn.Embedding(cfg["max_position_embeddings"], h)
        if not distil:
            self.embeddings.token_type_embeddings = nn.Embedding(cfg.get("type_vocab_size", 2), h)
        eps = 1e-12 if distil else cfg.get("layer_norm_eps", 1e-12)
        self.embeddings.LayerNorm = nn.LayerNorm(h, eps=eps)
        n = cfg["n_layers"] if distil else cfg["num_hidden_layers"]
        stack = nn.Module()
        stack.layer = nn.ModuleList(
            (_DistilLayer if distil else _BertLayer)(cfg) for _ in range(n))
        self.stack_name = "transformer" if distil else "encoder"
        self.add_module(self.stack_name, stack)

    def load_hf_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a checkpoint's tensors: a ``bert.`` / ``distilbert.`` prefix
        is dropped, ``gamma`` / ``beta`` read as LayerNorm ``weight`` /
        ``bias``, heads and poolers are left out; every tensor of the
        encoder must be there."""
        own = self.state_dict()
        got = {}
        for key, value in state.items():
            for prefix in ("bert.", "distilbert."):
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

    def forward(self, input_ids, attention_mask) -> List[torch.Tensor]:
        """Every hidden state (the embeddings', then each layer's), (B, T, H)."""
        emb = self.embeddings
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = emb.word_embeddings(input_ids) + emb.position_embeddings(positions)
        if hasattr(emb, "token_type_embeddings"):
            x = x + emb.token_type_embeddings(torch.zeros_like(input_ids))
        x = emb.LayerNorm(x)
        bias = (1.0 - attention_mask[:, None, None, :].float()) * torch.finfo(torch.float32).min
        hidden = [x]
        for layer in getattr(self, self.stack_name).layer:
            x = layer(x, bias)
            hidden.append(x)
        return hidden
