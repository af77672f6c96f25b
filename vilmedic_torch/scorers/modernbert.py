"""ModernBERT, the encoder of ``radevalbertscore``
(``IAMJB/RadEvalModernBERT``), under HF's parameter names, so that a
``model.safetensors`` loads through :func:`.bert_encoder.load_weights`.

The layout is HF ``ModernBertModel``'s (eval mode, every dropout off):

- ``embeddings.tok_embeddings``, then ``embeddings.norm`` (LayerNorm, a bias
  only with ``norm_bias``);
- per layer ``layers.{i}``: ``attn_norm`` (the identity in layer 0), then
  ``attn.Wqkv`` -> q, k, v of ``num_attention_heads`` heads, rotary
  embeddings (``global_rope_theta`` on every ``global_attn_every_n_layers``-th
  layer, ``local_rope_theta`` on the others), softmax attention in f32 over
  the unpadded keys (and, on the local layers, only keys within
  ``local_attention // 2`` positions on either side), ``attn.Wo``, the
  residual; then ``mlp_norm``, ``mlp.Wi`` split into input and gate, GeGLU
  (``act(input) * gate``, the exact GELU), ``mlp.Wo``, the residual;
- ``final_norm``.

:meth:`ModernBertEncoder.forward` returns the hidden states as
``ModernBertModel(output_hidden_states=True)`` returns them: the
embeddings', then each layer's output, the last one *before*
``final_norm``. The attention is plain ``torch.matmul`` and softmax, as the
reference runs it (transformers on the host); masked scores get the f32
minimum added, as HF's 4-D masks do.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

DEFAULTS = dict(vocab_size=50368, hidden_size=768, intermediate_size=1152,
                num_hidden_layers=22, num_attention_heads=12, hidden_activation="gelu",
                norm_eps=1e-5, norm_bias=False, attention_bias=False, mlp_bias=False,
                global_rope_theta=160000.0, local_rope_theta=10000.0, local_attention=128,
                global_attn_every_n_layers=3)


def _norm(cfg) -> nn.LayerNorm:
    return nn.LayerNorm(cfg["hidden_size"], eps=cfg["norm_eps"], bias=cfg["norm_bias"])


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def rotary(positions: torch.Tensor, head_dim: int, theta: float):
    """``(cos, sin)``, (T, head_dim), in f32: HF's default RoPE."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.int64,
                                             device=positions.device).float() / head_dim))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


class _Attention(nn.Module):
    def __init__(self, cfg, local: bool):
        super().__init__()
        h = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.head_dim = h // self.heads
        self.Wqkv = nn.Linear(h, 3 * h, bias=cfg["attention_bias"])
        self.Wo = nn.Linear(h, h, bias=cfg["attention_bias"])
        self.local = local
        self.theta = cfg["local_rope_theta"] if local and cfg.get("local_rope_theta") is not None \
            else cfg["global_rope_theta"]

    def forward(self, x, global_bias, local_bias):
        b, t, _ = x.shape
        qkv = self.Wqkv(x).view(b, t, 3, self.heads, self.head_dim).transpose(3, 1)
        q, k, v = qkv.unbind(dim=2)  # (B, H, T, D)
        cos, sin = rotary(torch.arange(t, device=x.device), self.head_dim, self.theta)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        scores = torch.matmul(q, k.transpose(2, 3)) * self.head_dim ** -0.5
        scores = scores + (local_bias if self.local else global_bias)
        probs = F.softmax(scores, dim=-1, dtype=torch.float32).to(q.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, -1)
        return self.Wo(out)


class _MLP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h, i = cfg["hidden_size"], cfg["intermediate_size"]
        self.Wi = nn.Linear(h, 2 * i, bias=cfg["mlp_bias"])
        self.Wo = nn.Linear(i, h, bias=cfg["mlp_bias"])

    def forward(self, x):
        inp, gate = self.Wi(x).chunk(2, dim=-1)
        return self.Wo(F.gelu(inp) * gate)


class _Layer(nn.Module):
    def __init__(self, cfg, index: int):
        super().__init__()
        self.attn_norm = nn.Identity() if index == 0 else _norm(cfg)
        self.attn = _Attention(cfg, local=index % cfg["global_attn_every_n_layers"] != 0)
        self.mlp_norm = _norm(cfg)
        self.mlp = _MLP(cfg)

    def forward(self, x, global_bias, local_bias):
        x = x + self.attn(self.attn_norm(x), global_bias, local_bias)
        return x + self.mlp(self.mlp_norm(x))


class ModernBertEncoder(nn.Module):
    """HF ``ModernBertModel`` from a ``config.json`` dict (module doc); f32."""

    def __init__(self, cfg: Dict):
        super().__init__()
        if cfg.get("model_type", "modernbert") != "modernbert":
            raise ValueError(f"model_type {cfg.get('model_type')!r} is not modernbert")
        cfg = {**DEFAULTS, **{k: v for k, v in cfg.items() if v is not None}}
        if cfg["hidden_activation"] not in ("gelu", "gelu_python"):
            raise NotImplementedError(f"ModernBERT activation {cfg['hidden_activation']!r}")
        self.cfg = cfg
        self.embeddings = nn.Module()
        self.embeddings.tok_embeddings = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.embeddings.norm = _norm(cfg)
        self.layers = nn.ModuleList(_Layer(cfg, i) for i in range(cfg["num_hidden_layers"]))
        self.final_norm = _norm(cfg)

    def load_hf_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a checkpoint's tensors: a ``model.`` prefix (the masked-LM
        class's) is dropped and the head left out; every tensor of the
        encoder must be there."""
        own = self.state_dict()
        got = {}
        for key, value in state.items():
            key = key[len("model."):] if key.startswith("model.") else key
            if key in own:
                got[key] = value.float()
        missing = sorted(set(own) - set(got))
        if missing:
            raise ValueError(f"the checkpoint lacks {missing[:5]} ({len(missing)} tensors)")
        self.load_state_dict(got, strict=True)

    def forward(self, input_ids, attention_mask) -> List[torch.Tensor]:
        """Every hidden state, (B, T, H): the embeddings', then each
        layer's output (the last one before ``final_norm``)."""
        t = input_ids.shape[1]
        minimum = torch.finfo(torch.float32).min
        keys = attention_mask[:, None, None, :].bool()
        global_bias = torch.zeros(keys.shape, device=input_ids.device).masked_fill(~keys, minimum)
        pos = torch.arange(t, device=input_ids.device)
        window = (pos[:, None] - pos[None, :]).abs() <= self.cfg["local_attention"] // 2
        local_bias = global_bias.masked_fill(~window, minimum)
        x = self.embeddings.norm(self.embeddings.tok_embeddings(input_ids))
        hidden = []
        for layer in self.layers:
            hidden.append(x)
            x = layer(x, global_bias, local_bias)
        hidden.append(x)
        return hidden
