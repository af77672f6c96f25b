"""DINOv2 vision tower: a LayerScale pre-LN ViT without a pooler (port of
``blocks/vision/dinov2.py``).

Images are NCHW. The patch embedding is a ``Conv2d`` with stride = kernel =
``patch_size`` and no padding; ``flatten(2).transpose(1, 2)`` gives the JAX
NHWC reshape's (h, w) token order. A CLS token and a learned position table
(1, 1 + S, D) are added as stored: the JAX package bakes any interpolation of
the position grid into the weights when it converts a checkpoint, so the
forward is a plain add. Each layer is ``x += ls1 * attn(ln_before(x)); x +=
ls2 * ffn(ln_after(x))``, with the LayerScale vectors kept in f32 and cast to
the activation dtype before the product, as Flax does. The output is the full
(B, 1 + S, D) hidden state after the final LayerNorm.

At 518² / 14 the self-attention runs over 1370 tokens, which takes the flash
kernel (``ops/attention.py``).

Parameters are f32, the patch convolution and the SwiGLU projections
included, cast to the compute dtype at use (Flax's ``param_dtype=float32``),
so that an unfrozen tower's optimizer updates do not round away; a frozen
tower gives the values it gave from compute-dtype parameters. In training
(``train=True``) attention routes as a training step (``FLASH_MIN_LEN_TRAIN``:
at 1370 tokens the flash forward with its LSE and the flash backward,
non-causal) and ``hidden_dropout_prob`` drops the embeddings, the attention
branch and the plain FFN's output (the SwiGLU FFN has no dropout, as in
Flax), with masks from the caller's generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..transformer import (
    FeedForward, LayerNorm, Linear, MultiHeadAttention, TransformerConfig, dropout,
)
from .vit import PatchEmbed


class SwiGLUFFN(nn.Module):
    """``weights_out(silu(x1) * x2)`` with ``x1, x2`` the halves of
    ``weights_in(x)`` (HF ``Dinov2SwiGLUFFN``)."""

    def __init__(self, config: TransformerConfig, hidden_features: int):
        super().__init__()
        self.weights_in = Linear(config.hidden_size, 2 * hidden_features, config.dtype)
        self.weights_out = Linear(hidden_features, config.hidden_size, config.dtype)

    def forward(self, x, generator=None):
        x1, x2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(x1) * x2)


class DinoLayer(nn.Module):
    """Pre-LN transformer layer with LayerScale (HF ``Dinov2Layer``)."""

    def __init__(self, config: TransformerConfig, use_swiglu_ffn: bool = False,
                 mlp_hidden: int = 0):
        super().__init__()
        eps, dt = config.layer_norm_eps, config.dtype
        self.ln_before = LayerNorm(config.hidden_size, eps, dt)
        self.self_attn = MultiHeadAttention(config, cross=False)
        self.ls1 = nn.Parameter(torch.ones(config.hidden_size))
        self.ln_after = LayerNorm(config.hidden_size, eps, dt)
        self.ffn = SwiGLUFFN(config, mlp_hidden) if use_swiglu_ffn else FeedForward(config)
        self.ls2 = nn.Parameter(torch.ones(config.hidden_size))

    def forward(self, x, train: bool = False, generator=None):
        attn = self.self_attn(self.ln_before(x), train=train)
        p = self.self_attn.config.hidden_dropout_prob
        x = x + dropout(attn, p, generator) * self.ls1.to(x.dtype)
        return x + self.ffn(self.ln_after(x), generator) * self.ls2.to(x.dtype)


class Dinov2(nn.Module):
    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, mlp_ratio: float = 4.0, patch_size: int = 14,
                 image_size: int = 518, hidden_dropout_prob: float = 0.0,
                 layer_norm_eps: float = 1e-6,
                 use_swiglu_ffn: bool = False, hidden_act: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mlp_hidden = int(hidden_size * mlp_ratio)
        cfg = TransformerConfig(
            vocab_size=1, hidden_size=hidden_size, num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads, intermediate_size=mlp_hidden,
            hidden_dropout_prob=hidden_dropout_prob, attention_probs_dropout_prob=0.0,
            layer_norm_eps=layer_norm_eps, hidden_act=hidden_act, dtype=dtype,
        )
        self.config = cfg
        self.patch_embed = PatchEmbed(hidden_size, patch_size, dtype)
        tokens = 1 + (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden_size))
        swiglu_hidden = (int(mlp_hidden * 2 / 3) + 7) // 8 * 8
        for i in range(num_hidden_layers):
            self.add_module(f"layer_{i}", DinoLayer(cfg, use_swiglu_ffn, swiglu_hidden))
        self.ln_final = LayerNorm(hidden_size, layer_norm_eps, dtype)

    def forward(self, images, train: bool = False, generator=None):
        """(B, 3, H, W) float images -> (B, 1 + S, D) in the compute dtype.
        ``train`` routes attention as a training step and, with
        ``generator``, draws the dropout masks."""
        dt = self.config.dtype
        x = self.patch_embed(images).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        gen = generator if train else None
        x = dropout(x, self.config.hidden_dropout_prob, gen)
        for i in range(self.config.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, train, gen)
        return self.ln_final(x)


DINOV2_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "mlp_ratio",
               "patch_size", "image_size", "hidden_dropout_prob", "layer_norm_eps",
               "use_swiglu_ffn", "hidden_act")


def make_dinov2(backbone: str, output_layer=None, dtype=torch.float32, **kwargs) -> Dinov2:
    """The tower from a config's keys (:data:`DINOV2_KEYS`; others are
    ignored). ``output_layer`` is accepted and ignored, as the JAX package's
    ``make_dinov2`` ignores it."""
    return Dinov2(dtype=dtype, **{k: v for k, v in kwargs.items() if k in DINOV2_KEYS})
