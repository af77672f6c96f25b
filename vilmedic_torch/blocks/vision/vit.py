"""Vision Transformer: patch embedding, CLS token, learned positions and a
transformer encoder (port of ``blocks/vision/vit.py``).

Images are NCHW. The patch embedding is a convolution with stride = kernel
= ``patch_size``, no padding and a bias, over f32 parameters cast to the
compute dtype at use (Flax's ``param_dtype=float32`` with ``dtype=``);
``flatten(2).transpose(1, 2)`` gives the JAX NHWC reshape's (h, w) token
order. A CLS token (zeros at init) and a position table (1, 1 + S, D)
(N(0, 0.02) at init) are f32 parameters cast to the compute dtype. S is
fixed when the tower is built, from ``image_size`` and ``patch_size``; the
Flax module infers it from its first input.

The layers are the BERT-style post-LN :class:`~..transformer.EncoderLayer`
(the default) or, with ``pre_ln``, :class:`ViTLayer`, HF ViT's residual
structure. ``hidden_act`` is ``gelu`` (exact erf) or ``gelu_tanh``;
``hidden_dropout_prob`` drops the embeddings, the attention output and the
FFN output in training, with masks from the caller's generator. Attention
routes through ``ops.attention`` as the JAX tower's does, a training
forward at ``FLASH_MIN_LEN_TRAIN``: at 224² / 16 (197 tokens) that is
dense attention. The output is the (B, 1 + S, D) hidden state after the
final LayerNorm. ``gradient_checkpointing`` (``True`` or ``"dots"``)
recomputes each layer in the backward (``transformer.run_layer``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..transformer import (
    EncoderLayer, FeedForward, LayerNorm, MultiHeadAttention, TransformerConfig, dropout,
    run_layer,
)


class ViTLayer(nn.Module):
    """Pre-LN layer (HF ``ViTLayer``): ``x += attn(ln_before(x)); x +=
    ffn(ln_after(x))``."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        eps, dt = config.layer_norm_eps, config.dtype
        self.ln_before = LayerNorm(config.hidden_size, eps, dt)
        self.self_attn = MultiHeadAttention(config, cross=False)
        self.ln_after = LayerNorm(config.hidden_size, eps, dt)
        self.ffn = FeedForward(config)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        attn = self.self_attn(self.ln_before(x), train=train)
        x = x + dropout(attn, self.self_attn.config.hidden_dropout_prob, generator)
        return x + self.ffn(self.ln_after(x), generator)


class PatchEmbed(nn.Conv2d):
    """Flax ``nn.Conv(D, (p, p), strides=(p, p), padding="VALID",
    dtype=..., param_dtype=float32)``."""

    def __init__(self, hidden_size: int, patch_size: int, dtype: torch.dtype):
        super().__init__(3, hidden_size, patch_size, stride=patch_size)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class ViT(nn.Module):
    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, intermediate_size: int = 3072,
                 patch_size: int = 16, image_size: int = 224, hidden_dropout_prob: float = 0.0,
                 layer_norm_eps: float = 1e-12, hidden_act: str = "gelu", pre_ln: bool = False,
                 gradient_checkpointing=False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if hidden_act not in ("gelu", "gelu_tanh"):
            raise ValueError(f"ViT hidden_act {hidden_act!r}: 'gelu' or 'gelu_tanh'")
        cfg = TransformerConfig(
            vocab_size=1, hidden_size=hidden_size, num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads, intermediate_size=intermediate_size,
            hidden_dropout_prob=hidden_dropout_prob, layer_norm_eps=layer_norm_eps,
            hidden_act=hidden_act, gradient_checkpointing=gradient_checkpointing, dtype=dtype,
        )
        self.config = cfg
        self.pre_ln = pre_ln
        self.patch_embed = PatchEmbed(hidden_size, patch_size, dtype)
        tokens = 1 + (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden_size))
        layer_cls = ViTLayer if pre_ln else EncoderLayer
        for i in range(num_hidden_layers):
            self.add_module(f"layer_{i}", layer_cls(cfg))
        self.ln_final = LayerNorm(hidden_size, layer_norm_eps, dtype)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_hidden_layers)]

    def forward(self, images, train: bool = False, generator: Optional[torch.Generator] = None):
        """(B, 3, H, W) float images -> (B, 1 + S, D) in the compute dtype.
        ``train`` routes attention as a training step and, with
        ``generator``, draws the dropout masks."""
        dt = self.config.dtype
        x = self.patch_embed(images).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        gen = generator if train else None
        x = dropout(x, self.config.hidden_dropout_prob, gen)
        remat = self.config.gradient_checkpointing
        for layer in self.layers:
            x = (run_layer(layer, remat, gen, x, train=train) if self.pre_ln
                 else run_layer(layer, remat, gen, x, None, train))
        return self.ln_final(x)


VIT_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
            "patch_size", "image_size", "hidden_dropout_prob", "layer_norm_eps", "pre_ln",
            "gradient_checkpointing", "hidden_act")


def make_vit(backbone: str, output_layer=None, dtype=torch.float32, **kwargs) -> ViT:
    """The tower from a config's architecture keys (others are ignored, and
    so is ``output_layer``, as in the JAX package)."""
    return ViT(dtype=dtype, **{k: v for k, v in kwargs.items() if k in VIT_KEYS})
