"""Vision tower: backbone + token flatten + projection (port of the 4-D
``encode`` path of ``blocks/vision/visual_encoder.py``).

Images are NCHW. Flattening (B, C, h, w) with ``flatten(2).transpose(1, 2)``
gives the same (h, w) token order as the JAX NHWC reshape (``batch_first``).
The feature mask comes from the pre-projection features. ``freeze`` takes the
backbone out of training: its parameters get no gradient (``requires_grad``
False) and so no optimizer state, the counterpart of the JAX package's
``stop_gradient`` plus frozen optimizer prefixes, and it keeps normalizing
with its running statistics. In training (``encode(..., train=True)``) an
unfrozen DenseNet normalizes with batch statistics, and ``dropout_out``
drops backbone outputs with masks from the caller's generator. Two towers: DenseNet
with its ``features`` output (``batch_first``), and DINOv2, whose
(B, 1 + S, D) tokens are returned as they are (as the JAX package returns
its ViT-family towers, whatever ``permute`` says; the VisionLanguage config
sets ``no_permute``). The other backbones and outputs, the ``spatial_first``
permute, the 5-D multi-image path and ``slice_encode`` are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..transformer import Linear, dropout
from .densenet import CONFIGS as DENSENET_CONFIGS
from .densenet import make_densenet
from .dinov2 import make_dinov2


class VisualEncoder(nn.Module):
    def __init__(self, backbone: str, output_layer: Optional[str] = None,
                 projection_dim: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 permute: str = "batch_first", freeze: bool = False, dropout_out: float = 0.0,
                 **backbone_kwargs):
        super().__init__()
        name = backbone.lower()
        self.is_vit = "dinov2" in name
        if self.is_vit:
            self.model = make_dinov2(name, output_layer, dtype=dtype, **backbone_kwargs)
            width = self.model.config.hidden_size
        elif name in DENSENET_CONFIGS:
            if output_layer not in (None, "features"):
                raise NotImplementedError(f"output_layer {output_layer!r} is not ported")
            if permute != "batch_first":
                raise NotImplementedError(f"permute {permute!r} is not ported for DenseNet")
            if backbone_kwargs:
                raise NotImplementedError(f"cnn options {sorted(backbone_kwargs)} are not ported")
            self.model = make_densenet(name, dtype=dtype)
            width = self.model.out_channels
        else:
            raise NotImplementedError(f"vision backbone {backbone!r} is not ported")
        self.width = width  # of the backbone's tokens, before any projection
        self.freeze = freeze
        self.dropout_out = float(dropout_out)
        if freeze:
            self.model.requires_grad_(False)
        self.visual_projection = None
        if projection_dim is not None:
            self.visual_projection = Linear(width, projection_dim, dtype)

    def forward(self, images, train: bool = False, generator=None):
        """Backbone forward. DINOv2: its (B, 1 + S, D) tokens as they are.
        DenseNet: ``batch_first`` flatten to (B, h*w, C) tokens, or (B, C)
        when the feature map is a single position. ``train`` (ignored when
        frozen): DenseNet's batch statistics, and ``dropout_out`` with masks
        from ``generator``."""
        train = train and not self.freeze
        if self.is_vit:
            if train:
                raise NotImplementedError("training an unfrozen ViT-family tower is not ported")
            return self.model(images)
        out = self.model(images, train)
        if train:
            out = dropout(out, self.dropout_out, generator)
        tokens = out.flatten(2).transpose(1, 2)
        return tokens.squeeze(1) if tokens.shape[1] == 1 else tokens

    def encode(self, images, images_mask=None, train: bool = False, generator=None):
        """(features, features_mask) from (B, 3, H, W) images: for
        generation, or for a training forward with ``train``."""
        if images.ndim != 4:
            raise NotImplementedError("only 4-D (single-image) batches are ported")
        features = self(images, train, generator)
        features_mask = features.abs().sum(dim=-1) != 0
        if self.visual_projection is not None:
            features = self.visual_projection(features)
        return features, features_mask


def build_visual_encoder(cfg, dtype=torch.float32) -> VisualEncoder:
    """Build from a reference-style ``cnn:`` config block (backbone,
    output_layer, permute, visual_projection, freeze, dropout_out, and a
    ViT-family tower's architecture keys)."""
    from ...config.config import Config

    if isinstance(cfg, Config):
        cfg = cfg.to_dict()
    cfg = dict(cfg)
    for key in ("proto", "pretrained"):
        cfg.pop(key, None)
    permute = cfg.pop("permute", "batch_first")
    if permute not in ("batch_first", "no_permute"):
        raise NotImplementedError(f"permute {permute!r} is not ported")
    vp = cfg.pop("visual_projection", None)
    projection_dim = vp.get("out_features") if isinstance(vp, dict) else None
    backbone, output_layer = cfg.pop("backbone"), cfg.pop("output_layer", None)
    return VisualEncoder(backbone, output_layer, projection_dim, dtype=dtype, permute=permute,
                         freeze=bool(cfg.pop("freeze", False)),
                         dropout_out=cfg.pop("dropout_out", 0.0) or 0.0, **cfg)
