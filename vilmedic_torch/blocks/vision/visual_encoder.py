"""Vision tower: backbone + token flatten + projection (port of the 4-D
``encode`` path of ``blocks/vision/visual_encoder.py``).

Images are NCHW. Flattening (B, C, h, w) with ``flatten(2).transpose(1, 2)``
gives the same (h, w) token order as the JAX NHWC reshape (``batch_first``).
The feature mask comes from the pre-projection features. Two towers: DenseNet
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

from .densenet import CONFIGS as DENSENET_CONFIGS
from .densenet import make_densenet
from .dinov2 import make_dinov2


class VisualEncoder(nn.Module):
    def __init__(self, backbone: str, output_layer: Optional[str] = None,
                 projection_dim: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 permute: str = "batch_first", **backbone_kwargs):
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
        self.visual_projection = None
        if projection_dim is not None:
            self.visual_projection = nn.Linear(width, projection_dim, dtype=dtype)

    def forward(self, images):
        """Backbone forward. DINOv2: its (B, 1 + S, D) tokens as they are.
        DenseNet: ``batch_first`` flatten to (B, h*w, C) tokens, or (B, C)
        when the feature map is a single position."""
        if self.is_vit:
            return self.model(images)
        tokens = self.model(images).flatten(2).transpose(1, 2)
        return tokens.squeeze(1) if tokens.shape[1] == 1 else tokens

    def encode(self, images, images_mask=None):
        """(features, features_mask) for generation, from (B, 3, H, W) images."""
        if images.ndim != 4:
            raise NotImplementedError("only 4-D (single-image) batches are ported")
        features = self(images)
        features_mask = features.abs().sum(dim=-1) != 0
        if self.visual_projection is not None:
            features = self.visual_projection(features)
        return features, features_mask


def build_visual_encoder(cfg, dtype=torch.float32) -> VisualEncoder:
    """Build from a reference-style ``cnn:`` config block (backbone,
    output_layer, permute, visual_projection, and a ViT-family tower's
    architecture keys; dropout_out and freeze act only in training, which is
    not ported, and are ignored)."""
    from ...config.config import Config

    if isinstance(cfg, Config):
        cfg = cfg.to_dict()
    cfg = dict(cfg)
    for key in ("proto", "pretrained", "dropout_out", "freeze"):
        cfg.pop(key, None)
    permute = cfg.pop("permute", "batch_first")
    if permute not in ("batch_first", "no_permute"):
        raise NotImplementedError(f"permute {permute!r} is not ported")
    vp = cfg.pop("visual_projection", None)
    projection_dim = vp.get("out_features") if isinstance(vp, dict) else None
    backbone, output_layer = cfg.pop("backbone"), cfg.pop("output_layer", None)
    return VisualEncoder(backbone, output_layer, projection_dim, dtype=dtype, permute=permute,
                         **cfg)
