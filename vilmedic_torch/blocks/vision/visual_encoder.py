"""Vision tower: backbone + permute + projection (port of the 4-D
``encode`` path of ``blocks/vision/visual_encoder.py``).

Backbones (``make_backbone``): ``resnet18`` to ``resnet152`` (``output_layer``
``stem``, ``layer1``-``layer4``, ``features`` = ``layer4``, or ``avgpool``,
the default), the DenseNets (``features``, the default, or ``avgpool``),
DINOv2, and the ViT family (``vit*``, ``deit*``). Images are NCHW.

Permutes of a CNN's output, as the JAX package's NHWC ones: ``batch_first``
flattens the (B, C, h, w) map to (B, h*w, C) tokens with
``flatten(2).transpose(1, 2)`` (the JAX reshape's (h, w) order), and a
single position to (B, C); ``spatial_first`` gives (h*w, B, C);
``no_permute`` returns the map as the JAX package lays it out, (B, h, w, C).
A pooled (B, C) output is returned as it is. A ViT-family tower returns its
(B, 1 + S, D) tokens whatever ``permute`` says, as the JAX package's does.

``freeze`` takes the backbone out of training: its parameters get no
gradient (``requires_grad`` False) and so no optimizer state, the
counterpart of the JAX package's ``stop_gradient`` plus frozen optimizer
prefixes, and a BatchNorm tower keeps normalizing with its running
statistics. In training (``train=True``) an unfrozen CNN normalizes with
batch statistics, an unfrozen ViT routes attention as a training step and
draws its dropout, and ``dropout_out`` drops the backbone's output, masks
from the caller's generator. Training an unfrozen DINOv2 tower, the 5-D
multi-image path and ``slice_encode`` are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..transformer import Linear, dropout
from .densenet import CONFIGS as DENSENET_CONFIGS
from .densenet import make_densenet
from .dinov2 import make_dinov2
from .resnet import STAGE_SIZES, make_resnet
from .vit import make_vit

PERMUTES = ("batch_first", "spatial_first", "no_permute")


def make_backbone(backbone: str, output_layer: Optional[str], dtype=torch.float32,
                  crop: Optional[int] = None, **kwargs):
    """The backbone module and the width of its tokens. ``crop`` (the input
    size) sizes a ViT's position table where ``kwargs`` give no
    ``image_size``."""
    name = backbone.lower()
    if name in STAGE_SIZES:
        model = make_resnet(name, output_layer or "avgpool", dtype=dtype)
        return model, model.out_channels
    if name in DENSENET_CONFIGS:
        unknown = sorted(set(kwargs) - {"packed_growth"})
        if unknown:
            raise NotImplementedError(f"DenseNet options {unknown} are not ported")
        model = make_densenet(name, output_layer, dtype=dtype, **kwargs)
        return model, model.out_channels
    if "dinov2" in name:
        model = make_dinov2(name, output_layer, dtype=dtype, **kwargs)
        return model, model.config.hidden_size
    if "vit" in name or "deit" in name:
        if crop is not None:
            kwargs.setdefault("image_size", crop)
        model = make_vit(name, output_layer, dtype=dtype, **kwargs)
        return model, model.config.hidden_size
    raise NotImplementedError(f"vision backbone {backbone!r} is not ported")


class VisualEncoder(nn.Module):
    def __init__(self, backbone: str, output_layer: Optional[str] = None,
                 projection_dim: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 permute: str = "batch_first", freeze: bool = False, dropout_out: float = 0.0,
                 crop: Optional[int] = None, **backbone_kwargs):
        super().__init__()
        if permute not in PERMUTES:
            raise ValueError(f"permute {permute!r}: one of {PERMUTES}")
        self.backbone = backbone.lower()
        self.is_vit = any(k in self.backbone for k in ("dinov2", "vit", "deit"))
        self.model, self.width = make_backbone(backbone, output_layer, dtype, crop,
                                               **backbone_kwargs)
        self.permute = permute
        self.freeze = freeze
        self.dropout_out = float(dropout_out)
        if freeze:
            self.model.requires_grad_(False)
        self.visual_projection = None
        if projection_dim is not None:
            self.visual_projection = Linear(self.width, projection_dim, dtype)

    def forward(self, images, train: bool = False, generator=None):
        """Backbone forward and permute (module doc). ``train`` (ignored when
        frozen): batch statistics or the ViT's training route and dropout,
        and ``dropout_out``, with masks from ``generator``."""
        train = train and not self.freeze
        if self.is_vit:
            if "dinov2" in self.backbone:
                if train:
                    raise NotImplementedError("training an unfrozen DINOv2 tower is not ported")
                out = self.model(images)
            else:
                out = self.model(images, train, generator)
            return dropout(out, self.dropout_out, generator) if train else out
        out = self.model(images, train)
        if train:
            out = dropout(out, self.dropout_out, generator)
        if out.ndim == 2:
            return out
        if self.permute == "no_permute":
            return out.permute(0, 2, 3, 1)
        tokens = out.flatten(2).transpose(1, 2)
        if self.permute == "spatial_first":
            return tokens.transpose(0, 1)
        return tokens.squeeze(1) if tokens.shape[1] == 1 else tokens

    def encode(self, images, images_mask=None, train: bool = False, generator=None):
        """(features, features_mask) from (B, 3, H, W) images: for
        generation, or for a training forward with ``train``. The mask is
        that of the pre-projection features."""
        if images.ndim != 4:
            raise NotImplementedError("only 4-D (single-image) batches are ported")
        features = self(images, train, generator)
        features_mask = features.abs().sum(dim=-1) != 0
        if self.visual_projection is not None:
            features = self.visual_projection(features)
        return features, features_mask


def build_visual_encoder(cfg, dtype=torch.float32, crop: Optional[int] = None) -> VisualEncoder:
    """Build from a reference-style ``cnn:`` config block (backbone,
    output_layer, permute, visual_projection, freeze, dropout_out, and the
    backbone's own keys). ``crop`` (the loader's) sizes a ViT's position
    table when the block has no ``image_size``."""
    from ...config.config import Config

    if isinstance(cfg, Config):
        cfg = cfg.to_dict()
    cfg = dict(cfg)
    if cfg.pop("slice_encode", None):
        raise NotImplementedError("slice_encode is not ported")
    for key in ("proto", "pretrained", "slice_dim"):
        cfg.pop(key, None)
    vp = cfg.pop("visual_projection", None)
    projection_dim = vp.get("out_features") if isinstance(vp, dict) else None
    backbone, output_layer = cfg.pop("backbone"), cfg.pop("output_layer", None)
    return VisualEncoder(backbone, output_layer, projection_dim, dtype=dtype,
                         permute=cfg.pop("permute", "batch_first") or "batch_first",
                         freeze=bool(cfg.pop("freeze", False)),
                         dropout_out=cfg.pop("dropout_out", 0.0) or 0.0,
                         crop=crop, **cfg)
