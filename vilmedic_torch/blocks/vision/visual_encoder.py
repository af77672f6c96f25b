"""Vision tower: backbone + permute + projection, and the multi-image and
volume paths of ``encode`` (port of ``blocks/vision/visual_encoder.py``).

Backbones (``make_backbone``): ``resnet18`` to ``resnet152`` (``output_layer``
``stem``, ``layer1``-``layer4``, ``features`` = ``layer4``, or ``avgpool``,
the default), the DenseNets (``features``, the default, or ``avgpool``) and
their 3-D variants ``3d_densenet121`` ... over volumes, DINOv2 (its
``output_layer`` accepted and ignored, as in the JAX package), and the ViT
family (``vit*``, ``deit*``). Images are NCHW, volumes NCDHW; a DenseNet's
stem takes ``in_channels`` channels (3 unless the caller names another).

Permutes of a CNN's output, as the JAX package's channel-last ones:
``batch_first`` flattens the (B, C, *spatial) map to (B, S, C) tokens with
``flatten(2).transpose(1, 2)`` (the JAX reshape's (d, h, w) order), and a
single position to (B, C); ``spatial_first`` gives (S, B, C);
``no_permute`` returns the map as the JAX package lays it out, channels
last. A pooled (B, C) output is returned as it is. A ViT-family tower
returns its (B, 1 + S, D) tokens whatever ``permute`` says, as the JAX
package's does.

``encode`` takes four kinds of batch:

- (B, C, H, W) images: the tower's tokens;
- (B, N, C, H, W) with a 2-D backbone, the multi-image batch of the data's
  ``multi_image``: the B·N images go through the tower as one batch, the
  features of the images that ``images_mask`` (B, N) marks as padding are
  zeroed, and each sample's N token sequences are concatenated into one
  (B, N·S, C) memory; a pooled tower (ndim <= 2) raises, as in JAX;
- (B, C, D, H, W) with a ``3d_*`` backbone: the whole volume;
- (B, C, D, H, W) with ``slice_encode``: a 2-D backbone over each slice,
  stacked to (B, n_slices, ...). ``slice_dim`` counts the axes as the JAX
  package lays a volume out, (B, D, H, W, C): 1 (the default) slices along
  D, 2 along H, 3 along W, so a config selects the same slices in both
  packages; here that is axis ``slice_dim + 1`` of (B, C, D, H, W).

The mask is that of the pre-projection features (``|f|.sum(-1) != 0``),
then the projection applies.

``freeze`` takes the backbone out of training: its parameters get no
gradient (``requires_grad`` False) and so no optimizer state, the
counterpart of the JAX package's ``stop_gradient`` plus frozen optimizer
prefixes, and a BatchNorm tower keeps normalizing with its running
statistics. In training (``train=True``) an unfrozen CNN normalizes with
batch statistics, an unfrozen ViT or DINOv2 routes attention as a training
step and draws its dropout, and ``dropout_out`` drops the backbone's output,
masks from the caller's generator.
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


def is_densenet(name: str) -> bool:
    return name.lower().replace("3d_", "", 1) in DENSENET_CONFIGS


def make_backbone(backbone: str, output_layer: Optional[str], dtype=torch.float32,
                  crop: Optional[int] = None, in_channels: Optional[int] = None, **kwargs):
    """The backbone module and the width of its tokens. ``crop`` (the input
    size) sizes a ViT's position table where ``kwargs`` give no
    ``image_size``; ``in_channels`` sets a DenseNet's stem (3 when None; a
    3-D DenseNet needs it named). The other towers take RGB images."""
    name = backbone.lower()
    if in_channels not in (None, 3) and not is_densenet(name):
        raise NotImplementedError(f"a {in_channels}-channel stem for {backbone!r} is not ported")
    if name in STAGE_SIZES:
        model = make_resnet(name, output_layer or "avgpool", dtype=dtype)
        return model, model.out_channels
    if is_densenet(name):
        unknown = sorted(set(kwargs) - {"packed_growth"})
        if unknown:
            raise NotImplementedError(f"DenseNet options {unknown} are not ported")
        if name.startswith("3d_") and in_channels is None:
            raise ValueError(f"{backbone}: name the stem's in_channels (the volumes' channels)")
        model = make_densenet(name, output_layer, dtype=dtype, in_channels=in_channels or 3,
                              **kwargs)
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
                 crop: Optional[int] = None, slice_encode: bool = False,
                 slice_dim: Optional[int] = None, in_channels: Optional[int] = None,
                 **backbone_kwargs):
        super().__init__()
        if permute not in PERMUTES:
            raise ValueError(f"permute {permute!r}: one of {PERMUTES}")
        self.backbone = backbone.lower()
        self.is_vit = any(k in self.backbone for k in ("dinov2", "vit", "deit"))
        self.is_3d = "3d" in self.backbone
        self.slice_encode = bool(slice_encode)
        self.slice_dim = 1 if slice_dim is None else int(slice_dim)
        if self.slice_encode and self.slice_dim not in (1, 2, 3):
            raise ValueError(f"slice_dim {slice_dim}: 1, 2 or 3, a spatial axis of the JAX "
                             "package's (B, D, H, W, C) volume")
        self.model, self.width = make_backbone(backbone, output_layer, dtype, crop,
                                               in_channels, **backbone_kwargs)
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
            out = self.model(images, train, generator)
            return dropout(out, self.dropout_out, generator) if train else out
        out = self.model(images, train)
        if train:
            out = dropout(out, self.dropout_out, generator)
        if out.ndim == 2:
            return out
        if self.permute == "no_permute":
            return out.movedim(1, -1)
        tokens = out.flatten(2).transpose(1, 2)
        if self.permute == "spatial_first":
            return tokens.transpose(0, 1)
        return tokens.squeeze(1) if tokens.shape[1] == 1 else tokens

    def encode(self, images, images_mask=None, train: bool = False, generator=None):
        """(features, features_mask) from a batch of images, multi-image
        samples or volumes (module doc): for generation, or for a training
        forward with ``train``. The mask is that of the pre-projection
        features."""
        if images.ndim == 4 or (images.ndim == 5 and self.is_3d and not self.slice_encode):
            features = self(images, train, generator)
        elif images.ndim != 5:
            raise ValueError(f"images of shape {tuple(images.shape)}: 4-D or 5-D")
        elif self.slice_encode:
            axis = self.slice_dim + 1
            features = torch.stack([self(images.select(axis, i), train, generator)
                                    for i in range(images.shape[axis])], dim=1)
        else:
            b, n = images.shape[:2]
            features = self(images.reshape(b * n, *images.shape[2:]), train, generator)
            if features.ndim <= 2:
                raise ValueError(
                    "The input size is too small for this model: spatial dim shrunk to 1.")
            s, c = features.shape[-2], features.shape[-1]
            features = features.reshape(b, n, s, c)
            if images_mask is not None:
                features = features * images_mask[:, :, None, None].to(features.dtype)
            features = features.reshape(b, n * s, c)
        features_mask = features.abs().sum(dim=-1) != 0
        if self.visual_projection is not None:
            features = self.visual_projection(features)
        return features, features_mask


def build_visual_encoder(cfg, dtype=torch.float32, crop: Optional[int] = None,
                         in_channels: Optional[int] = None) -> VisualEncoder:
    """Build from a reference-style ``cnn:`` config block (backbone,
    output_layer, permute, visual_projection, freeze, dropout_out,
    slice_encode, slice_dim, and the backbone's own keys). ``crop`` (the
    loader's) sizes a ViT's position table when the block has no
    ``image_size``; ``in_channels`` (the data's) sets a DenseNet's stem."""
    from ...config.config import Config

    if isinstance(cfg, Config):
        cfg = cfg.to_dict()
    cfg = dict(cfg)
    for key in ("proto", "pretrained"):
        cfg.pop(key, None)
    vp = cfg.pop("visual_projection", None)
    projection_dim = vp.get("out_features") if isinstance(vp, dict) else None
    backbone, output_layer = cfg.pop("backbone"), cfg.pop("output_layer", None)
    return VisualEncoder(backbone, output_layer, projection_dim, dtype=dtype,
                         permute=cfg.pop("permute", "batch_first") or "batch_first",
                         freeze=bool(cfg.pop("freeze", False)),
                         dropout_out=cfg.pop("dropout_out", 0.0) or 0.0,
                         crop=crop, slice_encode=bool(cfg.pop("slice_encode", False)),
                         slice_dim=cfg.pop("slice_dim", None), in_channels=in_channels, **cfg)
