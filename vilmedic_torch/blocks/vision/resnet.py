"""ResNet family, resnet18 to resnet152 (NCHW), port of
``blocks/vision/resnet.py``.

Architecture as torchvision's ResNets (v1.5: the bottleneck's stride on its
3x3 convolution), truncated at ``output_layer``: ``stem`` (after the max
pool), ``layer1`` to ``layer4`` (feature maps (B, C, h, w)) or ``avgpool``
((B, C)); ``features`` means ``layer4``. Parameter names follow the Flax
tree (``layer2_block0.Conv_1.weight``, ``conv_proj``/``norm_proj`` on the
downsample path), so the weight bridge is a rename plus transposes.

Padding matches Flax's NHWC convolutions: the stem's 7x7 stride-2 conv pads
3 on each side, every other convolution is ``"SAME"``: ``ceil(n / s)``
outputs, the total padding split with the extra pixel at the end. So a 3x3
stride-2 conv over an even input pads (0, 1), not PyTorch's (1, 1). The max
pool pads 1 on each side with -inf, as PyTorch's does. Convolutions hold f32
weights cast to the compute dtype at use; BatchNorm is the DenseNet's
(:class:`~.densenet.BatchNorm`, Flax's momentum 0.9: batch statistics in
training, kept for the trainer to commit, running statistics otherwise).
Each block's last BatchNorm starts with a zero scale, as in the JAX module.

``capture_layer`` (``layer1`` to ``layer4``; GLoRIA's local features take
``layer3``) makes the forward also return that stage's map, as the JAX
module does, in its NHWC layout (B, h, w, C): ``(output, captured)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .densenet import BatchNorm, Conv2d

STAGE_SIZES = {
    "resnet18": ([2, 2, 2, 2], "basic"),
    "resnet34": ([3, 4, 6, 3], "basic"),
    "resnet50": ([3, 4, 6, 3], "bottleneck"),
    "resnet101": ([3, 4, 23, 3], "bottleneck"),
    "resnet152": ([3, 8, 36, 3], "bottleneck"),
}
OUTPUT_LAYERS = ("stem", "layer1", "layer2", "layer3", "layer4", "avgpool")


class SameConv2d(Conv2d):
    """Flax ``nn.Conv(..., padding="SAME", use_bias=False)`` over NCHW."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad order: last dim first
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        dt = self.compute_dtype
        x = x.to(dt)
        if len(set(pads)) == 1:
            padding = pads[0]
        else:
            x, padding = F.pad(x, pads), 0
        return F.conv2d(x, self.weight.to(dt), None, self.stride, padding)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = SameConv2d(c_in, filters, 3, stride, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = SameConv2d(filters, filters, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self._proj(c_in, filters, stride, dtype)

    @property
    def last_norm(self) -> BatchNorm:
        return getattr(self, "BatchNorm_2", self.BatchNorm_1)

    def _proj(self, c_in: int, c_out: int, stride: int, dtype: torch.dtype):
        self.has_proj = c_in != c_out or stride != 1
        if self.has_proj:
            self.conv_proj = SameConv2d(c_in, c_out, 1, stride, dtype)
            self.norm_proj = BatchNorm(c_out, dtype)

    def residual(self, x, train: bool):
        return self.norm_proj(self.conv_proj(x), train) if self.has_proj else x

    def forward(self, x, train: bool = False):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        return F.relu(self.residual(x, train) + y)


class BottleneckBlock(BasicBlock):
    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int, dtype: torch.dtype):
        nn.Module.__init__(self)
        self.Conv_0 = SameConv2d(c_in, filters, 1, 1, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = SameConv2d(filters, filters, 3, stride, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = SameConv2d(filters, 4 * filters, 1, 1, dtype)
        self.BatchNorm_2 = BatchNorm(4 * filters, dtype)
        self._proj(c_in, 4 * filters, stride, dtype)

    def forward(self, x, train: bool = False):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        return F.relu(self.residual(x, train) + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes, kind: str, output_layer: str = "avgpool",
                 dtype: torch.dtype = torch.float32, capture_layer: Optional[str] = None):
        super().__init__()
        if output_layer not in OUTPUT_LAYERS:
            raise ValueError(f"ResNet output_layer {output_layer!r}: one of {OUTPUT_LAYERS}")
        if capture_layer not in (None, "layer1", "layer2", "layer3", "layer4"):
            raise ValueError(f"ResNet capture_layer {capture_layer!r}: layer1 to layer4")
        self.output_layer = output_layer
        self.capture_layer = capture_layer
        block_cls = BasicBlock if kind == "basic" else BottleneckBlock
        self.conv_init = Conv2d(3, 64, 7, 2, dtype)  # Flax's explicit padding 3
        self.bn_init = BatchNorm(64, dtype)
        self.stage_sizes = list(stage_sizes)
        ch = 64
        self.out_channels = 64
        last = (OUTPUT_LAYERS.index(output_layer) if output_layer != "avgpool"
                else len(self.stage_sizes))
        for i, n in enumerate(self.stage_sizes[:last]):
            for j in range(n):
                block = block_cls(ch, 64 * 2 ** i, 2 if i > 0 and j == 0 else 1, dtype)
                self.add_module(f"layer{i + 1}_block{j}", block)
                ch = 64 * 2 ** i * block_cls.expansion
            self.out_channels = ch
            if capture_layer == f"layer{i + 1}":
                self.captured_channels = ch
        self.n_stages = last

    def forward(self, x, train: bool = False):
        """(B, 3, H, W) -> the ``output_layer``'s (B, C, h, w) map, or
        (B, C) for ``avgpool``; with ``capture_layer``, ``(that, the
        captured stage's (B, h, w, C) map)`` (None past the output layer).
        ``train`` normalizes with the batch's statistics."""
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        captured = None
        for i in range(self.n_stages):
            for j in range(self.stage_sizes[i]):
                x = getattr(self, f"layer{i + 1}_block{j}")(x, train)
            if self.capture_layer == f"layer{i + 1}":
                captured = x.permute(0, 2, 3, 1)
        out = x.mean(dim=(2, 3)) if self.output_layer == "avgpool" else x
        return (out, captured) if self.capture_layer else out


def make_resnet(backbone: str, output_layer: str = "avgpool",
                dtype: torch.dtype = torch.float32, capture_layer: Optional[str] = None) -> ResNet:
    sizes, kind = STAGE_SIZES[backbone]
    if output_layer in (None, "features"):
        output_layer = "layer4"
    return ResNet(sizes, kind, output_layer, dtype, capture_layer)


@torch.no_grad()
def zero_last_norm_scales_(module: nn.Module) -> None:
    """Each residual block's last BatchNorm scale to 0 (the JAX module's
    ``scale_init=zeros_init()``)."""
    for m in module.modules():
        if isinstance(m, BasicBlock):
            m.last_norm.weight.zero_()
