"""DenseNet, 2-D (NCHW) and 3-D (NCDHW), port of ``blocks/vision/densenet.py``.

Architecture as torchvision's densenets (``densenet121`` ...) and, with
``spatial_dims=3`` (``3d_densenet121`` ...), MONAI's 3-D variants: the same
layers with cubic kernels, ``max_pool3d`` (3, stride 2, padding 1) after the
stem and ``avg_pool3d`` (2, stride 2) in the transitions. ``output_layer``
``features`` (the default) is the final BatchNorm with no ReLU,
(B, C, h, w) or (B, C, d, h, w); anything else is ``avgpool``, ReLU then
the mean over the spatial axes, (B, C). The stem's input channels are an
explicit argument (``in_channels``, 3 for RGB images): the Flax module
infers them from its first batch, the port takes them from the weights it
loads or from the data. Convolutions are ``torch.nn.functional.conv2d`` /
``conv3d`` (XLA ran them outside any Pallas kernel) over f32 weights cast
to the compute dtype at use, as Flax's ``param_dtype=float32`` with
``dtype=``, so that an optimizer's small updates are not rounded away in
bf16.

BatchNorm follows Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``. In
eval (``train=False``) it normalizes with the running statistics, in f32
with f32 parameters, output cast to the compute dtype. In training it
normalizes with the batch's statistics and keeps them (mean and the
**biased** variance, f32) as ``pending_stats``: the trainer folds them into
the running statistics (``0.9 * old + 0.1 * batch``) with
:func:`commit_batch_stats` only when the step's loss is finite, as the JAX
trainer gates its updated ``batch_stats``. Parameter names follow the Flax
tree (``block0_layer0.BatchNorm_0.running_mean``). The JAX module's
``packed_growth`` option computes the same 3x3 convolution in a layout made
for the TPU's matrix unit (2-D only); it is accepted and changes nothing
here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import all_reduce_sum, in_global_batch, process_count

CONFIGS = {
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
    "densenet264": (32, (6, 12, 64, 48), 64),
}


class BatchNorm(nn.Module):
    """BatchNorm over the channels of NCHW or NCDHW: ``(x - mean) *
    (rsqrt(var + eps) * weight) + bias`` in f32, output in ``out_dtype``;
    running statistics in eval, the batch's in training (module doc)."""

    momentum = 0.9  # Flax's: new running = momentum * old + (1 - momentum) * batch

    def __init__(self, channels: int, out_dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.pending_stats = None  # (mean, biased var) of the last training forward

    def forward(self, x, train: bool = False):
        if train:
            return self._train_forward(x)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(self.out_dtype)

    def _train_forward(self, x):
        """Normalize by the batch's statistics, gradients flowing through
        them, in f32 arithmetic. ``F.batch_norm`` writes the batch mean and
        the unbiased variance into scratch buffers at momentum 1; the biased
        variance Flax keeps is that times (n - 1) / n. In a training forward
        of several processes the statistics are the global batch's
        (:meth:`_global_forward`)."""
        if in_global_batch() and process_count() > 1:
            return self._global_forward(x)
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, training=True, momentum=1.0,
                         eps=self.eps)
        self.pending_stats = (mean, var * ((n - 1) / n))
        return y.to(self.out_dtype)

    def _global_forward(self, x):
        """The moments of every process's rows, as Flax takes them over the
        JAX package's global batch: the per-channel sums of x and x² and the
        row counts summed over the processes (differentiably, so each
        process's rows get the gradient through the others' losses), then
        ``var = max(0, E[x²] - E[x]²)`` (Flax's fast variance), in f32."""
        dims = [0] + list(range(2, x.ndim))
        xf = x.float()
        c = x.shape[1]
        sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims)]))
        n = torch.tensor(float(x.numel() // c), device=x.device)
        torch.distributed.all_reduce(n)
        mean, mean2 = sums[:c] / n, sums[c:] / n
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        self.pending_stats = (mean.detach(), var.detach())
        return y.to(self.out_dtype)


@torch.no_grad()
def commit_batch_stats(module: nn.Module, good) -> None:
    """Fold every BatchNorm's ``pending_stats`` into its running statistics
    where ``good`` holds (a bool, or a bool tensor on the module's device,
    read there: no host sync), and clear them. Flax's update,
    ``momentum * old + (1 - momentum) * batch``, in f32."""
    for m in module.modules():
        if isinstance(m, BatchNorm) and m.pending_stats is not None:
            for buf, new in zip((m.running_mean, m.running_var), m.pending_stats):
                upd = m.momentum * buf + (1 - m.momentum) * new
                buf.copy_(torch.where(torch.as_tensor(good, device=buf.device), upd, buf))
            m.pending_stats = None


class Conv2d(nn.Conv2d):
    """Flax ``nn.Conv(use_bias=False, dtype=..., param_dtype=float32)``: an
    f32 weight; input and weight cast to the compute dtype at use; padding
    ``k // 2``."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, dtype: torch.dtype):
        super().__init__(c_in, c_out, k, stride=stride, padding=k // 2, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)


class Conv3d(nn.Conv3d):
    """:class:`Conv2d` with cubic kernels, over NCDHW."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, dtype: torch.dtype):
        super().__init__(c_in, c_out, k, stride=stride, padding=k // 2, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv3d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)


class DenseLayer(nn.Module):
    def __init__(self, c_in: int, growth_rate: int, dtype: torch.dtype, conv=Conv2d):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(c_in, dtype)
        self.Conv_0 = conv(c_in, 4 * growth_rate, 1, 1, dtype)
        self.BatchNorm_1 = BatchNorm(4 * growth_rate, dtype)
        self.Conv_1 = conv(4 * growth_rate, growth_rate, 3, 1, dtype)

    def forward(self, x, train: bool = False):
        y = self.Conv_0(F.relu(self.BatchNorm_0(x, train)))
        y = self.Conv_1(F.relu(self.BatchNorm_1(y, train)))
        return torch.cat([x, y], dim=1)


class DenseNet(nn.Module):
    def __init__(self, growth_rate: int, block_config: Sequence[int], num_init_features: int,
                 dtype: torch.dtype = torch.float32, output_layer: str = "features",
                 spatial_dims: int = 2, in_channels: int = 3):
        super().__init__()
        conv = Conv2d if spatial_dims == 2 else Conv3d
        self.dtype = dtype
        self.output_layer = output_layer
        self.spatial_dims = spatial_dims
        self.block_config = tuple(block_config)
        self.conv0 = conv(in_channels, num_init_features, 7, 2, dtype)
        self.norm0 = BatchNorm(num_init_features, dtype)
        ch = num_init_features
        for i, num_layers in enumerate(self.block_config):
            for j in range(num_layers):
                self.add_module(f"block{i}_layer{j}", DenseLayer(ch, growth_rate, dtype, conv))
                ch += growth_rate
            if i < len(self.block_config) - 1:
                self.add_module(f"transition{i}_norm", BatchNorm(ch, dtype))
                self.add_module(f"transition{i}_conv", conv(ch, ch // 2, 1, 1, dtype))
                ch //= 2
        self.norm_final = BatchNorm(ch, dtype)
        self.out_channels = ch

    def forward(self, x, train: bool = False):
        """(B, in_channels, H, W) -> (B, C, h, w) features (3-D: (B,
        in_channels, D, H, W) -> (B, C, d, h, w)), or (B, C) for
        ``avgpool``; ``train`` normalizes with the batch's statistics."""
        max_pool, avg_pool = ((F.max_pool2d, F.avg_pool2d) if self.spatial_dims == 2
                              else (F.max_pool3d, F.avg_pool3d))
        x = F.relu(self.norm0(self.conv0(x), train))
        x = max_pool(x, 3, stride=2, padding=1)
        for i, num_layers in enumerate(self.block_config):
            for j in range(num_layers):
                x = getattr(self, f"block{i}_layer{j}")(x, train)
            if i < len(self.block_config) - 1:
                x = F.relu(getattr(self, f"transition{i}_norm")(x, train))
                x = getattr(self, f"transition{i}_conv")(x)
                x = avg_pool(x, 2, stride=2)
        x = self.norm_final(x, train)
        if self.output_layer == "features":
            return x
        return F.relu(x).mean(dim=tuple(range(2, x.ndim)))


def make_densenet(backbone: str, output_layer=None, dtype: torch.dtype = torch.float32,
                  packed_growth=None, in_channels: int = 3) -> DenseNet:
    """``densenet121`` ... (2-D) or ``3d_densenet121`` ... (3-D) with a stem
    over ``in_channels``."""
    spatial_dims = 3 if backbone.startswith("3d_") else 2
    growth, blocks, init = CONFIGS[backbone.replace("3d_", "", 1)]
    return DenseNet(growth, blocks, init, dtype, output_layer or "features", spatial_dims,
                    in_channels)
