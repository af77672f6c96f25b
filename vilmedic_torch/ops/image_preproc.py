"""On-device uint8 crop + ImageNet normalize (port of ``ops/image_preproc.py``).

The host ships the uint8 batch (4x fewer bytes than f32); the device crops at
per-image offsets, scales by 1/255 and normalizes per channel in one pass.
:func:`crop_normalize` launches the CUDA kernel ``csrc/image_preproc.cu`` for
CUDA tensors and runs :func:`crop_normalize_reference`, the same math in plain
PyTorch, for CPU tensors.

Every output is ``(v / 255 - mean_c) / std_c`` of one byte v and channel
c, so the kernel computes that once per (channel, byte) into a table, with
the IEEE ops the plain version runs on the card, and looks every value up:
it matches the plain version to the bit.

Layout: input (B, R, R, 3) uint8 as the host collates it; output NCHW
(B, 3, crop, crop) f32, what ``conv2d`` reads. (The JAX op returns NHWC.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.image import IMAGENET_MEAN, IMAGENET_STD
from . import cuda_lib


def _check(images_u8: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor, crop: int):
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"crop_normalize: expects (B, R, R, 3) uint8, got "
                         f"{tuple(images_u8.shape)} {images_u8.dtype}")
    b, r, r2, _ = images_u8.shape
    if r != r2 or not 0 < crop <= r:
        raise ValueError(f"crop_normalize: crop {crop} of a {r}x{r2} image")
    if tops.shape != (b,) or lefts.shape != (b,):
        raise ValueError("crop_normalize: tops/lefts must be (B,)")


def crop_normalize_reference(images_u8, tops, lefts, crop: int,
                             mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Plain PyTorch version: (B, R, R, 3) u8 -> (B, 3, crop, crop) f32.

    Offsets are placed as ``jax.lax.dynamic_slice`` places them: a negative
    offset counts from the end, then the window is clamped into the image."""
    _check(images_u8, tops, lefts, crop)
    b, r = images_u8.shape[:2]
    ar = torch.arange(crop, device=images_u8.device)

    def place(off):
        off = off.long()
        return torch.where(off < 0, off + r, off).clamp(0, r - crop)[:, None] + ar

    t, left = place(tops), place(lefts)  # (B, crop) each
    block = images_u8[torch.arange(b, device=images_u8.device)[:, None, None],
                      t[:, :, None], left[:, None, :]]  # (B, crop, crop, 3)
    x = block.to(torch.float32) / 255.0
    m = torch.as_tensor(np.asarray(mean, np.float32), device=x.device)
    s = torch.as_tensor(np.asarray(std, np.float32), device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous()


def crop_normalize(images_u8: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                   crop: int, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """(B, R, R, 3) u8 -> (B, 3, crop, crop) f32 normalized.

    CPU tensors take :func:`crop_normalize_reference`; CUDA tensors launch the
    kernel (int32 offsets, contiguous input) or raise."""
    if images_u8.device.type == "cpu":
        return crop_normalize_reference(images_u8, tops, lefts, crop, mean, std)
    _check(images_u8, tops, lefts, crop)
    dev = cuda_lib.require_cuda("crop_normalize", images_u8, tops, lefts)
    if tops.dtype != torch.int32 or lefts.dtype != torch.int32:
        raise ValueError("crop_normalize: tops/lefts must be int32 on CUDA")
    b, r = images_u8.shape[:2]
    m = [float(v) for v in np.asarray(mean, np.float32)]
    s = [float(v) for v in np.asarray(std, np.float32)]
    out = torch.empty((b, 3, crop, crop), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = cuda_lib.lib().vt_crop_normalize(
            images_u8.data_ptr(), tops.data_ptr(), lefts.data_ptr(), out.data_ptr(),
            b, r, crop, *m, *s, cuda_lib.stream_of(out),
        )
    cuda_lib.check(status, "crop_normalize")
    crop_normalize.launches += 1
    return out


crop_normalize.launches = 0
