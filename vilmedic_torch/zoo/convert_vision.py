"""torchvision and HF vision checkpoints -> the port's tower state dicts
(port of ``zoo/convert_vision.py``).

The reference's ``VisualEncoder`` wraps torchvision backbones, and its HF
protos load ``ViTModel`` / ``Dinov2Model`` weights. The port's towers keep
the Flax tree's module names (``zoo/from_jax.py``) and torch's layouts, so
each function here is a rename: convolutions stay OIHW, Linear weights
(out, in), BatchNorm ``weight`` / ``bias`` / ``running_mean`` /
``running_var`` keep their names under the Flax module's. The one change of
values is :func:`interpolate_pos_grid`, DINOv2's position grid resized to
the model's token count with the JAX package's numpy bicubic, which matches
``torch.nn.functional.interpolate(mode="bicubic", align_corners=False)``.

Every function takes torch tensors or numpy arrays and returns f32 tensors
keyed by the tower's own names (``VisualEncoder.model``'s).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..blocks.vision.densenet import CONFIGS as DENSENET_CONFIGS
from ..blocks.vision.resnet import STAGE_SIZES

_BN = ("weight", "bias", "running_mean", "running_var")


def f32(value) -> torch.Tensor:
    """A checkpoint value as a contiguous f32 CPU tensor."""
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
    return t.detach().to("cpu", torch.float32).contiguous()


def _bn(out: Dict, dst: str, sd: Dict, src: str) -> None:
    for leaf in _BN:
        out[f"{dst}.{leaf}"] = f32(sd[f"{src}.{leaf}"])


def convert_densenet(state_dict: Dict, name: str = "densenet169") -> Dict[str, torch.Tensor]:
    """torchvision DenseNet ``features.*`` -> the port's DenseNet tower."""
    sd = state_dict
    _, blocks, _ = DENSENET_CONFIGS[name]
    out = {"conv0.weight": f32(sd["features.conv0.weight"])}
    _bn(out, "norm0", sd, "features.norm0")
    for bi, num_layers in enumerate(blocks):
        for li in range(num_layers):
            src, dst = f"features.denseblock{bi + 1}.denselayer{li + 1}", f"block{bi}_layer{li}"
            _bn(out, f"{dst}.BatchNorm_0", sd, f"{src}.norm1")
            out[f"{dst}.Conv_0.weight"] = f32(sd[f"{src}.conv1.weight"])
            _bn(out, f"{dst}.BatchNorm_1", sd, f"{src}.norm2")
            out[f"{dst}.Conv_1.weight"] = f32(sd[f"{src}.conv2.weight"])
        if bi < len(blocks) - 1:
            src = f"features.transition{bi + 1}"
            _bn(out, f"transition{bi}_norm", sd, f"{src}.norm")
            out[f"transition{bi}_conv.weight"] = f32(sd[f"{src}.conv.weight"])
    _bn(out, "norm_final", sd, "features.norm5")
    return out


def convert_resnet(state_dict: Dict, name: str = "resnet50") -> Dict[str, torch.Tensor]:
    """torchvision ResNet -> the port's ResNet tower."""
    sd = state_dict
    sizes, kind = STAGE_SIZES[name]
    out = {"conv_init.weight": f32(sd["conv1.weight"])}
    _bn(out, "bn_init", sd, "bn1")
    convs = 3 if kind == "bottleneck" else 2
    for si, num_blocks in enumerate(sizes):
        for bi in range(num_blocks):
            src, dst = f"layer{si + 1}.{bi}", f"layer{si + 1}_block{bi}"
            for ci in range(convs):
                out[f"{dst}.Conv_{ci}.weight"] = f32(sd[f"{src}.conv{ci + 1}.weight"])
                _bn(out, f"{dst}.BatchNorm_{ci}", sd, f"{src}.bn{ci + 1}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.conv_proj.weight"] = f32(sd[f"{src}.downsample.0.weight"])
                _bn(out, f"{dst}.norm_proj", sd, f"{src}.downsample.1")
    return out


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of torch's ``interpolate(mode="bicubic",
    align_corners=False)`` along one axis: the cubic convolution kernel with
    A = -0.75, half-pixel centres, border-clamped taps (the JAX package's)."""
    a = -0.75

    def k(t):
        t = abs(t)
        if t <= 1.0:
            return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        if t < 2.0:
            return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
        return 0.0

    w = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for j in range(n_out):
        x = (j + 0.5) * scale - 0.5
        base = int(np.floor(x))
        for tap in range(base - 1, base + 3):
            w[j, min(max(tap, 0), n_in - 1)] += k(x - tap)
    return w.astype(np.float32)


def interpolate_pos_grid(pos, target_tokens: int) -> torch.Tensor:
    """DINOv2 positions (1, 1 + g², D) -> (1, 1 + t², D): the CLS slot as it
    is, the square grid resized bicubically in f32 (the JAX package's
    operations, in its order)."""
    pos = f32(pos).numpy()
    n = pos.shape[1] - 1
    if n + 1 == target_tokens:
        return torch.from_numpy(pos)
    g, t = int(round(n ** 0.5)), int(round((target_tokens - 1) ** 0.5))
    if g * g != n or t * t != target_tokens - 1:
        raise ValueError(f"position grid of {n} patches to {target_tokens} tokens: not square")
    d = pos.shape[-1]
    w = _cubic_weights(g, t)
    grid = np.einsum("og,ghd->ohd", w, pos[0, 1:].reshape(g, g, d))
    grid = np.einsum("og,hgd->hod", w, grid)
    return torch.from_numpy(np.concatenate([pos[:, :1], grid.reshape(1, t * t, d)], axis=1))


def _linear(out: Dict, dst: str, sd: Dict, src: str) -> None:
    out[f"{dst}.weight"] = f32(sd[f"{src}.weight"])
    out[f"{dst}.bias"] = f32(sd[f"{src}.bias"])


def _patch_tower(sd: Dict, pos) -> Dict[str, torch.Tensor]:
    out = {"patch_embed.weight": f32(sd["embeddings.patch_embeddings.projection.weight"]),
           "patch_embed.bias": f32(sd["embeddings.patch_embeddings.projection.bias"]),
           "cls_token": f32(sd["embeddings.cls_token"]), "pos_embed": f32(pos)}
    _linear(out, "ln_final", sd, "layernorm")
    return out


def _attention(out: Dict, dst: str, sd: Dict, src: str) -> None:
    for a, b in (("q", "query"), ("k", "key"), ("v", "value")):
        _linear(out, f"{dst}.self_attn.{a}", sd, f"{src}.attention.attention.{b}")
    _linear(out, f"{dst}.self_attn.o", sd, f"{src}.attention.output.dense")


def convert_hf_dinov2(state_dict: Dict, target_image_size: int = None,
                      target_tokens: int = None) -> Dict[str, torch.Tensor]:
    """HF ``Dinov2Model`` / ``Dinov2Backbone`` -> the port's DINOv2 tower:
    ``norm1`` / ``norm2`` -> ``ln_before`` / ``ln_after``, LayerScale
    ``layer_scale{1,2}.lambda1`` -> ``ls1`` / ``ls2``, ``mlp.fc{1,2}`` (or
    SwiGLU ``weights_in`` / ``weights_out``) under ``ffn``; the position grid
    re-gridded to ``target_tokens`` (or ``target_image_size``'s count); the
    mask token dropped."""
    sd = {k[len("dinov2."):] if k.startswith("dinov2.") else k: v for k, v in state_dict.items()}
    pos = sd["embeddings.position_embeddings"]
    if target_tokens is None and target_image_size is not None:
        patch = sd["embeddings.patch_embeddings.projection.weight"].shape[-1]
        target_tokens = (target_image_size // patch) ** 2 + 1
    out = _patch_tower(sd, interpolate_pos_grid(pos, target_tokens) if target_tokens else pos)
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        src, dst = f"encoder.layer.{i}", f"layer_{i}"
        _linear(out, f"{dst}.ln_before", sd, f"{src}.norm1")
        _attention(out, dst, sd, src)
        out[f"{dst}.ls1"] = f32(sd[f"{src}.layer_scale1.lambda1"])
        _linear(out, f"{dst}.ln_after", sd, f"{src}.norm2")
        ffn = (("fc1", "fc2") if f"{src}.mlp.fc1.weight" in sd
               else ("weights_in", "weights_out"))
        for name in ffn:
            _linear(out, f"{dst}.ffn.{name}", sd, f"{src}.mlp.{name}")
        out[f"{dst}.ls2"] = f32(sd[f"{src}.layer_scale2.lambda1"])
        i += 1
    return out


def convert_hf_vit(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """HF ``ViTModel`` -> the port's pre-LN ViT tower (the pooler dropped)."""
    sd = state_dict
    out = _patch_tower(sd, sd["embeddings.position_embeddings"])
    i = 0
    while f"encoder.layer.{i}.layernorm_before.weight" in sd:
        src, dst = f"encoder.layer.{i}", f"layer_{i}"
        _linear(out, f"{dst}.ln_before", sd, f"{src}.layernorm_before")
        _attention(out, dst, sd, src)
        _linear(out, f"{dst}.ln_after", sd, f"{src}.layernorm_after")
        _linear(out, f"{dst}.ffn.fc1", sd, f"{src}.intermediate.dense")
        _linear(out, f"{dst}.ffn.fc2", sd, f"{src}.output.dense")
        i += 1
    return out
