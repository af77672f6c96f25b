"""VisionLanguage: a frozen vision tower feeding a prefix-conditioned causal LM
(port of ``models/vision_language.py``).

The image prefix is a learned marker token followed by the tower's patch
tokens (CLS dropped for DINOv2) projected by a 2-layer MLP with the tanh GELU
(flax ``nn.gelu``'s default). Generation runs a one-shot **prefill** of the
prefix through the LM (causal self-attention over ~1.4k tokens at 518² / 14,
which takes the flash kernel), then beam search where every decode step
attends jointly over the beam-shared prefix K/V (batch B, never tiled) and
the per-beam generated cache (the beam-cache kernel with its softmax stats,
``MultiHeadAttention.prefix_decode``).

Training (``forward(..., train=True)``, :meth:`VisionLanguage.apply_train`)
runs the frozen tower under ``torch.no_grad()`` (the JAX ``stop_gradient``),
hidden dropout from an explicit generator where the Flax modules have it, and
the LM's causal self-attention at 1470 tokens through the flash kernels'
forward with LSE and their backward (``ops/flash_attention.py``).

Ported: the teacher-forced forward (logits and loss, with or without
gradient), the bf16 prefix K/V prefill, the kernel-cache decode step with the
blocked LM head, and :func:`make_vl_generate_fn`, the single-device
counterpart of ``vl_evaluation``'s ``generate``. Not ported: the int8 prefix
and generated caches, the fused prefix, greedy decoding, sharded evaluation,
the tokenizer half of ``vl_evaluation`` and gradient checkpointing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks.transformer import (
    Embeddings, FeedForward, LayerNorm, Linear, MultiHeadAttention, TransformerConfig,
    causal_lm_loss, dropout, make_blocked_head_weights, prefix_operands, to_kernel_cache,
)
from ..blocks.vision.dinov2 import DINOV2_KEYS, SwiGLUFFN
from ..blocks.vision.visual_encoder import VisualEncoder, build_visual_encoder
from ..decoding import BeamResult, beam_search, tile_for_beams
from ..ops.attention import make_attention_bias
from ..registry import register
from .base import resolve_block
from .evaluation_nlg import BLOCKED_MIN_VOCAB


class CausalLayer(nn.Module):
    """Post-LN self-attention-only layer, with the prefix decode route."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        eps, dt = config.layer_norm_eps, config.dtype
        self.self_attn = MultiHeadAttention(config, cross=False)
        self.self_ln = LayerNorm(config.hidden_size, eps, dt)
        self.ffn = FeedForward(config)
        self.ffn_ln = LayerNorm(config.hidden_size, eps, dt)

    def forward(self, x, bias=None, causal: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train`` routes the attention as a training step; ``generator``
        draws the hidden-dropout masks (None: no dropout)."""
        attn = self.self_attn(x, bias=bias, causal=causal, train=train)
        x = self.self_ln(x + dropout(attn, self.self_attn.config.hidden_dropout_prob, generator))
        return self.ffn_ln(x + self.ffn(x, generator))

    def decode(self, x, prefix_kv, cache, decode_index: int, ancestry):
        attn = self.self_attn.prefix_decode(x, prefix_kv, cache, decode_index, ancestry)
        x = self.self_ln(x + attn)
        return self.ffn_ln(x + self.ffn(x))


class VisionLanguageModule(nn.Module):
    def __init__(self, config: TransformerConfig, vision: VisualEncoder, num_image_tokens: int,
                 drop_cls_token: bool = False):
        super().__init__()
        self.config = config
        self.vision = vision
        self.num_image_tokens = num_image_tokens  # prefix length, marker included
        self.drop_cls_token = drop_cls_token
        self.embeddings = Embeddings(config)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", CausalLayer(config))
        h, dt = config.hidden_size, config.dtype
        self.lm_head = Linear(h, config.vocab_size, dt)
        self.proj_fc1 = Linear(vision.width, h, dt)
        self.proj_fc2 = Linear(h, h, dt)
        self.image_token_embedding = nn.Parameter(torch.zeros(1, 1, h))

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_hidden_layers)]

    def image_prefix(self, images):
        """(B, P, hidden): the marker token, then the projected patch tokens.
        No gradient reaches the tower (JAX's ``stop_gradient``)."""
        with torch.no_grad():
            feats = self.vision(images)
        if self.drop_cls_token:
            feats = feats[:, 1:]
        proj = self.proj_fc2(F.gelu(self.proj_fc1(feats), approximate="tanh"))
        marker = self.image_token_embedding.to(proj.dtype).expand(proj.shape[0], -1, -1)
        return torch.cat([marker, proj], dim=1)

    def _text_embed(self, input_ids, offset: int, generator=None):
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :] + offset
        return self.embeddings(input_ids, positions, generator)

    def forward(self, images, input_ids, attention_mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced logits over the text positions and the shifted
        causal-LM loss over them. ``train=True`` routes attention as a
        training step; ``generator`` draws the dropout masks (None: none)."""
        prefix = self.image_prefix(images)
        p = prefix.shape[1]
        text = self._text_embed(input_ids, p, generator)
        h = torch.cat([prefix.to(text.dtype), text], dim=1)
        key_mask = torch.cat([torch.ones(h.shape[0], p, dtype=attention_mask.dtype,
                                         device=attention_mask.device), attention_mask], dim=1)
        # a key-padding bias plus the causal flag, so long prefixes take flash
        bias = make_attention_bias(key_mask=key_mask)
        for layer in self.layers:
            h = layer(h, bias=bias, causal=True, train=train, generator=generator)
        logits = self.lm_head(h[:, p:]).float()
        return {"loss": causal_lm_loss(logits, input_ids, attention_mask), "logits": logits}

    def prefill(self, images, max_text_len: int):
        """Run the image prefix through the stack. Returns ``(gen_cache,
        prefix_kv, prefix_len)``: per layer the zeroed (B, max_text_len, H, D)
        generated-token cache and the prefix (K, V) in the compute dtype,
        which stay at batch B as decode-loop invariants."""
        cfg = self.config
        h = self.image_prefix(images).to(cfg.dtype)
        b, p, _ = h.shape
        shape = (b, max_text_len, cfg.num_attention_heads, cfg.head_dim)
        gen_cache, prefix_kv = [], []
        for layer in self.layers:
            # this layer's K/V projections of its prefix input are the prefix
            # segment of the decode-time cache
            prefix_kv.append(layer.self_attn.kv(h))
            h = layer(h, causal=True)
            gen_cache.append({"self_k": torch.zeros(shape, dtype=cfg.dtype, device=h.device),
                              "self_v": torch.zeros(shape, dtype=cfg.dtype, device=h.device)})
        return tuple(gen_cache), tuple(prefix_kv), p

    def decode_step(self, tokens, cache, prefix_kv, index: int, prefix_len: int,
                    blocked_head, ancestry):
        """One token at absolute position ``prefix_len + index`` for every
        beam row; ``cache`` is the kernel-layout generated cache (updated in
        place), ``prefix_kv`` the per-layer ``prefix_operands``,
        ``blocked_head`` the padded head ``(weight (Vp, H) f32, bias (Vp,)
        f32)``. Returns (N, Vp // 128, 128) f32 blocked logits."""
        h = self._text_embed(tokens, prefix_len + index)
        for layer, lc, pkv in zip(self.layers, cache, prefix_kv):
            h = layer.decode(h, pkv, (lc["self_k_tnf"], lc["self_v_tnf"]), index, ancestry)
        w, bias = blocked_head
        # compute-dtype operands, f32 sums (the weight holds compute-dtype values)
        out = h[:, -1].to(self.config.dtype).float() @ w.t() + bias
        return out.reshape(out.shape[0], -1, 128)


def make_vl_generate_fn(model, beam_width: int, max_len: int, bos_id: int, eos_id: int,
                        pad_id: int, length_penalty: float = 1.0, ancestry_group_items: int = 1):
    """``generate(images (B, 3, H, W) float) -> BeamResult`` for one
    VisionLanguage model, on the model's device.

    Prefill; tile only the generated cache for the beams and convert it to
    the kernel layout; pad the LM head once; beam search on the bare blocked
    logits. ``ancestry_group_items`` sets the items per beam-cache mask group;
    any divisor of the batch gives the same sequences."""
    if not beam_width or beam_width < 2:
        raise NotImplementedError("greedy decoding is not ported")
    if model.dec_config.vocab_size < BLOCKED_MIN_VOCAB:
        raise NotImplementedError(
            f"vocab {model.dec_config.vocab_size} < {BLOCKED_MIN_VOCAB}: the unblocked "
            "candidate route is not ported")
    module = model.module

    @torch.inference_mode()
    def generate(images) -> BeamResult:
        cache, prefix_kv, prefix_len = module.prefill(images, max_len)
        prefix_kv = prefix_operands(prefix_kv)
        cache = to_kernel_cache(tile_for_beams(cache, beam_width))
        wb, bb = make_blocked_head_weights(module)
        blocked = (wb.float(), bb)  # upcast once, not every step

        def step_fn(tokens, index, anc):
            return module.decode_step(tokens, cache, prefix_kv, index, prefix_len, blocked, anc)

        return beam_search(step_fn, images.shape[0], beam_width, max_len, bos_id, eos_id,
                           pad_id, images.device, length_penalty=length_penalty,
                           ancestry_group_items=ancestry_group_items)

    return generate


def init_vl_weights_(module: VisionLanguageModule, generator: torch.Generator) -> None:
    """Random weights from ``generator``, drawn on the CPU, at the Flax
    initializers' scales: Linear and Embedding weights N(0, initializer_range)
    (the tower's attention and FFN included); the patch convolution and the
    SwiGLU projections N(0, 1/fan_in) (Flax's lecun_normal, untruncated); the
    CLS token, position table and image marker N(0, 0.02); biases 0;
    LayerNorms and LayerScales at identity."""
    std = module.config.initializer_range

    def normal_(p, s):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator) * s)

    swiglu = {id(lin) for m in module.modules() if isinstance(m, SwiGLUFFN)
              for lin in (m.weights_in, m.weights_out)}
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun = isinstance(m, nn.Conv2d) or id(m) in swiglu
            normal_(m.weight, math.sqrt(1.0 / m.weight[0].numel()) if lecun else std)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, std)
        elif isinstance(m, LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for name, p in module.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf in ("cls_token", "pos_embed", "image_token_embedding"):
            normal_(p, 0.02)
        elif leaf in ("ls1", "ls2"):
            nn.init.ones_(p)


@register("model")
class VisionLanguage:
    """Host-side task model around :class:`VisionLanguageModule`, built from
    a config's ``model:`` block (proto ``VisionLanguage``).

    ``vision_hf_config`` takes the place of the JAX package's HF config
    lookup for ``vision_model_name`` (a DINOv2 architecture dict); with it,
    the prefix drops the tower's CLS token. ``vocab_size`` and the special
    ids take the place of the tokenizer. Weights are random from ``seed``
    unless a state dict is loaded after. The tower is frozen unless the
    config's ``vision`` block says ``freeze: false``: ``frozen_prefixes`` is
    then ``("vision",)`` and its parameters take no gradient."""

    def __init__(self, decoder=None, vision=None, vision_model_name: Optional[str] = None,
                 vision_hf_config=None, dtype="float32", vocab_size: Optional[int] = None,
                 bos_token_id: Optional[int] = None, eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None, device="cpu", seed: int = 0, **kwargs):
        from ..config.config import Config

        compute_dtype = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") else torch.float32
        dec_args, _ = resolve_block(decoder)
        if isinstance(vision, str):
            vision_model_name, vision = vision, None
        vision = vision.to_dict() if isinstance(vision, Config) else dict(vision or {})
        vision_model_name = vision.pop("vision_model_name", vision_model_name)
        drop_cls_token = False
        if vision_model_name:
            if vision_hf_config is None:
                raise NotImplementedError(
                    f"vision_model_name {vision_model_name!r}: resolving an HF config is not "
                    "ported; pass its architecture as vision_hf_config=")
            hf = dict(vision_hf_config)
            if hf.get("model_type") != "dinov2":
                raise ValueError(f"vision_model_name {vision_model_name!r} has model_type "
                                 f"{hf.get('model_type')!r}; only DINOv2 towers are supported")
            vision.setdefault("backbone", "dinov2")
            for key in DINOV2_KEYS:
                if key in hf:
                    vision.setdefault(key, hf[key])
            vision.setdefault("image_size", 518)
            drop_cls_token = True
        ids = dict(vocab_size=vocab_size, bos_token_id=bos_token_id,
                   eos_token_id=eos_token_id, pad_token_id=pad_token_id)
        self.dec_config = TransformerConfig.from_dict(
            dec_args, **{k: v for k, v in ids.items() if v is not None}, dtype=compute_dtype)
        vision.setdefault("backbone", "vit")
        vision.setdefault("permute", "no_permute")
        vision.setdefault("freeze", True)
        self.frozen_prefixes = ("vision",) if vision["freeze"] else ()
        enc = build_visual_encoder(vision, dtype=compute_dtype)
        image_size, patch = vision.get("image_size", 224), vision.get("patch_size", 16)
        # prefix = patches + marker (+ CLS unless the tower's is dropped)
        num_image_tokens = (image_size // patch) ** 2 + (1 if drop_cls_token else 2)
        self.module = VisionLanguageModule(self.dec_config, enc, num_image_tokens, drop_cls_token)
        init_vl_weights_(self.module, torch.Generator().manual_seed(seed))
        self.module.to(device).eval()

    def apply_train(self, batch, generator: Optional[torch.Generator] = None):
        """One training forward over a batch ``{"images", "input_ids",
        "attention_mask"}``: ``{"loss", "logits"}`` with the graph for the
        backward; ``generator`` (on the model's device) draws the dropout
        masks."""
        return self.module(batch["images"], batch["input_ids"], batch["attention_mask"],
                           train=True, generator=generator)

    def __repr__(self):
        return "model: VisionLanguage (frozen DINOv2 + prefix-conditioned causal LM)"
