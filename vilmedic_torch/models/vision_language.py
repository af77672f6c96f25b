"""VisionLanguage: a vision tower feeding a prefix-conditioned causal LM
(port of ``models/vision_language.py``).

The image prefix is a learned marker token followed by the tower's patch
tokens (CLS dropped for DINOv2) projected by a 2-layer MLP with the tanh GELU
(flax ``nn.gelu``'s default). Generation runs a one-shot **prefill** of the
prefix through the LM (causal self-attention over ~1.4k tokens at 518² / 14,
which takes the flash kernel), then beam search where every decode step
attends jointly over the beam-shared prefix K/V (batch B, never tiled) and
the per-beam generated cache (``MultiHeadAttention.prefix_decode``): the
beam-cache kernel with its softmax stats merged with the prefix products, or
with ``fused_prefix`` the kernel's stage (d) streaming the prefix itself.
The eval keys ``prefix_kv_dtype: int8`` and ``gen_kv_dtype: int8`` store the
prefix K/V as int8 with per-(token, head) scales and the generated cache as
int8 with per-lane scales derived from the prefix (the kernel's stage (c)).
A decoder whose head dim the beam-cache kernel is not built for takes the
permute route instead, as the JAX package falls back when its kernel cannot
run: a plain (N, T, H, D) generated cache that beam search reorders every
step, attended in plain PyTorch (the int8 prefix still applies there).

Training (``forward(..., train=True)``, :meth:`VisionLanguage.apply_train`)
runs the tower under ``torch.no_grad()`` whether or not it is frozen (the
JAX module's ``stop_gradient``), hidden dropout from an explicit generator
where the Flax modules have it, and the LM's causal self-attention at 1470
tokens through the flash kernels' forward with LSE and their backward
(``ops/flash_attention.py``); the decoder's ``gradient_checkpointing``
recomputes each layer of the stack in the backward.

:func:`vl_evaluation` is the model's ``eval_func`` (the Validator's and the
ensemble CLI's): :func:`make_vl_generate_fn`, the single-device counterpart
of the JAX ``vl_evaluation``'s ``generate`` with its greedy,
small-vocabulary, permute and kernel routes, over a loader, decoded with the
dataset's tokenizer. Not ported: sharded evaluation.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks.transformer import (
    Embeddings, FeedForward, LayerNorm, Linear, MultiHeadAttention, TransformerConfig,
    causal_lm_loss, dropout, make_blocked_head_weights, prefix_operands, quantize_kv,
    run_layer, to_kernel_cache,
)
from ..blocks.vision.dinov2 import SwiGLUFFN
from ..blocks.vision.visual_encoder import VisualEncoder, build_visual_encoder
from ..data.image import prepare_batch
from ..decoding import beam_search, greedy_search, tile_for_beams
from ..ops.attention import make_attention_bias
from ..ops.beam_cache_attention import KernelPrefix, pack_kernel_prefix, prefix_fusable
from ..registry import register
from .base import get_special_token_ids, resolve_block, resolve_device
from ..parallel.mesh import eval_devices
from .evaluation_nlg import (
    BLOCKED_MIN_VOCAB, kernel_route_ok, pipelined_decode, sharded_generate, to_device,
)

#: the keys of a DINOv2 config that the tower takes from a pretrained name,
#: besides ``image_size`` (the JAX package's list)
HF_DINOV2_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "mlp_ratio",
                  "patch_size", "layer_norm_eps", "use_swiglu_ffn", "hidden_act")


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
        # gradient checkpointing recomputes whole layers here, with or
        # without "dots" (the JAX module remats this stack without a policy)
        remat = bool(self.config.gradient_checkpointing)
        for layer in self.layers:
            h = run_layer(layer, remat, generator, h, bias=bias, causal=True, train=train)
        logits = self.lm_head(h[:, p:]).float()
        return {"loss": causal_lm_loss(logits, input_ids, attention_mask), "logits": logits}

    def prefill(self, images, max_text_len: int, quantize_prefix: bool = False):
        """Run the image prefix through the stack. Returns ``(gen_cache,
        prefix_kv, prefix_len)``: per layer the zeroed (B, max_text_len, H, D)
        generated-token cache and the prefix (K, V) in the compute dtype,
        which stay at batch B as decode-loop invariants.
        ``quantize_prefix=True`` stores each layer's prefix as ``quantize_kv(K)
        + quantize_kv(V)``: ``(K_q, k_scale, V_q, v_scale)``, int8 with
        per-(token, head) f32 scales."""
        cfg = self.config
        h = self.image_prefix(images).to(cfg.dtype)
        b, p, _ = h.shape
        shape = (b, max_text_len, cfg.num_attention_heads, cfg.head_dim)
        gen_cache, prefix_kv = [], []
        for layer in self.layers:
            # this layer's K/V projections of its prefix input are the prefix
            # segment of the decode-time cache
            kv = layer.self_attn.kv(h)
            prefix_kv.append(quantize_kv(kv[0]) + quantize_kv(kv[1]) if quantize_prefix else kv)
            h = layer(h, causal=True)
            gen_cache.append({"self_k": torch.zeros(shape, dtype=cfg.dtype, device=h.device),
                              "self_v": torch.zeros(shape, dtype=cfg.dtype, device=h.device)})
        return tuple(gen_cache), tuple(prefix_kv), p

    def decode_step(self, tokens, cache, prefix_kv, index: int, prefix_len: int,
                    blocked_head, ancestry):
        """One token at absolute position ``prefix_len + index`` for every
        beam row; ``cache`` is the generated cache, updated in place: the
        kernel layout (int8 with a ``self_kv_sc`` leaf for stage (c)), or the
        plain ``self_k``/``self_v`` (N, T, H, D) of the permute route
        (``ancestry`` unused). ``prefix_kv`` holds the per-layer
        ``prefix_operands`` or ``KernelPrefix`` bundles, ``blocked_head`` the
        padded head ``(weight (Vp, H) f32, bias (Vp,) f32)`` or None. Returns
        (N, Vp // 128, 128) f32 blocked logits, or without a blocked head the
        plain head's (N, V) logits in f32."""
        h = self._text_embed(tokens, prefix_len + index)
        kernel = "self_k_tnf" in cache[0]
        for layer, lc, pkv in zip(self.layers, cache, prefix_kv):
            layer_cache = ((lc["self_k_tnf"], lc["self_v_tnf"], lc.get("self_kv_sc")) if kernel
                           else (lc["self_k"], lc["self_v"]))
            h = layer.decode(h, pkv, layer_cache, index, ancestry)
        if blocked_head is None:
            return self.lm_head(h)[:, -1].float()
        w, bias = blocked_head
        # compute-dtype operands, f32 sums (the weight holds compute-dtype values)
        out = h[:, -1].to(self.config.dtype).float() @ w.t() + bias
        return out.reshape(out.shape[0], -1, 128)


def derive_gen_kv_scales(prefix_kvs, margin: float = 1.25):
    """Per-layer (2, H*D) f32 per-lane scales (row 0 K, row 1 V) for the int8
    generated cache (``gen_kv_dtype: int8``), from the prefix K/V.

    The generated cache needs scales fixed across the decode (past entries
    must dequantize alike) and known before the first write. The prefix went
    through the same K/V projections as the generated tokens will, so its
    per-lane maximum |x| over (B, P), times ``margin / 127``, is the
    estimate; the kernel's saturating write bounds any lane that still
    overshoots. Floored at 1e-8. Takes both prefill formats: ``(K, V)``, and
    the int8 ``(K_q, k_scale, V_q, v_scale)`` whose |x| is |q| * scale."""
    def amax_lanes(x, sc=None):
        xf = x.float().abs()
        if sc is not None:
            xf = xf * sc.float()[..., None]
        return xf.amax(dim=(0, 1)).flatten()

    out = []
    for pkv in prefix_kvs:
        if len(pkv) == 4:
            pk_q, k_sc, pv_q, v_sc = pkv
            ka, va = amax_lanes(pk_q, k_sc), amax_lanes(pv_q, v_sc)
        else:
            ka, va = amax_lanes(pkv[0]), amax_lanes(pkv[1])
        out.append(torch.clamp_min(torch.stack([ka, va]) * (margin / 127.0), 1e-8))
    return tuple(out)


def maybe_fuse_prefix(prefix_kv, group_items: int, beam_width: int, prefix_len: int):
    """Per-layer ``(K, V)`` prefix -> :class:`KernelPrefix` bundles for the
    kernel's stage (d), when :func:`prefix_fusable` allows it; an int8
    4-tuple (which keeps the products and the merge) and a prefix that cannot
    fuse come back unchanged.

    The JAX package's ``maybe_fuse_prefix`` fuses only under
    ``VILMEDIC_FUSED_PREFIX=1`` and, on the TPU, only at ``group_items % 8
    == 0`` (a Mosaic rule; on its CPU it always fuses). The port reads no
    environment: ``make_vl_generate_fn(fused_prefix=True)`` calls this, and
    ``prefix_fusable`` holds what the CUDA kernel needs."""
    if len(prefix_kv[0]) == 2 and prefix_fusable(beam_width, group_items, prefix_len):
        return tuple(pack_kernel_prefix(pk, pv, beam_width) for pk, pv in prefix_kv)
    return prefix_kv


def make_vl_generate_fn(model, beam_width: int, max_len: int, bos_id: int, eos_id: int,
                        pad_id: int, length_penalty: float = 1.0, ancestry_group_items: int = 1,
                        prefix_kv_dtype=None, gen_kv_dtype=None, fused_prefix: bool = False):
    """``generate(images (B, 3, H, W) float)`` for one VisionLanguage model,
    on the model's device: a ``BeamResult`` for beam search, a
    ``RolloutResult`` for greedy decoding (``beam_width`` <= 1).

    The order of ``vl_evaluation``'s generate: prefill; tile only the
    generated cache for the beams; on the kernel route, with ``gen_kv_dtype
    == "int8"`` derive the generated cache's scales from the prefix and
    convert the cache to the kernel layout (int8 with those scales), and
    with ``fused_prefix`` and no int8 generated cache pack the prefix for
    the kernel's stage (d); pad the LM head once; decode.

    The routes follow the model and the beam width, as in ``vl_evaluation``:

    - beam search where the beam-cache kernel is built for the decoder's
      head dim (:func:`~.evaluation_nlg.kernel_route_ok`): the
      never-reordered kernel cache; else the permute route, whose plain
      cache beam search reorders every step (there ``gen_kv_dtype`` and
      ``fused_prefix``, features of the kernel cache, are ignored);
    - beam search over a vocabulary of ``BLOCKED_MIN_VOCAB`` or more: the
      padded blocked head; below it, the plain head's f32 logits and the
      two-stage candidates;
    - ``beam_width`` <= 1: greedy decoding over the plain (B, T, H, D)
      cache and the plain head, without forced EOS.

    ``prefix_kv_dtype`` and ``gen_kv_dtype`` take the eval block's keys of
    those names and mean int8 where ``str(x or "") == "int8"``, as in
    ``vl_evaluation``. ``fused_prefix=True`` stands for the JAX package's
    ``VILMEDIC_FUSED_PREFIX=1``; the port reads no environment variable.
    ``ancestry_group_items`` sets the items per beam-cache mask group; any
    divisor of the batch gives the same sequences."""
    module = model.module
    beam = bool(beam_width) and beam_width > 1
    blocked = beam and model.dec_config.vocab_size >= BLOCKED_MIN_VOCAB
    kernel_cache = kernel_route_ok([model], beam_width)
    quantize_prefix = str(prefix_kv_dtype or "") == "int8"
    quantize_gen = kernel_cache and str(gen_kv_dtype or "") == "int8"

    @torch.inference_mode()
    def generate(images):
        cache, prefix_kv, prefix_len = module.prefill(images, max_len,
                                                      quantize_prefix=quantize_prefix)
        if beam:
            cache = tile_for_beams(cache, beam_width)
        if kernel_cache:
            gen_scales = derive_gen_kv_scales(prefix_kv) if quantize_gen else None
            cache = to_kernel_cache(cache, scales=gen_scales)
            if fused_prefix and gen_scales is None:
                prefix_kv = maybe_fuse_prefix(prefix_kv, ancestry_group_items, beam_width,
                                              prefix_len)
        if not isinstance(prefix_kv[0], KernelPrefix):
            prefix_kv = prefix_operands(prefix_kv)
        head = None
        if blocked:
            wb, bb = make_blocked_head_weights(module)
            head = (wb.float(), bb)  # upcast once, not every step

        def step_fn(tokens, index, anc=None):
            return module.decode_step(tokens, cache, prefix_kv, index, prefix_len, head, anc)

        if not beam:
            return greedy_search(step_fn, images.shape[0], max_len, bos_id, eos_id, pad_id,
                                 images.device, forced_eos=False)
        return beam_search(step_fn, images.shape[0], beam_width, max_len, bos_id, eos_id,
                           pad_id, images.device, length_penalty=length_penalty,
                           ancestry_group_items=ancestry_group_items, blocked=blocked,
                           caches=None if kernel_cache else cache)

    return generate


def vl_evaluation(models, config, dl, **kwargs) -> Dict[str, Any]:
    """The ``eval_func`` of :class:`VisionLanguage` (the JAX package's
    ``vl_evaluation``): :func:`make_vl_generate_fn` of the first
    model at the config's ``beam_width`` (default 1), ``length_penalty``
    (default 1), ``prefix_kv_dtype`` and ``gen_kv_dtype``, up to the
    dataset's ``tokenizer_max_len``, with the special ids of the decoder
    config or else the dataset's tokenizer; the fused prefix under
    ``VILMEDIC_FUSED_PREFIX=1``, as the JAX package's ``maybe_fuse_prefix``
    takes it. Every batch of ``dl`` goes to the model's device, and the
    generated and reference ids are decoded into ``hyps`` and ``refs``
    (``pipelined_decode``), sharded over the local cards as
    ``evaluation_nlg.sharded_generate`` does under ``shard_eval``."""
    model = models[0]
    dataset = dl.dataset
    tokenizer = dataset.tokenizer
    max_len = int(dataset.tokenizer_max_len)
    bos_id, eos_id, pad_id = get_special_token_ids(model.dec_config, tokenizer)
    device = next(model.module.parameters()).device

    def make_generate(replica):
        generate = make_vl_generate_fn(
            replica[0], int(config.get("beam_width", 1) or 1), max_len, bos_id, eos_id, pad_id,
            length_penalty=float(config.get("length_penalty") or 1.0),
            prefix_kv_dtype=config.get("prefix_kv_dtype"),
            gen_kv_dtype=config.get("gen_kv_dtype"),
            fused_prefix=os.environ.get("VILMEDIC_FUSED_PREFIX", "0") == "1")
        return lambda inputs: generate(inputs["images"])

    launch = sharded_generate([model], eval_devices(config, device), make_generate)

    def prepare(batch):
        images = prepare_batch(to_device(batch, device), dataset)["images"]
        return {"images": images}, batch["input_ids"], batch["input_ids"].shape[0]

    return pipelined_decode(dl, tokenizer, prepare, launch)


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
    a config's ``model:`` block (proto ``VisionLanguage``), as the JAX
    package builds it.

    ``vision_model_name`` names a pretrained DINOv2 tower: its
    ``config.json`` is read from a local directory or the HF hub cache
    (``hf_compat._resolve_hf_config``) and gives the tower's architecture
    (:data:`HF_DINOV2_KEYS` and ``image_size``, under the vision block's own
    keys); the prefix then drops the tower's CLS token. A name that does not
    resolve raises the JAX package's offline error; the tower is recorded in
    ``pretrained_blocks``, so that ``base.load_pretrained`` lays the weights
    beside the config over its init, the position grid re-gridded to the
    tower's token count (without weights the tower keeps its random
    weights, with the JAX package's warning). ``vision_hf_config`` (a DINOv2
    config dict) stands in for the lookup, and no weights are read then.

    With a loader ``dl`` the decoder's ``vocab_size`` and BOS / EOS / PAD
    are the tokenizer's vocabulary size and ``[CLS]`` / ``[SEP]`` /
    ``[PAD]`` ids; the keywords ``vocab_size`` and the special ids, where
    given, win over both. A special id at or past ``vocab_size`` raises
    ``ValueError`` (a tokenizer whose specials are added tokens beyond its
    vocabulary; the JAX package's loss is NaN there). It builds on the card unless ``device`` names
    another. Weights are random from ``seed`` unless a state dict is loaded
    after. The tower is frozen unless the config's ``vision`` block says
    ``freeze: false``: ``frozen_prefixes`` is then empty and the tower's
    parameters are in the optimizer, though the prefix takes no gradient
    through the tower (the JAX module's ``stop_gradient``), so only weight
    decay moves them."""

    def __init__(self, decoder=None, vision=None, vision_model_name: Optional[str] = None,
                 dl=None, from_training: bool = True, vision_hf_config=None,
                 dtype="float32", vocab_size: Optional[int] = None,
                 bos_token_id: Optional[int] = None, eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None, device="cuda", seed: int = 0, **kwargs):
        from ..config.config import Config
        from .hf_compat import _resolve_hf_config

        device = resolve_device(device)
        self.pretrained_blocks = {}
        compute_dtype = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") else torch.float32
        dec_args, _ = resolve_block(decoder)
        if isinstance(vision, str):
            vision_model_name, vision = vision, None
        vision = vision.to_dict() if isinstance(vision, Config) else dict(vision or {})
        vision_model_name = vision.pop("vision_model_name", vision_model_name)
        drop_cls_token = False
        if vision_model_name:
            hf = (dict(vision_hf_config) if vision_hf_config is not None
                  else _resolve_hf_config(vision_model_name))
            if hf.get("model_type") != "dinov2":
                raise ValueError(f"vision_model_name {vision_model_name!r} resolved to "
                                 f"model_type {hf.get('model_type')!r}; only DINOv2 "
                                 "backbones are supported here (the reference's default)")
            vision.setdefault("backbone", "dinov2")
            for key in HF_DINOV2_KEYS:
                if key in hf:
                    vision.setdefault(key, hf[key])
            vision.setdefault("image_size", hf.get("image_size", 518))
            if vision_hf_config is None:
                self.pretrained_blocks = {"vision": (vision_model_name, "dinov2")}
            drop_cls_token = True
        ids = {}
        if dl is not None:
            tokenizer = dl.dataset.tokenizer
            ids = dict(vocab_size=tokenizer.vocab_size, bos_token_id=tokenizer.cls_token_id,
                       eos_token_id=tokenizer.sep_token_id, pad_token_id=tokenizer.pad_token_id)
        explicit = dict(vocab_size=vocab_size, bos_token_id=bos_token_id,
                        eos_token_id=eos_token_id, pad_token_id=pad_token_id)
        ids.update({k: v for k, v in explicit.items() if v is not None})
        self.dec_config = TransformerConfig.from_dict(dec_args, **ids, dtype=compute_dtype)
        special = {k: getattr(self.dec_config, k) for k in ("bos_token_id", "eos_token_id",
                                                             "pad_token_id")}
        if any(i is not None and i >= self.dec_config.vocab_size for i in special.values()):
            # the JAX VL sizes its embedding the same way and reads NaN rows
            # there (jnp.take's fill): a tokenizer whose special tokens are
            # added after its vocabulary, as ModernBERT's are
            raise ValueError(
                f"special token ids {special} lie outside the decoder's vocab_size "
                f"{self.dec_config.vocab_size}: the tokenizer's special tokens are added "
                "tokens beyond its vocabulary; give vocab_size=len(tokenizer)")
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
        self.eval_func = vl_evaluation

    def apply_train(self, batch, generator: Optional[torch.Generator] = None):
        """One training forward over a batch ``{"images", "input_ids",
        "attention_mask"}``: ``{"loss", "logits"}`` with the graph for the
        backward; ``generator`` (on the model's device) draws the dropout
        masks."""
        return self.module(batch["images"], batch["input_ids"], batch["attention_mask"],
                           train=True, generator=generator)

    def __repr__(self):
        return "model: VisionLanguage (DINOv2 tower + prefix-conditioned causal LM)"
