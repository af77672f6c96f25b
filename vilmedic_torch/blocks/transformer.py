"""BERT-generation-style decoder with cross-attention, and the bidirectional
text encoder (port of ``blocks/transformer.py``).

A post-LayerNorm transformer with learned absolute positions, an exact-erf
GELU FFN, causal self-attention and cross-attention over an encoder memory,
and a linear LM head: bare (BertGeneration), or, with ``lm_head_transform``
(set by ``TransformerConfig.from_dict`` for a BERT or RoBERTa config), after
the HF prediction head's transform, ``lm_transform`` (dense H -> H), an
exact-erf GELU and ``lm_transform_ln``, on every head route (the plain head,
the blocked head and the blocked-stats kernel K2). Encoders ignore the flag.
Three ways in, as in the JAX module (``mode=``):

- ``train``: teacher forcing over a whole sequence -> f32 logits (B, T, V);
- ``init_cache``: zeroed self K/V at ``max_len`` plus the cross K/V of the
  encoder memory, computed once;
- ``decode``: one token at ``decode_index`` over either the fused-kernel
  cache layout (``to_kernel_cache``), updated in place by the beam-cache
  kernel, or the plain ``self_k``/``self_v`` (N, T, H, D) cache of
  ``init_cache``, where the step's K/V are written in place at
  ``decode_index`` (the JAX module's ``dynamic_update_slice``) and attention
  runs over all T positions under the causal decode bias.

:class:`TransformerEncoder` (RRS's findings encoder) is the same post-LN
layer stack without the causal mask and the cross-attention: bidirectional
self-attention under the key-padding bias, through
``ops.attention.dot_product_attention`` as in the JAX package.

``MultiHeadAttention.prefix_decode`` is the VisionLanguage prefix LM's decode
step: the beam-cache kernel's segment merged with a beam-shared prefix, or,
over a plain cache that beam search reorders, one softmax over the prefix
and the generated slots.

Numerics follow the Flax modules: parameters are f32 (the optimizer's master
weights), and every :class:`Linear` and :class:`Embedding` casts its weight
(and bias) to the compute dtype at use, as Flax's ``param_dtype=float32``
with ``dtype=`` does; LayerNorm computes in f32 with f32 params and casts its
output to the compute dtype; attention scores and softmax are f32. Hidden
dropout (:func:`dropout`) sits where the Flax modules have it, on the FFN
output and the embeddings; attention-probability dropout is folded away, as
in the JAX package. Parameter names follow the Flax tree
(``layer_0.self_attn.q.weight``), so the weight bridge (``zoo/from_jax.py``)
is a rename plus transposes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import NEG_INF, dot_product_attention, make_attention_bias
from ..ops.beam_cache_attention import (
    KernelPrefix, fused_beam_cache_attention, quantize_cache_rows,
)
from ..ops.blocked_lm_head import NEG, lm_head_blocked_stats

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    bos_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    hidden_act: str = "gelu"
    initializer_range: float = 0.02
    # recompute each layer in the backward (HF config key): True recomputes
    # everything, "dots" keeps the matmul outputs (:func:`run_layer`)
    gradient_checkpointing: Any = False
    # BERT/RoBERTa prediction heads run dense + GELU + LayerNorm before the
    # vocab projection (HF BertLMPredictionHead / RobertaLMHead)
    lm_head_transform: bool = False
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_dict(cls, d: Dict, **overrides) -> "TransformerConfig":
        """Build from an HF-style config dict, ignoring unknown keys; a BERT or RoBERTa
        ``model_type`` turns on ``lm_head_transform`` unless the dict sets
        it."""
        from ..config.config import Config

        if isinstance(d, Config):
            d = d.to_dict()
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in {**d, **overrides}.items() if k in known}
        if "lm_head_transform" not in kwargs and d.get("model_type") in (
                "bert", "roberta", "camembert", "xlm-roberta"):
            kwargs["lm_head_transform"] = True
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = _DTYPES[kwargs["dtype"]]
        return cls(**kwargs)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32 (f32 params), output cast to the compute dtype."""

    def __init__(self, size: int, eps: float, out_dtype: torch.dtype):
        super().__init__(size, eps=eps)
        self.out_dtype = out_dtype

    def forward(self, x):
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(self.out_dtype)


class Linear(nn.Linear):
    """Flax ``nn.Dense(dtype=..., param_dtype=float32)``: f32 parameters; the
    input, weight and bias are cast to the compute dtype at use.

    A forward without grad (serving) keeps the cast weight and bias until a
    parameter changes (another storage or an in-place update, which bumps
    its version counter), so a decode loop casts them once per generate and
    not once per step: the same values, and 144 fewer cast kernels per step of
    the 12-layer VisionLanguage decoder (6 Linears a layer, weight and
    bias)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype):
        super().__init__(n_in, n_out)
        self.compute_dtype = dtype
        self._cast = (None, None)  # (key of the f32 parameters, cast (weight, bias))

    def forward(self, x):
        dt = self.compute_dtype
        x = x if x.dtype == dt else x.to(dt)
        w, b = self.weight, self.bias
        if w.dtype == dt or torch.is_grad_enabled():
            return F.linear(x, w.to(dt), b.to(dt))
        key = (w.device, dt, w.data_ptr(), w._version, b.data_ptr(), b._version)
        if self._cast[0] != key:
            self._cast = (key, (w.to(dt), b.to(dt)))
        return F.linear(x, *self._cast[1])


class Embedding(nn.Embedding):
    """Flax ``nn.Embed(dtype=..., param_dtype=float32)``: an f32 table whose
    looked-up rows are cast to the compute dtype (the same values as casting
    the table first; the backward sums repeated ids in f32)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids):
        return super().forward(ids).to(self.compute_dtype)


def dropout(x, p: float, generator: Optional[torch.Generator]):
    """Flax ``nn.Dropout``: keep each value with probability ``1 - p`` and
    scale the kept ones by ``1 / (1 - p)``, with masks drawn from
    ``generator`` on ``x``'s device; ``generator=None`` (eval) or ``p == 0``
    is the identity."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _matmul_saved(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def run_layer(layer, checkpointing, generator: Optional[torch.Generator], *args, **kwargs):
    """``layer(*args, generator=generator, **kwargs)``, recomputed in the
    backward when ``checkpointing`` is truthy and gradients are on (Flax's
    ``nn.remat`` of the layer): ``True`` keeps only the layer's inputs,
    ``"dots"`` also the outputs of its 2-D matmuls (``aten.mm`` / ``addmm``,
    JAX's ``dots_with_no_batch_dims_saveable``). The recompute replays the
    dropout masks: ``generator`` is set back to its state at the layer's
    start for it, and restored after, so the gradients equal those without
    checkpointing."""
    if not checkpointing or not torch.is_grad_enabled():
        return layer(*args, generator=generator, **kwargs)
    import functools

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    start = generator.get_state() if generator is not None else None
    calls = []

    def fn(*inputs):
        if start is None:
            return layer(*inputs, generator=generator, **kwargs)
        after = generator.get_state() if calls else None  # a recompute
        calls.append(1)
        generator.set_state(start)
        try:  # a recompute may stop early, by an exception, once it has what it needs
            return layer(*inputs, generator=generator, **kwargs)
        finally:
            if after is not None:
                generator.set_state(after)

    context = (functools.partial(create_selective_checkpoint_contexts, _matmul_saved)
               if checkpointing == "dots" else None)
    extra = {"context_fn": context} if context is not None else {}
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **extra)


def _linear(cfg: TransformerConfig, n_in: int, n_out: int) -> Linear:
    return Linear(n_in, n_out, cfg.dtype)


def make_blocked_head_weights(decoder: "TransformerDecoder", block: int = 128):
    """Pad the LM head to a multiple of ``block`` vocab rows, once per generate.

    Returns ``(weight (Vp, H) compute dtype, bias (Vp,) f32)``: pad rows of
    the weight are 0 and pad bias lanes -1e30, so a pad column never wins a
    block max. The bias makes the Flax path's round trip through the compute
    dtype (Flax rounds the bias to the compute dtype; the f32 head then adds
    it in f32)."""
    cfg = decoder.config
    w = decoder.lm_head.weight
    b = decoder.lm_head.bias
    v = w.shape[0]
    pad = -(-v // block) * block - v
    wb = F.pad(w.to(cfg.dtype), (0, 0, 0, pad))
    bb = F.pad(b.float(), (0, pad), value=NEG).to(cfg.dtype).float()
    return wb.contiguous(), bb


def to_kernel_cache(self_cache, scales=None):
    """Per-layer ``self_k``/``self_v`` (N, T, H, D) -> ``self_k_tnf``/
    ``self_v_tnf`` (T, N, H*D): the layout the beam-cache kernel reads and
    writes in place.

    ``scales`` (per-layer (2, H*D) f32, ``models.vision_language.
    derive_gen_kv_scales``) makes the leaves int8 (the zeroed cache casts
    exactly) and adds each layer's scales as a ``self_kv_sc`` leaf: the
    kernel's stage (c) then quantizes each step's write and dequantizes its
    reads. Apply it after ``tile_for_beams``: the scale leaf has no batch
    axis."""
    out = []
    for i, layer in enumerate(self_cache):
        n, t, h, d = layer["self_k"].shape
        entry = {
            "self_k_tnf": layer["self_k"].permute(1, 0, 2, 3).reshape(t, n, h * d).contiguous(),
            "self_v_tnf": layer["self_v"].permute(1, 0, 2, 3).reshape(t, n, h * d).contiguous(),
        }
        if scales is not None:
            entry = {k: v.to(torch.int8) for k, v in entry.items()}
            entry["self_kv_sc"] = scales[i].float().contiguous()
        out.append(entry)
    return tuple(out)


def quantize_kv(x):
    """Symmetric int8 quantization of a (B, S, H, D) K/V tensor with
    per-(token, head) scales: ``(q int8, scale f32 (B, S, H))`` with
    ``q * scale[..., None] ~= x``. The scale is max |x| / 127, floored at
    1e-8; values round half to even and saturate at ±127.

    Both divisions are tensor by tensor: PyTorch divides a CUDA tensor by a
    Python scalar as a multiply by its reciprocal, which can move the scale
    by an ulp and flip int8 values against the CPU and the JAX package."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
    return quantize_cache_rows(xf, scale[..., None]), scale


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention; see the module doc for the decode paths."""

    def __init__(self, config: TransformerConfig, cross: bool = False):
        super().__init__()
        self.config = config
        self.cross = cross
        h = config.hidden_size
        self.q = _linear(config, h, h)
        self.k = _linear(config, h, h)
        self.v = _linear(config, h, h)
        self.o = _linear(config, h, h)

    def _split(self, x):
        b, t, _ = x.shape
        cfg = self.config
        return x.reshape(b, t, cfg.num_attention_heads, cfg.head_dim)

    def kv(self, kv_input):
        """Project an encoder memory to (K, V) once: the cross-attention cache."""
        return self._split(self.k(kv_input)), self._split(self.v(kv_input))

    def forward(self, x, kv_input=None, bias=None, cache=None, decode_index=None,
                ancestry=None, causal: bool = False, train: bool = False):
        """``cache``: the (K, V) cross cache at batch B for cross-attention;
        for a decode step the (k_tnf, v_tnf) kernel self cache (updated in
        place, with ``ancestry`` the kernel's (groups, rows, T*rows) mask) or
        the plain (K, V) (N, T, H, D) self cache (step ``decode_index``
        written in place, ``bias`` the causal decode bias).
        ``train=True`` routes as a training step (``FLASH_MIN_LEN_TRAIN``)."""
        cfg = self.config
        q = self._split(self.q(x))
        if self.cross:
            k, v = cache if cache is not None else self.kv(kv_input)
            if cache is not None and k.shape[0] != q.shape[0]:
                # Beam-shared cross cache: K/V (and bias) stay at batch B while
                # the queries arrive beam-tiled (N = B * fold rows, one token);
                # the beams fold into the query axis instead of tiling K/V.
                b = k.shape[0]
                fold = q.shape[0] // b
                if q.shape[0] != b * fold or q.shape[1] != 1:
                    raise ValueError(f"cross decode: q {tuple(q.shape)} vs K {tuple(k.shape)}")
                q2 = q.reshape(b, fold, *q.shape[2:])
                out = dot_product_attention(q2, k, v, bias=bias, dtype=cfg.dtype)
                return self.o(out.reshape(q.shape[0], 1, cfg.hidden_size))
        else:
            k_new = self._split(self.k(x))
            v_new = self._split(self.v(x))
            if cache is not None and cache[0].ndim == 4:
                if decode_index is None:
                    raise ValueError("plain-cache decode needs decode_index")
                cache[0][:, decode_index] = k_new[:, 0].to(cache[0].dtype)
                cache[1][:, decode_index] = v_new[:, 0].to(cache[1].dtype)
                k, v = cache
            elif cache is not None:
                if ancestry is None or decode_index is None:
                    raise ValueError("kernel-cache decode needs ancestry and decode_index")
                n = q.shape[0]
                shape = (n, cfg.num_attention_heads, cfg.head_dim)
                out = fused_beam_cache_attention(
                    cache[0], cache[1], q.reshape(shape), k_new.reshape(shape),
                    v_new.reshape(shape), ancestry, decode_index,
                )
                return self.o(out.to(cfg.dtype).reshape(n, 1, cfg.hidden_size))
            else:
                k, v = k_new, v_new
        out = dot_product_attention(q, k, v, bias=bias, dtype=cfg.dtype, causal=causal,
                                    train=train)
        b, t = out.shape[:2]
        return self.o(out.reshape(b, t, cfg.hidden_size))

    def prefix_decode(self, x, prefix_kv, cache, decode_index: int, ancestry):
        """One-token decode over a beam-shared prefix plus the per-beam
        generated cache, in one joint softmax (the JAX ``prefix_decode``).

        ``x`` carries N = B * fold beam-major rows. ``cache`` is either
        ``(k_tnf, v_tnf, kv_sc)``, the kernel self cache (updated in place)
        and its int8 scales or None, or ``(k, v)``, the plain (N, T, H, D)
        self cache of the permute route (``ancestry`` unused): the step's K/V
        are written at ``decode_index`` and one softmax runs over the prefix
        and the generated slots up to it (:meth:`_prefix_decode_plain`).
        ``prefix_kv`` is one of:

        - a :class:`~vilmedic_torch.ops.beam_cache_attention.KernelPrefix`
          (kernel cache only): one beam-cache kernel call streams the prefix,
          the generated cache and the current step (stage d), no merge;
        - ``(pk, pv)`` from :func:`prefix_operands`, (B, H, P, D) f32 at
          batch B, or its int8 form ``(pk, k_sc, pv, v_sc)``: the generated
          segment runs the kernel with its softmax stats, the prefix segment
          folds the beams into the query axis, and the two merge by their
          (m, l).

        The prefix products take the stored prefix's dtype: the compute
        dtype for ``(pk, pv)``, bf16 for int8 (whose values are exact in
        bf16) even in an f32 model, so there the scaled query and the
        V-scaled weights round to bf16. The K scale multiplies the f32
        scores."""
        cfg = self.config
        heads, d = cfg.num_attention_heads, cfg.head_dim
        q = self._split(self.q(x))  # (N, 1, H, D)
        k_new = self._split(self.k(x))
        v_new = self._split(self.v(x))
        if len(cache) == 2:
            return self._prefix_decode_plain(q, k_new, v_new, prefix_kv, cache, decode_index)
        n = q.shape[0]
        shape = (n, heads, d)
        kc, vc, kv_sc = cache
        args = (kc, vc, q.reshape(shape), k_new.reshape(shape), v_new.reshape(shape), ancestry,
                decode_index)
        if isinstance(prefix_kv, KernelPrefix):
            out = fused_beam_cache_attention(*args, prefix=prefix_kv)
            return self.o(out.to(cfg.dtype).reshape(n, 1, cfg.hidden_size))
        out_g, m_g, l_g = fused_beam_cache_attention(*args, return_stats=True, kv_scales=kv_sc)
        pk, k_sc, pv, v_sc, mm_dtype = self._prefix_parts(prefix_kv)
        b = pk.shape[0]
        fold = n // b
        # mm_dtype operands (the f32-scaled query rounded to it) with f32
        # sums, as the JAX package's f32-output products of the stored prefix
        qf = (q[:, 0].float() * (d ** -0.5)).to(mm_dtype).float()
        sp = qf.view(b, fold, heads, d).transpose(1, 2) @ pk.transpose(-1, -2)  # (B, H, fold, P)
        if k_sc is not None:
            sp = sp * k_sc
        mp = sp.amax(dim=-1, keepdim=True)
        ep = torch.exp(sp - mp)
        lp = ep.sum(dim=-1, keepdim=True)
        wp = ep if v_sc is None else ep * v_sc
        accp = wp.to(mm_dtype).float() @ pv  # (B, H, fold, D), unnormalized
        # online-softmax merge, term for term, in the (B, H, fold) layout
        m_g, l_g = (t.view(b, fold, heads).transpose(1, 2)[..., None] for t in (m_g, l_g))
        out_g = out_g.view(b, fold, heads, d).transpose(1, 2)
        big = torch.maximum(m_g, mp)
        cg = torch.exp(m_g - big) * l_g
        cp = torch.exp(mp - big)
        out = (cg * out_g + cp * accp) / (cg + cp * lp)
        return self.o(out.transpose(1, 2).to(cfg.dtype).reshape(n, 1, cfg.hidden_size))

    def _prefix_parts(self, prefix_kv):
        """``(pk, k_sc, pv, v_sc, matmul dtype)`` of a :func:`prefix_operands`
        bundle; the scales are None for a compute-dtype prefix."""
        if len(prefix_kv) == 4:
            pk, k_sc, pv, v_sc = prefix_kv
            return pk, k_sc, pv, v_sc, torch.bfloat16
        pk, pv = prefix_kv
        return pk, None, pv, None, self.config.dtype

    def _prefix_decode_plain(self, q, k_new, v_new, prefix_kv, cache, decode_index: int):
        """The permute route of :meth:`prefix_decode` (the JAX package's
        non-kernel branch): write the step's K/V into the plain (N, T, H, D)
        cache at ``decode_index``; prefix scores fold the beams into the
        query axis, generated-slot scores stay per row (slots past the index
        at -1e9), and one f32 softmax runs over the (P + T) keys. The query
        is scaled in the compute dtype; the prefix products keep the stored
        prefix's dtype with the int8 scales factored out; the generated
        weights round to the compute dtype before their product."""
        cfg = self.config
        heads, d = cfg.num_attention_heads, cfg.head_dim
        kc, vc = cache
        kc[:, decode_index] = k_new[:, 0].to(kc.dtype)
        vc[:, decode_index] = v_new[:, 0].to(vc.dtype)
        pk, k_sc, pv, v_sc, mm_dtype = self._prefix_parts(prefix_kv)
        n, t = kc.shape[:2]
        b, p = pk.shape[0], pk.shape[2]
        fold = n // b
        qs = (q[:, 0] * (d ** -0.5)).float()  # (N, H, D)
        qf = qs.to(mm_dtype).float().view(b, fold, heads, d).transpose(1, 2)
        sp = qf @ pk.transpose(-1, -2)  # (B, H, fold, P)
        if k_sc is not None:
            sp = sp * k_sc
        sg = torch.einsum("nhd,nthd->nht", qs, kc.float())
        sg = torch.where(torch.arange(t, device=sg.device) <= decode_index, sg, NEG_INF)
        sg = sg.view(b, fold, heads, t).transpose(1, 2)  # (B, H, fold, T)
        s = torch.cat([sp, sg], dim=-1)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        w = e / e.sum(dim=-1, keepdim=True)
        wp = w[..., :p] if v_sc is None else w[..., :p] * v_sc
        out = (wp.to(mm_dtype).float() @ pv).to(cfg.dtype).transpose(1, 2)  # (B, fold, H, D)
        wg = w[..., p:].to(cfg.dtype).transpose(1, 2).reshape(n, heads, t)
        out = out.reshape(n, heads, d) + torch.einsum("nht,nthd->nhd", wg, vc)
        return self.o(out.reshape(n, 1, cfg.hidden_size))


def prefix_operands(prefix_kv):
    """Per-layer prefix K/V from ``prefill`` -> the operands of
    :meth:`MultiHeadAttention.prefix_decode`'s products, made once per
    generate so that the decode loop reads them with no per-step cast or
    transpose.

    ``(K, V)`` (B, P, H, D) in the compute dtype -> ``(K, V)`` (B, H, P, D)
    f32 (compute-dtype values are exact in f32). The int8 form ``(K_q,
    k_scale, V_q, v_scale)`` (int8 (B, P, H, D), f32 (B, P, H)) -> ``(K,
    k_scale, V, v_scale)``: K and V (B, H, P, D) f32 (int8 values are exact),
    the scales (B, H, 1, P) f32, broadcast over the beams."""
    def layer(kv):
        if len(kv) == 4:
            pk, k_sc, pv, v_sc = kv
            return (pk.transpose(1, 2).float().contiguous(),
                    k_sc.transpose(1, 2)[:, :, None].float().contiguous(),
                    pv.transpose(1, 2).float().contiguous(),
                    v_sc.transpose(1, 2)[:, :, None].float().contiguous())
        return tuple(x.transpose(1, 2).float().contiguous() for x in kv)

    return tuple(layer(kv) for kv in prefix_kv)


class FeedForward(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.fc1 = _linear(config, config.hidden_size, config.intermediate_size)
        self.fc2 = _linear(config, config.intermediate_size, config.hidden_size)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = self.fc1(x)
        act = self.config.hidden_act
        if act == "gelu":
            h = F.gelu(h)  # exact erf GELU
        elif act == "gelu_tanh":
            h = F.gelu(h, approximate="tanh")
        else:
            h = F.relu(h)
        return dropout(self.fc2(h), self.config.hidden_dropout_prob, generator)


class Embeddings(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.word_embeddings = Embedding(config.vocab_size, config.hidden_size, config.dtype)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size, config.dtype)
        self.ln = LayerNorm(config.hidden_size, config.layer_norm_eps, config.dtype)

    def forward(self, input_ids, position_ids, generator: Optional[torch.Generator] = None):
        h = self.ln(self.word_embeddings(input_ids) + self.position_embeddings(position_ids))
        return dropout(h, self.config.hidden_dropout_prob, generator)


class EncoderLayer(nn.Module):
    """Post-LN bidirectional layer: self-attention, then the FFN."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        eps, dt = config.layer_norm_eps, config.dtype
        self.self_attn = MultiHeadAttention(config, cross=False)
        self.self_ln = LayerNorm(config.hidden_size, eps, dt)
        self.ffn = FeedForward(config)
        self.ffn_ln = LayerNorm(config.hidden_size, eps, dt)

    def forward(self, x, bias=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        attn = self.self_attn(x, bias=bias, train=train)
        x = self.self_ln(x + dropout(attn, self.self_attn.config.hidden_dropout_prob, generator))
        return self.ffn_ln(x + self.ffn(x, generator))


class TransformerEncoder(nn.Module):
    """Bidirectional text encoder (the reference's BertGeneration encoder):
    learned positions, post-LN layers, the key-padding mask as a bias."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(config)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", EncoderLayer(config))

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_hidden_layers)]

    def forward(self, input_ids, attention_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """(B, T) ids -> (B, T, hidden) in the compute dtype. ``train``
        routes attention as a training step; ``generator`` draws the
        dropout masks (None: no dropout)."""
        t = input_ids.shape[1]
        positions = torch.arange(t, device=input_ids.device)[None, :]
        h = self.embeddings(input_ids, positions, generator)
        bias = make_attention_bias(key_mask=attention_mask, query_len=t, key_len=t)
        for layer in self.layers:
            h = run_layer(layer, self.config.gradient_checkpointing, generator, h, bias, train)
        return h


class DecoderLayer(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        eps, dt = config.layer_norm_eps, config.dtype
        self.self_attn = MultiHeadAttention(config, cross=False)
        self.self_ln = LayerNorm(config.hidden_size, eps, dt)
        self.cross_attn = MultiHeadAttention(config, cross=True)
        self.cross_ln = LayerNorm(config.hidden_size, eps, dt)
        self.ffn = FeedForward(config)
        self.ffn_ln = LayerNorm(config.hidden_size, eps, dt)

    def forward(self, x, enc_hidden=None, self_bias=None, cross_bias=None,
                self_cache=None, cross_cache=None, decode_index=None, ancestry=None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """``train`` routes attention as a training step; ``generator``
        draws the hidden-dropout masks (None: no dropout)."""
        p = self.self_attn.config.hidden_dropout_prob
        attn = self.self_attn(x, bias=self_bias, cache=self_cache,
                              decode_index=decode_index, ancestry=ancestry, train=train)
        x = self.self_ln(x + dropout(attn, p, generator))
        cross = self.cross_attn(x, kv_input=enc_hidden, bias=cross_bias, cache=cross_cache,
                                train=train)
        x = self.cross_ln(x + dropout(cross, p, generator))
        return self.ffn_ln(x + self.ffn(x, generator))


class TransformerDecoder(nn.Module):
    """Causal decoder with cross-attention and LM head; ``mode`` as in the
    module doc."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(config)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", DecoderLayer(config))
        if config.lm_head_transform:
            self.lm_transform = _linear(config, config.hidden_size, config.hidden_size)
            self.lm_transform_ln = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                             config.dtype)
        self.lm_head = _linear(config, config.hidden_size, config.vocab_size)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_hidden_layers)]

    def _transform(self, h):
        """The BERT/RoBERTa prediction head's transform where the config has
        one, else ``h``."""
        if not self.config.lm_head_transform:
            return h
        return self.lm_transform_ln(F.gelu(self.lm_transform(h)))

    def _head(self, h):
        return self.lm_head(self._transform(h)).float()

    def _head_blocked(self, h, blocked_weights, block: int = 128):
        """(N, nb, block) f32 logits from the padded head, in plain PyTorch:
        the compute-dtype product with f32 accumulation, plus the f32 bias."""
        wb, bb = blocked_weights
        h2 = self._transform(h).reshape(-1, wb.shape[1]).to(self.config.dtype)
        out = h2.float() @ wb.float().t() + bb
        return out.reshape(out.shape[0], -1, block)

    def _head_blocked_stats(self, h, blocked_weights):
        """LM head through the blocked-stats kernel: returns ``(logits
        (N, nb, 128) f32, bmax (N, nb), bsum (N, nb))`` for beam search's
        ``_candidates_from_stats``."""
        wb, bb = blocked_weights
        h2 = self._transform(h).reshape(-1, wb.shape[1]).to(self.config.dtype)
        return lm_head_blocked_stats(h2.contiguous(), wb, bb)

    def forward(self, input_ids=None, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, mode: str = "train", cache=None,
                decode_index: Optional[int] = None, max_len: Optional[int] = None,
                blocked_head=None, ancestry=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train`` and ``generator`` apply to ``mode="train"``: attention
        routed as a training step, hidden dropout from ``generator``."""
        cfg = self.config
        if mode == "init_cache":
            # (self_cache, cross_cache): the per-beam mutable state and the
            # beam-invariant cross K/V computed once from the memory
            b = encoder_hidden_states.shape[0]
            dev = encoder_hidden_states.device
            shape = (b, max_len, cfg.num_attention_heads, cfg.head_dim)
            self_cache, cross_cache = [], []
            for layer in self.layers:
                ck, cv = layer.cross_attn.kv(encoder_hidden_states.to(cfg.dtype))
                self_cache.append({
                    "self_k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                    "self_v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                })
                cross_cache.append({"cross_k": ck, "cross_v": cv})
            return tuple(self_cache), tuple(cross_cache)

        if mode == "decode":
            # input_ids (N, 1); cache (self_cache, cross_cache); the self cache,
            # kernel layout or plain, is updated in place
            self_cache, cross_cache = cache
            kernel = "self_k_tnf" in self_cache[0]
            names = ("self_k_tnf", "self_v_tnf") if kernel else ("self_k", "self_v")
            positions = torch.full((1, 1), int(decode_index), dtype=torch.long,
                                   device=input_ids.device)
            h = self.embeddings(input_ids, positions)
            self_bias = None if kernel else make_attention_bias(
                causal=True, key_len=self_cache[0]["self_k"].shape[1],
                decode_index=int(decode_index), device=input_ids.device)
            cross_bias = make_attention_bias(key_mask=encoder_attention_mask)
            for layer, self_lc, cross_lc in zip(self.layers, self_cache, cross_cache):
                h = layer(h, None, self_bias, cross_bias,
                          (self_lc[names[0]], self_lc[names[1]]),
                          (cross_lc["cross_k"], cross_lc["cross_v"]),
                          decode_index, ancestry)
            if blocked_head is not None:
                if len(blocked_head) == 3 and blocked_head[2] == "stats":
                    return self._head_blocked_stats(h[:, -1], blocked_head[:2])
                return self._head_blocked(h[:, -1], blocked_head)
            return self._head(h)

        if mode != "train":
            raise ValueError(f"unknown mode {mode!r}")
        t = input_ids.shape[1]
        positions = torch.arange(t, device=input_ids.device)[None, :]
        h = self.embeddings(input_ids, positions, generator)
        self_bias = make_attention_bias(key_mask=attention_mask, causal=True,
                                        query_len=t, key_len=t, device=input_ids.device)
        cross_bias = make_attention_bias(key_mask=encoder_attention_mask)
        enc_h = (encoder_hidden_states.to(cfg.dtype)
                 if encoder_hidden_states is not None else None)
        for layer in self.layers:
            h = run_layer(layer, cfg.gradient_checkpointing, generator, h, enc_h, self_bias,
                          cross_bias, train=train)
        return self._head(h)


def causal_lm_loss(logits, labels, label_mask=None) -> torch.Tensor:
    """HF ``labels=input_ids`` semantics: predict token t+1 from the prefix up
    to t, with padding masked out of the mean by ``label_mask``."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:].long()
    lse = torch.logsumexp(shift_logits, dim=-1)
    picked = shift_logits.gather(-1, shift_labels[..., None])[..., 0]
    nll = lse - picked
    if label_mask is not None:
        mask = label_mask[:, 1:].float()
    else:
        mask = torch.ones_like(nll)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
