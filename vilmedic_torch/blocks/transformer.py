"""BERT-generation-style decoder with cross-attention (port of the decoder half
of ``blocks/transformer.py``).

A post-LayerNorm transformer with learned absolute positions, an exact-erf
GELU FFN, causal self-attention and cross-attention over an encoder memory,
and a bare linear LM head (BertGeneration). Three ways in, as in the JAX
module (``mode=``):

- ``train``: teacher forcing over a whole sequence -> f32 logits (B, T, V);
- ``init_cache``: zeroed self K/V at ``max_len`` plus the cross K/V of the
  encoder memory, computed once;
- ``decode``: one token at ``decode_index`` over the fused-kernel cache layout
  (``to_kernel_cache``), updated in place by the beam-cache kernel.

``MultiHeadAttention.prefix_decode`` is the VisionLanguage prefix LM's decode
step: the beam-cache kernel's segment merged with a beam-shared prefix.

Numerics follow the Flax modules: Linear/Embedding weights are stored in the
compute dtype (Flax casts its f32 params to the compute dtype per op, which
rounds the same way); LayerNorm computes in f32 with f32 params and casts its
output to the compute dtype; attention scores and softmax are f32.
Parameter names follow the Flax tree (``layer_0.self_attn.q.weight``), so the
weight bridge (``zoo/from_jax.py``) is a rename plus transposes. Dropout is
left out: it acts only in training, which a later slice ports.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, make_attention_bias
from ..ops.beam_cache_attention import fused_beam_cache_attention
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
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    bos_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    hidden_act: str = "gelu"
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_dict(cls, d: Dict, **overrides) -> "TransformerConfig":
        """Build from an HF-style config dict, ignoring unknown keys (dropout
        and gradient checkpointing act only in training, which is not
        ported)."""
        from ..config.config import Config

        if isinstance(d, Config):
            d = d.to_dict()
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in {**d, **overrides}.items() if k in known}
        if d.get("model_type") in ("bert", "roberta", "camembert", "xlm-roberta"):
            raise NotImplementedError("the BERT/RoBERTa LM-head transform is not ported")
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


def _linear(cfg: TransformerConfig, n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, dtype=cfg.dtype)


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


def to_kernel_cache(self_cache):
    """Per-layer ``self_k``/``self_v`` (N, T, H, D) -> ``self_k_tnf``/
    ``self_v_tnf`` (T, N, H*D): the layout the beam-cache kernel reads and
    writes in place."""
    out = []
    for layer in self_cache:
        n, t, h, d = layer["self_k"].shape
        out.append({
            "self_k_tnf": layer["self_k"].permute(1, 0, 2, 3).reshape(t, n, h * d).contiguous(),
            "self_v_tnf": layer["self_v"].permute(1, 0, 2, 3).reshape(t, n, h * d).contiguous(),
        })
    return tuple(out)


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
                ancestry=None, causal: bool = False):
        """``cache``: the (K, V) cross cache at batch B for cross-attention, or
        the (k_tnf, v_tnf) kernel self cache for a decode step (updated in
        place, with ``ancestry`` the kernel's (groups, rows, T*rows) mask)."""
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
            if cache is not None:
                if ancestry is None or decode_index is None:
                    raise ValueError("kernel-cache decode needs ancestry and decode_index")
                n = q.shape[0]
                shape = (n, cfg.num_attention_heads, cfg.head_dim)
                out = fused_beam_cache_attention(
                    cache[0], cache[1], q.reshape(shape), k_new.reshape(shape),
                    v_new.reshape(shape), ancestry, decode_index,
                )
                return self.o(out.to(cfg.dtype).reshape(n, 1, cfg.hidden_size))
            k, v = k_new, v_new
        out = dot_product_attention(q, k, v, bias=bias, dtype=cfg.dtype, causal=causal)
        b, t = out.shape[:2]
        return self.o(out.reshape(b, t, cfg.hidden_size))

    def prefix_decode(self, x, prefix_kv, cache, decode_index: int, ancestry):
        """One-token decode over a beam-shared prefix plus the per-beam
        generated cache, in one joint softmax (the kernel-cache route of the
        JAX ``prefix_decode``).

        ``prefix_kv`` is ``(pk, pv)`` from :func:`prefix_operands`, (B, H, P,
        D) f32 at batch B, while ``x`` carries N = B * fold beam-major rows;
        ``cache`` is the (k_tnf, v_tnf) kernel self cache, updated in place.
        The generated segment runs the beam-cache kernel with its softmax
        stats; the prefix segment folds the beams into the query axis; the two
        merge by their (m, l)."""
        cfg = self.config
        heads, d = cfg.num_attention_heads, cfg.head_dim
        q = self._split(self.q(x))  # (N, 1, H, D)
        k_new = self._split(self.k(x))
        v_new = self._split(self.v(x))
        n = q.shape[0]
        shape = (n, heads, d)
        out_g, m_g, l_g = fused_beam_cache_attention(
            cache[0], cache[1], q.reshape(shape), k_new.reshape(shape), v_new.reshape(shape),
            ancestry, decode_index, return_stats=True,
        )
        pk, pv = prefix_kv
        b = pk.shape[0]
        fold = n // b
        # compute-dtype operands (the f32-scaled query rounded to it) with f32
        # sums, as the JAX package's f32-output products of the stored prefix
        qf = (q[:, 0].float() * (d ** -0.5)).to(cfg.dtype).float()
        sp = qf.view(b, fold, heads, d).transpose(1, 2) @ pk.transpose(-1, -2)  # (B, H, fold, P)
        mp = sp.amax(dim=-1, keepdim=True)
        ep = torch.exp(sp - mp)
        lp = ep.sum(dim=-1, keepdim=True)
        accp = ep.to(cfg.dtype).float() @ pv  # (B, H, fold, D), unnormalized
        # online-softmax merge, term for term, in the (B, H, fold) layout
        m_g, l_g = (t.view(b, fold, heads).transpose(1, 2)[..., None] for t in (m_g, l_g))
        out_g = out_g.view(b, fold, heads, d).transpose(1, 2)
        big = torch.maximum(m_g, mp)
        cg = torch.exp(m_g - big) * l_g
        cp = torch.exp(mp - big)
        out = (cg * out_g + cp * accp) / (cg + cp * lp)
        return self.o(out.transpose(1, 2).to(cfg.dtype).reshape(n, 1, cfg.hidden_size))


def prefix_operands(prefix_kv):
    """Per-layer prefix ``(K, V)`` (B, P, H, D) in the compute dtype ->
    ``(K, V)`` (B, H, P, D) f32, the operands of
    :meth:`MultiHeadAttention.prefix_decode`'s products. Made once per
    generate: compute-dtype values are exact in f32, and the decode loop then
    reads them with no per-step cast or transpose."""
    return tuple(tuple(x.transpose(1, 2).float().contiguous() for x in kv) for kv in prefix_kv)


class FeedForward(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.fc1 = _linear(config, config.hidden_size, config.intermediate_size)
        self.fc2 = _linear(config, config.intermediate_size, config.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        act = self.config.hidden_act
        if act == "gelu":
            h = F.gelu(h)  # exact erf GELU
        elif act == "gelu_tanh":
            h = F.gelu(h, approximate="tanh")
        else:
            h = F.relu(h)
        return self.fc2(h)


class Embeddings(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(config.vocab_size, config.hidden_size,
                                            dtype=config.dtype)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings,
                                                config.hidden_size, dtype=config.dtype)
        self.ln = LayerNorm(config.hidden_size, config.layer_norm_eps, config.dtype)

    def forward(self, input_ids, position_ids):
        return self.ln(self.word_embeddings(input_ids) + self.position_embeddings(position_ids))


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
                self_cache=None, cross_cache=None, decode_index=None, ancestry=None):
        attn = self.self_attn(x, bias=self_bias, cache=self_cache,
                              decode_index=decode_index, ancestry=ancestry)
        x = self.self_ln(x + attn)
        cross = self.cross_attn(x, kv_input=enc_hidden, bias=cross_bias, cache=cross_cache)
        x = self.cross_ln(x + cross)
        return self.ffn_ln(x + self.ffn(x))


class TransformerDecoder(nn.Module):
    """Causal decoder with cross-attention and LM head; ``mode`` as in the
    module doc."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(config)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", DecoderLayer(config))
        self.lm_head = _linear(config, config.hidden_size, config.vocab_size)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_hidden_layers)]

    def _head(self, h):
        return self.lm_head(h).float()

    def _head_blocked(self, h, blocked_weights, block: int = 128):
        """(N, nb, block) f32 logits from the padded head, in plain PyTorch:
        the compute-dtype product with f32 accumulation, plus the f32 bias."""
        wb, bb = blocked_weights
        h2 = h.reshape(-1, wb.shape[1]).to(self.config.dtype)
        out = h2.float() @ wb.float().t() + bb
        return out.reshape(out.shape[0], -1, block)

    def _head_blocked_stats(self, h, blocked_weights):
        """LM head through the blocked-stats kernel: returns ``(logits
        (N, nb, 128) f32, bmax (N, nb), bsum (N, nb))`` for beam search's
        ``_candidates_from_stats``."""
        wb, bb = blocked_weights
        h2 = h.reshape(-1, wb.shape[1]).to(self.config.dtype)
        return lm_head_blocked_stats(h2.contiguous(), wb, bb)

    def forward(self, input_ids=None, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, mode: str = "train", cache=None,
                decode_index: Optional[int] = None, max_len: Optional[int] = None,
                blocked_head=None, ancestry=None):
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
            # input_ids (N, 1); cache (self_cache, cross_cache); the self cache
            # must be in the kernel layout and is updated in place
            self_cache, cross_cache = cache
            if "self_k_tnf" not in self_cache[0]:
                raise NotImplementedError(
                    "decode runs on the fused-kernel cache layout (to_kernel_cache); "
                    "the cache-permute route is not ported yet"
                )
            positions = torch.full((1, 1), int(decode_index), dtype=torch.long,
                                   device=input_ids.device)
            h = self.embeddings(input_ids, positions)
            cross_bias = make_attention_bias(key_mask=encoder_attention_mask)
            for layer, self_lc, cross_lc in zip(self.layers, self_cache, cross_cache):
                h = layer(h, None, None, cross_bias,
                          (self_lc["self_k_tnf"], self_lc["self_v_tnf"]),
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
        h = self.embeddings(input_ids, positions)
        self_bias = make_attention_bias(key_mask=attention_mask, causal=True,
                                        query_len=t, key_len=t, device=input_ids.device)
        cross_bias = make_attention_bias(key_mask=encoder_attention_mask)
        enc_h = (encoder_hidden_states.to(cfg.dtype)
                 if encoder_hidden_states is not None else None)
        for layer in self.layers:
            h = layer(h, enc_h, self_bias, cross_bias)
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
