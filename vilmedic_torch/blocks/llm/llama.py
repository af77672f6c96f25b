"""LLaMA-family causal LM, the GREEN judge's model (port of
``blocks/llm/llama.py``).

The numerics are the JAX module's, which follow HF ``LlamaForCausalLM``:
RMSNorm in f32 (the result times its f32 weight, cast to the compute
dtype), rotary embeddings in f32 (rotate-half, concatenated cos / sin, the
positions ``cumsum(mask) - 1`` clipped at 0, so left padding keeps every
row's positions), grouped-query attention (each key / value head serves
``num_attention_heads // num_key_value_heads`` query heads), scores in f32
masked to -1e9 where a key is padded or lies in a later slot, softmax in
f32, the SwiGLU MLP, pre-norm residuals, the head untied (``lm_head``) or
tied to the embedding, logits returned in f32.

The attention is plain ``torch.matmul`` and softmax, as in the JAX module
(``jnp.einsum``): no SDPA, no library kernel.

Parameters follow the Flax tree's names (``embed_tokens``, ``layers_{i}``
with ``self_attn`` ``q_proj`` / ``k_proj`` / ``v_proj`` / ``o_proj``,
``mlp`` ``gate_proj`` / ``up_proj`` / ``down_proj``, ``input_layernorm``,
``post_attention_layernorm``; ``norm``; ``lm_head``), so the JAX tree maps
on by a rename plus transposes (:func:`...zoo.from_jax.llama_state_dict_from_jax`)
and an HF checkpoint by a rename (:func:`...zoo.convert_llm.load_hf_llama`).
The projections and the embedding hold the compute dtype (the checkpoint's:
bf16 for a 7B judge), the norms f32, as the JAX module computes them.

:meth:`LlamaForCausalLM.forward_cached` is the serving entry: a prefill
(T prompt tokens at ``cache_index`` 0) or one decode step, writing its keys
and values into a (B, S, n_kv, D) cache per layer at ``cache_index``.
:func:`greedy_generate` decodes left-padded prompts greedily.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_config_from_hf(hf: Dict, dtype=torch.bfloat16) -> LlamaConfig:
    """A :class:`LlamaConfig` from an HF ``config.json`` dict."""
    return LlamaConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"], num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads") or hf["num_attention_heads"],
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5), rope_theta=hf.get("rope_theta", 10000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False), dtype=dtype)


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Linear(nn.Module):
    """A bias-free projection whose weight (out, in) holds the compute
    dtype."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.weight = _empty((d_out, d_in), dtype, device)

    def forward(self, x):
        return F.linear(x, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.weight = _empty((dim,), torch.float32, device)
        self.eps, self.dtype = eps, dtype

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight).to(self.dtype)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions (B, T) -> cos, sin (B, T, head_dim) in f32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x, cos, sin):
    """x (B, T, H, D): rotated in f32, back in x's dtype."""
    xf = x.float()
    return (xf * cos[:, :, None] + rotate_half(xf) * sin[:, :, None]).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        nh, nkv, dh, h = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                          cfg.hidden_size)
        self.q_proj = Linear(h, nh * dh, cfg.dtype, device)
        self.k_proj = Linear(h, nkv * dh, cfg.dtype, device)
        self.v_proj = Linear(h, nkv * dh, cfg.dtype, device)
        self.o_proj = Linear(nh * dh, h, cfg.dtype, device)

    def forward(self, x, cos, sin, key_mask, cache=None, cache_index: int = 0):
        """x (B, T, h); cos / sin of the tokens' positions; key_mask (B, S)
        over the key slots (S = T without a cache, the cache's length with
        one); the cache (k, v) is written in place at ``cache_index``."""
        cfg = self.cfg
        b, t, _ = x.shape
        nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = apply_rope(self.q_proj(x).view(b, t, nh, dh), cos, sin)
        k = apply_rope(self.k_proj(x).view(b, t, nkv, dh), cos, sin)
        v = self.v_proj(x).view(b, t, nkv, dh)
        if cache is not None:
            ck, cv = cache
            ck[:, cache_index:cache_index + t] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + t] = v.to(cv.dtype)
            k, v = ck, cv
        s = k.shape[1]
        if nkv != nh:
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
        # (B, H, T, S) in f32, as jnp.einsum(preferred_element_type=f32)
        scores = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1))
        scores = scores * dh ** -0.5
        q_slots = torch.arange(t, device=x.device) + cache_index
        visible = (key_mask[:, None, None, :] > 0) & (
            torch.arange(s, device=x.device)[None, None, None, :] <= q_slots[None, None, :, None])
        scores = scores.masked_fill(~visible, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2).reshape(b, t, nh * dh)
        return self.o_proj(out)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(h, i, cfg.dtype, device)
        self.up_proj = Linear(h, i, cfg.dtype, device)
        self.down_proj = Linear(i, h, cfg.dtype, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, device)
        self.mlp = LlamaMLP(cfg, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                                                device)

    def forward(self, x, cos, sin, key_mask, cache=None, cache_index: int = 0):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, key_mask, cache, cache_index)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaForCausalLM(nn.Module):
    """HF ``LlamaForCausalLM``'s decoder (module doc). The parameters are
    allocated, not initialized: load a state dict, or call
    :func:`init_random_`."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = _empty((cfg.vocab_size, cfg.hidden_size), cfg.dtype, device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", LlamaLayer(cfg, device))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, cfg.dtype, device)

    @property
    def layers(self) -> List[LlamaLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_hidden_layers)]

    def _head(self, x):
        w = self.embed_tokens.weight if self.cfg.tie_word_embeddings else self.lm_head.weight
        return F.linear(x, w).float()

    def _run(self, input_ids, positions, key_mask, cache=None, cache_index: int = 0):
        cos, sin = rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        x = self.embed_tokens.weight[input_ids]
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, key_mask, None if cache is None else cache[i], cache_index)
        return self._head(self.norm(x))

    @torch.inference_mode()
    def forward(self, input_ids, attention_mask):
        """Full-sequence logits (B, T, V) in f32; left or right padding per
        ``attention_mask``, positions ``cumsum(mask) - 1``."""
        positions = (attention_mask.cumsum(-1) - 1).clamp(min=0)
        return self._run(input_ids, positions, attention_mask)

    def init_cache(self, batch: int, length: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        cfg = self.cfg
        shape = (batch, length, cfg.num_key_value_heads, cfg.head_dim)
        dev = self.embed_tokens.weight.device
        return [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 torch.zeros(shape, dtype=cfg.dtype, device=dev))
                for _ in range(cfg.num_hidden_layers)]

    @torch.inference_mode()
    def forward_cached(self, input_ids, positions, key_mask, cache, cache_index: int):
        """Prefill or decode through the cache: ``input_ids`` (B, T) are
        written at slots ``[cache_index, cache_index + T)``; ``key_mask``
        (B, S) marks every slot valid after this write. Returns the logits
        (B, T, V) in f32; the cache is updated in place."""
        return self._run(input_ids, positions, key_mask, cache, cache_index)


@torch.inference_mode()
def greedy_generate(model: LlamaForCausalLM, input_ids, attention_mask, max_new_tokens: int,
                    eos_id: int, pad_id: int) -> torch.Tensor:
    """Batched greedy decode of LEFT-padded prompts (B, P): (B,
    max_new_tokens) int64 of the new tokens, ``pad_id`` after each row's EOS
    (the EOS itself kept). Causality is by cache slot; the loop ends early
    once every row is done, one host check per step."""
    b, p = input_ids.shape
    dev = input_ids.device
    cache = model.init_cache(b, p + max_new_tokens)
    positions = (attention_mask.cumsum(-1) - 1).clamp(min=0)
    key_mask = torch.zeros((b, p + max_new_tokens), dtype=attention_mask.dtype, device=dev)
    key_mask[:, :p] = attention_mask
    logits = model.forward_cached(input_ids, positions, key_mask, cache, 0)
    tok = logits[:, -1].argmax(-1)
    prompt_len = positions[:, -1] + 1
    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.long, device=dev)
    out[:, 0] = tok
    done = tok == eos_id
    for t in range(1, max_new_tokens):
        if bool(done.all()):
            break
        slot = p + t - 1  # the slot of the token emitted at step t - 1
        key_mask[:, slot] = 1
        logits = model.forward_cached(tok[:, None], (prompt_len + t - 1)[:, None], key_mask,
                                      cache, slot)
        tok = torch.where(done, torch.full_like(tok, pad_id), logits[:, 0].argmax(-1))
        out[:, t] = tok
        done = done | (tok == eos_id)
    return out


@torch.no_grad()
def init_random_(model: LlamaForCausalLM, seed: int = 0, std: float = 0.02) -> LlamaForCausalLM:
    """Random weights from ``seed`` on the model's device: normal(0, std)
    projections and embedding, unit norms."""
    dev = model.embed_tokens.weight.device
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight") or name == "norm.weight":
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=g, device=dev, dtype=torch.float32)
                    .mul_(std).to(p.dtype))
    return model
