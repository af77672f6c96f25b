"""The VisionLanguage serving routes with the int8 caches and the fused
prefix, port against the JAX package, on the CPU, float32.

The pieces: ``quantize_kv`` and ``derive_gen_kv_scales`` bitwise;
``MultiHeadAttention.prefix_decode`` for one layer on the int8-prefix route
(whose products round to bf16 even in an f32 model) and the ``KernelPrefix``
route; then the tiny VL slice of ``test_torch_vl_slice.py`` (DINOv2 width
128, 2-layer prefix LM, hidden 128, 2 heads of 64, beam 4) end to end on the
four routes, with weights carried across by ``vl_state_dict_from_jax``: beam
sequences exactly equal. The JAX side runs its kernels in interpret mode and
takes the fused prefix under ``VILMEDIC_FUSED_PREFIX=1``; the port takes
``fused_prefix=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vilmedic_torch.blocks.transformer as ttransformer
import vilmedic_torch.ops.attention as tattn
import vilmedic_tpu.ops.attention as jattn
from vilmedic_torch.blocks.transformer import MultiHeadAttention as TMHA
from vilmedic_torch.blocks.transformer import TransformerConfig as TConfig
from vilmedic_torch.blocks.transformer import prefix_operands, quantize_kv
from vilmedic_torch.models.rrg import RRG as TRRG
from vilmedic_torch.models.vision_language import VisionLanguage as TVL
from vilmedic_torch.models.vision_language import (
    derive_gen_kv_scales, make_vl_generate_fn, maybe_fuse_prefix,
)
from vilmedic_torch.ops.beam_cache_attention import KernelPrefix, fused_beam_cache_attention
from vilmedic_torch.ops.beam_cache_attention import pack_kernel_prefix as t_pack_prefix
from vilmedic_torch.zoo.from_jax import vl_state_dict_from_jax
from vilmedic_tpu.blocks import transformer as jtransformer
from vilmedic_tpu.blocks.transformer import MultiHeadAttention as JMHA
from vilmedic_tpu.blocks.transformer import TransformerConfig as JConfig
from vilmedic_tpu.blocks.transformer import make_blocked_head_weights, to_kernel_cache
from vilmedic_tpu.decoding import beam_search as jax_beam_search
from vilmedic_tpu.decoding import tile_for_beams
from vilmedic_tpu.models import hf_compat
from vilmedic_tpu.models import vision_language as jvl
from vilmedic_tpu.ops.beam_cache_attention import KernelPrefix as JKernelPrefix
from vilmedic_tpu.ops.beam_cache_attention import make_ancestry_mask, pick_ancestry_group
from vilmedic_tpu.ops.beam_cache_attention import pack_kernel_prefix as j_pack_prefix

VOCAB, BEAM, MAX_LEN, BOS, EOS, PAD = 4500, 4, 8, 0, 2, 1
IMAGE, PATCH = 32, 8
DINO = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            mlp_ratio=4.0, patch_size=PATCH, image_size=IMAGE, layer_norm_eps=1e-6,
            use_swiglu_ffn=False, hidden_act="gelu")
DECODER = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=192, max_position_embeddings=64, layer_norm_eps=1e-5,
               hidden_act="gelu", hidden_dropout_prob=0.0)
VISION = {"vision_model_name": "tiny/dinov2", "image_size": IMAGE}
FLASH_MIN_LEN = 16
# one layer's output: f32 sums in another order, then the int8 route's
# bf16 roundings of f32 values that can differ in their last bit
TOL = 1e-4

# (prefix_kv_dtype, gen_kv_dtype, fused_prefix)
ROUTES = {
    "int8 prefix + int8 generated cache": ("int8", "int8", False),
    "int8 generated cache": (None, "int8", False),
    "int8 prefix": ("int8", None, False),
    "fused prefix": (None, None, True),
}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_kv_bitwise(dtype):
    """int8 values and per-(token, head) scales bitwise equal to JAX's, an
    all-zero (token, head) included (the 1e-8 floor)."""
    rng = np.random.default_rng(1)
    x = np.array(jnp.asarray(rng.normal(size=(2, 7, 3, 64)) * 3.0, dtype).astype(jnp.float32))
    x[1, 4, 2] = 0.0
    x[0, 0, 0, 5] = 1e4  # one lane far above the rest of its head
    q_j, sc_j = jtransformer.quantize_kv(jnp.asarray(x, dtype))
    xt = torch.from_numpy(x)
    q_t, sc_t = quantize_kv(xt.to(torch.bfloat16) if dtype == jnp.bfloat16 else xt)
    assert q_t.dtype == torch.int8 and sc_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    assert sc_t[1, 4, 2] == np.float32(1e-8) and not q_t[1, 4, 2].any()


def test_derive_gen_kv_scales_bitwise():
    """Per-lane scales from both prefill formats, bitwise equal to JAX's."""
    rng = np.random.default_rng(2)
    layers = [tuple(rng.normal(size=(2, 9, 2, 64)).astype(np.float32) for _ in range(2))
              for _ in range(2)]
    layers[0][1][:, :, 1, 3] = 0.0  # a dead lane: the 1e-8 floor
    plain_j = [tuple(jnp.asarray(x) for x in kv) for kv in layers]
    int8_j = [jtransformer.quantize_kv(k) + jtransformer.quantize_kv(v) for k, v in plain_j]
    for fmt_j in (plain_j, int8_j):
        want = jvl.derive_gen_kv_scales(fmt_j)
        got = derive_gen_kv_scales([tuple(torch.from_numpy(np.array(x)) for x in kv)
                                    for kv in fmt_j])
        for g, w in zip(got, want):
            assert g.shape == (2, 128) and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert derive_gen_kv_scales([tuple(map(torch.from_numpy, layers[0]))])[0][1, 67] == \
        np.float32(1e-8)


def _one_layer(rng, int8_prefix: bool, int8_gen: bool, fused: bool, dequantized: bool = False):
    """``prefix_decode`` of one f32 attention layer, JAX and port, on the
    same weights, prefix, filled cache and ancestry. Returns (out_j, out_t,
    new cache JAX, the port's cache). ``dequantized``: the port gets the
    int8 prefix dequantized to f32 ``(K, V)``, the route of a stored f32
    prefix."""
    b, p, t, idx, g = 2, 11, 6, 4, 2
    n = b * BEAM
    cfg = dict(hidden_size=128, num_attention_heads=2)
    params = {name: {"kernel": (rng.normal(size=(128, 128)) * 0.1).astype(np.float32),
                     "bias": (rng.normal(size=128) * 0.1).astype(np.float32)}
              for name in ("q", "k", "v", "o")}
    mha_t = TMHA(TConfig(**cfg, dtype=torch.float32))
    mha_t.load_state_dict({f"{name}.{leaf}": torch.from_numpy(
        w["kernel"].T.copy() if leaf == "weight" else w["bias"])
        for name, w in params.items() for leaf in ("weight", "bias")})
    x = rng.normal(size=(n, 1, 128)).astype(np.float32)
    pk, pv = (rng.normal(size=(b, p, 2, 64)).astype(np.float32) for _ in range(2))
    src = rng.integers(0, BEAM, (b, BEAM, t))
    anc = np.zeros((b, BEAM, BEAM, t), np.float32)
    for bb in range(b):
        for qq in range(BEAM):
            for tt in range(idx):
                anc[bb, src[bb, qq, tt], qq, tt] = 1.0
    mask = np.asarray(make_ancestry_mask(jnp.asarray(anc), g=g)).astype(np.float32)
    cache_j = {"k_tnf": rng.normal(size=(t, n, 128)).astype(np.float32),
               "v_tnf": rng.normal(size=(t, n, 128)).astype(np.float32)}
    if int8_gen:
        cache_j = {k: np.clip(np.round(v * 40), -127, 127).astype(np.int8)
                   for k, v in cache_j.items()}
        cache_j["kv_sc"] = rng.uniform(0.01, 0.04, (2, 128)).astype(np.float32)
    cache_t = tuple(torch.from_numpy(cache_j[k].copy()) if k in cache_j else None
                    for k in ("k_tnf", "v_tnf", "kv_sc"))

    if fused:
        pkv_j = JKernelPrefix(*j_pack_prefix(jnp.asarray(pk), jnp.asarray(pv), g), beams=BEAM)
        pkv_t = t_pack_prefix(torch.from_numpy(pk), torch.from_numpy(pv), BEAM)
    elif int8_prefix:
        pkv_j = jtransformer.quantize_kv(jnp.asarray(pk)) + jtransformer.quantize_kv(
            jnp.asarray(pv))
        pk_q, k_sc, pv_q, v_sc = (torch.from_numpy(np.array(a)) for a in pkv_j)
        pkv_t = ((pk_q * k_sc[..., None], pv_q * v_sc[..., None]) if dequantized
                 else (pk_q, k_sc, pv_q, v_sc))
        pkv_t = prefix_operands([pkv_t])[0]
    else:
        pkv_j = (jnp.asarray(pk), jnp.asarray(pv))
        pkv_t = prefix_operands([(torch.from_numpy(pk), torch.from_numpy(pv))])[0]
    out_j, new_j = JMHA(JConfig(**cfg)).apply(
        {"params": params}, jnp.asarray(x), pkv_j, jax.tree.map(jnp.asarray, cache_j),
        jnp.asarray(idx), ancestry=jnp.asarray(mask), method=JMHA.prefix_decode)
    with torch.no_grad():
        out_t = mha_t.prefix_decode(torch.from_numpy(x), pkv_t, cache_t, idx,
                                    torch.from_numpy(mask) != 0)
    return np.asarray(out_j), out_t.numpy(), new_j, cache_t


@pytest.mark.parametrize("int8_prefix,int8_gen,fused", [
    (True, False, False), (True, True, False), (False, True, False), (False, False, True),
])
def test_prefix_decode_one_layer_matches_jax(int8_prefix, int8_gen, fused):
    """One f32 layer: the int8 prefix's products round the query and the
    V-scaled weights to bf16 (the stored prefix is not f32), the int8
    generated cache goes through stage (c) with its stats, and a
    ``KernelPrefix`` through stage (d) with no merge. The cache write (int8
    or f32) is bitwise JAX's, and the scale leaf is carried unchanged."""
    rng = np.random.default_rng(int8_prefix + 2 * int8_gen + 4 * fused)
    out_j, out_t, new_j, cache_t = _one_layer(rng, int8_prefix, int8_gen, fused)
    np.testing.assert_allclose(out_t, out_j, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache_t[0].numpy(), np.asarray(new_j["k_tnf"]))
    np.testing.assert_array_equal(cache_t[1].numpy(), np.asarray(new_j["v_tnf"]))
    if int8_gen:
        np.testing.assert_array_equal(cache_t[2].numpy(), np.asarray(new_j["kv_sc"]))


def test_int8_prefix_rounds_to_bf16_in_an_f32_model():
    """The same int8 prefix dequantized and multiplied in f32 misses JAX's
    int8 route by more than the tolerance: the bf16 roundings of that route
    are what the test above holds, not noise below it."""
    out_j, out_t, _, _ = _one_layer(np.random.default_rng(1), True, False, False,
                                    dequantized=True)
    assert np.abs(out_t - out_j).max() > 10 * TOL


def _jax_model(mp):
    mp.setattr(hf_compat, "_resolve_hf_config", lambda name: dict(DINO))
    return jvl.VisionLanguage(decoder=dict(DECODER), vision=dict(VISION), dl=_DL(),
                              dtype="float32")


class _DL:
    class dataset:
        class tokenizer:
            vocab_size = VOCAB
            cls_token_id = BOS
            sep_token_id = EOS
            pad_token_id = PAD


def _jax_generate(module, variables, images, prefix_kv_dtype, gen_kv_dtype, g):
    """``vl_evaluation``'s generate at these sizes, on one route (the fused
    prefix from the environment, as there)."""
    b = images.shape[0]
    cache, prefix_kv, p = module.apply(variables, images, MAX_LEN,
                                       quantize_prefix=prefix_kv_dtype == "int8",
                                       method=jvl.VisionLanguageModule.prefill)
    scales = jvl.derive_gen_kv_scales(prefix_kv) if gen_kv_dtype == "int8" else None
    cache = to_kernel_cache(tile_for_beams(cache, BEAM), scales=scales)
    if scales is None:
        prefix_kv = jvl.maybe_fuse_prefix(prefix_kv, g, BEAM, p)
    blocked = make_blocked_head_weights(variables["params"], jnp.float32)

    def step_fn(tokens, cache, index, anc=None):
        return module.apply(variables, tokens, cache, prefix_kv, index, p, blocked_head=blocked,
                            ancestry=anc, method=jvl.VisionLanguageModule.decode_step)

    res = jax_beam_search(step_fn, cache, b, BEAM, MAX_LEN, BOS, EOS, PAD, 1.0,
                          blocked_vocab=VOCAB, ancestry=True, ancestry_group_items=g)
    return res.sequences, res.scores


@pytest.fixture(scope="module")
def vl_setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "FLASH_MIN_LEN", FLASH_MIN_LEN)
        mp.setattr(tattn, "FLASH_MIN_LEN", FLASH_MIN_LEN)
        rng = np.random.default_rng(0)
        jmodel = _jax_model(mp)
        batch = {"images": jnp.zeros((2, IMAGE, IMAGE, 3)),
                 "input_ids": jnp.zeros((2, 4), jnp.int32),
                 "attention_mask": jnp.ones((2, 4), jnp.int32)}
        variables = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
        params = jax.tree.map(
            lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32),
            variables["params"])
        params["lm_head"]["kernel"] *= 2.0
        params["lm_head"]["kernel"][:, EOS] *= 3.0
        variables = {"params": params}
        images = rng.normal(size=(2, IMAGE, IMAGE, 3)).astype(np.float32)
        g = pick_ancestry_group(2, BEAM, MAX_LEN)
        want = {}
        for name, (p_dtype, g_dtype, fused) in ROUTES.items():
            if fused:
                mp.setenv("VILMEDIC_FUSED_PREFIX", "1")
            else:
                mp.delenv("VILMEDIC_FUSED_PREFIX", raising=False)
            seqs, scores = jax.jit(lambda v, im: _jax_generate(
                jmodel.module, v, im, p_dtype, g_dtype, g))(variables, jnp.asarray(images))
            want[name] = (np.asarray(seqs), np.asarray(scores))
        tmodel = TVL(decoder=dict(DECODER), vision=dict(VISION), vision_hf_config=DINO,
                     vocab_size=VOCAB, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
                     dtype="float32", device="cpu")
        tmodel.module.load_state_dict(vl_state_dict_from_jax(variables), strict=True)
        yield dict(tmodel=tmodel, images=images, g=g, want=want)


@pytest.mark.parametrize("route", list(ROUTES))
def test_vl_routes_beam_sequences_match_jax(vl_setup, route, monkeypatch):
    """The four routes end to end: beam sequences exactly JAX's, scores
    within 1e-4; each route launched what it should (counted on the
    wrapper: stage (c) once per layer and step on the int8 generated cache,
    stage (d) on the fused prefix, the stats with the merge)."""
    monkeypatch.setattr(tattn, "FLASH_MIN_LEN", FLASH_MIN_LEN)
    p_dtype, g_dtype, fused = ROUTES[route]
    calls = []

    def counting(*args, **kwargs):
        calls.append((kwargs.get("kv_scales") is not None, kwargs.get("prefix") is not None,
                      bool(kwargs.get("return_stats")), args[0].dtype))
        return fused_beam_cache_attention(*args, **kwargs)

    monkeypatch.setattr(ttransformer, "fused_beam_cache_attention", counting)
    generate = make_vl_generate_fn(vl_setup["tmodel"], BEAM, MAX_LEN, BOS, EOS, PAD, 1.0,
                                   ancestry_group_items=vl_setup["g"], prefix_kv_dtype=p_dtype,
                                   gen_kv_dtype=g_dtype, fused_prefix=fused)
    images = torch.from_numpy(vl_setup["images"]).permute(0, 3, 1, 2).contiguous()
    result = generate(images)
    seqs_j, scores_j = vl_setup["want"][route]
    np.testing.assert_array_equal(result.sequences.numpy(), seqs_j)
    np.testing.assert_allclose(result.scores.numpy(), scores_j, rtol=1e-4, atol=1e-4)
    assert len(calls) == 2 * result.steps
    int8_gen = g_dtype == "int8"
    assert all(c == (int8_gen, fused, not fused, torch.int8 if int8_gen else torch.float32)
               for c in calls)


def test_fused_prefix_helper_and_defaults():
    """``maybe_fuse_prefix`` packs ``(K, V)`` into ``KernelPrefix`` bundles
    and returns an int8 4-tuple unchanged; ``make_vl_generate_fn`` reads the
    dtype keys as ``vl_evaluation`` does (anything but "int8" is off)."""
    rng = np.random.default_rng(3)
    kv = [tuple(torch.from_numpy(rng.normal(size=(2, 5, 2, 64)).astype(np.float32))
                for _ in range(2))]
    fused = maybe_fuse_prefix(kv, 1, BEAM, 5)
    assert isinstance(fused[0], KernelPrefix) and fused[0].pk.shape == (2, 5, 128)
    assert fused[0].p_real == 5 and fused[0].beams == BEAM
    int8 = [quantize_kv(kv[0][0]) + quantize_kv(kv[0][1])]
    assert maybe_fuse_prefix(int8, 1, BEAM, 5) is int8
    assert maybe_fuse_prefix(kv, 1, BEAM, 0) is kv


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named, ``RRG``, ``VisionLanguage``, ``create_model``
    and ``Trainor`` build on the card, and raise where there is none: no
    entry point quietly builds on the CPU."""
    from vilmedic_torch.config import load_config
    from vilmedic_torch.config.config import executor_config
    from vilmedic_torch.executors import Trainor
    from vilmedic_torch.executors.utils import create_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = load_config("config/VL/vl-dinov2-modernbert.yml", [
        "model.decoder.hidden_size=128", "model.decoder.num_attention_heads=2",
        "model.decoder.num_hidden_layers=1", "model.decoder.intermediate_size=192",
        f"model.vision.image_size={IMAGE}"])
    kwargs = dict(vision_hf_config=DINO, vocab_size=VOCAB, bos_token_id=BOS, eos_token_id=EOS,
                  pad_token_id=PAD)
    entry_points = {
        "RRG": lambda: TRRG(decoder=dict(DECODER), cnn={"backbone": "densenet121"}),
        "VisionLanguage": lambda: TVL(decoder=dict(DECODER), vision=dict(VISION), **kwargs),
        "create_model": lambda: create_model(cfg, **kwargs),
        "Trainor": lambda: Trainor(executor_config(cfg, "trainor"), seed=0, loader=[],
                                   model_kwargs=kwargs),
    }
    for name, build in entry_points.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert create_model(cfg, device="cpu", **kwargs).module.lm_head.weight.device.type == "cpu"
