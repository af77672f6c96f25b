"""The VisionLanguage beam-search slice of the PyTorch port against the JAX
package, on the CPU, float32.

float images -> DINOv2 tower (width 128, 32² images, patch 8, CLS dropped) ->
2-layer projection + marker -> 2-layer prefix LM (hidden 128, 2 heads of 64)
-> prefill -> beam 4 over the beam-shared prefix and the never-permuted
generated cache, blocked LM head. The JAX side is the route of ``bench.py``'s
VisionLanguage generate: the ancestry beam-cache kernel with its softmax
stats (interpret mode) and the blocked head. ``FLASH_MIN_LEN`` is set low in
both packages, so the tower and the prefill take the flash route on both
sides at these lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vilmedic_torch.ops.attention as tattn
import vilmedic_tpu.ops.attention as jattn
from vilmedic_torch import registry as tregistry
from vilmedic_torch.blocks.transformer import make_blocked_head_weights as t_blocked_head
from vilmedic_torch.blocks.transformer import prefix_operands
from vilmedic_torch.blocks.transformer import to_kernel_cache as t_to_kernel_cache
from vilmedic_torch.blocks.vision.dinov2 import Dinov2 as TDinov2
from vilmedic_torch.config import load_config
from vilmedic_torch.models.vision_language import VisionLanguage as TVL
from vilmedic_torch.models.vision_language import make_vl_generate_fn
from vilmedic_torch.ops.flash_attention import flash_attention_reference
from vilmedic_torch.zoo.from_jax import vl_state_dict_from_jax
from vilmedic_tpu.blocks.transformer import make_blocked_head_weights, to_kernel_cache
from vilmedic_tpu.blocks.vision.dinov2 import Dinov2 as JDinov2
from vilmedic_tpu.decoding import beam_search as jax_beam_search
from vilmedic_tpu.decoding import tile_for_beams
from vilmedic_tpu.models import hf_compat
from vilmedic_tpu.models.vision_language import VisionLanguage as JVL
from vilmedic_tpu.models.vision_language import VisionLanguageModule as JVLModule
from vilmedic_tpu.ops.beam_cache_attention import make_ancestry_mask, pick_ancestry_group

VOCAB, BEAM, MAX_LEN, BOS, EOS, PAD = 4500, 4, 8, 0, 2, 1
IMAGE, PATCH = 32, 8
DINO = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            mlp_ratio=4.0, patch_size=PATCH, image_size=IMAGE, layer_norm_eps=1e-6,
            use_swiglu_ffn=False, hidden_act="gelu")
DECODER = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=192, max_position_embeddings=64, layer_norm_eps=1e-5,
               hidden_act="gelu", hidden_dropout_prob=0.0)
VISION = {"vision_model_name": "tiny/dinov2", "image_size": IMAGE}
# the tower (17 tokens), the prefill (17) and the teacher-forced pass take flash
FLASH_MIN_LEN = 16
# conv and matmul sums in another order than XLA's
TOL = 1e-4
# beam scores are sums of f32 log-probs computed in another order
TOL_SCORE = 1e-4


class _DL:
    class dataset:
        class tokenizer:
            vocab_size = VOCAB
            cls_token_id = BOS
            sep_token_id = EOS
            pad_token_id = PAD


def _jax_model(mp):
    mp.setattr(hf_compat, "_resolve_hf_config", lambda name: dict(DINO))
    return JVL(decoder=dict(DECODER), vision=dict(VISION), dl=_DL(), dtype="float32")


def _torch_model(variables=None, **kwargs):
    model = TVL(decoder=dict(DECODER), vision=dict(VISION), vision_hf_config=DINO,
                vocab_size=VOCAB, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
                dtype="float32", device="cpu", **kwargs)
    if variables is not None:
        model.module.load_state_dict(vl_state_dict_from_jax(variables), strict=True)
    return model


def _jax_generate(module, variables, images):
    """``bench.py``'s VisionLanguage generate at these sizes."""
    b = images.shape[0]
    cache, prefix_kv, p = module.apply(variables, images, MAX_LEN, method=JVLModule.prefill)
    cache = to_kernel_cache(tile_for_beams(cache, BEAM))
    blocked = make_blocked_head_weights(variables["params"], jnp.float32)

    def step_fn(tokens, cache, index, anc=None):
        return module.apply(variables, tokens, cache, prefix_kv, index, p, blocked_head=blocked,
                            ancestry=anc, method=JVLModule.decode_step)

    res = jax_beam_search(step_fn, cache, b, BEAM, MAX_LEN, BOS, EOS, PAD, 1.0,
                          blocked_vocab=VOCAB, ancestry=True,
                          ancestry_group_items=pick_ancestry_group(b, BEAM, MAX_LEN))
    return res.sequences, res.scores


@pytest.fixture(scope="module")
def slice_setup():
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
        # a wider head whose EOS logit swings widest: a hypothesis finishes
        # early, so the finished pool, the early stop and the length norm
        # all take part
        params["lm_head"]["kernel"] *= 2.0
        params["lm_head"]["kernel"][:, EOS] *= 3.0
        variables = {"params": params}
        images = rng.normal(size=(2, IMAGE, IMAGE, 3)).astype(np.float32)
        seqs_j, scores_j = jax.jit(lambda v, im: _jax_generate(jmodel.module, v, im))(
            variables, jnp.asarray(images))
        yield dict(jmodel=jmodel, variables=variables, images=images,
                   tmodel=_torch_model(variables), seqs_j=np.asarray(seqs_j),
                   scores_j=np.asarray(scores_j))


def _nchw(images):
    return torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("g", [1, 2])
def test_beam_sequences_match_jax(slice_setup, g):
    tmodel = slice_setup["tmodel"]
    generate = make_vl_generate_fn(tmodel, BEAM, MAX_LEN, BOS, EOS, PAD, 1.0,
                                   ancestry_group_items=g)
    result = generate(_nchw(slice_setup["images"]))
    assert result.sequences.shape == (2, MAX_LEN)
    np.testing.assert_array_equal(result.sequences.numpy(), slice_setup["seqs_j"])
    np.testing.assert_allclose(result.scores.numpy(), slice_setup["scores_j"],
                               rtol=TOL_SCORE, atol=TOL_SCORE)


def test_slice_exercises_early_finish(slice_setup):
    """The JAX reference itself: at least one hypothesis ends before max_len."""
    assert (slice_setup["seqs_j"][:, :-1] == EOS).any()


def test_prefix_drops_cls_and_takes_flash(slice_setup, monkeypatch):
    """The prefix drops CLS, and every tower and prefill layer routes its
    17-token self-attention to flash (the lowered threshold)."""
    jmodel, tmodel = slice_setup["jmodel"], slice_setup["tmodel"]
    assert tmodel.module.drop_cls_token and jmodel.module.drop_cls_token
    assert tmodel.module.num_image_tokens == jmodel.module.num_image_tokens == 17
    assert tmodel.dec_config.bos_token_id == BOS and tmodel.dec_config.vocab_size == VOCAB
    calls = []

    def counting_flash(q, k, v, key_mask=None, causal=False):
        calls.append((q.shape[1], k.shape[1], causal))
        return flash_attention_reference(q, k, v, key_mask, causal)

    monkeypatch.setattr(tattn, "flash_attention", counting_flash)
    with torch.no_grad():
        tmodel.module.prefill(_nchw(slice_setup["images"]), MAX_LEN)
    assert calls == [(17, 17, False)] * 2 + [(17, 17, True)] * 2


def test_prefill_matches_jax(slice_setup):
    """Per layer the prefix K/V (B, P, H, D) and the zeroed generated cache."""
    variables, images = slice_setup["variables"], slice_setup["images"]
    cache_j, pkv_j, p_j = slice_setup["jmodel"].module.apply(
        variables, jnp.asarray(images), MAX_LEN, method=JVLModule.prefill)
    with torch.no_grad():
        cache_t, pkv_t, p_t = slice_setup["tmodel"].module.prefill(_nchw(images), MAX_LEN)
    assert p_t == p_j == 17
    for (pk_t, pv_t), (pk_j, pv_j) in zip(pkv_t, pkv_j):
        np.testing.assert_allclose(pk_t.numpy(), np.asarray(pk_j), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j), rtol=TOL, atol=TOL)
    for lc_t, lc_j in zip(cache_t, cache_j):
        assert lc_t["self_k"].shape == lc_j["self_k"].shape == (2, MAX_LEN, 2, 64)
        assert not lc_t["self_k"].any() and not lc_t["self_v"].any()


@pytest.mark.parametrize("index", [0, 3])
def test_decode_step_matches_jax(slice_setup, index):
    """One decode step through every layer's ``prefix_decode`` (K1 with its
    stats, the beam-folded prefix products, the online-softmax merge) on a
    filled cache and a random ancestry: blocked logits and the cache write."""
    variables, images = slice_setup["variables"], slice_setup["images"]
    jmod, tmod = slice_setup["jmodel"].module, slice_setup["tmodel"].module
    b, n = 2, 2 * BEAM
    rng = np.random.default_rng(7 + index)
    _, pkv_j, p = jmod.apply(variables, jnp.asarray(images), MAX_LEN, method=JVLModule.prefill)
    with torch.no_grad():
        _, pkv_t, _ = tmod.prefill(_nchw(images), MAX_LEN)
    kv = [{"self_k": rng.normal(size=(n, MAX_LEN, 2, 64)).astype(np.float32),
           "self_v": rng.normal(size=(n, MAX_LEN, 2, 64)).astype(np.float32)}
          for _ in range(2)]
    anc = np.zeros((b, BEAM, BEAM, MAX_LEN), np.float32)  # (b, kj, kq, t)
    src = rng.integers(0, BEAM, (b, BEAM, MAX_LEN))
    for bb in range(b):
        for qq in range(BEAM):
            for t in range(index):
                anc[bb, src[bb, qq, t], qq, t] = 1.0
    mask = np.asarray(make_ancestry_mask(jnp.asarray(anc), g=1)).astype(np.float32)
    tokens = rng.integers(3, VOCAB, (n, 1)).astype(np.int32)

    cache_j = to_kernel_cache(jax.tree.map(jnp.asarray, kv))
    blocked_j = make_blocked_head_weights(variables["params"], jnp.float32)
    logits_j, new_j = jmod.apply(variables, jnp.asarray(tokens), cache_j, pkv_j,
                                 jnp.asarray(index), p, blocked_head=blocked_j,
                                 ancestry=jnp.asarray(mask), method=JVLModule.decode_step)
    cache_t = t_to_kernel_cache([{k: torch.from_numpy(v) for k, v in lc.items()} for lc in kv])
    with torch.no_grad():
        logits_t = tmod.decode_step(torch.from_numpy(tokens).long(), cache_t,
                                    prefix_operands(pkv_t), index, p,
                                    t_blocked_head(tmod), torch.from_numpy(mask) != 0)
    assert logits_t.shape == (n, -(-VOCAB // 128), 128)
    real = np.asarray(logits_j) > -1e29  # pad lanes sit at -1e30
    np.testing.assert_allclose(logits_t.numpy()[real], np.asarray(logits_j)[real],
                               rtol=TOL, atol=TOL)
    for lc_t, lc_j in zip(cache_t, new_j):
        np.testing.assert_allclose(lc_t["self_k_tnf"].numpy(), np.asarray(lc_j["self_k_tnf"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lc_t["self_v_tnf"].numpy(), np.asarray(lc_j["self_v_tnf"]),
                                   rtol=TOL, atol=TOL)


def test_teacher_forced_loss_matches_jax(slice_setup):
    """``VisionLanguageModule.forward``: prefix + text under a key-padding
    bias and the causal flag (the flash route here), logits over the text
    positions and the shifted loss."""
    rng = np.random.default_rng(5)
    ids = rng.integers(3, VOCAB, (2, 7)).astype(np.int32)
    ids[:, 0] = BOS
    mask = np.ones((2, 7), np.int32)
    mask[1, -3:] = 0
    images = slice_setup["images"]
    want = jax.jit(slice_setup["jmodel"].module.apply)(
        slice_setup["variables"], jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = slice_setup["tmodel"].module(_nchw(images), torch.from_numpy(ids),
                                           torch.from_numpy(mask))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("swiglu", [False, True])
def test_dinov2_tower_matches_jax(swiglu):
    """The DINOv2 tower alone (NHWC for JAX, NCHW for the port), with the
    plain GELU FFN and with SwiGLU, LayerScale away from identity."""
    arch = {k: v for k, v in DINO.items() if k != "model_type"}
    arch["use_swiglu_ffn"] = swiglu
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, IMAGE, IMAGE, 3)).astype(np.float32)
    jtower = JDinov2(**arch)
    params = jax.jit(jtower.init)(jax.random.key(1), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.normal(size=a.shape).astype(np.float32), params)
    want = np.asarray(jtower.apply({"params": params}, jnp.asarray(x)))
    ttower = TDinov2(**arch).eval()
    ttower.load_state_dict(vl_state_dict_from_jax({"params": params}), strict=True)
    with torch.no_grad():
        got = ttower(_nchw(x))
    assert got.shape == (2, 1 + (IMAGE // PATCH) ** 2, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_vl_builds_from_flagship_config():
    """config/VL/vl-dinov2-modernbert.yml builds the port's VisionLanguage
    through ``load_config`` and the registry (depth and width cut here by
    dotlist overrides and a tiny tower)."""
    cfg, _ = load_config("config/VL/vl-dinov2-modernbert.yml", [
        "model.decoder.hidden_size=128", "model.decoder.num_attention_heads=2",
        "model.decoder.num_hidden_layers=1", "model.decoder.intermediate_size=192",
        f"model.vision.image_size={IMAGE}",
    ])
    assert cfg.model.proto == "VisionLanguage" and cfg.dataset.seq.tokenizer_max_len == 100
    assert cfg.ensemblor.beam_width == 8 and cfg.ensemblor.batch_size == 16
    model = tregistry.build("model", cfg.model, vision_hf_config=DINO, vocab_size=VOCAB,
                            bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD, device="cpu")
    assert model.dec_config.dtype == torch.bfloat16
    assert model.dec_config.layer_norm_eps == 1e-5
    assert model.dec_config.max_position_embeddings == 2048
    assert model.module.num_image_tokens == 17 and model.module.drop_cls_token
    # f32 parameters, cast to bf16 at use (Flax's param_dtype)
    assert model.module.vision.model.patch_embed.weight.dtype == torch.float32
    with pytest.raises(RuntimeError, match="not in the local cache"):  # no download
        tregistry.build("model", cfg.model, vocab_size=VOCAB, device="cpu")
