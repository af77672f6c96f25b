"""The VisionLanguage permute route of the PyTorch port against the JAX
package, on the CPU, float32.

A decoder whose head dim the beam-cache kernel is not built for (hidden 32,
2 heads of 16; 32 % 128 != 0, so JAX's ``vl_evaluation`` computes
``kernel_ok`` false as well) keeps its generated cache in the plain
(N, T, H, D) layout, which beam search reorders every step, and attends over
the beam-shared prefix and that cache in one softmax (the non-kernel branch
of ``prefix_decode``). The rest is the tiny VL slice of
``test_torch_vl_slice.py`` (DINOv2 width 128, 32² images, patch 8, CLS
dropped, 2-layer LM), at beam 8; the prefix (17 tokens) stays below
``FLASH_MIN_LEN``, so attention outside the decode is dense on both sides.
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
from vilmedic_torch.blocks.transformer import prefix_operands
from vilmedic_torch.models.evaluation_nlg import kernel_route_ok
from vilmedic_torch.models.vision_language import VisionLanguage as TVL
from vilmedic_torch.models.vision_language import make_vl_generate_fn
from vilmedic_torch.ops.flash_attention import flash_attention_reference
from vilmedic_torch.zoo.from_jax import vl_state_dict_from_jax
from vilmedic_tpu.blocks import transformer as jtransformer
from vilmedic_tpu.blocks.transformer import MultiHeadAttention as JMHA
from vilmedic_tpu.blocks.transformer import TransformerConfig as JConfig
from vilmedic_tpu.blocks.transformer import make_blocked_head_weights
from vilmedic_tpu.decoding import beam_search as jax_beam_search
from vilmedic_tpu.decoding import tile_for_beams
from vilmedic_tpu.models import hf_compat
from vilmedic_tpu.models import vision_language as jvl

VOCAB, BEAM, MAX_LEN, BOS, EOS, PAD = 4500, 8, 8, 0, 2, 1
IMAGE, PATCH = 32, 8
DINO = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            mlp_ratio=4.0, patch_size=PATCH, image_size=IMAGE, layer_norm_eps=1e-6,
            use_swiglu_ffn=False, hidden_act="gelu")
DECODER = dict(proto=None, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=64, max_position_embeddings=64, layer_norm_eps=1e-5,
               hidden_act="gelu", hidden_dropout_prob=0.0)
VISION = {"vision_model_name": "tiny/dinov2", "image_size": IMAGE}
# one layer's output: f32 sums in another order
TOL = 1e-5
# beam scores are sums of f32 log-probs computed in another order
TOL_SCORE = 1e-4


class _DL:
    class dataset:
        class tokenizer:
            vocab_size = VOCAB
            cls_token_id = BOS
            sep_token_id = EOS
            pad_token_id = PAD


def _torch_model(decoder, variables=None):
    model = TVL(decoder=dict(decoder), vision=dict(VISION), vision_hf_config=DINO,
                vocab_size=VOCAB, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
                dtype="float32", device="cpu")
    if variables is not None:
        model.module.load_state_dict(vl_state_dict_from_jax(variables), strict=True)
    return model


def _jax_generate(module, variables, images, quantize_prefix: bool):
    """``vl_evaluation``'s generate where ``kernel_ok`` is false: the plain
    generated cache tiled for the beams and permuted by ``beam_search``."""
    b = images.shape[0]
    cache, prefix_kv, p = module.apply(variables, images, MAX_LEN,
                                       quantize_prefix=quantize_prefix,
                                       method=jvl.VisionLanguageModule.prefill)
    cache = tile_for_beams(cache, BEAM)
    blocked = make_blocked_head_weights(variables["params"], jnp.float32)

    def step_fn(tokens, cache, index, anc=None):
        return module.apply(variables, tokens, cache, prefix_kv, index, p, blocked_head=blocked,
                            ancestry=anc, method=jvl.VisionLanguageModule.decode_step)

    res = jax_beam_search(step_fn, cache, b, BEAM, MAX_LEN, BOS, EOS, PAD, 1.0,
                          blocked_vocab=VOCAB, ancestry=False)
    return res.sequences, res.scores


@pytest.fixture(scope="module")
def permute_setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hf_compat, "_resolve_hf_config", lambda name: dict(DINO))
        rng = np.random.default_rng(0)
        jmodel = jvl.VisionLanguage(decoder=dict(DECODER), vision=dict(VISION), dl=_DL(),
                                    dtype="float32")
        batch = {"images": jnp.zeros((2, IMAGE, IMAGE, 3)),
                 "input_ids": jnp.zeros((2, 4), jnp.int32),
                 "attention_mask": jnp.ones((2, 4), jnp.int32)}
        variables = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
        params = jax.tree.map(
            lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32),
            variables["params"])
        # a wider head whose EOS logit swings widest: hypotheses finish early
        params["lm_head"]["kernel"] *= 2.0
        params["lm_head"]["kernel"][:, EOS] *= 3.0
        variables = {"params": params}
        images = rng.normal(size=(2, IMAGE, IMAGE, 3)).astype(np.float32)
        want = {}
        for quantize in (False, True):
            seqs, scores = jax.jit(lambda v, im: _jax_generate(jmodel.module, v, im, quantize))(
                variables, jnp.asarray(images))
            want[quantize] = (np.asarray(seqs), np.asarray(scores))
        yield dict(tmodel=_torch_model(DECODER, variables), images=images, want=want)


def _nchw(images):
    return torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("prefix_kv_dtype", [None, "int8"])
def test_permute_sequences_match_jax(permute_setup, prefix_kv_dtype, monkeypatch):
    """Beam-8 sequences exactly JAX's permute path, scores within 1e-4,
    with the compute-dtype and the int8 prefix; the beam-cache kernel is
    never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("the permute route called the beam-cache kernel")

    monkeypatch.setattr(ttransformer, "fused_beam_cache_attention", refuse)
    generate = make_vl_generate_fn(permute_setup["tmodel"], BEAM, MAX_LEN, BOS, EOS, PAD, 1.0,
                                   prefix_kv_dtype=prefix_kv_dtype)
    result = generate(_nchw(permute_setup["images"]))
    seqs_j, scores_j = permute_setup["want"][prefix_kv_dtype == "int8"]
    assert result.sequences.shape == (2, MAX_LEN)
    np.testing.assert_array_equal(result.sequences.numpy(), seqs_j)
    np.testing.assert_allclose(result.scores.numpy(), scores_j, rtol=TOL_SCORE, atol=TOL_SCORE)


def test_permute_slice_exercises_early_finish(permute_setup):
    """The JAX reference itself: a hypothesis ends before max_len, so the
    finished pool and the reorder of finished beams take part."""
    assert (permute_setup["want"][False][0][:, :-1] == EOS).any()


def test_kernel_features_are_ignored_on_the_permute_route(permute_setup):
    """``gen_kv_dtype="int8"`` and ``fused_prefix=True`` describe the kernel
    cache; on the permute route they change nothing, as in JAX."""
    images = _nchw(permute_setup["images"])
    plain = make_vl_generate_fn(permute_setup["tmodel"], BEAM, MAX_LEN, BOS, EOS, PAD)(images)
    for kwargs in (dict(gen_kv_dtype="int8"), dict(fused_prefix=True)):
        got = make_vl_generate_fn(permute_setup["tmodel"], BEAM, MAX_LEN, BOS, EOS, PAD,
                                  **kwargs)(images)
        assert torch.equal(got.sequences, plain.sequences)
        assert torch.equal(got.scores, plain.scores)


@pytest.mark.parametrize("hidden,kernel", [(32, False), (128, True), (256, True)])
def test_route_follows_head_dim(hidden, kernel):
    """Heads of 16: the permute route; heads of 64 and 128: the kernel route.
    No caller option chooses it."""
    model = _torch_model(dict(DECODER, hidden_size=hidden, intermediate_size=2 * hidden))
    assert model.dec_config.head_dim == hidden // 2
    assert kernel_route_ok([model], BEAM) is kernel


def _plain_layer(rng, int8_prefix: bool, index: int):
    """``prefix_decode`` of one f32 layer (hidden 32, 2 heads of 16) over a
    plain filled cache, JAX's non-kernel branch and the port's, on the same
    weights and prefix. Returns (out_j, out_t, new cache JAX, the port's)."""
    b, p, t = 2, 11, 6
    n = b * BEAM
    params = {name: {"kernel": (rng.normal(size=(32, 32)) * 0.3).astype(np.float32),
                     "bias": (rng.normal(size=32) * 0.1).astype(np.float32)}
              for name in ("q", "k", "v", "o")}
    mha_t = TMHA(TConfig(hidden_size=32, num_attention_heads=2, dtype=torch.float32))
    mha_t.load_state_dict({f"{name}.{leaf}": torch.from_numpy(
        w["kernel"].T.copy() if leaf == "weight" else w["bias"])
        for name, w in params.items() for leaf in ("weight", "bias")})
    x = rng.normal(size=(n, 1, 32)).astype(np.float32)
    pk, pv = (rng.normal(size=(b, p, 2, 16)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.normal(size=(n, t, 2, 16)).astype(np.float32) for _ in range(2))
    if int8_prefix:
        pkv_j = jtransformer.quantize_kv(jnp.asarray(pk)) + jtransformer.quantize_kv(
            jnp.asarray(pv))
        pkv_t = tuple(torch.from_numpy(np.array(a)) for a in pkv_j)
    else:
        pkv_j = (jnp.asarray(pk), jnp.asarray(pv))
        pkv_t = (torch.from_numpy(pk), torch.from_numpy(pv))
    out_j, new_j = JMHA(JConfig(hidden_size=32, num_attention_heads=2)).apply(
        {"params": params}, jnp.asarray(x), pkv_j, {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(index), method=JMHA.prefix_decode)
    cache_t = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    with torch.no_grad():
        out_t = mha_t.prefix_decode(torch.from_numpy(x), prefix_operands([pkv_t])[0], cache_t,
                                    index, None)
    return np.asarray(out_j), out_t.numpy(), new_j, cache_t


@pytest.mark.parametrize("int8_prefix", [False, True])
@pytest.mark.parametrize("index", [0, 4])
def test_plain_prefix_decode_matches_jax(int8_prefix, index):
    """One step of the non-kernel branch within 1e-5 of JAX's (the int8
    prefix's products in bf16 with the scales factored out), and the step's
    K/V written at the index, bitwise JAX's."""
    rng = np.random.default_rng(10 * int8_prefix + index)
    out_j, out_t, new_j, cache_t = _plain_layer(rng, int8_prefix, index)
    assert out_t.shape == (2 * BEAM, 1, 32)
    np.testing.assert_allclose(out_t, out_j, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache_t[0].numpy(), np.asarray(new_j["k"]))
    np.testing.assert_array_equal(cache_t[1].numpy(), np.asarray(new_j["v"]))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_length_attention_with_heads_of_16_takes_flash(causal, monkeypatch):
    """At a flash length, heads of 16 (the permute route's decoder) go to
    the flash route in the port as in the JAX package (8 heads: H * D 128,
    JAX's head-packed v2 kernel); on CPU tensors that is the kernels' plain
    version, within f32 rounding of JAX's flash."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return flash_attention_reference(*args, **kwargs)

    monkeypatch.setattr(jattn, "FLASH_MIN_LEN", 32)
    monkeypatch.setattr(tattn, "FLASH_MIN_LEN", 32)
    monkeypatch.setattr(tattn, "flash_attention", counted)
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 40, 8, 16)).astype(np.float32) for _ in range(3))
    key_mask = np.ones((2, 40), np.int32)
    key_mask[1, -5:] = 0
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jattn.make_attention_bias(key_mask=jnp.asarray(key_mask)), causal=causal)
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=tattn.make_attention_bias(key_mask=torch.from_numpy(key_mask)), causal=causal)
    assert calls == [(2, 40, 8, 16)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
