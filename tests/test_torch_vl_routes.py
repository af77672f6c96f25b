"""The two VisionLanguage generate routes that follow from the beam width and
the vocabulary, in the PyTorch port against the JAX package's
``vl_evaluation``, on the CPU, float32:

- ``beam_width`` 1: greedy decoding over the plain generated cache, the
  plain head in f32, no forced EOS (no beam-cache kernel call);
- a vocabulary below 4096 (4000 here) at beam 4: the never-permuted kernel
  cache and its beam-cache kernel (heads of 64), the plain head in f32 and
  the two-stage candidates.

The model is the tiny VL slice of ``test_torch_vl_permute.py`` with a
kernel-route decoder (hidden 128, 2 heads of 64). The JAX side is
``vl_evaluation`` itself (unsharded), so its own routing picks the route;
a stand-in tokenizer spells each generated id out, and the port's sequences
must equal JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vilmedic_torch.blocks.transformer as ttransformer
from vilmedic_torch.models.vision_language import VisionLanguage as TVL
from vilmedic_torch.models.vision_language import make_vl_generate_fn
from vilmedic_torch.zoo.from_jax import vl_state_dict_from_jax
from vilmedic_tpu.models import hf_compat
from vilmedic_tpu.models import vision_language as jvl

MAX_LEN, BOS, EOS, PAD = 8, 0, 2, 1
IMAGE, PATCH = 32, 8
DINO = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            mlp_ratio=4.0, patch_size=PATCH, image_size=IMAGE, layer_norm_eps=1e-6,
            use_swiglu_ffn=False, hidden_act="gelu")
DECODER = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=192, max_position_embeddings=64, layer_norm_eps=1e-5,
               hidden_act="gelu", hidden_dropout_prob=0.0)
VISION = {"vision_model_name": "tiny/dinov2", "image_size": IMAGE}
# route: (beam width, vocabulary, EOS bias added to the head); the bias lets
# one greedy row end early and the other run to max_len
ROUTES = {"greedy": (1, 4500, 10.0), "small_vocab": (4, 4000, 0.0)}


class _Tokenizer:
    """Spells out every id, special ones included, so the decoded strings
    carry the whole sequence."""

    def __init__(self, vocab):
        self.vocab_size = vocab
        self.cls_token_id, self.sep_token_id, self.pad_token_id = BOS, EOS, PAD

    def decode(self, ids, **kwargs):
        return " ".join(str(int(i)) for i in ids)


class _DL:
    def __init__(self, vocab, images):
        self.batch_size = images.shape[0]
        self.dataset = type("Dataset", (), {"tokenizer": _Tokenizer(vocab),
                                            "tokenizer_max_len": MAX_LEN})()
        self.batches = [{"images": images,
                         "input_ids": np.zeros((images.shape[0], MAX_LEN), np.int32)}]

    def __iter__(self):
        return iter(self.batches)


def _variables(jmodel, rng, eos_bias: float):
    batch = {"images": jnp.zeros((2, IMAGE, IMAGE, 3)),
             "input_ids": jnp.zeros((2, 4), jnp.int32),
             "attention_mask": jnp.ones((2, 4), jnp.int32)}
    variables = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32),
        variables["params"])
    # a wider head whose EOS logit swings widest: sequences finish early
    params["lm_head"]["kernel"] *= 2.0
    params["lm_head"]["kernel"][:, EOS] *= 3.0
    params["lm_head"]["bias"][EOS] += eos_bias
    return {"params": params}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route_setup(request):
    beam, vocab, eos_bias = ROUTES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hf_compat, "_resolve_hf_config", lambda name: dict(DINO))
        rng = np.random.default_rng(1)
        dl = _DL(vocab, rng.normal(size=(2, IMAGE, IMAGE, 3)).astype(np.float32))
        jmodel = jvl.VisionLanguage(decoder=dict(DECODER), vision=dict(VISION), dl=dl,
                                    dtype="float32")
        jmodel.variables = _variables(jmodel, rng, eos_bias)
        out = jvl.vl_evaluation([jmodel], {"beam_width": beam, "shard_eval": False}, dl)
        want = np.array([[int(t) for t in h.split()] for h in out["hyps"]])
    tmodel = TVL(decoder=dict(DECODER), vision=dict(VISION), vision_hf_config=DINO,
                 vocab_size=vocab, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
                 dtype="float32", device="cpu")
    tmodel.module.load_state_dict(vl_state_dict_from_jax(jmodel.variables), strict=True)
    images = torch.from_numpy(dl.batches[0]["images"]).permute(0, 3, 1, 2).contiguous()
    yield dict(route=request.param, beam=beam, tmodel=tmodel, images=images, want=want)


def _generate(setup, monkeypatch):
    """The port's sequences, counting beam-cache kernel calls."""
    calls = []
    kernel = ttransformer.fused_beam_cache_attention

    def counted(*args, **kwargs):
        calls.append(args[2].shape)
        return kernel(*args, **kwargs)

    monkeypatch.setattr(ttransformer, "fused_beam_cache_attention", counted)
    generate = make_vl_generate_fn(setup["tmodel"], setup["beam"], MAX_LEN, BOS, EOS, PAD)
    return generate(setup["images"]), calls


def test_route_sequences_match_jax(route_setup, monkeypatch):
    """Sequences exactly ``vl_evaluation``'s on the route JAX picks."""
    result, _ = _generate(route_setup, monkeypatch)
    assert result.sequences.shape == (2, MAX_LEN)
    np.testing.assert_array_equal(result.sequences.numpy(), route_setup["want"])


def test_route_exercises_early_finish(route_setup):
    """The JAX reference itself: a sequence ends before max_len, and not
    every sequence at the first step."""
    want = route_setup["want"]
    assert (want[:, :-1] == EOS).any() and (want[:, 1] != EOS).any()


def test_route_takes_the_kernel_cache_only_under_beam_search(route_setup, monkeypatch):
    """Greedy decoding never calls the beam-cache kernel; the small-vocab
    beam search calls it once per layer per step, over B * beam rows."""
    result, calls = _generate(route_setup, monkeypatch)
    if route_setup["route"] == "greedy":
        assert calls == [] and result.steps > 0
    else:
        assert len(calls) == 2 * result.steps
        assert all(shape[0] == 2 * route_setup["beam"] for shape in calls)
