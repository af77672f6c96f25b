"""Gradient checkpointing in the port (``blocks.transformer.run_layer``): a
stack built with ``gradient_checkpointing`` ``True`` (every layer
recomputed in the backward) or ``"dots"`` (its matmul outputs kept) gives
the gradients of the same stack without it, with hidden dropout on and the
masks drawn from an explicit ``torch.Generator``: the recompute replays the
masks of the forward, and the generator ends where it would have.

Held on the decoder stack (causal self-attention and cross-attention), the
text encoder, the ViT tower (post- and pre-LN) and the VisionLanguage
forward, on the CPU, float32. The recompute runs the same operations on the
same values, so the gradients are equal to 1e-6 of each tensor's largest
entry (the ``"dots"`` matmuls are saved, not recomputed). With dropout 0,
the VisionLanguage loss and gradients with checkpointing on are also held
against the JAX package's with the same mode.
"""

import dataclasses

import pytest
import torch

from vilmedic_torch.blocks.transformer import (
    TransformerConfig, TransformerDecoder, TransformerEncoder,
)
from vilmedic_torch.blocks.vision.vit import make_vit
from vilmedic_torch.models.vision_language import VisionLanguage

REL = 1e-6
MODES = [True, "dots"]
CFG = TransformerConfig(vocab_size=50, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=32, hidden_dropout_prob=0.2)


def _grads(build, run, mode):
    """Gradients and the generator's final state of ``run(module, gen)``'s
    loss, the module built with ``gradient_checkpointing=mode``, from the
    weights of seed 0."""
    torch.manual_seed(0)
    module = build(mode)
    gen = torch.Generator().manual_seed(7)
    run(module, gen).backward()
    return ({n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None},
            gen.get_state())


def _check(build, run, mode):
    want, want_state = _grads(build, run, False)
    got, got_state = _grads(build, run, mode)
    assert sorted(got) == sorted(want) and want
    for name, g in want.items():
        scale = max(float(g.abs().max()), 1e-30)
        torch.testing.assert_close(got[name], g, rtol=0, atol=REL * scale, msg=name)
    assert torch.equal(got_state, want_state)


def _ids(b=2, t=9, seed=1):
    return torch.randint(3, CFG.vocab_size, (b, t), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("mode", MODES, ids=["full", "dots"])
def test_decoder_stack(mode):
    mem = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(2))
    mask = torch.ones(2, 9, dtype=torch.long)
    mask[1, -3:] = 0

    def build(m):
        return TransformerDecoder(dataclasses.replace(CFG, gradient_checkpointing=m))

    def run(dec, gen):
        logits = dec(_ids(), mask, mem, torch.ones(2, 5, dtype=torch.long), mode="train",
                     train=True, generator=gen)
        return logits.square().mean()

    _check(build, run, mode)


@pytest.mark.parametrize("mode", MODES, ids=["full", "dots"])
def test_encoder_stack(mode):
    def build(m):
        return TransformerEncoder(dataclasses.replace(CFG, gradient_checkpointing=m))

    def run(enc, gen):
        return enc(_ids(), torch.ones(2, 9, dtype=torch.long), train=True,
                   generator=gen).square().mean()

    _check(build, run, mode)


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("mode", MODES, ids=["full", "dots"])
def test_vit_tower(mode, pre_ln):
    images = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))

    def build(m):
        return make_vit("vit", hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=64, patch_size=8, image_size=32,
                        hidden_dropout_prob=0.2, pre_ln=pre_ln, gradient_checkpointing=m)

    def run(vit, gen):
        return vit(images, train=True, generator=gen).square().mean()

    _check(build, run, mode)


@pytest.mark.parametrize("mode", MODES, ids=["full", "dots"])
def test_vision_language_forward(mode):
    images = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(4))
    mask = torch.ones(2, 9, dtype=torch.long)
    mask[0, -2:] = 0
    dino = dict(model_type="dinov2", hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, mlp_ratio=2.0, patch_size=8, image_size=16)

    def build(m):
        decoder = dict(proto=None, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                       intermediate_size=64, max_position_embeddings=32,
                       hidden_dropout_prob=0.2, gradient_checkpointing=m)
        model = VisionLanguage(decoder=decoder, vision={"vision_model_name": "tiny"},
                               vision_hf_config=dino, vocab_size=50, bos_token_id=0,
                               eos_token_id=2, pad_token_id=1, device="cpu")
        assert model.dec_config.gradient_checkpointing == m
        return model.module

    def run(module, gen):
        return module(images, _ids(), mask, train=True, generator=gen)["loss"]

    _check(build, run, mode)


def test_checkpointing_recomputes_in_the_backward(monkeypatch):
    """The layers really run again in the backward (twice in all with
    checkpointing, once without), and without gradients nothing is
    recomputed."""
    from vilmedic_torch.blocks import transformer

    calls = []
    real = transformer.EncoderLayer.forward

    def counting(self, *args, **kwargs):
        calls.append(1)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(transformer.EncoderLayer, "forward", counting)
    for mode, want in ((False, 2), (True, 4), ("dots", 4)):
        calls.clear()
        enc = TransformerEncoder(dataclasses.replace(CFG, gradient_checkpointing=mode))
        enc(_ids(), train=True, generator=torch.Generator()).sum().backward()
        assert len(calls) == want, mode
    calls.clear()
    with torch.no_grad():
        enc(_ids())
    assert len(calls) == 2


@pytest.mark.parametrize("mode", MODES, ids=["full", "dots"])
def test_vision_language_matches_jax(mode, monkeypatch):
    """``model.decoder.gradient_checkpointing`` in both packages (the JAX
    package's ``jax.checkpoint`` per layer, ``tests/test_vision_language.py``),
    dropout 0, the same weights and batch: the port's loss and every
    gradient agree with JAX's within 1e-4 of each tensor's largest entry
    (f32 sums in another order than XLA's)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vilmedic_torch.zoo.from_jax import vl_state_dict_from_jax
    from vilmedic_tpu.models import hf_compat
    from vilmedic_tpu.models.vision_language import VisionLanguage as JVL

    vocab, bos, eos, pad = 50, 0, 2, 1
    dino = dict(model_type="dinov2", hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                mlp_ratio=2.0, patch_size=8, image_size=16)
    decoder = dict(proto=None, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=64, max_position_embeddings=32, hidden_dropout_prob=0.0,
                   gradient_checkpointing=mode)
    vision = {"vision_model_name": "tiny/dinov2", "image_size": 16}

    class _DL:
        class dataset:
            class tokenizer:
                vocab_size, cls_token_id, sep_token_id, pad_token_id = vocab, bos, eos, pad

    rng = np.random.default_rng(5)
    ids = rng.integers(3, vocab, (2, 9)).astype(np.int32)
    ids[:, 0] = bos
    mask = np.ones((2, 9), np.int32)
    mask[1, -3:] = 0
    ids[mask == 0] = pad
    images = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    monkeypatch.setattr(hf_compat, "_resolve_hf_config", lambda name: dict(dino))
    jmodel = JVL(decoder=dict(decoder), vision=dict(vision), dl=_DL())
    assert jmodel.dec_config.gradient_checkpointing == mode
    jbatch = {"images": jnp.asarray(images), "input_ids": jnp.asarray(ids),
              "attention_mask": jnp.asarray(mask)}
    params = jax.jit(jmodel.init_variables)(jax.random.key(0), jbatch)["params"]

    def loss_fn(p):
        return jmodel.apply_train({"params": p}, jbatch, jax.random.key(1), train=True)[0]["loss"]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    model = VisionLanguage(decoder=dict(decoder), vision=dict(vision), vision_hf_config=dino,
                           vocab_size=vocab, bos_token_id=bos, eos_token_id=eos,
                           pad_token_id=pad, device="cpu")
    assert model.dec_config.gradient_checkpointing == mode
    model.module.load_state_dict(vl_state_dict_from_jax({"params": params}), strict=True)
    tbatch = {"images": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
              "input_ids": torch.from_numpy(ids).long(),
              "attention_mask": torch.from_numpy(mask).long()}
    loss_t = model.apply_train(tbatch)["loss"]
    loss_t.backward()
    torch.testing.assert_close(loss_t.item(), float(loss_j), rtol=1e-5, atol=0)
    want = vl_state_dict_from_jax({"params": jax.tree.map(np.asarray, grads_j)})
    got = {n: p.grad for n, p in model.module.named_parameters() if p.grad is not None}
    assert sorted(got) == sorted(n for n in want if not n.startswith("vision.")) and got
    for name, g in got.items():
        w = want[name]
        if name.endswith("self_attn.k.bias"):  # 0 up to rounding: softmax is shift-invariant
            scale = float(want[name[:-len("bias")] + "weight"].abs().max())
            assert max(float(g.abs().max()), float(w.abs().max())) <= 1e-4 * scale, name
            continue
        scale = max(float(w.abs().max()), 1e-30)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale, msg=name)
