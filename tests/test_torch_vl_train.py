"""The VisionLanguage training path of the PyTorch port against the JAX package,
on the CPU.

A tiny VisionLanguage (DINOv2 tower of width 128 over 32² images with patch 8,
CLS dropped; 2-layer prefix LM, hidden 128, 2 heads of 64) takes one training
step in both packages from the same weights and batch: the loss and the
gradient of every trainable tensor against ``jax.value_and_grad`` of the JAX
``VisionLanguage.apply_train(train=True)``, then one AdamW update against
optax (``create_optimizer`` + ``gated_update``). ``FLASH_MIN_LEN_TRAIN`` is set
low in both packages, so the LM's causal self-attention over 17 + 7 tokens
takes the flash route with its backward on both sides (JAX: the Pallas
kernels in interpret mode; the port: ``FlashAttentionFunction`` with the
plain versions). Dropout probabilities are 0 in both packages, since the
port's masks cannot equal JAX's threefry masks; dropout itself is tested
alone.

The trainer's semantics (gradient accumulation, the non-finite gates, the
learning-rate sequence) are held against the JAX package's optimizer chain
and ``TrainingScheduler``, driven as the JAX trainer drives them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vilmedic_torch.ops.attention as tattn
import vilmedic_tpu.ops.attention as jattn
from vilmedic_torch.blocks.transformer import dropout
from vilmedic_torch.config.config import Config, executor_config, load_config
from vilmedic_torch.executors import trainor as ttrainor
from vilmedic_torch.executors.train_state import create_optimizer, gated_update
from vilmedic_torch.executors.trainor import Trainor
from vilmedic_torch.models.vision_language import VisionLanguage as TVL
from vilmedic_torch.zoo.from_jax import vl_state_dict_from_jax
from vilmedic_tpu.executors import train_state as jts
from vilmedic_tpu.executors.scheduler import TrainingScheduler as JScheduler
from vilmedic_tpu.models import hf_compat
from vilmedic_tpu.models.vision_language import VisionLanguage as JVL

VOCAB, BOS, EOS, PAD = 4500, 0, 2, 1
IMAGE, PATCH, TEXT = 32, 8, 7
DINO = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            mlp_ratio=4.0, patch_size=PATCH, image_size=IMAGE, layer_norm_eps=1e-6,
            use_swiglu_ffn=False, hidden_act="gelu")
DECODER = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=192, max_position_embeddings=64, layer_norm_eps=1e-5,
               hidden_act="gelu", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
VISION = {"vision_model_name": "tiny/dinov2", "image_size": IMAGE}
LR = 5e-5  # the VisionLanguage config's learning rate
# the LM's 24-token training attention takes flash; the tower's stays dense
FLASH_MIN_LEN_TRAIN = 16
# f32: the loss and gradients are sums of f32 products in another order than
# XLA's; relative to each tensor's largest entry
TOL_F32 = 1e-4
# bf16: both packages round activations to bf16 at the same points, from f32
# values that differ in the last bits, so a rounded value lands one bf16 step
# (2^-8 relative) apart now and then; relative to each tensor's largest entry
TOL_BF16_GRAD = 5e-2
TOL_BF16_LOSS = 1e-2
# One AdamW step from zero moments moves each entry by lr * g / (|g| + eps)
# (+ decay), about lr * sign(g). An entry whose gradient is within a few eps
# of 0 may move by less, or the other way, in one package than in the other,
# so the step is held entry by entry at a tenth of lr, and all but a small
# share of the entries must be within it (the rest within 2 lr).
STEP_TOL = 0.1 * LR
STEP_SHARE = {"float32": 1e-3, "bfloat16": 2e-2}


class _DL:
    class dataset:
        class tokenizer:
            vocab_size = VOCAB
            cls_token_id = BOS
            sep_token_id = EOS
            pad_token_id = PAD


def _batch(seed: int, b: int = 2):
    """Float NHWC images, ids (BOS first) and a mask with a padded tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, VOCAB, (b, TEXT)).astype(np.int32)
    ids[:, 0] = BOS
    mask = np.ones((b, TEXT), np.int32)
    mask[-1, -3:] = 0
    ids[mask == 0] = PAD
    images = rng.normal(size=(b, IMAGE, IMAGE, 3)).astype(np.float32)
    return {"images": images, "input_ids": ids, "attention_mask": mask}


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous(),
            "input_ids": torch.from_numpy(batch["input_ids"]).long(),
            "attention_mask": torch.from_numpy(batch["attention_mask"]).long()}


def _jax_params(mp, dtype: str, seed: int = 0):
    mp.setattr(hf_compat, "_resolve_hf_config", lambda name: dict(DINO))
    jmodel = JVL(decoder=dict(DECODER), vision=dict(VISION), dl=_DL(), dtype=dtype)
    b = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    variables = jax.jit(jmodel.init_variables)(jax.random.key(seed), b)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=x.shape).astype(np.float32),
        variables["params"])
    return jmodel, params


def _torch_model(params, dtype: str):
    model = TVL(decoder=dict(DECODER), vision=dict(VISION), vision_hf_config=DINO,
                vocab_size=VOCAB, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
                dtype=dtype, device="cpu")
    model.module.load_state_dict(vl_state_dict_from_jax({"params": params}), strict=True)
    return model


def _jax_step(jmodel, params, batch, lr=LR):
    """Loss, gradients and one AdamW update as the JAX trainer takes them."""

    def loss_fn(p):
        out, _ = jmodel.apply_train({"params": p}, batch, jax.random.key(1), train=True)
        return out["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jts.create_optimizer("adamw", {"lr": lr}, None, frozen_prefixes=jmodel.frozen_prefixes)
    new_params, _ = jax.jit(lambda p, g, l: jts.gated_update(tx, p, tx.init(p), g, lr, l))(
        params, grads, loss)
    return float(loss), grads, new_params


def _np(tree):
    return {k: v.float().numpy() for k, v in vl_state_dict_from_jax(
        {"params": jax.tree.map(lambda x: np.asarray(x, np.float32), tree)}).items()}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def train_step(request):
    """One training step of the tiny model in both packages."""
    dtype = request.param
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jattn, tattn):
            mp.setattr(mod, "FLASH_MIN_LEN_TRAIN", FLASH_MIN_LEN_TRAIN)
        jmodel, params = _jax_params(mp, dtype)
        batch = _batch(1)
        loss_j, grads_j, new_j = _jax_step(jmodel, params, {k: jnp.asarray(v)
                                                           for k, v in batch.items()})
        tmodel = _torch_model(params, dtype)
        calls = []
        real_flash = tattn.flash_attention

        def counting_flash(*args, **kwargs):
            out = real_flash(*args, **kwargs)
            calls.append(type(out.grad_fn).__name__)
            return out

        mp.setattr(tattn, "flash_attention", counting_flash)
        out = tmodel.apply_train(_torch_batch(batch))
        out["loss"].backward()
        grads_t = {n: None if p.grad is None else p.grad.clone()
                   for n, p in tmodel.module.named_parameters()}
        tx = create_optimizer("adamw", {"lr": LR}, None, tmodel.frozen_prefixes,
                              named_parameters=tmodel.module.named_parameters())
        before = {n: p.detach().clone() for n, p in tmodel.module.named_parameters()}
        assert gated_update(tx, LR, out["loss"].detach())
        yield dict(dtype=dtype, loss_j=loss_j, grads_j=_np(grads_j), new_j=_np(new_j),
                   old=_np(params), loss_t=out["loss"].item(), grads_t=grads_t, tx=tx,
                   before=before, tmodel=tmodel, calls=calls)


def test_training_forward_takes_the_flash_backward(train_step):
    """Both LM layers route their causal attention through
    ``FlashAttentionFunction`` (the tower runs without a graph)."""
    assert train_step["calls"] == ["FlashAttentionFunctionBackward"] * 2


def test_loss_matches_jax(train_step):
    tol = TOL_F32 if train_step["dtype"] == "float32" else TOL_BF16_LOSS
    np.testing.assert_allclose(train_step["loss_t"], train_step["loss_j"], rtol=tol)


def test_every_trainable_gradient_matches_jax(train_step):
    tol = TOL_F32 if train_step["dtype"] == "float32" else TOL_BF16_GRAD
    grads_t, grads_j = train_step["grads_t"], train_step["grads_j"]
    assert set(grads_t) == set(grads_j)
    trainable = [n for n in grads_t if not n.startswith("vision.")]
    assert len(trainable) > 20
    for name in trainable:
        got, want = grads_t[name].float().numpy(), grads_j[name]
        if name.endswith("self_attn.k.bias"):
            # exactly 0 in exact arithmetic (a key bias adds one constant to
            # a whole softmax row), so both sides hold rounding noise: held
            # against the scale of the same projection's weight gradient
            scale = np.abs(grads_j[name[:-len("bias")] + "weight"]).max()
            assert max(np.abs(got).max(), np.abs(want).max()) <= tol * scale, name
            continue
        scale = np.abs(want).max()
        assert scale > 0, name
        err = np.abs(got - want).max()
        assert err <= tol * scale, f"{name}: max|err| {err:.3e} vs {tol * scale:.3e}"


def test_tower_gets_no_gradient_and_no_optimizer_state(train_step):
    """JAX stops the gradient at the tower (its gradients are zeros) and
    leaves it out of the optimizer; the port's tower takes no gradient and
    has no optimizer state."""
    tmodel, tx = train_step["tmodel"], train_step["tx"]
    assert tmodel.frozen_prefixes == ("vision",)
    vision = {n for n in train_step["grads_t"] if n.startswith("vision.")}
    assert vision and all(train_step["grads_t"][n] is None for n in vision)
    assert all(not np.any(train_step["grads_j"][n]) for n in vision)
    assert not any(n.startswith("vision.") for n in tx.names)
    frozen = {id(p) for n, p in tmodel.module.named_parameters() if n.startswith("vision.")}
    assert not any(id(p) in frozen for p in tx.optimizer.state)
    assert len(tx.optimizer.state) == len(tx.names)
    for n, p in tmodel.module.named_parameters():
        if n.startswith("vision."):
            assert not p.requires_grad
            assert torch.equal(p, train_step["before"][n])


def _step_mismatch(new_t, new_j, old):
    """Share of entries whose AdamW step differs from optax's by more than
    ``STEP_TOL``, and the largest difference."""
    bad = total = 0
    worst = 0.0
    for name, want in new_j.items():
        if name.startswith("vision."):
            continue
        diff = np.abs((new_t[name] - old[name]) - (want - old[name]))
        bad += int((diff > STEP_TOL).sum())
        total += diff.size
        worst = max(worst, float(diff.max()))
    return bad / total, worst


def test_adamw_update_matches_optax(train_step):
    """Every trainable parameter after one AdamW step at lr 5e-5 against
    optax's, starting from the same f32 weights; the trainable parameters
    stay f32 at either compute dtype (the frozen tower may hold its weights
    in the compute dtype)."""
    tmodel = train_step["tmodel"]
    assert all(p.dtype == torch.float32 for n, p in tmodel.module.named_parameters()
               if not n.startswith("vision."))
    new_t = {n: p.detach().float().numpy() for n, p in tmodel.module.named_parameters()}
    share, worst = _step_mismatch(new_t, train_step["new_j"], train_step["old"])
    assert share <= STEP_SHARE[train_step["dtype"]], share
    assert worst <= 2 * LR, worst


def test_bf16_parameters_fail_the_adamw_check(monkeypatch):
    """The repair the f32 parameters make: the same step with the LM's
    parameters held in bf16 (as the port stored them before) rounds most of
    the lr-sized updates away, and fails the check the f32 model passes."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_MIN_LEN_TRAIN", FLASH_MIN_LEN_TRAIN)
    jmodel, params = _jax_params(monkeypatch, "bfloat16")
    batch = _batch(1)
    _, _, new_j = _jax_step(jmodel, params, {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = _torch_model(params, "bfloat16")
    module = tmodel.module
    for name, p in module.named_parameters():
        if not name.startswith("vision.") and p.dim() == 2:  # the Linear and Embedding weights
            p.data = p.data.bfloat16()
    out = tmodel.apply_train(_torch_batch(batch))
    out["loss"].backward()
    tx = create_optimizer("adamw", {"lr": LR}, None, tmodel.frozen_prefixes,
                          named_parameters=module.named_parameters())
    assert gated_update(tx, LR, out["loss"].detach())
    new_t = {n: p.detach().float().numpy() for n, p in module.named_parameters()}
    share, _ = _step_mismatch(new_t, _np(new_j), _np(params))
    assert share > 10 * STEP_SHARE["bfloat16"], share


def test_serving_operands_are_bitwise_those_of_compute_dtype_parameters(monkeypatch):
    """The f32 parameters change no serving value: the prefill's prefix
    operands and the padded LM head equal, bit for bit, those of the same
    model with its Linear and Embedding parameters stored in bf16 (the
    layout before the repair)."""
    import copy

    from vilmedic_torch.blocks.transformer import (
        Embedding, Linear, make_blocked_head_weights, prefix_operands,
    )

    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_MIN_LEN", 16)
    _, params = _jax_params(monkeypatch, "bfloat16")
    new = _torch_model(params, "bfloat16").module
    old = copy.deepcopy(new)
    for m in old.modules():
        if isinstance(m, (Linear, Embedding)):
            for p in m.parameters():
                p.data = p.data.bfloat16()
    images = _torch_batch(_batch(3))["images"]
    with torch.inference_mode():
        outs = [(prefix_operands(m.prefill(images, TEXT)[1]), make_blocked_head_weights(m))
                for m in (new, old)]
    (kv_new, head_new), (kv_old, head_old) = outs
    for a, b in zip(torch.utils._pytree.tree_leaves(kv_new + head_new),
                    torch.utils._pytree.tree_leaves(kv_old + head_old)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_linear_cast_is_kept_only_while_the_parameters_hold():
    """Without grad, ``Linear`` reuses its compute-dtype copy until a
    parameter changes (an in-place update, an optimizer step, a state-dict
    load); with grad it casts at every use and its f32 parameters take the
    gradient."""
    from vilmedic_torch.blocks.transformer import Linear

    lin = Linear(8, 4, torch.bfloat16)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))

    def plain():
        return torch.nn.functional.linear(x.bfloat16(), lin.weight.bfloat16(),
                                          lin.bias.bfloat16())

    with torch.no_grad():
        y = lin(x)
        cached = lin._cast[1][0]
        assert torch.equal(lin(x), y) and lin._cast[1][0] is cached
        lin.weight.add_(0.5)
        assert torch.equal(lin(x), plain()) and lin._cast[1][0] is not cached
    lin(x).float().sum().backward()
    assert lin.weight.grad.dtype == torch.float32 and lin.bias.grad.abs().sum() > 0
    torch.optim.AdamW(lin.parameters(), lr=1e-2).step()
    with torch.no_grad():
        assert torch.equal(lin(x), plain())
        lin.load_state_dict({"weight": torch.zeros(4, 8), "bias": torch.ones(4)})
        assert torch.equal(lin(x), torch.ones(3, 4, dtype=torch.bfloat16))


# ------------------------------------------------------------------ dropout


def test_dropout_keeps_one_minus_p_and_scales():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.1, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 3e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9), rtol=0, atol=0)
    yb = dropout(x.bfloat16(), 0.25, gen)
    assert yb.dtype == torch.bfloat16
    assert set(yb.unique().tolist()) == {0.0, float(torch.tensor(1 / 0.75).bfloat16())}


def test_dropout_eval_is_identity_and_seeded():
    x = torch.randn(1000)
    assert dropout(x, 0.1, None) is x
    assert dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    a = dropout(x, 0.3, torch.Generator().manual_seed(7))
    b = dropout(x, 0.3, torch.Generator().manual_seed(7))
    c = dropout(x, 0.3, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_model_dropout_sits_where_jax_has_it(monkeypatch):
    """With the config's 0.1 the training forward draws masks (a seeded
    generator repeats its loss; another seed gives another) at the
    embeddings, each FFN output and each attention residual, and the eval
    forward draws none."""
    jmodel, params = _jax_params(monkeypatch, "float32")
    decoder = dict(DECODER, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    tmodel = TVL(decoder=decoder, vision=dict(VISION), vision_hf_config=DINO, vocab_size=VOCAB,
                 bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD, device="cpu")
    assert tmodel.dec_config.hidden_dropout_prob == 0.1
    assert tmodel.dec_config.attention_probs_dropout_prob == 0.1
    tmodel.module.load_state_dict(vl_state_dict_from_jax({"params": params}), strict=True)
    batch = _torch_batch(_batch(2))
    draws = []
    real_rand = torch.rand

    def counting_rand(*args, **kwargs):
        draws.append(tuple(args[0]))
        return real_rand(*args, **kwargs)

    monkeypatch.setattr(torch, "rand", counting_rand)
    with torch.no_grad():
        l1 = tmodel.apply_train(batch, torch.Generator().manual_seed(3))["loss"]
        n_train = len(draws)
        l2 = tmodel.apply_train(batch, torch.Generator().manual_seed(3))["loss"]
        l3 = tmodel.apply_train(batch, torch.Generator().manual_seed(4))["loss"]
        del draws[:]
        tmodel.module(batch["images"], batch["input_ids"], batch["attention_mask"])
    assert n_train == 1 + 2 * DECODER["num_hidden_layers"]
    assert draws == []
    assert torch.equal(l1, l2) and not torch.equal(l1, l3)


# ------------------------------------------------------------------ trainer


def _tiny_config(grad_accu: int, warmup_ratio: float, epochs: int = 1, lr: float = LR):
    """The VisionLanguage config's ``trainor:`` view, cut to the tiny model."""
    cfg, _ = load_config("config/VL/vl-dinov2-modernbert.yml", [
        "model.dtype=float32", "model.decoder.hidden_size=128",
        "model.decoder.num_attention_heads=2", "model.decoder.num_hidden_layers=2",
        "model.decoder.intermediate_size=192", "model.decoder.max_position_embeddings=64",
        "model.decoder.hidden_dropout_prob=0.0", f"model.vision.image_size={IMAGE}",
        f"trainor.grad_accu={grad_accu}", f"trainor.epochs={epochs}",
        f"trainor.lr_decay_params.warmup_ratio={warmup_ratio}", f"trainor.optim_params.lr={lr}",
    ])
    return executor_config(cfg, "trainor")


class _Loader(list):
    """A list of batches with a length, what the trainer takes until the
    data loaders are ported."""


def _trainor(grad_accu, warmup_ratio, batches, params, lr=LR):
    config = _tiny_config(grad_accu, warmup_ratio, lr=lr)
    tr = Trainor(config, seed=0, loader=_Loader(_torch_batch(b) for b in batches), device="cpu",
                 model_kwargs=dict(vision_hf_config=DINO, vocab_size=VOCAB, bos_token_id=BOS,
                                   eos_token_id=EOS, pad_token_id=PAD))
    tr.model.module.load_state_dict(vl_state_dict_from_jax({"params": params}), strict=True)
    return tr


def test_trainor_accumulates_and_applies_the_tail_as_jax(monkeypatch):
    """grad_accu 2 over 5 microbatches under the VL config's warmup: the port's
    ``Trainor.train_epoch`` against the JAX trainer's loop (summed
    gradients, an update every 2 microbatches gated on the boundary loss, the
    partial tail applied at the end, the lr read from ``TrainingScheduler``
    and stepped once per update) written out with the JAX package's
    ``value_and_grad``, optax chain and scheduler."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_MIN_LEN_TRAIN", FLASH_MIN_LEN_TRAIN)
    jmodel, params = _jax_params(monkeypatch, "float32")
    batches = [_batch(10 + i) for i in range(5)]
    lr, warmup = 1e-3, 0.4  # 5 x 0.4: 2 warmup steps, so the lrs are 0, lr / 2, lr
    tr = _trainor(2, warmup, batches, params, lr=lr)
    lrs = []
    real_gated = ttrainor.gated_update

    def recording_gated(tx, lr_, loss):
        lrs.append(lr_)
        return real_gated(tx, lr_, loss)

    monkeypatch.setattr(ttrainor, "gated_update", recording_gated)
    assert tr.base_lr == lr
    losses = tr.train_epoch(0)
    assert len(losses) == 5 and all(np.isfinite(losses))

    # the JAX trainer's loop, written out
    sched = JScheduler(lr_decay_func="cosine", base_lr=lr, early_stop_metric="ROUGEL",
                       early_stop_limit=5, lr_decay_params={"warmup_ratio": warmup},
                       total_steps=5)
    tx = jts.create_optimizer("adamw", {"lr": lr}, None,
                              frozen_prefixes=jmodel.frozen_prefixes)

    def loss_fn(p, b):
        return jmodel.apply_train({"params": p}, b, None, train=True)[0]["loss"]

    vg = jax.jit(jax.value_and_grad(loss_fn))
    update = jax.jit(lambda p, o, g, lr_, l: jts.gated_update(tx, p, o, g, lr_, l))
    p, opt = params, tx.init(params)
    acc = jax.tree.map(jnp.zeros_like, params)
    want_lrs, want_losses = [], []
    for it, b in enumerate(batches, start=1):
        cur = sched.current_lr()
        loss, g = vg(p, {k: jnp.asarray(v) for k, v in b.items()})
        want_losses.append(float(loss))
        acc = jax.tree.map(lambda a, x: a + x, acc, g)
        if it % 2 == 0:
            want_lrs.append(cur)
            p, opt = update(p, opt, acc, cur, loss)
            acc = jax.tree.map(jnp.zeros_like, params)
            sched.iteration_step(it / 5)
    want_lrs.append(sched.current_lr())
    p, opt = update(p, opt, acc, sched.current_lr(), loss)
    assert lrs == pytest.approx(want_lrs, rel=1e-12)
    assert want_lrs == pytest.approx([0.0, lr / 2, lr], rel=1e-12)
    assert tr.training_scheduler.iteration_count == 3
    np.testing.assert_allclose(losses, want_losses, rtol=TOL_F32)
    new_t = {n: q.detach().numpy() for n, q in tr.model.module.named_parameters()}
    new_j = _np(p)
    # three Adam steps of up to lr each: held at a tenth of lr, entry by entry
    for name, want in new_j.items():
        diff = np.abs(new_t[name] - want)
        assert (diff > 0.1 * lr).mean() <= 1e-3, name
        assert diff.max() <= 6 * lr, name


def test_trainor_nan_microbatch_resets_and_nan_boundary_is_skipped(monkeypatch):
    """As ``tests/test_train_e2e.py`` holds the JAX trainer: a NaN microbatch
    wipes the accumulation; an update gated on a NaN loss leaves the
    parameters and the optimizer state unchanged; a finite one moves them."""
    jmodel, params = _jax_params(monkeypatch, "float32")
    good, other = _batch(20), _batch(21)
    bad = dict(good, images=np.full_like(good["images"], np.nan))
    tr = _trainor(2, 0.0, [good, bad], params)
    gb, bb, ob = (_torch_batch(b) for b in (good, bad, other))

    l1 = tr.grad_step(gb)
    assert torch.isfinite(l1) and any(p.grad.abs().sum() > 0 for p in tr.tx.params)
    l2 = tr.grad_step(bb)
    assert not torch.isfinite(l2)
    assert all(p.grad is None or not p.grad.any() for p in tr.tx.params)
    # after the reset the accumulation is the next microbatch's gradient alone
    tr.grad_step(ob)
    acc = [p.grad.clone() for p in tr.tx.params]
    tr.zero_grads()
    tr.grad_step(ob)
    for a, p in zip(acc, tr.tx.params):
        torch.testing.assert_close(a, p.grad, rtol=0, atol=0)

    before = [p.detach().clone() for p in tr.tx.params]
    assert not tr.apply_step(1e-3, l2)  # the boundary loss is NaN
    assert all(torch.equal(a, p) for a, p in zip(before, tr.tx.params))
    assert len(tr.tx.optimizer.state) == 0  # no moments, no step count
    assert all(p.grad is None for p in tr.tx.params)

    loss = tr.train_step(gb, 1e-3)
    assert torch.isfinite(loss)
    assert any(not torch.equal(a, p) for a, p in zip(before, tr.tx.params))
    state = {id(p): {k: v.clone() for k, v in s.items()} for p, s in tr.tx.optimizer.state.items()}
    moved = [p.detach().clone() for p in tr.tx.params]
    assert not torch.isfinite(tr.train_step(bb, 1e-3))
    assert all(torch.equal(a, p) for a, p in zip(moved, tr.tx.params))
    for p, s in tr.tx.optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, state[id(p)][k]), k


def test_trainor_start_runs_the_epoch_loop(monkeypatch):
    """``start`` runs epochs ``scheduler.epoch`` .. ``epochs`` (both ends, as
    the reference counts them), each with its partial tail applied, and
    steps the scheduler once per epoch."""
    _, params = _jax_params(monkeypatch, "float32")
    tr = _trainor(2, 0.0, [_batch(30 + i) for i in range(3)], params)
    tr.start()
    assert len(tr.epoch_losses) == 2 and all(np.isfinite(tr.epoch_losses))
    assert tr.training_scheduler.epoch == 2
    assert tr.training_scheduler.iteration_count == 4  # a boundary and a tail per epoch


def test_trainor_lr_sequence_matches_jax_scheduler():
    """The VL config's schedule (``lr_decay: cosine``, which the scheduler
    does not know, so the rate is constant after warmup; warmup_ratio 0.1
    over the epoch's microbatches) read as the trainer reads it, against
    the JAX ``TrainingScheduler``."""
    config = _tiny_config(4, 0.1, epochs=12)
    from vilmedic_torch.executors.utils import create_training_scheduler

    ours = create_training_scheduler(config, 5e-5, total_steps=8 * 12)
    theirs = JScheduler(lr_decay_func="cosine", base_lr=5e-5, early_stop_metric="ROUGEL",
                        early_stop_limit=5, lr_decay_params={"warmup_ratio": 0.1},
                        total_steps=8 * 12)
    seq_t, seq_j = [], []
    for it in range(40):
        seq_t.append(ours.current_lr())
        seq_j.append(theirs.current_lr())
        ours.iteration_step(it / 8)
        theirs.iteration_step(it / 8)
    assert seq_t == seq_j
    assert seq_t[0] == 0.0 and ours.warmup_steps == 9 and seq_t[-1] == 5e-5


def test_optimizer_factory_follows_optax():
    """adamw's defaults are optax's (weight decay 1e-4), adam's weight decay
    is additive L2, the clip is over the trainable gradients, frozen
    prefixes and gradient-free parameters get no state, and an optimizer
    the JAX package does not name (adamax) raises, as there."""
    lin = torch.nn.Linear(4, 3)
    frozen = torch.nn.Linear(4, 3)
    named = [("head.weight", lin.weight), ("head.bias", lin.bias),
             ("vision.w", frozen.weight), ("vision.b", frozen.bias)]
    tx = create_optimizer("AdamW", {"lr": 1e-3}, 1.0, ("vision",), named_parameters=named)
    assert tx.names == ["head.weight", "head.bias"]
    group = tx.optimizer.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and isinstance(tx.optimizer, torch.optim.AdamW)
    tx2 = create_optimizer("adam", {"lr": 1e-3, "weight_decay": 0.01}, None,
                           named_parameters=named)
    assert isinstance(tx2.optimizer, torch.optim.Adam) and len(tx2.params) == 4
    assert tx2.optimizer.param_groups[0]["weight_decay"] == 0.01
    with pytest.raises(NotImplementedError):
        create_optimizer("adamax", {"lr": 1e-3}, named_parameters=named)

    # against optax: clip 1.0 (the gradient norm here is above it), L2 adam
    rng = np.random.default_rng(4)
    w, g = rng.normal(size=(3, 4)).astype(np.float32), 3 * rng.normal(size=(3, 4)).astype(np.float32)
    for name, kw in (("adamw", {}), ("adam", {"weight_decay": 0.01})):
        p = torch.nn.Parameter(torch.from_numpy(w.copy()))
        tx = create_optimizer(name, {"lr": 1e-2, **kw}, 1.0, named_parameters=[("w", p)])
        for _ in range(3):
            p.grad = torch.from_numpy(g.copy())
            assert gated_update(tx, 1e-2, torch.tensor(1.0))
        jtx = jts.create_optimizer(name, {"lr": 1e-2, **kw}, 1.0)
        jp, jo = jnp.asarray(w), jtx.init(jnp.asarray(w))
        for _ in range(3):
            jp, jo = jts.gated_update(jtx, jp, jo, jnp.asarray(g), 1e-2, 1.0)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_config_carries_dropout_fields():
    """``TransformerConfig.from_dict`` keeps the dropout fields (defaults 0.1,
    as in JAX)."""
    from vilmedic_torch.blocks.transformer import TransformerConfig
    from vilmedic_tpu.blocks.transformer import TransformerConfig as JConfig

    assert TransformerConfig().hidden_dropout_prob == JConfig().hidden_dropout_prob == 0.1
    assert (TransformerConfig().attention_probs_dropout_prob
            == JConfig().attention_probs_dropout_prob == 0.1)
    cfg = TransformerConfig.from_dict(Config({"hidden_dropout_prob": 0.3,
                                              "attention_probs_dropout_prob": 0.2}))
    assert cfg.hidden_dropout_prob == 0.3 and cfg.attention_probs_dropout_prob == 0.2
