"""RRG training pieces of the PyTorch port against the JAX package, on the
CPU, float32, on the tiny RRG of ``test_torch_rrg_slice.py`` (DenseNet with
2 blocks of 2 layers, a 2-layer decoder, hidden dropout 0 on both sides):

- ``RRG.apply_train`` against the Flax model's training forward: the loss
  within 1e-5, every gradient within 1e-4 of its tensor's largest entry
  (f32 sums through BatchNorm's batch statistics in another order; two
  gradients that cancel to near 0 by an invariance are held against a
  sibling's scale, see the test), the updated running statistics within
  1e-5;
- RAdam against ``optax.radam`` over 10 steps, across the switch to the
  rectified update at step 7, with and without L2 weight decay: parameters
  within 1e-6 (at weight scale 0.1; optax rounds rho_t in f32);
- ``cnn.freeze``: the backbone takes no gradient, keeps its running
  statistics and stays bitwise unchanged; the projection trains;
- a non-finite loss leaves parameters and running statistics as they were;
- a checkpoint round trip and the best-only saver.
"""

import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
from vilmedic_torch.config.config import Config
from vilmedic_torch.executors import Trainor, create_optimizer
from vilmedic_torch.executors.checkpoint import (
    CheckpointSaver, load_checkpoint, save_checkpoint, snapshot,
)
from vilmedic_torch.models.rrg import RRG as TRRG
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.executors.train_state import create_optimizer as jax_create_optimizer
from vilmedic_tpu.models.rrg import RRG as JRRG

TINY = (8, (2, 2), 16)
VOCAB, BOS, EOS, PAD = 300, 0, 2, 1
DECODER = dict(proto=None, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=128, max_position_embeddings=64, layer_norm_eps=1e-5,
               hidden_act="gelu", vocab_size=VOCAB, bos_token_id=BOS, eos_token_id=EOS,
               pad_token_id=PAD, hidden_dropout_prob=0.0)
CNN = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
           dropout_out=0.0, permute="batch_first",
           visual_projection={"in_features": 32, "out_features": 64}, freeze=False)
TOL_LOSS, TOL_GRAD, TOL_STATS = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True)
def tiny_densenet(monkeypatch):
    monkeypatch.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)


def _batch(rng, b=3, t=9):
    ids = rng.integers(3, VOCAB, (b, t)).astype(np.int32)
    ids[:, 0] = BOS
    mask = np.ones((b, t), np.int32)
    mask[1, -4:] = 0
    ids[1, -4] = EOS
    return {"images": rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask}


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous(),
            "input_ids": torch.from_numpy(batch["input_ids"]).long(),
            "attention_mask": torch.from_numpy(batch["attention_mask"]).long()}


@pytest.fixture
def models(tiny_densenet):
    rng = np.random.default_rng(0)
    jmodel = JRRG(decoder=dict(DECODER), cnn=dict(CNN), dtype="float32")
    batch = _batch(rng)
    variables = jax.jit(jmodel.init_variables)(jax.random.key(0), {
        k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
        np.float32), variables["params"])
    stats = jax.tree.map(lambda x: rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32),
                         variables["batch_stats"])
    variables = {"params": params, "batch_stats": stats}
    tmodel = TRRG(decoder=dict(DECODER), cnn=dict(CNN), dtype="float32", device="cpu")
    tmodel.module.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel, batch


def test_apply_train_matches_jax(models):
    jmodel, variables, tmodel, batch = models
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, new_stats = jmodel.apply_train({"params": params,
                                             "batch_stats": variables["batch_stats"]},
                                            jbatch, jax.random.key(1), train=True)
        return out["loss"], new_stats

    (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want_grads = rrg_state_dict_from_jax({"params": jax.tree.map(np.asarray, grads_j)})
    want_stats = rrg_state_dict_from_jax({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, stats_j)})

    module = tmodel.module
    loss = tmodel.apply_train(_torch_batch(batch))["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=TOL_LOSS, atol=TOL_LOSS)
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(want_grads)
    for name, want in want_grads.items():
        scale = want.abs().max().item()
        if name.endswith("self_attn.k.bias") or name.endswith("cross_attn.k.bias"):
            # softmax is shift-invariant: an exactly 0 gradient
            scale = want_grads[name[:-len("bias")] + "weight"].abs().max().item()
        if name == "enc.model.norm0.weight":
            # every path from the stem's BatchNorm runs through ReLU into a
            # batch-normalized layer, which undoes a scaling of its channels:
            # the scale's gradient nearly cancels (1e-5 against 1e-2 for the
            # stem's convolution)
            scale = want_grads["enc.model.norm0.bias"].abs().max().item()
        err = (got[name].grad - want).abs().max().item()
        assert err <= TOL_GRAD * scale, (name, err, scale)

    running = {k: v.clone() for k, v in module.state_dict().items() if "running" in k}
    tdensenet.commit_batch_stats(module, True)
    for name, want in want_stats.items():
        assert not torch.equal(running[name], want)  # the statistics did move
        np.testing.assert_allclose(module.state_dict()[name].numpy(), want.numpy(),
                                   rtol=TOL_STATS, atol=TOL_STATS)


def test_radam_matches_optax():
    """Through ``create_optimizer("RAdam", ...)``: 10 steps against
    ``optax.radam`` (and, without weight decay, the JAX package's own
    factory), with L2 weight decay against ``add_decayed_weights`` ahead of
    it."""
    rng = np.random.default_rng(3)
    w0 = (0.1 * rng.normal(size=(6, 5))).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(10)]
    lr = 1e-3
    refs = {0.0: [optax.radam(lr), jax_create_optimizer("RAdam", {"lr": lr})],
            0.01: [optax.chain(optax.add_decayed_weights(0.01), optax.radam(lr))]}
    for wd, txs in refs.items():
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        tx = create_optimizer("RAdam", {"lr": lr, "weight_decay": wd},
                              named_parameters=[("w", p)])
        for g in grads:
            p.grad = torch.from_numpy(g.copy())
            tx.optimizer.step()
        assert tx.optimizer.param_groups[0]["step"] == 10
        for ref in txs:
            pj = jnp.asarray(w0)
            state = ref.init(pj)
            for g in grads:
                upd, state = ref.update(jnp.asarray(g), state, pj)
                pj = optax.apply_updates(pj, upd)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj), rtol=0, atol=1e-6)


def _trainer(tmp_path, cnn, batches, lr=1e-3):
    config = Config({"model": {"proto": "RRG", "decoder": dict(DECODER), "cnn": cnn,
                               "dtype": "float32"},
                     "optimizer": "RAdam", "optim_params": {"lr": lr}, "epochs": 0,
                     "ckpt_dir": str(tmp_path)})
    return Trainor(config, seed=0, loader=batches, device="cpu")


def test_cnn_freeze_keeps_the_backbone(tmp_path):
    """``cnn.freeze``: the backbone's parameters and running statistics are
    out of the optimizer and unchanged after steps; the projection and the
    decoder move. The frozen prefix is the JAX package's."""
    rng = np.random.default_rng(5)
    batch = _torch_batch(_batch(rng))
    trainer = _trainer(tmp_path, dict(CNN, freeze=True), [batch])
    assert trainer.model.frozen_prefixes == JRRG(
        decoder=dict(DECODER), cnn=dict(CNN, freeze=True)).frozen_prefixes == ("enc/model",)
    before = {k: v.clone() for k, v in trainer.model.module.state_dict().items()}
    assert not any(n.startswith("enc.model.") for n in trainer.tx.names)
    for _ in range(2):
        trainer.train_step(batch, 1e-3)
    after = trainer.model.module.state_dict()
    for name, value in after.items():
        moved = not torch.equal(value, before[name])
        if name.startswith("enc.model."):
            assert not moved, name
        elif name.endswith(".weight") and ("visual_projection" in name or "dec.layer_0" in name):
            assert moved, name


def test_non_finite_loss_keeps_parameters_and_statistics(tmp_path):
    rng = np.random.default_rng(6)
    batch = _torch_batch(_batch(rng))
    trainer = _trainer(tmp_path, dict(CNN), [batch])
    trainer.train_step(batch, 1e-3)  # one good step: optimizer state exists
    before = {k: v.clone() for k, v in trainer.model.module.state_dict().items()}
    bad = dict(batch, images=torch.full_like(batch["images"], float("nan")))
    loss = trainer.train_step(bad, 1e-3)
    assert not torch.isfinite(loss)
    for name, value in trainer.model.module.state_dict().items():
        assert torch.equal(value, before[name]), name
    trainer.train_step(batch, 1e-3)
    assert not torch.equal(trainer.model.module.state_dict()["enc.model.norm0.running_mean"],
                           before["enc.model.norm0.running_mean"])


def test_checkpoint_round_trip(tmp_path):
    """A saved payload restores into a fresh model, optimizer and scheduler
    that then step exactly as the original; the saver keeps only the best
    file, named ``{tag}_{epoch}_{seed}.ckpt``."""
    rng = np.random.default_rng(7)
    batch = _torch_batch(_batch(rng))
    trainer = _trainer(tmp_path, dict(CNN), [batch])
    trainer.train_step(batch, 1e-3)
    trainer.training_scheduler.iteration_step()
    logger = logging.getLogger("ckpt-test")
    saver = CheckpointSaver(str(tmp_path), logger, seed=11)
    payload = lambda: {"model": snapshot(trainer.model.module.state_dict()),  # noqa: E731
                       "opt_state": snapshot(trainer.tx.optimizer.state_dict()),
                       "training_scheduler": trainer.training_scheduler.state_dict(),
                       "config": {"model": {"proto": "RRG"}}, "__version__": "0.1.0"}
    saver.save(payload(), tag=0.1234567, current_epoch=1)
    path = saver.save(payload(), tag=0.25, current_epoch=2)
    saver.wait()
    assert sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "*.ckpt"))) == [
        "0.25_2_11.ckpt"]
    assert CheckpointSaver.extract_tag_and_step(path) == (0.25, 2)

    state = load_checkpoint(path)
    assert state["config"]["model"]["proto"] == "RRG" and state["__version__"] == "0.1.0"
    config = Config(dict(trainer.config.to_dict(), ckpt=path))
    resumed = Trainor(config, seed=0, loader=[batch], device="cpu")
    assert resumed.training_scheduler.iteration_count == 1
    for name, value in trainer.model.module.state_dict().items():
        assert torch.equal(resumed.model.module.state_dict()[name], value), name
    trainer.train_step(batch, 1e-3)
    resumed.train_step(batch, 1e-3)
    for (name, p), q in zip(trainer.model.module.named_parameters(),
                            resumed.model.module.parameters()):
        assert torch.equal(p, q), name

    save_checkpoint(str(tmp_path / "direct.ckpt"), payload())
    assert sorted(load_checkpoint(str(tmp_path / "direct.ckpt"))) == [
        "__version__", "config", "model", "opt_state", "training_scheduler"]
