"""SCST of the PyTorch port against the JAX package, on the CPU, float32.

- ``scst_loss`` and its gradient through a tiny RRG (the grad step's body
  of ``vilmedic_tpu/models/scst_models.py``: encode with running
  statistics, the sampled ids teacher-forced, lse minus the picked logit)
  against ``jax.value_and_grad``: the loss within 1e-5, every gradient
  within 1e-4 of its tensor's largest entry (``test_torch_rrg_train.py``'s
  tolerances; the key biases against their weights' scale);
- ``SCST.get_reward`` against JAX's on the same ids, for every ported
  reward (``ciderdrl`` with a ``df`` corpus file);
- one epoch of ``RRG_SCST`` through the ``Trainor`` (2 iterations of batch
  4, Adam) on the family test's fixture (``tests/test_models_families.py``)
  with ``densenet_tiny`` in both packages, from the same weights and JAX's
  Gumbel noise (per iteration n and step i,
  ``gumbel(fold_in(fold_in(key(seed), n), i))``): equal greedy and sampled
  rollouts, equal rewards, losses within 1e-5, equal validation hypotheses
  and scores, and each tensor's change over the epoch within 1e-4 of its
  largest change plus one f32 rounding of its largest entry per step (the
  chip parity's ``update_agreement``). Adam runs with ``eps`` 1, so that
  its update is near linear in the gradient: at ``eps`` 1e-8 it divides
  each gradient entry by its own size, and an entry near 0 (the key
  biases') turns rounding noise into a full step;
- ``RRS_SCST``: the JAX package takes the rewards' references and the
  ``use_nll`` labels from ``input_ids``, the source findings; the port
  takes the target;
- the pipelined iteration (``overlap_rollout``) against JAX's: 3 batches
  of 3 and the epoch-end flush from the same weights and noise; the
  warm-up returns no loss in both, the rollouts and rewards are equal, the
  losses and each tensor's change within the serial run's tolerances (one
  f32 rounding of the largest entry per step); through the ``Trainor``
  (RRG_SCST and RRS_SCST), one step per batch, nothing left pending, one
  finite epoch loss;
- an unported reward raises, and so does an SCST model (serial or
  pipelined) across several processes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
import vilmedic_tpu.models.scst_models as jscst_models
from vilmedic_torch.blocks.rl.scst import SCST as TSCST
from vilmedic_torch.blocks.rl.scst import scst_loss as tscst_loss
from vilmedic_torch.config.config import Config as TConfig
from vilmedic_torch.data.tokenizer import WordPieceTokenizer
from vilmedic_torch.decoding import decode as tdecode
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.executors import Validator as TValidator
from vilmedic_torch.models.rrg import RRG as TRRG
from vilmedic_torch.utils import set_logger as tset_logger
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax, scst_state_dict_from_jax
from vilmedic_tpu.blocks.rl.scst import SCST as JSCST
from vilmedic_tpu.blocks.rl.scst import scst_loss as jscst_loss
from vilmedic_tpu.config import Config as JConfig
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
from vilmedic_tpu.models.rrg import RRG as JRRG
from vilmedic_tpu.utils import set_logger as jset_logger

TINY = (8, (2, 2), 16)
TOL_LOSS, TOL_GRAD = 1e-5, 1e-4
REPORTS = [
    "no acute disease .",
    "heart size is normal .",
    "small pleural effusion .",
    "no evidence of pneumonia .",
    "lungs are clear .",
    "mild cardiomegaly .",
    "no acute disease .",
    "lungs are clear .",
]
FINDINGS = [
    "the lungs are well expanded and clear without focal consolidation .",
    "heart size is mildly enlarged with tortuous aorta .",
    "there is a small left pleural effusion with adjacent atelectasis .",
    "no pneumothorax or pleural effusion is identified .",
    "the cardiomediastinal silhouette is within normal limits .",
    "patchy opacity in the right lower lobe may reflect pneumonia .",
    "lungs are clear without effusion .",
    "stable cardiomegaly without edema .",
]
IMPRESSIONS = ["no acute disease .", "cardiomegaly .", "small left effusion .",
               "no pneumothorax .", "normal heart .", "possible pneumonia .", "clear lungs .",
               "stable cardiomegaly ."]
TINY_TRANSFORMER = dict(proto=None, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                        intermediate_size=64, max_position_embeddings=64,
                        hidden_dropout_prob=0.0)
CNN = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
           dropout_out=0.0, permute="batch_first",
           visual_projection={"in_features": 32, "out_features": 32}, freeze=False)


@pytest.fixture(autouse=True)
def tiny_densenet(monkeypatch):
    monkeypatch.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("scst")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(len(REPORTS)):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    for split in ("train", "validate"):
        (root / f"{split}.report.tok").write_text("\n".join(REPORTS))
        (root / f"{split}.image.tok").write_text("\n".join(paths))
        (root / f"{split}.findings.tok").write_text("\n".join(FINDINGS))
        (root / f"{split}.impression.tok").write_text("\n".join(IMPRESSIONS))
    vocab = ["[CLS]", "[PAD]", "[SEP]", "[UNK]", "[MASK]"] + sorted(
        {w for r in REPORTS for w in r.split()})
    (root / "vocab.txt").write_text("\n".join(vocab))
    return root


# ------------------------------------------------------------ loss, grads


def test_scst_loss_matches_jax():
    rng = np.random.default_rng(0)
    logp = -rng.uniform(0, 5, (3, 7)).astype(np.float32)
    ids = rng.integers(0, 9, (3, 7)).astype(np.int64)
    ids[1, 4:] = 1  # padding
    adv = rng.normal(size=(2, 3)).astype(np.float32)
    want = jscst_loss(jnp.asarray(logp), jnp.asarray(ids), jnp.asarray(adv), (0.3, 0.7), 1)
    got = tscst_loss(torch.from_numpy(logp), torch.from_numpy(ids), torch.from_numpy(adv),
                     (0.3, 0.7), 1)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL_LOSS)
    # an all-pad batch divides by max(mask sum, 1): a zero loss, not a NaN
    zero = tscst_loss(torch.from_numpy(logp), torch.ones_like(torch.from_numpy(ids)),
                      torch.from_numpy(adv), (0.3, 0.7), 1)
    assert zero.item() == 0.0


def test_scst_gradient_matches_jax():
    """The grad step's loss of a tiny RRG on sampled ids and advantages."""
    vocab, bos, eos, pad = 60, 0, 2, 1
    dec = dict(TINY_TRANSFORMER, hidden_size=64, num_attention_heads=2, num_hidden_layers=2,
               intermediate_size=128, vocab_size=vocab, bos_token_id=bos, eos_token_id=eos,
               pad_token_id=pad, layer_norm_eps=1e-5)
    cnn = dict(CNN, visual_projection={"in_features": 32, "out_features": 64})
    rng = np.random.default_rng(1)
    jmodel = JRRG(decoder=dict(dec), cnn=dict(cnn), dtype="float32")
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    v = jax.jit(jmodel.init_variables)(jax.random.key(0), {
        "images": jnp.asarray(images), "input_ids": jnp.zeros((3, 4), jnp.int32),
        "attention_mask": jnp.ones((3, 4), jnp.int32)})
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
        np.float32), v["params"])
    stats = jax.tree.map(lambda x: rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32),
                         v["batch_stats"])
    sampled = rng.integers(3, vocab, (3, 10)).astype(np.int32)
    sampled[:, 0] = bos
    sampled[0, 5], sampled[0, 6:] = eos, pad
    adv = rng.normal(size=(1, 3)).astype(np.float32)
    module = jmodel.module

    def loss_fn(p):
        variables = {"params": p, "batch_stats": stats}
        enc_h, enc_m = module.apply(variables, jnp.asarray(images), None,
                                    method=type(module).encode)
        ids = jnp.asarray(sampled)
        logits = module.apply(
            variables, ids, (ids != pad).astype(jnp.int32), enc_h, enc_m.astype(jnp.int32),
            method=lambda m, a, b, c, d: m.dec(a, b, encoder_hidden_states=c,
                                               encoder_attention_mask=d, deterministic=True))
        shift = logits[:, :-1, :].astype(jnp.float32)
        tok = ids[:, 1:]
        lse = jax.nn.logsumexp(shift, axis=-1)
        iota = jax.lax.broadcasted_iota(jnp.int32, shift.shape, 2)
        picked = jnp.sum(jnp.where(iota == tok[..., None], shift, 0.0), axis=-1)
        return jscst_loss(picked - lse, tok, jnp.asarray(adv), (1.0,), pad)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = rrg_state_dict_from_jax({"params": jax.tree.map(np.asarray, grads_j)})

    tmodel = TRRG(decoder=dict(dec), cnn=dict(cnn), dtype="float32", device="cpu")
    tmodel.module.load_state_dict(rrg_state_dict_from_jax({"params": params,
                                                           "batch_stats": stats}))

    class Holder:  # the SCST model's gradient-step surface over the tiny RRG
        module = tmodel.module
        scst = type("S", (), {"pad_token_id": pad, "reward_weights": [1.0], "use_nll": False})

    from vilmedic_torch.models.scst_models import _SCSTBase

    enc = {"images": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
           "images_mask": None}
    loss = _SCSTBase.policy_loss(Holder, {}, enc, torch.from_numpy(sampled).long(),
                                 torch.from_numpy(adv))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=TOL_LOSS, atol=TOL_LOSS)
    got = dict(tmodel.module.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = w.abs().max().item()
        if name.endswith("self_attn.k.bias") or name.endswith("cross_attn.k.bias"):
            scale = want[name[:-len("bias")] + "weight"].abs().max().item()
        err = (got[name].grad - w).abs().max().item()
        assert err <= TOL_GRAD * scale, (name, err, scale)
    # running statistics, not batch statistics: nothing pending
    assert all(m.pending_stats is None for m in tmodel.module.modules()
               if isinstance(m, tdensenet.BatchNorm))


# ----------------------------------------------------------------- rewards


@pytest.mark.parametrize("score", ["rougel", "rouge1", "rouge2", "bleu", "ciderdrl"])
def test_get_reward_matches_jax(workdir, score):
    from transformers import BertTokenizer

    vocab_file = str(workdir / "vocab.txt")
    args = {"df": str(workdir / "train.report.tok")} if score == "ciderdrl" else None
    kw = dict(max_length=12, bos_token_id=0, eos_token_id=2, pad_token_id=1, scores=[score],
              scores_args=[args] if args else None)
    j = JSCST(tokenizer=BertTokenizer(vocab_file, do_basic_tokenize=False), **kw)
    t = TSCST(tokenizer=WordPieceTokenizer(vocab_file), **kw)
    rng = np.random.default_rng(2)
    vocab = len(open(vocab_file).read().split("\n"))
    rollouts = rng.integers(3, vocab, (6, 12))
    rollouts[:, 0] = 0
    rollouts[::2, 5] = 2
    rollouts[::2, 6:] = 1
    refs = rng.integers(5, vocab, (6, 12))
    refs[:2] = rollouts[:2]  # rows 0 and 1 equal, row 2 half equal: rewards above 0
    refs[2, :6] = rollouts[2, :6]
    want, want_h, want_r = j.get_reward(rollouts, refs)
    got, got_h, got_r = t.get_reward(rollouts, refs)
    assert got_h == want_h and got_r == want_r
    assert [g.dtype for g in got] == [np.float32]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
    assert np.any(got[0] > 0)
    if score == "ciderdrl":
        assert t.scorers[0].document_frequency  # frozen from the df file


def test_unported_reward_and_overlap_raise(workdir, tmp_path, monkeypatch):
    vocab_file = str(workdir / "vocab.txt")
    kw = dict(tokenizer=WordPieceTokenizer(vocab_file), max_length=12, bos_token_id=0,
              eos_token_id=2, pad_token_id=1)
    with pytest.raises(ValueError, match="radevalbertscore"):
        TSCST(scores=["rougel", "radevalbertscore"], scores_weights=[0.5, 0.5], **kw)
    with pytest.raises(ValueError):
        TSCST(scores=["rougel", "bleu"], **kw)  # two scores need their weights
    # the pipelined iteration builds; across processes it raises as the serial one does
    import vilmedic_torch.parallel.mesh as tmesh

    model = {"proto": "RRG_SCST", "decoder": dict(TINY_TRANSFORMER), "cnn": dict(CNN),
             "scores": "rougel", "overlap_rollout": True}
    assert TTrainor(TConfig(_scst_config(workdir, tmp_path, model)), seed=SEED,
                    device="cpu").model.overlap_rollout
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="processes"):
        TTrainor(TConfig(_scst_config(workdir, tmp_path, model)), seed=SEED, device="cpu")


# ------------------------------------------------- RRG_SCST through Trainor


SEED = 515154


def _scst_config(workdir, ckpt_dir, model, dataset=None, optim_params=None):
    return {
        "ckpt_dir": str(ckpt_dir), "seed": SEED,
        "dataset": dataset or {
            "proto": "ImSeq",
            "image": {"root": str(workdir), "file": "image.tok", "resize": 40, "crop": 32,
                      "ext": ".jpg"},
            "seq": {"root": str(workdir), "file": "report.tok", "source": "tgt",
                    "tokenizer_max_len": 12},
            "num_workers": 0},
        "model": model,
        "batch_size": 4, "optimizer": "Adam", "optim_params": optim_params or {"lr": 1e-3},
        "epochs": 0,
        "early_stop": 5, "eval_start": 0, "early_stop_metric": "ROUGEL",
        "metrics": ["ROUGEL", "BLEU"], "beam_width": 2, "splits": ["validate"],
    }


ADAM = {"lr": 0.1, "eps": 1.0}


class IterationNoise:
    """JAX's rollout noise for the port: ``start(n)`` before iteration n's
    rollout; call i then returns ``gumbel(fold_in(fold_in(key, n), i))``."""

    def __init__(self, key):
        self.key, self.step_key, self.i = key, None, 0

    def start(self, n):
        self.step_key, self.i = jax.random.fold_in(self.key, n), 0

    def __call__(self, shape, generator, device):
        n = jax.random.gumbel(jax.random.fold_in(self.step_key, self.i), tuple(shape),
                              jnp.float32)
        self.i += 1
        return torch.from_numpy(np.array(n)).to(device)


def _record(model, calls):
    """Record each ``get_reward`` call's ids and rewards."""
    real = model.scst.get_reward

    def get_reward(rollout_ids, ref_ids):
        out = real(rollout_ids, ref_ids)
        calls.append((np.asarray(rollout_ids).copy(), np.asarray(ref_ids).copy(),
                      [np.asarray(r).copy() for r in out[0]]))
        return out

    model.scst.get_reward = get_reward


@pytest.fixture(scope="module")
def scst_runs(workdir, tmp_path_factory):
    model = {"proto": "RRG_SCST", "decoder": dict(TINY_TRANSFORMER), "cnn": dict(CNN),
             "scores": "rougel", "top_k": 5}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
        mp.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)
        jdir = tmp_path_factory.mktemp("jax_scst")
        jconfig = JConfig(_scst_config(workdir, jdir, model, optim_params=ADAM))
        jset_logger(str(jdir), SEED)
        jtrainor = JTrainor(config=jconfig, seed=SEED)
        jtrainor.dl.dataset.image.transform.rng = np.random.default_rng(SEED)
        jtrainor.evaluator = JValidator(config=jconfig, models=[jtrainor.model],
                                        train_dl=jtrainor.dl, seed=SEED, from_training=True)
        initial = {k: v.clone() for k, v in scst_state_dict_from_jax(
            jax.tree.map(np.asarray, jtrainor.model.variables)).items()}
        jcalls, jlosses = [], []
        _record(jtrainor.model, jcalls)
        jreal = jtrainor.model.train_iteration

        def jiteration(*args):
            state, loss, custom = jreal(*args)
            jlosses.append(float(loss))
            return state, loss, custom

        jtrainor.model.train_iteration = jiteration
        jtrainor.start()
        jhyps = open(os.path.join(str(jdir), f"validate_{SEED}_hyps.txt")).read()
        jfinal = scst_state_dict_from_jax(jax.tree.map(np.asarray, jtrainor.model.variables))

        tdir = tmp_path_factory.mktemp("torch_scst")
        tconfig = TConfig(_scst_config(workdir, tdir, model, optim_params=ADAM))
        tset_logger(str(tdir), SEED)
        ttrainor = TTrainor(config=tconfig, seed=SEED, device="cpu")
        ttrainor.model.module.load_state_dict(initial, strict=True)
        ttrainor.evaluator = TValidator(config=tconfig, models=[ttrainor.model], seed=SEED)
        noise = IterationNoise(jtrainor.rng)
        mp.setattr(tdecode, "gumbel_noise", noise)
        tcalls, tlosses = [], []
        _record(ttrainor.model, tcalls)
        treal, rollouts = ttrainor.model.train_iteration, ttrainor.model.rollouts

        def titeration(*args):
            loss, custom = treal(*args)
            tlosses.append(float(loss))
            return loss, custom

        def trollouts(enc_inputs):
            noise.start(len(tlosses))
            return rollouts(enc_inputs)

        ttrainor.model.train_iteration = titeration
        ttrainor.model.rollouts = trollouts
        ttrainor.start()
        thyps = open(os.path.join(str(tdir), f"validate_{SEED}_hyps.txt")).read()
        yield dict(j=jtrainor, t=ttrainor, jcalls=jcalls, tcalls=tcalls, jlosses=jlosses,
                   tlosses=tlosses, jfinal=jfinal, initial=initial, jhyps=jhyps, thyps=thyps)


def test_scst_rollouts_and_rewards_match_jax(scst_runs):
    j, t = scst_runs["jcalls"], scst_runs["tcalls"]
    assert len(t) == len(j) == 4  # greedy and sampled, 2 iterations
    for (t_ids, t_refs, t_rew), (j_ids, j_refs, j_rew) in zip(t, j):
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_refs, j_refs)
        np.testing.assert_allclose(t_rew[0], j_rew[0], rtol=1e-6, atol=1e-7)
    greedy, sampled = t[0][0], t[1][0]
    assert not np.array_equal(greedy, sampled)


def _assert_update_agrees(got, want, initial, steps):
    """Each tensor's change within 1e-4 of JAX's largest change plus one f32
    rounding of its largest entry per step; the running statistics unmoved."""
    delta = {k: (want[k] - initial[k], got[k] - initial[k]) for k in want if "running" not in k}
    eps = torch.finfo(torch.float32).eps
    for name, (dw, dg) in delta.items():
        sibling = name
        if name.endswith("self_attn.k.bias") or name.endswith("cross_attn.k.bias"):
            sibling = name[:-len("bias")] + "weight"
        tol = (TOL_GRAD * delta[sibling][0].abs().max().item()
               + steps * eps * want[name].abs().max().item())
        assert (dg - dw).abs().max().item() <= tol, name
    moved = [name for name, (dw, _) in delta.items() if dw.abs().max().item() > 0]
    assert len(moved) >= len(delta) - 2, sorted(set(delta) - set(moved))  # the key biases
    for name in want:
        if "running" in name:  # encode runs on running statistics: they stay
            assert torch.equal(got[name], initial[name]) and torch.equal(want[name], initial[name])


def test_scst_losses_and_update_match_jax(scst_runs):
    np.testing.assert_allclose(scst_runs["tlosses"], scst_runs["jlosses"], rtol=TOL_LOSS,
                               atol=TOL_LOSS)
    t = scst_runs["t"]
    assert t.training_scheduler.iteration_count == 2 == scst_runs["j"].training_scheduler.iteration_count
    assert t.model.timing["iters"] == 2 and t.model.timing["reward_s"] > 0
    _assert_update_agrees(t.model.module.state_dict(), scst_runs["jfinal"], scst_runs["initial"],
                          steps=2)


def test_scst_validation_matches_jax(scst_runs):
    assert scst_runs["thyps"] == scst_runs["jhyps"]
    want, got = scst_runs["j"].evaluator.scores[0], scst_runs["t"].evaluator.scores[0]
    for key in ("ROUGEL", "BLEU"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=1e-12)


# ------------------------------------------------- the pipelined iteration


OVERLAP_BATCH = 3  # 9 train lines: 3 batches, 2 steps in the loop and the flush


def _nine_lines(workdir):
    """``train.{report,image}9.tok``: the 8 lines and the first again."""
    for kind in ("report", "image"):
        lines = (workdir / f"train.{kind}.tok").read_text().split("\n")
        (workdir / f"train.{kind}9.tok").write_text("\n".join(lines + lines[:1]))
    return {"proto": "ImSeq",
            "image": {"root": str(workdir), "file": "image9.tok", "resize": 40, "crop": 32,
                      "ext": ".jpg"},
            "seq": {"root": str(workdir), "file": "report9.tok", "source": "tgt",
                    "tokenizer_max_len": 12},
            "num_workers": 0}


@pytest.fixture(scope="module")
def overlap_runs(workdir, tmp_path_factory):
    """JAX's and the port's pipelined iterations over one epoch, driven batch
    by batch (the epoch loop's calls, no Validator), from the same weights
    and JAX's noise (rollout n: ``fold_in(key(seed), n)``)."""
    model = {"proto": "RRG_SCST", "decoder": dict(TINY_TRANSFORMER), "cnn": dict(CNN),
             "scores": "rougel", "top_k": 5, "overlap_rollout": True}
    dataset = _nine_lines(workdir)
    lr = ADAM["lr"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
        mp.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)
        jdir = tmp_path_factory.mktemp("jax_overlap")
        jconfig = JConfig(dict(_scst_config(workdir, jdir, model, dataset, ADAM),
                               batch_size=OVERLAP_BATCH))
        jset_logger(str(jdir), SEED)
        jtrainor = JTrainor(config=jconfig, seed=SEED)
        jtrainor.dl.dataset.image.transform.rng = np.random.default_rng(SEED)
        initial = {k: v.clone() for k, v in scst_state_dict_from_jax(
            jax.tree.map(np.asarray, jtrainor.model.variables)).items()}
        jcalls, jlosses = [], []
        _record(jtrainor.model, jcalls)
        jtrainor.dl.set_epoch(0)
        state, jlr = jtrainor.state, jnp.asarray(lr, jnp.float32)
        for batch in jtrainor._device_batches():
            state, loss, _ = jtrainor.model.train_iteration(jtrainor, state, batch, jlr)
            jlosses.append(None if loss is None else float(loss))
        state, loss, _ = jtrainor.model.finish_epoch(jtrainor, state, jlr)
        jlosses.append(float(loss))
        jtrainor.state = state
        jtrainor._sync_model_variables()
        jfinal = scst_state_dict_from_jax(jax.tree.map(np.asarray, jtrainor.model.variables))

        tdir = tmp_path_factory.mktemp("torch_overlap")
        tconfig = TConfig(dict(_scst_config(workdir, tdir, model, dataset, ADAM),
                               batch_size=OVERLAP_BATCH))
        tset_logger(str(tdir), SEED)
        ttrainor = TTrainor(config=tconfig, seed=SEED, device="cpu")
        ttrainor.model.module.load_state_dict(initial, strict=True)
        noise = IterationNoise(jtrainor.rng)
        mp.setattr(tdecode, "gumbel_noise", noise)
        tcalls, tlosses, started = [], [], []
        _record(ttrainor.model, tcalls)
        rollouts = ttrainor.model.rollouts

        def trollouts(enc_inputs):
            noise.start(len(started))
            started.append(1)
            return rollouts(enc_inputs)

        ttrainor.model.rollouts = trollouts
        ttrainor.dl.set_epoch(0)
        for batch in ttrainor._device_batches():
            loss, _ = ttrainor.model.train_iteration(ttrainor, batch, lr)
            tlosses.append(None if loss is None else float(loss))
        loss, _ = ttrainor.model.finish_epoch(ttrainor, lr)
        tlosses.append(float(loss))
        yield dict(t=ttrainor, jcalls=jcalls, tcalls=tcalls, jlosses=jlosses, tlosses=tlosses,
                   jfinal=jfinal, initial=initial)


def test_overlapped_scst_rollouts_and_rewards_match_jax(overlap_runs):
    j, t = overlap_runs["jcalls"], overlap_runs["tcalls"]
    assert len(t) == len(j) == 6  # greedy and sampled for each of 3 batches
    for (t_ids, t_refs, t_rew), (j_ids, j_refs, j_rew) in zip(t, j):
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_refs, j_refs)
        np.testing.assert_allclose(t_rew[0], j_rew[0], rtol=1e-6, atol=1e-7)
    assert not np.array_equal(t[0][0], t[1][0])


def test_overlapped_scst_losses_and_update_match_jax(overlap_runs):
    jl, tl = overlap_runs["jlosses"], overlap_runs["tlosses"]
    assert len(jl) == len(tl) == 4 and jl[0] is None and tl[0] is None  # the warm-up
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=TOL_LOSS, atol=TOL_LOSS)
    model = overlap_runs["t"].model
    assert model.timing["iters"] == 3 and model._pending is None
    _assert_update_agrees(model.module.state_dict(), overlap_runs["jfinal"],
                          overlap_runs["initial"], steps=3)


@pytest.mark.parametrize("proto", ["RRG_SCST", "RRS_SCST"])
def test_overlapped_pipeline_through_the_trainor(workdir, tmp_path, proto):
    """The port's counterpart of ``test_rrg_scst_overlapped_pipeline``: one
    step per batch (the last in ``finish_epoch``), nothing left pending, the
    warm-up's missing loss skipped: one finite epoch loss."""
    if proto == "RRG_SCST":
        model, dataset = {"proto": "RRG_SCST", "decoder": dict(TINY_TRANSFORMER),
                          "cnn": dict(CNN), "scores": "rougel", "top_k": 5}, None
    else:
        model, dataset = _rrs_scst_model(), _seq2seq(workdir)
    config = TConfig(_scst_config(workdir, tmp_path, dict(model, overlap_rollout=True), dataset))
    tset_logger(str(tmp_path), SEED)
    trainer = TTrainor(config=config, seed=SEED, device="cpu")
    trainer.evaluator = TValidator(config=config, models=[trainer.model], seed=SEED)
    trainer.start()
    n = len(trainer.dl)
    assert n == 2 and trainer.training_scheduler.iteration_count == n
    assert trainer.model.timing["iters"] == n and trainer.model._pending is None
    assert len(trainer.epoch_losses) == 1 and np.isfinite(trainer.epoch_losses[0])
    assert np.isfinite(trainer.evaluator.scores[0]["ROUGEL"])


# ---------------------------------------------------------------- RRS_SCST


def _seq2seq(workdir):
    return {"proto": "Seq2Seq",
            "src": {"root": str(workdir), "file": "findings.tok", "tokenizer_max_len": 24},
            "tgt": {"root": str(workdir), "file": "impression.tok", "tokenizer_max_len": 8},
            "num_workers": 0}


def _rrs_scst_model(**extra):
    block = dict(TINY_TRANSFORMER, max_position_embeddings=32)
    return {"proto": "RRS_SCST", "encoder": dict(block), "decoder": dict(block),
            "scores": "rougel", "top_k": 3, **extra}


def test_rrs_scst_reads_the_target_where_jax_reads_the_source(workdir, tmp_path, monkeypatch):
    """One JAX RRS_SCST iteration with ``use_nll``: the rewards' references
    are the batch's ``input_ids`` (the source findings, decoded with the
    target tokenizer), and the NLL labels have the source's length. The
    port's iteration takes ``decoder_input_ids`` for both."""
    model = _rrs_scst_model(use_nll=True, scores_weights=[0.5, 1.0])
    jconfig = JConfig(_scst_config(workdir, tmp_path / "j", model, _seq2seq(workdir)))
    (tmp_path / "j").mkdir()
    jset_logger(str(tmp_path / "j"), SEED)
    jtrainor = JTrainor(config=jconfig, seed=SEED)
    jcalls, nll_labels = [], []
    _record(jtrainor.model, jcalls)
    real_nll = jscst_models.causal_lm_loss

    def nll(logits, labels, mask):
        nll_labels.append(labels.shape)
        return real_nll(logits, labels, mask)

    monkeypatch.setattr(jscst_models, "causal_lm_loss", nll)
    batch = next(iter(jtrainor._device_batches()))
    jtrainor.model.train_iteration(jtrainor, jtrainor.state, batch,
                                   jnp.asarray(1e-3, jnp.float32))
    src, tgt = np.asarray(batch["input_ids"]), np.asarray(batch["decoder_input_ids"])
    assert src.shape[1] == 24 and tgt.shape[1] == 8
    np.testing.assert_array_equal(jcalls[0][1], src)  # JAX: references = the source
    assert nll_labels and all(shape == src.shape for shape in nll_labels)

    tconfig = TConfig(_scst_config(workdir, tmp_path / "t", model, _seq2seq(workdir)))
    (tmp_path / "t").mkdir()
    tset_logger(str(tmp_path / "t"), SEED)
    ttrainor = TTrainor(config=tconfig, seed=SEED, device="cpu")
    tcalls = []
    _record(ttrainor.model, tcalls)
    tbatch = ttrainor._model_batch(next(iter(ttrainor.dl)))
    loss, _ = ttrainor.model.train_iteration(ttrainor, tbatch, 1e-3)
    assert torch.isfinite(loss)
    np.testing.assert_array_equal(tcalls[0][1], tbatch["decoder_input_ids"].numpy())
    assert ttrainor.model.scst.decode(tcalls[0][1]) == [
        IMPRESSIONS[i] for i in ttrainor.dl.batch_indices()[0]]

    # the port's NLL term is the target's teacher-forced loss
    m = ttrainor.model
    enc = m.encoder_inputs(tbatch)
    zero = torch.zeros(1, tbatch["input_ids"].shape[0])
    with torch.no_grad():
        got = m.policy_loss(tbatch, enc, tbatch["decoder_input_ids"], zero)
        want = m.module(tbatch["input_ids"], tbatch["attention_mask"],
                        tbatch["decoder_input_ids"], tbatch["decoder_attention_mask"])["loss"]
    torch.testing.assert_close(got, 0.5 * want, rtol=1e-6, atol=1e-7)


def test_trainor_drains_model_owned_steps():
    """The ``Trainor``'s hooks for a model that owns its step: every
    ``train_iteration`` loss and the ``finish_epoch`` tail reach the epoch's
    losses, the scheduler counts the iterations, the supervised path is
    skipped."""
    calls = []

    class Owned:
        module = torch.nn.Linear(2, 2)
        frozen_prefixes = ()

        def train_iteration(self, trainor, batch, lr):
            calls.append(("iteration", float(batch["x"][0]), lr))
            return torch.tensor(float(batch["x"][0])), "text"

        def finish_epoch(self, trainor, lr):
            calls.append(("finish", lr))
            return torch.tensor(10.0), "tail"

        def apply_train(self, batch, generator=None):
            raise AssertionError("the supervised step ran")

    config = TConfig({"model": {"proto": "unused"}, "optimizer": "Adam",
                      "optim_params": {"lr": 1e-3}, "epochs": 0, "grad_accu": 2})
    batches = [{"x": torch.tensor([float(i)])} for i in (1, 2, 3)]

    class Trainer(TTrainor):
        def __init__(self):
            import vilmedic_torch.executors.trainor as trainor_module

            real = trainor_module.create_model
            trainor_module.create_model = lambda *a, **k: Owned()
            try:
                super().__init__(config, seed=0, loader=batches, device="cpu")
            finally:
                trainor_module.create_model = real

    trainer = Trainer()
    assert trainer.train_epoch(0) == [1.0, 2.0, 3.0, 10.0]
    assert [c[0] for c in calls] == ["iteration"] * 3 + ["finish"]
    assert trainer.training_scheduler.iteration_count == 3
