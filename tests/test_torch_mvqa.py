"""The MVQA / CLASS family of the port against the JAX package, on the CPU,
float32:

- the classification losses (``CrossEntropyLoss`` with the ignore index,
  ``BCEWithLogitsLoss``, ``LabelSmoothingCrossEntropy``; every reduction),
  within 1e-6 relative;
- ``MVQAModule``'s logits in eval mode (a ResNet tower and a ViT tower), and
  a training forward's loss and every parameter's gradient (ViT tower,
  dropout 0), with JAX's variables carried by ``zoo/from_jax.py``: 1e-4 of
  each tensor's largest entry;
- the train CLI (``python -m vilmedic_torch.bin.train``, its ``main``)
  against the JAX package's ``Trainor`` + ``Validator`` on the fixture of
  tests/test_models_families.py (8 JPEGs, 3 labels): its MVQA with the
  1-layer ViT tower, and ``config/MVQA/vqa.yml`` and
  ``config/CLASS/cvamd.yml`` cut down by dotlist overrides (resnet18), from
  the same initial weights and seed: per-epoch losses within 1e-5
  relative, equal answers, accuracy and f1 report, validation loss and
  AUROC within 1e-5, the validation logits within 1e-4 of their largest;
- ``LabelDataset`` with single- and multi-label rows against JAX's (label
  map file, processed labels, the ignore index for unseen labels);
- ``bin/ensemble.py``: ``best-2`` picks the checkpoints JAX's
  ``get_ckpts`` picks, and the ensemble CLI over two checkpoints averages
  the members' logits as JAX's ``evaluation`` does (hyps, refs, loss and
  scores).
"""

import copy
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import vilmedic_torch.bin.train as tcli
from vilmedic_torch.blocks import losses as tlosses
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.models.mvqa import MVQA as TMVQA
from vilmedic_torch.zoo.from_jax import mvqa_state_dict_from_jax, rrg_state_dict_from_jax
from vilmedic_tpu.blocks import losses as jlosses
from vilmedic_tpu.config.config import executor_config, load_config
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
from vilmedic_tpu.models.mvqa import MVQA as JMVQA
from vilmedic_tpu.utils import set_logger as jset_logger

REPO = pathlib.Path(__file__).resolve().parents[1]
LABELS = ["normal", "normal", "effusion", "normal", "normal", "cardiomegaly", "normal", "normal"]
TINY_VIT = {"proto": "VisualEncoder", "backbone": "vit", "permute": "no_permute",
            "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
            "intermediate_size": 64, "patch_size": 16}
TINY_RESNET = {"proto": "VisualEncoder", "backbone": "resnet18", "output_layer": "layer3",
               "permute": "batch_first"}
TINY_TRANSFORMER = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
                    "intermediate_size": 64, "max_position_embeddings": 64,
                    "hidden_dropout_prob": 0.0}
SEED = 515151
REL = 1e-4


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", ["CrossEntropyLoss", "BCEWithLogitsLoss",
                                  "LabelSmoothingCrossEntropy"])
def test_losses_match_jax(name, reduction):
    rng = np.random.default_rng(3)
    logits = (3 * rng.normal(size=(6, 5))).astype(np.float32)
    if name == "BCEWithLogitsLoss":
        target = (rng.random((6, 5)) < 0.5).astype(np.float32)
    else:
        target = rng.integers(0, 5, 6)
        if name == "CrossEntropyLoss":
            target[2] = -100  # the ignore index
    kwargs = {"smoothing": 0.2} if name == "LabelSmoothingCrossEntropy" else {}
    want = np.asarray(getattr(jlosses, name)(reduction=reduction, **kwargs)(
        jnp.asarray(logits), jnp.asarray(target)))
    got = getattr(tlosses, name)(reduction=reduction, **kwargs)(
        torch.from_numpy(logits), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_cross_entropy_all_ignored_is_zero():
    loss = tlosses.cross_entropy(torch.zeros(3, 4), torch.full((3,), -100))
    assert float(loss) == 0.0


# ---------------------------------------------------------------- the module

def _model_cfg(cnn, n_classes=3, loss=None):
    return dict(cnn=dict(cnn), classifier={"proto": "Classifier", "num_classes": n_classes},
                adapter={"input_size": 32, "output_size": 32}, transformer=dict(TINY_TRANSFORMER),
                loss=dict(loss or {"proto": "LabelSmoothingCrossEntropy", "smoothing": 0.1}))


def _pair(cnn, images, rng, seed=0):
    """A JAX MVQA with perturbed variables and the port's with the same."""
    jmodel = JMVQA(**_model_cfg(cnn))
    variables = jax.jit(jmodel.init_variables)(jax.random.key(seed),
                                               {"images": jnp.asarray(images)})
    variables = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.normal(size=x.shape)
                             .astype(np.float32), variables)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree.map(
            lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), variables["batch_stats"])
    jmodel.variables = variables
    cnn_cfg = dict(cnn, image_size=images.shape[1]) if cnn["backbone"] == "vit" else cnn
    tmodel = TMVQA(**_model_cfg(cnn_cfg), device="cpu")
    tmodel.module.load_state_dict(mvqa_state_dict_from_jax(variables), strict=True)
    return jmodel, tmodel


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("cnn", [TINY_VIT, TINY_RESNET], ids=["vit", "resnet18"])
def test_mvqa_logits_match_jax(cnn):
    rng = np.random.default_rng(1)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 2, 1, 2])
    jmodel, tmodel = _pair(cnn, images, rng)
    jout = jmodel.apply_eval(jmodel.variables, {"images": jnp.asarray(images),
                                                "labels": jnp.asarray(labels)})
    tout = tmodel.apply_eval({"images": _nchw(images), "labels": torch.from_numpy(labels)})
    assert tout["output"].dtype == torch.float32 and tout["output"].shape == (4, 3)
    _close(tout["output"].numpy(), jout["output"])
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tout["answer"].numpy(), np.asarray(jout["answer"]))


def test_mvqa_training_step_matches_jax():
    """A training forward (dropout 0, the ViT tower trained) and its
    backward: the loss and every parameter's gradient."""
    rng = np.random.default_rng(2)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 0, 2, 2])
    jmodel, tmodel = _pair(TINY_VIT, images, rng, seed=4)
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}

    def loss_fn(params):
        out, _ = jmodel.apply_train({"params": params}, batch, jax.random.key(0))
        return out["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(jmodel.variables["params"])
    out = tmodel.apply_train({"images": _nchw(images), "labels": torch.from_numpy(labels)},
                             torch.Generator().manual_seed(0))
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=1e-5)
    want = rrg_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    got = dict(tmodel.module.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        if name.endswith("self_attn.k.bias"):  # 0 up to rounding (shift invariance)
            assert float(got[name].grad.abs().max()) <= 1e-5 * float(
                want[name.replace("bias", "weight")].abs().max())
            continue
        _close(got[name].grad.numpy(), g.numpy())


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The fixture of tests/test_models_families.py: 8 noise JPEGs of 48²
    and their labels, train = validate."""
    root = tmp_path_factory.mktemp("mvqa")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(len(LABELS)):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    for split in ("train", "validate"):
        (root / f"{split}.image.tok").write_text("\n".join(paths))
        (root / f"{split}.label.tok").write_text("\n".join(LABELS))
    return root


def _vit_config(root, ckpt_dir):
    """The families fixture's MVQA (the ViT tower) as a config dict."""
    return {
        "name": "mvqa", "ckpt_dir": str(ckpt_dir), "seed": SEED,
        "dataset": {"proto": "ImLabel",
                    "image": {"root": str(root), "file": "image.tok", "resize": 40, "crop": 32,
                              "ext": ".jpg"},
                    "label": {"root": str(root), "file": "label.tok"}, "num_workers": 0},
        "model": {"proto": "MVQA", **_model_cfg(TINY_VIT, loss={"proto": "CrossEntropyLoss"})},
        "trainor": {"batch_size": 4, "optimizer": "Adam", "optim_params": {"lr": 1e-3},
                    "epochs": 1, "early_stop": 5, "eval_start": 0,
                    "early_stop_metric": "accuracy"},
        "validator": {"batch_size": 4, "metrics": ["accuracy"], "splits": ["validate"],
                      "shard_eval": False},
        "ensemblor": {"batch_size": 4, "metrics": ["accuracy", "f1-score"],
                      "splits": ["validate"], "mode": "best-2", "shard_eval": False},
    }


def _config_file(kind, root, ckpt_dir, path):
    """The run's config as one file both packages read: the families
    fixture's MVQA with the ViT tower, or ``config/MVQA/vqa.yml`` /
    ``config/CLASS/cvamd.yml`` cut down by dotlist overrides (resnet18 to
    layer3, width 32, 3 classes, dropout 0, 2 epochs of 2 steps)."""
    if kind == "vit":
        cfg = _vit_config(root, ckpt_dir)
    else:
        # Adam turns the rounding noise of a ~0 gradient entry into a full lr
        # step of either sign: the BatchNorm biases of the ResNet tower, whose
        # gradients nearly cancel through the batch-normalized layers after
        # them, would then move apart between the packages. eps 1 keeps such
        # entries' steps as small as their gradients.
        cfg, _ = load_config(f"config/{kind}", [
            f"ckpt_dir={ckpt_dir}", "name=mvqa", f"seed={SEED}", "model.dtype=float32",
            f"dataset.image.root={root}", f"dataset.label.root={root}",
            "dataset.image.resize=40", "dataset.image.crop=32", "dataset.num_workers=0",
            "model.cnn.backbone=resnet18", "model.cnn.output_layer=layer3",
            "model.adapter.output_size=32", "model.transformer.hidden_size=32",
            "model.transformer.intermediate_size=64", "model.transformer.num_attention_heads=4",
            "model.transformer.hidden_dropout_prob=0.0", "model.classifier.num_classes=3",
            "trainor.batch_size=4", "trainor.epochs=1", "trainor.optim_params.eps=1.0",
            "validator.batch_size=4", "validator.shard_eval=false", "ensemblor.batch_size=4",
            "ensemblor.splits=[validate]", "ensemblor.mode=best-2", "ensemblor.shard_eval=false"])
        cfg = cfg.to_dict()
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module", params=["vit", "MVQA/vqa.yml", "CLASS/cvamd.yml"])
def runs(request, workdir, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)  # the config files' paths
        jdir = tmp_path_factory.mktemp("jax_mvqa")
        config, _ = load_config(_config_file(request.param, workdir, jdir, jdir / "config.yml"))
        train_config = executor_config(config, "trainor")
        val_config = executor_config(config, "validator")
        ckpt_dir = os.path.join(config.ckpt_dir, config.name)
        os.makedirs(ckpt_dir)
        train_config.ckpt_dir = val_config.ckpt_dir = ckpt_dir
        jset_logger(ckpt_dir, SEED)
        jtrainor = JTrainor(config=train_config, seed=SEED)
        jtrainor.dl.dataset.image.transform.rng = np.random.default_rng(SEED)
        jtrainor.evaluator = JValidator(config=val_config, models=[jtrainor.model],
                                        train_dl=jtrainor.dl, seed=SEED, from_training=True)
        initial = {k: v.numpy().copy() for k, v in mvqa_state_dict_from_jax(
            jax.tree.map(np.asarray, dict(jtrainor.model.variables))).items()}
        jresults = []
        jeval = jtrainor.model.eval_func

        def jrecord(*args, **kwargs):  # a copy: the Validator pops its keys
            out = jeval(*args, **kwargs)
            jresults.append(dict(out))
            return out

        jtrainor.model.eval_func = jrecord
        jtrainor.start()

        tresults = []

        class Seeded(TTrainor):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.model.module.load_state_dict(
                    {k: torch.from_numpy(v) for k, v in initial.items()}, strict=True)
                teval = self.model.eval_func

                def trecord(*a, **kw):
                    out = teval(*a, **kw)
                    tresults.append(dict(out))
                    return out

                self.model.eval_func = trecord

        tdir = tmp_path_factory.mktemp("torch_mvqa")
        mp.setattr(tcli, "Trainor", Seeded)
        tpath = _config_file(request.param, workdir, tdir, tdir / "config.yml")
        ttrainor = tcli.main([tpath, "device=cpu"])
        model_cfg = {k: v for k, v in config.model.to_dict().items() if k != "proto"}
        yield dict(j=jtrainor, t=ttrainor, jres=jresults, tres=tresults, tdir=tdir,
                   tpath=tpath, model_cfg=model_cfg)


def test_cli_losses_match_jax(runs):
    j, t = runs["j"], runs["t"]
    assert len(t.epoch_losses) == len(j.epoch_losses) == 2
    np.testing.assert_allclose(t.epoch_losses, j.epoch_losses, rtol=1e-5)


def test_cli_answers_and_accuracy_match_jax(runs):
    assert len(runs["tres"]) == len(runs["jres"]) == 2
    for got, want in zip(runs["tres"], runs["jres"]):
        np.testing.assert_array_equal(got["refs"], want["refs"])
        np.testing.assert_array_equal(got["hyps"].argmax(-1), want["hyps"].argmax(-1))
        _close(got["hyps"], want["hyps"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    got, want = runs["t"].evaluator.scores[0], runs["j"].evaluator.scores[0]
    assert sorted(got) == sorted(want) and "accuracy" in got
    for key in want:
        if isinstance(want[key], str):  # the f1-score report
            assert got[key] == want[key]
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


# ---------------------------------------------------------------- labels

def test_label_dataset_matches_jax(tmp_path):
    """The label map (built on train, read back on test), each split's
    processed labels (an index, or a multi-hot vector; an unseen label is
    the ignore index -100 in both kinds, as JAX gives it) and the train
    batch."""
    from vilmedic_torch.data.label import LabelDataset as TLabel
    from vilmedic_tpu.data.label import LabelDataset as JLabel

    for multi, rows in ((False, ["b", "a", "c", "a"]), (True, ["b,a", "c", "a", "c,b,a"])):
        root = tmp_path / f"multi{multi}"
        root.mkdir()
        (root / "train.label.tok").write_text("\n".join(rows))
        (root / "test.label.tok").write_text("\n".join(rows[:2] + ["zzz"]))
        jdir, tdir = root / "j", root / "t"
        jdir.mkdir(), tdir.mkdir()
        for split in ("train", "test"):
            j = JLabel(root=str(root), split=split, file="label.tok", ckpt_dir=str(jdir))
            t = TLabel(root=str(root), split=split, file="label.tok", ckpt_dir=str(tdir))
            assert t.labels_map.multi_label == multi == j.labels_map.multi_label
            assert t.labels_map.labels == j.labels_map.labels
            assert len(t) == len(j) == (4 if split == "train" else 3)
            for got, want in zip(t.labels, j.labels):
                np.testing.assert_array_equal(got, want)
        assert int(t.labels[-1]) == -100
        train = TLabel(root=str(root), split="train", file="label.tok", ckpt_dir=str(tdir))
        jtrain = JLabel(root=str(root), split="train", file="label.tok", ckpt_dir=str(jdir))
        batch = train.get_collate_fn()([train[i] for i in range(4)])["labels"]
        np.testing.assert_array_equal(
            batch.numpy(), jtrain.get_collate_fn()([jtrain[i] for i in range(4)])["labels"])
        assert batch.dtype == (torch.float32 if multi else torch.int64)
        assert (tdir / "labels.tok").read_text() == (jdir / "labels.tok").read_text()


# ---------------------------------------------------------------- the ensemble CLI

def _jax_get_ckpts():
    script = REPO / "bin_tpu" / "ensemble.py"
    spec = importlib.util.spec_from_file_location("jax_ensemble_cli", script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.get_ckpts


def test_get_ckpts_matches_jax(tmp_path):
    from vilmedic_torch.bin.ensemble import get_ckpts

    for name in ("12.5_3_7.ckpt", "40.0_9_7.ckpt", "3.25_1_7.ckpt", "40.5_2_7.ckpt", "x.txt"):
        (tmp_path / name).write_text("")
    jget = _jax_get_ckpts()
    for mode in ("best-1", "best-2", "best-3"):
        assert get_ckpts(str(tmp_path), mode) == jget(str(tmp_path), mode)
    assert sorted(get_ckpts(str(tmp_path), "all")) == sorted(jget(str(tmp_path), "all"))
    assert [os.path.basename(p) for p in get_ckpts(str(tmp_path), "best-2")] == [
        "40.5_2_7.ckpt", "40.0_9_7.ckpt"]


def test_ensemble_cli_averages_like_jax(runs):
    """Two checkpoints of different weights in the port's run directory;
    the port's ensemble CLI against JAX's ``evaluation`` of the same two
    models on the same split."""
    from vilmedic_torch.bin.ensemble import main as ensemble_main
    from vilmedic_torch.executors.checkpoint import save_checkpoint
    from vilmedic_tpu.blocks.classifier import evaluation as jevaluation
    from vilmedic_tpu.executors.utils import create_data_loader as jloader
    from vilmedic_tpu.scorers.scores import compute_scores as jcompute

    jtrainor, tdir = runs["j"], runs["tdir"]
    run_dir = os.path.join(str(tdir), "mvqa")
    for f in pathlib.Path(run_dir).glob("*.ckpt"):
        f.unlink()
    rng = np.random.default_rng(9)
    members = []
    for k, tag in enumerate((70.0, 80.0, 10.0)):  # best-2: the tags 80 and 70
        variables = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape)
                                 .astype(np.float32), dict(jtrainor.model.variables))
        sd = mvqa_state_dict_from_jax(variables)
        save_checkpoint(os.path.join(run_dir, f"{tag}_{k + 1}_{SEED}.ckpt"),
                        {"model": sd, "config": {}, "__version__": "test"})
        members.append((tag, variables))
    chosen = [v for tag, v in sorted(members, key=lambda m: -m[0])[:2]]
    jmodels = []
    for variables in chosen:
        m = JMVQA(**copy.deepcopy(runs["model_cfg"]))
        m.variables = jax.tree.map(jnp.asarray, variables)
        jmodels.append(m)
    config, _ = load_config(runs["tpath"])
    ens = executor_config(config, "ensemblor")
    ens.ckpt_dir = run_dir
    dl = jloader(ens, "validate", jset_logger(None, "ensemble-test"), called_by_validator=True,
                 called_by_ensemblor=True)
    want = jevaluation(jmodels, ens, dl)
    got = ensemble_main([runs["tpath"], "device=cpu"])
    scores = got.scores[0]
    np.testing.assert_allclose(scores["validation_loss"], want["loss"], rtol=1e-5)
    jscores = jcompute(list(ens.metrics), want["refs"], want["hyps"], "validate", 0, None, 0,
                       None, dump=False)
    assert sorted(scores) == sorted(jscores) + ["validation_loss"]
    for key in jscores:
        if isinstance(jscores[key], str):  # the f1-score report
            assert scores[key] == jscores[key]
        else:
            np.testing.assert_allclose(scores[key], jscores[key], rtol=1e-12)
    assert len(got.models) == 2
