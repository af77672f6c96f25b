"""RRG_FORCE (constrained decoding) of the PyTorch port against the JAX
package, on the CPU, float32, on the family test's fixture
(``tests/test_models_families.py``: 8 reports with one concept each, an
``ImSeqAny`` dataset) with ``densenet_tiny`` in both packages:

- ``_force_ids``: equal (B, 16) id matrices, -1 padded, from the corpus
  vocabulary (transformers' ``BertTokenizer`` there, the port's WordPiece
  tokenizer here);
- ``evaluation_force``: from the same weights, equal hypotheses and
  references over the validate split, and every forced concept present;
- one epoch through the port's ``Trainor`` and ``Validator`` with the
  ``concepts`` strings in the batches.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
from vilmedic_torch.config.config import Config as TConfig
from vilmedic_torch.data.tokenizer import WordPieceTokenizer
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.executors import Validator as TValidator
from vilmedic_torch.executors.utils import create_data_loader as tcreate_data_loader
from vilmedic_torch.models.rrg_force import RRG_FORCE as TRRG_FORCE
from vilmedic_torch.models.rrg_force import _force_ids as t_force_ids
from vilmedic_torch.models.rrg_force import evaluation_force as tevaluation_force
from vilmedic_torch.utils import set_logger as tset_logger
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.config import Config as JConfig
from vilmedic_tpu.executors.utils import create_data_loader as jcreate_data_loader
from vilmedic_tpu.models.rrg_force import RRG_FORCE as JRRG_FORCE
from vilmedic_tpu.models.rrg_force import _force_ids as j_force_ids
from vilmedic_tpu.models.rrg_force import evaluation_force as jevaluation_force
from vilmedic_tpu.utils import set_logger as jset_logger

TINY = (8, (2, 2), 16)
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
CONCEPTS = ["pleural", "heart", "effusion", "pneumonia", "lungs", "cardiomegaly",
            "disease", "clear"]
DECODER = dict(proto=None, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0)
CNN = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
           dropout_out=0.0, permute="batch_first",
           visual_projection={"in_features": 32, "out_features": 32}, freeze=False)
SEED = 515155


@pytest.fixture(autouse=True)
def tiny_densenet(monkeypatch):
    monkeypatch.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("force")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(len(REPORTS)):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    for split in ("train", "validate"):
        (root / f"{split}.report.tok").write_text("\n".join(REPORTS))
        (root / f"{split}.image.tok").write_text("\n".join(paths))
        (root / f"{split}.concepts.tok").write_text("\n".join(CONCEPTS))
    return root


def _config(workdir, ckpt_dir, **extra):
    return {
        "ckpt_dir": str(ckpt_dir), "seed": SEED,
        "dataset": {
            "proto": "ImSeqAny",
            "image": {"root": str(workdir), "file": "image.tok", "resize": 40, "crop": 32,
                      "ext": ".jpg"},
            "seq": {"root": str(workdir), "file": "report.tok", "source": "tgt",
                    "tokenizer_max_len": 12},
            "any": {"root": str(workdir), "file": "concepts.tok", "name": "concepts"},
            "num_workers": 0},
        "model": {"proto": "RRG_FORCE", "decoder": dict(DECODER), "cnn": dict(CNN)},
        "batch_size": 4, "optimizer": "Adam", "optim_params": {"lr": 1e-3}, "epochs": 0,
        "early_stop": 5, "eval_start": 0, "early_stop_metric": "BLEU", "metrics": ["BLEU"],
        "splits": ["validate"], **extra,
    }


def test_force_ids_match_jax(workdir, tmp_path):
    from transformers import BertTokenizer

    vocab = ["[CLS]", "[PAD]", "[SEP]", "[UNK]", "[MASK]"] + sorted(
        {w for r in REPORTS for w in r.split()})
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    concepts = ["pleural, heart", "effusion", "", "no acute disease , mild cardiomegaly",
                " ".join(["lungs"] * 20), ["clear", "heart size"]]
    want = j_force_ids(BertTokenizer(str(tmp_path / "vocab.txt"), do_basic_tokenize=False),
                       concepts)
    got = t_force_ids(WordPieceTokenizer(str(tmp_path / "vocab.txt")), concepts)
    assert got.dtype == np.int32 and got.shape == (6, 16)
    np.testing.assert_array_equal(got, want)
    assert (got[2] == -1).all() and (got[4] >= 0).all()  # empty; truncated at 16


@pytest.fixture(scope="module")
def models(workdir, tmp_path_factory):
    """The validate loaders of both packages (vocabularies built from the
    train split first) and RRG_FORCE models with the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
        mp.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)
        jdir, tdir = tmp_path_factory.mktemp("jforce"), tmp_path_factory.mktemp("tforce")
        jconfig, tconfig = JConfig(_config(workdir, jdir)), TConfig(_config(workdir, tdir))
        logger = jset_logger(str(jdir), SEED)
        jcreate_data_loader(jconfig, "train", logger)
        tcreate_data_loader(tconfig, "train")
        jdl = jcreate_data_loader(jconfig, "validate", logger, called_by_validator=True)
        tdl = tcreate_data_loader(tconfig, "validate", called_by_validator=True)
        jmodel = JRRG_FORCE(decoder=dict(DECODER), cnn=dict(CNN), dl=jdl, dtype="float32")
        batch = {"images": jnp.zeros((2, 32, 32, 3)), "input_ids": jnp.zeros((2, 4), jnp.int32),
                 "attention_mask": jnp.ones((2, 4), jnp.int32)}
        v = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
        rng = np.random.default_rng(1)
        params = jax.tree.map(lambda x: np.asarray(x) + 0.2 * rng.normal(size=x.shape).astype(
            np.float32), v["params"])
        jmodel.variables = {"params": params,
                            "batch_stats": jax.tree.map(np.asarray, v["batch_stats"])}
        tmodel = TRRG_FORCE(decoder=dict(DECODER), cnn=dict(CNN), dl=tdl, dtype="float32",
                            device="cpu")
        tmodel.module.load_state_dict(rrg_state_dict_from_jax(jmodel.variables), strict=True)
        yield jmodel, jdl, tmodel, tdl


def test_evaluation_force_matches_jax(models):
    jmodel, jdl, tmodel, tdl = models
    want = jevaluation_force([jmodel], JConfig({}), jdl)
    got = tevaluation_force([tmodel], TConfig({}), tdl)
    assert got["refs"] == want["refs"] == [r for r in REPORTS]
    assert got["hyps"] == want["hyps"]
    for hyp, concept in zip(got["hyps"], CONCEPTS):
        assert concept in hyp.split(), (hyp, concept)


def test_rrg_force_trains_and_evaluates(workdir, tmp_path):
    """An epoch of 2 steps through the port's Trainor (the batches carry the
    ``concepts`` strings), then the constrained Validator."""
    config = TConfig(_config(workdir, tmp_path))
    tset_logger(str(tmp_path), SEED)
    trainor = TTrainor(config=config, seed=SEED, device="cpu")
    trainor.evaluator = TValidator(config=config, models=[trainor.model], seed=SEED)
    trainor.start()
    assert trainor.training_scheduler.iteration_count == 2
    assert np.isfinite(trainor.epoch_losses[0])
    assert "BLEU" in trainor.evaluator.scores[0]
    hyps = open(glob.glob(str(tmp_path / "*hyps.txt"))[0]).read().splitlines()
    assert all(c in h.split() for h, c in zip(hyps, CONCEPTS))
    assert isinstance(next(iter(trainor.dl))["concepts"], list)
    assert torch.is_tensor(next(iter(trainor.dl))["input_ids"])
