"""``config/RRG/baseline-mimic-vit.yml`` (RRG with a trainable pre-LN ViT
tower, tanh GELU, and the JAX package's ``rng_impl: rbg``) end to end: the
port's train CLI against the JAX package's ``Trainor`` + ``Validator``, on
the CPU, float32, on the JPEG fixture of tests/test_torch_rrg_e2e.py.

The config is cut down by dotlist overrides (a 1-layer ViT of 32 at 32² /
16, the 1-layer decoder at 32, dropout 0, batch 4, 2 epochs, beam 2) and
written without RAdam's ``weight_decay``, which ``optax.radam`` rejects;
the Validator's list is cut to the ported NLG metrics (BLEU, ROUGEL,
METEOR, CIDERD: the flagship's clinical scorers need weights the
repository does not have). The JAX model's initial variables are copied
into the port. Required: per-epoch losses within 1e-5 relative, equal
hypotheses, scores within 1e-12, and ``rng_impl`` accepted (logged, no
effect) by the port.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import vilmedic_torch.bin.train as tcli
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.config.config import executor_config, load_config
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
from vilmedic_tpu.scorers.nlg import meteor as jmeteor
from vilmedic_tpu.utils import set_logger as jset_logger

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
SEED = 363636
TOL_LOSS, TOL_SCORE = 1e-5, 1e-12


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("rrg_vit")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(len(REPORTS)):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    for split in ("train", "validate"):
        (root / f"{split}.report.tok").write_text("\n".join(REPORTS))
        (root / f"{split}.image.tok").write_text("\n".join(paths))
    return root


def _config_file(root, ckpt_dir, path):
    config, _ = load_config("config/RRG/baseline-mimic-vit.yml", [
        f"ckpt_dir={ckpt_dir}", "name=vit", f"seed={SEED}", "model.dtype=float32",
        f"dataset.image.root={root}", "dataset.image.file=image.tok", "dataset.image.resize=40",
        "dataset.image.crop=32", f"dataset.seq.root={root}", "dataset.seq.file=report.tok",
        "dataset.seq.tokenizer_max_len=12", "dataset.num_workers=0",
        "model.cnn.hidden_size=32", "model.cnn.num_hidden_layers=1",
        "model.cnn.num_attention_heads=4", "model.cnn.intermediate_size=64",
        "model.cnn.visual_projection.in_features=32", "model.cnn.visual_projection.out_features=32",
        "model.decoder.hidden_size=32", "model.decoder.num_attention_heads=4",
        "model.decoder.intermediate_size=64", "model.decoder.max_position_embeddings=64",
        "model.decoder.hidden_dropout_prob=0.0", "trainor.batch_size=4", "trainor.epochs=1",
        "trainor.early_stop_metric=BLEU", "validator.batch_size=4", "validator.beam_width=2",
        "validator.metrics=[BLEU,ROUGEL,METEOR,CIDERD]", "validator.shard_eval=false",
    ])
    config = config.to_dict()
    del config["trainor"]["optim_params"]["weight_decay"]
    assert config["trainor"]["rng_impl"] == "rbg" and config["model"]["cnn"]["pre_ln"]
    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.fixture(scope="module")
def runs(workdir, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("METEOR_SYNONYMS", raising=False)
        mp.delenv("METEOR_PARAPHRASE", raising=False)
        mp.setattr(jmeteor._Matchers, "_instance", None)
        jdir = tmp_path_factory.mktemp("jax_ckpt")
        config, _ = load_config(_config_file(workdir, jdir, jdir / "config.yml"))
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
        initial = {k: v.numpy().copy() for k, v in rrg_state_dict_from_jax(
            jax.tree.map(np.asarray, dict(jtrainor.model.variables))).items()}
        jhyps = []
        jeval = jtrainor.evaluator.start

        def jstart():
            jeval()
            jhyps.append(open(os.path.join(ckpt_dir, f"validate_{SEED}_hyps.txt")).read())

        jtrainor.evaluator.start = jstart
        jtrainor.start()

        class Seeded(TTrainor):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.model.module.load_state_dict(
                    {k: torch.from_numpy(v) for k, v in initial.items()}, strict=True)

        from vilmedic_torch.executors.validator import Validator as TValidator

        thyps = []
        tdir = tmp_path_factory.mktemp("torch_ckpt")
        tdir_run = os.path.join(str(tdir), "vit")
        tstart = TValidator.start

        def recording_start(self):
            scores = tstart(self)
            thyps.append(open(os.path.join(tdir_run, f"validate_{SEED}_hyps.txt")).read())
            return scores

        mp.setattr(tcli, "Trainor", Seeded)
        mp.setattr(TValidator, "start", recording_start)
        ttrainor = tcli.main([_config_file(workdir, tdir, tdir / "config.yml"), "device=cpu"])
        yield dict(j=jtrainor, t=ttrainor, jhyps=jhyps, thyps=thyps)


def test_vit_tower_is_built_and_trained(runs):
    enc = runs["t"].model.module.enc
    assert enc.is_vit and enc.model.pre_ln and enc.model.config.hidden_act == "gelu_tanh"
    assert enc.model.pos_embed.shape == (1, 5, 32)  # 32² / 16: 4 patches + CLS
    names = set(runs["t"].tx.names)
    assert any(n.startswith("enc.model.layer_0.") for n in names)  # the tower trains


def test_epoch_losses_match_jax(runs):
    j, t = runs["j"], runs["t"]
    assert len(t.epoch_losses) == len(j.epoch_losses) == 2
    np.testing.assert_allclose(t.epoch_losses, j.epoch_losses, rtol=TOL_LOSS)


def test_hyps_and_scores_match_jax(runs):
    assert len(runs["thyps"]) == len(runs["jhyps"]) == 2
    assert runs["thyps"] == runs["jhyps"]
    want, got = runs["j"].evaluator.scores[0], runs["t"].evaluator.scores[0]
    assert sorted(got) == sorted(want) == ["BLEU", "CIDERD", "METEOR", "ROUGEL",
                                           "validation_loss"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_SCORE, atol=TOL_SCORE)
