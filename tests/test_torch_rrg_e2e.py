"""RRG training and evaluation end to end: the port's CLI
(``python -m vilmedic_torch.bin.train``, its ``main``) against the JAX
package's ``Trainor`` + ``Validator`` as ``bin_tpu/train.py`` builds them,
on the CPU, float32, on the synthetic JPEG fixture of
``tests/test_train_e2e.py`` (8 reports, r2gen-cleaned, corpus vocabulary).

Both sides read one config file: ``config/RRG/baseline-mimic.yml`` cut down
by dotlist overrides (``densenet_tiny``, a 1-layer decoder of width 32,
hidden dropout 0, float32, RAdam at lr 1e-3; 2 epochs of 2 steps, beam 2,
BLEU / ROUGEL / CIDERD, early stop on BLEU) and written out without its
``weight_decay: 0.``, which the JAX package hands to ``optax.radam``, where
it raises. The JAX model's initial
variables are copied into the port's Trainor before ``start()``, and JAX's
random train crops draw from a generator of the config's seed, as the
port's do. Required: per-epoch losses within 1e-5, equal hyps and scores
(within 1e-12), equal checkpoint names, iteration counts and early-stop
state.
"""

import glob
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import vilmedic_torch.bin.train as tcli
import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.config.config import executor_config, load_config
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
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
SEED = 424242
TINY = (8, (2, 2), 16)
TOL_LOSS, TOL_SCORE = 1e-5, 1e-12


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("rrg_e2e")
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


def _overrides(root, ckpt_dir):
    return [
        f"ckpt_dir={ckpt_dir}", "name=e2e", f"seed={SEED}", "model.dtype=float32",
        f"dataset.image.root={root}", "dataset.image.file=image.tok", "dataset.image.resize=40",
        "dataset.image.crop=32", f"dataset.seq.root={root}", "dataset.seq.file=report.tok",
        "dataset.seq.tokenizer_max_len=12", "dataset.num_workers=0",
        "model.cnn.backbone=densenet_tiny", "model.cnn.visual_projection.in_features=32",
        "model.cnn.visual_projection.out_features=32", "model.decoder.hidden_size=32",
        "model.decoder.num_attention_heads=4", "model.decoder.intermediate_size=64",
        "model.decoder.max_position_embeddings=64", "model.decoder.hidden_dropout_prob=0.0",
        "trainor.batch_size=4", "trainor.epochs=1", "trainor.optim_params.lr=0.001",
        "trainor.early_stop_metric=BLEU", "validator.batch_size=4", "validator.beam_width=2",
        "validator.metrics=[BLEU,ROUGEL,CIDERD]", "validator.shard_eval=false",
    ]


def _config_file(root, ckpt_dir, path):
    """The cut-down flagship config as one file, without RAdam's
    ``weight_decay`` (see the module doc)."""
    config, _ = load_config("config/RRG/baseline-mimic.yml", _overrides(root, ckpt_dir))
    config = config.to_dict()
    del config["trainor"]["optim_params"]["weight_decay"]
    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.fixture(scope="module")
def runs(workdir, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
        mp.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)

        # the JAX side, as bin_tpu/train.py builds it
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
        initial = {k: np.array(v) for k, v in rrg_state_dict_from_jax(
            {"params": jtrainor.model.variables["params"],
             "batch_stats": jtrainor.model.variables["batch_stats"]}).items()}
        jhyps = []
        jeval = jtrainor.evaluator.start

        def jstart():
            jeval()
            jhyps.append(open(os.path.join(ckpt_dir, f"validate_{SEED}_hyps.txt")).read())

        jtrainor.evaluator.start = jstart
        jtrainor.start()

        # the port, through its CLI, from the same initial weights
        class Seeded(TTrainor):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.model.module.load_state_dict(
                    {k: torch.from_numpy(v) for k, v in initial.items()}, strict=True)

        thyps = []
        tdir = tmp_path_factory.mktemp("torch_ckpt")
        mp.setattr(tcli, "Trainor", Seeded)
        tdir_run = os.path.join(str(tdir), "e2e")
        from vilmedic_torch.executors.validator import Validator as TValidator

        tstart = TValidator.start

        def recording_start(self):
            scores = tstart(self)
            thyps.append(open(os.path.join(tdir_run, f"validate_{SEED}_hyps.txt")).read())
            return scores

        mp.setattr(TValidator, "start", recording_start)
        ttrainor = tcli.main([_config_file(workdir, tdir, tdir / "config.yml"), "device=cpu"])
        yield dict(j=jtrainor, t=ttrainor, jdir=ckpt_dir, tdir=tdir_run, jhyps=jhyps,
                   thyps=thyps)


def test_epoch_losses_match_jax(runs):
    j, t = runs["j"], runs["t"]
    assert len(t.epoch_losses) == len(j.epoch_losses) == 2
    np.testing.assert_allclose(t.epoch_losses, j.epoch_losses, rtol=TOL_LOSS, atol=TOL_LOSS)


def test_hyps_and_scores_match_jax(runs):
    """Every evaluation's hypotheses equal, and the last one's scores."""
    assert len(runs["thyps"]) == len(runs["jhyps"]) == 2
    assert runs["thyps"] == runs["jhyps"]
    want, got = runs["j"].evaluator.scores[0], runs["t"].evaluator.scores[0]
    assert sorted(got) == sorted(want) == ["BLEU", "CIDERD", "ROUGEL", "validation_loss"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_SCORE, atol=TOL_SCORE)


def test_checkpoints_and_schedule_match_jax(runs):
    """Best-only checkpoints of the same names (``{tag}_{epoch}_{seed}``),
    the same iteration count and early-stop state, and a config dump."""
    names = lambda d: sorted(os.path.basename(p) for p in glob.glob(os.path.join(d, "*.ckpt")))  # noqa: E731
    assert names(runs["tdir"]) == names(runs["jdir"])
    assert len(names(runs["tdir"])) == 1 and names(runs["tdir"])[0].endswith(f"_{SEED}.ckpt")
    js, ts = runs["j"].training_scheduler, runs["t"].training_scheduler
    assert ts.iteration_count == js.iteration_count == 4
    assert (ts.early_stop, ts.current_best_metric) == (js.early_stop, js.current_best_metric)
    assert ts.lr_decay_params == js.lr_decay_params and ts._lr == js._lr
    assert os.path.exists(os.path.join(runs["tdir"], f"config_{SEED}.json"))


def test_checkpoint_reloads_into_the_same_sequences(runs):
    """The best checkpoint, loaded into a fresh model, generates the
    hypotheses its epoch's evaluation wrote."""
    from vilmedic_torch.config.config import Config
    from vilmedic_torch.executors.checkpoint import CheckpointSaver, load_checkpoint
    from vilmedic_torch.executors.utils import create_model
    from vilmedic_torch.models.evaluation_nlg import evaluation

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)
        t = runs["t"]
        path = glob.glob(os.path.join(runs["tdir"], "*.ckpt"))[0]
        _, epoch = CheckpointSaver.extract_tag_and_step(path)
        state = load_checkpoint(path)
        model = create_model(Config(state["config"]), dl=t.dl, state_dict=state, device="cpu")
        _, dl = t.evaluator.splits[0]
        hyps = evaluation([model], Config({"beam_width": 2}), dl)["hyps"]
        assert "\n".join(hyps) == runs["thyps"][epoch - 1]
