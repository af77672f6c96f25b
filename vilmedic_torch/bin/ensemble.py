"""Ensemble / test CLI: re-score a run's saved checkpoints, ensembling them
(port of ``bin_tpu/ensemble.py``).

    python -m vilmedic_torch.bin.ensemble config.yml [key=value ...]

Reads the checkpoints ``{tag}_{epoch}_{seed}.ckpt`` of ``ckpt_dir/name``,
picks them by the config's ``ensemblor.mode`` (:func:`get_ckpts`: ``all``,
or ``best-N`` by the tag, highest first), loads the N models on the card
(the top-level ``device`` key names another device, e.g. ``device=cpu``)
and runs the :class:`~vilmedic_torch.executors.Validator` over the
``ensemblor:`` splits. An RRG-style model serves the ensemble route of
``make_generate_fn`` (the members' heads summed at each step), an MVQA the
classifier's ensemble evaluation (the members' logits averaged).
:func:`main` returns the Validator.
"""

from __future__ import annotations

import glob
import os

from ..config.config import executor_config, get_args
from ..executors import Validator
from ..executors.checkpoint import load_checkpoint
from ..executors.utils import create_data_loader, create_model
from ..utils import extract_seed_from_ckpt, set_logger
from ..utils.logger import SETTINGS_LEVEL


def get_ckpts(ckpt_dir: str, mode: str = "best-1"):
    """The checkpoints of ``ckpt_dir`` that ``mode`` picks: ``all`` (in
    glob order) or ``best-N``, the N highest tags."""
    ckpts = glob.glob(os.path.join(ckpt_dir, "*.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    if mode == "all":
        return ckpts
    if not mode.startswith("best-"):
        raise ValueError(f"unknown ensemblor mode {mode!r}: 'all' or 'best-N'")
    n = int(mode.split("-")[1])
    return sorted(ckpts, key=lambda p: float(os.path.basename(p).split("_")[0]),
                  reverse=True)[:n]


def main(argv=None) -> Validator:
    config, _ = get_args(argv)
    ens_config = executor_config(config, "ensemblor")
    ckpt_dir = os.path.join(config.ckpt_dir, config.name)
    ens_config.ckpt_dir = ckpt_dir
    device = config.get("device", "cuda")

    ckpts = get_ckpts(ckpt_dir, ens_config.get("mode", "best-1"))
    seed = extract_seed_from_ckpt(ckpts[0])
    logger = set_logger(ckpt_dir, seed)
    logger.log(SETTINGS_LEVEL, f"Ensembling {len(ckpts)} checkpoints: {ckpts}")

    dl = create_data_loader(ens_config, split="train", logger=logger, called_by_validator=True,
                            called_by_ensemblor=True, seed=int(seed))
    models = [create_model(ens_config, dl=dl, logger=logger, state_dict=load_checkpoint(ckpt),
                           seed=int(seed), device=device) for ckpt in ckpts]
    evaluator = Validator(config=ens_config, models=models, seed=seed, from_training=False)
    evaluator.start()
    return evaluator


if __name__ == "__main__":
    main()
