"""Train CLI: ``python -m vilmedic_torch.bin.train config.yml [key=value ...]``
(port of ``bin_tpu/train.py``).

Parses the config and its dotlist overrides, makes ``ckpt_dir/name``, picks
the seed (from a resumed checkpoint's name, else the config's ``seed`` or a
random one), dumps the config as ``config_{seed}.json``, builds the
``Trainor`` and a ``Validator`` over the trained model and starts training.
Trains on the card; the top-level ``device`` key names another device
(``device=cpu``). :func:`main` returns the ``Trainor``.
"""

from __future__ import annotations

import json
import os

from ..config.config import executor_config, get_args
from ..executors import Trainor, Validator
from ..utils import extract_seed_from_ckpt, get_seed, set_logger
from ..utils.logger import SETTINGS_LEVEL


def main(argv=None) -> Trainor:
    config, override = get_args(argv)
    train_config = executor_config(config, "trainor")
    val_config = executor_config(config, "validator")

    ckpt_dir = os.path.join(config.ckpt_dir, config.name)
    os.makedirs(ckpt_dir, exist_ok=True)
    train_config.ckpt_dir = ckpt_dir
    val_config.ckpt_dir = ckpt_dir

    seed = (extract_seed_from_ckpt(train_config.ckpt) if train_config.get("ckpt")
            else get_seed(train_config.get("seed")))
    logger = set_logger(ckpt_dir, seed)
    with open(os.path.join(ckpt_dir, f"config_{seed}.json"), "w") as f:
        json.dump(config.to_dict(), f, indent=4, default=str)
    logger.log(SETTINGS_LEVEL, "Override dict")
    logger.info(json.dumps(override.to_dict(), indent=4, default=str))

    trainor = Trainor(config=train_config, seed=seed, device=config.get("device", "cuda"))
    trainor.evaluator = Validator(config=val_config, models=[trainor.model], seed=seed,
                                  from_training=True)
    trainor.start()
    return trainor


if __name__ == "__main__":
    main()
