"""Train CLI: ``python -m vilmedic_torch.bin.train config.yml [key=value ...]``
(port of ``bin_tpu/train.py``).

Parses the config and its dotlist overrides, makes ``ckpt_dir/name``, picks
the seed (from a resumed checkpoint's name, else the config's ``seed`` or a
random one), dumps the config as ``config_{seed}.json``, builds the
``Trainor`` and a ``Validator`` over the trained model and starts training.
Trains on the card; the top-level ``device`` key names another device
(``device=cpu``). :func:`main` returns the ``Trainor``.

Under ``torchrun`` (``torchrun --nproc_per_node N -m vilmedic_torch.bin.train
config.yml ...``) it first starts the process group
(``parallel.mesh.init_distributed``: NCCL on the cards, one per process;
gloo with ``device=cpu``) and trains data parallel over the global
``batch_size``: process 0 picks the seed and writes the config and the
checkpoints.
"""

from __future__ import annotations

import json
import os

from ..config.config import executor_config, get_args
from ..executors import Trainor, Validator
from ..parallel import mesh
from ..utils import extract_seed_from_ckpt, get_seed, set_logger
from ..utils.logger import SETTINGS_LEVEL


def main(argv=None) -> Trainor:
    config, override = get_args(argv)
    device = config.get("device", "cuda")
    mesh.init_distributed(device)
    device = mesh.local_device(device)
    train_config = executor_config(config, "trainor")
    val_config = executor_config(config, "validator")

    ckpt_dir = os.path.join(config.ckpt_dir, config.name)
    os.makedirs(ckpt_dir, exist_ok=True)
    train_config.ckpt_dir = ckpt_dir
    val_config.ckpt_dir = ckpt_dir

    seed = (extract_seed_from_ckpt(train_config.ckpt) if train_config.get("ckpt")
            else get_seed(train_config.get("seed")))
    seed = mesh.broadcast_json(seed)  # every process trains under process 0's seed
    logger = set_logger(ckpt_dir, seed)
    if mesh.process_index() == 0:
        with open(os.path.join(ckpt_dir, f"config_{seed}.json"), "w") as f:
            json.dump(config.to_dict(), f, indent=4, default=str)
    logger.log(SETTINGS_LEVEL, "Override dict")
    logger.info(json.dumps(override.to_dict(), indent=4, default=str))

    trainor = Trainor(config=train_config, seed=seed, device=device)
    trainor.evaluator = Validator(config=val_config, models=[trainor.model], seed=seed,
                                  from_training=True)
    trainor.start()
    return trainor


if __name__ == "__main__":
    main()
    mesh.destroy()
