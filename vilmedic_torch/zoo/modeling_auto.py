"""The model zoo's one-line loading (port of ``zoo/modeling_auto.py``).

``AutoModel.from_pretrained(dir_or_zoo_name)`` reads a checkpoint directory
(a local path, or a :data:`MODEL_ZOO` name found in the local cache
``constants.MODEL_ZOO_CACHE_DIR``; nothing is fetched), loads its
``.ckpt`` (the port's ``torch.save`` file or the JAX package's flax
msgpack, ``executors.checkpoint.load_checkpoint``), rebuilds the dataset of
the saved config in its zoo mode (every section ``inference_only``, split
``test``, ``ckpt_dir`` = the directory, so vocabularies and label maps come
from there; ``num_workers`` dropped) and builds the model through
``executors.utils.create_model`` with that dataset's loader and the
checkpoint's state dict, on ``device`` (the card unless the caller names
another). It returns ``(model, dataset)``; ``dataset.inference(...)``
makes a batch from raw inputs::

    model, dataset = AutoModel.from_pretrained("ckpt/rrg_mimic")
    batch = dataset.inference(seq=["..."], image=["xray.jpg"])
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

from .. import registry
from ..config.config import Config
from ..constants import MODEL_ZOO_CACHE_DIR
from ..data.loader import DataLoader
from ..executors.checkpoint import load_checkpoint
from ..executors.utils import create_model

#: the reference's public zoo names; they resolve only in the local cache
MODEL_ZOO = {
    "rrg/baseline-mimic": "RRG trained on MIMIC-CXR impressions",
    "rrg/baseline-padchest": "RRG trained on PadChest",
    "rrg/baseline-indiana": "RRG trained on Indiana (Open-I)",
    "rrg/biomed-roberta-baseline-mimic": "RRG biomed-roberta decoder, MIMIC-CXR",
    "rrg/biomed-roberta-baseline-indiana": "RRG biomed-roberta decoder, Indiana",
    "rrs/biomed-roberta-baseline-mimic": "RRS biomed-roberta, MIMIC-CXR",
    "rrs/baseline-mimic": "RRS trained on MIMIC-CXR",
    "selfsup/convirt-mimic": "ConVIRT pretrained on MIMIC-CXR",
    "selfsup/convirt-mimic-balanced": "ConVIRT balanced sampling",
    "selfsup/convirt-padchest-16": "ConVIRT PadChest 16",
    "selfsup/convirt-padchest-32": "ConVIRT PadChest 32",
    "selfsup/gloria-chexpert": "GLoRIA pretrained on CheXpert",
    "selfsup/gloria-mimic-48": "GLoRIA MIMIC-CXR 48",
    "selfsup/simclr-mimic-16": "SimCLR MIMIC 16",
    "selfsup/simclr-mimic-32": "SimCLR MIMIC 32",
    "selfsup/simclr-mimic-64": "SimCLR MIMIC 64",
    "selfsup/vae-mimic": "VAE MIMIC",
    "selfsup/vae-indiana": "VAE Indiana",
    "selfsup/vae-padchest": "VAE PadChest",
    "mvqa/mvqa-imageclef": "MVQA ImageCLEF",
}


class AutoModel:
    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path: str, logger=None, device="cuda"
                        ) -> Tuple[object, object]:
        """``(model, dataset)`` of a checkpoint directory (module doc)."""
        from ..data import composites  # noqa: F401  (registers the composite datasets)

        path = cls._resolve(pretrained_model_name_or_path)
        ckpts = sorted(glob.glob(os.path.join(path, "*.ckpt")))
        if not ckpts:
            raise FileNotFoundError(f"no checkpoint found in {path}")
        state = load_checkpoint(ckpts[0])
        config = Config(state["config"])
        dataset_config = config.dataset.to_dict()
        for section in dataset_config.values():
            if isinstance(section, dict):
                section["inference_only"] = True
        proto = dataset_config.pop("proto")
        dataset_config.pop("num_workers", None)
        dataset = registry.get("dataset", proto)(split="test", ckpt_dir=path,
                                                 called_by_ensemblor=True, **dataset_config)
        dl = DataLoader(dataset, batch_size=4, num_workers=0)
        model = create_model(config, dl=dl, logger=logger, state_dict=state, device=device)
        return model, dataset

    @staticmethod
    def _resolve(name_or_path: str) -> str:
        if os.path.isdir(name_or_path):
            return name_or_path
        if name_or_path in MODEL_ZOO:
            cached = os.path.join(MODEL_ZOO_CACHE_DIR, name_or_path)
            if os.path.isdir(cached):
                return cached
            raise FileNotFoundError(
                f"Zoo model {name_or_path!r} is not in the local cache ({cached}) and this "
                f"environment has no network egress. Place the checkpoint directory there "
                f"or pass a local path.")
        raise KeyError(f"Unknown zoo name {name_or_path!r}; known: {sorted(MODEL_ZOO)}")
