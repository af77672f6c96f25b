"""Label dataset (port of ``data/label.py``).

The label vocabulary is built from the train split's ``{root}/train.{file}``
and saved to ``ckpt_dir/labels.tok`` (kept if it exists); every split reads
it back from there. A row's labels are comma
separated: a single-label vocabulary gives each row its index, a
multi-label one a multi-hot f32 vector; a label absent from the vocabulary
gives the ignore index -100. Batches are ``{"labels": (B,) int64 or (B, C)
f32}`` CPU tensors. The JAX package's zoo options (``label_file``,
``inference_only``) are not ported.
"""

from __future__ import annotations

import json
import os
import numpy as np
import torch

from ..registry import register
from .utils import Labels, load_file

IGNORE_INDEX = -100


@register("dataset")
class LabelDataset:
    def __init__(self, root=None, split=None, file=None, ckpt_dir=None, **kwargs):
        if split is None or file is None:
            raise ValueError("LabelDataset needs a split and a file")
        self.root = root
        self.split = split
        raw_labels = load_file(os.path.join(root, split + "." + file))
        self.label_file = os.path.join(ckpt_dir, "labels.tok")
        if split == "train" and not os.path.exists(self.label_file):
            Labels(raw_labels).dump(self.label_file)
        if not os.path.exists(self.label_file):
            raise FileNotFoundError(f"label file {self.label_file} does not exist: verify the "
                                    "path or start a training")
        self.labels_map = Labels().load(self.label_file)
        self.labels = [self.get_processed_label(l) for l in raw_labels]

    def get_processed_label(self, label: str):
        classes = label.split(",")
        try:
            if not self.labels_map.multi_label:
                return np.int64(self.labels_map.label2idx[classes[0]])
            multi_hot = np.zeros(len(self.labels_map), dtype=np.float32)
            multi_hot[[self.labels_map.label2idx[c] for c in classes]] = 1.0
            return multi_hot
        except KeyError:  # a label the train split lacks
            return np.int64(IGNORE_INDEX)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, index):
        return {"label": self.labels[index]}

    def get_collate_fn(self):
        def collate_fn(batch):
            return {"labels": torch.from_numpy(np.stack([s["label"] for s in batch]))}

        return collate_fn

    def __repr__(self):
        return "LabelDataset\n" + json.dumps({"num_labels": len(self.labels_map),
                                              "multi_label": self.labels_map.multi_label},
                                             indent=4, default=str)
