"""Untyped per-line payload under a configurable key (port of
``data/anyfield.py``): RRG_FORCE's ``concepts``."""

from __future__ import annotations

import json
import os

from ..registry import register
from .processing import get_processing


@register("dataset")
class AnyDataset:
    """Line ``i`` of ``{root}/{split}.{file}``, cleaned by ``processing``,
    as item ``i``'s ``name`` key; batches collate to a list of strings."""

    def __init__(self, root=None, file=None, split=None, processing=None, name=None, **kwargs):
        if split is None:
            raise ValueError("split cannot be None")
        self.root = root
        self.file = file
        self.split = split
        self.name = name or "any"
        self.processing = get_processing(processing)
        with open(os.path.join(root, split + "." + file)) as f:
            self.lines = [self.processing(line.strip()) for line in f]

    def __getitem__(self, index):
        return {self.name: self.lines[index]}

    def __len__(self):
        return len(self.lines)

    def get_collate_fn(self):
        def collate_fn(batch):
            return {self.name: [s[self.name] for s in batch]}

        return collate_fn

    def __repr__(self):
        return "AnyDataset\n" + json.dumps({"root": self.root, "file": self.file,
                                            "name": self.name}, indent=4, default=str)
