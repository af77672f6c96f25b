"""Image + sequence dataset (port of ``ImSeq`` of ``data/composites.py``;
the other composites wait for the models that read them)."""

from __future__ import annotations

from ..config.config import Config
from ..registry import register
from .image import ImageDataset
from .text import TextDataset


def _as_dict(cfg):
    return cfg.to_dict() if isinstance(cfg, Config) else dict(cfg or {})


@register("dataset")
class ImSeq:
    """Merges an :class:`ImageDataset` and a :class:`TextDataset` item by
    item and batch by batch; exposes the text side's tokenizer."""

    def __init__(self, seq, image, split, ckpt_dir=None, called_by_ensemblor=False,
                 seed: int = 0, **kwargs):
        self.split = split
        self.seq = TextDataset(**_as_dict(seq), split=split, ckpt_dir=ckpt_dir)
        self.image = ImageDataset(**_as_dict(image), split=split,
                                  called_by_ensemblor=called_by_ensemblor, seed=seed)
        if len(self.image) != len(self.seq):
            raise ValueError(f"{len(self.image)} images vs {len(self.seq)} sentences")
        self.tokenizer = self.seq.tokenizer
        self.tokenizer_max_len = self.seq.tokenizer_max_len

    def __len__(self):
        return len(self.image)

    def decode(self, index):
        return self.image.decode(index), self.seq[index]

    def finish(self, decoded):
        images, seq = decoded
        return {**self.image.finish(images), **seq}

    def __getitem__(self, index):
        return self.finish(self.decode(index))

    def get_collate_fn(self):
        seq_fn, image_fn = self.seq.get_collate_fn(), self.image.get_collate_fn()

        def collate_fn(batch):
            return {**seq_fn(batch), **image_fn(batch)}

        return collate_fn

    def __repr__(self):
        return "ImSeq\n" + str(self.seq) + "\n" + str(self.image)
