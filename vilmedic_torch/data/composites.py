"""Composite datasets (port of ``ImSeq``, ``Seq2Seq``, ``ImSeq2Seq``,
``ImLabel`` and ``ImSeqAny`` of ``data/composites.py``; the other
composites wait for the models that read them). Each merges its children's
items and collates and exposes the tokenizer or label-map attributes the
models and the evaluation read; ``ImSeq``, ``Seq2Seq``, ``ImSeq2Seq`` and
``ImLabel`` also build a batch from raw inputs (``inference``, the JAX
package's zoo API: the children's batches merged, their sizes checked)."""

from __future__ import annotations

from ..config.config import Config
from ..registry import register
from .anyfield import AnyDataset
from .image import ImageDataset
from .label import LabelDataset
from .text import TextDataset


def _as_dict(cfg):
    return cfg.to_dict() if isinstance(cfg, Config) else dict(cfg or {})


def _check_batch(batch):
    sizes = {len(v) for v in batch.values() if v is not None}
    if len(sizes) > 1:
        raise ValueError("elements in batch do not have the same size")
    return batch


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

    def inference(self, seq=None, image=None):
        batch = {}
        if image is not None:
            batch.update(self.image.inference(image))
        if seq is not None:
            batch.update(self.seq.inference(seq))
        return _check_batch(batch)

    def __repr__(self):
        return "ImSeq\n" + str(self.seq) + "\n" + str(self.image)


@register("dataset")
class Seq2Seq:
    """A source and a target :class:`TextDataset` (vocabularies
    ``vocab.src`` and ``vocab.tgt`` built from the corpus); the target
    collates to ``decoder_input_ids`` / ``decoder_attention_mask``."""

    def __init__(self, src, tgt, split, ckpt_dir=None, **kwargs):
        self.split = split
        self.src = TextDataset(**{**_as_dict(src), "source": "src"}, split=split,
                               ckpt_dir=ckpt_dir)
        self.tgt = TextDataset(**{**_as_dict(tgt), "source": "tgt"}, split=split,
                               ckpt_dir=ckpt_dir)
        if len(self.src) != len(self.tgt):
            raise ValueError(f"{len(self.src)} sources vs {len(self.tgt)} targets")
        self.tgt_tokenizer = self.tgt.tokenizer
        self.tgt_tokenizer_max_len = self.tgt.tokenizer_max_len

    def __len__(self):
        return len(self.src)

    def __getitem__(self, index):
        return {**self.src[index], **self.tgt[index]}

    def get_collate_fn(self):
        src_fn, tgt_fn = self.src.get_collate_fn(), self.tgt.get_collate_fn()

        def collate_fn(batch):
            tgt = tgt_fn(batch)
            return {**src_fn(batch), "decoder_input_ids": tgt["input_ids"],
                    "decoder_attention_mask": tgt["attention_mask"]}

        return collate_fn

    def inference(self, src=None, tgt=None):
        batch = {}
        if src is not None:
            batch.update(self.src.inference(src))
        if tgt is not None:
            t = self.tgt.inference(tgt)
            batch["decoder_input_ids"] = t["input_ids"]
            batch["decoder_attention_mask"] = t["attention_mask"]
        return _check_batch(batch)

    def __repr__(self):
        return "Seq2Seq\n" + str(self.src) + "\n" + str(self.tgt)


@register("dataset")
class ImSeq2Seq:
    """A :class:`Seq2Seq` and an :class:`ImageDataset`, item by item and
    batch by batch (the Seq2Seq keys, then the image keys); exposes the
    target side's tokenizer."""

    def __init__(self, src, tgt, image, split, ckpt_dir=None, called_by_ensemblor=False,
                 seed: int = 0, **kwargs):
        self.split = split
        self.seq2seq = Seq2Seq(src, tgt, split=split, ckpt_dir=ckpt_dir)
        self.image = ImageDataset(**_as_dict(image), split=split,
                                  called_by_ensemblor=called_by_ensemblor, seed=seed)
        if len(self.image) != len(self.seq2seq):
            raise ValueError(f"{len(self.image)} images vs {len(self.seq2seq)} pairs")
        self.src, self.tgt = self.seq2seq.src, self.seq2seq.tgt
        self.tgt_tokenizer = self.seq2seq.tgt_tokenizer
        self.tgt_tokenizer_max_len = self.seq2seq.tgt_tokenizer_max_len

    def __len__(self):
        return len(self.image)

    def decode(self, index):
        return self.image.decode(index), self.seq2seq[index]

    def finish(self, decoded):
        images, pair = decoded
        return {**self.image.finish(images), **pair}

    def __getitem__(self, index):
        return self.finish(self.decode(index))

    def get_collate_fn(self):
        pair_fn, image_fn = self.seq2seq.get_collate_fn(), self.image.get_collate_fn()

        def collate_fn(batch):
            return {**pair_fn(batch), **image_fn(batch)}

        return collate_fn

    def inference(self, src=None, tgt=None, image=None):
        batch = {}
        if image is not None:
            batch.update(self.image.inference(image))
        batch.update(self.seq2seq.inference(src=src, tgt=tgt))
        return _check_batch(batch)

    def __repr__(self):
        return "ImSeq2Seq\n" + str(self.seq2seq) + "\n" + str(self.image)


@register("dataset")
class ImLabel:
    """An :class:`ImageDataset` and a :class:`~.label.LabelDataset`, item by
    item and batch by batch; exposes the label map."""

    def __init__(self, label, image, split, ckpt_dir=None, called_by_ensemblor=False,
                 seed: int = 0, **kwargs):
        self.split = split
        self.image = ImageDataset(**_as_dict(image), split=split,
                                  called_by_ensemblor=called_by_ensemblor, seed=seed)
        self.label = LabelDataset(**_as_dict(label), split=split, ckpt_dir=ckpt_dir)
        if len(self.image) != len(self.label):
            raise ValueError(f"{len(self.image)} images vs {len(self.label)} labels")
        self.labels_map = self.label.labels_map

    def __len__(self):
        return len(self.image)

    def decode(self, index):
        return self.image.decode(index), self.label[index]

    def finish(self, decoded):
        images, label = decoded
        return {**self.image.finish(images), **label}

    def __getitem__(self, index):
        return self.finish(self.decode(index))

    def get_collate_fn(self):
        image_fn, label_fn = self.image.get_collate_fn(), self.label.get_collate_fn()

        def collate_fn(batch):
            return {**image_fn(batch), **label_fn(batch)}

        return collate_fn

    def inference(self, image=None, label=None):
        batch = {}
        if image is not None:
            batch.update(self.image.inference(image))
        if label is not None:
            batch.update(self.label.inference(label))
        return _check_batch(batch)

    def __repr__(self):
        return "ImLabel\n" + str(self.image) + "\n" + str(self.label)


@register("dataset")
class ImSeqAny:
    """:class:`ImSeq` plus an :class:`~.anyfield.AnyDataset` payload (the
    ``concepts`` of RRG_FORCE) under its ``name``."""

    def __init__(self, seq, image, any, split, ckpt_dir=None, called_by_ensemblor=False,
                 seed: int = 0, **kwargs):
        self.split = split
        self.imgseq = ImSeq(seq, image, split=split, ckpt_dir=ckpt_dir,
                            called_by_ensemblor=called_by_ensemblor, seed=seed)
        self.any = AnyDataset(**_as_dict(any), split=split)
        if len(self.imgseq) != len(self.any):
            raise ValueError(f"{len(self.imgseq)} image-report pairs vs {len(self.any)} lines")
        self.image = self.imgseq.image  # the device preprocessing reads it
        self.tokenizer = self.imgseq.tokenizer
        self.tokenizer_max_len = self.imgseq.tokenizer_max_len

    def __len__(self):
        return len(self.any)

    def decode(self, index):
        return self.imgseq.decode(index), self.any[index]

    def finish(self, decoded):
        pair, payload = decoded
        return {**self.imgseq.finish(pair), **payload}

    def __getitem__(self, index):
        return self.finish(self.decode(index))

    def get_collate_fn(self):
        imgseq_fn, any_fn = self.imgseq.get_collate_fn(), self.any.get_collate_fn()

        def collate_fn(batch):
            return {**imgseq_fn(batch), **any_fn(batch)}

        return collate_fn

    def __repr__(self):
        return "ImSeqAny\n" + str(self.imgseq) + "\n" + str(self.any)
