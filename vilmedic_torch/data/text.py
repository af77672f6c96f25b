"""Text dataset: line files -> token id batches (port of ``data/text.py``).

Sentences come from ``{root}/{split}.{file}``, are cleaned by a registered
``processing`` function and split on whitespace. The tokenizer is the
pretrained one that ``tokenizer:`` names (a directory or a hub-cache name,
read by :class:`.auto_tokenizer.AutoTokenizer` from local files only), else
the WordPiece tokenizer of :mod:`.tokenizer` over a vocabulary file: the
one named by ``vocab_file``, or the vocabulary built from the train split
and dumped to ``ckpt_dir/vocab.{source}`` (later splits read the train
split's file), as the JAX package's ``BertTokenizer`` over the same file.

Special tokens are added on the target side only. Batches are padded to
``tokenizer_max_len`` (with truncation) when it is set, else to the longest
row rounded up to a multiple of 8 with ``pad_token_id or 0``. An
``hf_dataset`` gives the sentences of its ``hf_field`` instead of a file
(:mod:`.hf_plumbing`: ``hf_local`` reads a ``save_to_disk`` folder,
``hf_filter`` keeps rows). ``inference_only`` (the zoo's mode) reads
no data file: the tokenizer, or the vocabulary ``ckpt_dir/vocab.{source}``
a training wrote, and the cleaning are all it keeps, for
:meth:`TextDataset.inference`.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import torch

from ..registry import register
from .processing import get_processing
from .auto_tokenizer import AutoTokenizer
from .tokenizer import WordPieceTokenizer
from .utils import Vocab, load_file, pad_to_multiple


def split_sentences(sentences: List[str], processing) -> List[List[str]]:
    return [processing(s.strip()).split() for s in sentences]


def make_sentences(root: str, split: str, file: str, processing) -> List[List[str]]:
    return split_sentences(load_file(os.path.join(root, split + "." + file)), processing)


@register("dataset")
class TextDataset:
    def __init__(self, root=None, file=None, split=None, ckpt_dir=None, processing=None,
                 tokenizer=None, tokenizer_max_len=None, vocab_file=None, source="src",
                 hf_dataset=None, hf_field=None, hf_local=None, hf_filter=None,
                 inference_only: bool = False, **kwargs):
        if inference_only:  # the zoo's mode: no data file
            file, hf_dataset = None, None
        if source not in ("src", "tgt"):
            raise ValueError(f"source {source!r}: 'src' or 'tgt'")
        if split is None:
            raise ValueError("split cannot be None")
        if file is not None and vocab_file is not None:
            raise ValueError("give a data file or a vocab file, not both")
        if source == "tgt" and tokenizer_max_len is None:
            raise ValueError("tokenizer_max_len is required for source 'tgt'")

        self.root = root
        self.file = file
        self.split = split
        self.source = source
        self.ckpt_dir = ckpt_dir
        self.processing_name = processing
        self.processing = get_processing(processing)
        self.tokenizer_max_len = tokenizer_max_len
        self.sentences: Optional[List[List[str]]] = None
        if file is not None:
            self.sentences = make_sentences(root, split, file, self.processing)
        if hf_dataset is not None:
            from .hf_plumbing import process_hf_dataset

            dataset = process_hf_dataset(hf_dataset, hf_local, hf_filter, hf_field, split)
            self.sentences = split_sentences([d[hf_field] for d in dataset], self.processing)

        self.vocab_file = None
        if tokenizer is not None:
            self.tokenizer = AutoTokenizer.from_pretrained(tokenizer)
        else:
            if vocab_file is None:
                vocab_file = os.path.join(ckpt_dir, f"vocab.{source}")
                if split == "train" and not os.path.exists(vocab_file):
                    Vocab(self.sentences).dump(vocab_file)
            self.vocab_file = vocab_file
            self.tokenizer = WordPieceTokenizer(vocab_file)
        # the JAX collate's tokenizer call: special tokens on the target only
        self.add_special_tokens = source == "tgt"

    def __len__(self):
        return len(self.sentences or [])

    def __getitem__(self, index):
        return {f"{self.source}_seq": " ".join(self.sentences[index])}

    def inference(self, seq):
        """A batch from raw strings, cleaned and collated as the items are
        (the JAX package's zoo API)."""
        seq = seq if isinstance(seq, list) else [seq]
        return self.get_collate_fn()([
            {f"{self.source}_seq": " ".join(self.processing(s.strip()).split())} for s in seq])

    def get_collate_fn(self):
        key = f"{self.source}_seq"

        def collate_fn(batch):
            input_ids, mask = self.tokenizer.encode_batch(
                [s[key] for s in batch], max_length=self.tokenizer_max_len,
                add_special_tokens=self.add_special_tokens)
            if self.tokenizer_max_len is None:
                width = pad_to_multiple(input_ids.shape[1])
                pad = width - input_ids.shape[1]
                input_ids = torch.nn.functional.pad(torch.from_numpy(input_ids), (0, pad),
                                                    value=self.tokenizer.pad_token_id or 0)
                mask = torch.nn.functional.pad(torch.from_numpy(mask), (0, pad))
                return {"input_ids": input_ids, "attention_mask": mask}
            return {"input_ids": torch.from_numpy(input_ids),
                    "attention_mask": torch.from_numpy(mask)}

        return collate_fn

    def __repr__(self):
        return "TextDataset\n" + json.dumps({
            "source": self.source, "root": self.root, "file": self.file, "len": len(self),
            "processing": str(self.processing_name),
            "Tokenizer": {"vocab_file": self.vocab_file,
                          "name": getattr(self.tokenizer, "name_or_path", None),
                          "vocab_size": self.tokenizer.vocab_size,
                          "max_length": self.tokenizer_max_len},
        }, indent=4, default=str)
