"""HuggingFace ``datasets`` plumbing (port of ``data/hf_plumbing.py``): load,
filter and keep one field.

``hf_local`` true reads a dataset written by ``Dataset.save_to_disk`` /
``DatasetDict.save_to_disk`` (``load_from_disk``); false names a hub
dataset (``load_dataset``, which reads the local hub cache when offline).
A filter is a dict ``{field: value}`` (keep the rows where the field
equals it) or ``{field: [v1, v2]}`` (membership), or a callable; a list of
them applies in order. ``datasets`` and Pillow are imported inside the
functions, never when the module is imported.
"""

from __future__ import annotations

import os
from typing import List


def _make_filter(spec):
    if callable(spec):
        return spec
    if isinstance(spec, dict):
        def fn(example):
            for field, expected in spec.items():
                val = example[field]
                if isinstance(expected, (list, tuple)):
                    if val not in expected:
                        return False
                elif val != expected:
                    return False
            return True

        return fn
    raise ValueError(f"Unsupported hf_filter spec: {spec!r} (dict or callable expected)")


def process_hf_dataset(datasets, hf_local, hf_filter, hf_field: str, split: str):
    from datasets import concatenate_datasets, load_dataset, load_from_disk

    if isinstance(datasets, str):
        datasets = [datasets]
    if hf_filter is None:
        hf_filter = []
    elif isinstance(hf_filter, dict):
        hf_filter = [hf_filter]

    def process_single(name):
        load_func = load_from_disk if hf_local else load_dataset
        dataset = load_func(name)
        dataset = dataset[split]
        for spec in hf_filter:
            dataset = dataset.filter(_make_filter(spec))
        return dataset.select_columns([hf_field])

    parts = [process_single(name) for name in datasets]
    return parts[0] if len(parts) == 1 else concatenate_datasets(parts)


def load_hf_images(hf_dataset, hf_local, hf_filter, hf_field, split, image_path) -> List[List]:
    """Per-row image lists: paths (joined to ``image_path`` and checked) or
    Pillow images as the dataset holds them."""
    from PIL import Image

    dataset = process_hf_dataset(hf_dataset, hf_local, hf_filter, hf_field, split)
    out: List[List] = []
    for example in dataset:
        item = example[hf_field]
        items = item if isinstance(item, list) else [item]
        validated = []
        for img in items:
            if isinstance(img, str):
                full = os.path.join(image_path, img) if image_path else img
                if not os.path.exists(full):
                    raise FileNotFoundError(f"Image file not found: {img} or {full}")
                validated.append(full)
            elif isinstance(img, Image.Image):
                validated.append(img)
            else:
                raise TypeError(f"Unexpected image type: {type(img)}")
        out.append(validated)
    return out
