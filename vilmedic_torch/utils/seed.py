"""Run seeding and recovering the seed from a checkpoint's name (a copy of
``utils/seed.py`` of the JAX package, without its JAX key)."""

from __future__ import annotations

import os
import random
import re
from random import randrange

import numpy as np


def get_seed(seed=None) -> int:
    """``seed``, or a random 6-digit one; seeds Python's and NumPy's global
    generators with it."""
    if seed is None:
        seed = randrange(100000, 999999)
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed)
    return seed


def extract_seed_from_ckpt(ckpt: str) -> str:
    """``1.68_10_560435.ckpt`` -> ``560435``."""
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"{ckpt} does not exist")
    m = re.match(r".*_(.*?)\.(pth|ckpt|msgpack)$", os.path.basename(ckpt))
    if m is None:
        raise ValueError(f"cannot extract a seed from {ckpt}")
    return m.group(1)
