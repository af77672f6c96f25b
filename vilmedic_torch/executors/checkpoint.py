"""Best-only checkpointing with ``{tag}_{epoch}_{seed}.ckpt`` naming (port of
``executors/checkpoint.py``).

A checkpoint is one ``torch.save`` file of the JAX package's payload keys:
``model`` (the module's state dict: parameters and BatchNorm statistics),
``opt_state`` (the optimizer's state dict), ``training_scheduler`` and
``config`` (dicts) and ``__version__``. The JAX package writes flax msgpack;
the two formats do not read each other. :class:`CheckpointSaver` keeps one
checkpoint per run, the best, deleting the previous best on improvement,
and writes in a background thread: the payload it is handed must hold
copies (:func:`snapshot`), not live tensors the next epoch updates in place.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.logger import SETTINGS_LEVEL


def snapshot(tree):
    """A copy of a (nested) state dict's tensors, taken now on their device
    (the background writer moves them to the host)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` (model, opt_state, training_scheduler, config,
    __version__) to ``path`` through a temporary file, so a reader never
    sees half a checkpoint."""
    tmp = path + ".tmp"
    torch.save({key: payload.get(key) for key in
                ("model", "opt_state", "training_scheduler", "config", "__version__")}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint this module wrote, on the CPU. The file
    is unpickled (tensors, dicts, numbers, strings): load only checkpoints
    written by this program."""
    return torch.load(path, map_location="cpu", weights_only=False)


class CheckpointSaver:
    def __init__(self, ckpt_dir: str, logger, seed, ckpt: Optional[str] = None):
        self.ckpt_dir = ckpt_dir
        self.seed = seed
        self.logger = logger
        self.current_tag = None
        self.current_epoch = None
        self._thread = None
        self._error = None
        if ckpt is not None:
            self.current_tag, self.current_epoch = self.extract_tag_and_step(ckpt)
            logger.log(SETTINGS_LEVEL, f"Resuming checkpoint after epoch {self.current_epoch + 1} "
                            f"with tag {self.current_tag}.")

    def save(self, payload: Dict[str, Any], tag, current_epoch: int) -> str:
        """Replace the previous best with ``{tag}_{current_epoch}_{seed}.ckpt``
        (the tag rounded to 6 decimals), written in the background. Returns
        the new path."""
        self.wait()  # one save in flight at a time
        if self.current_tag is not None:
            old = os.path.join(self.ckpt_dir,
                               f"{self.current_tag}_{self.current_epoch}_{self.seed}.ckpt")
            if os.path.exists(old):
                os.remove(old)
        tag = float(np.round(float(tag), 6))
        path = os.path.join(self.ckpt_dir, f"{tag}_{current_epoch}_{self.seed}.ckpt")

        def write():
            try:
                save_checkpoint(path, payload)
                self.logger.info(f"{path} saved.")
            except BaseException as e:  # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        self.current_tag = tag
        self.current_epoch = current_epoch
        return path

    def wait(self) -> None:
        """Join the save in flight; re-raise its failure (the previous best
        is already deleted, so a lost write would leave no checkpoint)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            err, self._error = self._error, None
            if err is not None:
                raise RuntimeError("background checkpoint write failed") from err

    @staticmethod
    def extract_tag_and_step(ckpt: str) -> Tuple[float, int]:
        groups = re.match(r".*/(.*?)_(.*?)_(.*?)\.(ckpt|pth)", ckpt)
        return float(groups.group(1)), int(groups.group(2))
