"""Best-only checkpointing with ``{tag}_{epoch}_{seed}.ckpt`` naming (port of
``executors/checkpoint.py``).

A checkpoint is one ``torch.save`` file of the JAX package's payload keys:
``model`` (the module's state dict: parameters and BatchNorm statistics),
``opt_state`` (the optimizer's state dict), ``training_scheduler`` and
``config`` (dicts) and ``__version__``. The JAX package writes flax msgpack;
:func:`load_checkpoint` reads both, told apart by the file's first bytes
(a zip archive for ``torch.save``, a msgpack map for flax). A JAX
checkpoint is decoded by :func:`msgpack_restore`, the port's own reader of
flax's msgpack (no ``msgpack`` or ``flax`` import); its ``model`` tree
becomes the port's state dict through ``zoo/from_jax.py`` (by the config's
``model.proto``), its ``training_scheduler`` and ``config`` JSON strings
become dicts, and its ``opt_state`` (optax's tree, which the port's
optimizers do not read) is dropped. :class:`CheckpointSaver` keeps one
checkpoint per run, the best, deleting the previous best on improvement,
and writes in a background thread: the payload it is handed must hold
copies (:func:`snapshot`), not live tensors the next epoch updates in place.
"""

from __future__ import annotations

import json
import os
import re
import struct
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
    """The payload of a checkpoint, on the CPU: one this module wrote (the
    file is unpickled: load only checkpoints written by this program), or
    one the JAX package wrote (module doc)."""
    with open(path, "rb") as f:
        head = f.read(1)
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):  # a msgpack map
        return load_jax_checkpoint(path)
    return torch.load(path, map_location="cpu", weights_only=False)


#: the ``zoo/from_jax.py`` bridge of each model proto (the others: RRG's)
_FROM_JAX = {"RRG_HF": "rrg_hf", "RRS": "rrs", "RRS_HF": "rrs_hf", "RRG_SCST": "scst",
             "RRS_SCST": "scst", "VisionLanguage": "vl", "MVQA": "mvqa", "ConVIRT": "convirt",
             "GLoRIA": "gloria"}


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """A JAX package's ``.ckpt`` as the port's payload (module doc)."""
    from ..zoo import from_jax

    with open(path, "rb") as f:
        state = msgpack_restore(f.read())
    config = json.loads(state.get("config") or "{}")
    proto = (config.get("model") or {}).get("proto")
    bridge = getattr(from_jax, f"{_FROM_JAX.get(proto, 'rrg')}_state_dict_from_jax")
    return {"model": bridge(_numpy_leaves(state["model"])), "opt_state": None,
            "training_scheduler": json.loads(state.get("training_scheduler") or "{}"),
            "config": config, "__version__": state.get("__version__")}


def _numpy_leaves(tree):
    """bfloat16 leaves (torch tensors: numpy has no bfloat16) as exact f32
    numpy arrays; everything else as it is."""
    if isinstance(tree, dict):
        return {k: _numpy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


# -------------------------------------------------------------------- msgpack

_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_INT = {0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZE = {1: ">B", 2: ">H", 4: ">I"}
#: flax's ext codes of an array and a numpy scalar (``flax.serialization._MsgpackExtType``)
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


class _Reader:
    """A msgpack decoder over one buffer: strings as ``str`` (or ``bytes``
    with ``raw``), arrays as lists, maps as dicts, bin as ``bytes`` (with
    ``raw``: ``memoryview`` slices of the buffer, no copy), ext through
    :meth:`ext`."""

    def __init__(self, data, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int):
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _UINT:
            return self.unpack(_UINT[b])
        if b in _INT:
            return self.unpack(_INT[b])
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            view = self.take(self.unpack(_SIZE[1 << (b - 0xC4)]))
            return view if self.raw else bytes(view)
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.str(self.unpack(_SIZE[1 << (b - 0xD9)]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(_SIZE[2 if b == 0xDC else 4]))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(_SIZE[2 if b == 0xDE else 4]))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self.unpack(_SIZE[1 << (b - 0xC7)])
            code = self.unpack(">b")
            return self.ext(code, self.take(n))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    @staticmethod
    def ext(code: int, data):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} is not a flax array")
        arr = _ndarray_from_bytes(data)
        return arr[()] if code == EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr


def _ndarray_from_bytes(data):
    """Flax's ndarray ext: msgpack ``(shape, dtype name, bytes)``. A
    ``bfloat16`` array comes back as a torch bfloat16 tensor (the bytes read
    as uint16), every other dtype as a numpy array."""
    shape, name, buf = _Reader(data, raw=True).read()
    if name == b"bfloat16":
        u16 = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(u16.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def _unchunk(tree):
    """Flax's chunked form of a leaf over its chunk size, joined back."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore`` without ``msgpack`` or
    ``flax``: the tree of ``data`` with its array leaves (numpy arrays,
    bfloat16 ones as torch tensors) and numpy scalars."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)


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
