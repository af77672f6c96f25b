"""Processes, devices and collectives (port of ``parallel/mesh.py``).

Multi-process training and evaluation run one process per card, started by
``torchrun`` (or anything that sets its environment): :func:`init_distributed`
starts ``torch.distributed`` from ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` and ``LOCAL_RANK``, with NCCL for a CUDA device (the process
takes card ``LOCAL_RANK``) and gloo for the CPU. It is a no-op without that
environment, and everything below then runs as one process.

The JAX package runs one program over a global mesh, so its losses, batch
statistics and gradients are those of the global batch. Here each process
holds its strided shard of the global batch (the loader's ``shard_index`` /
``num_shards``), and the trainer makes the same quantities global:

- :func:`global_batch` marks a training forward; inside it :func:`global_mean`
  divides a loss's local sum by the count summed over the processes, so the
  per-process losses add up to the global-batch mean, BatchNorm takes its
  moments over every process's rows (``densenet.BatchNorm``), and a loss
  that couples the batch's rows (the contrastive losses) runs over every
  process's rows, each process taking its share
  (:func:`loss_over_global_rows`);
- :func:`all_reduce_sum_` sums the gradients over the processes, in one flat
  buffer per dtype (data parallelism's all-reduce, done by hand once per
  update: the models' steps are not single module calls, and the sum of the
  per-process gradients of those losses is the gradient of the global mean).

Evaluation gathers what each process scored: :func:`gather_string_lists`,
:func:`gather_arrays` and :func:`gather_weighted_mean`, in process order,
and :func:`broadcast_json` hands process 0's scores to all, so every process
takes the same early-stop and checkpoint decisions. :func:`eval_devices`
and :func:`sharded_call` are ``shard_eval``: one replica of the models per
local device, each batch padded to a multiple of the device count and split.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import threading
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_GLOBAL_BATCH = threading.local()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def init_distributed(device="cuda") -> bool:
    """Start the process group from ``torchrun``'s environment: NCCL when
    ``device`` is a CUDA device (``LOCAL_RANK`` becomes the current card),
    gloo otherwise. A no-op when the environment is absent or the group
    already runs. Returns whether a group runs."""
    if initialized():
        return True
    if not all(os.environ.get(k) for k in TORCHRUN_ENV):
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend="nccl" if cuda else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def destroy() -> None:
    """End the process group, if one runs."""
    if initialized():
        dist.destroy_process_group()


def local_device(device) -> torch.device:
    """This process's device: under a group on CUDA, card ``LOCAL_RANK``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def rank_zero_first():
    """Process 0 runs the block first, then the others (files it writes,
    such as a built vocabulary, are whole when they read them)."""
    if not initialized():
        yield
        return
    if process_index() != 0:
        dist.barrier()
    try:
        yield
    finally:
        if process_index() == 0:
            dist.barrier()


# ---------------------------------------------------------------- training

@contextlib.contextmanager
def global_batch():
    """Mark a training forward over this process's shard of the global
    batch: under a process group, losses and batch statistics inside it are
    the global batch's."""
    previous = getattr(_GLOBAL_BATCH, "on", False)
    _GLOBAL_BATCH.on = initialized()
    try:
        yield
    finally:
        _GLOBAL_BATCH.on = previous


def in_global_batch() -> bool:
    return getattr(_GLOBAL_BATCH, "on", False)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the processes, differentiable (its gradient is the sum
    of the processes' gradients)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / count`` (count at least 1); inside :func:`global_batch` the
    count is summed over the processes, so the processes' results add up to
    the global batch's mean."""
    if in_global_batch():
        count = count.detach().clone()
        dist.all_reduce(count)
    return total / count.clamp_min(1)


def _sharing() -> bool:
    return in_global_batch() and process_count() > 1


def loss_over_global_rows(loss_fn: Callable, *xs) -> torch.Tensor:
    """``loss_fn(*xs)``, a scalar loss that couples the batch's rows (a
    contrastive loss). Inside :func:`global_batch` across several processes
    it runs over every process's rows, in process order (gathered
    differentiably: a process's rows get the gradients the others' losses
    send back), with the global-batch reductions off inside it (its rows
    are the global batch already), and this process's share of it is
    returned: the loss over the number of processes, so the shares add up
    to it. A tensor whose second axis differs between processes (tokens)
    comes as a ``(tensor, pad)`` pair and is padded to the longest with
    ``pad``."""
    if not _sharing():
        return loss_fn(*(x[0] if isinstance(x, tuple) else x for x in xs))
    return gathered_loss(loss_fn, *xs)


def gathered_loss(loss_fn: Callable, *xs) -> torch.Tensor:
    """:func:`loss_over_global_rows` across processes: the rows gathered
    from every process of the group, whatever their number, and this
    process's share of the loss over them."""
    from torch.distributed.nn.functional import all_gather

    rows = []
    for x in xs:
        x, pad = x if isinstance(x, tuple) else (x, None)
        if pad is not None:
            longest = torch.tensor(x.shape[1], device=x.device)
            dist.all_reduce(longest, op=dist.ReduceOp.MAX)
            fill = x.new_full((x.shape[0], int(longest) - x.shape[1], *x.shape[2:]), pad)
            x = torch.cat([x, fill], dim=1)
        rows.append(torch.cat(all_gather(x.contiguous()), dim=0))
    previous, _GLOBAL_BATCH.on = in_global_batch(), False
    try:
        loss = loss_fn(*rows)
    finally:
        _GLOBAL_BATCH.on = previous
    return loss / process_count()


@torch.no_grad()
def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` over the processes in place: one flat buffer per
    dtype, one all-reduce each."""
    if not initialized():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of the global batch."""
    return max(1, int(global_batch_size) // process_count())


# ---------------------------------------------------------------- evaluation

def _all_gather(obj) -> list:
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def process_allgather(x):
    """Every process's ``x`` (an array, or a dict / list of them) stacked on
    a new leading axis in process order; ``x`` itself in one process."""
    if not initialized():
        return x
    parts = _all_gather(x)
    if isinstance(x, dict):
        return {k: np.stack([np.asarray(p[k]) for p in parts]) for k in x}
    if isinstance(x, (list, tuple)):
        return type(x)(np.stack([np.asarray(p[i]) for p in parts]) for i in range(len(x)))
    return np.stack([np.asarray(p) for p in parts])


def gather_string_lists(strings) -> List[str]:
    """Every process's strings, concatenated in process order."""
    if not initialized():
        return list(strings)
    return [s for part in _all_gather(list(strings)) for s in part]


def gather_arrays(x) -> np.ndarray:
    """Every process's rows (leading sizes may differ), concatenated in
    process order."""
    x = np.asarray(x)
    if not initialized():
        return x
    return np.concatenate(_all_gather(x), axis=0)


def gather_weighted_mean(value: float, weight: float) -> float:
    """The processes' values weighted by ``weight`` (an evaluation loss by
    its sample count)."""
    if not initialized():
        return float(value)
    parts = _all_gather((float(value) * float(weight), float(weight)))
    total = sum(w for _, w in parts)
    return sum(vw for vw, _ in parts) / total if total else float(value)


def broadcast_json(obj, root: int = 0):
    """Process ``root``'s JSON-serializable ``obj`` on every process (as a
    JSON round trip on all of them, ``root`` included)."""
    if not initialized():
        return obj
    payload = [json.dumps(obj, default=str) if process_index() == root else None]
    dist.broadcast_object_list(payload, src=root)
    return json.loads(payload[0])


def local_devices(device) -> List[torch.device]:
    """The devices this process may spread an evaluation over: every card
    of the host when it runs alone on CUDA, else its own device."""
    device = torch.device(device)
    if device.type == "cuda" and not initialized():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def eval_devices(config, device) -> List[torch.device]:
    """``shard_eval``'s devices: the local devices when ``shard_eval`` is on
    (by default only when there are several) and there are several, else
    ``[device]``."""
    devices = local_devices(device)
    shard = config.get("shard_eval", None)
    if shard is None:
        shard = len(devices) > 1
    return devices if shard and len(devices) > 1 else [torch.device(device)]


def replicate(models, devices) -> List[list]:
    """The models on each device: the originals on the first, copies on the
    others."""
    out = [list(models)]
    for dev in devices[1:]:
        copies = []
        for m in models:
            c = copy.copy(m)
            c.module = copy.deepcopy(m.module).to(dev)
            copies.append(c)
        out.append(copies)
    return out


def pad_rows(x, target: int):
    """``x`` with its last row repeated up to ``target`` rows (the JAX
    package's ``_pad_batch``); anything without rows as it is."""
    if not torch.is_tensor(x) or x.ndim == 0 or x.shape[0] >= target:
        return x
    return torch.cat([x, x[-1:].expand(target - x.shape[0], *x.shape[1:])])


def sharded_call(fn: Callable, devices: List[torch.device], inputs: dict) -> list:
    """``fn(i, shard)`` for each device ``i`` over its rows of ``inputs``
    (padded to a multiple of the device count by repeating the last row,
    then split; tensors moved to the device), the devices in threads;
    returns the results in device order."""
    n_dev = len(devices)
    rows = next(v.shape[0] for v in inputs.values() if torch.is_tensor(v) and v.ndim > 0)
    per = -(-rows // n_dev)
    padded = {k: pad_rows(v, per * n_dev) for k, v in inputs.items()}

    def shard(i):
        return {k: v[i * per: (i + 1) * per].to(devices[i], non_blocking=True)
                if torch.is_tensor(v) and v.ndim > 0 else v for k, v in padded.items()}

    results: list = [None] * n_dev
    errors: list = []

    def run(i):
        try:
            if devices[i].type == "cuda":
                torch.cuda.set_device(devices[i])
            results[i] = fn(i, shard(i))
        except BaseException as e:  # re-raised in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(1, n_dev)]
    for t in threads:
        t.start()
    run(0)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
