"""Data parallelism over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``.  JAX is one
controller over a device mesh; here every rank runs the same program (one
process per card, as ``torchrun --nproc_per_node=N`` starts them), and the
mesh is a ``('dp', 'tp')`` :class:`~torch.distributed.device_mesh.DeviceMesh`
over the ranks:

- :func:`init_process_group`: the default process group, if there is none
  yet, from torchrun's environment, else a world of 1 on a local store;
  NCCL for ``cuda``, gloo for ``cpu``;
- :func:`make_mesh`: the ``('dp', 'tp')`` mesh; ``tp > 1`` raises
  (tensor parallelism is ROADMAP item 19c);
- :func:`batch_sharding`: this rank's block of a leading (window or record)
  axis; :func:`replicate`: rank 0's tensors on every rank;
- :func:`psum_wer_counts` / :func:`reduce_wer_counts`: corpus WER counts
  summed over the dp ranks, exactly (int64).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "tp")


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_process_group(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Make sure a default process group exists and return this rank's
    device: an existing group is kept; else torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is used;
    else a world of 1 on a local store.  ``device`` ``None`` means
    ``cuda:{LOCAL_RANK}``, which becomes the current CUDA device.  A failed
    initialisation raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    if dist.is_initialized():
        return dev
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        dist.init_process_group(_backend(dev), init_method="env://")
    else:
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)
    return dev


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, devices=None):
    """A ``('dp', 'tp')`` device mesh over the first ``n_devices`` ranks
    (all of them by default) of the default group, which must exist
    (:func:`init_process_group`).  ``devices`` is the device type (``"cuda"``
    or ``"cpu"``); by default that of the group's backend."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no default process group: call init_process_group first")
    n = n_devices or dist.get_world_size()
    if n % tp:
        raise ValueError(f"n_devices ({n}) not divisible by tp ({tp})")
    if n > dist.get_world_size():
        raise ValueError(f"n_devices ({n}) > world size ({dist.get_world_size()})")
    if tp > 1:
        raise NotImplementedError(
            "tensor parallelism (--tp > 1) is not ported yet (ROADMAP queue 1 item 19c)")
    device_type = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, torch.arange(n).reshape(n // tp, tp), mesh_dim_names=AXES)


def axis_size(mesh, axis: str = "dp") -> int:
    return int(mesh.size(AXES.index(axis)))


def axis_rank(mesh, axis: str = "dp") -> int:
    return int(mesh.get_local_rank(axis))


def _group_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_sharding(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``take(x)``: this rank's contiguous block of ``x``'s leading axis,
    whose length must be a multiple of the dp size (JAX's ``P('dp')``)."""
    ndp, rank = axis_size(mesh), axis_rank(mesh)

    def take(x):
        if x.shape[0] % ndp:
            raise ValueError(f"leading axis {x.shape[0]} is not a multiple of dp ({ndp})")
        share = x.shape[0] // ndp
        return x[rank * share : (rank + 1) * share]

    return take


def replicate(tree: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Each tensor of ``tree`` as dp rank 0 holds it, on every dp rank
    (a broadcast, in place)."""
    group = mesh.get_group("dp")
    src = dist.get_global_rank(group, 0)
    for t in tree.values():
        dist.broadcast(t, src=src, group=group)
    return tree


def psum_wer_counts(err_counts, mesh=None) -> torch.Tensor:
    """All-reduce (sum) of (ins, del, sub, words) int64 counts over the dp
    ranks (every rank of the default group without a mesh)."""
    group = mesh.get_group("dp") if mesh is not None else None
    t = torch.as_tensor(np.asarray(err_counts, np.int64), device=_group_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def reduce_wer_counts(counts: np.ndarray, mesh) -> np.ndarray:
    """``[R, 4]`` per-record ``(ins, del, sub, words)`` counts, the same on
    every rank, → corpus totals: the record axis padded with zeros to a
    multiple of dp, each rank sums its block, one all-reduce sums the
    blocks.  The totals equal the serial sum exactly."""
    ndp = axis_size(mesh)
    c = np.asarray(counts, np.int64).reshape(-1, 4)
    pad = (-c.shape[0]) % ndp
    if pad:
        c = np.concatenate([c, np.zeros((pad, 4), np.int64)])
    local = batch_sharding(mesh)(torch.from_numpy(c)).sum(0)
    return psum_wer_counts(local.numpy(), mesh).cpu().numpy()
