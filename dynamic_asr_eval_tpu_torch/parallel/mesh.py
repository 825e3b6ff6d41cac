"""Data, tensor and sequence parallelism over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``.  JAX is one
controller over a device mesh; here every rank runs the same program (one
process per card, as ``torchrun --nproc_per_node=N`` starts them), and the
mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks:

- :func:`init_process_group`: the default process group, if there is none
  yet, from torchrun's environment, else a world of 1 on a local store;
  NCCL for ``cuda``, gloo for ``cpu``;
- :func:`make_mesh`: the ``('dp', 'tp')`` mesh, the tp ranks adjacent (JAX's
  ``reshape(n // tp, tp)``); a caller may build a mesh with more dimensions
  (``('dp', 'tp', 'sp')``, as JAX's tests build their ``Mesh``), which the
  functions here read by name (an absent dimension has size 1);
- :func:`batch_sharding`: this rank's block of a leading (window or record)
  axis; :func:`replicate`: rank 0's tensors on every rank;
- :func:`psum_wer_counts` / :func:`reduce_wer_counts`: corpus WER counts
  summed over the dp ranks, exactly (int64);
- tensor parallelism: :func:`conformer_param_sharding` (how each parameter
  of a conformer splits over tp), :func:`shard_params` (slices a model in
  place and hands its modules the tp group), :func:`shard_state` /
  :func:`gather_state` / :func:`gather_params` (a state dict's local slices
  and back);
- :func:`use_mesh`: the counterpart of JAX's ``with mesh:``; a conformer
  whose ``seq_shard_axes`` names a dimension of this mesh shards its time
  axis over it (``models/conformer.py``).
"""

from __future__ import annotations

import contextlib
import os
import re
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from dynamic_asr_eval_tpu_torch.parallel.collectives import Group, _all_gather

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
    device_type = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, torch.arange(n).reshape(n // tp, tp), mesh_dim_names=AXES)


def axis_size(mesh, axis: str = "dp") -> int:
    """The size of the mesh dimension named ``axis`` (1 where it has none)."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index(axis))) if axis in names else 1


def axis_rank(mesh, axis: str = "dp") -> int:
    """This rank's index along ``axis`` (0 where the mesh has none)."""
    return int(mesh.get_local_rank(axis)) if axis in (mesh.mesh_dim_names or ()) else 0


def axis_group(mesh, axis: str) -> Optional[Group]:
    """The :class:`.collectives.Group` of this rank's ``axis`` dimension;
    ``None`` where the mesh has no such dimension or it holds one rank."""
    if mesh is None or axis_size(mesh, axis) <= 1:
        return None
    return Group(mesh.get_group(axis))


_CURRENT = []


@contextlib.contextmanager
def use_mesh(mesh):
    """The counterpart of JAX's ``with mesh:``: inside it,
    :func:`current_mesh` is ``mesh`` (contexts nest)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, else ``None``."""
    return _CURRENT[-1] if _CURRENT else None


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


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


class Shard(NamedTuple):
    """How a tensor splits over tp: axis ``dim`` holds ``groups`` equal
    groups (q, k, v of a fused projection; a GLU's two halves), and rank r
    keeps block r of each."""

    dim: int
    groups: int = 1


# (name pattern under layers.N., the module whose split it follows, Shard);
# torch layouts: a Linear's weight is [out, in], a Conv1d's [out, in, K]
_TP_RULES = (
    (r"ff[12]\.in_proj\.(weight|bias)", "ff", Shard(0)),
    (r"ff[12]\.out_proj\.weight", "ff", Shard(1)),
    (r"attn\.qkv\.(weight|bias)", "attn", Shard(0, 3)),
    (r"attn\.out\.weight", "attn", Shard(1)),
    (r"attn\.linear_pos\.weight", "attn", Shard(0)),
    (r"attn\.pos_bias_[uv]", "attn", Shard(0)),
    (r"conv\.pw1\.(weight|bias)", "conv", Shard(0, 2)),
    (r"conv\.dw\.(weight|bias)", "conv", Shard(0)),
    (r"conv\.norm_mid\.(weight|bias|running_mean|running_var)", "conv", Shard(0)),
    (r"conv\.pw2\.weight", "conv", Shard(1)),
)
_TP_RULES_RE = tuple((re.compile(r"layers\.\d+\." + p), m, s) for p, m, s in _TP_RULES)


def _split_modules(config, tp: int) -> Dict[str, bool]:
    """Which of a block's modules split over ``tp`` ranks: attention by whole
    heads, the FF modules by hidden units, the conv module by channels."""
    if tp <= 1:
        return {"attn": False, "ff": False, "conv": False}
    return {"attn": config.n_heads % tp == 0,
            "ff": config.d_model * config.expansion_factor % tp == 0,
            "conv": config.d_model % tp == 0}


def conformer_param_sharding(model, mesh) -> Dict[str, Optional[Shard]]:
    """Each parameter and buffer name of a conformer (``models.
    SCConformer``) → its :class:`Shard` over the mesh's tp dimension, or
    ``None`` (replicated).  The JAX package's ``_CONFORMER_RULES``, with
    what slicing by hand needs:

    - the FF ``in`` and the conv ``pw1`` weights split on their output axis,
      the FF ``out``, attention ``out`` and conv ``pw2`` weights on their
      input axis (their biases, added after the sum, stay whole);
    - attention splits by whole heads: a rank holds its heads' q, k and v
      rows of ``qkv`` (layout [3, H, D]), their ``out`` columns, and with
      ``rel_pos`` their ``linear_pos`` rows and ``pos_bias_u`` /
      ``pos_bias_v``.  Where ``n_heads % tp != 0`` attention stays
      replicated, while JAX splits ``qkv`` wherever ``3 H D`` divides;
    - ``pw1`` splits by GLU pairs: rank r takes block r of the ``a`` half and
      block r of the ``b`` half;
    - a column-parallel layer's bias, the depthwise kernel and bias, and the
      mid norm's parameters and running statistics go with their channels.
      JAX replicates these: GSPMD needs no slicing to apply them;
    - a module whose axis does not divide by tp is replicated, as JAX
      replicates such a weight (the conv module as a whole where ``d_model
      % tp != 0``).
    """
    split = _split_modules(model.config, axis_size(mesh, "tp"))
    out = {}
    for name, _ in list(model.named_parameters()) + list(model.named_buffers()):
        out[name] = None
        for pattern, module, shard in _TP_RULES_RE:
            if pattern.fullmatch(name):
                out[name] = shard if split[module] else None
                break
    return out


def _local(t: torch.Tensor, s: Optional[Shard], tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the full tensor ``t``."""
    if s is None:
        return t
    n = t.shape[s.dim] // s.groups
    if n % tp:
        raise ValueError(f"axis {s.dim} of {tuple(t.shape)} does not split over {tp} ranks")
    blk = n // tp
    return t.unflatten(s.dim, (s.groups, n)).narrow(s.dim + 1, rank * blk, blk).flatten(
        s.dim, s.dim + 1)


def shard_state(state: Dict[str, torch.Tensor], sharding: Dict[str, Optional[Shard]],
                mesh) -> Dict[str, torch.Tensor]:
    """This tp rank's slices of a full state dict (views)."""
    tp, rank = axis_size(mesh, "tp"), axis_rank(mesh, "tp")
    return {name: _local(t, sharding.get(name), tp, rank) for name, t in state.items()}


def gather_state(state: Dict[str, torch.Tensor], sharding: Dict[str, Optional[Shard]],
                 mesh) -> Dict[str, torch.Tensor]:
    """The full tensors of a tp rank's state dict, on every rank (an
    all-gather over tp for each split entry); a new dict of detached
    copies."""
    g = axis_group(mesh, "tp")
    out = {}
    for name, t in state.items():
        s = sharding.get(name)
        t = t.detach()
        if s is None or g is None:
            out[name] = t.clone()
            continue
        blk = t.shape[s.dim] // s.groups
        parts = _all_gather(t.unflatten(s.dim, (s.groups, blk)), s.dim + 1, g)
        out[name] = parts.flatten(s.dim, s.dim + 1)
    return out


def shard_params(model, mesh) -> Dict[str, Optional[Shard]]:
    """Slice a conformer's parameters and buffers to this tp rank's shards,
    in place: every name and module path stays (``param_labels``, remat,
    ``functional_call`` and the converters still find them), only the
    shapes shrink.  The split modules get the tp group (their ``tp``), which
    their forwards reduce over.  Returns the sharding
    (:func:`conformer_param_sharding`)."""
    sharding = conformer_param_sharding(model, mesh)
    g = axis_group(mesh, "tp")
    if g is None:
        return sharding
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            s = sharding[name]
            if s is None:
                continue
            owner, leaf = model.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
            local = _local(t.detach(), s, g.size, g.rank).clone()
            if isinstance(t, torch.nn.Parameter):
                t.data = local
            else:
                setattr(owner, leaf, local)
    split = _split_modules(model.config, g.size)
    for block in model.layers:
        for module, kind in ((block.ff1, "ff"), (block.ff2, "ff"), (block.attn, "attn"),
                             (block.conv, "conv")):
            if split[kind]:
                module.tp = g
    model.tp_sharding = sharding
    return sharding


def gather_params(model, mesh) -> Dict[str, torch.Tensor]:
    """The full state dict of a model sliced by :func:`shard_params`, on
    every rank (a copy of its state dict when it was not sliced)."""
    sharding = getattr(model, "tp_sharding", None) or {}
    return gather_state(model.state_dict(), sharding, mesh)
