"""The collectives of tensor and sequence parallelism, written by hand.

The JAX package shards the conformer with GSPMD annotations and lets XLA
insert the collectives (``parallel/mesh.py``, ``ConformerConfig.
seq_shard_axes``).  ``torch.distributed`` has no such compiler, so the port
shards its forward by hand with these operations.  Each is a
``torch.autograd.Function`` with an explicit backward and a ``vmap`` rule:
under ``torch.func.vmap`` (the records-batched engine) the collective acts
on the whole batched tensor, one call for the group.

Every operation takes a :class:`Group` (``None``, or a group of one rank,
makes it the identity) and assumes that the loss downstream of the sharded
region is computed the same on every rank of the group:

- :func:`copy_to_tp`: identity forward, all-reduce backward; before a
  column-parallel product (the replicated input's gradient is the sum of
  the ranks' partial ones);
- :func:`reduce_from_tp`: all-reduce forward, identity backward; after a
  row-parallel product (the sum's consumers are replicated, so each rank's
  gradient is already whole).  Not ``torch.distributed.nn``'s all-reduce,
  which differentiates to another all-reduce and would multiply the
  gradients by the group's size here;
- :func:`sum_partials`: all-reduce forward and backward; a statistic summed
  over the group whose consumers are themselves sharded (LayerNorm moments
  over tp-split channels, batch moments over sp-split frames);
- :func:`split_seq`: this rank's block of the time axis forward, all-gather
  backward;
- :func:`gather_seq`: all-gather forward, this rank's block of the gradient
  backward;
- :func:`gather_kv`: all-gather forward, reduce-scatter backward (all-reduce
  and this rank's block where the backend has no reduce-scatter): K and V
  for the query block's attention, whose key gradients are partial;
- :func:`halo`: the edge frames of each time neighbour (zeros past the ends
  of the sequence), for the depthwise convolution; their gradients go back
  to their owners;
- :func:`sync_grad`: identity forward, all-reduce backward over the sp
  group; every parameter read inside the sequence-sharded region goes
  through it, so the weight gradients come out whole and equal on every
  rank.

The route of a call is chosen from its group's backend, never on failure:
NCCL for CUDA tensors; gloo for CPU tensors, and for CUDA tensors (two
ranks on one card), whose all-reduce and all-gather gloo runs itself; on
gloo the reduce-scatter is an all-reduce and this rank's block.
Reductions of bf16 or f16 tensors sum in f32 and return the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

class Group:
    """A process group with its size and this rank's index in it.  Copying
    a module that holds one (``copy.deepcopy``) shares it."""

    __slots__ = ("group", "size", "rank")

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"Group(rank {self.rank} of {self.size})"


def _active(g: Optional[Group]) -> bool:
    return g is not None and g.size > 1


def _check_backend(t: torch.Tensor, g: Group) -> None:
    """Refuse a tensor or a backend that the group's route does not take."""
    backend = dist.get_backend(g.group)
    if backend == "nccl" and t.device.type != "cuda":
        raise ValueError(f"an NCCL group takes CUDA tensors, got {t.device}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported process-group backend {backend!r}")


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A reduction's operand: f32 for a 16-bit float tensor."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def _all_reduce(t: torch.Tensor, g: Group) -> torch.Tensor:
    """The sum of every rank's ``t``, a new tensor in ``t``'s dtype."""
    _check_backend(t, g)
    work = _wide(t.detach()).to(t.device, copy=True).contiguous()
    dist.all_reduce(work, group=g.group)
    return work.to(t.dtype)


def _all_gather(t: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """Every rank's ``t`` (one shape) concatenated along ``dim`` in rank
    order."""
    _check_backend(t, g)
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(g.size)]
    dist.all_gather(parts, src, group=g.group)
    return torch.cat(parts, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """The sum of every rank's ``t``, this rank's block of ``dim``."""
    n = t.shape[dim] // g.size
    if dist.get_backend(g.group) != "nccl":  # gloo: all-reduce, then the block
        return _all_reduce(t, g).narrow(dim, g.rank * n, n).contiguous()
    x = _wide(t.detach()).movedim(dim, 0).contiguous()
    out = torch.empty((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=g.group)
    return out.movedim(0, dim).to(t.dtype).contiguous()


def _block(t: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    if t.shape[dim] % g.size:
        raise ValueError(f"axis {dim} of length {t.shape[dim]} does not split over "
                         f"{g.size} ranks")
    n = t.shape[dim] // g.size
    return t.narrow(dim, g.rank * n, n).contiguous()


def _batched_dim(x, bdim, dim):
    """(x with its vmapped axis first, the logical ``dim`` in it)."""
    return x.movedim(bdim, 0), dim + 1


# ---------------------------------------------------------------------------
# element-wise: identity one way, all-reduce the other
# ---------------------------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(x, g):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.g), None

    @staticmethod
    def vmap(info, in_dims, x, g):
        return _CopyToGroup.apply(x, g), in_dims[0]


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(x, g):
        return _all_reduce(x, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, g):
        return _ReduceFromGroup.apply(x, g), in_dims[0]


class _SumPartials(torch.autograd.Function):
    """All-reduce forward and backward."""

    @staticmethod
    def forward(x, g):
        return _all_reduce(x, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.g), None

    @staticmethod
    def vmap(info, in_dims, x, g):
        return _SumPartials.apply(x, g), in_dims[0]


def copy_to_tp(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """The input of a column-parallel product: identity forward, gradient
    all-reduced over the tp group."""
    return _CopyToGroup.apply(x, g) if _active(g) else x


def sync_grad(p: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """A parameter read inside the sequence-sharded region: identity
    forward, gradient all-reduced over the sp group."""
    return _CopyToGroup.apply(p, g) if _active(g) and p is not None else p


def reduce_from_tp(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """The output of a row-parallel product: summed over the tp group,
    identity backward."""
    return _ReduceFromGroup.apply(x, g) if _active(g) else x


def sum_partials(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """A statistic summed over the group for consumers that are sharded
    themselves: all-reduce forward and backward."""
    return _SumPartials.apply(x, g) if _active(g) else x


# ---------------------------------------------------------------------------
# the time axis
# ---------------------------------------------------------------------------


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, g):
        return _block(x, dim, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.g = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.g), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, g):
        x, dim = _batched_dim(x, in_dims[0], dim)
        return _SplitSeq.apply(x, dim, g), 0


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, g):
        return _all_gather(x, dim, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.g = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.dim, ctx.g), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, g):
        x, dim = _batched_dim(x, in_dims[0], dim)
        return _GatherSeq.apply(x, dim, g), 0


class _GatherKV(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, g):
        return _all_gather(x, dim, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.g = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.g), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, g):
        x, dim = _batched_dim(x, in_dims[0], dim)
        return _GatherKV.apply(x, dim, g), 0


def split_seq(x: torch.Tensor, dim: int, g: Optional[Group]) -> torch.Tensor:
    """This rank's block of ``x``'s ``dim`` (which the group's size must
    divide); the gradient is all-gathered."""
    return _SplitSeq.apply(x, dim, g) if _active(g) else x


def gather_seq(x: torch.Tensor, dim: int, g: Optional[Group]) -> torch.Tensor:
    """Every rank's block along ``dim``, in rank order; the gradient's
    block goes back to its rank."""
    return _GatherSeq.apply(x, dim, g) if _active(g) else x


def gather_kv(x: torch.Tensor, dim: int, g: Optional[Group]) -> torch.Tensor:
    """Every rank's keys (or values) along ``dim``; the ranks' partial
    gradients are summed and each rank keeps its block."""
    return _GatherKV.apply(x, dim, g) if _active(g) else x


class _Halo(torch.autograd.Function):
    """[left frames of the previous rank, x, right frames of the next]."""

    @staticmethod
    def forward(x, dim, left, right, g):
        T = x.shape[dim]
        if T < max(left, right):
            raise ValueError(f"a block of {T} frames is shorter than the halo "
                             f"({left}, {right})")
        edges = torch.cat([x.narrow(dim, 0, right), x.narrow(dim, T - left, left)], dim)
        parts = _all_gather(edges, dim, g).split(right + left, dim)
        zeros = lambda n: x.new_zeros(x.shape[:dim] + (n,) + x.shape[dim + 1:])  # noqa: E731
        before = parts[g.rank - 1].narrow(dim, right, left) if g.rank > 0 else zeros(left)
        after = parts[g.rank + 1].narrow(dim, 0, right) if g.rank < g.size - 1 else zeros(right)
        return torch.cat([before, x, after], dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.left, ctx.right, ctx.g = inputs

    @staticmethod
    def backward(ctx, grad):
        dim, left, right, g = ctx.dim, ctx.left, ctx.right, ctx.g
        T = grad.shape[dim] - left - right
        mine = grad.narrow(dim, left, T).clone()
        sent = torch.cat([grad.narrow(dim, 0, left), grad.narrow(dim, left + T, right)], dim)
        parts = _all_gather(sent, dim, g).split(left + right, dim)
        if g.rank > 0:  # my first frames were the previous rank's right halo
            mine.narrow(dim, 0, right).add_(parts[g.rank - 1].narrow(dim, left, right))
        if g.rank < g.size - 1:  # my last frames were the next rank's left halo
            mine.narrow(dim, T - left, left).add_(parts[g.rank + 1].narrow(dim, 0, left))
        return mine, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, left, right, g):
        x, dim = _batched_dim(x, in_dims[0], dim)
        return _Halo.apply(x, dim, left, right, g), 0


def halo(x: torch.Tensor, dim: int, left: int, right: int, g: Optional[Group]) -> torch.Tensor:
    """``x`` with ``left`` frames of the previous rank's block before it and
    ``right`` frames of the next rank's after it along ``dim`` (zeros past
    the first and the last rank).  Without a group: zero padding."""
    if _active(g):
        return _Halo.apply(x, dim, left, right, g)
    pad = [0, 0] * (x.dim() - 1 - dim) + [left, right]
    return torch.nn.functional.pad(x, pad)
