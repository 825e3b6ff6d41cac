"""The NSTI adapt step's call into the model, replayed from CUDA graphs.

One :class:`GraphedForward` serves one engine's working copy of the model.
Around the adapt step's own call, :meth:`GraphedForward.step` sets the
model's ``forward`` for that one call: the call still goes through
``Module.__call__``, so the model's forward pre-hooks and hooks see it and
its output, but ``forward`` replays a graph of the model's own forward (the
class's ``forward``, never ``__call__``: no hook fires inside a capture),
and autograd then replays a graph of its backward.  The backward graph
writes the trainable parameters' gradients, which autograd accumulates into
``.grad`` as it does the eager backward's.  Every other call into the model
(offline inference, the entropy augmentation's ``functional_call``, the
records-batched ``vmap``, anything under ``no_grad``) runs the eager
forward.  Every kernel in the chain is the one the eager passes launch: a
graph only records their launches.

When it engages: the backend supports the batch's device (CUDA, for the
default :class:`CudaGraphs`), there is no mesh (tensor and sequence
parallelism put collectives inside the forward), grad mode is on, the batch
needs no gradient, the lengths are on the batch's device, and no module
under the model carries hooks (they would fire while a graph is captured,
never when it replays).  A graph is keyed by the shape, dtype and device of
the batch and of the lengths, the trainable mask and ``training``.  A key is
captured only when it is seen twice within one pass over one record's
windows (:meth:`GraphedForward.new_pass` starts a pass): a window shape that
repeats within a record.  A record shorter than the window length has one
window, of its own length, in each pass, and never pays for a capture, nor
do two such records of equal length.  One graph is live at a time: a new
capture drops the old graph and its memory pool.  A capture that raises
leaves its key eager for the lifetime of the object and counts one
failure.

What a graph holds fixed:

- the addresses of the parameters and buffers: the engine's
  ``load_state_dict`` and MADGRAD write in place, and where one has moved
  the graph is not replayed, and the key is captured again as a new one;
- its outputs: the forward returns the graph's own buffers, which the next
  replay rewrites, so nothing may hold one past its window.
  Only ``final_posteriors`` is differentiable; the other outputs come back
  detached.

``captures``, ``replays`` and ``failures`` are running totals.  The
kernels' own launch counters count where their wrappers run: a capture's
warm-up pass and its capture pass count once each, and a replay, which
runs no wrapper, counts nothing (``replays`` counts those).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import warnings
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

DIFF = "final_posteriors"  # the one differentiable output


class CudaGraphs:
    """Capture on CUDA: one warm-up forward and backward on a side stream,
    then the forward and the backward each captured into a
    ``torch.cuda.CUDAGraph`` on that stream, the two in one memory pool of
    their own (they replay in the order they were captured)."""

    def __init__(self):
        self._stream: Optional[torch.cuda.Stream] = None

    def supports(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def capture(self, forward: Callable, batch: torch.Tensor, lengths: torch.Tensor,
                params: Sequence[torch.Tensor]) -> "CudaGraph":
        if self._stream is None:
            self._stream = torch.cuda.Stream(batch.device)
        try:
            return CudaGraph(forward, batch, lengths, params, self._stream)
        except Exception:
            # a capture that raised never ran the end of the CUDA generators'
            # capture, and they would refuse every later draw outside one; a
            # capture that ends runs it
            with torch.cuda.stream(self._stream):
                with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=self._stream):
                    torch.zeros(1, device=batch.device)
            raise


class CudaGraph:
    """A key's two graphs and their static buffers: ``inputs`` (batch,
    lengths), ``outputs`` (the forward's dict), ``grad_output`` (the
    gradient of ``final_posteriors``) and ``grads`` (one per trainable
    parameter, ``None`` where the output does not depend on it)."""

    def __init__(self, forward, batch, lengths, params, stream: torch.cuda.Stream):
        self.inputs = (batch.detach().clone(), lengths.detach().clone())
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(batch.device)
        stream.wait_stream(main)
        try:
            # the outer stream context restores the current stream even where
            # a failed capture leaves ``torch.cuda.graph`` half exited
            with torch.cuda.stream(stream):
                out = forward(*self.inputs)
                torch.autograd.grad(out[DIFF], params, torch.zeros_like(out[DIFF]),
                                    allow_unused=True)
                del out
                with torch.cuda.graph(self.fwd, pool=pool, stream=stream):
                    out = forward(*self.inputs)
                if not all(isinstance(v, torch.Tensor) for v in out.values()):
                    raise TypeError("a graphed forward returns a dict of tensors")
                self.outputs = {k: v.detach() for k, v in out.items()}
                self.grad_output = torch.zeros_like(out[DIFF])
                with torch.cuda.graph(self.bwd, pool=pool, stream=stream):
                    self.grads = torch.autograd.grad(out[DIFF], params, self.grad_output,
                                                     allow_unused=True)
        finally:
            main.wait_stream(stream)

    def replay_forward(self, batch: torch.Tensor, lengths: torch.Tensor) -> None:
        self.inputs[0].copy_(batch)
        self.inputs[1].copy_(lengths)
        self.fwd.replay()

    def replay_backward(self, grad: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        self.grad_output.copy_(grad)
        self.bwd.replay()
        return self.grads


class _Replay(torch.autograd.Function):
    """The forward graph's outputs, in the forward's order; the backward
    replays the backward graph and hands autograd the parameters'
    gradients.  Outputs and gradients are fresh aliases of the static
    buffers, so autograd takes a gradient as a parameter's ``.grad`` without
    a copy where ``.grad`` is unset (the engine clears it every step); a
    ``.grad`` that still aliases the buffers from an earlier step is moved
    off them before the replay rewrites them, so it accumulates as eager."""

    @staticmethod
    def forward(ctx, graph, batch, lengths, *params):
        graph.replay_forward(batch, lengths)
        ctx.graph, ctx.params = graph, params
        outs = tuple(t.detach() for t in graph.outputs.values())
        ctx.mark_non_differentiable(*(t for k, t in zip(graph.outputs, outs) if k != DIFF))
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        graph = ctx.graph
        for p, g in zip(ctx.params, graph.grads):
            if p.grad is not None and g is not None and p.grad.data_ptr() == g.data_ptr():
                p.grad = p.grad.clone()
        grads = graph.replay_backward(grads[list(graph.outputs).index(DIFF)])
        return (None, None, None, *(None if g is None else g.detach() for g in grads))


def _hooked_below(module: torch.nn.Module) -> bool:
    """Whether global module hooks are set or a module under ``module``
    carries hooks."""
    from torch.nn.modules import module as nn_module

    if any(getattr(nn_module, name, None) for name in (
            "_global_forward_pre_hooks", "_global_forward_hooks", "_global_backward_pre_hooks",
            "_global_backward_hooks")):
        return True
    return any(sub._forward_pre_hooks or sub._forward_hooks or sub._backward_pre_hooks
               or sub._backward_hooks for sub in itertools.islice(module.modules(), 1, None))


def _addresses(module: torch.nn.Module) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in itertools.chain(module.parameters(), module.buffers()))


class GraphedForward:
    """The graph of one model, one key at a time; ``backend`` captures it
    (:class:`CudaGraphs` by default: ``supports(device)`` and
    ``capture(forward, batch, lengths, params)``, which returns an object
    with ``outputs``, ``grads``, ``replay_forward(batch, lengths)`` and
    ``replay_backward(grad)``, the last two rewriting ``outputs`` and
    ``grads``)."""

    def __init__(self, backend=None):
        self.backend = CudaGraphs() if backend is None else backend
        self._graph = self._key = self._at = None  # the one live graph
        self._seen = set()  # the keys seen in this pass
        self._failed = set()
        self.captures = self.replays = self.failures = 0

    def new_pass(self) -> None:
        """A new pass over a record's windows: the keys seen before it no
        longer count towards a capture."""
        self._seen.clear()

    def engages(self, module: torch.nn.Module, batch: torch.Tensor, mesh=None) -> bool:
        return (mesh is None and torch.is_grad_enabled() and not batch.requires_grad
                and self.backend.supports(batch.device) and not _hooked_below(module))

    @contextlib.contextmanager
    def step(self, module: torch.nn.Module, batch: torch.Tensor, mesh=None):
        """Around the adapt step's call ``module(batch, lengths)``: where
        :meth:`engages`, that call's forward goes through the graph."""
        if not self.engages(module, batch, mesh):
            yield
            return
        missing = object()
        saved = module.__dict__.get("forward", missing)
        module.forward = functools.partial(self._forward, module, module.forward)
        try:
            yield
        finally:
            if saved is missing:
                del module.forward
            else:
                module.forward = saved

    def _forward(self, module, eager, *args, **kwargs):
        if len(args) != 2 or kwargs or args[1].device != args[0].device:
            return eager(*args, **kwargs)
        batch, lengths = args
        params = list(module.parameters())
        trainable = [p for p in params if p.requires_grad]
        key = (tuple(batch.shape), batch.dtype, batch.device, tuple(lengths.shape),
               lengths.dtype, tuple(p.requires_grad for p in params), module.training)
        if key in self._failed:
            return eager(batch, lengths)
        addresses = _addresses(module)
        if (key, addresses) != (self._key, self._at):
            if key not in self._seen:
                self._seen.add(key)
                return eager(batch, lengths)
            self._graph = self._key = self._at = None  # the old graph and its pool go
            try:
                graph = self.backend.capture(eager, batch, lengths, trainable)
            except Exception as exc:  # the step runs on, eager, and says why
                self._failed.add(key)
                self.failures += 1
                warnings.warn(f"CUDA graph capture of the model for a batch of "
                              f"{tuple(batch.shape)} failed, that shape stays eager: {exc!r}",
                              stacklevel=2)
                return eager(batch, lengths)
            self._graph, self._key, self._at = graph, key, addresses
            self.captures += 1
        self.replays += 1
        outs = _Replay.apply(self._graph, batch, lengths, *trainable)
        return dict(zip(self._graph.outputs, outs))
