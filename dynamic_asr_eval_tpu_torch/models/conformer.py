"""Self-conditioned conformer-CTC encoder (lcasr ``SCConformerXL`` form).

Counterpart of the JAX package's ``models/conformer.py``.  The configuration
keeps the JAX field names and values, and the parameters carry the lcasr
torch names that the JAX package's ``models/convert.py`` maps, so one set of
weights drives both.  Semantics followed line by line:

- the input is masked by length; depthwise-striding subsampling with
  torch-aligned (1, 1) padding, feature-major flatten (f·C + c) into
  ``out``.  ``subsampling_impl="conv"`` runs ``F.conv2d`` with a length mask
  after each stride-2 stage (``ceil(len / 2^(k+1))``);
  ``subsampling_impl="pallas"`` with factor 8 and ``feat_in % 8 == 0`` runs
  the fused Hopper kernel of :mod:`..kernels.subsample` with no masks
  between stages, as the JAX package's fused kernel (the two differ on a
  window whose length is not a multiple of 8); other shapes take the conv
  path, as in JAX;
  the ``"xla"``, ``"hybrid"`` and ``"conv_tapbwd"`` lowerings are TPU
  formulations of the ``"conv"`` math (same parameters, same per-stage
  masks) and run the conv path here; ``subsampling_norm_out`` adds a
  LayerNorm after ``out`` on every lowering; ``input_xscale`` scales the
  embedding by √d_model;
- macaron blocks: ½-FF → MHSA → conv module → ½-FF → ``norm_out``;
- rotary embedding on half-split pairs, cos/sin in f32;
- attention: ``attention_impl="pallas_flash"`` runs the Hopper kernel of
  :mod:`..kernels.attention` (segment semantics); ``"xla"`` runs plain
  PyTorch attention with a −1e30 key-mask bias; ``position_encoding=
  "rel_pos"`` (NeMo's Transformer-XL attention: ``pos_bias_u`` /
  ``pos_bias_v``, ``linear_pos`` over sinusoidal relative embeddings, the
  pad-reshape relative shift) is plain PyTorch whatever ``attention_impl``
  says, as in JAX, where it is plain XLA; ``bias_in_attn`` puts a bias on
  ``qkv`` (``out`` always has one);
- conv module: pw1 → GLU → mask → depthwise K → mid norm → SiLU → pw2; the
  mid norm is a LayerNorm, or with ``default_norm`` ``"batch_renorm"`` /
  ``"batch_norm"`` a :class:`BatchRenorm` (running statistics as buffers;
  the engines read them, ``use_running_average=False`` renormalises by the
  masked batch statistics and updates them);
- dropout (``dropout_ff``, ``dropout_attn``, ``dropout_conv``) only when
  ``forward`` is given ``deterministic=False`` and a ``torch.Generator``;
  the engines never do, as JAX's never pass ``deterministic=False``;
- shared ``decoder_norm`` + ``decoder`` CTC head, fp32 log-softmax;
  self-conditioning adds a re-embedding of ``exp(lp)`` after every block but
  the last, then re-masks;
- dtypes: fp32 parameters, ``compute_dtype`` activations (each dense layer
  casts its input and weights to it), LayerNorm in f32 returned in the
  input's dtype (eps 1e-5), the head in f32 unless ``head_in_compute_dtype``.

Activation rematerialisation, as JAX's ``nn.remat``: with
``checkpoint_every_n_layers`` n, blocks i with ``i % n == 0``, and with
``remat_subsampling`` the subsampling module, run under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` when
gradients are on: their activations are recomputed in the backward, which
launches the kernels a second time (the launch counters count it).  The
recomputation sees the batch-renorm running statistics and a dropout
generator as the forward saw them, and leaves them as the forward left them:
the statistics move once a step, as flax keeps only the primal pass's
updates.  A model whose ``rematerialise`` is false (the records-batched
engine sets it around its ``torch.func.vmap`` forwards, inside which a
checkpoint cannot recompute) keeps every activation.

Tensor parallelism (``parallel.shard_params``): a module whose weights
were sliced holds the tp group (its ``tp``) and reads its rank's shards.
The column-parallel input goes through ``copy_to_tp``, the row-parallel
output through ``reduce_from_tp`` before the replicated bias is added;
attention runs this rank's heads; the conv module's LayerNorm mid norm
takes its per-frame moments from two all-reduces over tp (the sum, then
the sum of squared deviations: LayerNorm's two passes), a batch-renorm mid
norm is per channel and needs none.  Subsampling, the LayerNorms outside
the conv module, the CTC head and the re-embedding stay replicated.

Sequence parallelism: with ``seq_shard_axes = (b_ax, s_ax)`` and, around
the call, ``parallel.use_mesh(mesh)`` whose mesh has a dimension named
``s_ax`` of more than one rank, the blocks run on this rank's block of the
time axis (otherwise the setting is a no-op, as JAX's constraint is outside
a mesh).  Subsampling runs on the whole window; T_ds is padded with invalid
frames to a multiple of sp and ``split_seq`` takes the block; rotary
positions start at the block's start; attention gathers K and V
(``gather_kv``) and runs the query block (``flash_attention(...,
q_offset)``, or the plain versions; ``rel_pos`` scores the block's rows
against all keys without the whole T×T matrix); the depthwise convolution
reads its ``halo``; batch-renorm batch statistics are summed over sp; the
self-conditioning head runs per frame on the block, and the log-probs and
``a_hidden`` come back through ``gather_seq`` with the padding stripped, so
the forward's inputs and outputs are what they are unsharded.  Every
parameter read inside the sharded region goes through ``sync_grad``.  The
batch axis ``b_ax`` is not split here: the engines give every rank the
whole batch and split windows or records over dp above the model.  TP and
SP combine on a mesh with both dimensions (``('dp', 'tp', 'sp')``).  With
dropout on, TP and SP ranks draw their masks each from its own generator.

Not ported (raise ``NotImplementedError``): a subsampling other than
``"dw_striding"`` and an ``attention_impl`` other than ``"xla"`` /
``"pallas_flash"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from dynamic_asr_eval_tpu_torch.kernels.attention import flash_attention
from dynamic_asr_eval_tpu_torch.kernels.subsample import fused_subsample
from dynamic_asr_eval_tpu_torch.parallel.collectives import (
    Group,
    copy_to_tp,
    gather_kv,
    gather_seq,
    halo,
    reduce_from_tp,
    split_seq,
    sum_partials,
    sync_grad,
)
from dynamic_asr_eval_tpu_torch.parallel.mesh import axis_group, current_mesh

LN_EPS = 1e-5

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def to_torch_dtype(x) -> torch.dtype:
    """A torch dtype, a dtype name, or a framework dtype object whose name
    contains one of bfloat16 / float32 / float16."""
    if isinstance(x, torch.dtype):
        return x
    s = str(getattr(x, "__name__", x))
    for name, dt in _DTYPES.items():
        if name in s:
            return dt
    raise ValueError(f"unsupported compute dtype {x!r}")


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    feat_in: int = 80
    n_layers: int = 6
    d_model: int = 768
    n_heads: int = 6
    head_dim: int = 128
    vocab_size: int = 4095  # output dim = vocab_size + 1 (CTC blank, last id)
    subsampling_factor: int = 8
    subsampling: str = "dw_striding"
    subsampling_act: str = "silu"
    subsampling_conv_channels: int = 256
    subsampling_norm_out: bool = False
    conv_kernel_size: int = 9
    expansion_factor: int = 4
    self_conditioning: bool = True
    decoder_norm: bool = True
    use_rotary: bool = True
    rotary_base_freq: float = 1_500_000.0
    rotary_interpolation_factor: float = 1.0
    position_encoding: Optional[str] = None  # "rotary" | "rel_pos" | "none"
    input_xscale: bool = False
    bias_in_attn: bool = False
    default_norm: str = "layer_norm"  # or "batch_renorm" / "batch_norm"
    bias_in_ff: bool = False
    checkpoint_every_n_layers: int = 0
    dropout_ff: float = 0.0
    dropout_attn: float = 0.0
    dropout_conv: float = 0.0
    compute_dtype: Any = torch.bfloat16
    attention_impl: str = "xla"  # "xla" | "pallas_flash" (kernels.attention)
    attention_logits_in_compute_dtype: bool = False
    head_in_compute_dtype: bool = False
    # "conv" | "pallas" (kernels.subsample); "xla" | "hybrid" | "conv_tapbwd"
    # run the "conv" path
    subsampling_impl: str = "conv"
    remat_subsampling: bool = False
    seq_shard_axes: Optional[Any] = None

    def __post_init__(self):
        object.__setattr__(self, "compute_dtype", to_torch_dtype(self.compute_dtype))

    @property
    def pos_encoding(self) -> str:
        if self.position_encoding is not None:
            return self.position_encoding
        return "rotary" if self.use_rotary else "none"

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def n_classes(self) -> int:
        return self.vocab_size + 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ConformerConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


_SUBSAMPLING_IMPLS = ("conv", "pallas", "xla", "hybrid", "conv_tapbwd")
_BATCH_NORMS = ("batch_renorm", "batch_norm")


def _check_supported(cfg: ConformerConfig) -> None:
    unsupported = {
        "subsampling": cfg.subsampling != "dw_striding",
        "attention_impl": cfg.attention_impl not in ("xla", "pallas_flash"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"conformer options not ported: {bad}")
    if cfg.seq_shard_axes is not None and len(cfg.seq_shard_axes) != 2:
        raise ValueError(f"seq_shard_axes is (batch_axis, seq_axis), got {cfg.seq_shard_axes!r}")
    if cfg.subsampling_impl not in _SUBSAMPLING_IMPLS:
        raise ValueError(f"unknown subsampling_impl {cfg.subsampling_impl!r}")
    if cfg.pos_encoding not in ("rotary", "rel_pos", "none"):
        raise ValueError(f"unknown position encoding {cfg.pos_encoding!r}")
    if cfg.default_norm not in ("layer_norm",) + _BATCH_NORMS:
        raise ValueError(f"unknown norm kind {cfg.default_norm}")


def _act(name: str):
    # "gelu" is jax.nn.gelu's default, the tanh approximation
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda z: F.gelu(z, approximate="tanh")}[name]


def lengths_to_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input and weights cast to ``dtype``."""
    return F.linear(x.to(dtype), w.to(dtype), None if b is None else b.to(dtype))


def _same(p):
    return p


class SeqShard:
    """This rank's place in the sequence-sharded region: the sp group, the
    block's first frame, and the valid-frame mask of the whole (padded)
    sequence [B, T], which attention's keys need."""

    def __init__(self, group: Group, start: int, mask: torch.Tensor):
        self.group, self.start, self.mask = group, start, mask

    def read(self, p):
        """A parameter as the sharded region reads it (``sync_grad``)."""
        return sync_grad(p, self.group)


def _reader(sp: Optional[SeqShard]):
    return _same if sp is None else sp.read


def _row_dense(x, w, b, dtype, tp: Optional[Group]) -> torch.Tensor:
    """``_dense`` of a row-parallel layer: the partial products summed over
    tp, then the (replicated) bias."""
    if tp is None:
        return _dense(x, w, b, dtype)
    y = reduce_from_tp(_dense(x, w, None, dtype), tp)
    return y if b is None else y + b.to(dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, read=_same) -> torch.Tensor:
    """flax ``LayerNorm(dtype=x.dtype)``: statistics in f32, output in x's
    dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, read(ln.weight), read(ln.bias),
                        LN_EPS).to(x.dtype)


def _tp_layer_norm(x: torch.Tensor, ln: nn.LayerNorm, tp: Group, read=_same) -> torch.Tensor:
    """:func:`_layer_norm` over channels split across the tp group: the
    per-frame mean and then the variance from two sums over the group."""
    xf = x.float()
    d = xf.shape[-1] * tp.size
    mean = sum_partials(xf.sum(-1, keepdim=True), tp) / d
    xc = xf - mean
    var = sum_partials((xc * xc).sum(-1, keepdim=True), tp) / d
    return (xc * torch.rsqrt(var + LN_EPS) * read(ln.weight) + read(ln.bias)).to(x.dtype)


def rotary_freqs(head_dim: int, base: float, T: int, interpolation: float, device,
                 offset: int = 0):
    """cos, sin [T, head_dim/2] of positions ``offset .. offset + T - 1``."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(offset, offset + T, dtype=torch.float32, device=device) / interpolation
    ang = torch.outer(t, inv)  # [T, head_dim/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D]; rotate half-split pairs (x[..., i], x[..., i + D/2]),
    in f32, returned in x's dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def plain_attention(q, k, v, mask, compute_dtype, logits_in_compute_dtype: bool):
    """The JAX package's "xla" attention: f32 logits (optionally cast to the
    compute dtype), a −1e30 bias on padding keys, softmax, weighted sum."""
    D = q.shape[-1]
    scale = (1.0 / torch.tensor(math.sqrt(D)).to(compute_dtype)).to(compute_dtype).float()
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if logits_in_compute_dtype:
        logits = logits.to(compute_dtype)
    bias = torch.where(mask[:, None, None, :], 0.0, -1e30).to(logits.dtype)
    attn = torch.softmax(logits + bias, dim=-1).to(compute_dtype)
    return torch.einsum("bhts,bshd->bthd", attn, v.to(compute_dtype))


def relpos_encoding(d_model: int, T: int, device=None, Tk: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Sinusoidal embeddings of relative positions T-1 … -(T-1), [2T-1,
    d_model] f32: index 0 is the most distant past key (NeMo's
    ``RelPositionalEncoding`` layout); sin on even features, cos on odd.
    For T query rows ``q_offset ..`` against ``Tk`` keys: the distances
    ``q_offset + T - 1`` … ``q_offset - Tk + 1``, [T + Tk - 1, d_model]."""
    Tk = T if Tk is None else Tk
    pos = torch.arange(q_offset + T - 1, q_offset - Tk, -1, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    ang = pos[:, None] * div[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(-1, d_model)


def rel_shift(x: torch.Tensor, Tk: Optional[int] = None) -> torch.Tensor:
    """Transformer-XL relative shift: x [B, H, T, T+Tk-1] (last axis indexed
    by embedding position k, relative distance T-1-k) → [B, H, T, Tk] whose
    (i, j) is x[..., i, j - i + T - 1] (Tk = T by default); the pad-reshape
    trick, no gather."""
    B, H, T, W = x.shape
    Tk = T if Tk is None else Tk
    x = F.pad(x, (1, 0)).reshape(B, H, T * (W + 1))[..., T:]
    return x.reshape(B, H, T, W)[..., :Tk]


def relpos_attention(q, k, v, mask, pos, pos_bias_u, pos_bias_v, compute_dtype):
    """The JAX package's ``rel_pos`` attention: content scores (q + u)·k and
    relatively shifted position scores (q + v)·pos in f32, their sum over
    √D, a −1e30 bias on padding keys, softmax in f32, probabilities in the
    compute dtype times v.  q [B, T, H, D], k, v [B, Tk, H, D]; pos [T+Tk-1,
    H, D] (:func:`relpos_encoding` of the query rows)."""
    D = q.shape[-1]
    qf = q.float()
    ac = torch.einsum("bthd,bshd->bhts", qf + pos_bias_u, k.float())
    bd = torch.einsum("bthd,khd->bhtk", qf + pos_bias_v, pos.float())
    logits = (ac + rel_shift(bd, k.shape[1])) / math.sqrt(D)
    bias = torch.where(mask[:, None, None, :], 0.0, -1e30)
    attn = torch.softmax(logits + bias, dim=-1).to(compute_dtype)
    return torch.einsum("bhts,bshd->bthd", attn, v.to(compute_dtype))


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity when ``deterministic`` or the
    rate is 0.  Random only through an explicit ``generator``."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class BatchRenorm(nn.Module):
    """Batch renormalisation over the feature axis of [B, T, C] inputs with
    a time mask (the JAX package's ``BatchRenorm``; ``default_norm``
    ``"batch_renorm"`` and ``"batch_norm"`` share it).  ``weight`` / ``bias``
    are the affine parameters (flax ``scale`` / ``bias``), ``running_mean``
    / ``running_var`` buffers (flax ``batch_stats`` ``mean`` / ``var``).
    With ``use_running_average`` (what the engines run) it normalises by the
    running statistics.  Without, by the masked batch statistics,
    renormalised by r = std / running std clipped to [1/rmax, rmax] and d =
    (mean - running mean) / running std clipped to [-dmax, dmax], both
    detached, and the buffers move by ``momentum`` towards the batch's.  In
    f32, returned in the input's dtype."""

    def __init__(self, features: int, momentum: float = 0.001, eps: float = 1e-5,
                 rmax: float = 3.0, dmax: float = 5.0):
        super().__init__()
        self.momentum, self.eps, self.rmax, self.dmax = momentum, eps, rmax, dmax
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                use_running_average: bool = True, read=_same,
                group: Optional[Group] = None) -> torch.Tensor:
        """``group``: the frames are split over its ranks (sequence
        parallelism), whose masked sums the batch statistics add up."""
        xf = x.float()
        if use_running_average:
            xn = (xf - self.running_mean) / torch.sqrt(self.running_var + self.eps)
        else:
            m = (torch.ones(x.shape[:2], device=x.device) if mask is None
                 else mask.float())[..., None]
            cnt = torch.clamp(sum_partials(m.sum((0, 1)), group), min=1.0)
            mean = sum_partials((xf * m).sum((0, 1)), group) / cnt
            var = sum_partials(((xf - mean) ** 2 * m).sum((0, 1)), group) / cnt
            std = torch.sqrt(var + self.eps)
            r_std = torch.sqrt(self.running_var + self.eps)
            r = torch.clamp(std / r_std, 1.0 / self.rmax, self.rmax).detach()
            d = torch.clamp((mean - self.running_mean) / r_std, -self.dmax, self.dmax).detach()
            xn = (xf - mean) / std * r + d
            with torch.no_grad():
                self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var
                                       + self.momentum * var)
        return (xn * read(self.weight) + read(self.bias)).to(x.dtype)


class DWStridingSubsampling(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        n_stages = {2: 1, 4: 2, 8: 3}[cfg.subsampling_factor]
        C = cfg.subsampling_conv_channels
        self.conv_in = nn.Conv2d(1, C, 3, stride=2, padding=1)
        self.dw_conv = nn.ModuleList(
            nn.Conv2d(C, C, 3, stride=2, padding=1, groups=C) for _ in range(n_stages - 1))
        self.pw_conv = nn.ModuleList(nn.Conv2d(C, C, 1) for _ in range(n_stages - 1))
        f_ds = cfg.feat_in
        for _ in range(n_stages):
            f_ds = -(-f_ds // 2)
        self.out = nn.Linear(f_ds * C, cfg.d_model)
        self.norm_out = nn.LayerNorm(cfg.d_model, eps=LN_EPS) if cfg.subsampling_norm_out else None

    def uses_fused_kernel(self, feat: int) -> bool:
        """The JAX module's dispatch: the fused kernel for ×8 and F % 8 == 0."""
        return (self.cfg.subsampling_impl == "pallas" and self.cfg.subsampling_factor == 8
                and feat % 8 == 0)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """No masks between stages; the weights come from the convs, so the
        gradients reach the same parameters as on the conv path."""
        C = self.conv_in.out_channels

        def taps(conv):  # [C, 1, 3, 3] → [9, C], (dt, df) row-major
            return conv.weight[:, 0].reshape(C, 9).t()

        weights = [taps(self.conv_in), self.conv_in.bias]
        for dw, pw in zip(self.dw_conv, self.pw_conv):
            weights += [taps(dw), dw.bias, pw.weight[:, :, 0, 0].t(), pw.bias]
        h = fused_subsample(x, *weights, act_name=self.cfg.subsampling_act)
        B, T_ds, F_ds, _ = h.shape
        return h.reshape(B, T_ds, F_ds * C)

    def forward(self, x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """x [B, T, F] in the compute dtype → [B, ceil(T/factor), d_model]."""
        cd = self.cfg.compute_dtype
        if self.uses_fused_kernel(x.shape[-1]):
            h = self._fused(x.to(cd))
        else:
            h = self._conv(x, length)
        h = _dense(h, self.out.weight, self.out.bias, cd)
        return h if self.norm_out is None else _layer_norm(h, self.norm_out)

    def _conv(self, x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """The masked conv path → [B, T_ds, F_ds·C], feature-major."""
        cd = self.cfg.compute_dtype
        act = _act(self.cfg.subsampling_act)

        def conv(h, layer, stride, padding, groups=1):
            return F.conv2d(h, layer.weight.to(cd), layer.bias.to(cd),
                            stride=stride, padding=padding, groups=groups)

        def stage_mask(h, k):  # h [B, C, T_k, F_k]
            div = 2 ** (k + 1)
            valid = (length + div - 1) // div
            keep = torch.arange(h.shape[2], device=h.device)[None, :] < valid[:, None]
            return torch.where(keep[:, None, :, None], h, torch.zeros((), dtype=h.dtype, device=h.device))

        h = stage_mask(act(conv(x[:, None], self.conv_in, 2, 1)), 0)
        for i, (dw, pw) in enumerate(zip(self.dw_conv, self.pw_conv)):
            h = conv(h, dw, 2, 1, groups=h.shape[1])
            h = stage_mask(act(conv(h, pw, 1, 0)), i + 1)
        B, C, T_ds, F_ds = h.shape
        return h.permute(0, 2, 3, 1).reshape(B, T_ds, F_ds * C)  # feature-major


class FeedForward(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.in_proj = nn.Linear(d, d * cfg.expansion_factor, bias=cfg.bias_in_ff)
        self.out_proj = nn.Linear(d * cfg.expansion_factor, d, bias=cfg.bias_in_ff)
        self.tp: Optional[Group] = None  # set by parallel.shard_params

    def forward(self, x, deterministic=True, generator=None, sp=None):
        cd, rate = self.cfg.compute_dtype, self.cfg.dropout_ff
        r = _reader(sp)
        h = copy_to_tp(_layer_norm(x, self.norm, r), self.tp)
        h = _dense(h, r(self.in_proj.weight), r(self.in_proj.bias), cd)
        h = dropout(F.silu(h), rate, deterministic, generator)
        h = _row_dense(h, r(self.out_proj.weight), r(self.out_proj.bias), cd, self.tp)
        return dropout(h, rate, deterministic, generator)


class MHSA(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        HD = cfg.n_heads * cfg.head_dim
        self.norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.qkv = nn.Linear(cfg.d_model, 3 * HD, bias=cfg.bias_in_attn)
        if cfg.pos_encoding == "rel_pos":
            self.pos_bias_u = nn.Parameter(torch.zeros(cfg.n_heads, cfg.head_dim))
            self.pos_bias_v = nn.Parameter(torch.zeros(cfg.n_heads, cfg.head_dim))
            self.linear_pos = nn.Linear(cfg.d_model, HD, bias=False)
        self.out = nn.Linear(HD, cfg.d_model)
        self.tp: Optional[Group] = None  # set by parallel.shard_params

    def forward(self, x, mask, cos, sin, deterministic=True, generator=None, sp=None):
        """Under sequence parallelism ``x`` is the block of query rows from
        ``sp.start``; keys and values are gathered over every block."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        D = cfg.head_dim
        H = self.qkv.weight.shape[0] // (3 * D)  # this rank's heads
        B, T, _ = x.shape
        r = _reader(sp)
        qkv = _dense(copy_to_tp(_layer_norm(x, self.norm, r), self.tp), r(self.qkv.weight),
                     r(self.qkv.bias), cd)
        q, k, v = qkv.view(B, T, 3, H, D).unbind(2)  # strided [B, T, H, D] views
        if cfg.pos_encoding == "rotary":
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        start, key_mask = 0, mask
        if sp is not None:
            start, key_mask = sp.start, sp.mask
            k, v = gather_kv(k, 1, sp.group), gather_kv(v, 1, sp.group)
        if cfg.pos_encoding == "rel_pos":  # plain in both packages, whatever attention_impl says
            Tk = k.shape[1]
            pe = relpos_encoding(cfg.d_model, T, x.device, Tk, start)
            pos = _dense(pe, r(self.linear_pos.weight), None, cd).view(T + Tk - 1, H, D)
            out = relpos_attention(q, k, v, key_mask, pos, r(self.pos_bias_u),
                                   r(self.pos_bias_v), cd)
        elif cfg.attention_impl == "pallas_flash":
            out = flash_attention(q, k, v, key_mask, start)
        else:
            out = plain_attention(q, k, v, key_mask, cd, cfg.attention_logits_in_compute_dtype)
        out = _row_dense(out.reshape(B, T, H * D), r(self.out.weight), r(self.out.bias), cd,
                         self.tp)
        return dropout(out, cfg.dropout_attn, deterministic, generator)


class ConvModule(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        d, K = cfg.d_model, cfg.conv_kernel_size
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.pw1 = nn.Conv1d(d, 2 * d, 1)
        self.dw = nn.Conv1d(d, d, K, groups=d)
        if cfg.default_norm in _BATCH_NORMS:
            self.norm_mid = BatchRenorm(d)
        else:
            self.norm_mid = nn.LayerNorm(d, eps=LN_EPS)
        self.pw2 = nn.Conv1d(d, d, 1)
        self.tp: Optional[Group] = None  # set by parallel.shard_params

    def forward(self, x, mask, deterministic=True, generator=None, use_running_average=True,
                sp=None):
        cd = self.cfg.compute_dtype
        K = self.cfg.conv_kernel_size
        r = _reader(sp)
        h = _dense(copy_to_tp(_layer_norm(x, self.norm, r), self.tp), r(self.pw1.weight)[:, :, 0],
                   r(self.pw1.bias), cd)
        a, b = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(b)  # GLU
        h = torch.where(mask[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
        pad_l = (K - 1) // 2
        # [B, d, T + K - 1]: zeros past the sequence, the neighbours' frames
        # between blocks
        hp = halo(h.transpose(1, 2), 2, pad_l, K - 1 - pad_l, None if sp is None else sp.group)
        h = F.conv1d(hp, r(self.dw.weight).to(cd), r(self.dw.bias).to(cd), groups=h.shape[-1])
        h = h.transpose(1, 2)
        if isinstance(self.norm_mid, BatchRenorm):
            h = self.norm_mid(h, mask, use_running_average, r,
                              None if sp is None else sp.group)
        elif self.tp is not None:
            h = _tp_layer_norm(h, self.norm_mid, self.tp, r)
        else:
            h = _layer_norm(h, self.norm_mid, r)
        h = _row_dense(F.silu(h), r(self.pw2.weight)[:, :, 0], r(self.pw2.bias), cd, self.tp)
        return dropout(h, self.cfg.dropout_conv, deterministic, generator)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.ff1 = FeedForward(cfg)
        self.attn = MHSA(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FeedForward(cfg)
        self.norm_out = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def forward(self, x, mask, cos, sin, deterministic=True, generator=None,
                use_running_average=True, sp=None):
        drop = (deterministic, generator)
        x = x + 0.5 * self.ff1(x, *drop, sp=sp)
        x = x + self.attn(x, mask, cos, sin, *drop, sp=sp)
        x = x + self.conv(x, mask, *drop, use_running_average, sp=sp)
        x = x + 0.5 * self.ff2(x, *drop, sp=sp)
        return _layer_norm(x, self.norm_out, _reader(sp))


def remat(module: nn.Module, *args, generator: Optional[torch.Generator] = None):
    """``module(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant).  The recomputation runs
    with the module's buffers and ``generator`` as the forward found them,
    and restores them afterwards to what the forward left."""
    first = {}

    def run(*a):
        buffers = [b for b in module.buffers()]
        if not first:  # the forward
            first["buffers"] = [b.clone() for b in buffers]
            first["rng"] = generator.get_state() if generator is not None else None
            return module(*a)
        now = [b.clone() for b in buffers]
        rng_now = generator.get_state() if generator is not None else None
        with torch.no_grad():
            for b, old in zip(buffers, first["buffers"]):
                b.copy_(old)
        if generator is not None:
            generator.set_state(first["rng"])
        try:
            return module(*a)
        finally:
            with torch.no_grad():
                for b, cur in zip(buffers, now):
                    b.copy_(cur)
            if generator is not None:
                generator.set_state(rng_now)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


class SCConformer(nn.Module):
    """``forward(audio_signal [B, feat_in, T], length [B]) -> {
    'final_posteriors' [B, T_ds, vocab+1] f32 log-probs, 'length' [B]
    downsampled lengths, 'a_hidden' [B, T_ds, d_model]}``.
    ``deterministic=False`` with a ``generator`` applies dropout;
    ``use_running_average=False`` runs the batch-renorm mid-norms on batch
    statistics (and updates their running statistics)."""

    def __init__(self, config: ConformerConfig):
        super().__init__()
        _check_supported(config)
        self.config = config
        d = config.d_model
        self.subsampling = DWStridingSubsampling(config)
        self.layers = nn.ModuleList(ConformerBlock(config) for _ in range(config.n_layers))
        self.decoder_norm = nn.LayerNorm(d, eps=LN_EPS) if config.decoder_norm else None
        self.decoder = nn.Linear(d, config.n_classes)
        # as flax creates it: only where one block feeds another
        self.self_condition_reembed = (
            nn.Linear(config.n_classes, d, bias=False)
            if config.self_conditioning and config.n_layers > 1 else None)
        self.rematerialise = True

    def _ctc_logits(self, h, read=_same):
        cfg = self.config
        z = h.float()
        if self.decoder_norm is not None:
            z = _layer_norm(z, self.decoder_norm, read)
        head_dtype = cfg.compute_dtype if cfg.head_in_compute_dtype else torch.float32
        logits = _dense(z, read(self.decoder.weight), read(self.decoder.bias), head_dtype)
        return torch.log_softmax(logits.float(), dim=-1)

    def seq_group(self) -> Optional[Group]:
        """The sp group of ``seq_shard_axes`` on the current mesh
        (``parallel.use_mesh``); ``None`` (no sharding) without one, or where
        that dimension holds one rank."""
        axes = self.config.seq_shard_axes
        return None if axes is None else axis_group(current_mesh(), axes[1])

    def forward(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                use_running_average: bool = True) -> Dict[str, torch.Tensor]:
        cfg = self.config
        cd = cfg.compute_dtype
        x = audio_signal.transpose(1, 2)  # [B, T, F]
        B, T, _ = x.shape
        if length is None:
            length = torch.full((B,), T, dtype=torch.int64, device=x.device)
        length = length.to(device=x.device, dtype=torch.int64)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x = torch.where(lengths_to_mask(length, T)[..., None], x, zero).to(cd)

        remat_on = self.rematerialise and torch.is_grad_enabled()
        if cfg.remat_subsampling and remat_on:
            h = remat(self.subsampling, x, length)
        else:
            h = self.subsampling(x, length)
        if cfg.input_xscale:  # NeMo scales the embedding by √d_model
            h = h * torch.sqrt(torch.tensor(float(cfg.d_model))).to(h.dtype)
        T_ds = h.shape[1]
        f = cfg.subsampling_factor
        ds_length = (length + f - 1) // f
        mask = lengths_to_mask(ds_length, T_ds)
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        h = torch.where(mask[..., None], h, zero)
        group = self.seq_group()
        sp, start = None, 0
        if group is not None:  # this rank's block of the padded time axis
            T_pad = -(-T_ds // group.size) * group.size
            block_len = T_pad // group.size
            start = group.rank * block_len
            mask = F.pad(mask, (0, T_pad - T_ds))
            sp = SeqShard(group, start, mask)
            h = split_seq(F.pad(h, (0, 0, 0, T_pad - T_ds)), 1, group)
            mask = mask[:, start : start + block_len]
        cos, sin = rotary_freqs(cfg.head_dim, cfg.rotary_base_freq, h.shape[1],
                                cfg.rotary_interpolation_factor, h.device, start)
        r = _reader(sp)

        n = len(self.layers)
        every = cfg.checkpoint_every_n_layers
        for i, block in enumerate(self.layers):
            if every and i % every == 0 and remat_on:
                h = remat(block, h, mask, cos, sin, deterministic, generator, use_running_average,
                          sp, generator=generator)
            else:
                h = block(h, mask, cos, sin, deterministic, generator, use_running_average, sp)
            if self.self_condition_reembed is not None and i < n - 1:
                lp = self._ctc_logits(h, r)
                h = h + _dense(torch.exp(lp), r(self.self_condition_reembed.weight), None, cd)
                h = torch.where(mask[..., None], h, zero)

        lp = self._ctc_logits(h, r)
        if sp is not None:  # the whole sequence again, its padding stripped
            lp = gather_seq(lp, 1, group)[:, :T_ds]
            h = gather_seq(h, 1, group)[:, :T_ds]
        return {
            "final_posteriors": lp,
            "length": ds_length,
            "a_hidden": h,
        }


@torch.no_grad()
def init_conformer(config: ConformerConfig, seed: int = 0,
                   device: Optional[torch.device] = None) -> SCConformer:
    """Random weights from ``seed`` (drawn on the CPU, so every device gets
    the same numbers): lecun-normal kernels (std 1/√fan_in), zero biases and
    relative-position biases, unit norm scales, running statistics at mean
    0 and variance 1."""
    model = SCConformer(config)
    g = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        if isinstance(_owner(model, name), (nn.LayerNorm, BatchRenorm)):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias") or name.endswith(("pos_bias_u", "pos_bias_v")):
            p.zero_()
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
    return model.to(device) if device is not None else model


def _owner(model: nn.Module, param_name: str) -> nn.Module:
    return model.get_submodule(param_name.rsplit(".", 1)[0])
