"""Plain conformer-CTC encoder, the benchmark's reference forward.

One function covers both configurations of the benchmark: the lcasr
SCConformer (rotary attention, LayerNorm mid norm, self-conditioning) and
NeMo's FastConformer (Transformer-XL relative positions, batch norm with
running statistics, biases, the √d_model input scale).  It reads its shapes
and options from a configuration file's ``"model"`` object and its weights
from a dict of tensors under the lcasr names (``param_shapes``).

Everything runs in float32 with plain PyTorch operations and no kernel of
the program; ``quant`` rounds the operands of every product (dense layers,
convolutions, attention), which is how the precision control is computed.
Only valid frames are defined: padding frames of the output are zero.

Semantics, per the published models:

- the input [B, F, T] is zeroed past each length; the ×8 depthwise-striding
  subsampling (3×3 stride-2 convolutions, padding 1; activation after the
  first convolution and after each pointwise convolution) runs without
  masks between its stages; its [B, C, T', F'] output is flattened
  feature-major (f·C + c) into the ``out`` projection;
- macaron blocks: x + ½ FF, x + MHSA, x + conv module, x + ½ FF, LayerNorm;
- FF: LayerNorm, Linear, SiLU, Linear;
- MHSA: LayerNorm, one qkv projection, then rotary embeddings on half-split
  pairs (positions from 0) and scaled dot-product attention, or relative
  positions (content scores (q + u)·k, position scores (q + v)·p(i - j)
  over sinusoidal embeddings of i - j through ``linear_pos``); padding keys
  are excluded;
- conv module: LayerNorm, pointwise to 2d, GLU, padding frames zeroed,
  depthwise convolution (kernel K, centred), mid norm (LayerNorm, or batch
  norm with running statistics), SiLU, pointwise;
- CTC head: optional LayerNorm, Linear, log-softmax; with
  self-conditioning every block but the last adds ``exp(log-probs)``
  through ``self_condition_reembed`` and re-zeroes the padding frames.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _stages(factor: int) -> int:
    return {2: 1, 4: 2, 8: 3}[factor]


def param_shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(name, shape, kind)`` of every weight and buffer, kind one of
    ``kernel`` (fan-in scaled), ``bias``, ``norm_scale``, ``norm_bias``,
    ``small`` (relative-position biases), ``running_mean``, ``running_var``."""
    d, C, H, D = m["d_model"], m["subsampling_conv_channels"], m["n_heads"], m["head_dim"]
    K, V, E = m["conv_kernel_size"], m["vocab_size"] + 1, m.get("expansion_factor", 4)
    rel = m.get("position_encoding") == "rel_pos"
    batch_norm = m.get("default_norm", "layer_norm") in ("batch_norm", "batch_renorm")
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def add(name, shape, kind):
        out.append((name, tuple(shape), kind))

    def norm(prefix):
        add(f"{prefix}.weight", (d,), "norm_scale")
        add(f"{prefix}.bias", (d,), "norm_bias")

    add("subsampling.conv_in.weight", (C, 1, 3, 3), "kernel")
    add("subsampling.conv_in.bias", (C,), "bias")
    n = _stages(m["subsampling_factor"])
    for i in range(n - 1):
        add(f"subsampling.dw_conv.{i}.weight", (C, 1, 3, 3), "kernel")
        add(f"subsampling.dw_conv.{i}.bias", (C,), "bias")
    for i in range(n - 1):
        add(f"subsampling.pw_conv.{i}.weight", (C, C, 1, 1), "kernel")
        add(f"subsampling.pw_conv.{i}.bias", (C,), "bias")
    f_ds = m["feat_in"]
    for _ in range(n):
        f_ds = -(-f_ds // 2)
    add("subsampling.out.weight", (d, f_ds * C), "kernel")
    add("subsampling.out.bias", (d,), "bias")
    if m.get("subsampling_norm_out", False):
        norm("subsampling.norm_out")
    for layer in range(m["n_layers"]):
        p = f"layers.{layer}"
        for ff in ("ff1", "ff2"):
            norm(f"{p}.{ff}.norm")
            add(f"{p}.{ff}.in_proj.weight", (E * d, d), "kernel")
            if m.get("bias_in_ff", False):
                add(f"{p}.{ff}.in_proj.bias", (E * d,), "bias")
            add(f"{p}.{ff}.out_proj.weight", (d, E * d), "kernel")
            if m.get("bias_in_ff", False):
                add(f"{p}.{ff}.out_proj.bias", (d,), "bias")
        if rel:
            add(f"{p}.attn.pos_bias_u", (H, D), "small")
            add(f"{p}.attn.pos_bias_v", (H, D), "small")
        norm(f"{p}.attn.norm")
        add(f"{p}.attn.qkv.weight", (3 * H * D, d), "kernel")
        if m.get("bias_in_attn", False):
            add(f"{p}.attn.qkv.bias", (3 * H * D,), "bias")
        if rel:
            add(f"{p}.attn.linear_pos.weight", (H * D, d), "kernel")
        add(f"{p}.attn.out.weight", (d, H * D), "kernel")
        add(f"{p}.attn.out.bias", (d,), "bias")
        norm(f"{p}.conv.norm")
        add(f"{p}.conv.pw1.weight", (2 * d, d, 1), "kernel")
        add(f"{p}.conv.pw1.bias", (2 * d,), "bias")
        add(f"{p}.conv.dw.weight", (d, 1, K), "kernel")
        add(f"{p}.conv.dw.bias", (d,), "bias")
        norm(f"{p}.conv.norm_mid")
        if batch_norm:
            add(f"{p}.conv.norm_mid.running_mean", (d,), "running_mean")
            add(f"{p}.conv.norm_mid.running_var", (d,), "running_var")
        add(f"{p}.conv.pw2.weight", (d, d, 1), "kernel")
        add(f"{p}.conv.pw2.bias", (d,), "bias")
        norm(f"{p}.norm_out")
    if m.get("decoder_norm", True):
        norm("decoder_norm")
    add("decoder.weight", (V, d), "kernel")
    add("decoder.bias", (V,), "bias")
    if m.get("self_conditioning", True) and m["n_layers"] > 1:
        add("self_condition_reembed.weight", (d, V), "kernel")
    return out


def trainable(name: str) -> bool:
    """Every weight adapts; the batch norms' running statistics do not."""
    return not name.endswith(("running_mean", "running_var"))


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def _linear(x, w, b, quant: Quant):
    return F.linear(_q(quant, x), _q(quant, w), b)


def _layer_norm(x, P, prefix):
    return F.layer_norm(x, x.shape[-1:], P[f"{prefix}.weight"], P[f"{prefix}.bias"], EPS)


def _subsample(x, P, m, quant: Quant):
    """x [B, T, F] → [B, T', F'·C], feature-major."""
    act = {"silu": F.silu, "relu": F.relu}[m.get("subsampling_act", "silu")]
    C = m["subsampling_conv_channels"]
    h = act(F.conv2d(_q(quant, x[:, None]), _q(quant, P["subsampling.conv_in.weight"]),
                     P["subsampling.conv_in.bias"], stride=2, padding=1))
    for i in range(_stages(m["subsampling_factor"]) - 1):
        h = F.conv2d(_q(quant, h), _q(quant, P[f"subsampling.dw_conv.{i}.weight"]),
                     P[f"subsampling.dw_conv.{i}.bias"], stride=2, padding=1, groups=C)
        h = act(F.conv2d(_q(quant, h), _q(quant, P[f"subsampling.pw_conv.{i}.weight"]),
                         P[f"subsampling.pw_conv.{i}.bias"]))
    B, _, T, Fd = h.shape
    h = h.permute(0, 2, 3, 1).reshape(B, T, Fd * C)
    return _linear(h, P["subsampling.out.weight"], P["subsampling.out.bias"], quant)


def _rotary(x, base: float, interpolation: float):
    """x [B, T, H, D]: pairs (i, i + D/2) rotated by position t / interpolation."""
    T, D = x.shape[1], x.shape[-1]
    inv = base ** (-torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] / interpolation * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., : D // 2], x[..., D // 2 :]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _relative_positions(d_model: int, T: int, device):
    """Sinusoidal embeddings [2T - 1, d] of the distances T-1, ..., -(T-1)
    (sin on even features, cos on odd)."""
    dist = torch.arange(T - 1, -T, -1, dtype=torch.float32, device=device)
    freq = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / d_model))
    ang = dist[:, None] * freq[None]
    pe = torch.zeros(2 * T - 1, d_model, device=device)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(ang), torch.cos(ang)
    return pe


def _attention(x, mask, P, p, m, quant: Quant):
    B, T, d = x.shape
    H, D = m["n_heads"], m["head_dim"]
    h = _layer_norm(x, P, f"{p}.attn.norm")
    qkv = _linear(h, P[f"{p}.attn.qkv.weight"], P.get(f"{p}.attn.qkv.bias"), quant)
    q, k, v = qkv.view(B, T, 3, H, D).unbind(2)
    keys_out = ~mask[:, None, None, :]
    encoding = m.get("position_encoding") or ("rotary" if m.get("use_rotary", True) else "none")
    if encoding == "rel_pos":
        pe = _relative_positions(d, T, x.device)
        pos = _linear(pe, P[f"{p}.attn.linear_pos.weight"], None, quant).view(2 * T - 1, H, D)
        content = torch.einsum("bthd,bshd->bhts", _q(quant, q + P[f"{p}.attn.pos_bias_u"]),
                               _q(quant, k))
        by_dist = torch.einsum("bthd,khd->bhtk", _q(quant, q + P[f"{p}.attn.pos_bias_v"]),
                               _q(quant, pos))
        # row i, key j reads the embedding of distance i - j, at index T-1-(i-j)
        i = torch.arange(T, device=x.device)
        idx = (T - 1 - i[:, None] + i[None, :]).expand(B, H, T, T)
        scores = (content + torch.gather(by_dist, 3, idx)) / math.sqrt(D)
    else:
        if encoding == "rotary":
            base, interp = m["rotary_base_freq"], m.get("rotary_interpolation_factor", 1.0)
            q, k = _rotary(q, base, interp), _rotary(k, base, interp)
        scores = torch.einsum("bthd,bshd->bhts", _q(quant, q), _q(quant, k)) / math.sqrt(D)
    probs = torch.softmax(scores.masked_fill(keys_out, float("-inf")), dim=-1)
    out = torch.einsum("bhts,bshd->bthd", _q(quant, probs), _q(quant, v)).reshape(B, T, H * D)
    return _linear(out, P[f"{p}.attn.out.weight"], P[f"{p}.attn.out.bias"], quant)


def _conv_module(x, mask, P, p, m, quant: Quant):
    K = m["conv_kernel_size"]
    h = _layer_norm(x, P, f"{p}.conv.norm")
    h = _linear(h, P[f"{p}.conv.pw1.weight"][:, :, 0], P[f"{p}.conv.pw1.bias"], quant)
    a, g = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(g)) * mask[..., None]
    left = (K - 1) // 2
    h = F.conv1d(F.pad(_q(quant, h.transpose(1, 2)), (left, K - 1 - left)),
                 _q(quant, P[f"{p}.conv.dw.weight"]), P[f"{p}.conv.dw.bias"],
                 groups=h.shape[-1]).transpose(1, 2)
    if f"{p}.conv.norm_mid.running_mean" in P:
        mean, var = P[f"{p}.conv.norm_mid.running_mean"], P[f"{p}.conv.norm_mid.running_var"]
        h = (h - mean) / torch.sqrt(var + EPS) * P[f"{p}.conv.norm_mid.weight"] \
            + P[f"{p}.conv.norm_mid.bias"]
    else:
        h = _layer_norm(h, P, f"{p}.conv.norm_mid")
    return _linear(F.silu(h), P[f"{p}.conv.pw2.weight"][:, :, 0], P[f"{p}.conv.pw2.bias"], quant)


def _ff(x, P, p, quant: Quant):
    h = _layer_norm(x, P, f"{p}.norm")
    h = F.silu(_linear(h, P[f"{p}.in_proj.weight"], P.get(f"{p}.in_proj.bias"), quant))
    return _linear(h, P[f"{p}.out_proj.weight"], P.get(f"{p}.out_proj.bias"), quant)


def _head(h, P, quant: Quant):
    if "decoder_norm.weight" in P:
        h = _layer_norm(h, P, "decoder_norm")
    return torch.log_softmax(_linear(h, P["decoder.weight"], P["decoder.bias"], quant), dim=-1)


def subsampled_length(n: int, factor: int) -> int:
    return -(-int(n) // factor)


def forward(P: Dict[str, torch.Tensor], m: Dict, x: torch.Tensor, lengths: List[int],
            quant: Quant = None) -> torch.Tensor:
    """Log-probs [B, T', vocab + 1] of x [B, F, T] with valid lengths
    ``lengths``; frames past ``ceil(length / factor)`` are zero."""
    B, _, T = x.shape
    f = m["subsampling_factor"]
    lens = torch.as_tensor(lengths, device=x.device)
    x = x.transpose(1, 2) * (torch.arange(T, device=x.device)[None] < lens[:, None])[..., None]
    h = _subsample(x, P, m, quant)
    if m.get("subsampling_norm_out", False):
        h = _layer_norm(h, P, "subsampling.norm_out")
    if m.get("input_xscale", False):
        h = h * math.sqrt(m["d_model"])
    Td = h.shape[1]
    mask = torch.arange(Td, device=x.device)[None] < (lens[:, None] + f - 1) // f
    h = h * mask[..., None]
    n = m["n_layers"]
    sc = m.get("self_conditioning", True) and n > 1
    for layer in range(n):
        p = f"layers.{layer}"
        h = h + 0.5 * _ff(h, P, f"{p}.ff1", quant)
        h = h + _attention(h, mask, P, p, m, quant)
        h = h + _conv_module(h, mask, P, p, m, quant)
        h = h + 0.5 * _ff(h, P, f"{p}.ff2", quant)
        h = _layer_norm(h, P, f"{p}.norm_out")
        if sc and layer < n - 1:
            lp = _head(h, P, quant)
            h = (h + _linear(torch.exp(lp), P["self_condition_reembed.weight"], None, quant)) \
                * mask[..., None]
    return _head(h, P, quant) * mask[..., None]


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude onto e4m3's 448), back in float32: the precision control."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return ((x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale).detach() \
        + (x - x.detach())
