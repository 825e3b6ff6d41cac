"""wav2vec2-CTC (waveform domain) as a PyTorch module.

Counterpart of the JAX package's ``models/wav2vec2.py``, with HuggingFace's
parameter names, so that a ``Wav2Vec2ForCTC`` state dict loads through
:func:`load_hf_weights`:

- feature encoder: 7 temporal convolutions without bias (512 channels; k10/s5,
  k3/s2 ×4, k2/s2 ×2), a per-channel group norm after the first
  (:class:`MaskedGroupNorm`: padding frames excluded from its statistics,
  where HF's ``GroupNorm`` includes them), erf-exact GELU after each;
- feature projection: LayerNorm → linear to ``hidden``; padding frames
  zeroed after it;
- encoder: the grouped positional convolution (kernel ``pos_conv_kernel``,
  padded ``(k//2, (k-1)//2)``), ``h + gelu(pos)``; ``stable_layer_norm=False``
  (wav2vec2-base) puts the encoder LayerNorm before post-norm blocks,
  ``True`` (the lv60 family) pre-norm blocks and the LayerNorm after them;
  attention is plain PyTorch (keys beyond the length masked to -1e30), as
  JAX's is plain XLA;
- ``lm_head`` logits in f32 and their log-softmax; the blank is 0.

``normalize_input`` applies the HF processor's zero-mean/unit-variance
normalization over the valid samples (population variance, eps 1e-7) inside
the forward.  LayerNorm eps is ``layer_norm_eps`` (1e-5).  The call surface
is the conformer's: ``audio_signal [B, 1, T]`` or ``[B, T]`` and ``length
[B]`` → ``{'final_posteriors', 'length', 'a_hidden'}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dynamic_asr_eval_tpu_torch.models.conformer import to_torch_dtype


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    vocab_size: int = 32
    blank_id: int = 0  # HF wav2vec2 CTC convention: <pad> == blank == 0
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ff_dim: int = 3072
    conv_dim: int = 512
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    stable_layer_norm: bool = False  # HF do_stable_layer_norm: False for -base
    layer_norm_eps: float = 1e-5
    normalize_input: bool = False  # the HF processor's normalization, in the forward
    compute_dtype: Any = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "compute_dtype", to_torch_dtype(self.compute_dtype))

    @property
    def n_classes(self) -> int:
        return self.vocab_size

    @property
    def downsampling_factor(self) -> int:
        return math.prod(self.conv_strides)  # 320


def feat_extract_output_lengths(cfg: Wav2Vec2Config, input_length):
    """Frames out of the feature encoder for ``input_length`` samples (an
    int or an integer tensor)."""
    L = input_length
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        L = (L - k) // s + 1
    return L


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm(dtype=x.dtype)``: statistics in f32, output in x's
    dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MaskedGroupNorm(nn.Module):
    """Per-channel group norm over time with the padding frames (``mask``
    False) left out of the statistics; computed in f32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:  # [B, C, T], [B, T]
        m = mask[:, None, :].float()
        cnt = torch.clamp(m.sum(dim=2, keepdim=True), min=1.0)
        xf = x.float()
        mean = (xf * m).sum(dim=2, keepdim=True) / cnt
        var = ((xf - mean) ** 2 * m).sum(dim=2, keepdim=True) / cnt
        out = (xf - mean) / torch.sqrt(var + self.eps) * self.weight[:, None] + self.bias[:, None]
        return out.to(x.dtype)


class ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=False)
        if group_norm:
            self.layer_norm = MaskedGroupNorm(c_out)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.conv_layers = nn.ModuleList(
            ConvLayer(1 if i == 0 else cfg.conv_dim, cfg.conv_dim, k, s, group_norm=i == 0)
            for i, (k, s) in enumerate(zip(cfg.conv_kernels, cfg.conv_strides)))

    def forward(self, x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """[B, T] samples, [B] lengths → [B, T', conv_dim]."""
        cd = self.cfg.compute_dtype
        h = x[:, None, :]
        L = length
        for layer in self.conv_layers:
            (k,), (s,) = layer.conv.kernel_size, layer.conv.stride
            h = F.conv1d(h.to(cd), layer.conv.weight.to(cd), stride=s)
            L = (L - k) // s + 1
            if hasattr(layer, "layer_norm"):
                mask = torch.arange(h.shape[2], device=h.device)[None, :] < L[:, None]
                h = layer.layer_norm(h, mask)
            h = F.gelu(h)  # erf-exact, as HF's nn.GELU
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim, cfg.hidden)


class Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.q_proj = nn.Linear(cfg.hidden, cfg.hidden)
        self.k_proj = nn.Linear(cfg.hidden, cfg.hidden)
        self.v_proj = nn.Linear(cfg.hidden, cfg.hidden)
        self.out_proj = nn.Linear(cfg.hidden, cfg.hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        H = self.n_heads
        D = C // H
        q, k, v = (_linear(x, p, x.dtype).view(B, T, H, D)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(D)
        logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, C)
        return _linear(out, self.out_proj, x.dtype)


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden, cfg.ff_dim)
        self.output_dense = nn.Linear(cfg.ff_dim, cfg.hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.intermediate_dense, x.dtype)), self.output_dense,
                       x.dtype)


class EncoderBlock(nn.Module):
    """Post-norm (``layer_norm`` after the attention residual,
    ``final_layer_norm`` after the feed-forward one) unless
    ``stable_layer_norm``, which makes both pre-norms."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.stable = cfg.stable_layer_norm
        self.attention = Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.stable:
            x = x + self.attention(_ln(x, self.layer_norm), mask)
            return x + self.feed_forward(_ln(x, self.final_layer_norm))
        x = _ln(x + self.attention(x, mask), self.layer_norm)
        return _ln(x + self.feed_forward(x), self.final_layer_norm)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv = nn.Conv1d(cfg.hidden, cfg.hidden, cfg.pos_conv_kernel,
                              groups=cfg.pos_conv_groups)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderBlock(cfg) for _ in range(cfg.n_layers))


class Wav2Vec2Model(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)


class Wav2Vec2ForCTC(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.wav2vec2 = Wav2Vec2Model(config)
        self.lm_head = nn.Linear(config.hidden, config.vocab_size)

    def forward(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
                **_) -> Dict[str, torch.Tensor]:
        cfg = self.config
        cd = cfg.compute_dtype
        w2v = self.wav2vec2
        x = audio_signal
        if x.dim() == 3:  # [B, 1, T], the engines' layout
            x = x[:, 0, :]
        x = x.float()
        B, T = x.shape
        if length is None:
            length = torch.full((B,), T, dtype=torch.int64, device=x.device)
        length = length.to(device=x.device, dtype=torch.int64)
        smask = torch.arange(T, device=x.device)[None, :] < length[:, None]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x = torch.where(smask, x, zero)
        if cfg.normalize_input:
            cnt = torch.clamp(length.float(), min=1.0)[:, None]
            mean = x.sum(dim=1, keepdim=True) / cnt
            var = ((x - mean) ** 2 * smask).sum(dim=1, keepdim=True) / cnt
            x = torch.where(smask, (x - mean) / torch.sqrt(var + 1e-7), zero)

        feats = w2v.feature_extractor(x, length)
        Tf = feats.shape[1]
        out_len = feat_extract_output_lengths(cfg, length)
        fmask = torch.arange(Tf, device=x.device)[None, :] < out_len[:, None]

        proj = w2v.feature_projection
        h = _linear(_ln(feats, proj.layer_norm), proj.projection, cd)
        h = torch.where(fmask[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))

        enc = w2v.encoder
        k = cfg.pos_conv_kernel
        conv = enc.pos_conv_embed.conv
        pos = F.conv1d(F.pad(h.transpose(1, 2), (k // 2, (k - 1) // 2)).to(cd),
                       conv.weight.to(cd), conv.bias.to(cd), groups=cfg.pos_conv_groups)
        h = h + F.gelu(pos.transpose(1, 2))
        if not cfg.stable_layer_norm:  # base: the encoder norm before the blocks
            h = _ln(h, enc.layer_norm)
        for block in enc.layers:
            h = block(h, fmask)
        if cfg.stable_layer_norm:  # lv60: after them
            h = _ln(h, enc.layer_norm)

        logits = _linear(h.float(), self.lm_head, torch.float32)
        return {"final_posteriors": torch.log_softmax(logits, dim=-1), "length": out_len,
                "a_hidden": h}


@torch.no_grad()
def init_wav2vec2(config: Wav2Vec2Config, seed: int = 0,
                  device: Optional[torch.device] = None) -> Wav2Vec2ForCTC:
    """Random weights from ``seed`` (drawn on the CPU): lecun-normal kernels
    (std 1/√fan_in), zero biases, unit norm scales."""
    model = Wav2Vec2ForCTC(config)
    g = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(owner, (nn.LayerNorm, MaskedGroupNorm)):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))
    return model.to(device) if device is not None else model


# ---------------------------------------------------------------------------
# weights: HuggingFace state dicts and the JAX package's parameter tree
# ---------------------------------------------------------------------------

_POS_CONV = "wav2vec2.encoder.pos_conv_embed.conv"


def _weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g · v / ‖v‖`` with the norm over dims (0, 1) (HF's ``dim=2``),
    in f64."""
    norm = torch.sqrt((v.double() ** 2).sum(dim=(0, 1), keepdim=True))
    return (g.double() * v.double() / norm).to(v.dtype)


def load_hf_weights(state_dict: Mapping[str, Any], config: Wav2Vec2Config) -> Dict[str, torch.Tensor]:
    """A HF ``Wav2Vec2ForCTC`` state dict (tensors or numpy values, with or
    without a DDP ``module.`` prefix) → this model's state dict.  The
    weight-normed positional convolution is materialised from any of the
    three layouts: ``parametrizations.weight.original0/1`` (torch >= 2.1),
    ``weight_g`` / ``weight_v``, or a plain ``weight``.  Keys this model has
    no use for (``masked_spec_embed``) are left out."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(np.asarray(v))
          if not torch.is_tensor(v) else v.detach().cpu()
          for k, v in state_dict.items()}
    if f"{_POS_CONV}.parametrizations.weight.original0" in sd:
        pos_w = _weight_norm(sd[f"{_POS_CONV}.parametrizations.weight.original0"],
                             sd[f"{_POS_CONV}.parametrizations.weight.original1"])
    elif f"{_POS_CONV}.weight_g" in sd:
        pos_w = _weight_norm(sd[f"{_POS_CONV}.weight_g"], sd[f"{_POS_CONV}.weight_v"])
    else:
        pos_w = sd[f"{_POS_CONV}.weight"]
    sd[f"{_POS_CONV}.weight"] = pos_w
    keys = Wav2Vec2ForCTC(config).state_dict().keys()
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"HF state dict lacks {missing[:5]}{'...' if len(missing) > 5 else ''}")
    return {k: sd[k].float() for k in keys}
