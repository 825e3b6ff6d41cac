"""Decoder-only transformer language model with a fixed-size ring-buffer KV
cache.

Counterpart of the JAX package's ``lm/transformer_lm.py``, the fusion LM of
the reference's beam search (the lming transformer): one token per row and
step, next-token log-probs out.  The parameters carry the lming torch names
(``embed``, ``layers.{i}.{ln1,ln2,qkv,out,ff_in,ff_out}``, ``ln_f``,
``head``), so a reference ``.pt`` loads with ``load_state_dict``.

Numerics as in JAX:

- LayerNorm eps 1e-6 (flax's default), statistics in f32;
- GELU is the tanh approximation (``jax.nn.gelu``);
- rotary embeddings rotate the first and second halves of each head (not
  interleaved pairs), with f32 angles from absolute positions;
- dense layers run in ``compute_dtype`` (parameters f32), the cache is in
  ``compute_dtype``, attention logits and softmax in f32, ``ln_f`` and the
  log-softmax in f32.

The cache is ``{'k', 'v': [L, B, H, N, D], 'lengths': [B]}``: the token at
absolute position ``p`` goes to slot ``p % N``; a row whose ``write_mask``
is false keeps its cache and its length, but its log-probs are computed all
the same.  The JAX module returns new cache arrays (XLA writes them in place
where the input is dead); here the ring write goes into the given cache's
``k`` and ``v`` in place, so a caller hands over a cache it no longer needs
(the beams pass the output of their ``gather``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax nn.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    vocab_size: int = 4096
    n_layers: int = 6
    d_model: int = 512
    n_heads: int = 8
    max_cache_length: int = 128
    rotary_base: float = 10_000.0
    expansion_factor: int = 4
    compute_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope(pos: torch.Tensor, head_dim: int, base: float):
    """pos [...] → cos, sin [..., head_dim / 2] (f32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=pos.device) / head_dim
    inv = 1.0 / (torch.tensor(base, dtype=torch.float32, device=pos.device) ** exps)
    ang = pos[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        LN_EPS).to(dtype)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LMBlock(nn.Module):
    def __init__(self, config: TransformerLMConfig):
        super().__init__()
        self.config = config
        d, hd = config.d_model, config.n_heads * config.head_dim
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS)
        self.qkv = nn.Linear(d, 3 * hd, bias=False)
        self.out = nn.Linear(hd, d, bias=False)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS)
        self.ff_in = nn.Linear(d, d * config.expansion_factor)
        self.ff_out = nn.Linear(d * config.expansion_factor, d)

    def forward(self, x, k_cache, v_cache, cache_pos, pos, write_mask=None):
        """One token per row.  x [B, d]; k/v_cache [B, H, N, D], written in
        place at slot ``pos % N`` (rows with ``write_mask`` false keep
        theirs); cache_pos [B] valid entries; pos [B] absolute position.
        Returns y [B, d]."""
        cfg = self.config
        cd = cfg.compute_dtype
        H, D, N = cfg.n_heads, cfg.head_dim, cfg.max_cache_length
        B = x.shape[0]
        h = _layer_norm(x, self.ln1, x.dtype)
        q, k, v = _dense(h, self.qkv, cd).reshape(B, 3, H, D).unbind(1)  # [B, H, D]
        cos, sin = _rope(pos, D, cfg.rotary_base)  # [B, D/2]
        q = _rot(q, cos[:, None], sin[:, None])  # f32, as JAX promotes
        k = _rot(k, cos[:, None], sin[:, None])

        # the ring write of the emitting rows: the other rows' slots are
        # written back with what they held, B·H·D values, not a where over
        # the whole cache
        bidx = torch.arange(B, device=x.device)
        slot = pos % N
        for cache, new in ((k_cache, k), (v_cache, v)):
            new = new.to(cache.dtype)
            if write_mask is not None:
                new = torch.where(write_mask[:, None, None], new, cache[bidx, :, slot])
            cache[bidx, :, slot] = new

        # slot s holds the largest absolute position <= pos that is s mod N
        slots = torch.arange(N, device=x.device)[None, :]
        abs_pos = pos[:, None] - torch.remainder(pos[:, None] - slots, N)
        valid = ((abs_pos >= 0) & (abs_pos >= pos[:, None] - (N - 1))
                 & (abs_pos >= pos[:, None] - cache_pos[:, None]))
        logits = torch.einsum("bhd,bhnd->bhn", q, k_cache.float()) / math.sqrt(D)
        logits = logits.masked_fill(~valid[:, None, :], -1e30)
        attn = torch.softmax(logits, dim=-1).to(cd)
        o = torch.einsum("bhn,bhnd->bhd", attn, v_cache.to(cd)).reshape(B, H * D)
        x = x + _dense(o, self.out, cd)
        h2 = _layer_norm(x, self.ln2, x.dtype)
        h2 = F.gelu(_dense(h2, self.ff_in, cd), approximate="tanh")
        return x + _dense(h2, self.ff_out, cd)


class TransformerLM(nn.Module):
    """``forward(tokens [B], cache, write_mask [B] or None) -> (log_probs
    [B, V] f32, cache)``: the returned cache holds the same ``k`` and ``v``
    tensors, written in place, and new ``lengths``."""

    def __init__(self, config: TransformerLMConfig):
        super().__init__()
        self.config = config
        self.embed = nn.Embedding(config.vocab_size, config.d_model)
        self.layers = nn.ModuleList(LMBlock(config) for _ in range(config.n_layers))
        self.ln_f = nn.LayerNorm(config.d_model, eps=LN_EPS)
        self.head = nn.Linear(config.d_model, config.vocab_size)

    def forward(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                write_mask: Optional[torch.Tensor] = None):
        cfg = self.config
        pos = cache["lengths"]  # absolute position of this token
        x = self.embed(tokens.to(torch.int64)).to(cfg.compute_dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, cache["k"][i], cache["v"][i], pos, pos, write_mask)
        x = _layer_norm(x, self.ln_f, torch.float32)
        logits = _dense(x, self.head, cfg.compute_dtype)
        lengths = pos + 1 if write_mask is None else pos + write_mask.to(pos.dtype)
        new_cache = {"k": cache["k"], "v": cache["v"], "lengths": lengths}
        return torch.log_softmax(logits.float(), dim=-1), new_cache


def empty_cache(config: TransformerLMConfig, batch: int,
                device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    L, H, N, D = config.n_layers, config.n_heads, config.max_cache_length, config.head_dim
    return {
        "k": torch.zeros((L, batch, H, N, D), dtype=config.compute_dtype, device=device),
        "v": torch.zeros((L, batch, H, N, D), dtype=config.compute_dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


@torch.no_grad()
def init_lm(config: TransformerLMConfig, seed: int = 0,
            device: Optional[Union[str, torch.device]] = None) -> TransformerLM:
    """Random weights from ``seed`` (drawn on the CPU): flax's initializers'
    scales, lecun-normal kernels (std 1/√fan_in), embeddings of std
    1/√d_model, zero biases, unit LayerNorm scales."""
    model = TransformerLM(config)
    g = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(owner, nn.LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1]))
    model.eval()
    return model.to(device) if device is not None else model


@torch.no_grad()
def lm_score_sequence(model: TransformerLM, tokens: torch.Tensor,
                      config: Optional[TransformerLMConfig] = None) -> torch.Tensor:
    """Teacher-forced log-prob of each next token: ``tokens`` [T] with the
    BOS first → [T - 1]."""
    config = config or model.config
    tokens = tokens.to(model_device(model))
    cache = empty_cache(config, 1, tokens.device)
    lps = []
    for tok in tokens[:-1]:
        lp, cache = model(tok[None], cache)
        lps.append(lp[0])
    return torch.gather(torch.stack(lps), 1, tokens[1:, None].to(torch.int64))[:, 0]


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


__all__ = ["LMBlock", "TransformerLM", "TransformerLMConfig", "empty_cache", "init_lm",
           "lm_score_sequence"]
