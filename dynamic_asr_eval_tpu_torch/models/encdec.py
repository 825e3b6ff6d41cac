"""Encoder-decoder (attention) ASR model with a joint CTC branch.

Counterpart of the JAX package's ``models/encdec.py``:

- ``forward(audio_signal)`` → ``{'a_hidden', 'length',
  'final_posteriors_ctc'}`` (the encoder and its CTC branch);
  ``forward(audio_signal, text_bos, text_lengths=...)`` adds
  ``final_posteriors_lm`` (the decoder's logits over the text positions);
- :meth:`EncDecConformer.decode_step` — one autoregressive step with a
  self-attention KV cache;
- :func:`generate_encdec` — greedy or sampled generation as a fixed-length
  loop of ``max_generate`` steps with per-sample EOS retirement, on the
  device, with no host read inside the loop.

The encoder is the port's :class:`..models.conformer.SCConformer` (its
kernels run wherever its configuration selects them); the decoder is a
pre-norm transformer (causal self-attention, cross-attention on
``a_hidden`` masked by the encoder's lengths, a tanh-GELU feed-forward) in
plain PyTorch, as JAX's is plain XLA.  Numerics follow the JAX code: the
decoder runs in f32 whatever the encoder's ``compute_dtype`` (the embedding
is f32 and each dense layer takes the activations' dtype; ``a_hidden`` is
cast to f32 by ``cross_kv``), LayerNorm eps 1e-5, masked logits −1e30 in f32
scaled by 1/√D, text positions clipped at ``max_text_len``.

Parameter names are those of the reference's enc-dec torch model
(``encoder.*`` in the lcasr conformer names, then ``embed``, ``pos_enc``,
``dec_layers.{i}.{ln_self, self_qkv, self_out, ln_cross, cross_q, cross_kv,
cross_out, ln_ff, ff_in, ff_out}``, ``ln_f``, ``head``), which the JAX
package's ``convert_encdec_checkpoint`` maps: one set of weights drives both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynamic_asr_eval_tpu_torch.models.conformer import (
    ConformerConfig,
    SCConformer,
    _dense,
    _layer_norm,
    init_conformer,
    lengths_to_mask,
)

MASKED = -1e30


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder: ConformerConfig = dataclasses.field(default_factory=ConformerConfig)
    decoder_layers: int = 4
    decoder_d_model: int = 512
    decoder_heads: int = 8
    decoder_ff_mult: int = 4
    max_text_len: int = 256
    bos_id: int = 0
    eos_id: int = 0
    ctc_loss_weight: float = 0.3
    dropout_emb: float = 0.0
    dropout_attn: float = 0.0
    dropout_post_ff: float = 0.0

    @property
    def vocab_size(self) -> int:
        return self.encoder.vocab_size

    @property
    def head_dim(self) -> int:
        return self.decoder_d_model // self.decoder_heads


def _attend(q, k, v, mask):
    """q [B, T, H, D], k / v [B, S, H, D], mask broadcastable to [B, H, T, S]
    → [B, T, H·D]; f32 logits over √D, −1e30 where masked."""
    D = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(D)
    logits = logits.masked_fill(~mask, MASKED)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", attn, v)
    return out.reshape(q.shape[0], q.shape[1], -1)


class DecoderBlock(nn.Module):
    """Causal self-attention (with a KV cache in generation), cross-attention
    on the encoder's output, feed-forward; each pre-norm and residual."""

    def __init__(self, config: EncDecConfig):
        super().__init__()
        d, hd = config.decoder_d_model, config.decoder_heads * config.head_dim
        self.heads, self.head_dim = config.decoder_heads, config.head_dim
        self.ln_self = nn.LayerNorm(d)
        self.self_qkv = nn.Linear(d, 3 * hd, bias=False)
        self.self_out = nn.Linear(hd, d, bias=False)
        self.ln_cross = nn.LayerNorm(d)
        self.cross_q = nn.Linear(d, hd, bias=False)
        # keys and values of the encoder's output, at its width
        self.cross_kv = nn.Linear(config.encoder.d_model, 2 * hd, bias=False)
        self.cross_out = nn.Linear(hd, d, bias=False)
        self.ln_ff = nn.LayerNorm(d)
        self.ff_in = nn.Linear(d, d * config.decoder_ff_mult)
        self.ff_out = nn.Linear(d * config.decoder_ff_mult, d)

    def cross_keys(self, a_hidden: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cross-attention keys and values of ``a_hidden``, [B, Ta, H, D]
        each; they do not depend on the tokens."""
        B, Ta, _ = a_hidden.shape
        kv = _dense(a_hidden, self.cross_kv.weight, None, dtype)
        kv = kv.reshape(B, Ta, 2, self.heads, self.head_dim)
        return kv[:, :, 0], kv[:, :, 1]

    def forward(self, x, a_hidden, a_mask, self_mask, cache=None, position=None, cross=None):
        B, T, _ = x.shape
        H, D = self.heads, self.head_dim
        dt = x.dtype

        h = _layer_norm(x, self.ln_self)
        qkv = _dense(h, self.self_qkv.weight, None, dt).reshape(B, T, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is not None:
            # a generation step: T == 1; the cache [B, N, H, D] is written in
            # place at each sample's slot
            ck, cv = cache["k"], cache["v"]
            N = ck.shape[1]
            slot = torch.clamp(position, 0, N - 1).long()
            bidx = torch.arange(B, device=x.device)
            ck[bidx, slot] = k[:, 0].to(ck.dtype)
            cv[bidx, slot] = v[:, 0].to(cv.dtype)
            valid = torch.arange(N, device=x.device)[None, :] <= position[:, None]
            out = _attend(q, ck, cv.to(dt), valid[:, None, None, :])
        else:
            causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
            mask = causal[None, None] & self_mask[:, None, None, :]
            out = _attend(q, k, v, mask)
        x = x + _dense(out, self.self_out.weight, None, dt)

        h = _layer_norm(x, self.ln_cross)
        qc = _dense(h, self.cross_q.weight, None, dt).reshape(B, T, H, D)
        kc, vc = cross if cross is not None else self.cross_keys(a_hidden, dt)
        out = _attend(qc, kc, vc, a_mask[:, None, None, :])
        x = x + _dense(out, self.cross_out.weight, None, dt)

        h = _layer_norm(x, self.ln_ff)
        h = _dense(h, self.ff_in.weight, self.ff_in.bias, dt)
        h = F.gelu(h, approximate="tanh")
        h = _dense(h, self.ff_out.weight, self.ff_out.bias, dt)
        return x + h


class LanguageModelDecoder(nn.Module):
    """Token and position embeddings, ``decoder_layers`` blocks, ``ln_f`` and
    the ``head``; :meth:`decode` → ``{'logits' [B, T, vocab] f32[, 'cache']}``."""

    def __init__(self, config: EncDecConfig):
        super().__init__()
        d = config.decoder_d_model
        self.config = config
        self.embed = nn.Embedding(config.vocab_size, d)
        self.pos_enc = nn.Embedding(config.max_text_len + 1, d)
        self.dec_layers = nn.ModuleList(DecoderBlock(config) for _ in range(config.decoder_layers))
        self.ln_f = nn.LayerNorm(d)
        self.head = nn.Linear(d, config.vocab_size)

    def decode(self, tokens, a_hidden, a_lengths, text_lengths=None, cache=None,
               position=None, cross=None) -> Dict:
        """``tokens`` [B, T]; with ``cache`` (``{'k', 'v'}`` [L, B, N, H, D])
        and ``position`` [B] one generation step (T == 1).  ``cross``: each
        layer's precomputed :meth:`DecoderBlock.cross_keys`."""
        cfg = self.config
        B, T = tokens.shape
        dev = tokens.device
        a_mask = lengths_to_mask(a_lengths.to(dev), a_hidden.shape[1])
        if text_lengths is None:
            self_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
        else:
            self_mask = lengths_to_mask(text_lengths.to(dev), T)
        x = self.embed.weight[tokens.long()].float()
        pos = torch.arange(T, device=dev)[None] if position is None else position[:, None]
        x = x + self.pos_enc.weight[torch.clamp(pos, 0, cfg.max_text_len).long()].float()
        for i, layer in enumerate(self.dec_layers):
            layer_cache = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
            x = layer(x, a_hidden, a_mask, self_mask, cache=layer_cache, position=position,
                      cross=None if cross is None else cross[i])
        x = _layer_norm(x.float(), self.ln_f)
        out = {"logits": _dense(x, self.head.weight, self.head.bias, torch.float32)}
        if cache is not None:
            out["cache"] = cache  # written in place, layer by layer
        return out

    forward = decode


class EncDecConformer(LanguageModelDecoder):
    """The SCConformer encoder (``encoder.*``) and the attention decoder."""

    def __init__(self, config: EncDecConfig):
        super().__init__(config)
        self.encoder = SCConformer(config.encoder)

    def encode(self, audio_signal, length=None):
        return self.encoder(audio_signal, length)

    def forward(self, audio_signal, text_bos=None, length=None, text_lengths=None) -> Dict:
        enc = self.encode(audio_signal, length)
        out = {"a_hidden": enc["a_hidden"], "length": enc["length"],
               "final_posteriors_ctc": enc["final_posteriors"]}
        if text_bos is not None:
            out["final_posteriors_lm"] = self.decode(
                text_bos, enc["a_hidden"], enc["length"], text_lengths)["logits"]
        return out

    def decode_step(self, tokens, a_hidden, a_lengths, cache, position) -> Dict:
        """One AR step with the KV cache: ``tokens`` [B], ``position`` [B]."""
        return self.decode(tokens[:, None], a_hidden, a_lengths, cache=cache, position=position)


@torch.no_grad()
def generate_encdec(
    model: EncDecConformer,
    audio_signal: torch.Tensor,  # [1, F, T]
    config: EncDecConfig,
    generator: Optional[torch.Generator] = None,
    sample: int = 1,
    greedy: bool = True,
    temperature: float = 1.0,
    max_generate: int = 256,
    length: Optional[torch.Tensor] = None,
    encoder_out: Optional[Dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """AR generation as a fixed-length loop with per-sample EOS retirement:
    (tokens [sample, max_generate], lengths [sample], encoder_out).

    ``greedy and sample == 1`` takes the argmax; otherwise each step samples
    from the categorical of the logits (Gumbel-max, the noise drawn from
    ``generator``).  The logits are multiplied by ``temperature``, as in JAX.
    A step that emits EOS, and the last step, retire a sample; a retired
    sample emits ``eos_id``; tokens past a sample's length are 0.  The
    cross-attention keys and values are computed once a call (JAX recomputes
    them each step from the same inputs)."""
    if encoder_out is None:
        encoder_out = model.encode(audio_signal, length)
    a_hidden = encoder_out["a_hidden"].repeat_interleave(sample, dim=0)
    a_lengths = encoder_out["length"].repeat_interleave(sample, dim=0)
    B, dev = sample, a_hidden.device
    H, D, L, N = config.decoder_heads, config.head_dim, config.decoder_layers, max_generate + 1
    cache = {"k": torch.zeros((L, B, N, H, D), dtype=torch.float32, device=dev),
             "v": torch.zeros((L, B, N, H, D), dtype=torch.float32, device=dev)}
    cross = [layer.cross_keys(a_hidden, torch.float32) for layer in model.dec_layers]
    if generator is None and not (greedy and sample == 1):
        generator = torch.Generator(device=dev).manual_seed(0)

    tokens = torch.full((B,), config.bos_id, dtype=torch.int64, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
    eos = torch.full((), config.eos_id, dtype=torch.int64, device=dev)
    out_tokens = []
    for i in range(max_generate):
        pos = torch.full((B,), i, dtype=torch.int64, device=dev)
        logits = model.decode(tokens[:, None], a_hidden, a_lengths, cache=cache, position=pos,
                              cross=cross)["logits"][:, 0, :] * temperature
        if greedy and sample == 1:
            nxt = torch.argmax(logits, dim=-1)
        else:
            u = torch.rand(logits.shape, generator=generator, device=dev)
            nxt = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        is_eos = (nxt == config.eos_id) | (i >= max_generate - 1)
        newly_finished = is_eos & ~finished
        lengths = lengths + (~finished & ~is_eos).to(torch.int32)
        finished = finished | is_eos
        nxt = torch.where(finished & ~newly_finished, eos, nxt)
        out_tokens.append(nxt)
        tokens = nxt
    toks = torch.stack(out_tokens, dim=1)
    keep = torch.arange(max_generate, device=dev)[None, :] < lengths[:, None]
    return torch.where(keep, toks, torch.zeros_like(toks)), lengths, encoder_out


@torch.no_grad()
def init_encdec(config: EncDecConfig, seed: int = 0,
                device: Optional[torch.device] = None) -> EncDecConformer:
    """Random weights from ``seed``, drawn on the CPU: the encoder as
    :func:`..models.conformer.init_conformer` draws it; the decoder's
    kernels and embeddings normal with std 1/√fan_in (an embedding's fan-in
    is its width), zero biases, unit norm scales."""
    model = EncDecConformer(config)
    model.encoder.load_state_dict(init_conformer(config.encoder, seed=seed).state_dict())
    g = torch.Generator().manual_seed(int(seed) + 1)
    for name, p in model.named_parameters():
        if name.startswith("encoder."):
            continue
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(owner, nn.LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))
    return model.to(device) if device is not None else model
