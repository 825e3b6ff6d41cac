"""NeMo conformer checkpoints and presets.

Counterpart of the JAX package's ``models/nemo_convert.py``; the port keeps
its own copy of the mapping table:

- :data:`NEMO_PRESETS` / :func:`load_default_instance` — the NeMo
  conformer-CTC configurations (``position_encoding="rel_pos"``,
  ``input_xscale``, biases, ``batch_norm`` mid-norms);
- :func:`convert_nemo_state_dict` — a NeMo ``ConformerEncoder``
  (dw_striding) + ``ConvASRDecoder`` state dict → the port's state dict
  (lcasr names), weights, biases and the batch norms' running statistics;
- :func:`load_from_old_state_dict` — a torch pickle path or a state dict,
  with or without DDP prefixes → ``(model, state)``.

NeMo's names (1.x)::

    encoder.pre_encode.conv.{0,2,3,5,6}.{weight,bias}   subsampling
    encoder.pre_encode.out.{weight,bias}                flatten projection
    encoder.layers.N.norm_{feed_forward1,self_att,conv,feed_forward2,out}
    encoder.layers.N.feed_forward{1,2}.linear{1,2}.*    macaron FFs
    encoder.layers.N.self_attn.linear_{q,k,v,out,pos}.*, pos_bias_{u,v}
    encoder.layers.N.conv.{pointwise_conv1,depthwise_conv,batch_norm,
                           pointwise_conv2}.*
    decoder.decoder_layers.0.{weight,bias}              1×1 conv CTC head

The port's modules keep torch's layouts, so most tensors copy as they are:
q, k and v concatenate into ``qkv``; the subsampling's ``out`` takes its
input feature-major (f·C + c) where NeMo flattens channel-major (c·F + f);
the head's 1×1 conv drops its tap.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.models.conformer import ConformerConfig, SCConformer

NEMO_PRESETS: Dict[str, ConformerConfig] = {
    # nvidia/stt_en_fastconformer_ctc_large (×8, rel-pos, dw_striding)
    "stt_en_fastconformer_ctc_large": ConformerConfig(
        feat_in=80,
        n_layers=17,
        d_model=512,
        n_heads=8,
        head_dim=64,
        vocab_size=1024,
        subsampling_factor=8,
        subsampling_conv_channels=256,
        subsampling_act="relu",
        conv_kernel_size=9,
        position_encoding="rel_pos",
        input_xscale=True,
        bias_in_attn=True,
        bias_in_ff=True,
        self_conditioning=False,
        decoder_norm=False,
        default_norm="batch_norm",
        use_rotary=False,
    ),
}


def load_default_instance(name: str = "stt_en_fastconformer_ctc_large") -> ConformerConfig:
    """A preset by name (the reference's ``load_defaul_instance``)."""
    return NEMO_PRESETS[name]


def _tensor(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def convert_nemo_state_dict(state_dict: Mapping[str, Any],
                            config: ConformerConfig) -> Dict[str, torch.Tensor]:
    """A NeMo state dict (tensors or numpy arrays, ``module.`` prefixes
    allowed) → the port's state dict for ``SCConformer(config)``: f32
    tensors on the CPU, running statistics included.  A missing depthwise
    or pointwise-conv bias becomes zeros; any other missing key raises."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): _tensor(v)
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    d, C = config.d_model, config.subsampling_conv_channels

    def copy(dst, src):
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = sd[f"{src}.bias"]

    # subsampling: conv 0 (full), then per stage a depthwise (2, 5) and a
    # pointwise (3, 6) conv
    copy("subsampling.conv_in", "encoder.pre_encode.conv.0")
    n_stages = {2: 1, 4: 2, 8: 3}[config.subsampling_factor]
    for i in range(n_stages - 1):
        copy(f"subsampling.dw_conv.{i}", f"encoder.pre_encode.conv.{2 + 3 * i}")
        copy(f"subsampling.pw_conv.{i}", f"encoder.pre_encode.conv.{3 + 3 * i}")
    w = sd["encoder.pre_encode.out.weight"]  # [d, C·F_ds], channel-major
    out["subsampling.out.weight"] = w.reshape(d, C, -1).transpose(1, 2).reshape(d, -1)
    out["subsampling.out.bias"] = sd["encoder.pre_encode.out.bias"]

    H, D = config.n_heads, config.head_dim
    for n in range(config.n_layers):
        e, p = f"encoder.layers.{n}", f"layers.{n}"
        for f in (1, 2):
            copy(f"{p}.ff{f}.norm", f"{e}.norm_feed_forward{f}")
            copy(f"{p}.ff{f}.in_proj", f"{e}.feed_forward{f}.linear1")
            copy(f"{p}.ff{f}.out_proj", f"{e}.feed_forward{f}.linear2")
        a = f"{e}.self_attn"
        copy(f"{p}.attn.norm", f"{e}.norm_self_att")
        qkv = [f"{a}.linear_{x}" for x in "qkv"]
        out[f"{p}.attn.qkv.weight"] = torch.cat([sd[f"{x}.weight"] for x in qkv])
        if f"{qkv[0]}.bias" in sd:
            out[f"{p}.attn.qkv.bias"] = torch.cat([sd[f"{x}.bias"] for x in qkv])
        copy(f"{p}.attn.out", f"{a}.linear_out")
        out[f"{p}.attn.linear_pos.weight"] = sd[f"{a}.linear_pos.weight"]
        out[f"{p}.attn.pos_bias_u"] = sd[f"{a}.pos_bias_u"].reshape(H, D)
        out[f"{p}.attn.pos_bias_v"] = sd[f"{a}.pos_bias_v"].reshape(H, D)
        c = f"{e}.conv"
        copy(f"{p}.conv.norm", f"{e}.norm_conv")
        for dst, src in (("pw1", "pointwise_conv1"), ("dw", "depthwise_conv"),
                         ("pw2", "pointwise_conv2")):
            out[f"{p}.conv.{dst}.weight"] = sd[f"{c}.{src}.weight"]
            out[f"{p}.conv.{dst}.bias"] = sd.get(
                f"{c}.{src}.bias", torch.zeros(sd[f"{c}.{src}.weight"].shape[0]))
        copy(f"{p}.conv.norm_mid", f"{c}.batch_norm")
        for stat in ("running_mean", "running_var"):
            out[f"{p}.conv.norm_mid.{stat}"] = sd[f"{c}.batch_norm.{stat}"]
        copy(f"{p}.norm_out", f"{e}.norm_out")

    out["decoder.weight"] = sd["decoder.decoder_layers.0.weight"][:, :, 0]
    out["decoder.bias"] = sd["decoder.decoder_layers.0.bias"]
    return out


def load_from_old_state_dict(
    path_or_sd,
    config: Optional[ConformerConfig] = None,
    instance: Optional[ConformerConfig] = None,
) -> Tuple[SCConformer, Dict[str, torch.Tensor]]:
    """A torch pickle path (``{'model': ...}``, ``{'state_dict': ...}`` or a
    bare state dict; it unpickles, so load only files you trust) or a state
    dict, with or without DDP prefixes → ``(model, state)``: an
    ``SCConformer`` on the CPU holding the converted weights (loaded
    strictly) and its state dict.  ``config`` (or ``instance``) defaults to
    the large FastConformer preset."""
    config = config or instance or load_default_instance()
    if isinstance(path_or_sd, str):
        ckpt = torch.load(path_or_sd, map_location="cpu", weights_only=False)
        sd = (ckpt.get("model", ckpt.get("state_dict", ckpt)) if isinstance(ckpt, dict)
              else ckpt)
    else:
        sd = path_or_sd
    state = convert_nemo_state_dict(sd, config)
    model = SCConformer(config)
    model.load_state_dict(state, strict=True)
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}
