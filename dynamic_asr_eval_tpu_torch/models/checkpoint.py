"""Checkpoints: the JAX package's own DAE1 files and reference torch pickles.

Counterpart of the JAX package's ``models/checkpoint.py``:

- :func:`save_checkpoint` / :func:`load_checkpoint` — the DAE1 container:
  magic ``b"DAE1"``, a ``<I`` header length, a JSON header ``{"config",
  "extra"}`` (``compute_dtype`` as a dtype name), then the variables tree
  ``{"params": ...}`` (and ``"batch_stats"``, the running statistics of
  batch-renorm mid-norms) in flax's MessagePack layout, written and read by
  :mod:`.msgpack_codec` (no flax, no msgpack).  The weights cross between
  the port's names and the flax paths through :mod:`.convert`, so a file
  either package writes loads in the other.  The header carries the whole
  ``ConformerConfig``, the kernel selections (``attention_impl``,
  ``subsampling_impl``) included.
- :func:`load_reference_torch_checkpoint` — a reference ``.pt`` pickle
  (``{'model': state_dict, 'config': ...}`` or a bare state dict): DDP
  prefixes stripped, the config recovered (OmegaConf-pickled configs through
  a permissive stub), structural dims inferred from the weights (weights win),
  then a strict=False overlay onto a fresh :func:`init_conformer`: init values
  kept for missing keys, extras dropped, any shape mismatch raises.  The
  port's model carries the lcasr names, so this is a ``load_state_dict``,
  with no conversion (mid-norms with running statistics load into a
  batch-renorm model; their ``num_batches_tracked`` is dropped, as JAX's
  rules drop it).  A reference file's config names no kernel, so it runs
  the defaults (``"xla"`` attention, ``"conv"`` subsampling), as in JAX.
- :func:`load_any_checkpoint` — sniffs the format.
- :func:`load_encdec_torch_checkpoint` — a reference encoder-decoder
  pickle (``encoder.*`` in the lcasr names, the decoder as ``embed``,
  ``pos_enc``, ``dec_layers.N.*``, ``ln_f``, ``head``): the encoder's
  configuration as for a conformer pickle, the decoder's dims from
  :func:`infer_encdec_decoder_dims` (the head split from the config, else
  head_dim 64 where it divides, with a warning), then a strict=False overlay
  onto a fresh :func:`..models.encdec.init_encdec`, as above.

Each loader returns ``(model, params, config)``: an ``SCConformer`` (or an
``EncDecConformer``) on the CPU, its state dict (running statistics
included), and its ``ConformerConfig`` (or ``EncDecConfig``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
import sys
from typing import Any, Dict, Mapping, Tuple, Union

import torch

from dynamic_asr_eval_tpu_torch.models import msgpack_codec
from dynamic_asr_eval_tpu_torch.models.conformer import (
    ConformerConfig,
    SCConformer,
    init_conformer,
)
from dynamic_asr_eval_tpu_torch.models.convert import params_from_jax, variables_to_jax

_MAGIC = b"DAE1"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sorted_tree(tree):
    """flax writes a variables tree with sorted keys; so do we, which makes
    the payload byte-identical to the JAX package's for the same weights."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_checkpoint(path: str, params: Union[Mapping[str, torch.Tensor], torch.nn.Module],
                    config: ConformerConfig, extra: Dict | None = None) -> None:
    """Write a DAE1 file of ``params`` (the port's state dict, or a model)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    cfg_d = dataclasses.asdict(config)
    cfg_d["compute_dtype"] = _dtype_name(config.compute_dtype)
    header = json.dumps({"config": cfg_d, "extra": extra or {}}).encode("utf-8")
    payload = msgpack_codec.packb(_sorted_tree(variables_to_jax(params)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(payload)


def _loaded(model: SCConformer):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def load_checkpoint(path: str):
    """A DAE1 file → ``(model, params, config)``."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a DAE checkpoint (bad magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        payload = f.read()
    cfg_d = dict(header["config"])
    cfg_d["compute_dtype"] = cfg_d.get("compute_dtype", "bfloat16")
    config = ConformerConfig.from_dict(cfg_d)
    model = SCConformer(config)  # raises on options not ported
    variables = msgpack_codec.unpackb(payload)
    if "params" not in variables or not set(variables) <= {"params", "batch_stats"}:
        raise ValueError(f"{path}: variables {sorted(variables)}, expected 'params' "
                         "(and 'batch_stats')")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model, _loaded(model), config


def convert_from_ddp(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Strip DistributedDataParallel ``module.`` prefixes."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Any]:
    """A torch checkpoint on the CPU → (state dict of tensors, raw config).
    Reference checkpoints pickle their config, so this unpickles (which can
    run code): load only checkpoints you trust."""
    _install_omegaconf_stub()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    state = {k: v.detach().cpu() for k, v in convert_from_ddp(state).items()
             if torch.is_tensor(v)}
    config = ckpt.get("config", {}) if isinstance(ckpt, dict) else {}
    return state, config


def _install_omegaconf_stub() -> None:
    """Reference checkpoints may pickle their ``config`` as OmegaConf
    containers; without omegaconf installed, permissive stub modules let
    ``torch.load`` unpickle them, and :func:`_plain_config` unwraps the
    captured pickle state.  A real omegaconf (or a stub already in place)
    wins."""
    import types

    try:
        import omegaconf  # noqa: F401
        return
    except ImportError:
        pass
    if "omegaconf" in sys.modules:
        return

    class _OCStub:
        def __init__(self, *args, **kwargs):
            pass

        def __setstate__(self, state):
            self.__dict__["_oc_state"] = state

    class _OCModule(types.ModuleType):
        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)
            cls = type(name, (_OCStub,), {"__module__": self.__name__})
            setattr(self, name, cls)
            return cls

    root = _OCModule("omegaconf")
    sys.modules["omegaconf"] = root
    for sub in ("omegaconf", "dictconfig", "listconfig", "base", "nodes",
                "errors", "basecontainer"):
        mod = _OCModule(f"omegaconf.{sub}")
        sys.modules[f"omegaconf.{sub}"] = mod
        setattr(root, sub, mod)


def _plain_config(obj: Any) -> Any:
    """A pickled config (plain containers, real OmegaConf nodes, or
    stub-unpickled OmegaConf state) → plain dicts, lists and scalars."""
    try:
        from omegaconf import OmegaConf

        if OmegaConf.is_config(obj):
            return _plain_config(OmegaConf.to_container(obj, resolve=False))
    except (ImportError, AttributeError):  # no omegaconf, or only the stub
        pass
    st = getattr(obj, "_oc_state", None)
    if isinstance(st, dict):
        # containers pickle {_content, _metadata, ...}; value nodes {_val, ...}
        if "_content" in st:
            return _plain_config(st["_content"])
        if "_val" in st:
            return _plain_config(st["_val"])
        return None
    if isinstance(obj, dict):
        return {str(k): _plain_config(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain_config(v) for v in obj]
    return obj


def infer_conformer_dims(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The structural ``ConformerConfig`` fields an lcasr state dict implies.
    The head split cannot come from the weights: ``_attn_total`` carries
    n_heads·head_dim for :func:`_merge_reference_config`."""
    dims: Dict[str, Any] = {}
    layer_ids = {int(m.group(1)) for k in state for m in [re.match(r"layers\.(\d+)\.", k)] if m}
    if layer_ids:
        dims["n_layers"] = max(layer_ids) + 1
    w = state.get("decoder.weight")
    if w is not None:
        dims["vocab_size"] = int(w.shape[0]) - 1
        dims["d_model"] = int(w.shape[1])
    cin = state.get("subsampling.conv_in.weight")
    if cin is not None:
        dims["subsampling_conv_channels"] = int(cin.shape[0])
        n_dw = len({k for k in state if re.fullmatch(r"subsampling\.dw_conv\.\d+\.weight", k)})
        dims["subsampling_factor"] = 2 ** (1 + n_dw)
        # the out dense consumes f_ds·C; the weights pin f_ds, not feat_in
        out_w = state.get("subsampling.out.weight")
        if out_w is not None:
            dims["_f_ds"] = int(out_w.shape[1]) // dims["subsampling_conv_channels"]
    dw = state.get("layers.0.conv.dw.weight")
    if dw is not None:
        dims["conv_kernel_size"] = int(dw.shape[-1])
    ff = state.get("layers.0.ff1.in_proj.weight")
    if ff is not None and "d_model" in dims:
        dims["expansion_factor"] = int(ff.shape[0]) // dims["d_model"]
    # a one-layer model has no re-embedding either way (nothing feeds a next
    # block), and the flag changes nothing there
    dims["self_conditioning"] = "self_condition_reembed.weight" in state
    dims["decoder_norm"] = "decoder_norm.weight" in state
    if any(k.endswith("conv.norm_mid.running_mean") for k in state):
        dims["default_norm"] = "batch_renorm"
    qkv = state.get("layers.0.attn.qkv.weight")
    if qkv is not None:
        dims["_attn_total"] = int(qkv.shape[0]) // 3
    return dims


def _merge_reference_config(model_cfg: Dict[str, Any], dims: Dict[str, Any]) -> Tuple[Dict, list]:
    """A checkpoint's declared model config merged with the weight-implied
    dims: the weights win for structure, the config supplies what weights
    cannot express (rotary base, head split, norm kind, ...)."""
    warns: list = []
    merged = dict(model_cfg)
    dims = dict(dims)
    attn_total = dims.pop("_attn_total", None)
    batch_from_weights = dims.pop("default_norm", None)
    f_ds = dims.pop("_f_ds", None)
    if f_ds is not None:
        stages = max(int(dims.get("subsampling_factor", 1)).bit_length() - 1, 0)

        def _ceil_ds(f: int) -> int:
            for _ in range(stages):
                f = -(-f // 2)
            return f

        cfg_feat = merged.get("feat_in")
        if not (isinstance(cfg_feat, int) and _ceil_ds(cfg_feat) == f_ds):
            canonical = f_ds * int(dims.get("subsampling_factor", 1))
            if cfg_feat is not None:
                warns.append(
                    f"config says feat_in={cfg_feat} but the subsampling out dense implies "
                    f"{f_ds} downsampled freq bins; using the canonical preimage "
                    f"feat_in={canonical}")
            dims["feat_in"] = canonical
    for k, v in dims.items():
        if k in merged and merged[k] != v:
            warns.append(f"config says {k}={merged[k]} but weights imply {v}; "
                         "using the weight shapes")
        merged[k] = v
    if batch_from_weights and merged.get("default_norm", "layer_norm") == "layer_norm":
        if "default_norm" in merged:
            warns.append("config says default_norm=layer_norm but the conv mid-norms carry "
                         "running statistics; using batch_renorm")
        merged["default_norm"] = batch_from_weights
    total = attn_total or merged.get("d_model")
    if total:
        n_h, h_d = merged.get("n_heads"), merged.get("head_dim")
        if n_h and h_d and n_h * h_d != total:
            warns.append(f"n_heads*head_dim={n_h * h_d} != attention width {total}; "
                         f"head_dim adjusted to {total // n_h}")
            merged["head_dim"] = total // n_h
        elif n_h and not h_d:
            merged["head_dim"] = total // n_h
        elif h_d and not n_h:
            merged["n_heads"] = total // h_d
        elif not n_h and not h_d:
            # published lcasr configs use head_dim 128
            h_d = 128 if total % 128 == 0 and total >= 128 else (
                64 if total % 64 == 0 and total >= 64 else max(total // 4, 1))
            merged["head_dim"], merged["n_heads"] = h_d, total // h_d
            warns.append(f"checkpoint config carries no head split; assuming head_dim={h_d} "
                         "(the published lcasr convention) — pass an explicit config yaml if "
                         "this is wrong")
    return merged, warns


def _overlay_on_init(config, state: Mapping[str, torch.Tensor], init=init_conformer):
    """strict=False load onto a fresh ``init`` (seed 0): checkpoint values
    where the model has the key, init values for missing keys, extras
    dropped; any shape mismatch raises (a silently misloaded tensor cannot be
    caught later)."""
    model = init(config, seed=0)
    template = model.state_dict()
    bad = [f"{k}: checkpoint {tuple(state[k].shape)} vs model {tuple(template[k].shape)}"
           for k in template.keys() & state.keys() if state[k].shape != template[k].shape]
    if bad:
        raise ValueError("checkpoint/model shape mismatches:\n  " + "\n  ".join(sorted(bad)))
    merged = dict(template)
    merged.update({k: state[k] for k in template.keys() & state.keys()})
    model.load_state_dict(merged, strict=True)
    return model, sorted(template.keys() - state.keys()), sorted(state.keys() - template.keys())


def load_reference_torch_checkpoint(path: str, compute_dtype: Any = None, verbose: bool = True):
    """A reference torch checkpoint → ``(model, params, config)``."""
    state, raw_cfg = load_torch_checkpoint(path)
    cfg_plain = _plain_config(raw_cfg)
    model_cfg = dict(cfg_plain.get("model", cfg_plain) or {}) if isinstance(cfg_plain, dict) else {}
    dims = infer_conformer_dims(state)
    if not dims.get("n_layers") or "d_model" not in dims:
        raise ValueError(
            f"{path}: state dict does not look like an lcasr conformer checkpoint "
            f"({len(state)} tensors; expected layers.N.* / decoder.* naming)")
    merged, warns = _merge_reference_config(model_cfg, dims)
    if compute_dtype is not None:
        merged["compute_dtype"] = compute_dtype
    config = ConformerConfig.from_dict(merged)
    if config.default_norm in ("batch_renorm", "batch_norm"):
        state = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    model, missing, extra = _overlay_on_init(config, state)
    if verbose:
        for w in warns:
            print(f"load_reference_torch_checkpoint: WARNING {w}", file=sys.stderr)
        if missing:
            print(f"load_reference_torch_checkpoint: {len(missing)} model params kept their "
                  f"fresh init (strict=False; first: {missing[:4]})", file=sys.stderr)
        if extra:
            print(f"load_reference_torch_checkpoint: {len(extra)} checkpoint tensors unused "
                  f"by the model (first: {extra[:4]})", file=sys.stderr)
    return model, _loaded(model), config


def load_any_checkpoint(path: str, compute_dtype: Any = None):
    """DAE1 or a reference torch pickle → ``(model, params, config)``;
    ``compute_dtype`` applies to a reference pickle (a DAE1 header states
    its own)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _MAGIC:
        return load_checkpoint(path)
    return load_reference_torch_checkpoint(path, compute_dtype=compute_dtype)


def infer_encdec_decoder_dims(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The structural decoder dims an enc-dec state dict implies
    (``decoder_layers``, ``decoder_d_model``, ``max_text_len``);
    ``_self_attn_total`` carries heads·head_dim."""
    dims: Dict[str, Any] = {}
    dec_ids = {int(m.group(1)) for k in state for m in [re.match(r"dec_layers\.(\d+)\.", k)] if m}
    if dec_ids:
        dims["decoder_layers"] = max(dec_ids) + 1
    emb = state.get("embed.weight")
    if emb is not None:
        dims["decoder_d_model"] = int(emb.shape[1])
    pos = state.get("pos_enc.weight")
    if pos is not None:
        dims["max_text_len"] = int(pos.shape[0]) - 1
    qkv = state.get("dec_layers.0.self_qkv.weight")
    if qkv is not None:
        dims["_self_attn_total"] = int(qkv.shape[0]) // 3
    return dims


_DECODER_FIELDS = ("decoder_layers", "decoder_d_model", "decoder_heads", "decoder_ff_mult",
                   "max_text_len", "bos_id", "eos_id", "ctc_loss_weight")


def load_encdec_torch_checkpoint(path: str, compute_dtype: Any = None, verbose: bool = True):
    """A reference enc-dec torch checkpoint → ``(model, params, config)``:
    an ``EncDecConformer``, its state dict and its ``EncDecConfig``."""
    from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig, init_encdec

    state, raw_cfg = load_torch_checkpoint(path)
    cfg_plain = _plain_config(raw_cfg)
    model_cfg = dict(cfg_plain.get("model", cfg_plain) or {}) if isinstance(cfg_plain, dict) else {}
    enc_state = {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}
    dec_state = {k: v for k, v in state.items() if not k.startswith("encoder.")}
    if not enc_state or "embed.weight" not in dec_state:
        raise ValueError(f"{path}: not an enc-dec checkpoint (need encoder.* "
                         "keys and a decoder embed.weight)")

    enc_cfg_d = dict(model_cfg.get("encoder", model_cfg) or {})
    enc_merged, warns = _merge_reference_config(enc_cfg_d, infer_conformer_dims(enc_state))
    if compute_dtype is not None:
        enc_merged["compute_dtype"] = compute_dtype
    enc_config = ConformerConfig.from_dict(enc_merged)

    dec_dims = infer_encdec_decoder_dims(dec_state)
    self_total = dec_dims.pop("_self_attn_total", None)
    dec_merged = {k: v for k, v in model_cfg.items() if k in _DECODER_FIELDS}
    dec_merged.update(dec_dims)
    if "decoder_heads" not in dec_merged and dec_merged.get("decoder_d_model"):
        d = self_total or dec_merged["decoder_d_model"]
        # EncDecConfig convention: head_dim 64 where divisible
        h_d = 64 if d % 64 == 0 and d >= 64 else max(d // 4, 1)
        dec_merged["decoder_heads"] = d // h_d
        warns.append(f"checkpoint config carries no decoder head count; assuming head_dim={h_d}")
    config = EncDecConfig(encoder=enc_config, **dec_merged)
    if enc_config.default_norm in ("batch_renorm", "batch_norm"):
        state = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    model, missing, extra = _overlay_on_init(config, state, init=init_encdec)
    if verbose:
        for w in warns:
            print(f"load_encdec_torch_checkpoint: WARNING {w}", file=sys.stderr)
        if extra:
            print(f"load_encdec_torch_checkpoint: {len(extra)} torch keys unconverted "
                  f"(first: {extra[:4]})", file=sys.stderr)
        if missing:
            print(f"load_encdec_torch_checkpoint: {len(missing)} params kept fresh init "
                  f"(first: {missing[:4]})", file=sys.stderr)
    return model, _loaded(model), config
