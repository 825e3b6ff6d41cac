"""Weights between the JAX package's flax ``params`` tree and the port.

The port's ``SCConformer`` carries the lcasr torch parameter names, the names
the JAX package's ``models/convert.py`` (``DEFAULT_RULES``) maps to its flax
paths.  This module keeps its own copy of that table, in both directions:

- :func:`params_from_jax` — flax ``params`` (nested dict of numpy arrays),
  or a variables dict with ``params`` and ``batch_stats`` → the port's
  ``state_dict``, running statistics included; raises on any key it cannot
  place.
- :func:`variables_to_jax` — the inverse: the port's ``state_dict`` → the
  flax variables, ``{"params": ...}`` and, for batch-renorm mid-norms,
  ``"batch_stats"`` (their running statistics), numpy arrays in the JAX
  package's layouts; :func:`params_to_jax` is its ``params``.
- :func:`jax_path` — the flax path of an lcasr name (used by the freeze
  policies, which the JAX package states on flax paths);
- :func:`lm_params_from_jax` / :func:`lm_params_to_jax` — the same two
  directions for the transformer LM (lming torch names, the JAX package's
  ``lm/loader.py`` ``_LM_TORCH_RULES``);
- :func:`encdec_params_from_jax` / :func:`encdec_params_to_jax` — the same
  for the encoder-decoder: the encoder (``encoder.*``, flax ``encoder/``)
  through the conformer's tables, the decoder (``embed``, ``pos_enc``,
  ``dec_layers.N.*``, ``ln_f``, ``head``; flax ``language_model_decoder/``)
  through the JAX package's ``ENCDEC_DECODER_RULES``.

Layouts: flax Dense kernels are [in, out] (torch Linear [out, in]); flax
conv kernels are [kh, kw, in/groups, out] (torch [out, in/groups, kh, kw]);
the conv-module 1-D convs are [k, in/groups, out] (torch [out, in/groups,
k]); the conv-module pointwise convs are flax Dense kernels (torch [out, in,
1]).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

_FROM_FLAX: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "dense": lambda w: w.T,
    "conv2d": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "conv1d": lambda w: np.transpose(w, (2, 1, 0)),
    "conv1d_pw": lambda w: w.T[:, :, None],
    "identity": lambda w: w,
}

_TO_FLAX: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "dense": lambda w: w.T,
    "conv2d": lambda w: np.transpose(w, (2, 3, 1, 0)),
    "conv1d": lambda w: np.transpose(w, (2, 1, 0)),
    "conv1d_pw": lambda w: w[:, :, 0].T,
    "identity": lambda w: w,
}

# (lcasr name, flax path, layout); {n} is a layer or stage index, {m} a
# submodule with a pre-norm
_TABLE: List[Tuple[str, str, str]] = [
    ("subsampling.conv_in.weight", "subsampling/conv_in_kernel", "conv2d"),
    ("subsampling.conv_in.bias", "subsampling/conv_in_bias", "identity"),
    ("subsampling.dw_conv.{n}.weight", "subsampling/dw_conv_{n}_kernel", "conv2d"),
    ("subsampling.dw_conv.{n}.bias", "subsampling/dw_conv_{n}_bias", "identity"),
    ("subsampling.pw_conv.{n}.weight", "subsampling/pw_conv_{n}/kernel", "conv2d"),
    ("subsampling.pw_conv.{n}.bias", "subsampling/pw_conv_{n}/bias", "identity"),
    ("subsampling.out.weight", "subsampling/out/kernel", "dense"),
    ("subsampling.out.bias", "subsampling/out/bias", "identity"),
    ("subsampling.norm_out.weight", "subsampling/norm_out/scale", "identity"),
    ("subsampling.norm_out.bias", "subsampling/norm_out/bias", "identity"),
    ("layers.{n}.{f}.in_proj.weight", "layer_{n}/{f}/in/kernel", "dense"),
    ("layers.{n}.{f}.in_proj.bias", "layer_{n}/{f}/in/bias", "identity"),
    ("layers.{n}.{f}.out_proj.weight", "layer_{n}/{f}/out/kernel", "dense"),
    ("layers.{n}.{f}.out_proj.bias", "layer_{n}/{f}/out/bias", "identity"),
    ("layers.{n}.attn.qkv.weight", "layer_{n}/attn/qkv/kernel", "dense"),
    ("layers.{n}.attn.qkv.bias", "layer_{n}/attn/qkv/bias", "identity"),
    ("layers.{n}.attn.pos_bias_u", "layer_{n}/attn/pos_bias_u", "identity"),
    ("layers.{n}.attn.pos_bias_v", "layer_{n}/attn/pos_bias_v", "identity"),
    ("layers.{n}.attn.linear_pos.weight", "layer_{n}/attn/linear_pos/kernel", "dense"),
    ("layers.{n}.attn.out.weight", "layer_{n}/attn/out/kernel", "dense"),
    ("layers.{n}.attn.out.bias", "layer_{n}/attn/out/bias", "identity"),
    ("layers.{n}.conv.pw1.weight", "layer_{n}/conv/pw1/kernel", "conv1d_pw"),
    ("layers.{n}.conv.pw1.bias", "layer_{n}/conv/pw1/bias", "identity"),
    ("layers.{n}.conv.dw.weight", "layer_{n}/conv/dw_kernel", "conv1d"),
    ("layers.{n}.conv.dw.bias", "layer_{n}/conv/dw_bias", "identity"),
    ("layers.{n}.conv.pw2.weight", "layer_{n}/conv/pw2/kernel", "conv1d_pw"),
    ("layers.{n}.conv.pw2.bias", "layer_{n}/conv/pw2/bias", "identity"),
    ("layers.{n}.{m}.norm.weight", "layer_{n}/{m}/LayerNorm_0/scale", "identity"),
    ("layers.{n}.{m}.norm.bias", "layer_{n}/{m}/LayerNorm_0/bias", "identity"),
    ("layers.{n}.conv.norm_mid.weight", "layer_{n}/conv/norm/LayerNorm_0/scale", "identity"),
    ("layers.{n}.conv.norm_mid.bias", "layer_{n}/conv/norm/LayerNorm_0/bias", "identity"),
    ("layers.{n}.norm_out.weight", "layer_{n}/norm_out/scale", "identity"),
    ("layers.{n}.norm_out.bias", "layer_{n}/norm_out/bias", "identity"),
    ("decoder_norm.weight", "decoder_norm/scale", "identity"),
    ("decoder_norm.bias", "decoder_norm/bias", "identity"),
    ("decoder.weight", "decoder/kernel", "dense"),
    ("decoder.bias", "decoder/bias", "identity"),
    ("self_condition_reembed.weight", "self_condition_reembed/kernel", "dense"),
]

# batch-renorm mid-norms (``default_norm`` "batch_renorm" / "batch_norm"):
# the affine parameters under ``BatchRenorm_0`` in ``params``, the running
# statistics in the ``batch_stats`` collection (the JAX package's
# ``BATCH_RENORM_RULES``)
_BATCH_RENORM_TABLE: List[Tuple[str, str, str]] = [
    ("layers.{n}.conv.norm_mid.weight", "layer_{n}/conv/norm/BatchRenorm_0/scale", "identity"),
    ("layers.{n}.conv.norm_mid.bias", "layer_{n}/conv/norm/BatchRenorm_0/bias", "identity"),
]
_STATS_TABLE: List[Tuple[str, str, str]] = [
    ("layers.{n}.conv.norm_mid.running_mean", "layer_{n}/conv/norm/BatchRenorm_0/mean",
     "identity"),
    ("layers.{n}.conv.norm_mid.running_var", "layer_{n}/conv/norm/BatchRenorm_0/var",
     "identity"),
]

# the transformer LM (lm/transformer_lm.py): the lming torch names that the
# JAX package's ``_LM_TORCH_RULES`` (lm/loader.py) map
_LM_TABLE: List[Tuple[str, str, str]] = [
    ("embed.weight", "embed/embedding", "identity"),
    ("layers.{n}.ln1.weight", "layer_{n}/ln1/scale", "identity"),
    ("layers.{n}.ln1.bias", "layer_{n}/ln1/bias", "identity"),
    ("layers.{n}.ln2.weight", "layer_{n}/ln2/scale", "identity"),
    ("layers.{n}.ln2.bias", "layer_{n}/ln2/bias", "identity"),
    ("layers.{n}.qkv.weight", "layer_{n}/qkv/kernel", "dense"),
    ("layers.{n}.out.weight", "layer_{n}/out/kernel", "dense"),
    ("layers.{n}.ff_in.weight", "layer_{n}/ff_in/kernel", "dense"),
    ("layers.{n}.ff_in.bias", "layer_{n}/ff_in/bias", "identity"),
    ("layers.{n}.ff_out.weight", "layer_{n}/ff_out/kernel", "dense"),
    ("layers.{n}.ff_out.bias", "layer_{n}/ff_out/bias", "identity"),
    ("ln_f.weight", "ln_f/scale", "identity"),
    ("ln_f.bias", "ln_f/bias", "identity"),
    ("head.weight", "head/kernel", "dense"),
    ("head.bias", "head/bias", "identity"),
]

# the enc-dec's decoder (models/encdec.py): the names the JAX package's
# ``ENCDEC_DECODER_RULES`` (models/convert.py) map, under ``language_model_decoder``
_DEC = "language_model_decoder"
_ENCDEC_DECODER_TABLE: List[Tuple[str, str, str]] = [
    ("embed.weight", f"{_DEC}/embed/embedding", "identity"),
    ("pos_enc.weight", f"{_DEC}/pos_enc/embedding", "identity"),
    ("dec_layers.{n}.{l}.weight", _DEC + "/layer_{n}/{l}/scale", "identity"),
    ("dec_layers.{n}.{l}.bias", _DEC + "/layer_{n}/{l}/bias", "identity"),
    ("dec_layers.{n}.{w}.weight", _DEC + "/layer_{n}/{w}/kernel", "dense"),
    ("dec_layers.{n}.{b}.bias", _DEC + "/layer_{n}/{b}/bias", "identity"),
    ("ln_f.weight", f"{_DEC}/ln_f/scale", "identity"),
    ("ln_f.bias", f"{_DEC}/ln_f/bias", "identity"),
    ("head.weight", f"{_DEC}/head/kernel", "dense"),
    ("head.bias", f"{_DEC}/head/bias", "identity"),
]

_GROUPS = {"n": r"(?P<n>\d+)", "m": r"(?P<m>ff1|ff2|attn|conv)", "f": r"(?P<f>ff1|ff2)",
           "l": r"(?P<l>ln_self|ln_cross|ln_ff)",
           "w": r"(?P<w>self_qkv|self_out|cross_q|cross_kv|cross_out|ff_in|ff_out)",
           "b": r"(?P<b>ff_in|ff_out)"}


def _regex(template: str) -> "re.Pattern":
    out = re.escape(template)
    for k, g in _GROUPS.items():
        out = out.replace(re.escape("{" + k + "}"), g)
    return re.compile(out)


def _compile(table):
    return [(_regex(t), _regex(j), t, j, kind) for t, j, kind in table]


_COMPILED = _compile(_TABLE)
_BATCH_RENORM_COMPILED = _compile(_BATCH_RENORM_TABLE) + _COMPILED
_STATS_COMPILED = _compile(_STATS_TABLE)
_LM_COMPILED = _compile(_LM_TABLE)
_ENCDEC_DECODER_COMPILED = _compile(_ENCDEC_DECODER_TABLE)


def jax_path(name: str) -> str:
    """Flax path ("layer_0/attn/qkv/kernel") of an lcasr name."""
    for t_re, _, _, j, _ in _COMPILED:
        m = t_re.fullmatch(name)
        if m:
            return j.format(**m.groupdict())
    raise KeyError(f"no flax path for parameter {name!r}")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _from_jax(params_np: Mapping, compiled, what="params") -> Dict[str, torch.Tensor]:
    state, unmatched = {}, []
    for path, value in _flatten(params_np).items():
        for _, j_re, t, _, kind in compiled:
            m = j_re.fullmatch(path)
            if m:
                arr = _FROM_FLAX[kind](np.asarray(value, np.float32))
                state[t.format(**m.groupdict())] = torch.tensor(arr)
                break
        else:
            unmatched.append(path)
    if unmatched:
        raise KeyError(f"flax {what} with no port counterpart: {unmatched}")
    return state


def _to_jax(state: Mapping[str, torch.Tensor], compiled) -> Dict:
    tree: Dict = {}
    unmatched = []
    for name, value in state.items():
        for t_re, _, _, j, kind in compiled:
            m = t_re.fullmatch(name)
            if m:
                arr = value.detach().to("cpu", torch.float32).numpy()
                *parents, leaf = j.format(**m.groupdict()).split("/")
                node = tree
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = np.ascontiguousarray(_TO_FLAX[kind](arr))
                break
        else:
            unmatched.append(name)
    if unmatched:
        raise KeyError(f"port parameters with no flax counterpart: {unmatched}")
    return tree


def params_from_jax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``params`` tree (numpy leaves), or a variables
    dict ``{'params': ..., 'batch_stats': ...}`` (``batch_stats`` optional)
    → the port's ``state_dict`` (f32 tensors on the CPU), the running
    statistics of batch-renorm mid-norms included.  Raises on any flax path
    the tables do not place."""
    if set(params_np) <= {"params", "batch_stats"} and "params" in params_np:
        state = _from_jax(params_np["params"], _BATCH_RENORM_COMPILED)
        if "batch_stats" in params_np:
            state.update(_from_jax(params_np["batch_stats"], _STATS_COMPILED, "batch_stats"))
        return state
    return _from_jax(params_np, _BATCH_RENORM_COMPILED)


def variables_to_jax(state: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``state_dict`` → the JAX package's flax variables:
    ``{"params": ...}``, plus ``"batch_stats"`` when the state carries
    running statistics (batch-renorm mid-norms, whose affine parameters
    then go under ``BatchRenorm_0``); nested dicts of C-contiguous f32 numpy
    arrays.  Raises on any name the tables do not place."""
    stat_names = {n for n in state if any(t_re.fullmatch(n) for t_re, *_ in _STATS_COMPILED)}
    if not stat_names:
        return {"params": _to_jax(state, _COMPILED)}
    params = {n: v for n, v in state.items() if n not in stat_names}
    return {"params": _to_jax(params, _BATCH_RENORM_COMPILED),
            "batch_stats": _to_jax({n: state[n] for n in stat_names}, _STATS_COMPILED)}


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict:
    """The ``params`` collection of :func:`variables_to_jax`."""
    return variables_to_jax(state)["params"]


def lm_params_from_jax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """:func:`params_from_jax` for the transformer LM (the JAX package's
    ``convert_lm_torch_state`` inverted: kernels transposed, the rest as
    they are)."""
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    return _from_jax(params_np, _LM_COMPILED)


def lm_params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict:
    """:func:`params_to_jax` for the transformer LM."""
    return _to_jax(state, _LM_COMPILED)


def encdec_params_from_jax(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's enc-dec variables (``{'params': {'encoder': ...,
    'language_model_decoder': ...}}``, optionally ``'batch_stats':
    {'encoder': ...}``; numpy leaves), or their ``params`` → the port's
    :class:`..models.encdec.EncDecConformer` state dict.  Raises on any flax
    path the tables do not place."""
    if "params" in variables_np:
        params, stats = variables_np["params"], variables_np.get("batch_stats", {})
    else:
        params, stats = variables_np, {}
    enc = {"params": params["encoder"]}
    if stats:
        enc["batch_stats"] = stats["encoder"]
    state = {f"encoder.{k}": v for k, v in params_from_jax(enc).items()}
    dec = {k: v for k, v in params.items() if k != "encoder"}
    state.update(_from_jax(dec, _ENCDEC_DECODER_COMPILED))
    return state


def encdec_params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict:
    """The port's enc-dec state dict → the JAX package's variables
    (``{'params': ...}`` and, for batch-renorm mid-norms, ``'batch_stats'``
    under ``encoder``), what JAX's ``convert_encdec_checkpoint`` gives for the
    same state dict."""
    enc = variables_to_jax({k[len("encoder."):]: v for k, v in state.items()
                            if k.startswith("encoder.")})
    dec = _to_jax({k: v for k, v in state.items() if not k.startswith("encoder.")},
                  _ENCDEC_DECODER_COMPILED)
    out = {"params": {"encoder": enc["params"], **dec}}
    if "batch_stats" in enc:
        out["batch_stats"] = {"encoder": enc["batch_stats"]}
    return out
