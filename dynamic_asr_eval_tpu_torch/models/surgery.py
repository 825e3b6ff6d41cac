"""Model surgery: the nvidia_ctc backend's preparation steps.

Counterpart of the JAX package's ``models/surgery.py``:

- :func:`batchnorm_to_batchrenorm` — a BatchNorm's affine parameters and
  running statistics in the JAX package's :class:`..conformer.BatchRenorm`
  collections (``params`` and ``batch_stats``);
- :func:`convert_torch_batchnorm_state` — one torch BatchNorm's tensors by
  state-dict prefix;
- :func:`nvidia_freeze_labels` — the reference's freeze set (subsampling,
  positional encodings and the CTC head stay frozen during TTA), as
  ``"train"`` / ``"freeze"`` labels over the port's parameter names, stated
  on their flax paths as :func:`..optim.masks.param_labels` states its
  policies.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch

from dynamic_asr_eval_tpu_torch.models.convert import jax_path


def batchnorm_to_batchrenorm(bn_params: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """``{'scale', 'bias', 'mean', 'var'}`` (a BatchNorm) → ``{'params':
    {'scale', 'bias'}, 'batch_stats': {'mean', 'var'}}`` (the statistics in
    f32)."""
    return {
        "params": {"scale": torch.as_tensor(bn_params["scale"]),
                   "bias": torch.as_tensor(bn_params["bias"])},
        "batch_stats": {"mean": torch.as_tensor(bn_params["mean"], dtype=torch.float32),
                        "var": torch.as_tensor(bn_params["var"], dtype=torch.float32)},
    }


def convert_torch_batchnorm_state(prefix: str,
                                  state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One torch BatchNorm1d's tensors by state-dict prefix, under the names
    :func:`batchnorm_to_batchrenorm` takes."""
    return {
        "scale": state_dict[f"{prefix}.weight"],
        "bias": state_dict[f"{prefix}.bias"],
        "mean": state_dict[f"{prefix}.running_mean"],
        "var": state_dict[f"{prefix}.running_var"],
    }


def nvidia_freeze_labels(names: Iterable[str]) -> Dict[str, str]:
    """Parameter name → ``"freeze"`` for the subsampling (pre-encode),
    positional encodings and the CTC head, ``"train"`` for the rest."""

    def label(s: str) -> str:
        s = s.lower()
        if "subsampling" in s or "pos_enc" in s or "pre_encode" in s:
            return "freeze"
        if s.startswith("decoder") or "/decoder" in s:
            return "freeze"
        return "train"

    return {n: label(jax_path(n)) for n in names}
