"""Parameter-selection policies: which parameters a TTA run adapts.

Counterpart of the JAX package's ``optim/masks.py``.  The policies are stated
on the flax path of each parameter (:func:`..models.convert.jax_path`), so the
port selects exactly the set the JAX package selects:

- ``bitfit`` — parameters whose flax leaf is literally named ``bias`` (so the
  fused-name conv biases ``conv_in_bias``, ``dw_conv_N_bias`` and
  ``dw_bias`` stay frozen, as in the JAX package);
- ``subsampling_only`` — the subsampling module only;
- ``last_block_and_head`` — the last conformer block and the CTC head;
- ``freeze_subsampling`` — everything but the subsampling module.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from dynamic_asr_eval_tpu_torch.models.convert import jax_path


def param_labels(
    names: Iterable[str],
    bitfit: bool = False,
    freeze_subsampling: bool = False,
    last_block_and_head: bool = False,
    subsampling_only: bool = False,
    n_layers: Optional[int] = None,
) -> Dict[str, str]:
    """lcasr parameter name → ``"train"`` or ``"freeze"``."""

    def label(s: str) -> str:
        s = s.lower()
        leaf = s.rsplit("/", 1)[-1]
        if bitfit:
            return "train" if leaf == "bias" else "freeze"
        if subsampling_only:
            return "train" if "subsampling" in s else "freeze"
        if last_block_and_head:
            if n_layers is None:
                raise ValueError("last_block_and_head requires n_layers")
            if f"layer_{n_layers - 1}/" in s or s.startswith("decoder") or "/decoder" in s:
                return "train"
            return "freeze"
        if freeze_subsampling and "subsampling" in s:
            return "freeze"
        return "train"

    return {n: label(jax_path(n)) for n in names}
