from dynamic_asr_eval_tpu_torch.models.conformer import (
    ConformerConfig,
    SCConformer,
    init_conformer,
)
from dynamic_asr_eval_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
    variables_to_jax,
)

__all__ = ["ConformerConfig", "SCConformer", "init_conformer", "params_from_jax", "params_to_jax",
           "variables_to_jax"]
