from dynamic_asr_eval_tpu_torch.models.conformer import (
    ConformerConfig,
    SCConformer,
    init_conformer,
)
from dynamic_asr_eval_tpu_torch.models.convert import (
    encdec_params_from_jax,
    encdec_params_to_jax,
    params_from_jax,
    params_to_jax,
    variables_to_jax,
)
from dynamic_asr_eval_tpu_torch.models.encdec import (
    EncDecConfig,
    EncDecConformer,
    generate_encdec,
    init_encdec,
)

__all__ = ["ConformerConfig", "SCConformer", "init_conformer", "params_from_jax", "params_to_jax",
           "variables_to_jax", "EncDecConfig", "EncDecConformer", "generate_encdec",
           "init_encdec", "encdec_params_from_jax", "encdec_params_to_jax"]
