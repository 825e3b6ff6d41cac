from dynamic_asr_eval_tpu_torch.parallel.mesh import (
    axis_rank,
    axis_size,
    batch_sharding,
    init_process_group,
    make_mesh,
    psum_wer_counts,
    reduce_wer_counts,
    replicate,
)

__all__ = [
    "axis_rank",
    "axis_size",
    "batch_sharding",
    "init_process_group",
    "make_mesh",
    "psum_wer_counts",
    "reduce_wer_counts",
    "replicate",
]
