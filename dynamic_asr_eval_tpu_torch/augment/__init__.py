from dynamic_asr_eval_tpu_torch.augment.spec_augment import (
    add_random_noise,
    apply_augmentation_pipeline,
    cutout,
    frame_shuffle,
    replace_with_frame,
    spec_augment,
)

__all__ = [
    "add_random_noise",
    "apply_augmentation_pipeline",
    "cutout",
    "frame_shuffle",
    "replace_with_frame",
    "spec_augment",
]
