from dynamic_asr_eval_tpu_torch.augment.spec_augment import (
    add_random_noise,
    apply_augmentation_pipeline,
    cutout,
    frame_shuffle,
    spec_augment,
)

__all__ = [
    "add_random_noise",
    "apply_augmentation_pipeline",
    "cutout",
    "frame_shuffle",
    "spec_augment",
]
