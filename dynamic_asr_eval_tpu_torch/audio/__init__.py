from dynamic_asr_eval_tpu_torch.audio.features import (
    FeaturizerConfig,
    log_mel,
    log_mel_spectrogram,
)

__all__ = ["FeaturizerConfig", "log_mel", "log_mel_spectrogram"]
