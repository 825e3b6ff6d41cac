from dynamic_asr_eval_tpu_torch.audio.features import (
    FeaturizerConfig,
    log_mel,
    log_mel_spectrogram,
    make_featurizer,
    zero_out_spectrogram,
)
from dynamic_asr_eval_tpu_torch.audio.io import audio_duration_seconds, load_audio, resample

__all__ = ["FeaturizerConfig", "log_mel", "log_mel_spectrogram", "make_featurizer",
           "zero_out_spectrogram",
           "load_audio", "resample", "audio_duration_seconds"]
