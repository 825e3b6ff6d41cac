from dynamic_asr_eval_tpu_torch.ops.chunk import (
    chunk_spectrogram,
    chunk_starts_and_lengths,
    num_chunks,
    pad_num_chunks,
)
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss, greedy_decode, greedy_labels
from dynamic_asr_eval_tpu_torch.ops.stitch import stitch_chunk_probs, trim_stitched

__all__ = [
    "chunk_spectrogram",
    "chunk_starts_and_lengths",
    "num_chunks",
    "pad_num_chunks",
    "ctc_loss",
    "greedy_decode",
    "greedy_labels",
    "stitch_chunk_probs",
    "trim_stitched",
]
