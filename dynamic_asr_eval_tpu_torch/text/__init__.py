from dynamic_asr_eval_tpu_torch.text.normalizer import EnglishTextNormalizer, normalize
from dynamic_asr_eval_tpu_torch.text.tokenizer import (
    CharTokenizer,
    VocabTokenizer,
    load_tokenizer,
)
from dynamic_asr_eval_tpu_torch.text.wer import cer, word_error_rate_detail

__all__ = [
    "EnglishTextNormalizer",
    "normalize",
    "CharTokenizer",
    "VocabTokenizer",
    "load_tokenizer",
    "word_error_rate_detail",
    "cer",
]
