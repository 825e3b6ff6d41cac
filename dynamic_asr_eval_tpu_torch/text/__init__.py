from dynamic_asr_eval_tpu_torch.text.normalizer import EnglishTextNormalizer, normalize
from dynamic_asr_eval_tpu_torch.text.tokenizer import (
    CharTokenizer,
    SentencePieceTokenizer,
    VocabTokenizer,
    load_tokenizer,
    parse_sentencepiece_model,
)
from dynamic_asr_eval_tpu_torch.text.wer import cer, wer_counts, word_error_rate_detail

__all__ = [
    "EnglishTextNormalizer",
    "normalize",
    "CharTokenizer",
    "SentencePieceTokenizer",
    "VocabTokenizer",
    "parse_sentencepiece_model",
    "load_tokenizer",
    "word_error_rate_detail",
    "wer_counts",
    "cer",
]
