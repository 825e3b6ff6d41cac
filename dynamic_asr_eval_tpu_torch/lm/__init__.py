from dynamic_asr_eval_tpu_torch.lm.ngram import NGramLM, load_arpa
from dynamic_asr_eval_tpu_torch.lm.transformer_lm import TransformerLM, TransformerLMConfig, init_lm

__all__ = ["TransformerLM", "TransformerLMConfig", "init_lm", "NGramLM", "load_arpa"]
