from dynamic_asr_eval_tpu_torch.lm.ngram import NGramLM, load_arpa

__all__ = ["NGramLM", "load_arpa"]
