from dynamic_asr_eval_tpu_torch.data.adapters import datasets_functions, get_dataset

__all__ = ["datasets_functions", "get_dataset"]
