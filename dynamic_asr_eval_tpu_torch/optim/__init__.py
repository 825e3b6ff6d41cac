from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD
from dynamic_asr_eval_tpu_torch.optim.masks import param_labels

__all__ = ["MADGRAD", "param_labels"]
