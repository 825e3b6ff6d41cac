from dynamic_asr_eval_tpu_torch.optim.adafactor import Adafactor
from dynamic_asr_eval_tpu_torch.optim.ema import EmaState, ema_init, ema_params, ema_update
from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD, RecordsMADGRAD
from dynamic_asr_eval_tpu_torch.optim.masks import param_labels

__all__ = ["Adafactor", "EmaState", "MADGRAD", "ema_init", "ema_params", "ema_update",
           "param_labels", "RecordsMADGRAD"]
