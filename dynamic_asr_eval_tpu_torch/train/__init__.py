from dynamic_asr_eval_tpu_torch.train.data import SimpleDataset, VariableBatchLoader
from dynamic_asr_eval_tpu_torch.train.nst import EvalRunner, NSTTrainer, TrainConfig
from dynamic_asr_eval_tpu_torch.train.schedule import CosineSchedule, SequenceWarmupManager

__all__ = [
    "CosineSchedule",
    "SequenceWarmupManager",
    "SimpleDataset",
    "VariableBatchLoader",
    "EvalRunner",
    "NSTTrainer",
    "TrainConfig",
]
