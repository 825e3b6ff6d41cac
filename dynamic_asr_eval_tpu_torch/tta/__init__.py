from dynamic_asr_eval_tpu_torch.tta.awmc import AWMCEngine
from dynamic_asr_eval_tpu_torch.tta.consistency import ConsistencyEngine
from dynamic_asr_eval_tpu_torch.tta.runner import DynamicEvalEngine, EngineOutput, chunked_inference
from dynamic_asr_eval_tpu_torch.tta.utterance import UtteranceTTAEngine

__all__ = ["AWMCEngine", "ConsistencyEngine", "DynamicEvalEngine", "EngineOutput",
           "UtteranceTTAEngine", "chunked_inference"]
