"""PyTorch/CUDA port of ``dynamic_asr_eval_tpu`` for the NVIDIA H100.

Same layout and module names as the JAX package; imports neither JAX nor the
JAX package.  Entry points run on ``cuda`` unless asked for ``cpu``.
"""
