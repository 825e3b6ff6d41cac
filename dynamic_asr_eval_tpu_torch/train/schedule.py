"""Training schedules, plain Python.

Counterpart of the JAX package's ``train/schedule.py``:

- :class:`CosineSchedule`: linear warm-up to ``peak_lr``, then a cosine
  decay to ``peak_lr * final_lr_ratio`` over ``total_steps``, read once per
  optimizer step;
- :class:`SequenceWarmupManager`: a sequence-length curriculum: every
  ``increase_every_steps`` steps the window grows by ``growth_factor`` (up to
  ``max_seq_len``) and the batch shrinks by the same ratio.  Its rotary
  interpolation factor is reported, not applied to the model (as in JAX).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


class CosineSchedule:
    def __init__(self, peak_lr: float, warmup_steps: int, total_steps: int,
                 final_lr_ratio: float = 0.0):
        self.peak_lr = peak_lr
        self.warmup_steps = max(warmup_steps, 1)
        self.total_steps = max(total_steps, 1)
        self.final_lr_ratio = final_lr_ratio

    def __call__(self, step: int) -> float:
        if step < self.warmup_steps:
            return self.peak_lr * (step + 1) / self.warmup_steps
        t = min(step - self.warmup_steps, self.total_steps) / self.total_steps
        cos = 0.5 * (1 + math.cos(math.pi * t))
        floor = self.peak_lr * self.final_lr_ratio
        return floor + (self.peak_lr - floor) * cos

    def state_dict(self):
        return {"peak_lr": self.peak_lr, "warmup_steps": self.warmup_steps,
                "total_steps": self.total_steps, "final_lr_ratio": self.final_lr_ratio}

    @classmethod
    def from_state_dict(cls, d):
        return cls(**d)


@dataclasses.dataclass
class SequenceWarmupManager:
    """Grow the sequence length (and shrink the batch) on a step schedule."""

    initial_seq_len: int = 2048
    max_seq_len: int = 16384
    increase_every_steps: int = 500
    growth_factor: float = 2.0
    initial_batch_size: int = 8
    min_batch_size: int = 1
    rotary_base_seq_len: int = 2048  # interpolation reference length

    steps_taken: int = 0
    current_seq_len: int = 0
    current_batch_size: int = 0

    def __post_init__(self):
        if self.current_seq_len == 0:
            self.current_seq_len = self.initial_seq_len
        if self.current_batch_size == 0:
            self.current_batch_size = self.initial_batch_size

    def step(self, n: int = 1) -> Tuple[bool, int, int]:
        """Advance; returns ``(changed, seq_len, batch_size)``."""
        self.steps_taken += n
        target_growths = self.steps_taken // self.increase_every_steps
        new_len = min(int(self.initial_seq_len * (self.growth_factor ** target_growths)),
                      self.max_seq_len)
        changed = new_len != self.current_seq_len
        if changed:
            ratio = new_len / self.current_seq_len
            self.current_seq_len = new_len
            self.current_batch_size = max(int(self.current_batch_size / ratio),
                                          self.min_batch_size)
        return changed, self.current_seq_len, self.current_batch_size

    @property
    def rotary_interpolation_factor(self) -> float:
        return max(self.current_seq_len / self.rotary_base_seq_len, 1.0)

    def state_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d):
        return cls(**d)
