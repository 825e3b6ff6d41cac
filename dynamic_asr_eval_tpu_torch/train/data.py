"""Training data pipeline, numpy and the standard library only.

Counterpart of the JAX package's ``train/data.py``, with its order and
padding (the same ``random.Random`` seeds):

- :class:`SimpleDataset`: records sorted by duration, shuffled within
  fixed-size subgroups per epoch (``random.Random(seed + epoch)``), records
  whose id is in ``seen_ids`` skipped (mid-epoch resume);
- :class:`VariableBatchLoader`: padded ``[B, F, T]`` f32 batches, lengths and
  texts; ``set_batch_size`` may change the batch between batches.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


class SimpleDataset:
    def __init__(
        self,
        records: Sequence[Dict],
        duration_fn: Optional[Callable[[Dict], float]] = None,
        subgroup_size: int = 8,
        seen_ids: Optional[set] = None,
        seed: int = 0,
    ):
        self.records = list(records)
        self.subgroup_size = subgroup_size
        self.seen_ids = set(seen_ids or ())
        self.seed = seed
        if duration_fn is None:
            duration_fn = lambda r: r.get("duration", 0.0)  # noqa: E731
        self._order = sorted(range(len(self.records)),
                             key=lambda i: duration_fn(self.records[i]))

    def epoch_order(self, epoch: int) -> List[int]:
        """Duration-sorted order, shuffled within subgroups; seen records
        left out."""
        rng = random.Random(self.seed + epoch)
        order = []
        for g in range(0, len(self._order), self.subgroup_size):
            group = self._order[g : g + self.subgroup_size]
            rng.shuffle(group)
            order.extend(group)
        return [i for i in order if self.records[i].get("id") not in self.seen_ids]

    def mark_seen(self, rec: Dict):
        if "id" in rec:
            self.seen_ids.add(rec["id"])

    def reset_seen_ids(self):
        self.seen_ids.clear()

    def __len__(self):
        return len(self.records)


class VariableBatchLoader:
    """One epoch of padded batches; ``set_batch_size`` may be called between
    batches (the sequence warm-up)."""

    def __init__(self, dataset: SimpleDataset, batch_size: int,
                 process_fn: Callable[[Dict], np.ndarray], epoch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.process_fn = process_fn
        self.epoch = epoch

    def set_batch_size(self, b: int):
        self.batch_size = max(int(b), 1)

    def __iter__(self) -> Iterator[Dict]:
        order = self.dataset.epoch_order(self.epoch)
        i = 0
        while i < len(order):
            idxs = order[i : i + self.batch_size]
            i += len(idxs)
            recs = [self.dataset.records[j] for j in idxs]
            specs = [np.asarray(self.process_fn(r)) for r in recs]
            specs = [s[0] if s.ndim == 3 else s for s in specs]
            F = specs[0].shape[0]
            T = max(s.shape[1] for s in specs)
            batch = np.zeros((len(specs), F, T), np.float32)
            lengths = np.zeros((len(specs),), np.int32)
            for k, s in enumerate(specs):
                batch[k, :, : s.shape[1]] = s
                lengths[k] = s.shape[1]
            yield {"spectrograms": batch, "lengths": lengths,
                   "texts": [r.get("text", "") for r in recs], "records": recs}
            for r in recs:
                self.dataset.mark_seen(r)
