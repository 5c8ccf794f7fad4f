"""Host-side data loading: a deterministic shuffled batch sampler and a
map-style loader that collates numpy batches.

A copy of ``paddlenlp_tpu/data/dataloader.py`` (pure numpy); the port feeds
one device, so it runs with one data shard.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

__all__ = ["DataLoader", "DistributedBatchSampler"]


class DistributedBatchSampler:
    """Deterministic shuffled batch sampler with ``consumed_samples`` fast-forward
    for resume (reference utils/batch_sampler.py:22,119-145)."""

    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        consumed_samples: int = 0,
        num_shards: int = 1,
        shard_id: int = 0,
        shard_span: int = 1,
    ):
        """``batch_size`` is the GLOBAL batch, split into ``num_shards`` row
        groups (the mesh's data-shard groups, dp x fsdp); this sampler yields the
        contiguous slice covering groups ``[shard_id, shard_id + shard_span)`` —
        the multihost replacement for the reference's broadcast dataloader
        (dist_dataloader.py:41): every process loads exactly the rows its
        addressable devices will hold (identical rows on processes that share a
        data shard, e.g. tp spanning hosts). A final partial batch is padded by
        wrapping to the epoch start (reference DistributedBatchSampler
        complete-the-batch semantics) so every shard stays consistent."""
        if batch_size % max(num_shards, 1) != 0:
            raise ValueError(f"global batch {batch_size} not divisible by {num_shards} data shards")
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.consumed_samples = consumed_samples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shard_span = shard_span
        self.filler_rows: List[int] = []  # local rows that are wrap-pad duplicates

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.dataset_len // self.batch_size
        return (self.dataset_len + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[List[int]]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        # consumed_samples is a ONE-TIME fast-forward for the resumed epoch; later
        # epochs iterate in full.
        start = self.consumed_samples % self.dataset_len if self.consumed_samples else 0
        self.consumed_samples = 0
        order = order[start:]
        n = len(order)
        end = n - n % self.batch_size if self.drop_last else n
        local = self.batch_size // self.num_shards
        for i in range(0, end, self.batch_size):
            batch = order[i : i + self.batch_size]
            self.filler_rows = []
            if len(batch) < self.batch_size and self.num_shards > 1:
                # pad the final partial batch by wrapping so every shard slices
                # a consistent full-size batch (duplicates, not drops); record
                # which LOCAL rows are filler so the loader can mask their labels
                n_real = len(batch)
                pad = np.resize(order, self.batch_size - n_real)
                batch = np.concatenate([batch, pad])
                lo, hi = self.shard_id * local, (self.shard_id + self.shard_span) * local
                self.filler_rows = [j - lo for j in range(max(n_real, lo), hi)]
            if self.num_shards > 1:
                batch = batch[self.shard_id * local : (self.shard_id + self.shard_span) * local]
            yield batch.tolist()


class DataLoader:
    """Minimal map-style loader: sampler + collate into numpy batches."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Optional[Callable] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        sampler: Optional[DistributedBatchSampler] = None,
        num_shards: int = 1,
        shard_id: int = 0,
        shard_span: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _stack_collate
        if sampler is None and _has_len(dataset):
            sampler = DistributedBatchSampler(
                len(dataset), batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed,
                num_shards=num_shards, shard_id=shard_id, shard_span=shard_span,
            )
        elif sampler is None and num_shards > 1:
            raise ValueError(
                "iterable (length-less) datasets are not shardable across processes; "
                "pre-shard the stream per host or use a map-style dataset"
            )
        self.batch_sampler = sampler

    def set_epoch(self, epoch: int):
        if self.batch_sampler is not None:
            self.batch_sampler.set_epoch(epoch)

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("iterable dataset has no length")
        return len(self.batch_sampler)

    def __iter__(self):
        if self.batch_sampler is not None:
            for idx_batch in self.batch_sampler:
                batch = self.collate_fn([self.dataset[i] for i in idx_batch])
                filler = getattr(self.batch_sampler, "filler_rows", [])
                if filler and isinstance(batch, dict) and "labels" in batch:
                    # wrap-padded duplicate rows must not count toward eval
                    # loss/perplexity — mask them like single-host filler
                    labels = np.array(batch["labels"], copy=True)
                    labels[filler] = -100
                    batch["labels"] = labels
                yield batch
        else:
            buf = []
            for sample in self.dataset:
                buf.append(sample)
                if len(buf) == self.batch_size:
                    yield self.collate_fn(buf)
                    buf = []


def _stack_collate(features: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(f[k]) for f in features]) for k in features[0]}


def _has_len(x) -> bool:
    try:
        len(x)
        return True
    except TypeError:
        return False
