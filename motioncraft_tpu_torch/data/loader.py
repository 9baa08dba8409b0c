"""Batching (a copy of motioncraft_tpu/data/loader.py, one process).

A numpy batcher: shuffled (seeded) index stream, round-up semantics,
stacked numpy batches with host-side CLIP tokenization (the port's
models/tokenizer.py), and thread prefetch.  Batches stay numpy on the host;
the test and train loops copy them to the device.  Several processes
(``dist=True``) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..models.tokenizer import tokenize


class RoundUpSampler:
    """Epoch index sampler with DistributedSampler semantics: shuffle by
    epoch-seeded permutation, cycle-extend to a multiple of num_replicas
    (round_up), then hand rank r the interleaved slice
    ``indices[r::num_replicas]``."""

    def __init__(self, dataset_len: int, shuffle: bool = True, round_up: bool = True,
                 num_replicas: int = 1, seed: int = 0, rank: int = 0):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.round_up = round_up
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0

    def indices(self) -> np.ndarray:
        """This rank's interleaved index slice for the current epoch."""
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = rng.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        if self.round_up and self.num_replicas > 1:
            total = int(math.ceil(self.dataset_len / self.num_replicas)) * self.num_replicas
            reps = -(-total // len(idx))  # cycle, as the reference (indices * k)
            idx = np.tile(idx, reps)[:total]
        if self.num_replicas > 1:
            idx = idx[self.rank::self.num_replicas]
        return idx

    def set_epoch(self, epoch: int):
        self.epoch = epoch


def collate(samples: List[dict], tokenize_text: bool = True) -> Dict:
    """Stack per-sample dicts into a batch dict of numpy arrays (and lists
    of the non-numeric values), with the CLIP token ids of the texts.  The
    first sample's keys decide, and a numeric value is stacked, as in the
    JAX package; a key that a later sample lacks (a mixed train set's
    condition ``c``, which its text samples have not) is left out, where
    the JAX package raises KeyError."""
    batch: Dict = {}
    first = samples[0]
    for key in first:
        if key == "motion_metas" or any(key not in s for s in samples):
            continue
        vals = [s[key] for s in samples]
        is_numeric = ((isinstance(first[key], np.ndarray)
                       and np.issubdtype(np.asarray(first[key]).dtype, np.number))
                      or (np.isscalar(first[key]) and not isinstance(first[key], str)))
        if is_numeric:
            batch[key] = np.stack([np.asarray(v) for v in vals])
        else:
            batch[key] = vals
    if "motion_length" in batch:
        batch["motion_length"] = np.asarray(batch["motion_length"], np.int32).reshape(
            len(samples), 1)
    metas = [s.get("motion_metas", {}) for s in samples]
    batch["motion_metas"] = metas
    texts = [m.get("text", "") for m in metas]
    if tokenize_text and any(texts):
        batch["text_ids"] = tokenize(texts)
    return batch


class DataLoader:
    """Minimal epoch iterator: sampler -> dataset[i] -> collate."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, round_up: bool = False,
                 num_replicas: int = 1, seed: int = 0, tokenize_text: bool = True,
                 rank: int = 0, num_workers: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.tokenize_text = tokenize_text
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.sampler = RoundUpSampler(len(dataset), shuffle, round_up,
                                      num_replicas, seed, rank)

    def _rank_len(self) -> int:
        s = self.sampler
        if s.round_up and s.num_replicas > 1:
            return int(math.ceil(s.dataset_len / s.num_replicas))
        n = s.dataset_len
        return len(range(s.rank, n, s.num_replicas)) if s.num_replicas > 1 else n

    def __len__(self):
        n = self._rank_len()
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def _chunks(self, idx: np.ndarray) -> Iterator[np.ndarray]:
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def _load(self, chunk: np.ndarray) -> Dict:
        samples = [self.dataset[int(i)] for i in chunk]
        return collate(samples, self.tokenize_text)

    def __iter__(self) -> Iterator[Dict]:
        idx = self.sampler.indices()
        self.sampler.epoch += 1
        if self.num_workers <= 0:
            for chunk in self._chunks(idx):
                yield self._load(chunk)
            return
        yield from self._iter_async(idx)

    def _iter_async(self, idx: np.ndarray) -> Iterator[Dict]:
        """Worker-thread batch loading with bounded lookahead.  Threads (not
        processes): sample loading is numpy slicing / file IO which releases
        the GIL, and batches skip a pickle round trip."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        depth = max(1, self.prefetch)
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending: collections.deque = collections.deque()
            chunk_it = self._chunks(idx)
            try:
                for _ in range(depth):
                    pending.append(ex.submit(self._load, next(chunk_it)))
                for chunk in chunk_it:
                    batch = pending.popleft().result()
                    pending.append(ex.submit(self._load, chunk))
                    yield batch
            except StopIteration:
                pass
            while pending:
                yield pending.popleft().result()


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 0,
                     num_gpus: int = 1, dist: bool = False, shuffle: bool = True,
                     round_up: bool = True, seed: Optional[int] = None,
                     num_replicas: Optional[int] = None, rank: Optional[int] = None,
                     **kwargs) -> DataLoader:
    """The JAX package's builder signature, one process: ``workers_per_gpu``
    maps to loader prefetch threads."""
    if dist:
        raise NotImplementedError("dist=True: multi-process loading (ROADMAP queue 1: "
                                  "multi-GPU, serving and the host-side tools)")
    return DataLoader(dataset, samples_per_gpu * num_gpus, shuffle=shuffle,
                      drop_last=shuffle, round_up=round_up,
                      num_replicas=num_replicas or 1, seed=seed or 0, rank=rank or 0,
                      num_workers=workers_per_gpu)
