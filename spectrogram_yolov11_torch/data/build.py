"""Batches on the host: collate and a threaded prefetching loader.

Counterpart of spectrogram_yolov11_tpu/data/build.py (collate :22,
DataLoader :31-125). Worker threads run the dataset's get_item, each sample on
its own (zlib releases the GIL while it inflates), a bounded number of
samples ahead of the batch being taken; an error in a worker is raised where
its sample's batch is taken.

Validation (the defaults): the images in dataset order, the tail batch padded
with copies of its last image and `n_valid` saying how many are real; `img`
is a list of the frames at their own sizes (BGR uint8 HWC), letterboxed on
the card by the validator.

Training (shuffle=True, drop_last=True, as the JAX trainer builds it): the
batch holds the train transform's fields stacked, `img` (B, S, S, 3) uint8
RGB too when the host augments the images; the epoch's order is default_rng(seed + epoch).permutation(n) (set_epoch picks
the epoch), the tail that does not fill a batch is dropped, and the sample at
position p of the epoch draws from its own stream,
default_rng((seed * 1_000_003 + epoch) * 100_003 + p), so a batch does not
depend on which thread made it. With pin_memory every field is collated into
pinned host memory, for a non_blocking upload to the card.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    """A sample's field as a CPU tensor of its own shape (a scalar stays 0-d, as np.stack keeps it)."""
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags["C_CONTIGUOUS"] else np.ascontiguousarray(a))


def collate(samples: list, pin_memory: bool = False, stack_img: bool = False) -> Dict:
    """Stack the samples' fields into one batch; `img` stays a list unless
    stack_img (the train batch's equal-sized images). With pin_memory the
    stacked fields are torch tensors in pinned memory."""
    out: Dict = {}
    for k in samples[0]:
        if k == "img" and not stack_img:
            out[k] = [s[k] for s in samples]
        elif pin_memory:
            first = _tensor(samples[0][k])
            t = torch.empty((len(samples), *first.shape), dtype=first.dtype, pin_memory=True)
            for j, s in enumerate(samples):
                t[j].copy_(_tensor(s[k]))
            out[k] = t
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


PREFETCH_BATCHES = 2  # batches' worth of samples made ahead of the one being taken


class DataLoader:
    """Batches of `batch_size`. `workers` threads make the samples, up to
    PREFETCH_BATCHES batches' worth ahead of the consumer. The defaults are
    the val loader's; shuffle, seed, drop_last and set_epoch are the train
    loader's (module docstring)."""

    def __init__(self, dataset, batch_size: int, workers: int = 8, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(1, workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pin_memory = pin_memory
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        return np.random.default_rng(self.seed + self.epoch).permutation(n) if self.shuffle else np.arange(n)

    def _item(self, idx: int, pos: int):
        """The dataset's sample idx, at position pos of the epoch: with its own
        Generator when the dataset augments."""
        if not getattr(self.dataset, "augment", False):
            return self.dataset.get_item(idx)
        return self.dataset.get_item(idx, np.random.default_rng((self.seed * 1_000_003 + self.epoch) * 100_003 + pos))

    def __iter__(self) -> Iterator[Dict]:
        idxs, bs = self._indices(), self.batch_size
        n = min(len(idxs), len(self) * bs)
        todo = iter(range(n))
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending: deque = deque()
            try:
                for bi in range(len(self)):
                    while len(pending) < PREFETCH_BATCHES * bs and (p := next(todo, None)) is not None:
                        pending.append(pool.submit(self._item, int(idxs[p]), p))
                    n_valid = min(bs, n - bi * bs)
                    samples = [pending.popleft().result() for _ in range(n_valid)]
                    batch = collate(samples + samples[-1:] * (bs - n_valid), self.pin_memory,  # a val tail padded
                                    stack_img=getattr(self.dataset, "augment", False))
                    batch["n_valid"] = np.int32(n_valid)
                    yield batch
            finally:
                for f in pending:
                    f.cancel()
