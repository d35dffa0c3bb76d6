"""Val batches on the host: collate and a threaded prefetching loader.

Counterpart of spectrogram_yolov11_tpu/data/build.py (collate :22,
DataLoader :31) for validation: the images in dataset order, no shuffle, the
tail batch padded with copies of its last image and `n_valid` saying how many
are real. Worker threads read and decode the images, each image on its own
(zlib releases the GIL while it inflates), a bounded number of them ahead of
the batch being taken.

A batch holds `img` as a list of the frames at their own sizes (BGR uint8
HWC), letterboxed on the card by the validator; every other field is stacked.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


def collate(samples: list) -> Dict:
    """Stack the samples' fields into one batch; `img` stays a list."""
    return {k: [s[k] for s in samples] if k == "img" else np.stack([s[k] for s in samples]) for k in samples[0]}


PREFETCH_BATCHES = 2  # batches' worth of images read ahead of the one being taken


class DataLoader:
    """Batches of `batch_size` in dataset order. `workers` threads read and
    format the images, up to PREFETCH_BATCHES batches' worth ahead of the
    consumer; an error in a worker is raised where its image's batch is taken."""

    def __init__(self, dataset, batch_size: int, workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(1, workers)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        n, bs = len(self.dataset), self.batch_size
        todo = iter(range(n))
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending: deque = deque()
            try:
                for bi in range(len(self)):
                    while len(pending) < PREFETCH_BATCHES * bs and (i := next(todo, None)) is not None:
                        pending.append(pool.submit(self.dataset.get_item, i))
                    n_valid = min(bs, n - bi * bs)
                    samples = [pending.popleft().result() for _ in range(n_valid)]
                    batch = collate(samples + samples[-1:] * (bs - n_valid))  # the tail padded with its last image
                    batch["n_valid"] = np.int32(n_valid)
                    yield batch
            finally:
                for f in pending:
                    f.cancel()
