"""Threaded prefetching batch loader.

Counterpart of ``lip2speech_tpu/data/loader.py``: worker threads decode
samples (bz2 and cv2 release the GIL while they work), the producer thread
collates each batch to static shapes and keeps up to ``prefetch`` batches
ahead of the consumer. The transfer to the device, normalisation and mel
extraction come after, in ``collate.to_device`` and ``prepare_batch``.

``stats`` counts, since the loader was made: ``batches`` produced,
``host_s`` the producer's wall time decoding and collating them,
``wait_s`` the consumer's wall time blocked on an empty queue, and
``stalls`` how many of its gets found the queue empty.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from lip2speech_torch.config import DataConfig
from lip2speech_torch.data.collate import collate


class Loader:
    def __init__(self, dataset, batch_size: int, cfg: DataConfig = DataConfig(),
                 shuffle: bool = True, drop_last: bool = True, num_workers: int = 8,
                 prefetch: int = 2, seed: int = 0, infinite: bool = False,
                 shard_index: int = 0, shard_count: int = 1, pin_memory: bool = False):
        """``batch_size`` is the global batch. With ``shard_count`` > 1 every
        process shuffles with the same seed and yields its contiguous
        ``batch_size // shard_count`` slice of each global batch. With
        ``pin_memory`` the producer hands over each batch as page-locked
        tensors, ready for a non-blocking copy to the card."""
        assert batch_size % shard_count == 0, (batch_size, shard_count)
        assert 0 <= shard_index < shard_count
        self.ds = dataset
        self.batch_size = batch_size
        self.local_batch_size = batch_size // shard_count
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.cfg = cfg
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.infinite = infinite
        self.pin_memory = pin_memory
        self.stats = {"batches": 0, "host_s": 0.0, "wait_s": 0.0, "stalls": 0}

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        nb = -(-n // self.batch_size)
        # a ragged tail smaller than shard_count is skipped by every process
        tail = n % self.batch_size
        if self.shard_count > 1 and 0 < tail < self.shard_count:
            nb -= 1
        return nb

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def shard_rows(self, n: int) -> tuple[int, int] | None:
        """[start, stop) of this process's rows of a batch of ``n`` clips:
        its equal share of a full batch, its part of a ragged tail split as
        evenly as the counts allow; None when the tail leaves some process
        nothing, which every process then skips."""
        if n == self.batch_size:
            lo = self.shard_index * self.local_batch_size
            return lo, lo + self.local_batch_size
        edges = np.linspace(0, n, self.shard_count + 1).round().astype(int)
        if (np.diff(edges) == 0).any():
            return None
        return int(edges[self.shard_index]), int(edges[self.shard_index + 1])

    def _shard(self, chunk: np.ndarray) -> np.ndarray | None:
        """This process's share of one batch's indices (``shard_rows``)."""
        rows = self.shard_rows(len(chunk))
        if rows is None:
            logging.getLogger(__name__).warning(
                "skipping %d-clip tail batch (< %d processes)", len(chunk), self.shard_count)
            return None
        return chunk[rows[0]: rows[1]]

    def _batch(self, pool: ThreadPoolExecutor, chunk: np.ndarray) -> dict:
        t0 = time.perf_counter()
        batch = collate(list(pool.map(self.ds.__getitem__, chunk)), self.cfg)
        if self.pin_memory:
            batch = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
        self.stats["host_s"] += time.perf_counter() - t0
        self.stats["batches"] += 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops early sets `stop`; a producer blocked on a
            # full queue must see it, or it and its pool would leak
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    while True:
                        idx = self._epoch_indices()
                        nb = (len(idx) // self.batch_size if self.drop_last
                              else -(-len(idx) // self.batch_size))
                        for b in range(nb):
                            if stop.is_set():
                                return
                            chunk = self._shard(idx[b * self.batch_size: (b + 1) * self.batch_size])
                            if chunk is None:
                                continue
                            if not put(("batch", self._batch(pool, chunk))):
                                return
                        if not self.infinite:
                            put(("end", None))
                            return
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                put(("error", e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                if q.empty():
                    self.stats["stalls"] += 1
                t0 = time.perf_counter()
                kind, payload = q.get()
                self.stats["wait_s"] += time.perf_counter() - t0
                if kind == "end":
                    return
                if kind == "error":
                    raise RuntimeError("Loader worker failed") from payload
                yield payload
        finally:
            stop.set()
            try:  # unblock a producer mid-put so it can exit
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30)
