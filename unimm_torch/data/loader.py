"""Lightweight prefetching data loader.

The port's copy of the JAX package's ``data/loader.py``, process-shard
arguments included: in a world of several processes each rank loads its
slice of every global batch through ``process_index`` /
``process_count`` (``cli/train.py`` by dp index, and
``cli/common.eval_loader`` by rank under ``-eval_data_sharded``).

Replaces the reference's torch DataLoader worker processes
(the reference's train.py:309-316) with a thread pool building items ahead
of consumption while the current batch computes — keeping the card fed
without worker processes. Encoding is
numpy-bound (no GIL-heavy Python loops in the hot path), so threads are
sufficient; the heavy O(L^2) mask work that justified worker processes in the
reference no longer exists host-side at all.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle=False,
                 drop_last=False, num_workers: int = 4, seed: int = 0,
                 collate_fn: Optional[Callable] = None, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        """``batch_size`` is GLOBAL. Under several processes
        (process_count > 1) every process computes the identical global
        shuffle from the shared seed, then loads only its slice of each
        global batch — the per-process rows that the processes together
        assemble into the global batch. In a world with an mp axis a
        process passes its dp index and the dp size, so the ranks of one
        mp group load the same rows.

        Multi-process + drop_last=False: a global batch whose size does not
        divide the process count is PADDED up to the next multiple by
        repeating its last row, so every row of the dataset reaches some
        process (the reference scores every val dialog unconditionally,
        val_lm.py:40-190). Padded batches carry a per-process boolean
        ``valid`` key marking the duplicated rows — metric consumers mask
        them out (eval/evaluator.evaluate_split); the padded global size
        still need not divide a data-parallel axis, where sharding fails
        loudly rather than silently diverging (training CLIs therefore keep
        drop_last=True)."""
        from unimm_torch.data.dataset import collate
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.collate = collate_fn or collate
        self.prefetch = prefetch
        self.epoch = 0
        assert 0 <= process_index < process_count, (process_index,
                                                    process_count)
        if drop_last and batch_size % process_count != 0:
            # training consumers ignore the ``valid`` padding mask
            # (flatten_for_forward drops it), so padding here would silently
            # train duplicated rows every batch — fail loudly instead
            raise ValueError(
                f"process-sharded training loader: batch_size {batch_size} "
                f"must divide over the {process_count} processes "
                "(drop_last=True batches carry no 'valid' mask consumers; "
                "pick a divisible -batch_size)")
        self.process_index = process_index
        self.process_count = process_count
        self.dropped_rows = 0   # always 0 since the r4 tail-padding fix

    def __len__(self):
        n = len(self.dataset)
        full = n // self.batch_size
        tail = n % self.batch_size
        return full + (1 if (tail and not self.drop_last) else 0)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        batches = [order[i: i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        self.dropped_rows = 0
        valids: Optional[list] = None
        if self.process_count > 1:
            # per-process shard of each global batch: contiguous slice in
            # process order (= the rows this process's devices own under a
            # data-parallel layout in process order).
            # Non-divisible batches are PADDED to the next multiple of the
            # process count by repeating the last row, so every dataset row
            # reaches a process; the duplicated rows are flagged in a
            # per-batch ``valid`` mask (None when no padding — the padding
            # decision depends only on the GLOBAL batch size, so every
            # process agrees on whether the key is present).
            nproc = self.process_count
            valids = []

            def shard(b):
                pad = -len(b) % nproc
                v = None
                if pad:
                    b = np.concatenate([b, np.repeat(b[-1:], pad)])
                    v = np.ones(len(b), bool)
                    v[-pad:] = False
                k = len(b) // nproc
                sl = slice(self.process_index * k,
                           (self.process_index + 1) * k)
                valids.append(None if v is None else v[sl])
                return b[sl]

            batches = [shard(b) for b in batches]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_abandon(item) -> bool:
            """Bounded put that gives up when the consumer stopped iterating
            (a blocking q.put here would leak the producer thread forever
            when the consumer breaks out of the epoch early)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # bounded pipelining: at most (prefetch + 1) batches of items are
            # in flight, so host memory stays O(prefetch * batch) rather than
            # the whole epoch being pre-submitted to the pool
            window = self.prefetch + 1
            with ThreadPoolExecutor(self.num_workers) as pool:
                in_flight = []
                bi = 0
                try:
                    while (bi < len(batches) or in_flight) and not stop.is_set():
                        while bi < len(batches) and len(in_flight) < window:
                            in_flight.append(
                                (bi,
                                 [pool.submit(self.dataset.__getitem__,
                                              int(i)) for i in batches[bi]]))
                            bi += 1
                        idx, fs = in_flight.pop(0)
                        item = self.collate([f.result() for f in fs])
                        if valids is not None and valids[idx] is not None:
                            item["valid"] = valids[idx]
                        if not put_or_abandon(item):
                            break
                except Exception as e:  # surfaced to the consumer
                    put_or_abandon(e)
                for _, fs in in_flight:
                    for f in fs:
                        f.cancel()
            put_or_abandon(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def batch_iter(loader: DataLoader, num_epochs: int, start_epoch: int = 0):
    """Epoch iterator (utils/data_utils.py:52-55 equivalent).

    ``start_epoch`` skips already-completed epochs on an -auto_resume
    relaunch without loading their batches."""
    for epoch in range(start_epoch, num_epochs):
        loader.set_epoch(epoch)
        for idx, batch in enumerate(loader):
            yield epoch, idx, batch
