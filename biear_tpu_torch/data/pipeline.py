"""Host input pipeline: shuffled batches and a prefetcher to the device.

Counterpart of ``biear_tpu/data/pipeline.py``. ``batch_iterator`` is a
copy of its ``pad_to_full=True`` mode (the same numpy permutation, so the
same rows arrive in the same order and the same padding, and the same
per-host slices of it). ``Prefetcher`` builds the
next batches on a worker thread: each array goes into pinned host memory
and is copied to the card with ``non_blocking`` on a side stream; an event
recorded after the copies orders them before the consumer's use.
"""

from __future__ import annotations

import queue as queue_mod
import threading

import numpy as np
import torch


def batch_iterator(ds, batch_size: int, *, shuffle: bool, seed: int = 0,
                   epoch: int = 0, host_id: int = 0, host_count: int = 1):
    """Tuples of numpy batches from a dataset with ``rows()`` / ``len()``,
    each with a float32 (batch_size,) weight vector appended (1 real, 0
    padding): the last partial batch is padded to batch_size by repeating
    its own rows, so the step sees one shape per run (the JAX package's
    ``pad_to_full=True``). shuffle permutes the rows with
    ``default_rng(seed + epoch)``.

    With host_count > 1, host host_id takes ``idx[host_id::host_count]``
    of each epoch's global permutation, and every host yields the same
    number of batches: a host whose share runs out first appends
    all-padding batches (weights 0), because each step is a collective
    that every host must join."""
    n = len(ds)
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed + epoch).permutation(n)
    idx = idx[host_id::host_count]
    emitted = 0
    for s in range(0, len(idx), batch_size):
        sel = idx[s:s + batch_size]
        n_valid = len(sel)
        if n_valid < batch_size:
            fill = sel[np.arange(batch_size - n_valid) % n_valid]
            sel = np.concatenate([sel, fill])
        w = np.zeros(batch_size, np.float32)
        w[:n_valid] = 1.0
        yield (*ds.rows(sel), w)
        emitted += 1
    if host_count > 1 and n > 0:
        # host 0 always holds the longest share: ceil(n / host_count)
        global_batches = -(-(-(-n // host_count)) // batch_size)
        while emitted < global_batches:
            sel = np.broadcast_to(idx[:1] if len(idx)
                                  else np.zeros(1, np.int64),
                                  (batch_size,)).copy()
            yield (*ds.rows(sel), np.zeros(batch_size, np.float32))
            emitted += 1


class Prefetcher:
    """Iterate `it` (tuples of numpy arrays) as tuples of tensors on
    `device`, DEPTH batches ahead on a worker thread. An exception of the
    worker is raised to the consumer; ``close()`` releases the worker and
    its queued batches (a consumer that stops early must call it)."""

    DEPTH = 2
    _DONE = object()

    def __init__(self, it, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)
        self._q = queue_mod.Queue(maxsize=self.DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _to_device(self, batch):
        if not self._cuda:
            return tuple(torch.as_tensor(np.asarray(b)) for b in batch), None
        host = [torch.from_numpy(np.ascontiguousarray(b)).pin_memory()
                for b in batch]
        with torch.cuda.stream(self._stream):
            out = tuple(h.to(self.device, non_blocking=True) for h in host)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _put(self, item) -> bool:
        """Enqueue unless the consumer closed us; False means stop."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _run(self, it):
        try:
            for batch in it:
                if not self._put(self._to_device(batch)):
                    return
            self._put(self._DONE)
        except Exception as e:       # noqa: BLE001 (raised to the consumer)
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._q.put(self._DONE)          # later calls stop too
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        batch, ready = item
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            for t in batch:                  # made on the side stream
                t.record_stream(cur)
        return batch

    def close(self):
        """Stop the worker and drop its queued batches; safe to repeat."""
        self._stop.set()

        def drain():
            try:
                while True:
                    self._q.get_nowait()
            except queue_mod.Empty:
                pass

        drain()
        self._thread.join(timeout=5.0)
        drain()
