"""Deterministic token data pipeline with host-side prefetch (PyTorch port
of ``repro.data.pipeline``).

Sources (numpy, as in the reference, so batch ``i`` equals the reference's
batch ``i`` byte for byte):
  * SyntheticSource — seeded Zipfian token stream (self-contained runs);
  * MemmapSource — flat uint16/uint32 token file (np.memmap), the standard
    packed-tokens format.

The pipeline is *stateless-resumable*: batch ``i`` is a pure function of
(seed, i), so checkpoint/restart only needs the step counter — no iterator
state in checkpoints.

A background thread makes the batches and moves them onto ``device``.  The
copy is a plain synchronous ``Tensor.to``: a batch is a few KB of int32
tokens.  With ``shardings`` (``{"tokens": NamedSharding, "labels": ...}``
on a ``DeviceMesh``, as ``launch.steps.batch_shardings`` gives them) each
batch is a DTensor per key, placed by its spec as the reference's sharded
``device_put`` places it: every rank makes the same whole batch from
(seed, i) and keeps its rows, so nothing is sent.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.kernels.ops import resolve_device


class SyntheticSource:
    """Zipf-distributed tokens; batch i is a pure function of (seed, i)."""

    def __init__(self, vocab: int, seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab
        self.seed = seed
        self.zipf_a = zipf_a

    def batch(self, index: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) ^ index)
        toks = rng.zipf(self.zipf_a, size=(batch, seq + 1)).astype(np.int64)
        return np.clip(toks, 0, self.vocab - 1).astype(np.int32)


class MemmapSource:
    """Packed token file; deterministic strided windows per batch index."""

    def __init__(self, path: str, vocab: int, dtype=np.uint16, seed: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab
        self.seed = seed

    def batch(self, index: int, batch: int, seq: int) -> np.ndarray:
        n = len(self.tokens) - (seq + 1)
        rng = np.random.default_rng((self.seed << 32) ^ index)
        starts = rng.integers(0, n, size=batch)
        out = np.stack(
            [self.tokens[s : s + seq + 1] for s in starts]
        ).astype(np.int32)
        return np.clip(out, 0, self.vocab - 1)


@dataclasses.dataclass
class PipelineConfig:
    batch: int
    seq: int
    prefetch: int = 2
    start_step: int = 0


class DataPipeline:
    """Iterates {"tokens","labels"} int32 tensors on ``device`` with
    background prefetch.  A batch that fails to be made raises from
    ``__next__``."""

    def __init__(self, source, cfg: PipelineConfig,
                 device: str | torch.device = DEFAULT_DEVICE, shardings: dict | None = None):
        self.source = source
        self.cfg = cfg
        self.device = resolve_device(device)
        self.shardings = shardings
        self._start(cfg.start_step)

    def _start(self, step: int) -> None:
        # the thread gets its own queue and stop flag, so a worker that
        # outlives close() never feeds the next one's queue
        self._q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        self._stop = threading.Event()
        self._step = step
        self._thread = threading.Thread(target=self._worker, args=(self._q, self._stop, step),
                                        daemon=True)
        self._thread.start()

    def _make(self, index: int) -> dict:
        raw = torch.from_numpy(self.source.batch(index, self.cfg.batch, self.cfg.seq))
        batch = {"tokens": raw[:, :-1].to(self.device), "labels": raw[:, 1:].to(self.device)}
        if self.shardings is not None:
            from torch.distributed.tensor import distribute_tensor

            batch = {k: distribute_tensor(v.contiguous(), self.shardings[k].mesh,
                                          self.shardings[k].placements, src_data_rank=None)
                     for k, v in batch.items()}
        return batch

    def _worker(self, q: queue.Queue, stop: threading.Event, i: int) -> None:
        while not stop.is_set():
            try:
                item = self._make(i)
            except Exception as exc:   # handed to the consumer, raised by __next__
                item = exc
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            i += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        self._step += 1
        return item

    def seek(self, step: int) -> None:
        """Restart resume: restart prefetch at ``step``."""
        self.close()
        self.cfg = dataclasses.replace(self.cfg, start_step=step)
        self._start(step)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
