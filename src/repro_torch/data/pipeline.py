"""Deterministic, shardable synthetic token pipeline with prefetch — a copy
of the reference's ``data/pipeline.py`` (plain numpy), so the port draws the
reference's batches byte for byte, plus ``to_device``, the upload step.

Every batch is a pure function of (seed, step, shard) — counter-based
generation (Philox) means any host can regenerate any shard of any step
without coordination: restart/elastic-rescale safe (the data analogue of the
paper's reproducible relocation mappings), and resharding only changes which
slices a host draws, never the global stream.

``Prefetcher`` overlaps host-side generation with compute via a background
thread and a bounded queue; its ``transform`` (e.g. ``to_device``) runs on
the consumer thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def make_batch(
    *,
    vocab_size: int,
    global_batch: int,
    seq_len: int,
    step: int,
    seed: int = 0,
    shard: int = 0,
    num_shards: int = 1,
    with_frames: int = 0,
) -> dict[str, np.ndarray]:
    """Generate (this shard of) one global batch. labels = next token."""
    assert global_batch % num_shards == 0
    rows = global_batch // num_shards
    rng = np.random.Philox(key=(seed << 32) | step)
    gen = np.random.Generator(rng)
    # draw the full global batch and slice the shard: cheap and exact
    tokens = gen.integers(
        0, vocab_size, (global_batch, seq_len + 1), dtype=np.int32
    )[shard * rows : (shard + 1) * rows]
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if with_frames:
        frames = gen.standard_normal(
            (global_batch, seq_len, with_frames), dtype=np.float32
        )[shard * rows : (shard + 1) * rows]
        out["frames"] = frames
    return out


class SyntheticTokens:
    def __init__(
        self,
        *,
        vocab_size: int,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        shard: int = 0,
        num_shards: int = 1,
        start_step: int = 0,
        with_frames: int = 0,
    ):
        self.kw = dict(
            vocab_size=vocab_size,
            global_batch=global_batch,
            seq_len=seq_len,
            seed=seed,
            shard=shard,
            num_shards=num_shards,
            with_frames=with_frames,
        )
        self.step = start_step

    def seek(self, step: int) -> None:
        """Restart support: resume the stream at an arbitrary step."""
        self.step = step

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        b = make_batch(step=self.step, **self.kw)
        self.step += 1
        return b


class Prefetcher:
    """Bounded background prefetch; ``transform`` (e.g. sharded device_put)
    runs on the consumer thread so device state stays single-threaded.
    ``close()`` ends the producer thread, which an endless source would
    otherwise keep blocked on a full queue for the process's life, holding
    this object and what ``transform`` refers to."""

    def __init__(self, it: Iterator, depth: int = 2, transform=None):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``close()`` comes first (then False)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        finally:
            self._put(self._done)

    def close(self) -> None:
        """Stop the producer and wait for its thread to end."""
        self._stop.set()
        self._thread.join()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return self._transform(item) if self._transform else item


def to_device(batch: dict, device) -> dict:
    """A numpy batch as torch tensors on ``device``: on CUDA each array goes
    up from a pinned host copy with ``non_blocking=True`` (the caching host
    allocator keeps the pinned buffer until its copy has run); on the CPU
    the tensors wrap contiguous arrays of the batch."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
    return out
