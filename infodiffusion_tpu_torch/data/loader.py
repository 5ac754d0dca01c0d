"""Host input pipeline (JAX counterpart: ``infodiffusion_tpu/data/loader.py``).

Batches of ``batch_size`` rows (``drop_last`` always), assembled and
flipped on the host by a background producer thread that keeps
``prefetch`` batches ready on ``device``. The random stream is the JAX
loader's: one ``np.random.RandomState(seed)`` that draws, per epoch and up
front in ``__iter__``, one permutation when shuffling and one
``rand(nb, B) < 0.5`` flip block when flipping, so both loaders yield the
same rows in the same order with the same flips, and ``fast_forward``
replays the draws of skipped epochs.

Pixels cross to the card as uint8 (a quarter of f32's bytes), from pinned
memory with ``non_blocking=True``, and are normalized there to [-1, 1]
(``pm1_on_device``). ``INFODIFF_HOST_NORMALIZE=1`` normalizes on the host
and ships f32 instead, as in the JAX package. Float data (latents) and
dsprites' raw 0/1 pixels always ship f32. Attributes stay numpy arrays on
the host. Batches are ``[B, H, W, C]`` tensors (``[B, d]`` for latents). The
consumer's wait for each batch is the span ``data.wait`` (``tracing.py``).

``batch_size`` is the **global** batch. Under data parallelism ``rows``
names the rows of each global batch this rank assembles
(``parallel.multihost.local_row_indices``): every rank draws the same
order and flips from ``seed``, and the union of the ranks' rows is the
one-process batch.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from infodiffusion_tpu_torch import tracing


def pm1_on_device(u8: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> f32 in [-1, 1]: ``x / 255 * 2 - 1``, clipped so that
    code 255 lands on 1.0 exactly."""
    return torch.clamp(u8.to(torch.float32) / 255.0 * 2.0 - 1.0, -1.0, 1.0)


class DataLoader:
    """``drop_last=True`` always. ``device`` is where batches land
    (required: the runner passes the run's device)."""

    def __init__(self, dataset, batch_size: int, *, device,
                 shuffle: bool = False, flip: bool = False, seed: int = 0,
                 with_attrs: bool = False, prefetch: int = 2, rows=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = (np.arange(batch_size) if rows is None
                     else np.asarray(rows))
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.flip = flip
        self.with_attrs = with_attrs
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)
        self._epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return self._rng.permutation(n)
        return np.arange(n)

    def fast_forward(self, n_epochs: int, n_batches: int = 0) -> None:
        """Advance the random stream past ``n_epochs`` epochs without
        loading any data (exactly the draws ``__iter__`` makes), so a
        resumed run's epoch k sees the order and flips of the uninterrupted
        run's epoch k; the next epoch then starts at batch ``n_batches``
        (a run preempted mid-epoch resumes where it stopped)."""
        for _ in range(n_epochs):
            if self.shuffle:
                self._rng.permutation(len(self.dataset))
            if self.flip:
                self._rng.rand(len(self), self.batch_size)
            self._epoch += 1
        self._skip = n_batches

    def u8_transfer(self) -> bool:
        """Whether batches ship as uint8 and normalize on the device."""
        if os.environ.get("INFODIFF_HOST_NORMALIZE") == "1":
            return False
        ok = getattr(self.dataset, "u8_transfer_ok", None)
        return bool(ok and ok())

    def _assemble(self, idx: np.ndarray, flip_mask=None, u8: bool = False):
        idx = idx[self.rows]
        if flip_mask is not None:
            flip_mask = flip_mask[self.rows]
        if u8:
            x, a = self.dataset.get_batch_u8(idx)
        else:
            x, a = self.dataset.get_batch(idx)
        if flip_mask is not None:
            x[flip_mask] = x[flip_mask, :, ::-1, :]
        return x, a

    def _to_device(self, x: np.ndarray, u8: bool) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return pm1_on_device(t) if u8 else t

    def __iter__(self) -> Iterator:
        # every draw of the epoch happens here, before the producer starts,
        # so how far an abandoned iteration prefetched never moves the
        # stream (the JAX loader's contract)
        order = self._order()
        self._epoch += 1
        nb = len(self)
        flip_masks = (self._rng.rand(nb, self.batch_size) < 0.5
                      if self.flip else None)
        first, self._skip = self._skip, 0
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        u8 = self.u8_transfer()
        # the producer thread starts on card 0: it takes the card by index,
        # the consumer's current one where the device names none
        card = None
        if self.device.type == "cuda":
            card = (self.device.index if self.device.index is not None
                    else torch.cuda.current_device())

        def put(item):
            # a plain put would block forever on a full queue once the
            # consumer abandons the iteration
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                if card is not None:
                    torch.cuda.set_device(card)
                for b in range(first, nb):
                    if stop.is_set():
                        return
                    idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                    mask = flip_masks[b] if flip_masks is not None else None
                    x, a = self._assemble(idx, mask, u8)
                    x = self._to_device(x, u8)
                    if not put((x, a) if self.with_attrs else x):
                        return
                put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                # a decode or copy failure must reach the consumer, or
                # q.get() would wait forever
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with tracing.span("data.wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def h2d_bytes_per_batch(loader: DataLoader) -> int:
    """Bytes one batch moves host to device (pixels only)."""
    example = loader.dataset.get_batch_u8(np.arange(1))[0]
    per_row = int(np.prod(example.shape[1:]))
    return len(loader.rows) * per_row * (1 if loader.u8_transfer() else 4)
