"""Cross-request micro-batching for the /classify endpoint (r5).

The reference's concurrency model is replica scaling — one MPS request
per worker (reference README.md:35-38) — which cannot batch across
requests at all. Serializing whole /classify requests on the accelerator
lock would batch within one request (models/infer.py), but N concurrent
clients would queue and each pay a full forward, with no admission
control. This module adds the one serving lever replica scaling can't
reach:

  * a single dispatcher thread drains EVERYTHING queued the moment the
    accelerator frees and runs ONE bucketed forward over the coalesced
    images. No artificial batching window: under load, the previous
    forward's duration is the batching window (requests arriving while a
    batch runs coalesce into the next batch); an idle service dispatches a
    lone request immediately, so the unloaded latency cost is ~zero.
  * a bounded image queue with 503-on-full backpressure: a burst beyond
    ``max_queue_images`` is rejected up front (the client can retry
    against another replica) instead of accumulating unbounded latency.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Sequence

import numpy as np


class QueueFullError(Exception):
    """Raised by submit() when the bounded image queue is full."""


class ClassifyBatcher:
    """Coalesces concurrent classification requests into device batches.

    classifier: models.infer.SpectrogramClassifier (its ``classify`` runs
    the bucketed jitted forward).
    accel_lock: the service's accelerator lock — batched forwards
    serialize against /process chain runs on the shared chip.
    max_queue_images: admission bound (images, not requests).
    """

    def __init__(self, classifier, accel_lock: threading.Lock | None = None,
                 max_queue_images: int = 256):
        self.classifier = classifier
        self.accel_lock = accel_lock or threading.Lock()
        self.max_queue_images = max_queue_images
        self._mu = threading.Condition(threading.Lock())
        self._pending: list[tuple[np.ndarray, concurrent.futures.Future]] = []
        self._pending_images = 0
        self._stopped = False
        # Observability (read under _mu): how much coalescing happened.
        self.stats = {"batches": 0, "batched_images": 0, "max_batch": 0,
                      "rejected": 0}
        self._thread = threading.Thread(
            target=self._loop, name="classify-batcher", daemon=True)
        self._thread.start()

    # ------------------------------ client API ---------------------------

    def submit(self, images: np.ndarray) -> concurrent.futures.Future:
        """Enqueue one request's images; resolves to a list of per-image
        prediction dicts (models/infer.py classify schema)."""
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[None]
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._mu:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            # Admission: reject only when adding to a NON-empty queue would
            # exceed the bound. A single over-sized request with an empty
            # queue is always admitted — the classifier chunks internally
            # at MAX_BATCH_BUCKET, and rejecting it would make it
            # permanently unservable (no retry could ever succeed).
            if (self._pending_images > 0
                    and self._pending_images + len(images)
                    > self.max_queue_images):
                self.stats["rejected"] += 1
                raise QueueFullError(
                    f"classification queue full "
                    f"({self._pending_images} images pending, "
                    f"bound {self.max_queue_images})")
            self._pending.append((images, fut))
            self._pending_images += len(images)
            self._mu.notify()
        return fut

    def classify(self, images: np.ndarray, timeout: float | None = None):
        """Synchronous convenience wrapper: submit + wait."""
        return self.submit(images).result(timeout)

    def stop(self) -> None:
        with self._mu:
            self._stopped = True
            self._mu.notify()
        self._thread.join(timeout=5)
        # Fail anything still queued so no caller hangs forever.
        for _, fut in self._pending:
            if not fut.done():
                fut.set_exception(RuntimeError("batcher stopped"))
        self._pending.clear()
        self._pending_images = 0

    # ------------------------------ dispatcher ---------------------------

    def _drain(self) -> Sequence[tuple[np.ndarray, concurrent.futures.Future]]:
        with self._mu:
            while not self._pending and not self._stopped:
                self._mu.wait()
            if self._stopped and not self._pending:
                return ()
            batch = self._pending
            self._pending = []
            self._pending_images = 0
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._drain()
            if not batch:
                return
            imgs = (batch[0][0] if len(batch) == 1
                    else np.concatenate([b for b, _ in batch]))
            try:
                with self.accel_lock:
                    results = self.classifier.classify(imgs)
            except Exception as e:  # noqa: BLE001 — delivered per-request
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            with self._mu:
                self.stats["batches"] += 1
                self.stats["batched_images"] += len(imgs)
                self.stats["max_batch"] = max(self.stats["max_batch"],
                                              len(imgs))
            i = 0
            for b, fut in batch:
                if not fut.done():
                    fut.set_result(results[i:i + len(b)])
                i += len(b)
