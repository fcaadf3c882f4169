"""Device scoring for serving: one CUDA graph of the predict per batch bucket.

Counterpart of ``h2o3_tpu/serve/registry.py``, whose ``CompiledScorer``
warms one jitted predict per batch bucket. Every micro-batch pads to one
of a fixed set of batch-size buckets (1/8/64/512/4096 by default), with
the live-row count ``n_active`` masking the tail. On the card, deploy
captures one ``torch.cuda.CUDAGraph`` of the masked predict per bucket,
over static input, ``n_active`` and output tensors; serving then copies
a batch into the static tensors and replays the graph, so the warm path
captures nothing and runs no eager predict. ``n_active`` is a device
tensor written before each replay: a Python int would be frozen into
the graph at capture. A capture that fails raises out of the
constructor; the scorer never falls back to eager scoring on the card.
On the CPU, which the caller asked for, the scorer runs the predict
eagerly at the bucket's shape (``graphed`` is False).

Scoring is asynchronous on the card: ``score`` copies the padded batch
into a pinned slot, enqueues the copy in, the replay and the copy out on
the scorer's stream, records an event and returns the slot; ``fetch``
waits on the slot's event and returns the host scores. Each bucket keeps
a ring of slots, a slot reused only after its fetch, so that batches in
flight (the batcher keeps ``PIPELINE_DEPTH`` of them, and two may share
a bucket) never share a slot; the static output is copied out in stream
order before the next replay of the bucket overwrites it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.serve.batcher import PIPELINE_DEPTH

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 64, 512, 4096)

# eager predicts on the side stream before a capture (torch's rule: the
# captured work must not be the first of its kind on the stream)
WARMUP_CALLS = 3


class _Slot:
    """Host side of one in-flight batch: the padded input, ``n_active``,
    the scores (pinned on the card) and the event after the copy out."""
    __slots__ = ("bucket", "x", "n", "out", "event")

    def __init__(self, bucket: "_Bucket", F: int, out_shape,
                 on_card: bool):
        self.bucket = bucket
        self.x = torch.empty((bucket.rows, F), dtype=torch.float32,
                             pin_memory=on_card)
        self.n = torch.zeros(1, dtype=torch.int64, pin_memory=on_card)
        self.out = torch.empty(out_shape, dtype=torch.float32,
                               pin_memory=on_card)
        self.event = torch.cuda.Event() if on_card else None


class _Bucket:
    """One batch bucket: the static tensors and graph (on the card) and
    its ring of free slots."""

    def __init__(self, rows: int):
        self.rows = rows
        self.x: Optional[torch.Tensor] = None      # static input [rows, F]
        self.n: Optional[torch.Tensor] = None      # static n_active [1]
        self.out: Optional[torch.Tensor] = None    # static output
        self.graph = None                          # torch.cuda.CUDAGraph
        self._free: List[_Slot] = []
        self._cv = threading.Condition()

    def acquire(self) -> _Slot:
        with self._cv:
            while not self._free:
                self._cv.wait()
            return self._free.pop()

    def release(self, slot: _Slot) -> None:
        with self._cv:
            self._free.append(slot)
            self._cv.notify()


class CompiledScorer:
    def __init__(self, model, buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.model = model
        self.device = _device.resolve(model.device)
        self.buckets = tuple(sorted({int(b) for b in buckets if int(b) > 0}))
        if not self.buckets:
            raise ValueError("at least one batch bucket is required")
        self.n_features = len(model.feature_names)
        self.nclasses = int(getattr(model, "nclasses", 1) or 1)
        self.graphed = self.device.type == "cuda"
        # slots a bucket: the batches in flight, the one the collector
        # holds and the one being dispatched
        self.ring = PIPELINE_DEPTH + 2
        self.warm_seconds: Dict[int, float] = {}
        # output contract read at warm time (deploy-time validation):
        # ndim and, for 2-D outputs, the class-axis width
        self.out_ndim: Optional[int] = None
        self.out_k: Optional[int] = None
        # what the scorer ran: graph captures, replays and eager predicts
        # (the warm-ups before each capture included)
        self.captures = 0
        self.replays = 0
        self.eager_calls = 0
        self._mu = threading.Lock()
        self.stream = (torch.cuda.Stream(self.device) if self.graphed
                       else None)
        self._buckets = {b: _Bucket(b) for b in self.buckets}
        for b in self.buckets:
            self._warm(self._buckets[b])

    # -- warmup ---------------------------------------------------------

    def _masked(self, X: torch.Tensor, n_active: torch.Tensor
                ) -> torch.Tensor:
        """The model's batch predict with the pad rows' scores set to 0:
        pad rows are all-NA, and nothing they score leaves the scorer."""
        out = self.model._predict_matrix(X)
        live = torch.arange(X.shape[0], device=X.device) < n_active
        if out.dim() == 2:
            return torch.where(live[:, None], out, 0.0)
        return torch.where(live, out, 0.0)

    def _warm(self, b: _Bucket) -> None:
        """The bucket's static tensors and, on the card, its graph: eager
        warm-ups on the scorer's stream, then one capture in
        thread-local mode (another deployment's batcher thread may
        allocate or replay meanwhile). A capture that fails raises."""
        dev = self.device
        t0 = time.perf_counter()
        b.x = torch.full((b.rows, self.n_features), float("nan"),
                         dtype=torch.float32, device=dev)
        b.n = torch.zeros(1, dtype=torch.int64, device=dev)
        if self.graphed:
            with torch.cuda.device(dev):
                self.stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(self.stream):
                    for _ in range(WARMUP_CALLS):
                        self._masked(b.x, b.n)
                self.eager_calls += WARMUP_CALLS
                torch.cuda.current_stream(dev).wait_stream(self.stream)
                b.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(b.graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    b.out = self._masked(b.x, b.n)
                self.captures += 1
                torch.cuda.synchronize(dev)
        else:
            b.out = self._masked(b.x, b.n)
            self.eager_calls += 1
        self.warm_seconds[b.rows] = time.perf_counter() - t0
        self.out_ndim = b.out.dim()
        self.out_k = int(b.out.shape[1]) if b.out.dim() == 2 else None
        b._free = [_Slot(b, self.n_features, tuple(b.out.shape),
                         self.graphed) for _ in range(self.ring)]

    # -- scoring --------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the batcher caps batches at
        max(buckets), so every batch has one)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} rows exceeds the largest bucket "
                         f"{self.buckets[-1]}")

    def bucket(self, rows: int) -> _Bucket:
        """The bucket of ``rows`` padded rows (its static tensors and
        graph)."""
        b = self._buckets.get(int(rows))
        if b is None:
            raise ValueError(
                f"batch shape {rows} is not a bucket {self.buckets} — "
                f"encode with pad_to=bucket_for(n)")
        return b

    def score(self, X: np.ndarray, n_active: int) -> _Slot:
        """Dispatch one padded batch ([bucket, F] float32); returns its
        slot, which ``fetch`` turns into host scores."""
        b = self.bucket(X.shape[0])
        slot = b.acquire()
        try:
            np.copyto(slot.x.numpy(), X)
            slot.n[0] = int(n_active)
            if b.graph is None:
                with self._mu:
                    self.eager_calls += 1
                slot.out.copy_(self._masked(slot.x, slot.n))
                return slot
            # one batch's copy in, replay and copy out stay together in
            # stream order (the collector's retry dispatches too)
            with self._mu, torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                b.x.copy_(slot.x, non_blocking=True)
                b.n.copy_(slot.n, non_blocking=True)
                b.graph.replay()
                self.replays += 1
                slot.out.copy_(b.out, non_blocking=True)
                slot.event.record(self.stream)
        except BaseException:
            b.release(slot)
            raise
        return slot

    def fetch(self, slot: _Slot) -> np.ndarray:
        """Wait for a dispatched batch and return its host scores; the
        slot goes back to its bucket's ring."""
        try:
            if slot.event is not None:
                slot.event.synchronize()
            return slot.out.numpy().copy()
        finally:
            slot.bucket.release(slot)
