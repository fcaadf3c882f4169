"""Row chunks of a design matrix that stays on the host: the out-of-core
(memory-pressure) GBM's data path.

Counterpart of ``h2o3_tpu/models/streaming.py``. Where a frame's design
matrix passes the device budget (``memman``), the GBM keeps it on the
host and grows each tree over row chunks (``models/tree.py``
``grow_tree_binned_streamed`` and ``grow_tree_adaptive_streamed``). The
chunks are those of the JAX package at the same budget, cut from the
same formula, so a level's histogram is the same sum of the same
chunks' histograms, added in chunk order.

- **The resident window.** The first ``R`` chunks keep their features
  (packed codes, or float32 features on the adaptive path), y, w, the
  margin and the node ids on the device for the whole train: uploaded
  once a train, the features only when a pass first reads them. Their
  margins update there with the dense GBM's float32 expression, so a
  train whose window holds the whole frame in one chunk is bit-equal to
  the dense train.
- **The overflow chunks** go to the device once a level pass. On
  ``cuda`` each one is copied into one of two pinned host staging
  buffers, then onto the device on a side stream; chunk k+1's copy is
  issued before chunk k's level kernel runs on the compute stream (the
  stream the kernels launch on). CUDA events order the two streams: the
  compute stream waits for a chunk's copy before its kernel, the side
  stream for the kernels that read a device buffer before it overwrites
  it, and the host for a copy out of a staging buffer before it refills
  it. The small per-row vectors (margin, y, w, node id: 16 bytes a row)
  ride along from pinned host arrays, and the new node ids and margins
  go back into them asynchronously; each pass starts by having the side
  stream wait for the work queued before it. On the CPU every copy is a
  view.
- **Sampling.** ``begin_tree`` draws one ``uniform(key, rows)`` over all
  rows on the device (the port's copy of the JAX generator), which each
  chunk slices.

``profile()`` reports the chunking and the bytes moved
(``model.output["stream_profile"]``); on ``cuda`` also the copies' own
time on the side stream (``copy_ms``), the time the compute stream
waited for them (``copy_wait_ms``), the share of the copies' time it
did not wait for (``unwaited_copy_share``: a copy that ends while the
host stages the next chunk counts as unwaited, the device busy or
idle, so this is no overlap with the kernels; a profiler's device
time says that), and the host's seconds in the staging copies. The cancel and preempt hooks
(``cancel_check``, ``interrupt_check``) stay None until the port has
jobs (ROADMAP.md item 18).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.ops.random import uniform

# the share of the memman budget the resident window may claim (headroom
# for histograms, split tables and scratch)
_RESIDENT_SHARE = 0.8


class StreamCancelled(RuntimeError):
    """A cancel seen by ``cancel_check`` at the start of a level pass."""


def _apply_leaf(margin, lr: float, value, nid):
    """``margin + lr · value[nid]``: the dense GBM's margin update, in
    the same float32 expression."""
    return margin + lr * value[nid.long()]


class _ChunkHandle:
    """One chunk's view in a level pass: features, node ids, and the
    (g, h, w) triple from the chunk's current margin."""

    __slots__ = ("mgr", "k", "s", "e", "X", "nid", "_margin", "_y", "_wt")

    def __init__(self, mgr: "StreamedChunks", k: int, X, nid, margin, y,
                 wt):
        self.mgr = mgr
        self.k = k
        self.s, self.e = mgr.spans[k]
        self.X = X
        self.nid = nid
        self._margin = margin
        self._y = y
        self._wt = wt

    def ghw(self, dist) -> torch.Tensor:
        """[3, rows_c] float32: (g·wt, h·wt, wt), as the dense GBM feeds
        its grower."""
        g, h = dist.grad_hess(self._margin, self._y)
        return torch.stack([g * self._wt, h * self._wt, self._wt]).to(
            torch.float32).contiguous()

    def put_nid(self, nid2: torch.Tensor) -> None:
        if self.mgr.is_resident(self.k):
            self.mgr._res[self.k]["nid"] = nid2
        else:
            self.mgr._to_host(nid2, self.mgr.nid_h, self.s, self.e)

    def apply_leaf(self, lr: float, value: torch.Tensor, nid) -> None:
        new = _apply_leaf(self._margin, lr, value, nid)
        if self.mgr.is_resident(self.k):
            self.mgr._res[self.k]["margin"] = new
        else:
            self.mgr._to_host(new, self.mgr.margin_h, self.s, self.e)


class StreamedChunks:
    """A train's chunks: the resident window and the streamed overflow
    (module docstring). ``X_host`` is [rows, F]: packed codes (int8 or
    int16, NA in lane ``packed_W - 1``) or float32 features."""

    def __init__(self, X_host: np.ndarray, y_host: np.ndarray,
                 w_host: np.ndarray, f0: float, chunk_rows: int,
                 device, padded_rows: Optional[int] = None,
                 margin0: Optional[np.ndarray] = None,
                 packed_W: Optional[int] = None):
        from h2o3_tpu_torch import memman
        rows, F = X_host.shape
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        # the dense grower's histogram-precision rule reads the frame's
        # row count: a one-chunk train makes the dense train's choice
        self.padded_rows = int(padded_rows) if padded_rows else rows
        self.rows, self.F = rows, F
        self.packed_W = packed_W
        self._x_itemsize = int(X_host.dtype.itemsize)
        self.X_host = X_host
        self.spans: List[Tuple[int, int]] = [
            (s, min(s + chunk_rows, rows)) for s in range(0, rows, chunk_rows)]
        self.C = len(self.spans)
        budget = memman.manager().budget
        # features + y/w/margin/nid/sample-weight working vectors
        per_row = F * self._x_itemsize + 5 * 4
        window = int(budget * _RESIDENT_SHARE)
        if rows * per_row <= window:
            R = self.C
        else:
            # the two stream buffers the overflow pipeline needs
            window -= 2 * chunk_rows * F * self._x_itemsize
            R = max(0, window // max(chunk_rows * per_row, 1))
        self.R = int(min(R, self.C))
        ro = os.environ.get("H2O3_STREAM_RESIDENT")
        if ro is not None and ro != "":
            self.R = max(0, min(int(ro), self.C))
        self._res: Dict[int, Dict[str, torch.Tensor]] = {}
        # host mirrors of the small per-row vectors (pinned on cuda: the
        # overflow chunks' copies are asynchronous). ``margin0`` is a
        # resumed checkpoint's exact float32 margin.
        m0 = (np.asarray(margin0, np.float32)[:rows] if margin0 is not None
              else np.full(rows, np.float32(f0), np.float32))
        self.y_h = self._host(np.asarray(y_host, np.float32))
        self.w_h = self._host(np.asarray(w_host, np.float32))
        self.margin_h = self._host(m0)
        self.nid_h = self._host(np.zeros(rows, np.int32))
        self._u = None                 # this tree's row draw, on the device
        self._rate = 1.0
        self.h2d_bytes = 0
        self.h2d_resident_bytes = 0    # the once-a-train window upload
        self.cancel_check = None
        self.interrupt_check = None
        self.staging_s = 0.0
        self._timing: List[Tuple[torch.cuda.Event, ...]] = []
        if self.cuda and self.R < self.C:
            self._init_pipeline(min(chunk_rows, rows))

    # -- buffers ---------------------------------------------------------

    def _host(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.cuda else t.clone()

    def _init_pipeline(self, cr: int) -> None:
        """Two slots, each a pinned staging buffer for a chunk's features
        and device buffers for its features and small vectors, plus the
        side stream and the events that order it."""
        dev, F = self.dev, self.F
        xdt = torch.from_numpy(self.X_host[:1]).dtype
        self._side = torch.cuda.Stream(dev)
        self._stage_x = [torch.empty((cr, F), dtype=xdt, pin_memory=True)
                         for _ in range(2)]
        self._dev_x = [torch.empty((cr, F), dtype=xdt, device=dev)
                       for _ in range(2)]
        self._dev_f = [torch.empty((3, cr), dtype=torch.float32, device=dev)
                       for _ in range(2)]           # margin, y, w
        self._dev_n = [torch.empty(cr, dtype=torch.int32, device=dev)
                       for _ in range(2)]
        for t in self._dev_x + self._dev_f + self._dev_n:
            t.record_stream(self._side)
        self._copied = [torch.cuda.Event() for _ in range(2)]
        self._consumed = [torch.cuda.Event() for _ in range(2)]

    def is_resident(self, k: int) -> bool:
        return k < self.R

    def _to_host(self, t: torch.Tensor, host: torch.Tensor, s: int,
                 e: int) -> None:
        """Write a chunk's device vector into its host mirror (on cuda
        asynchronously, on the compute stream)."""
        host[s:e].copy_(t, non_blocking=self.cuda)

    def _upload(self, t: torch.Tensor, resident: bool = False):
        """A host tensor onto the device, counted."""
        nbytes = t.numel() * t.element_size()
        self.h2d_bytes += nbytes
        if resident:
            self.h2d_resident_bytes += nbytes
        if not self.cuda:
            return t
        return t.to(self.dev, non_blocking=True)

    def _ensure_resident(self, k: int, need_x: bool = True
                         ) -> Dict[str, torch.Tensor]:
        st = self._res.get(k)
        s, e = self.spans[k]
        if st is None:
            st = {"X": None,
                  "y": self._upload(self.y_h[s:e], resident=True),
                  "w": self._upload(self.w_h[s:e], resident=True),
                  "margin": self._upload(self.margin_h[s:e], resident=True),
                  "nid": torch.zeros(e - s, dtype=torch.int32,
                                     device=self.dev)}
            self._res[k] = st
        if need_x and st["X"] is None:
            # deferred until a pass reads features: a depth-0 train never
            # uploads them
            st["X"] = self._upload(torch.from_numpy(self.X_host[s:e]),
                                   resident=True)
        return st

    # -- per tree --------------------------------------------------------

    def begin_tree(self, key, sample_rate: float) -> None:
        """Draw the tree's row sample (``uniform(key, rows) <
        sample_rate``, over all rows at once) and reset every node id to
        the root."""
        if self.cuda:
            # the last pass's node ids may still be on their way home
            torch.cuda.current_stream(self.dev).synchronize()
        self._u = None
        if sample_rate < 1.0 and key is not None:
            self._u = uniform(key, (self.rows,), self.dev)
        self._rate = float(sample_rate)
        for k, st in self._res.items():
            s, e = self.spans[k]
            st["nid"] = torch.zeros(e - s, dtype=torch.int32,
                                    device=self.dev)
        self.nid_h.zero_()

    def _wt(self, k: int, w: torch.Tensor) -> torch.Tensor:
        if self._u is None:
            return w
        s, e = self.spans[k]
        return w * (self._u[s:e] < self._rate).to(w.dtype)

    # -- level passes ----------------------------------------------------

    def interrupt_pending(self) -> bool:
        """True where a cancel or a preempt is pending: the fused
        L-level driver then clamps its window to one level. Never
        raises."""
        for check in (self.cancel_check, self.interrupt_check):
            if check is not None and check():
                return True
        return False

    def _stage(self, k: int, need_x: bool):
        """Issue chunk k's copies (overflow only): (X or None, margin, y,
        w, nid) on the device, and on cuda the slot and its events."""
        s, e = self.spans[k]
        n = e - s
        self.h2d_bytes += n * 16 + (n * self.F * self._x_itemsize
                                    if need_x else 0)
        if not self.cuda:
            X = torch.from_numpy(self.X_host[s:e]) if need_x else None
            return (X, self.margin_h[s:e], self.y_h[s:e], self.w_h[s:e],
                    self.nid_h[s:e], None)
        slot = (k - self.R) % 2
        side = self._side
        if need_x:
            t0 = time.perf_counter()
            # the host refills a staging buffer only once its last copy
            # to the device is done
            self._copied[slot].synchronize()
            self._stage_x[slot][:n].copy_(torch.from_numpy(self.X_host[s:e]))
            self.staging_s += time.perf_counter() - t0
        c0 = torch.cuda.Event(enable_timing=True)
        c1 = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            # the device buffers of this slot: free once the kernels of
            # the chunk that used them last have run
            side.wait_event(self._consumed[slot])
            c0.record(side)
            X = None
            if need_x:
                X = self._dev_x[slot][:n]
                X.copy_(self._stage_x[slot][:n], non_blocking=True)
            f = self._dev_f[slot][:, :n]
            f[0].copy_(self.margin_h[s:e], non_blocking=True)
            f[1].copy_(self.y_h[s:e], non_blocking=True)
            f[2].copy_(self.w_h[s:e], non_blocking=True)
            nid = self._dev_n[slot][:n]
            nid.copy_(self.nid_h[s:e], non_blocking=True)
            c1.record(side)
            self._copied[slot].record(side)
        return X, f[0], f[1], f[2], nid, (slot, c0, c1)

    def level_pass(self, need_x: bool = True):
        """Yield a ``_ChunkHandle`` per chunk, in chunk order. An
        overflow chunk's copies are issued one chunk ahead, so that they
        run under the previous chunk's kernels. ``need_x=False`` (the
        passes that read no feature) stages no features."""
        if self.cancel_check is not None and self.cancel_check():
            # at a pass's start only: a pass under way, the leaf pass
            # among them, always completes
            raise StreamCancelled("training cancelled between tree levels")
        if self.cuda and self.R < self.C:
            # the side stream starts after what is queued: the last
            # pass's node ids and margins written back to the host
            self._side.wait_stream(torch.cuda.current_stream(self.dev))
        pending: Dict[int, tuple] = {}

        def stage(k: int) -> None:
            if self.R <= k < self.C and k not in pending:
                pending[k] = self._stage(k, need_x)

        stage(self.R)
        for k in range(self.C):
            stage(k + 1)
            if self.is_resident(k):
                st = self._ensure_resident(k, need_x=need_x)
                yield _ChunkHandle(self, k, st["X"], st["nid"], st["margin"],
                                   st["y"], self._wt(k, st["w"]))
                continue
            X, mg, yv, wv, nid, ev = pending.pop(k)
            if ev is not None:
                cur = torch.cuda.current_stream(self.dev)
                w0 = torch.cuda.Event(enable_timing=True)
                w1 = torch.cuda.Event(enable_timing=True)
                w0.record(cur)
                cur.wait_event(ev[2])
                w1.record(cur)
                self._timing.append((ev[1], ev[2], w0, w1))
            yield _ChunkHandle(self, k, X, nid, mg, yv, self._wt(k, wv))
            if ev is not None:
                # everything the consumer queued for this chunk reads the
                # slot before this point
                self._consumed[ev[0]].record(
                    torch.cuda.current_stream(self.dev))

    # -- finalize --------------------------------------------------------

    def gather_margin(self) -> np.ndarray:
        """The whole float32 margin on the host (the resident chunks
        fetched here, once)."""
        for k, st in self._res.items():
            s, e = self.spans[k]
            self._to_host(st["margin"], self.margin_h, s, e)
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        return self.margin_h.numpy()

    def profile(self) -> Dict[str, object]:
        out = {"chunks": self.C, "resident_chunks": self.R,
               "chunk_rows": (self.spans[0][1] - self.spans[0][0]
                              if self.spans else 0),
               "h2d_bytes": int(self.h2d_bytes),
               "h2d_resident_bytes": int(self.h2d_resident_bytes),
               "device_footprint_bytes": int(
                   self.rows * self.F * self._x_itemsize),
               "packed_codes": self.packed_W is not None,
               "x_itemsize": self._x_itemsize}
        if self.cuda and self._timing:
            torch.cuda.synchronize(self.dev)
            copy_ms = sum(c0.elapsed_time(c1) for c0, c1, _w0, _w1
                          in self._timing)
            wait_ms = sum(w0.elapsed_time(w1) for _c0, _c1, w0, w1
                          in self._timing)
            out.update(copy_ms=copy_ms, copy_wait_ms=wait_ms,
                       unwaited_copy_share=(1.0 - wait_ms / copy_ms
                                            if copy_ms > 0 else None),
                       staging_s=self.staging_s)
        return out
