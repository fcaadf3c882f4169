"""Per-chunk streamed host-to-device copy of a parse's columns.

Counterpart of ``h2o3_tpu/ingest/stream.py``, single card. Without it a
parse tokenizes every byte range, merges whole columns on the host and
only then copies each dtype group to the card, so the copy waits for
the slowest range and the merge passes over every numeric byte once
more. Here each range's numeric, time and enum columns, as soon as its
worker has encoded them, are packed into a float32 ``[rows, C]`` matrix
(in the worker, ``prepack_chunk``) and copied to the card while the
other ranges still tokenize; ``assemble`` concatenates them on the card.

On ``cuda`` the copies come from a small ring of pinned staging buffers,
allocated once a parse and reused, on a side CUDA stream: the consumer
thread copies a pack into the next free slot and enqueues its transfer
into a device buffer allocated on that stream, then records an event; a
slot is written again only after its event, which bounds the copies in
flight by the ring's size. ``assemble`` makes the current stream wait
for the side stream, marks the chunk buffers as used by it
(``record_stream``) and builds the columns there. A failed copy raises:
nothing falls back to the host merge quietly.

Enum codes ride the pack: chunk-local codes are below 2^24 and NA is -1,
exact in float32. The domain union stays on the host (domains are small
beside codes); the codes are remapped on the card through one lookup
table with a section of ``1 + len(domain)`` slots a chunk, slot 0 of each
holding ``ENUM_NA``, indexed by ``code + 1``: an NA code reads slot 0 and
no index is negative (a torch gather raises on one where the JAX package
clamps it).

Some columns take the host merge instead (``fallback_cols``), as in the
JAX package: integer columns with an exact int64 shadow in any chunk
(their values must come from the resolved int64), enum columns with a
chunk past the cardinality cap (they become strings) and enum columns
whose union passes ``MAX_ENUM_CARDINALITY``. String columns never
stream. Time columns keep their int64 host milliseconds, and integral
columns past float32's 24-bit mantissa their float64 host copy, decided
by the merge path's own rule (``_host_shadow``).

On the CPU the packs stay on the host and ``assemble`` builds each
column once (the JAX package's host-assemble mode): the same values, no
copies to count.

A per-chunk float64 to float32 conversion then a concatenation equals
the conversion of the concatenated column element for element, so a
streamed parse gives the unstreamed parse's frame bit for bit.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.vec import (ENUM_NA, T_ENUM, T_TIME, TIME_NA, Vec,
                                      _numeric_host_copy)
from h2o3_tpu_torch.ingest import chunk as chunk_mod

# pinned staging slots a parse reuses on cuda; also the bound on the
# copies in flight (a slot is refilled only after its copy's event)
RING_SLOTS = 3

_EXACT_F32_BOUND = float(1 << 24)   # integral values past this keep the
                                    # float64 host copy


class PrepackedChunk:
    """The float32 ``[rows, C]`` pack of one chunk's streamed columns,
    built in the worker thread, and each lane's finite |max| (-inf for
    time and enum lanes)."""
    __slots__ = ("mat", "fmax")

    def __init__(self, mat, fmax):
        self.mat = mat
        self.fmax = fmax


def prepack_chunk(col_ids, cols) -> PrepackedChunk:
    """Pack ``cols[i]`` for ``i`` in ``col_ids`` into the float32
    streaming matrix: numeric values converted, time as float64 seconds
    then float32 (``Vec.from_numpy``'s arithmetic), enum chunk-local
    codes, and NaN for an enum lane that came back as strings (the
    column then takes the host merge)."""
    rows = len(cols[col_ids[0]].data) if col_ids else 0
    mat = np.empty((rows, len(col_ids)), np.float32)
    fmax = np.full(len(col_ids), -np.inf)
    for j, i in enumerate(col_ids):
        c = cols[i]
        if c.vtype == T_TIME:
            ms = np.asarray(c.data, dtype=np.int64)
            mat[:, j] = np.where(ms == TIME_NA, np.nan, ms / 1000.0)
            continue
        if c.vtype == T_ENUM:
            mat[:, j] = c.data
            continue
        if c.data.dtype == object:
            mat[:, j] = np.nan
            continue
        f64 = c.data
        mat[:, j] = f64
        if c.fmax is not None:           # the native encoder reduced it
            fmax[j] = c.fmax
        elif f64.size:
            finite = np.isfinite(f64)
            if finite.any():
                with np.errstate(invalid="ignore"), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    fmax[j] = float(np.abs(f64[finite]).max())
    return PrepackedChunk(mat, fmax)


class ChunkDeviceStreamer:
    """Streams one parse's numeric, time and enum columns to ``device``
    a chunk at a time.

    ``add(k, cols, pack)`` is called from one consumer thread as the
    range workers finish (in any order; ``k`` is the range index, which
    is row order); ``assemble`` waits for the copies and returns a Vec
    per streamed column, keyed by the column's index in the setup,
    except ``fallback_cols``."""

    def __init__(self, col_ids: List[int], col_types: List[str],
                 device: torch.device):
        self.col_ids = list(col_ids)
        self.col_types = col_types
        self.device = device
        self.host_assemble = device.type != "cuda"
        self._chunks: Dict[int, object] = {}    # k -> host pack or device
        self._rows: Dict[int, int] = {}
        self._time_ms: Dict[int, Dict[int, np.ndarray]] = {}
        self._f64: Dict[int, Dict[int, np.ndarray]] = {}
        self._fmax: Dict[int, float] = {i: float("-inf") for i in col_ids}
        self._exact: set = set()
        self._domains: Dict[int, Dict[int, List[str]]] = {}
        self._enum_fb: set = set()
        self.add_seconds = 0.0        # copy work hidden under tokenize
        self.assemble_seconds = 0.0   # visible, after the last range
        self.h2d_bytes = 0
        self.discarded_bytes = 0
        self.ring_allocs = 0
        self._discarded = False
        if not self.host_assemble:
            self._stream = torch.cuda.Stream(device)
            # order the side stream after everything queued before the
            # parse on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(device))
            self._ring: List[Optional[torch.Tensor]] = [None] * RING_SLOTS
            self._events: List[Optional[torch.cuda.Event]] = \
                [None] * RING_SLOTS
            self._next = 0

    # -- per-chunk feed --------------------------------------------------

    def add(self, k: int, cols, pack: Optional[PrepackedChunk] = None
            ) -> None:
        """Take chunk ``k``'s columns and its worker-built pack (built
        here where there is none: a range the Python tokenizer read
        again joins late) and, on cuda, enqueue its copy."""
        if self._discarded:
            return
        t0 = time.perf_counter()
        if pack is None:
            pack = prepack_chunk(self.col_ids, cols)
        mat = pack.mat
        for j, i in enumerate(self.col_ids):
            c = cols[i]
            if c.vtype == T_TIME:
                self._time_ms.setdefault(i, {})[k] = np.asarray(
                    c.data, dtype=np.int64)
                continue
            if self.col_types[i] == T_ENUM:
                if c.vtype != T_ENUM:
                    self._enum_fb.add(i)
                elif i not in self._enum_fb:
                    self._domains.setdefault(i, {})[k] = list(
                        c.domain or ())
                continue
            if i in self._exact:
                continue
            if c.exact is not None:
                self._exact.add(i)
            if pack.fmax[j] > self._fmax[i]:
                self._fmax[i] = float(pack.fmax[j])
            self._f64.setdefault(i, {})[k] = c.data
        self._rows[k] = mat.shape[0]
        if self.host_assemble:
            self._chunks[k] = mat
        else:
            self._chunks[k] = self._copy(mat)
            self.h2d_bytes += mat.nbytes
        self.add_seconds += time.perf_counter() - t0

    def _copy(self, mat: np.ndarray) -> torch.Tensor:
        """Stage ``mat`` in the next ring slot (after that slot's last
        copy has finished) and enqueue its copy on the side stream into
        a device buffer allocated there."""
        s = self._next % len(self._ring)
        self._next += 1
        if self._events[s] is not None:
            self._events[s].synchronize()
        n = mat.size
        buf = self._ring[s]
        if buf is None or buf.numel() < n:
            # grown with an eighth of headroom: ranges differ a little
            buf = torch.empty(n + n // 8 + 1, dtype=torch.float32,
                              pin_memory=True)
            self._ring[s] = buf
            self.ring_allocs += 1
        staged = buf[:n].view(mat.shape)
        np.copyto(staged.numpy(), mat)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(mat.shape, dtype=torch.float32,
                              device=self.device)
            dev.copy_(staged, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._events[s] = ev
        return dev

    def discard(self) -> None:
        """Drop every streamed chunk (a parse that cuts its ranges
        again); the bytes already copied are counted in
        ``discarded_bytes``."""
        if not self.host_assemble:
            self._stream.synchronize()
        self.discarded_bytes += self.h2d_bytes
        self._discarded = True
        self._chunks.clear()
        self._time_ms.clear()
        self._f64.clear()
        self._domains.clear()

    # -- assembly --------------------------------------------------------

    @property
    def fallback_cols(self) -> set:
        """Columns the host merge finishes: exact int64 shadows, enum
        columns with a string chunk or a union past the cap."""
        return set(self._exact) | set(self._enum_fb)

    def _resolve_enum_unions(self) -> Dict[int, tuple]:
        """``{col: (union, [chunk domains in row order])}`` of every
        streamed enum column; a union past ``MAX_ENUM_CARDINALITY`` sends
        its column to the host merge instead."""
        unions: Dict[int, tuple] = {}
        for i in self.col_ids:
            if self.col_types[i] != T_ENUM or i in self._enum_fb:
                continue
            per = self._domains.get(i, {})
            doms = [per[k] for k in sorted(per)]
            union = sorted(set().union(*doms)) if doms else []
            if len(union) > chunk_mod.MAX_ENUM_CARDINALITY:
                self._enum_fb.add(i)
                continue
            unions[i] = (union, doms)
        return unions

    @staticmethod
    def _enum_remap_aux(union, doms):
        """The remap table: a section of ``1 + len(domain)`` slots a
        chunk, slot 0 ``ENUM_NA``; chunk ``k``'s code ``c`` reads
        ``lut[base[k] + 1 + c]``. ``(None, None)`` where every chunk's
        domain is the union already."""
        if all(d == union for d in doms):
            return None, None
        gidx = {lab: g for g, lab in enumerate(union)}
        luts, base, off = [], [], 0
        for d in doms:
            base.append(off)
            sec = np.empty(1 + len(d), np.int32)
            sec[0] = ENUM_NA
            for j, lab in enumerate(d):
                sec[1 + j] = gidx[lab]
            luts.append(sec)
            off += len(sec)
        return np.concatenate(luts), np.asarray(base, np.int64)

    def _host_shadow(self, i: int) -> Optional[np.ndarray]:
        """The float64 host copy where the column needs one, by the merge
        path's rule (``_numeric_host_copy`` over the whole column); the
        concatenation runs only for columns whose finite |max| passes
        2^24."""
        if not (np.isfinite(self._fmax[i])
                and self._fmax[i] > _EXACT_F32_BOUND):
            return None
        parts = [self._f64[i][k] for k in sorted(self._f64[i])]
        full = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return _numeric_host_copy(full, self.col_types[i])

    def _time_host(self, i: int) -> np.ndarray:
        parts = [self._time_ms[i][k] for k in sorted(self._time_ms[i])]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def assemble(self) -> Dict[int, Vec]:
        """Wait for the copies, build every streamed column and return
        them by column index (``fallback_cols`` left out)."""
        if self._discarded:
            raise RuntimeError("assemble after discard")
        t0 = time.perf_counter()
        order = sorted(self._chunks)
        nrow = sum(self._rows[k] for k in order)
        unions = self._resolve_enum_unions()
        keep = [(j, i) for j, i in enumerate(self.col_ids)
                if i not in self._exact and i not in self._enum_fb]
        if self.host_assemble:
            cols = self._assemble_host(order, nrow, keep)
        else:
            cols = self._assemble_cuda(order, nrow, keep)
        out: Dict[int, Vec] = {}
        for j, i in keep:
            vt = self.col_types[i]
            col = cols[j]
            if vt == T_ENUM:
                union, doms = unions[i]
                out[i] = Vec(self._remap(col, union, doms, order), T_ENUM,
                             domain=union)
            elif vt == T_TIME:
                out[i] = Vec(col, T_TIME, host_data=self._time_host(i))
            else:
                out[i] = Vec(col, vt, host_data=self._host_shadow(i))
        if not self.host_assemble:
            torch.cuda.current_stream(self.device).synchronize()
        self._f64.clear()
        self._chunks.clear()
        self.assemble_seconds = time.perf_counter() - t0
        return out

    def _assemble_host(self, order, nrow, keep) -> Dict[int, torch.Tensor]:
        """CPU: each kept lane's chunks concatenated into one float32
        ``[C, nrow]`` matrix, a column a row."""
        mats = [self._chunks[k] for k in order]
        group = np.empty((len(keep), nrow), np.float32)
        for r, (j, _i) in enumerate(keep):
            off = 0
            for m in mats:
                group[r, off:off + m.shape[0]] = m[:, j]
                off += m.shape[0]
        cols = torch.from_numpy(group).unbind(0)
        return {j: cols[r] for r, (j, _i) in enumerate(keep)}

    def _assemble_cuda(self, order, nrow, keep) -> Dict[int, torch.Tensor]:
        """cuda: the current stream waits for the side stream, then the
        chunks are concatenated and transposed there, a column a row."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(self._stream)
        devs = [self._chunks[k] for k in order]
        for d in devs:
            d.record_stream(cur)
        C = len(self.col_ids)
        full = (devs[0] if len(devs) == 1 else torch.cat(devs, 0)) \
            if devs else torch.empty((0, C), device=self.device)
        del devs
        self._chunks.clear()
        lanes = torch.tensor([j for j, _i in keep], dtype=torch.long,
                             device=self.device)
        group = full.index_select(1, lanes).t().contiguous()
        del full
        cols = group.unbind(0)
        return {j: cols[r] for r, (j, _i) in enumerate(keep)}

    def _remap(self, col: torch.Tensor, union, doms, order) -> torch.Tensor:
        """A streamed enum lane's chunk-local codes as codes of the
        union: the +1-shifted sectioned table, gathered where the lane
        lives."""
        codes = col.to(torch.int32)
        lut, base = self._enum_remap_aux(union, doms)
        if lut is None:
            return codes
        dev = col.device
        rows = torch.tensor([self._rows[k] for k in order],
                            dtype=torch.long, device=dev)
        chunk_of_row = torch.repeat_interleave(
            torch.arange(len(order), device=dev), rows)
        base_t = torch.as_tensor(base, device=dev)
        lut_t = torch.as_tensor(lut, device=dev)
        if dev.type == "cuda":
            self.h2d_bytes += lut.nbytes + base.nbytes + rows.numel() * 8
        idx = base_t[chunk_of_row] + 1 + codes.to(torch.long)
        return lut_t[idx]
