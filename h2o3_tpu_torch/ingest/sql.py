"""SQL table import (H2O's ``SQLManager.importSqlTable``).

Counterpart of ``h2o3_tpu/ingest/sql.py``. Any Python DB-API connection
factory takes the place of H2O's JDBC connection (``sqlite3`` in the
tests). With an integer key column the table is fetched in key ranges
(and its NULL keys once more) on a thread pool of ``ingest_workers``
threads, one connection each; without one, in a single full fetch,
since LIMIT and OFFSET without an ORDER BY give no row order. Columns of
numbers and NULLs become float64 columns, any other an enum of its
labels.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.log import warn


def import_sql_table(connection_factory: Callable, table: str,
                     columns: Optional[Sequence[str]] = None,
                     key_column: Optional[str] = None,
                     fetch_chunks: int = 4, device=None) -> Frame:
    """``table`` (its ``columns``, or all) as a Frame on ``device`` (the
    ``init`` default, else ``cuda``), through DB-API connections from
    ``connection_factory``, a fresh one a fetch. ``key_column`` (an
    integer column) splits the fetch into ``fetch_chunks`` key ranges;
    a fetched row count that differs from ``COUNT(*)`` warns."""
    dev = _device.resolve(device)
    cols_sql = ", ".join(columns) if columns else "*"
    con = connection_factory()
    try:
        cur = con.cursor()
        cur.execute(f"SELECT {cols_sql} FROM {table} LIMIT 1")
        names = [d[0] for d in cur.description]
        cur.execute(f"SELECT COUNT(*) FROM {table}")
        nrow = int(cur.fetchone()[0])
        ranges: List[tuple] = []
        if key_column:
            cur.execute(f"SELECT MIN({key_column}), MAX({key_column}) "
                        f"FROM {table}")
            lo, hi = cur.fetchone()
            if lo is None or hi is None:
                # empty table or all-NULL keys: single full fetch
                key_column = None
        if key_column:
            lo, hi = int(lo), int(hi)
            span = max((hi - lo + 1) // max(fetch_chunks, 1), 1)
            s = lo
            while s <= hi:
                ranges.append(("key", s, min(s + span - 1, hi)))
                s += span
            # BETWEEN never matches NULL keys — fetch them explicitly
            ranges.append(("nullkey", 0, 0))
        else:
            # parallel LIMIT/OFFSET without a key column is unsound
            # (row order per query is undefined without ORDER BY), so
            # fall back to ONE full fetch — SQLManager requires a key
            # range for its chunking too
            ranges.append(("all", 0, 0))
    finally:
        con.close()

    # integer bounds are interpolated (they originate here, not from
    # user input) to stay DB-API paramstyle-agnostic: sqlite wants '?',
    # psycopg2/mysql want '%s'
    def fetch(rg) -> List[tuple]:
        c = connection_factory()
        try:
            cu = c.cursor()
            if rg[0] == "key":
                cu.execute(
                    f"SELECT {cols_sql} FROM {table} WHERE {key_column} "
                    f"BETWEEN {int(rg[1])} AND {int(rg[2])}")
            elif rg[0] == "nullkey":
                cu.execute(f"SELECT {cols_sql} FROM {table} "
                           f"WHERE {key_column} IS NULL")
            else:
                cu.execute(f"SELECT {cols_sql} FROM {table}")
            return cu.fetchall()
        finally:
            c.close()

    if len(ranges) > 1:
        from h2o3_tpu_torch.ingest.parse import ingest_workers
        with cf.ThreadPoolExecutor(
                max_workers=min(len(ranges), ingest_workers())) as ex:
            parts = list(ex.map(fetch, ranges))
    else:
        parts = [fetch(r) for r in ranges]
    rows = [r for p in parts for r in p]
    if len(rows) != nrow:
        warn("import_sql_table: fetched %d rows but COUNT(*)=%d "
             "(concurrent writes?)", len(rows), nrow)
    data: Dict[str, np.ndarray] = {}
    for j, n in enumerate(names):
        vals = [r[j] for r in rows]
        if all(v is None or isinstance(v, (int, float)) for v in vals):
            data[n] = np.asarray(
                [np.nan if v is None else float(v) for v in vals])
        else:
            data[n] = np.asarray(
                [None if v is None else str(v) for v in vals],
                dtype=object)
    fr = Frame.from_numpy(data, device=dev)
    fr.key = table
    return fr
