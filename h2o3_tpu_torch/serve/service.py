"""Model serving registry: deploy/undeploy/score/stats.

Counterpart of ``h2o3_tpu/serve/service.py``. ``deploy(key, model=...)``
builds the row codec's enum LUTs, captures one CUDA graph of the
predict per batch bucket on the card (``registry.CompiledScorer``) and
starts a micro-batcher — after deploy() returns, the steady-state
scoring path captures nothing and runs no eager predict.

One Deployment per model key; re-deploying an already-deployed key with
new knobs drains and replaces the old pipeline. Deploying by key alone
needs the keyed store, whose pin and the registry snapshot for warm
replicas wait for ROADMAP.md queue 1, item 18; the fleet's peer circuit
check waits for item 22.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from h2o3_tpu_torch.serve.batcher import MicroBatcher
from h2o3_tpu_torch.serve.circuit import CircuitBreaker
from h2o3_tpu_torch.serve.codec import RowCodec
from h2o3_tpu_torch.serve.registry import DEFAULT_BUCKETS, CompiledScorer
from h2o3_tpu_torch.serve.stats import ServeStats, merge_snapshots

__all__ = ["deploy", "undeploy", "deployment", "deployments",
           "predict_rows", "predict_columnar", "stats", "shutdown_all",
           "circuit_states", "Deployment"]

_DEPLOYMENTS: Dict[str, "Deployment"] = {}
_LOCK = threading.Lock()


class Deployment:
    def __init__(self, key: str, model, *, max_batch: int = 512,
                 max_delay_ms: float = 2.0, queue_limit: int = 8192,
                 timeout_ms: float = 10_000.0,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 circuit_failures: int = 5,
                 circuit_open_ms: float = 1000.0):
        if not hasattr(model, "_predict_matrix"):
            raise ValueError(
                f"model '{key}' has no batch predict path "
                f"(_predict_matrix) — only trained h2o3_tpu_torch models "
                f"can be deployed")
        if model.params.get("offset_column"):
            raise ValueError(
                "offset-trained models cannot be deployed for row "
                "serving: rows carry no offset column")
        buckets = tuple(sorted({int(b) for b in buckets}))
        if max_batch > max(buckets):
            raise ValueError(f"max_batch={max_batch} exceeds the largest "
                             f"bucket {max(buckets)}")
        # prune buckets bucket_for can never pick: batches cap at
        # max_batch rows, so anything past the smallest bucket >=
        # max_batch would only add dead capture time + memory
        cap = min(b for b in buckets if b >= max_batch)
        buckets = tuple(b for b in buckets if b <= cap)
        self.key = key
        self.model = model
        self.created = time.time()
        self.config = dict(max_batch=int(max_batch),
                           max_delay_ms=float(max_delay_ms),
                           queue_limit=int(queue_limit),
                           timeout_ms=float(timeout_ms),
                           buckets=list(buckets),
                           circuit_failures=int(circuit_failures),
                           circuit_open_ms=float(circuit_open_ms))
        self.codec = RowCodec(model)
        t0 = time.perf_counter()
        self.scorer = CompiledScorer(model, buckets=buckets)
        self.warm_seconds = time.perf_counter() - t0
        # output-contract validation (the warm run recorded the shape):
        # a classifier whose _predict_matrix yields a 1-D margin would
        # crash decode on EVERY request — reject at deploy instead
        if self.codec.nclasses > 1 and (
                self.scorer.out_ndim != 2
                or self.scorer.out_k != self.codec.nclasses):
            raise ValueError(
                f"model '{key}' ({getattr(model, 'algo', '?')}) "
                f"declares {self.codec.nclasses} classes but its "
                f"batch predict returns "
                f"{self.scorer.out_ndim}-D/"
                f"{self.scorer.out_k}-wide output — this algo's "
                f"predict() override is not row-servable")
        self.stats = ServeStats(model=key)
        # per-deployment circuit breaker: N consecutive device-stage
        # failures → open (fast 503 + Retry-After) → half-open probe
        self.breaker = CircuitBreaker(
            model=key, failure_threshold=circuit_failures,
            open_secs=float(circuit_open_ms) / 1000.0, stats=self.stats)
        self.batcher = MicroBatcher(
            encode=self.codec.encode, dispatch=self.scorer.score,
            fetch=self.scorer.fetch, decode=self.codec.decode_batch,
            stats=self.stats, bucket_for=self.scorer.bucket_for,
            max_batch=max_batch, max_delay_ms=max_delay_ms,
            queue_limit=queue_limit, default_timeout_ms=timeout_ms,
            breaker=self.breaker)

    def predict_rows(self, rows: Sequence[Dict[str, Any]],
                     timeout_ms: Optional[float] = None,
                     lane: Optional[str] = None
                     ) -> List[Dict[str, Any]]:
        """Score a list of row dicts through the micro-batcher. Requests
        larger than max_batch are split — the slices pipeline through
        consecutive ticks. ``lane`` is the deadline class."""
        mb = self.batcher.max_batch
        if len(rows) <= mb:
            return self.batcher.submit(rows, timeout_ms=timeout_ms,
                                       lane=lane)
        out: List[Dict[str, Any]] = []
        for s in range(0, len(rows), mb):
            out.extend(self.batcher.submit(rows[s: s + mb],
                                           timeout_ms=timeout_ms,
                                           lane=lane))
        return out

    def predict_columnar(self, rows: Sequence[Dict[str, Any]],
                         timeout_ms: Optional[float] = None,
                         lane: Optional[str] = None
                         ) -> Dict[str, List]:
        """Score rows and return COLUMN arrays (``{"predict": [...],
        "p<label>": [...]}`` — the H2O predictions-frame shape) from the
        batch's one vectorized decode instead of per-row dicts. Values
        bit-match ``predict_rows`` on the same rows."""
        mb = self.batcher.max_batch
        if len(rows) <= mb:
            return self.batcher.submit(rows, timeout_ms=timeout_ms,
                                       columnar=True, lane=lane)
        out: Dict[str, List] = {}
        for s in range(0, len(rows), mb):
            part = self.batcher.submit(rows[s: s + mb],
                                       timeout_ms=timeout_ms,
                                       columnar=True, lane=lane)
            if not out:
                out = part
            else:
                for c, vals in part.items():
                    out[c].extend(vals)
        return out

    def info(self) -> Dict[str, Any]:
        return {"model": self.key,
                "algo": getattr(self.model, "algo", "?"),
                "nclasses": self.codec.nclasses,
                "n_features": self.codec.n_features,
                "compiled_buckets": list(self.scorer.buckets),
                "graphed": self.scorer.graphed,
                "warm_seconds": round(self.warm_seconds, 3),
                "created": self.created,
                **self.config}

    def close(self):
        self.batcher.close()


def deploy(model_key: str, model=None, **config) -> Deployment:
    """Deploy a model for row serving. The model is passed directly
    (``Model.deploy()`` does); deploying a key alone needs the keyed
    store (ROADMAP.md queue 1, item 18). On the card a capture that
    fails raises here."""
    if model is None:
        raise NotImplementedError(
            f"deploy('{model_key}') without model=: deploying by key "
            f"needs the keyed store, not ported yet (ROADMAP.md queue 1, "
            f"item 18)")
    dep = Deployment(model_key, model, **config)
    with _LOCK:
        old = _DEPLOYMENTS.pop(model_key, None)
        _DEPLOYMENTS[model_key] = dep
    if old is not None:
        old.close()
    return dep


def undeploy(model_key: str) -> bool:
    with _LOCK:
        dep = _DEPLOYMENTS.pop(model_key, None)
    if dep is None:
        return False
    dep.close()
    return True


def deployment(model_key: str) -> Optional[Deployment]:
    with _LOCK:
        return _DEPLOYMENTS.get(model_key)


def deployments() -> List[Deployment]:
    with _LOCK:
        return list(_DEPLOYMENTS.values())


def _deployed(model_key: str) -> Deployment:
    dep = deployment(model_key)
    if dep is None:
        raise KeyError(f"model '{model_key}' is not deployed — "
                       f"serve.deploy('{model_key}', model=...) first")
    return dep


def predict_rows(model_key: str, rows: Sequence[Dict[str, Any]],
                 timeout_ms: Optional[float] = None,
                 lane: Optional[str] = None) -> List[Dict[str, Any]]:
    return _deployed(model_key).predict_rows(rows, timeout_ms=timeout_ms,
                                             lane=lane)


def predict_columnar(model_key: str, rows: Sequence[Dict[str, Any]],
                     timeout_ms: Optional[float] = None,
                     lane: Optional[str] = None) -> Dict[str, List]:
    return _deployed(model_key).predict_columnar(
        rows, timeout_ms=timeout_ms, lane=lane)


def circuit_states() -> List[Dict[str, Any]]:
    """Every deployment's circuit-breaker state in gossip shape (what a
    peer replica needs to shed load; the port's fleet waits for
    ROADMAP.md queue 1, item 22)."""
    return [dep.breaker.publish() for dep in deployments()]


def stats() -> Dict[str, Any]:
    per_model = {}
    for dep in deployments():
        per_model[dep.key] = {**dep.stats.snapshot(),
                              "pending_rows": dep.batcher.pending_rows,
                              "circuit": dep.breaker.snapshot()}
    return {"models": per_model,
            "total": merge_snapshots(list(per_model.values()))}


def shutdown_all():
    """Undeploy everything (test/interpreter teardown)."""
    for dep in deployments():
        undeploy(dep.key)
