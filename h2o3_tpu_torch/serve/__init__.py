"""h2o3_tpu_torch.serve — low-latency model serving on the card.

Counterpart of ``h2o3_tpu.serve``: deploy() captures one CUDA graph of
the predict per batch-size bucket, so steady-state serving captures
nothing and runs no eager predict; a micro-batching queue coalesces
concurrent row requests into padded device batches with admission
control, deadline lanes, per-request deadlines and a circuit breaker.
Served predictions bit-match ``Model.predict`` on the same rows. The
REST surface waits for ROADMAP.md queue 1, item 20.
"""
from h2o3_tpu_torch.serve.batcher import (ServeBadRequestError,
                                          ServeCircuitOpenError,
                                          ServeClosedError,
                                          ServeDeadlineError, ServeError,
                                          ServeLaneShedError,
                                          ServeOverloadedError)
from h2o3_tpu_torch.serve import lanes
from h2o3_tpu_torch.serve.circuit import CircuitBreaker
from h2o3_tpu_torch.serve.codec import RowCodec
from h2o3_tpu_torch.serve.registry import DEFAULT_BUCKETS, CompiledScorer
from h2o3_tpu_torch.serve.service import (Deployment, circuit_states, deploy,
                                          deployment, deployments,
                                          predict_columnar, predict_rows,
                                          shutdown_all, stats, undeploy)
from h2o3_tpu_torch.serve.stats import ServeStats

__all__ = [
    "CircuitBreaker", "CompiledScorer", "DEFAULT_BUCKETS", "Deployment",
    "RowCodec",
    "ServeBadRequestError", "ServeCircuitOpenError", "ServeClosedError",
    "ServeDeadlineError",
    "ServeError", "ServeLaneShedError", "ServeOverloadedError",
    "ServeStats",
    "circuit_states", "deploy",
    "deployment", "deployments", "lanes", "predict_columnar",
    "predict_rows", "shutdown_all", "stats",
    "undeploy",
]
