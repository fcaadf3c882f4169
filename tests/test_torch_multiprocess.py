"""A mesh across processes: two gloo CPU processes of
``h2o3_tpu_torch.tools.multihost_worker`` form a process group, each
keeps its own data shard's rows and trains the packed GBM with its
histograms and leaf totals reduced across the processes. Both print the
same digest, and it is the digest of the same train on the in-process
(2, 1) mesh of CPU shards (the JAX package's tests/test_multihost.py)."""
import os
import socket
import subprocess
import sys

import pytest

from h2o3_tpu_torch.tools import multihost_worker
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, TREES = 3001, 3


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(120)
def test_two_gloo_processes_train_the_in_process_tree():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "h2o3_tpu_torch.tools.multihost_worker",
         str(i), "2", str(port), "--device", "cpu", "--rows", str(ROWS),
         "--trees", str(TREES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=100)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
    digests = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("DIGEST ")]
        assert lines, out
        digests.append(lines[-1].split()[1])
    assert digests[0] == digests[1], digests
    assert "coordinator=True" in outs[0] and "coordinator=False" in outs[1]
    assert "backend=gloo" in outs[0] and "'n_data': 2" in outs[0]
    assert digests[0] == multihost_worker.train_digest(2, "cpu", ROWS, TREES)
