"""The GLM on the card: the coordinate-descent kernel against its plain
version, and small trains on the card against the same trains on the
CPU.

- ``cd_elastic_net`` (``csrc/glm_cd.cu``) equal in value to
  ``cd_elastic_net_plain`` run on the card on the same inputs (both
  round every product and sum alone, in the same order), at P = 10, 669
  (the airlines width), 1500 and 5000 (several entries a thread) and
  9000 (past shared memory: the global workspace, no prefetch), with the
  non-negativity flags and box bounds; one launch counted a solve.
- A binomial elastic-net train and a lambda search on the card: the
  kernel launched, coefficients within atol 2e-4 + rtol 2e-4 of the CPU
  train, the path's nonzero counts equal past λ_max; the multinomial by
  coordinate descent the same.
- TF32 allowed by the caller changes no coefficient bit (the GLM runs
  its products in full float32) and is restored after.

Every test needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -m gpu
tests/test_torch_glm_cuda.py``."""
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
from h2o3_tpu_torch.ops import glm_cd, kernels
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

COEF_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def gram_inputs(P, seed, dev):
    rng = np.random.default_rng(seed)
    n = max(2 * P, 200)
    X = rng.normal(size=(n, P)).astype(np.float32)
    w = rng.uniform(0.2, 1.5, n).astype(np.float32)
    z = (X @ rng.normal(size=P) + rng.normal(size=n)).astype(np.float32)
    Xt = torch.as_tensor(X, device=dev)
    wt = torch.as_tensor(w, device=dev)
    G = Xt.t() @ (Xt * wt[:, None])
    b = (Xt * wt[:, None]).t() @ torch.as_tensor(z, device=dev)
    pen = torch.ones(P, device=dev)
    pen[-1] = 0.0
    beta0 = torch.as_tensor((0.01 * rng.normal(size=P)).astype(np.float32),
                            device=dev)
    return G.contiguous(), b.contiguous(), beta0, pen


@pytest.mark.gpu
@pytest.mark.parametrize("P,sweeps", [(10, 10), (669, 10), (1500, 2),
                                      (5000, 1), (9000, 1)])
@pytest.mark.parametrize("mode", ["plain", "non-negative", "nn-mask-box"])
def test_cd_kernel_equals_plain(cuda, P, sweeps, mode):
    G, b, beta0, pen = gram_inputs(P, P + len(mode), cuda)
    lam1 = float(0.05 * torch.max(torch.abs(b)))
    kw = {}
    if mode == "non-negative":
        kw["non_negative"] = True
    if mode == "nn-mask-box":
        nn = torch.zeros(P, device=cuda)
        nn[::3] = 1.0
        lo = torch.full((P,), -float("inf"), device=cuda)
        hi = torch.full((P,), float("inf"), device=cuda)
        lo[1::5], hi[1::5] = -0.01, 0.02
        hi[2::7] = -0.001
        kw.update(nn_mask=nn, lo=lo, hi=hi)
    before = kernels.LAUNCHES["cd_elastic_net"]
    got = glm_cd.cd_elastic_net(G, b, beta0, lam1, 2.0, pen, sweeps, **kw)
    assert kernels.LAUNCHES["cd_elastic_net"] == before + 1
    torch.cuda.synchronize()
    want = glm_cd.cd_elastic_net_plain(G, b, beta0, lam1, 2.0, pen, sweeps,
                                       **kw)
    assert torch.equal(got, want)
    assert int((got != 0).sum()) > 0


def draw(rows, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    c = rng.choice(np.array(["a", "b", "c", "d", "e"], dtype=object), rows)
    eta = 0.6 * np.nan_to_num(X[:, 0]) - 0.4 * np.nan_to_num(X[:, 1]) \
        + 0.5 * (c == "c")
    cols = {f"x{i}": X[:, i] for i in range(6)}
    cols["c"] = c
    y = rng.random(rows) < 1 / (1 + np.exp(-eta))
    cols["y"] = np.where(y, "Y", "N").astype(object)
    k = np.searchsorted(np.quantile(eta, [0.33, 0.66]), eta)
    cols["k"] = np.array(["p", "q", "r"], dtype=object)[k]
    return cols


def both(cols, y, **params):
    out = []
    for dev in ("cpu", "cuda"):
        fr = th2o.Frame.from_numpy(cols, device=dev)
        other = "k" if y == "y" else "y"
        out.append(H2OGeneralizedLinearEstimator(
            ignored_columns=[other], **params).train(
                y=y, training_frame=fr).model)
    return out


def same_coef(a, b):
    ca, cb = a.coef(), b.coef()
    if isinstance(next(iter(ca.values())), dict):
        for k in ca:
            np.testing.assert_allclose(list(cb[k].values()),
                                       list(ca[k].values()), **COEF_TOL)
    else:
        np.testing.assert_allclose(list(cb.values()), list(ca.values()),
                                   **COEF_TOL)


@pytest.mark.gpu
def test_card_trains_like_the_cpu(cuda):
    cols = draw(20_000)
    before = kernels.LAUNCHES["cd_elastic_net"]
    cpu, card = both(cols, "y", family="binomial", alpha=0.5, Lambda=1e-3)
    assert kernels.LAUNCHES["cd_elastic_net"] > before
    same_coef(cpu, card)
    cpu, card = both(cols, "y", family="binomial", alpha=0.5,
                     lambda_search=True, nlambdas=6)
    for a, b in list(zip(cpu.output["lambda_path"],
                         card.output["lambda_path"]))[1:]:
        assert a["nonzero"] == b["nonzero"]
    same_coef(cpu, card)
    before = kernels.LAUNCHES["cd_elastic_net"]
    cpu, card = both(cols, "k", family="multinomial", alpha=0.5,
                     Lambda=1e-3, max_iterations=6)
    assert kernels.LAUNCHES["cd_elastic_net"] > before
    same_coef(cpu, card)


@pytest.mark.gpu
def test_tf32_changes_no_coefficient(cuda):
    cols = draw(50_000, seed=1)
    fr = th2o.Frame.from_numpy(cols, device="cuda")
    fit = dict(family="binomial", ignored_columns=["k"])
    plain = H2OGeneralizedLinearEstimator(**fit).train(
        y="y", training_frame=fr).model
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = H2OGeneralizedLinearEstimator(**fit).train(
            y="y", training_frame=fr).model
        mm = torch.backends.cuda.matmul
        # the caller's setting is back (read through the API this torch
        # keeps: reading allow_tf32 after fp32_precision was set raises)
        assert (mm.fp32_precision == "tf32" if hasattr(mm, "fp32_precision")
                else mm.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert tf32.coef() == plain.coef()
