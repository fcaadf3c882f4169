"""``import_file`` onto the card gives the frame it gives on the CPU: the
same types, domains, device values bit for bit and host copies. Needs a
CUDA device (marked ``gpu``); imports nothing of JAX, so that it runs
where JAX is absent."""
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o

CSV = ('id,score,city,seen,note,big\n'
       '1,0.5,ames,2021-01-02,"a ""b""",16777217\n'
       'NA,NaN,"delhi,town",,n2,16777219\n'
       '3,-1.25,berlin,2021-03-04,NA,3\n')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_ingest_cuda.py)")
    return torch.device("cuda")


def _bits(a):
    return a.view({4: np.int32, 8: np.int64}[a.itemsize])


@pytest.mark.gpu
def test_cuda_frame_equals_the_cpu_frame(cuda, tmp_path):
    p = tmp_path / "mixed.csv"
    p.write_text(CSV)
    on_card = th2o.import_file(str(p), device=cuda)
    on_cpu = th2o.import_file(str(p), device="cpu")
    assert on_card.device.type == "cuda"
    assert on_card.types == on_cpu.types
    assert on_cpu.vec("big").host_data is not None
    for n in on_cpu.names:
        a, b = on_card.vec(n), on_cpu.vec(n)
        assert a.domain == b.domain
        if b.data is None:
            assert list(a.host_data) == list(b.host_data)
            continue
        assert a.data.device.type == "cuda"
        np.testing.assert_array_equal(_bits(a.data.cpu().numpy()),
                                      _bits(b.data.numpy()))
        if b.host_data is None:
            assert a.host_data is None
        else:
            np.testing.assert_array_equal(_bits(a.host_data),
                                          _bits(b.host_data))
