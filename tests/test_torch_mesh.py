"""The port's mesh layer (``h2o3_tpu_torch/parallel``) against the JAX
package's on the suite's eight virtual XLA devices: ``make_mesh`` shapes
and its refusal, the partitioner's row bounds, chunk homes and process
map, ``padded_len``, ``logical_to_physical``, the ``H2O3_SPMD=0``
collapse, the collectives' fixed shard order and ``map_reduce`` /
``map_cols`` on the same numpy arrays. The port's meshes are of CPU
shards; its JAX counterparts' of virtual devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o
from h2o3_tpu.parallel import mesh as jm
from h2o3_tpu.parallel.map_reduce import map_cols as jmap_cols
from h2o3_tpu.parallel.map_reduce import map_reduce as jmap_reduce
from h2o3_tpu_torch.parallel import collectives
from h2o3_tpu_torch.parallel import mesh as tm
from h2o3_tpu_torch.parallel.map_reduce import map_cols as tmap_cols
from h2o3_tpu_torch.parallel.map_reduce import map_reduce as tmap_reduce
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-virtual-device test mesh")

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _restore_meshes(monkeypatch):
    """Each test's meshes and ``init``'s default device go back as they
    were."""
    from h2o3_tpu_torch import _device
    monkeypatch.setattr(_device, "_default", _device._default)
    old_t, old_j = tm._MESH, jm._MESH
    yield
    tm.set_mesh(old_t)
    jm.set_mesh(old_j)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 1),
                                   (None, 1), (None, 2)])
def test_make_mesh_shapes_match_jax(shape):
    nd, nmod = shape
    j = jm.make_mesh(n_data=nd, n_model=nmod)
    t = tm.make_mesh(n_data=nd, n_model=nmod, devices=CPU8)
    assert t.shape == dict(j.shape)
    assert t.devices.shape == j.devices.shape
    assert t.size == j.size
    assert tm.n_data_shards(t) == jm.n_data_shards(j)
    assert tm.n_model_shards(t) == jm.n_model_shards(j)


@pytest.mark.parametrize("shape", [(16, 1), (5, 2), (3, 3)])
def test_make_mesh_refusal_matches_jax(shape):
    with pytest.raises(ValueError) as ej:
        jm.make_mesh(n_data=shape[0], n_model=shape[1])
    with pytest.raises(ValueError) as et:
        tm.make_mesh(n_data=shape[0], n_model=shape[1], devices=CPU8)
    assert str(et.value) == str(ej.value)


def test_cpu_shards_are_virtual_and_a_missing_card_raises():
    """Without a device list a CPU mesh is as many host shards as asked
    for; a mesh that names a card not there raises."""
    th2o.init(device="cpu", n_data=4)
    mesh = tm.current_mesh()
    assert mesh.shape == {"data": 4, "model": 1}
    assert all(d.type == "cpu" for d in mesh.devices.reshape(-1))
    th2o.init(device="cpu")
    assert tm.current_mesh().shape == {"data": 1, "model": 1}
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError, match=missing):
        tm.make_mesh(n_data=1, devices=[missing])
    with pytest.raises(NotImplementedError, match="item 20"):
        th2o.init(device="cpu", port=54321)


@pytest.mark.parametrize("nrow", [1, 7, 8, 63, 64, 65, 1000, 1003, 4096])
@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_padded_len_and_row_bounds_match_jax(nrow, nd):
    j = jm.make_mesh(n_data=nd, devices=jax.devices()[:nd])
    t = tm.make_mesh(n_data=nd, devices=["cpu"] * nd)
    assert tm.padded_len(nrow, t) == jm.padded_len(nrow, j)
    plen = tm.padded_len(nrow, t)
    assert (tm.partitioner(t).row_bounds(plen)
            == jm.partitioner(j).row_bounds(plen))


@pytest.mark.parametrize("nd", [1, 3, 4, 8])
def test_chunk_home_and_shard_process_match_jax(nd):
    pj = jm.partitioner(jm.make_mesh(n_data=nd, devices=jax.devices()[:nd]))
    pt = tm.partitioner(tm.make_mesh(n_data=nd, devices=["cpu"] * nd))
    for n_chunks in (1, 3, nd, 4 * nd + 1):
        assert ([pt.chunk_home(k, n_chunks) for k in range(n_chunks)]
                == [pj.chunk_home(k, n_chunks) for k in range(n_chunks)])
    for nproc in (None, 1, 2, 4):
        if nproc and nd % nproc and nproc > nd:
            continue
        assert ([pt.shard_process(s, nproc) for s in range(nd)]
                == [pj.shard_process(s, nproc) for s in range(nd)])
    assert pt.home_device(nd - 1) == torch.device("cpu")
    assert len(pt.shard_devices(0)) == 1


@pytest.mark.parametrize("axes", [("rows",), ("rows", "features"),
                                  ("features", "rows"), ("rows", "rows"),
                                  ("bins",), ("trees", "classes"),
                                  ("features", "features", "rows")])
def test_logical_to_physical_matches_jax(axes):
    assert tm.logical_to_physical(axes) == tuple(jm.logical_to_physical(axes))


def test_spmd_zero_collapses_the_default_mesh(monkeypatch):
    """After tests/test_spmd_parity.py's escape hatch: H2O3_SPMD=0
    collapses the lazily built default mesh to one device; an explicit
    shape still wins."""
    monkeypatch.setenv("H2O3_SPMD", "0")
    assert not tm.spmd_enabled() and not jm.spmd_enabled()
    tm.set_mesh(None)
    jm.set_mesh(None)
    assert tm.current_mesh().shape == dict(jm.current_mesh().shape) \
        == {"data": 1, "model": 1}
    assert tm.make_mesh(n_data=4, devices=["cpu"] * 4).shape["data"] == 4
    assert dict(jm.make_mesh(n_data=4).shape)["data"] == 4


def test_shard_rows_places_padded_blocks():
    mesh = tm.make_mesh(n_data=4, devices=["cpu"] * 4)
    part = tm.partitioner(mesh)
    arr = np.arange(32, dtype=np.float32)[:, None]
    blocks = part.shard_rows(arr)
    assert [tuple(b.shape) for b in blocks] == [(8, 1)] * 4
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), arr)
    assert len(tm.data_sharding(mesh).place(arr)) == 4
    assert all(b.shape == (32, 1)
               for b in tm.replicated_sharding(mesh).place(arr))
    with pytest.raises(ValueError, match="not divisible"):
        part.shard_rows(np.zeros((30, 1), np.float32))


def test_psum_is_the_shard_order_sum():
    """acc = s0; acc += s1; ...: bit for bit the left-to-right float32
    sum, repeated, the result on every shard; one shard passes through
    untouched."""
    rng = np.random.default_rng(3)
    xs = [torch.as_tensor((rng.normal(size=(5, 7))
                           * 10.0 ** rng.integers(-3, 4)).astype(np.float32))
          for _ in range(6)]
    ref = xs[0].numpy().copy()
    for x in xs[1:]:
        ref = (ref + x.numpy()).astype(np.float32)
    mesh = tm.make_mesh(n_data=6, devices=["cpu"] * 6)
    out = collectives.psum(xs, mesh)
    assert len(out) == 6
    for o in out:
        np.testing.assert_array_equal(o.numpy(), ref)
    np.testing.assert_array_equal(
        collectives.pmax(xs, mesh)[0].numpy(),
        np.max(np.stack([x.numpy() for x in xs]), axis=0))
    np.testing.assert_array_equal(
        collectives.pmin(xs, mesh, lead_only=True)[0].numpy(),
        np.min(np.stack([x.numpy() for x in xs]), axis=0))
    assert collectives.psum(xs[:1])[0] is xs[0]
    with collectives.timing() as rec:
        collectives.psum(xs, mesh)
    assert len(collectives.elapsed_ms(rec)) == 1
    with pytest.raises(ValueError, match="model"):
        collectives.psum(xs, mesh, axis="model")


def _local_sum(x):
    return jnp.sum(x, axis=0)


def _local_max(x):
    return jnp.max(x, axis=0)


def _local_min(x):
    return jnp.min(x, axis=0)


@pytest.mark.parametrize("nd", [4, 8])
def test_map_reduce_matches_jax(nd):
    """sum, max and min over the data shards of the same numpy array
    (integer-valued floats: every order gives the same sum); a pytree of
    arrays (which the JAX combinator takes only as a single array)
    against numpy."""
    rng = np.random.default_rng(nd)
    x = rng.integers(-50, 50, size=(64, 3)).astype(np.float32)
    w = rng.integers(0, 3, size=64).astype(np.float32)
    jmesh = jm.make_mesh(n_data=nd, devices=jax.devices()[:nd])
    tmesh = tm.make_mesh(n_data=nd, devices=["cpu"] * nd)
    for op, jf, tf in (("sum", _local_sum, lambda s: s.sum(dim=0)),
                       ("max", _local_max, lambda s: s.amax(dim=0)),
                       ("min", _local_min, lambda s: s.amin(dim=0))):
        jr = jmap_reduce(jf, jnp.asarray(x), op, mesh=jmesh)
        tr = tmap_reduce(tf, x, op, mesh=tmesh)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    t = tmap_reduce(lambda s: {"s": s["x"].sum(dim=0),
                               "n": (s["w"].sum(), s["w"].amax())},
                    {"x": x, "w": w}, mesh=tmesh)
    np.testing.assert_array_equal(t["s"].numpy(), x.sum(axis=0))
    assert float(t["n"][0]) == w.sum() and isinstance(t["n"], tuple)
    with pytest.raises(ValueError, match="reduce_op"):
        tmap_reduce(lambda s: s.sum(), x, "prod", tmesh)


def _scale(x):
    return x * 2.0 + 1.0


def test_map_cols_matches_jax():
    x = np.arange(48, dtype=np.float32).reshape(24, 2) / 7.0
    jmesh = jm.make_mesh(n_data=4, devices=jax.devices()[:4])
    tmesh = tm.make_mesh(n_data=4, devices=["cpu"] * 4)
    j = jmap_cols(_scale, jnp.asarray(x), mesh=jmesh)
    t = tmap_cols(lambda s: s * 2.0 + 1.0, x, mesh=tmesh)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    pair = tmap_cols(lambda s: (s[:, 0], s[:, 1] + 1), x, mesh=tmesh)
    np.testing.assert_array_equal(pair[1].numpy(), x[:, 1] + 1)
