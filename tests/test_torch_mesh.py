"""The port's mesh over ranks ≡ JAX's device mesh.

``MeshSpec`` and ``factor_devices`` must give JAX's spec for every device
count 1..8 and three axis tuples (with and without a fixed axis).  Then
four real ranks (gloo on the CPU, one launch through
``tests/torch_ranks.py``) build three meshes — dp2×tp2, dp4 and dp1×tp4 —
and report each rank's coordinates, device and the members of each
axis group: rank ``r`` must sit where JAX puts device ``r`` in
``np.asarray(devices).reshape(spec.shape)``, and its group along an axis
must hold exactly the devices that share its other coordinates.  Without
a process group a mesh of one device needs nothing, and a larger one
refuses.  Tolerance: none.
"""

import json

import jax
import numpy as np
import pytest
import torch

from music_analyst_tpu.parallel import mesh as jmesh
from music_analyst_tpu_torch.parallel import mesh as tmesh
from tests.torch_ranks import launch_ranks

AXES = [("dp", "tp", "sp"), ("dp", "tp"), ("dp", "tp", "sp", "ep")]


@pytest.mark.parametrize("axes", AXES, ids="-".join)
@pytest.mark.parametrize("n", range(1, 9))
def test_factor_devices_equals_jax(n, axes):
    want = jmesh.factor_devices(n, axes)
    got = tmesh.factor_devices(n, axes)
    assert got.axes == want.axes
    assert (got.names, got.shape, got.size()) == (
        want.names, want.shape, want.size())
    if n % 2 == 0:
        assert (tmesh.factor_devices(n, axes, fixed={"tp": 2}).axes
                == jmesh.factor_devices(n, axes, fixed={"tp": 2}).axes)


def test_fixed_axis_that_does_not_divide_raises_like_jax():
    with pytest.raises(ValueError, match="does not divide"):
        jmesh.factor_devices(6, fixed={"tp": 4})
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.factor_devices(6, fixed={"tp": 4})


def test_one_device_mesh_without_a_group():
    mesh = tmesh.data_parallel_mesh(device="cpu")
    assert mesh.shape == {"dp": 1} and mesh.size == 1
    assert mesh.device == torch.device("cpu") and mesh.coords == {"dp": 0}
    assert mesh.group("dp") is None and mesh.group("tp") is None
    assert mesh.axis_size("tp") == 1 and mesh.coord("tp") == 0
    x = torch.arange(6)
    assert tmesh.all_reduce(x, mesh, "dp") is x
    assert tmesh.all_gather(x, mesh, "dp") is x
    assert tmesh.replicated(mesh, [1, 2]) == [1, 2]
    assert tmesh.batch_sharding(mesh, [1, 2, 3]) == [1, 2, 3]
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        tmesh.build_mesh(tmesh.MeshSpec((("dp", 2),)), device="cpu")


@pytest.mark.parametrize("rank", range(8))
def test_coordinates_and_batch_rows_follow_jax_layout(rank):
    """Rank r's coordinates are device r's index in JAX's mesh array, and
    its batch rows are that device's block of a P("dp") array."""
    spec = (("dp", 2), ("tp", 4))
    jm = jmesh.build_mesh(jmesh.MeshSpec(spec))
    index = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    mesh = tmesh.DeviceMesh((torch.device("cpu"),) * 8, spec, rank)
    assert tuple(mesh.coords.values()) == index[jax.devices()[rank].id]
    batch = np.arange(16)
    placed = jax.device_put(batch, jmesh.batch_sharding(jm))
    want = [s.data for s in placed.addressable_shards
            if s.device == jax.devices()[rank]][0]
    np.testing.assert_array_equal(tmesh.batch_sharding(mesh, batch), want)


_CHILD = r"""
import json, sys
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import torch.distributed as dist
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
mh.initialize(f"localhost:{port}", n, rank, timeout_s=60)
out = {}
for spec in ([("dp", 2), ("tp", 2)], [("dp", 4)], [("dp", 1), ("tp", 4)]):
    m = M.build_mesh(M.MeshSpec(tuple(map(tuple, spec))), device="cpu")
    x = M.all_reduce(M.torch.tensor([rank + 1]), m, "tp")
    out[json.dumps(spec)] = dict(
        coords=m.coords, device=str(m.device), devices=len(m.devices),
        groups={a: dist.get_process_group_ranks(g) for a, g in m.groups.items()},
        tp_sum=int(x), dp_rows=M.all_gather(M.torch.tensor([rank]), m, "dp").tolist())
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    outs = launch_ranks(_CHILD, 4, [], tmp_path_factory.mktemp("mesh"))
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


@pytest.mark.parametrize("spec", [[["dp", 2], ["tp", 2]], [["dp", 4]],
                                  [["dp", 1], ["tp", 4]]],
                         ids=["dp2xtp2", "dp4", "dp1xtp4"])
@pytest.mark.parametrize("rank", range(4))
def test_rank_groups_match_jax_device_layout(four_ranks, spec, rank):
    names = tuple(a for a, _ in spec)
    shape = tuple(s for _, s in spec)
    jm = jmesh.build_mesh(jmesh.MeshSpec(tuple(map(tuple, spec))),
                          devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    got = four_ranks[rank][json.dumps(spec)]
    where = tuple(int(i) for i in np.argwhere(ids == rank)[0])
    assert tuple(got["coords"][a] for a in names) == where
    assert got["device"] == "cpu" and got["devices"] == 4
    for i, axis in enumerate(names):
        line = np.moveaxis(ids, i, -1)[
            tuple(c for j, c in enumerate(where) if j != i)]
        if shape[i] == 1:
            assert axis not in got["groups"]
        else:
            assert got["groups"][axis] == sorted(int(d) for d in line)
    tp_line = (np.moveaxis(ids, names.index("tp"), -1)[
        tuple(c for j, c in enumerate(where) if j != names.index("tp"))]
        if "tp" in names else [rank])
    assert got["tp_sum"] == sum(int(d) + 1 for d in tp_line)
    dp_line = np.moveaxis(ids, 0, -1)[tuple(where[1:])]
    assert got["dp_rows"] == [int(d) for d in dp_line]
