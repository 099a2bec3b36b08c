"""The port's multi-process coordination ≡ the JAX package's semantics.

``music_analyst_tpu_torch/parallel/multihost.py`` in one process (no
process group: every call gives the trivial result, as JAX's do with one
process, and the same result as JAX's on the same payload), then in two
real processes over gloo on the CPU: one launch of two ranks runs every
case, writes its results as JSON, and the parametrised checks below read
them.  Byte payloads are empty, non-ASCII, binary and uneven in length
across ranks.  A rank whose peer has exited must get an error from its
next collective within the group's timeout, not hang.
"""

import json

import numpy as np
import pytest

from music_analyst_tpu.parallel import multihost as jax_mh
from music_analyst_tpu_torch.parallel import multihost as mh
from tests.torch_ranks import launch_ranks

PAYLOADS = {
    "empty": b"",
    "ascii": b"love heart night",
    "non_ascii": "héllo wörld ✓ 日本".encode("utf-8"),
    "binary": bytes(range(256)) * 3,
}


# ------------------------------------------------------------ one process


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_one_process_bytes_equal_jax(name):
    payload = PAYLOADS[name]
    assert mh.allgather_bytes(payload) == jax_mh.allgather_bytes(payload)
    assert mh.allgather_bytes(payload) == [payload]
    assert mh.broadcast_bytes(payload) == jax_mh.broadcast_bytes(payload)


def test_one_process_trivial_results():
    assert (mh.process_count(), mh.process_index(), mh.is_coordinator()) == (
        jax_mh.process_count(), jax_mh.process_index(),
        jax_mh.is_coordinator()) == (1, 0, True)
    value = {"a": [1, 2], "b": "x"}
    assert mh.broadcast_from_coordinator(value) is value
    assert mh.all_agree(3) and mh.all_agree(np.arange(4))
    mh.barrier("nothing to wait for")
    mh.shutdown()          # no group: a no-op
    assert mh.backend() is None and str(mh.transport_device()) == "cpu"
    with pytest.raises(ValueError, match="payload is None"):
        mh.broadcast_bytes(None)


def test_initialize_refuses_unknown_backend():
    with pytest.raises(ValueError, match="backend must be one of"):
        mh.initialize("localhost:1", 2, 0, backend="mpi")


# ------------------------------------------------------------ two ranks

_CHILD = r"""
import json, os, pathlib, sys, time
import numpy as np
rank, n, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from music_analyst_tpu_torch.parallel import multihost as mh
mh.initialize(f"localhost:{port}", n, rank, timeout_s=30)
hexs = lambda bs: [b.hex() for b in bs]
res = dict(count=mh.process_count(), index=mh.process_index(),
           coordinator=mh.is_coordinator(), backend=mh.backend(),
           device=str(mh.transport_device()))
mine = {
    "empty": b"",
    "non_ascii": ("héllo" if rank == 0 else "wörld ✓ 日本").encode(),
    "uneven": (b"a" * 1000) if rank == 0 else b"bcd",
    "one_empty": b"" if rank == 0 else bytes(range(256)),
}
res["allgather"] = {k: hexs(mh.allgather_bytes(v)) for k, v in mine.items()}
res["broadcast"] = {
    "non_ascii": mh.broadcast_bytes("ünïcode ✓".encode() if rank == 0 else None).hex(),
    "empty": mh.broadcast_bytes(b"" if rank == 0 else None).hex(),
    "ignores_others": mh.broadcast_bytes(b"\x00\xff" if rank == 0 else b"zz").hex(),
}
res["broadcast_object"] = mh.broadcast_from_coordinator({"from": rank, "l": [rank]})
res["agree"] = {
    "same_bool": mh.all_agree(True),
    "same_array": mh.all_agree(np.arange(5)),
    "rank": mh.all_agree(rank),
    "shape": mh.all_agree(np.zeros(rank + 1)),
}
# barrier: every rank's marker exists once the barrier returns.
marker = pathlib.Path(out) / f"marker{rank}"
if rank == 1:
    time.sleep(0.5)
marker.write_text("x")
mh.barrier("markers")
res["barrier"] = all((pathlib.Path(out) / f"marker{r}").exists() for r in range(n))
(pathlib.Path(out) / f"result{rank}.json").write_text(json.dumps(res))
mh.barrier("written")
if rank == 1:
    os._exit(0)            # leave without a word: the peer must not hang
t0 = time.monotonic()
try:
    mh.allgather_bytes(b"anyone?")
    raised = None
except Exception as exc:
    raised = type(exc).__name__
(pathlib.Path(out) / "dead_peer.json").write_text(
    json.dumps(dict(raised=raised, seconds=time.monotonic() - t0)))
os._exit(0)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    launch_ranks(_CHILD, 2, [out], out / "logs", timeout=180)
    return [json.loads((out / f"result{r}.json").read_text()) for r in (0, 1)], \
        json.loads((out / "dead_peer.json").read_text())


@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_identity(two_ranks, rank):
    res = two_ranks[0][rank]
    assert (res["count"], res["index"], res["coordinator"]) == (2, rank, rank == 0)
    assert res["backend"] == "gloo" and res["device"] == "cpu"


_EXPECT_GATHER = {
    "empty": [b"", b""],
    "non_ascii": ["héllo".encode(), "wörld ✓ 日本".encode()],
    "uneven": [b"a" * 1000, b"bcd"],
    "one_empty": [b"", bytes(range(256))],
}


@pytest.mark.parametrize("case", sorted(_EXPECT_GATHER))
def test_two_ranks_allgather_bytes(two_ranks, case):
    want = [b.hex() for b in _EXPECT_GATHER[case]]
    assert [res["allgather"][case] for res in two_ranks[0]] == [want, want]


@pytest.mark.parametrize("case,want", [
    ("non_ascii", "ünïcode ✓".encode()),
    ("empty", b""),
    ("ignores_others", b"\x00\xff"),
])
def test_two_ranks_broadcast_bytes(two_ranks, case, want):
    assert [res["broadcast"][case] for res in two_ranks[0]] == [want.hex()] * 2


def test_two_ranks_broadcast_from_coordinator(two_ranks):
    assert [res["broadcast_object"] for res in two_ranks[0]] == \
        [{"from": 0, "l": [0]}] * 2


@pytest.mark.parametrize("case,want", [
    ("same_bool", True), ("same_array", True), ("rank", False),
    ("shape", False),
])
def test_two_ranks_all_agree(two_ranks, case, want):
    assert [res["agree"][case] for res in two_ranks[0]] == [want, want]


def test_two_ranks_barrier(two_ranks):
    assert [res["barrier"] for res in two_ranks[0]] == [True, True]


def test_dead_peer_raises_within_timeout(two_ranks):
    dead = two_ranks[1]
    assert dead["raised"] is not None
    assert dead["seconds"] < 60
