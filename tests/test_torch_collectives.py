"""The port's collective byte accounting ≡ the JAX package's.

``music_analyst_tpu_torch/profiling/collectives.py`` against
``music_analyst_tpu/profiling/collectives.py``: the estimators over a
grid of payloads and participant counts, the counters, ``collective``
events and ``collective_stage_table`` of one ``record_collective``
sequence, the unknown-kind error, and the rows the histogram layouts
record (stage, kind, axis, calls, devices) for the same input on a
one-device mesh in each package.  Payload bytes of the histogram rows
differ by design: JAX buckets the vocabulary, the port does not.
Tolerance: none (integer arithmetic).
"""

import json

import numpy as np
import pytest
import torch

from music_analyst_tpu.ops import histogram as jh
from music_analyst_tpu.parallel.mesh import data_parallel_mesh as jax_mesh
from music_analyst_tpu.profiling import collectives as jc
from music_analyst_tpu.telemetry import configure as jax_configure
from music_analyst_tpu.telemetry import get_telemetry as jax_telemetry
from music_analyst_tpu_torch import profiling as port_profiling
from music_analyst_tpu_torch.ops import histogram as th
from music_analyst_tpu_torch.parallel.mesh import data_parallel_mesh
from music_analyst_tpu_torch.profiling import collectives as tc
from music_analyst_tpu_torch.telemetry import configure, get_telemetry

torch.set_num_threads(1)

PAYLOADS = (0, 1, 7, 1000, 4096, 12_345, 1 << 26)
KINDS = ("psum", "all_gather", "all_to_all", "ppermute")


@pytest.fixture(autouse=True)
def _fresh():
    """Clean registries and empty stage tables in both packages."""
    for mod in (jc, tc):
        with mod._STAGE_LOCK:
            mod._STAGE_TOTALS.clear()
    jax_configure(enabled=True, directory=None)
    configure(enabled=True, directory=None)
    yield
    jax_configure(enabled=True, directory=None)
    configure(enabled=True, directory=None)
    for mod in (jc, tc):
        with mod._STAGE_LOCK:
            mod._STAGE_TOTALS.clear()


def _estimate(mod, kind, payload, n):
    if kind == "ppermute":
        return mod.ppermute_bytes(payload)
    return getattr(mod, f"{kind}_bytes")(payload, n)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_estimators_equal_jax(kind, n_devices):
    for payload in PAYLOADS:
        assert (_estimate(tc, kind, payload, n_devices)
                == _estimate(jc, kind, payload, n_devices)), payload


def test_package_exports_equal_jax():
    from music_analyst_tpu import profiling as jax_profiling

    names = {n for n in jax_profiling.__all__ if n in dir(jc)}
    assert names <= set(port_profiling.__all__)
    for name in names:
        assert getattr(port_profiling, name) is getattr(tc, name)


def test_unknown_kind_error_matches_jax():
    errors = []
    for mod in (jc, tc):
        with pytest.raises(ValueError) as info:
            mod.record_collective("s", "broadcastify", payload_bytes=1,
                                  n_devices=2)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "unknown collective kind 'broadcastify'" in errors[1]


SEQUENCES = {
    "psum_and_ppermute": [
        ("stage_a", "psum", dict(payload_bytes=4096, n_devices=8)),
        ("stage_b", "ppermute", dict(payload_bytes=64, n_devices=8, count=10)),
    ],
    "every_kind_repeated_stage": [
        ("merge", "psum", dict(payload_bytes=1000, n_devices=3, axis="dp")),
        ("gather", "all_gather", dict(payload_bytes=77, n_devices=4,
                                      axis="sp")),
        ("shuffle", "all_to_all", dict(payload_bytes=4097, n_devices=4,
                                       axis="ep")),
        ("merge", "psum", dict(payload_bytes=1000, n_devices=3, axis="dp")),
        ("ring", "ppermute", dict(payload_bytes=33_554_432, n_devices=4,
                                  axis="sp", count=3)),
        ("one_device", "psum", dict(payload_bytes=8, n_devices=1)),
    ],
}


def _events(path, name):
    return [ev["attrs"] for ev in map(json.loads, path.read_text().splitlines())
            if ev.get("name") == name]


def _run_sequence(mod, tel, seq, directory):
    with tel.run_scope("x", str(directory)):
        returned = [mod.record_collective(stage, kind, **kw)
                    for stage, kind, kw in seq]
        counters = {k: v for k, v in tel.counters.items()
                    if k.startswith("collectives.")}
        table = mod.stage_table()
    log = directory / "telemetry.jsonl"
    return dict(returned=returned, counters=counters, table=table,
                events=_events(log, "collective"),
                emitted=_events(log, "collective_stage_table"),
                after=mod.stage_table())


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_record_sequence_equals_jax(tmp_path, name):
    seq = SEQUENCES[name]
    want = _run_sequence(jc, jax_telemetry(), seq, tmp_path / "jax")
    got = _run_sequence(tc, get_telemetry(), seq, tmp_path / "port")
    assert got == want
    # The run end emitted the table once and cleared it.
    assert got["emitted"] == [{"rows": got["table"]}]
    assert got["after"] == []


def _rows(directory):
    """(stage, kind, axis, count, devices) of each collective event and
    the emitted stage table without its bytes."""
    log = directory / "telemetry.jsonl"
    calls = [(e["stage"], e["kind"], e["axis"], e["count"], e["devices"])
             for e in _events(log, "collective")]
    (table,) = _events(log, "collective_stage_table")
    return calls, [{k: v for k, v in row.items() if k != "bytes"}
                   for row in table["rows"]]


def _histogram_layouts(pkg, mesh, ids, offsets, vocab):
    return {
        "device_ids": lambda: pkg.sharded_histogram(ids, vocab, mesh),
        "hostlocal": lambda: pkg.sharded_histogram_hostlocal_timed(
            ids, vocab, mesh),
        "streaming": lambda: pkg.sharded_histogram_streaming(
            ids, offsets, vocab, mesh, chunk_songs=3),
        "scalar_total": lambda: pkg.sharded_total(
            np.asarray([5, 6, 7], np.int64), mesh),
    }


@pytest.mark.parametrize("layout",
                         ["device_ids", "hostlocal", "streaming", "scalar_total"])
def test_histogram_records_jax_rows(tmp_path, layout):
    rng = np.random.default_rng(12)
    ids = rng.integers(-1, 300, size=4_000).astype(np.int32)
    offsets = np.linspace(0, ids.shape[0], 11).astype(np.int64)
    rows = {}
    for name, pkg, mesh, tel in (
            ("jax", jh, jax_mesh(1), jax_telemetry()),
            ("port", th, data_parallel_mesh(device="cpu"), get_telemetry())):
        directory = tmp_path / name
        with tel.run_scope("x", str(directory)):
            _histogram_layouts(pkg, mesh, ids, offsets, 300)[layout]()
        rows[name] = _rows(directory)
    assert rows["port"] == rows["jax"]
    assert rows["port"][0], "no collective recorded"


def test_analyze_run_emits_jax_stage_table(fixture_csv, tmp_path):
    """``analyze`` through each CLI on the fixture: the run end's stage
    table has JAX's stages, kinds, axes and call counts; the manifest
    counts the port's merge bytes on one device (zero)."""
    from music_analyst_tpu.cli.main import main as jax_main
    from music_analyst_tpu_torch.cli.main import main as port_main

    tables = {}
    for name, main, extra in (("jax", jax_main, ["--devices", "1"]),
                              ("port", port_main, ["--device", "cpu"])):
        out = tmp_path / name
        assert main(["analyze", str(fixture_csv), "--no-corpus-cache",
                     "--output-dir", str(out), *extra]) == 0
        tables[name] = _rows(out)[1]
    assert tables["port"] == tables["jax"]
    assert tables["port"]
    manifest = json.loads((tmp_path / "port" / "run_manifest.json").read_text())
    assert manifest["counters"]["collectives.total_bytes"] == 0
