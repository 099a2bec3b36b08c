"""The port's distributed word count ≡ the JAX package's, in 1, 2 and 3
processes.

``music_analyst_tpu_torch/parallel/distributed.py:distributed_wordcount``
in one process against JAX's in-process ``distributed_wordcount`` on the
same CSV: ``word_counts.csv``, ``top_artists.csv`` and
``performance_metrics.json`` byte-identical, timings aside.  Then one
launch of 2 ranks and one of 3 ranks (uneven record slices) over gloo on
the CPU, each over ``tests/fixtures/mini_songs.csv`` and a 300-song seeded
corpus: the coordinator's CSVs must be byte-identical to JAX's
single-process output, every rank must report the same totals, and the
metrics must carry one ``per_chip`` row per process.  The 2-rank launch
also runs with the native partitioner hidden from rank 1: the ranks must
agree on the Python partitioner and still write the same bytes.
Tolerance: none (integer counts, exact bytes).
"""

import json

import pytest

from music_analyst_tpu.parallel.distributed import (
    distributed_wordcount as jax_distributed_wordcount,
)
from music_analyst_tpu_torch.data.synthetic import generate_dataset
from music_analyst_tpu_torch.parallel.distributed import distributed_wordcount
from tests.torch_ranks import launch_ranks

FILES = ("word_counts.csv", "top_artists.csv")
DATASETS = ("mini", "seeded300")
# Timing fields of performance_metrics.json: measured, so never equal.
TIMED = ("compute_time", "total_time")


def _untimed(metrics):
    out = {k: v for k, v in metrics.items() if k not in TIMED}
    out["per_chip"] = [{k: v for k, v in row.items() if k != "compute_seconds"}
                       for row in metrics["per_chip"]]
    return out


@pytest.fixture(scope="module")
def datasets(tmp_path_factory, fixture_csv):
    d = tmp_path_factory.mktemp("distributed_data")
    seeded = d / "songs300.csv"
    generate_dataset(str(seeded), num_songs=300, seed=21)
    return {"mini": fixture_csv, "seeded300": seeded}


@pytest.fixture(scope="module")
def jax_outputs(datasets, tmp_path_factory):
    """JAX's single-process output per dataset: (result, file bytes,
    metrics)."""
    outs = {}
    for name, path in datasets.items():
        out = tmp_path_factory.mktemp(f"jax_{name}")
        result = jax_distributed_wordcount(str(path), output_dir=str(out))
        outs[name] = (result, {f: (out / f).read_bytes() for f in FILES},
                      json.loads((out / "performance_metrics.json").read_text()))
    return outs


@pytest.mark.parametrize("dataset", DATASETS)
def test_one_process_equals_jax(datasets, jax_outputs, tmp_path, dataset):
    result = distributed_wordcount(str(datasets[dataset]),
                                   output_dir=str(tmp_path), device="cpu")
    want_result, want_files, want_metrics = jax_outputs[dataset]
    assert result == want_result
    for f in FILES:
        assert (tmp_path / f).read_bytes() == want_files[f], f
    metrics = json.loads((tmp_path / "performance_metrics.json").read_text())
    assert _untimed(metrics) == _untimed(want_metrics)
    assert set(metrics["compute_time"]) == set(want_metrics["compute_time"])


_CHILD = r"""
import json, sys
rank, n, port, spec = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from music_analyst_tpu_torch.parallel import multihost
from music_analyst_tpu_torch.parallel.distributed import distributed_wordcount
multihost.initialize(f"localhost:{port}", n, rank, timeout_s=60)
runs = json.loads(spec)
for run in runs:
    if run.get("hide_native_on") == rank:
        from music_analyst_tpu_torch.data import native
        native.available = lambda: False
    result = distributed_wordcount(run["dataset"], output_dir=run["out"],
                                   device="cpu")
    print("RESULT " + json.dumps(dict(run=run["name"], **result)), flush=True)
multihost.shutdown()
"""

LAUNCHES = (2, 3)


@pytest.fixture(scope="module")
def launched(datasets, tmp_path_factory):
    """One launch per rank count; returns {np: (per-rank results by run,
    output dirs by run)}."""
    out = {}
    for n in LAUNCHES:
        base = tmp_path_factory.mktemp(f"np{n}")
        runs = [dict(name=name, dataset=str(path), out=str(base / name))
                for name, path in datasets.items()]
        if n == 2:
            runs.append(dict(name="mixed_native", dataset=str(datasets["mini"]),
                             out=str(base / "mixed_native"), hide_native_on=1))
        stdouts = launch_ranks(_CHILD, n, [json.dumps(runs)], base / "logs",
                               timeout=240)
        results = [{r["run"]: r for r in
                    (json.loads(line[len("RESULT "):])
                     for line in s.splitlines() if line.startswith("RESULT "))}
                   for s in stdouts]
        out[n] = (results, {r["name"]: base / r["name"] for r in runs})
    return out


RUNS = [(n, d) for n in LAUNCHES for d in DATASETS] + [(2, "mixed_native")]


def _source(run):
    return "mini" if run == "mixed_native" else run


@pytest.mark.parametrize("n,run", RUNS)
@pytest.mark.parametrize("name", FILES)
def test_ranks_write_jax_bytes(launched, jax_outputs, n, run, name):
    _, dirs = launched[n]
    assert (dirs[run] / name).read_bytes() == jax_outputs[_source(run)][1][name]


@pytest.mark.parametrize("n,run", RUNS)
def test_every_rank_reports_the_totals(launched, jax_outputs, n, run):
    results, _ = launched[n]
    want = dict(jax_outputs[_source(run)][0], processes=n, run=run)
    assert [res[run] for res in results] == [want] * n


@pytest.mark.parametrize("n,run", RUNS)
def test_metrics_have_one_row_per_process(launched, jax_outputs, n, run):
    _, dirs = launched[n]
    metrics = json.loads((dirs[run] / "performance_metrics.json").read_text())
    want = _untimed(jax_outputs[_source(run)][2])
    assert metrics["processes"] == n
    assert metrics["device_platform"] == want["device_platform"]
    assert (metrics["total_songs"], metrics["total_words"]) == (
        want["total_songs"], want["total_words"])
    samples = [row["compute_seconds"] for row in metrics["per_chip"]]
    assert [row["process"] for row in metrics["per_chip"]] == list(range(n))
    assert all(s > 0 for s in samples)
    assert metrics["total_time"]["avg_seconds"] >= \
        metrics["compute_time"]["avg_seconds"]
