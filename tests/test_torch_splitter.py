"""Port ``split`` and the dataset column splitter ≡ the JAX package's.

The ``split`` subcommand of both CLIs runs over the same CSVs (the
fixture, a generated 300-song CSV, a semicolon CSV with quoted cells and
short rows), with and without ``--no-header`` and with ``--delimiter``;
every output file must be byte-identical.  The analyze-side splitter
(``split_dataset_columns``, python and native) is held the same way.
Tolerance: none.
"""

import os

import pytest

from music_analyst_tpu.cli.main import main as jax_main
from music_analyst_tpu.data import splitter as js
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.data import splitter as ts
from music_analyst_tpu_torch.data.synthetic import generate_dataset


@pytest.fixture(scope="module")
def inputs(tmp_path_factory, fixture_csv):
    root = tmp_path_factory.mktemp("split_inputs")
    songs = root / "songs_300.csv"
    generate_dataset(str(songs), num_songs=300, seed=21)
    semi = root / "semi.csv"
    semi.write_text('name;"note; with sep";n\nA;"x ""q""";1\nB\nC;;;extra\n'
                    'Ünï;"line\nbreak";3\n', encoding="utf-8")
    return {"fixture": fixture_csv, "songs": songs, "semi": semi}


def _tree(path):
    return {name: (path / name).read_bytes() for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("flags", [[], ["--no-header"], ["--delimiter", ";"],
                                   ["--delimiter", ",", "--no-header"]],
                         ids=["default", "no-header", "semicolon",
                              "comma-no-header"])
@pytest.mark.parametrize("name", ["fixture", "songs", "semi"])
def test_split_cli_matches_jax(inputs, tmp_path, capsys, name, flags):
    src = str(inputs[name])
    jax_main(["split", src, "--output-dir", str(tmp_path / "jax"), *flags])
    jax_out = capsys.readouterr().out
    assert port_main(["split", src, "--output-dir", str(tmp_path / "port"),
                      "--no-telemetry", *flags]) == 0
    port_out = capsys.readouterr().out
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert port_out.replace("port", "jax") == jax_out


def test_split_collision_suffixes_and_force(tmp_path, capsys):
    src = tmp_path / "dup.csv"
    src.write_text("a,A,a b,\n1,2,3,4\n", encoding="utf-8")
    for tool, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / tool
        main(["split", str(src), "--output-dir", str(out)])
        main(["split", str(src), "--output-dir", str(out)])          # suffixes
        main(["split", str(src), "--output-dir", str(out), "--force"])
    capsys.readouterr()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.mark.parametrize("backend", ["python", "native"])
def test_dataset_splitter_matches_jax(inputs, tmp_path, backend):
    for name in ("fixture", "songs"):
        src = str(inputs[name])
        labels = ts.read_header_labels(src)
        assert labels == js.read_header_labels(src)
        bases = [ts.sanitize_header_name(x) for x in labels]
        assert bases == [js.sanitize_header_name(x) for x in labels]
        for mod, tool in ((ts, "port"), (js, "jax")):
            mod.split_dataset_columns(src, str(tmp_path / name / tool),
                                      *bases, *labels, backend=backend)
        assert _tree(tmp_path / name / "port") == _tree(tmp_path / name / "jax")


def test_sanitizers_match_jax():
    for text in ("artist", " Text\r\n", "a/b:c", "Ünï code", "", "x" * 100,
                 "tab\there", "-._ok"):
        assert ts.sanitize_header_name(text) == js.sanitize_header_name(text)
        assert ts.sanitize_filename(text) == js.sanitize_filename(text)
