"""The port's real-weight validation harness, on the JAX harness's cases.

``tests/test_validate_weights.py``'s cases, run through
``music_analyst_tpu_torch.engines.validate`` on the CPU with the same
crafted tiny HF checkpoints: the oracle is ``transformers``' own torch
modules, so these tests also hold the port's configs to HF configs that
consume the checkpoints exactly.  Labels are compared exactly (agreement
1.0 where the classifier head is scaled far from the Neutral threshold);
logits of the tied-embedding Llama within 1e-3, as in the JAX test.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from test_distilbert_checkpoint import (  # noqa: E402
    _hf_state_dict as distil_state_dict,
)
from test_llama_checkpoint import (  # noqa: E402
    _hf_state_dict as llama_state_dict,
)

from music_analyst_tpu.engines.validate import (  # noqa: E402
    run_validation as jax_run_validation,
)
from music_analyst_tpu.models.distilbert import (  # noqa: E402
    DistilBertConfig as JaxDistilBertConfig,
)
from music_analyst_tpu_torch.cli.main import main  # noqa: E402
from music_analyst_tpu_torch.engines.validate import (  # noqa: E402
    build_llama_oracle,
    run_validation,
)
from music_analyst_tpu_torch.models import llama as tl  # noqa: E402
from music_analyst_tpu_torch.models.distilbert import (  # noqa: E402
    DistilBertClassifier,
    DistilBertConfig,
)

torch.set_num_threads(1)


def _distil_ckpt(tmp_path):
    sd = distil_state_dict(JaxDistilBertConfig.tiny(), seed=3)
    # Push every non-empty text far from the 0.6 Neutral threshold so
    # bf16-vs-f32 noise cannot flip a label (the JAX test's scaling).
    sd["classifier.weight"] = sd["classifier.weight"] * 40
    sd["classifier.bias"] = torch.zeros_like(sd["classifier.bias"])
    path = tmp_path / "pytorch_model.bin"
    torch.save(sd, path)
    return path


def test_validate_distilbert_full_agreement(fixture_csv, tmp_path,
                                            monkeypatch):
    ckpt = _distil_ckpt(tmp_path)
    monkeypatch.setenv("MUSICAAL_DISTILBERT_CKPT", str(ckpt))
    out = tmp_path / "out"
    report = run_validation(str(fixture_csv), model="distilbert-tiny",
                            output_dir=str(out), quiet=True, device="cpu")
    assert report["rows"] > 0
    assert report["agreement"] == 1.0
    assert report["disagreements"] == []
    diag = sum(report["confusion_oracle_to_ours"][lab][lab]
               for lab in ("Positive", "Neutral", "Negative"))
    assert diag == report["rows"]
    on_disk = json.loads((out / "weight_validation.json").read_text())
    assert on_disk["agreement"] == 1.0
    # The JAX harness reports the same on the same checkpoint.
    want = jax_run_validation(str(fixture_csv), model="distilbert-tiny",
                              quiet=True)
    for key in ("rows", "agreement", "confusion_oracle_to_ours", "oracle"):
        assert report[key] == want[key], key


@pytest.mark.parametrize("model,weight_quant", [
    ("distilbert-tiny-int8", None),
    ("distilbert-tiny-packed", None),
    ("distilbert-tiny", "int8"),
])
def test_validate_covers_int8_and_packed_variants(fixture_csv, tmp_path,
                                                  monkeypatch, model,
                                                  weight_quant):
    """The quantized and packed execution paths against the same float
    oracle."""
    monkeypatch.setenv("MUSICAAL_DISTILBERT_CKPT",
                       str(_distil_ckpt(tmp_path)))
    monkeypatch.setenv("MUSICAAL_WQ_CACHE", str(tmp_path / "wq"))
    report = run_validation(str(fixture_csv), model=model, quiet=True,
                            weight_quant=weight_quant, device="cpu")
    assert report["agreement"] == 1.0, (model, report["disagreements"])


def test_validate_cli_gate(fixture_csv, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MUSICAAL_DISTILBERT_CKPT",
                       str(_distil_ckpt(tmp_path)))
    args = ["validate", str(fixture_csv), "--model", "distilbert-tiny",
            "--device", "cpu", "--output-dir", str(tmp_path / "out")]
    assert main(args + ["--min-agreement", "0.99"]) == 0
    assert (tmp_path / "out" / "weight_validation.json").exists()
    assert (tmp_path / "out" / "run_manifest.json").exists()
    # A bar above any agreement fails the gate.
    assert main(args + ["--min-agreement", "1.01"]) == 1
    assert "FAIL: agreement" in capsys.readouterr().err


def test_validate_llama(fixture_csv, tmp_path):
    cfg = tl.LlamaConfig.tiny(dtype="float32")
    sd = llama_state_dict(cfg, seed=5)
    # A sharded directory, the form real Llama weights arrive in: the
    # backend and the oracle must both merge the shards.
    ckpt = tmp_path / "ckpt_dir"
    ckpt.mkdir()
    keys = sorted(sd)
    torch.save({k: sd[k] for k in keys[::2]},
               ckpt / "pytorch_model-00001-of-00002.bin")
    torch.save({k: sd[k] for k in keys[1::2]},
               ckpt / "pytorch_model-00002-of-00002.bin")
    # An f32 backend, so ours-vs-oracle compares arithmetic, not bf16
    # rounding on random tiny weights.
    clf = tl.LlamaZeroShotClassifier(config=cfg, checkpoint_path=str(ckpt),
                                     device="cpu")
    assert clf.pretrained
    report = run_validation(str(fixture_csv), model="llama3-tiny",
                            checkpoint_path=str(ckpt), backend=clf,
                            quiet=True)
    assert report["rows"] > 0
    assert report["agreement"] == 1.0, report["disagreements"]


def test_validate_llama_tied_embeddings_oracle_logit_parity(tmp_path):
    cfg = tl.LlamaConfig.tiny(dtype="float32")
    sd = llama_state_dict(cfg, seed=6, tied=True)
    assert "lm_head.weight" not in sd
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save(sd, ckpt)
    hf = build_llama_oracle(str(ckpt), cfg)
    assert hf.config.tie_word_embeddings
    model = tl.LlamaModel(cfg)
    tl.load_hf_torch_checkpoint(model, str(ckpt))
    rng = np.random.default_rng(3)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
    pos = torch.arange(16).expand(2, 16)
    with torch.no_grad():
        ours, _ = model(ids, pos, tl.causal_mask(16, 16, 0))
        theirs = hf(ids).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_validate_requires_checkpoint(fixture_csv, monkeypatch):
    monkeypatch.delenv("MUSICAAL_DISTILBERT_CKPT", raising=False)
    with pytest.raises(RuntimeError, match="MUSICAAL_DISTILBERT_CKPT"):
        run_validation(str(fixture_csv), model="distilbert-tiny",
                       device="cpu")


def test_validate_rejects_weightless_models(fixture_csv):
    with pytest.raises(ValueError, match="mock"):
        run_validation(str(fixture_csv), model="mock", device="cpu")


def test_validate_oracle_catches_a_poisoned_path(fixture_csv, tmp_path):
    """The harness must be able to fail: flip the backend's head and the
    disagreement shows in the report."""
    ckpt = _distil_ckpt(tmp_path)
    clf = DistilBertClassifier(config=DistilBertConfig.tiny(),
                               checkpoint_path=str(ckpt), device="cpu")
    with torch.no_grad():
        clf.model.classifier.weight.neg_()
    report = run_validation(str(fixture_csv), model="distilbert-tiny",
                            checkpoint_path=str(ckpt), backend=clf,
                            quiet=True)
    assert report["agreement"] < 1.0
    assert report["disagreements"]


def test_validate_without_transformers_stops_clearly(fixture_csv, tmp_path,
                                                     monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        run_validation(str(fixture_csv), model="distilbert-tiny",
                       checkpoint_path=str(_distil_ckpt(tmp_path)),
                       device="cpu")
