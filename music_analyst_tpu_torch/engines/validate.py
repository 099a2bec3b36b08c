"""Real-weight validation harness.

Counterpart of ``music_analyst_tpu/engines/validate.py``: once real
weights are available through ``MUSICAAL_DISTILBERT_CKPT`` /
``MUSICAAL_LLAMA_CKPT``, one command runs a dataset slice through the
port's backend and through an independent oracle built from the same
checkpoint file, and reports label agreement:

    MUSICAAL_DISTILBERT_CKPT=.../pytorch_model.bin \\
        python -m music_analyst_tpu_torch validate data.csv --model distilbert

The oracle is not this package's model code: its logits come from
HuggingFace ``transformers``' own ``DistilBertForSequenceClassification``
/ ``LlamaForCausalLM`` loaded with the checkpoint's state dict (on the
CPU), so a mapping or architecture fault of the port cannot cancel out.
``transformers`` is imported only when the oracle runs; without it the
command stops with an error that says so.  Token ids are shared (the
backend's tokenizer feeds both), so the report isolates the model path.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from music_analyst_tpu_torch.device import DeviceLike
from music_analyst_tpu_torch.utils.labels import SUPPORTED_LABELS

_ENV_BY_FAMILY = {
    "distilbert": "MUSICAAL_DISTILBERT_CKPT",
    "llama": "MUSICAAL_LLAMA_CKPT",
}


def _family(model: str) -> str:
    for family in _ENV_BY_FAMILY:
        if model.startswith(family):  # "llama" also covers "llama3*"
            return family
    raise ValueError(
        f"validate supports distilbert[-*] and llama[3*] models, got "
        f"{model!r} (mock/ollama have no checkpoint to validate)"
    )


def _transformers():
    try:
        import transformers
    except ImportError:
        raise RuntimeError(
            "validate needs the `transformers` package for its independent "
            "oracle, and it is not installed"
        ) from None
    return transformers


def _oracle_distilbert_labels(
    checkpoint_path: str, clf, texts: Sequence[str]
) -> List[str]:
    """Labels from transformers' own DistilBERT given the same checkpoint,
    the same token ids, and the same 2 → 3-label rule."""
    transformers = _transformers()
    cfg = clf.config
    hf_cfg = transformers.DistilBertConfig(
        vocab_size=cfg.vocab_size,
        dim=cfg.dim,
        n_layers=cfg.n_layers,
        n_heads=cfg.n_heads,
        hidden_dim=cfg.hidden_dim,
        max_position_embeddings=cfg.max_positions,
        num_labels=cfg.n_classes,
        dropout=0.0,
        attention_dropout=0.0,
        seq_classif_dropout=0.0,
    )
    model = transformers.DistilBertForSequenceClassification(hf_cfg)
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    unexpected = [k for k in unexpected if not k.endswith("position_ids")]
    if missing or unexpected:
        raise ValueError(
            "oracle could not consume the checkpoint exactly: "
            f"missing={sorted(missing)[:4]} unexpected={sorted(unexpected)[:4]}"
        )
    model.eval()

    ids, lengths = clf.tokenizer.encode_batch(texts, clf.max_len)
    attention = (
        np.arange(clf.max_len)[None, :] < lengths[:, None]
    ).astype(np.int64)
    with torch.no_grad():
        logits = model(
            input_ids=torch.tensor(np.asarray(ids, dtype=np.int64)),
            attention_mask=torch.tensor(attention),
        ).logits
    probs = torch.softmax(logits, dim=-1)
    conf, cls = probs.max(dim=-1)
    labels = []
    for text, c, k in zip(texts, conf.tolist(), cls.tolist()):
        if not text.strip():
            labels.append("Neutral")  # reference empty-lyric rule
        elif c < clf.neutral_threshold:
            labels.append("Neutral")
        else:
            labels.append(clf._CLASS_LABELS[int(k)])
    return labels


def build_llama_oracle(checkpoint_path: str, cfg):
    """transformers' own ``LlamaForCausalLM`` loaded from the checkpoint
    (a file or a directory of shards, read as the backend reads it)."""
    transformers = _transformers()
    from music_analyst_tpu_torch.models.llama import load_torch_state_dict

    sd = load_torch_state_dict(checkpoint_path)
    if not any(k.startswith("model.") for k in sd):
        # The backend tolerates bare-model keys; HF's module names don't.
        sd = {(k if k == "lm_head.weight" else "model." + k): v
              for k, v in sd.items()}
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.dim,
        intermediate_size=cfg.hidden_dim,
        num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads,
        max_position_embeddings=cfg.max_seq_len,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=1e-5,  # models/layers.py RMSNorm epsilon
        attention_bias=False,
        tie_word_embeddings="lm_head.weight" not in sd,
    )
    model = transformers.LlamaForCausalLM(hf_cfg)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if k != "lm_head.weight"]  # tied
    unexpected = [k for k in unexpected if "rotary_emb" not in k]
    if missing or unexpected:
        raise ValueError(
            "oracle could not consume the checkpoint exactly: "
            f"missing={sorted(missing)[:4]} unexpected={sorted(unexpected)[:4]}"
        )
    model.eval()
    return model


def _oracle_llama_labels(
    checkpoint_path: str, clf, texts: Sequence[str]
) -> List[str]:
    """Labels from transformers' ``LlamaForCausalLM``, scoring the same
    label continuations teacher-forced after the same prompt ids."""
    from music_analyst_tpu_torch.models.llama import (
        LYRICS_TRUNCATION,
        PROMPT_TEMPLATE,
    )

    model = build_llama_oracle(checkpoint_path, clf.config)
    label_ids = [
        [int(t) for t in clf._label_ids[k][: clf._label_lens[k]]]
        for k in range(len(SUPPORTED_LABELS))
    ]
    labels = []
    for text in texts:
        if not text.strip():
            labels.append("Neutral")  # reference empty-lyric rule
            continue
        prompt = PROMPT_TEMPLATE.format(lyrics=text.strip()[:LYRICS_TRUNCATION])
        row, n = clf.tokenizer.encode(prompt, clf.max_prompt_len)
        prompt_ids = [int(t) for t in row[:n]]
        # One batched forward scores the three right-padded continuations.
        width = n + max(len(c) for c in label_ids)
        batch = torch.zeros((len(label_ids), width), dtype=torch.long)
        attention = torch.zeros_like(batch)
        for k, cont in enumerate(label_ids):
            seq = prompt_ids + cont
            batch[k, : len(seq)] = torch.tensor(seq)
            attention[k, : len(seq)] = 1
        with torch.no_grad():
            logits = model(batch, attention_mask=attention).logits
        logp = torch.log_softmax(logits.float(), dim=-1)
        scores = []
        for k, cont in enumerate(label_ids):
            # Token cont[j] is predicted by the position before it;
            # length-normalised like the backend's scorer.
            total = sum(float(logp[k, n - 1 + j, tok])
                        for j, tok in enumerate(cont))
            scores.append(total / max(1, len(cont)))
        labels.append(SUPPORTED_LABELS[int(np.argmax(scores))])
    return labels


def run_validation(
    dataset_path: str,
    model: str = "distilbert",
    limit: int = 64,
    output_dir: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    quiet: bool = False,
    backend=None,
    weight_quant: Optional[str] = None,
    device: DeviceLike = "cuda",
):
    """Classify a slice with the port's backend and with the
    ``transformers`` oracle; return the agreement report (and write
    ``weight_validation.json`` into ``output_dir``).

    ``backend`` is injectable for tests; by default the model name
    resolves through ``get_backend`` on ``device``, which takes the
    checkpoint from the same ``MUSICAAL_*_CKPT`` variable a production run
    uses."""
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.serving.residency import ModelResidency
    from music_analyst_tpu_torch.telemetry import get_telemetry

    family = _family(model)
    checkpoint_path = checkpoint_path or os.environ.get(
        _ENV_BY_FAMILY[family]
    )
    if not checkpoint_path:
        raise RuntimeError(
            f"no checkpoint to validate: set {_ENV_BY_FAMILY[family]} (or "
            "pass checkpoint_path=)"
        )
    _transformers()  # fail before loading the backend, not after
    clf = ModelResidency(
        model, backend=backend, weight_quant=weight_quant, device=device,
        checkpoint_path=checkpoint_path,
    ).acquire()
    if not getattr(clf, "pretrained", False):
        raise RuntimeError(
            "backend did not load the checkpoint — validating random "
            "weights would certify nothing"
        )

    tel = get_telemetry()
    with tel.run_scope("validate", output_dir):
        tel.annotate(model=model, backend=getattr(clf, "name", model))
        with tel.span("ingest"):
            songs = []
            for artist, song, text in iter_songs(dataset_path):
                songs.append((artist, song, text))
                if limit and len(songs) >= limit:
                    break
            texts = [text for _, _, text in songs]
        tel.count("rows_validated", len(texts))

        with tel.span("compute", rows=len(texts)):
            ours = clf.classify_batch(texts)
        with tel.span("oracle", rows=len(texts)):
            oracle = (
                _oracle_distilbert_labels(checkpoint_path, clf, texts)
                if family == "distilbert"
                else _oracle_llama_labels(checkpoint_path, clf, texts)
            )

        disagreements = [
            {"artist": a, "song": s, "ours": o, "oracle": h}
            for (a, s, _), o, h in zip(songs, ours, oracle)
            if o != h
        ]
        confusion = {want: {got: 0 for got in SUPPORTED_LABELS}
                     for want in SUPPORTED_LABELS}
        for o, h in zip(ours, oracle):
            confusion[h][o] += 1
        report = {
            "model": model,
            "checkpoint": checkpoint_path,
            "rows": len(texts),
            # Unrounded: the CLI --min-agreement gate compares this value.
            "agreement": sum(o == h for o, h in zip(ours, oracle))
            / max(1, len(texts)),
            "oracle": "transformers torch forward, shared tokenizer ids",
            "confusion_oracle_to_ours": confusion,
            "disagreements": disagreements[:20],
        }
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            path = os.path.join(output_dir, "weight_validation.json")
            with tel.span("write"), open(path, "w", encoding="utf-8") as fh:
                json.dump(report, fh, indent=2)
            if not quiet:
                print(f"Validation report -> {path}")
    if not quiet:
        print(
            f"{report['rows']} rows: {report['agreement'] * 100:.1f}% label "
            f"agreement vs the transformers oracle"
        )
        for d in disagreements[:5]:
            print(f"  differs: {d['song']!r} ours={d['ours']} "
                  f"oracle={d['oracle']}")
    return report
