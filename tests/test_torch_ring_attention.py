"""The port's ring attention across 4 processes ≡ the JAX package's.

``music_analyst_tpu_torch/ops/ring_attention.py:ring_attention`` runs in
one launch of 4 ranks over gloo on the CPU, on the cases of
``tests/test_ring_attention.py`` (plain, causal, a long sequence in small
blocks, GQA, packed segments, causal + segments, and ``use_flash`` —
each hop through the flash kernel's plain version on the CPU — with and
without GQA, causal or segments), on the same numpy inputs.  Each rank's
output is held against JAX's ``ring_attention`` on the JAX tests'
8-device ``sp`` mesh and against dense attention (JAX's
``dot_product_attention``), at the JAX tests' tolerances: rtol 1e-4 /
atol 1e-5, and 2e-4 for the flash path.  Every rank returns the whole
output.  The ring's byte accounting (``ppermute`` per hop) is held to the
blocks' sizes.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from music_analyst_tpu.models.layers import dot_product_attention
from music_analyst_tpu.ops.ring_attention import ring_attention as jax_ring
from music_analyst_tpu.parallel.mesh import MeshSpec, build_mesh
from tests.torch_ranks import launch_ranks

RANKS = 4


def _rand_qkv(rng, B=2, S=64, H=4, D=16, kv_heads=None):
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, kv_heads or H, D)).astype(np.float32)
    v = rng.normal(size=(B, S, kv_heads or H, D)).astype(np.float32)
    return q, k, v


def _doc_segments(rng, B, S, n_docs=5):
    """Contiguous document ids 1..n over the sequence, cut at points not
    aligned to the shard boundaries (``tests/test_ring_attention.py``)."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), size=n_docs - 1,
                                  replace=False))
        bounds = [0, *cuts.tolist(), S]
        for i in range(n_docs):
            seg[b, bounds[i]:bounds[i + 1]] = i + 1
    return seg


# name: (seed, shape kwargs, causal, use_flash, n_docs or None), as in
# tests/test_ring_attention.py.
CASES = {
    "plain": (0, {}, False, False, None),
    "causal": (1, {}, True, False, None),
    "long_small_blocks": (2, dict(B=1, S=512, H=2, D=8), False, False, None),
    "flash": (3, dict(B=2, S=1024, H=2, D=64), False, True, None),
    "flash_causal": (4, dict(B=1, S=1024, H=2, D=64), True, True, None),
    "gqa": (5, dict(B=2, S=64, H=8, D=16, kv_heads=2), False, False, None),
    "gqa_flash": (6, dict(B=1, S=1024, H=4, D=64, kv_heads=2), False, True,
                  None),
    "segmented": (7, dict(B=2, S=64, H=4, D=16), False, False, 5),
    "segmented_causal": (8, dict(B=1, S=64, H=2, D=16), True, False, 3),
    "segmented_flash": (9, dict(B=1, S=1024, H=2, D=64), False, True, 7),
    # Beyond JAX's list: the flash hop under causal + segments with GQA,
    # where later ranks' hops are fully masked.
    "gqa_flash_causal_segmented": (10, dict(B=1, S=256, H=4, D=64,
                                            kv_heads=2), True, True, 4),
}


def _inputs(name):
    seed, shape, causal, use_flash, n_docs = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = _rand_qkv(rng, **shape)
    seg = None
    if n_docs is not None:
        seg = _doc_segments(rng, q.shape[0], q.shape[1], n_docs)
    return q, k, v, seg


_CHILD = r"""
import json, sys
import numpy as np, torch
rank, n, port, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                              sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
from music_analyst_tpu_torch.ops.ring_attention import ring_attention
from music_analyst_tpu_torch.parallel import multihost
from music_analyst_tpu_torch.telemetry import get_telemetry
multihost.initialize(f"localhost:{port}", n, rank, timeout_s=60)
cases = json.loads(open(inputs + ".json").read())
data = np.load(inputs + ".npz")
results = {}
for name, (causal, use_flash) in cases.items():
    q, k, v = (torch.from_numpy(data[f"{name}.{x}"]) for x in "qkv")
    seg = (torch.from_numpy(data[f"{name}.seg"]) if f"{name}.seg" in data
           else None)
    results[name] = ring_attention(q, k, v, causal=causal,
                                   use_flash=use_flash,
                                   segment_ids=seg).numpy()
np.savez(f"{out}/rank{rank}.npz", **results)
counters = {k: v for k, v in get_telemetry().counters.items()
            if k.startswith("collectives.")}
json.dump(counters, open(f"{out}/counters{rank}.json", "w"))
multihost.shutdown()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 4-rank launch over every case; returns each rank's outputs and
    collective counters."""
    base = tmp_path_factory.mktemp("ring")
    arrays, cases = {}, {}
    for name in CASES:
        q, k, v, seg = _inputs(name)
        arrays.update({f"{name}.q": q, f"{name}.k": k, f"{name}.v": v})
        if seg is not None:
            arrays[f"{name}.seg"] = seg
        cases[name] = CASES[name][2:4]
    np.savez(base / "inputs.npz", **arrays)
    (base / "inputs.json").write_text(json.dumps(cases))
    launch_ranks(_CHILD, RANKS, [base / "inputs", base], base / "logs",
                 timeout=240)
    return ([dict(np.load(base / f"rank{r}.npz")) for r in range(RANKS)],
            [json.loads((base / f"counters{r}.json").read_text())
             for r in range(RANKS)])


@pytest.fixture(scope="module")
def sp_mesh():
    return build_mesh(MeshSpec((("sp", 8),)))


def _dense(q, k, v, seg, causal):
    S = q.shape[1]
    mask = None
    if causal:
        mask = (jnp.arange(S)[None, :] <= jnp.arange(S)[:, None])[None, None]
    if seg is not None:
        segj = jnp.asarray(seg)
        seg_mask = segj[:, None, :, None] == segj[:, None, None, :]
        mask = seg_mask if mask is None else (mask & seg_mask)
    group = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, group, axis=2), np.repeat(v, group, axis=2)
    return np.asarray(dot_product_attention(q, k, v, mask))


def _tolerance(use_flash):
    return dict(rtol=2e-4, atol=2e-4) if use_flash else dict(rtol=1e-4,
                                                            atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_ring_and_dense(ranks, sp_mesh, name):
    q, k, v, seg = _inputs(name)
    causal, use_flash = CASES[name][2:4]
    want_dense = _dense(q, k, v, seg, causal)
    want_jax = np.asarray(jax_ring(
        q, k, v, sp_mesh, causal=causal, use_flash=use_flash,
        segment_ids=None if seg is None else jnp.asarray(seg)))
    outputs, _ = ranks
    for rank, got in enumerate(out[name] for out in outputs):
        assert got.shape == q.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want_jax, **_tolerance(use_flash),
                                   err_msg=f"rank {rank} vs JAX ring")
        np.testing.assert_allclose(got, want_dense, **_tolerance(use_flash),
                                   err_msg=f"rank {rank} vs dense")
        # All ranks gather the same shards in the same order.
        np.testing.assert_array_equal(got, outputs[0][name])


def test_ring_records_hop_and_gather_bytes(ranks):
    rotate = gather = 0
    for name in CASES:
        q, k, v, seg = _inputs(name)
        blocks = (k.nbytes + v.nbytes + (0 if seg is None else seg.nbytes))
        rotate += (RANKS - 1) * blocks // RANKS
        gather += (RANKS - 1) * q.nbytes // RANKS
    _, counters = ranks
    for c in counters:
        assert c["collectives.ppermute_bytes"] == rotate
        assert c["collectives.all_gather_bytes"] == gather
        assert c["collectives.total_bytes"] == rotate + gather


def test_one_process_ring_is_plain_attention():
    """Outside a process group the ring is one hop over the whole
    sequence (no transfer), through both hop kinds."""
    import torch

    from music_analyst_tpu_torch.ops.ring_attention import ring_attention

    q, k, v, seg = _inputs("gqa_flash_causal_segmented")
    want = _dense(q, k, v, seg, True)
    for use_flash in (False, True):
        got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True, use_flash=use_flash,
                             segment_ids=torch.from_numpy(seg))
        np.testing.assert_allclose(got.numpy(), want, **_tolerance(use_flash))
