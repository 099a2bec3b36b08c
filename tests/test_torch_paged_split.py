"""The paged kernel's split plan and its split-then-combine order, on the CPU.

``split_plan`` lays the keys of a decode step out over the kernel's splits;
``paged_attention_split_reference`` is that order in plain f32 PyTorch
(each split's max, sum and unnormalised V sum over its valid keys, then the
splits combined in order, a split with no valid key skipped).  Both run on
the seeded cases of ``tests/test_torch_paged_attention.py`` (odd per-slot
lengths, a decode row past a masked gap, a free slot on the trash page,
garbage in the trash page; bf16 and int8 pools).  Tolerance against the f32
oracles (the port's and JAX's): 1e-5, f32 sums in another order.  A slot
with no valid key gives exact zeros.
"""

import numpy as np
import pytest
import torch

from music_analyst_tpu.ops import paged_attention as jpa
from music_analyst_tpu_torch.ops import paged_attention as tpa
from test_torch_paged_attention import _args, _case, _jax, _np, _scales

torch.set_num_threads(1)

TOL = 1e-5


@pytest.mark.parametrize("total,page_size", [
    (1040, 16),           # Llama-3-8B decode
    (1040, 64),
    (1, 16),
    (31, 8),              # the seeded cases' geometry
    (63, 16),
    (128, 64),
    (129, 64),
    (1000, 48),           # a page size that does not divide the chunk
    (5000, 256),          # a page larger than the chunk
])
def test_split_plan_covers_every_key_once(total, page_size):
    plan = tpa.split_plan(total, page_size)
    ranges = plan.ranges
    assert len(ranges) == plan.splits >= 1
    assert 0 < plan.chunk <= tpa.SPLIT_KEYS
    if page_size <= plan.chunk:
        assert plan.chunk % page_size == 0
    keys = np.concatenate([np.arange(a, b) for a, b in ranges])
    assert np.array_equal(keys, np.arange(total))    # each key exactly once
    assert all(b > a for a, b in ranges)             # no empty range
    assert all(b - a == plan.chunk for a, b in ranges[:-1])
    assert ranges[-1][1] == total


def test_split_plan_chunks_whole_pages():
    # 64 keys a split at the Llama-3-8B decode shape: 17 splits.
    assert tpa.split_plan(1040, 16).chunk == 64
    assert tpa.split_plan(1040, 16).splits == 17
    assert tpa.split_plan(1000, 48).chunk == 48        # whole pages
    assert tpa.split_plan(5000, 256).chunk == 64       # a page split up
    with pytest.raises(ValueError, match="positive"):
        tpa.split_plan(0, 16)
    with pytest.raises(ValueError, match="positive"):
        tpa.split_plan(16, 0)


def _plans(total):
    return [None, tpa.SplitPlan(8, total), tpa.SplitPlan(5, total),
            tpa.SplitPlan(total, total)]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("plan_index", range(4))
def test_split_reference_matches_oracle(P, quantized, plan_index):
    case = _case(P + quantized, P, quantized)
    plan = _plans(case["mask"].shape[-1])[plan_index]
    got = tpa.paged_attention_split_reference(*_args(case), **_scales(case),
                                              plan=plan)
    want = tpa.paged_attention_reference(*_args(case), **_scales(case))
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got[:-1], want[:-1], atol=TOL, rtol=0)
    assert bool((got[-1] == 0).all())                # free slot: zeros


@pytest.mark.parametrize("quantized", [False, True])
def test_split_reference_matches_jax_oracle(quantized):
    case = _case(3, 8, quantized)
    got = tpa.paged_attention_split_reference(*_args(case), **_scales(case))
    want = _np(jpa.paged_attention_reference(
        *(_jax(t) for t in _args(case)),
        **{k: _jax(v) for k, v in _scales(case).items()}))
    np.testing.assert_allclose(got[:-1].numpy(), want[:-1], atol=TOL, rtol=0)


def test_empty_splits_and_a_single_key():
    """Splits with no valid key are skipped; a slot with exactly one valid
    key reads that key's value row; an all-masked slot reads zeros."""
    case = _case(7, 8, False)
    mask = torch.zeros_like(case["mask"])
    total = mask.shape[-1]
    mask[0, :3] = True                 # only the first split has keys
    mask[1, total - 1] = True          # one key, in the last split
    mask[2, 9:12] = True               # the second split only
    case["mask"] = mask
    plan = tpa.SplitPlan(8, total)
    got = tpa.paged_attention_split_reference(*_args(case), plan=plan)
    want = tpa.paged_attention_reference(*_args(case))
    torch.testing.assert_close(got[:-1], want[:-1], atol=TOL, rtol=0)
    page = int(case["table"][1, (total - 1) // 8])
    v_row = case["value_pages"][page, (total - 1) % 8].float()   # [n_kv, D]
    group = got.shape[2] // v_row.shape[0]
    torch.testing.assert_close(got[1, 0], v_row.repeat_interleave(group, 0),
                               atol=TOL, rtol=0)
    assert bool((got[-1] == 0).all())


def test_split_reference_checks_its_arguments():
    case = _case(0, 8, False)
    q, kp, vp, table, mask = _args(case)
    with pytest.raises(ValueError, match="decode kernel"):
        tpa.paged_attention_split_reference(q.expand(-1, 2, -1, -1), kp, vp,
                                            table, mask)
    with pytest.raises(ValueError, match="passed together"):
        tpa.paged_attention_split_reference(q, kp, vp, table, mask,
                                            key_scale=torch.ones(kp.shape[:2]))
