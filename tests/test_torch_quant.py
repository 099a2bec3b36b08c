"""Port ``ops/quant.py`` ≡ the JAX ``ops/quant.py``, on the same inputs.

Inputs are drawn with numpy from a seed and go through both packages on
the CPU.  Tolerances: quantized codes byte-identical and scales equal
(the same f32 division and round-half-even on both sides); op outputs
within 1e-5 relative of JAX's (the integer accumulations are exact on
both sides, the f32 epilogue sums in another order); tree paths and byte
counts equal.  The card's padded int8 product is checked here through
``torch._int_mm`` on the CPU (which has no row minimum) against the plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.ops import quant as jq
from music_analyst_tpu_torch.ops import quant as tq

REL = 1e-5


def _rel_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * scale, (
        np.abs(got - want).max(), scale)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("shape,n_contract,group", [
    ((256, 48), 1, 128),
    ((64, 4, 16), 1, 128),       # q_proj layout [dim, H, Dh], one group
    ((4, 16, 32), 2, 32),        # o_proj layout [H, Dh, dim]
    ((96, 24), 1, 40),           # group does not divide K: one group
])
def test_quantize_array_codes_identical(scheme, shape, n_contract, group):
    w = _rand(0, *shape)
    want = jq.quantize_array(w, scheme, n_contract, group)
    got = tq.quantize_array(torch.from_numpy(w), scheme, n_contract, group)
    assert got.q.dtype == torch.int8
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.scheme, got.shape, got.n_contract, got.group_size) == (
        want.scheme, want.shape, want.n_contract, want.group_size)
    # numpy input quantizes the same way.
    from_np = tq.quantize_array(w, scheme, n_contract, group)
    assert np.array_equal(from_np.q.numpy(), got.q.numpy())


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_dequantize_param_matches(scheme):
    w = _rand(1, 256, 16)
    jqp = jq.quantize_array(w, scheme)
    tqp = tq.quantize_array(w, scheme)
    assert np.array_equal(tq.dequantize_param(tqp).numpy(),
                          np.asarray(jq.dequantize_param(jqp)))
    # Unpacking inverts the packing.
    if scheme == "int4":
        codes = tq._unpack_int4(tqp.q)
        assert codes.shape == (256, 16)
        assert int(codes.abs().max()) <= 7
        assert np.array_equal(codes.numpy(),
                              np.asarray(jq._unpack_int4(jqp.q)))


def test_quant_matmul_matches_jax():
    x = _rand(2, 3, 10, 64)
    w = _rand(3, 64, 40)
    want = jq.quant_matmul(jnp.asarray(x), jnp.asarray(w))
    got = tq.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    _rel_close(got, want)


def test_quant_dense_layouts_match_jax():
    x = _rand(4, 4, 10, 32)
    k = _rand(5, 32, 4, 8)
    b = _rand(6, 4, 8)
    want = jq.quant_dense_axis_last(jnp.asarray(x), jnp.asarray(k),
                                    jnp.asarray(b))
    got = tq.quant_dense_axis_last(torch.from_numpy(x), torch.from_numpy(k),
                                   torch.from_numpy(b))
    _rel_close(got, want)
    xo = _rand(7, 4, 10, 4, 8)
    ko = _rand(8, 4, 8, 32)
    bo = _rand(9, 32)
    want2 = jq.quant_dense_axis_last2(jnp.asarray(xo), jnp.asarray(ko),
                                      jnp.asarray(bo))
    got2 = tq.quant_dense_axis_last2(torch.from_numpy(xo),
                                     torch.from_numpy(ko),
                                     torch.from_numpy(bo))
    _rel_close(got2, want2)
    # bf16 output dtype, as the model layers ask for.
    got3 = tq.quant_dense_axis_last(torch.from_numpy(x), torch.from_numpy(k),
                                    out_dtype=torch.bfloat16)
    assert got3.dtype == torch.bfloat16 and got3.shape == (4, 10, 4, 8)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("n_contract", [1, 2])
def test_wq_matmul_matches_jax(scheme, n_contract):
    if n_contract == 1:
        w = _rand(10, 256, 4, 12)                  # [K, H, Dh], 2 groups
        x = _rand(11, 2, 7, 256)
        jx = jnp.asarray(x)
    else:
        w = _rand(12, 4, 64, 24)                   # [H, Dh, N], 2 groups
        x = _rand(13, 2, 7, 4, 64)
        jx = jnp.asarray(x)
    b = _rand(14, *w.shape[n_contract:])
    jqp = jq.quantize_array(w, scheme, n_contract)
    tqp = tq.quantize_array(torch.from_numpy(w), scheme, n_contract)
    if n_contract == 1:
        flat = x
        want = jq.wq_dense_axis_last(jx, jqp, jnp.asarray(b))
        got = tq.wq_dense_axis_last(torch.from_numpy(x), tqp,
                                    torch.from_numpy(b))
    else:
        flat = x.reshape(2, 7, 256)
        want = jq.wq_dense_axis_last2(jx, jqp, jnp.asarray(b))
        got = tq.wq_dense_axis_last2(torch.from_numpy(x), tqp,
                                     torch.from_numpy(b))
    _rel_close(got, want)
    _rel_close(tq.wq_matmul(torch.from_numpy(flat), tqp),
               jq.wq_matmul(jnp.asarray(flat), jqp))


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_kernel_major_layout_keeps_values(scheme):
    """The card's kernel-major codes hold the same logical tensor, and the
    int8 operand they give is K-contiguous."""
    qp = tq.quantize_array(_rand(15, 4, 64, 24), scheme, n_contract=2,
                           group_size=64)
    km = tq.kernel_major(qp)
    assert tq.is_kernel_major(km.q, 2)
    assert not tq.is_kernel_major(qp.q, 2)
    assert torch.equal(km.q, qp.q)
    codes = tq._card_weight_codes(qp)
    assert codes.shape == (256, 24) and codes.stride() == (1, 256)
    assert torch.equal(codes.float(), tq.dequantize_param(
        tq.QuantizedParam(qp.q, torch.ones_like(qp.scale), qp.scheme,
                          qp.shape, qp.n_contract, qp.group_size)
    ).reshape(256, 24))


def test_block_spread_group_partials_equal_plain():
    """The card's int4 route (one product of block-spread rows) gives the
    plain per-group partial sums exactly; run here through the CPU's
    ``torch._int_mm``."""
    rng = np.random.default_rng(16)
    qx = torch.from_numpy(rng.integers(-127, 128, (5, 256)).astype(np.int8))
    qp = tq.quantize_array(_rand(17, 256, 40), "int4", group_size=64)
    w = tq._card_weight_codes(qp)
    want = tq._group_partials_plain(
        qx, tq._unpack_int4(qp.q).reshape(4, 64, 40))
    got = tq._group_partials_card(
        qx, w, 4, mm=lambda a, b: tq._int_mm_padded(a, b, torch._int_mm))
    assert got.shape == (4, 5, 40)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M", [1, 8, 16, 31, 32, 40])
def test_padded_int_mm_equals_unpadded_plain(M):
    rng = np.random.default_rng(M)
    qx = torch.from_numpy(rng.integers(-127, 128, (M, 64)).astype(np.int8))
    qw_nk = torch.from_numpy(rng.integers(-127, 128, (24, 64)).astype(np.int8))
    calls = []

    def mm(a, b):
        calls.append(a.shape[0])
        return torch._int_mm(a, b)

    got = tq._int_mm_padded(qx, qw_nk.t(), mm)
    assert calls == [max(M, tq.INT_MM_MIN_ROWS)]
    assert got.dtype == torch.int32 and got.shape == (M, 24)
    assert torch.equal(got, tq.int8_matmul_plain(qx, qw_nk.t()))


def test_row_chunks_do_not_change_results(monkeypatch):
    x = torch.from_numpy(_rand(18, 50, 256))
    for scheme in ("int8", "int4"):
        qp = tq.quantize_array(_rand(19, 256, 16), scheme)
        whole = tq.wq_matmul(x, qp)
        monkeypatch.setattr(tq, "_CHUNK_BYTES", 4 * 16 * 2 * 7)
        assert torch.equal(tq.wq_matmul(x, qp), whole)
        monkeypatch.undo()
    w = torch.from_numpy(_rand(20, 256, 16))
    whole = tq.quant_matmul(x, w)
    monkeypatch.setattr(tq, "_CHUNK_BYTES", 4 * 16 * 3)
    assert torch.equal(tq.quant_matmul(x, w), whole)


def test_path_rules_match_jax():
    paths = [
        "layer_0/attention/q_proj/kernel", "layer_3/attention/o_proj/kernel",
        "layer_1/feed_forward/gate_proj/kernel",
        "layer_1/feed_forward/down_proj/kernel",
        "encoder/layer_0/ffn/lin1/kernel", "encoder/layer_0/ffn/lin2/kernel",
        "encoder/layer_0/attention/v_proj/kernel", "lm_head/kernel",
        "tok_embeddings/embedding", "layer_0/attention/q_proj/bias",
        "pre_classifier/kernel", "classifier/kernel", "norm/scale",
    ]
    assert tq.WQ_PATH_RULES == jq.WQ_PATH_RULES
    assert (tq.WQ_SCHEMES, tq.WQ_DEFAULT_GROUP) == (jq.WQ_SCHEMES,
                                                    jq.WQ_DEFAULT_GROUP)
    for path in paths:
        assert tq.wq_rule_for_path(path) == jq.wq_rule_for_path(path), path
    for K in (128, 256, 96, 768, 14336):
        assert tq.wq_group_size(K) == jq.wq_group_size(K)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quantize_tree_and_bytes_match_jax(scheme):
    tree = {
        "layer_0": {"attention": {"q_proj": {"kernel": _rand(21, 128, 4, 8)},
                                  "o_proj": {"kernel": _rand(22, 4, 8, 128)}},
                    "feed_forward": {"up_proj": {"kernel": _rand(23, 128, 64)}},
                    "attention_norm": {"scale": _rand(24, 128)}},
        "tok_embeddings": {"embedding": _rand(25, 64, 128)},
        "lm_head": {"kernel": _rand(26, 128, 64)},
    }
    jt = jq.quantize_tree(tree, scheme)
    tt = tq.quantize_tree(tree, scheme)
    assert tq.param_tree_bytes(tt) == jq.param_tree_bytes(jt)
    jleaves = dict(tq.iter_tree(jt))
    for path, leaf in tq.iter_tree(tt):
        other = jleaves[path]
        if isinstance(leaf, tq.QuantizedParam):
            assert np.array_equal(leaf.q.numpy(), np.asarray(other.q)), path
            assert np.array_equal(leaf.scale.numpy(), np.asarray(other.scale))
        else:
            assert np.array_equal(np.asarray(leaf), np.asarray(other))


def test_param_tree_bytes_of_a_module_matches_its_tree():
    from music_analyst_tpu_torch.models.layers import WqLinear

    layer = torch.nn.Module()
    layer.proj = WqLinear(128, 64, "int8", bias=True, dtype=torch.float32)
    layer.norm = torch.nn.Linear(4, 4, bias=False)
    acc = tq.param_tree_bytes(layer)
    assert acc["n_quantized_leaves"] == 1 and acc["n_float_leaves"] == 2
    assert acc["quantized_bytes"] == 128 * 64 + 64 * 4
    assert acc["float_bytes"] == 64 * 4 + 16 * 4
    assert acc["dequant_transient_bytes"] == 128 * 64 * 4


def test_errors_match_jax():
    with pytest.raises(ValueError, match="even"):
        tq.quantize_array(np.ones((7, 4), np.float32), "int4")
    with pytest.raises(ValueError, match="even"):
        jq.quantize_array(np.ones((7, 4), np.float32), "int4")
    with pytest.raises(ValueError, match="scheme"):
        tq.quantize_array(np.ones((4, 4), np.float32), "int2")
    with pytest.raises(ValueError, match="scheme"):
        jq.quantize_array(np.ones((4, 4), np.float32), "int2")


def test_dynamic_scales_and_codes_identical_to_jax():
    """Per-row activation scales and codes, and per-channel dynamic weight
    scales, equal JAX's bit for bit (true divisions on both sides)."""
    x = _rand(27, 2048, 96) * np.float32(3.7)
    s_j = np.asarray(jq._symmetric_scale(jnp.asarray(x), axis=-1))
    q_j = np.asarray(jnp.round(jnp.asarray(x) / s_j))
    q_t, s_t = tq._quantize_rows(torch.from_numpy(x))
    assert np.array_equal(s_t.numpy(), s_j)
    assert np.array_equal(q_t.numpy().astype(np.float32), q_j)
    w = _rand(28, 96, 2048)
    sw_j = np.asarray(jq._symmetric_scale(jnp.asarray(w), axis=0))
    _, sw_t = tq._quantize_weight_columns(torch.from_numpy(w))
    assert np.array_equal(sw_t.numpy(), sw_j)
