"""The port's train step on a mesh of ranks ≡ JAX's on its device mesh.

JAX runs in this process on the 8-device CPU mesh; the port runs as 8 gloo
ranks (``tests/torch_ranks.py``), one launch shared by every case through a
module fixture, with JAX's weights carried over by ``params_from_jax``.
The configuration is JAX's ``test_zero1_optimizer_state_sharding`` one
(f32, vocab 256, dim 32, 2 layers, 4 / 2 heads; 4 / 4 for the restore onto
dp2×tp4, which must split the KV heads four ways, as in JAX's
``test_checkpoint_restores_across_mesh_layouts``), on batches of 8 rows
with random lengths, so the ``dp`` ranks' rows hold different numbers of
valid tokens.  Tolerances, f32 on both sides, sums in another order:

- losses: rtol 1e-5, against JAX and between the port's own meshes;
- masters after three steps, JAX vs port, through their update from the
  common start: ``|Δport − Δjax| ≤ 1e-6 + 2e-2·|Δjax|`` — AdamW steps of
  lr 3e-4, each rounded on its own side, and an element whose gradient
  is near Adam's eps (1e-8) moves by m̂ / (√v̂ + eps), which the
  gradient's last bits move by a few percent (one embedding row of
  8,192 elements: 1.5%);
- masters, ZeRO-1 vs the plain step, both the port's: atol 2e-6;
- gradients: atol 1e-5 · max|g| of the leaf, as ``test_torch_train.py``.

Cases: (a) dp4×tp2 losses and masters against JAX's; (b) ZeRO-1 moment
shares equal JAX's addressable shards leaf by leaf, and its losses and
masters equal the plain dp4×tp2 step's; (c) a dp4×tp2 ZeRO-1 state saved
(every rank's masters, moments and step counts its block of the file's)
and restored onto dp2×tp4 (plain and ZeRO-1) and onto one device holds
them bit for bit and steps to the loss and masters of one more step on
the old mesh, and a one-device state restores onto the mesh; (d) packed documents through the step; (e)
``prefetch_batches`` hands each rank its rows and refuses a batch ``dp``
does not divide; (f) one tp2 step gives every rank its block of one
device's ``lm_head`` and embedding gradients — and without the f operator
it does not.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.engines import train as jtrain
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu.parallel.mesh import MeshSpec, build_mesh
from music_analyst_tpu_torch.engines import train as ttrain
from music_analyst_tpu_torch.engines.checkpoint import (
    TRAIN_STATE_FILE,
    restore_train_state,
    save_train_state,
)
from music_analyst_tpu_torch.models import llama as tl
from tests.torch_ranks import launch_ranks

torch.set_num_threads(1)

CFG = dict(vocab_size=256, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           hidden_dim=64, rope_theta=1e4, max_seq_len=64, dtype="float32")
CFGS = {"gqa": CFG, "mha": dict(CFG, n_kv_heads=4)}
B, S, STEPS = 8, 17, 3
LOSS_RTOL = 1e-5
MASTER_ATOL = 2e-6
UPDATE_ATOL, UPDATE_RTOL = 1e-6, 2e-2
DP4XTP2 = (("dp", 4), ("tp", 2))


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(1, 256, (B, S)).astype(np.int32)
        lengths = rng.integers(S // 2, S + 1, (B,)).astype(np.int32)
        out.append((ids, lengths))
    return out


def _packed():
    """Rows of two or three documents, then padding (segment 0)."""
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 256, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = sorted(rng.choice(np.arange(3, S - 3), 1 + b % 2,
                                 replace=False))
        bounds = [0, *cuts, S - (b % 3)]
        for doc, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]), 1):
            seg[b, lo:hi] = doc
    return ids, (seg > 0).sum(axis=1).astype(np.int32), seg


def _jax_mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return build_mesh(MeshSpec(axes), devices=jax.devices()[:n])


def _port_tree(tree):
    """A JAX parameter-shaped tree as the port's ``{name: array}``."""
    return {k: np.asarray(v) for k, v in tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _port_model(key, weights):
    model = tl.LlamaModel(tl.LlamaConfig(**CFGS[key]))
    model.load_state_dict({k: torch.tensor(v) for k, v in weights.items()})
    return model


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


_CHILD = r"""
import contextlib, json, sys
import numpy as np, torch
rank, n, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from music_analyst_tpu_torch.engines import train as T
from music_analyst_tpu_torch.engines.checkpoint import (
    restore_train_state, save_train_state)
from music_analyst_tpu_torch.models import layers, llama as tl
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
mh.initialize(f"localhost:{port}", n, rank, timeout_s=120)
data = dict(np.load(f"{work}/inputs.npz"))
cfgs = json.loads(open(f"{work}/cfgs.json").read())
steps = int(data["steps"])
batches = [(data[f"ids{i}"], data[f"len{i}"]) for i in range(steps)]

def model_of(key):
    m = tl.LlamaModel(tl.LlamaConfig(**cfgs[key]))
    m.load_state_dict({k[len(key) + 2:]: torch.tensor(v)
                       for k, v in data.items() if k.startswith(key + "::")})
    return m

def rows(mesh, *arrays):
    return tuple(torch.tensor(M.batch_sharding(mesh, a)) for a in arrays)

def blocks(state):
    return {k: v.clone() for k, v in state.params.items()}

def max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)

def block_of(state, name, full):
    piece = state.tp_layout.get(name)
    return piece.take(full) if piece is not None else full

def saved(path):
    return torch.load(f"{path}/train_state.pt", weights_only=True)

# The masters, moments and step counts of this rank that differ from its
# block (and ZeRO-1 row) of the global tensors saved in path.
def unequal(state, path):
    held, bad = saved(path), []
    for name, t in state.opt_tensors().items():
        if not torch.equal(state.params[name],
                           block_of(state, name, held["params"][name])):
            bad.append(name)
        st = state.opt_state.state[t]
        for key in ("exp_avg", "exp_avg_sq"):
            want = block_of(state, name, held[key][name]).contiguous()
            if name in state.zero1:
                want = state.zero1[name].take(want)
            if not torch.equal(st[key], want):
                bad.append(f"{name}.{key}")
        if float(st["step"]) != held["adam_step"][name]:
            bad.append(f"{name}.step")
    return bad

# Each master's step from the state saved in start, against the same
# step of the masters saved in end (this rank's blocks): the largest
# |got - want| - UPDATE_RTOL |want| over every element.
def update_excess(state, start, end, rtol):
    a, b = saved(start)["params"], saved(end)["params"]
    excess = 0.0
    for name, master in state.params.items():
        base = block_of(state, name, a[name])
        want = block_of(state, name, b[name]) - base
        got = master - base
        excess = max(excess, float(((got - want).abs()
                                    - rtol * want.abs()).max()))
    return excess

out = {}
grid = M.build_mesh(M.MeshSpec((("dp", 4), ("tp", 2))), device="cpu")
opt = T.make_optimizer()

# (a) the plain dp4 x tp2 step, three batches; (b) ZeRO-1 beside it.
model = model_of("gqa")
plain = T.init_train_state(model, opt, seed=None, mesh=grid)
step = T.make_train_step(model, opt, mesh=grid)
losses = []
for i, (ids, lens) in enumerate(batches):
    plain, loss = step(plain, *rows(grid, ids, lens))
    losses.append(float(loss))
    if i == 1:
        plain_two = blocks(plain)
save_train_state(plain, f"{work}/a_ckpt")
out["a"] = dict(losses=losses)
zmodel = model_of("gqa")
z1 = T.init_train_state(zmodel, opt, seed=None, mesh=grid, zero1=True)
zstep = T.make_train_step(zmodel, opt, mesh=grid)
zl = []
for ids, lens in batches[:2]:
    z1, loss = zstep(z1, *rows(grid, ids, lens))
    zl.append(float(loss))
out["b"] = dict(
    losses=zl, master_diff=max_diff(blocks(z1), plain_two),
    moment_numel={name: [z1.opt_state.state[t][key].numel()
                         for key in ("exp_avg", "exp_avg_sq")]
                  for name, t in z1.opt_tensors().items()},
    sharded=sorted(z1.zero1), routes=dict(M.ROUTES))

# (c) a ZeRO-1 dp4 x tp2 state on the 4 / 4-head model, one step, saved;
# one more step on the old mesh; restored onto dp2 x tp4 (plain and
# ZeRO-1) it takes the same step.  A one-device state restores onto the
# mesh.
amodel = model_of("mha")
astate = T.init_train_state(amodel, opt, seed=None, mesh=grid, zero1=True)
astep = T.make_train_step(amodel, opt, mesh=grid)
astate, _ = astep(astate, *rows(grid, *batches[0]))
save_train_state(astate, f"{work}/c_ckpt")
out["c"] = dict(saved_unequal=unequal(astate, f"{work}/c_ckpt"))
astate, old = astep(astate, *rows(grid, *batches[1]))
save_train_state(astate, f"{work}/c_next")
other = M.build_mesh(M.MeshSpec((("dp", 2), ("tp", 4))), device="cpu")
out["c"]["old"] = float(old)
rtol = float(data["update_rtol"])
for tag, zero1 in (("dp2xtp4", False), ("dp2xtp4_zero1", True)):
    bmodel = tl.LlamaModel(tl.LlamaConfig(**cfgs["mha"]))
    like = T.init_train_state(bmodel, opt, seed=1, mesh=other, zero1=zero1)
    restored = restore_train_state(f"{work}/c_ckpt", like=like)
    restored_unequal = unequal(restored, f"{work}/c_ckpt")
    bstep = T.make_train_step(bmodel, opt, mesh=other)
    restored, loss = bstep(restored, *rows(other, *batches[1]))
    out["c"][tag] = dict(
        loss=float(loss), step=int(restored.step), unequal=restored_unequal,
        update_excess=update_excess(restored, f"{work}/c_ckpt",
                                    f"{work}/c_next", rtol))
like = T.init_train_state(amodel, opt, seed=1, mesh=grid, zero1=True)
restored = restore_train_state(f"{work}/one_ckpt", like=like)
out["c"]["from_one_device_unequal"] = unequal(restored, f"{work}/one_ckpt")
restored, loss = astep(restored, *rows(grid, *batches[1]))
out["c"]["from_one_device"] = float(loss)

# (d) packed documents through the dp4 x tp2 step.
dmodel = model_of("gqa")
dstate = T.init_train_state(dmodel, opt, seed=None, mesh=grid)
dstep = T.make_train_step(dmodel, opt, mesh=grid)
packed = (data["pids"], data["plen"], data["pseg"])
dstate, loss = dstep(dstate, *rows(grid, *packed))
dstate, unpacked = dstep(dstate, *rows(grid, *packed[:2]))
out["d"] = dict(packed=float(loss), unpacked=float(unpacked))

# (e) prefetch_batches: this rank's rows; a batch dp does not divide.
got = list(T.prefetch_batches([batches[0], packed], mesh=grid, depth=1))
out["e"] = dict(
    rows=[bool(all(np.array_equal(g.numpy(), M.batch_sharding(grid, w))
                   for g, w in zip(got_b, want_b)))
          for got_b, want_b in zip(got, [batches[0], packed])],
    int16=[str(g[1].dtype) for g in got])
try:
    list(T.prefetch_batches([(batches[0][0][:6], batches[0][1][:6])],
                            mesh=grid))
    out["e"]["uneven"] = "no error"
except ValueError as exc:
    out["e"]["uneven"] = str(exc)

# (f) one step on a tp2 mesh (this rank's tp line of the grid): the
# lm_head and embedding gradients before the AdamW step; then again with
# the f operator taken out (no sum over tp in its backward).
line = [r for r in range(n) if r // 2 == rank // 2]
tp2 = M.DeviceMesh(tuple(grid.devices[r] for r in line),
                   (("dp", 1), ("tp", 2)), grid.coord("tp"),
                   {"tp": grid.group("tp")})
for tag in ("f", "f_without_copy"):
    if tag == "f_without_copy":
        layers.copy_to_axis = lambda x, mesh, axis="tp": x
    fmodel = model_of("gqa")
    fstate = T.init_train_state(fmodel, opt, seed=None, mesh=tp2)
    seen = {}

    @contextlib.contextmanager
    def phase(name):
        if name == "reduce_gradients":
            for key in ("lm_head.weight", "tok_embeddings.weight",
                        "norm.weight"):
                seen[key] = fmodel.get_parameter(key).grad.tolist()
        yield

    fstep = T.make_train_step(fmodel, opt, mesh=tp2, phase=phase)
    fstate, loss = fstep(fstate, *(torch.tensor(a) for a in batches[0]))
    out[tag] = dict(loss=float(loss), grads=seen, coord=tp2.coord("tp"))
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's runs in this process, the port's 8 ranks in one launch."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    batches = _batches()
    packed = _packed()
    jmesh = _jax_mesh(DP4XTP2)
    jopt = jtrain.make_optimizer()
    jids = [(jnp.asarray(i), jnp.asarray(n)) for i, n in batches]
    models, states, weights = {}, {}, {}
    inputs = {"steps": np.int32(STEPS), "update_rtol": np.float64(UPDATE_RTOL)}
    for key, cfg in CFGS.items():
        models[key] = jl.LlamaModel(jl.LlamaConfig(**cfg))
        states[key] = jtrain.init_train_state(models[key], jopt, jids[0],
                                              seed=7, mesh=jmesh)
        weights[key] = _port_tree(states[key].params)
        inputs.update({f"{key}::{k}": v for k, v in weights[key].items()})
    for i, (ids, lengths) in enumerate(batches):
        inputs[f"ids{i}"], inputs[f"len{i}"] = ids, lengths
    inputs["pids"], inputs["plen"], inputs["pseg"] = packed
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "cfgs.json").write_text(json.dumps(CFGS))
    want = {}
    # (f): one device's gradients on batch 0.
    ids, lengths = jids[0]
    want["grads"] = _port_tree(jax.grad(lambda p: jtrain.causal_lm_loss(
        models["gqa"], p, ids, lengths))(
            jax.device_get(states["gqa"].params)))

    # (a): JAX's plain dp4 x tp2 step; (b): its ZeRO-1 moment shards.
    step = jtrain.make_train_step(models["gqa"], jopt, mesh=jmesh)
    state, losses = states["gqa"], []
    for ids, lengths in jids:
        state, loss = step(state, ids, lengths)
        losses.append(float(loss))
    want["losses"], want["masters"] = losses, _port_tree(state.params)
    z1 = jtrain.init_train_state(models["gqa"], jopt, jids[0], seed=7,
                                 mesh=jmesh, zero1=True)
    mu = z1.opt_state[0].mu
    want["shards"] = [
        {name: int(v.flat[0]) for name, v in _port_tree(
            jax.tree_util.tree_map(
                lambda leaf, dev=dev: np.full(leaf.shape, {
                    s.device: s.data.size for s in leaf.addressable_shards
                }[dev]), mu)).items()}
        for dev in jmesh.devices.flat]
    # (d): packed documents through JAX's dp4 x tp2 step.
    state = jtrain.init_train_state(models["gqa"], jopt, jids[0], seed=7,
                                    mesh=jmesh)
    state, packed_loss = step(state, *(jnp.asarray(a) for a in packed))
    want["packed"] = float(packed_loss)

    # (c), the other way: a one-device port state, one step, saved; the
    # ranks restore it onto dp4 x tp2 and take the next step.
    model = _port_model("mha", weights["mha"])
    opt = ttrain.make_optimizer()
    one = ttrain.init_train_state(model, opt, seed=None)
    one_step = ttrain.make_train_step(model, opt)
    one, _ = one_step(one, *_t(*batches[0]))
    save_train_state(one, str(tmp / "one_ckpt"))
    one, loss = one_step(one, *_t(*batches[1]))
    want["one_device_next"] = float(loss)

    outs = launch_ranks(_CHILD, 8, [tmp], tmp / "ranks", timeout=240.0)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return dict(want=want, ranks=ranks, tmp=tmp, batches=batches,
                weights=weights)


def _saved(path):
    return torch.load(path / TRAIN_STATE_FILE, weights_only=True)


def test_every_rank_returns_the_global_loss(run):
    def losses(r):
        return (r["a"]["losses"], r["b"]["losses"], r["c"]["old"],
                r["d"]["packed"])

    for r in run["ranks"][1:]:
        assert losses(r) == losses(run["ranks"][0])


@pytest.mark.parametrize("step", range(STEPS))
def test_dp4xtp2_losses_match_jax(run, step):
    got = run["ranks"][0]["a"]["losses"][step]
    np.testing.assert_allclose(got, run["want"]["losses"][step],
                               rtol=LOSS_RTOL)


def test_dp4xtp2_masters_match_jax(run):
    saved = _saved(run["tmp"] / "a_ckpt")
    assert int(saved["step"]) == STEPS
    for name, want in run["want"]["masters"].items():
        start = run["weights"]["gqa"][name]
        got = saved["params"][name].numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got - start, want - start,
                                   rtol=UPDATE_RTOL, atol=UPDATE_ATOL,
                                   err_msg=name)


def test_zero1_shares_equal_jax_addressable_shards(run):
    """Leaf by leaf, each rank's moments hold as many elements as JAX's
    addressable shard of that leaf on the device of the same index."""
    for rank, r in enumerate(run["ranks"]):
        want = run["want"]["shards"][rank]
        got = r["b"]["moment_numel"]
        assert set(got) == set(want)
        for name, numel in want.items():
            assert got[name] == [numel, numel], (rank, name)
    full = run["ranks"][0]["b"]["moment_numel"]
    assert run["ranks"][0]["b"]["sharded"], "ZeRO-1 sharded nothing"
    sizes = {k: v.size for k, v in run["weights"]["gqa"].items()}
    assert any(full[k][0] < sizes[k] // 2 for k in full)


def test_zero1_steps_equal_the_plain_step(run):
    r = run["ranks"][0]["b"]
    np.testing.assert_allclose(r["losses"],
                               run["ranks"][0]["a"]["losses"][:2],
                               rtol=LOSS_RTOL)
    for rank in run["ranks"]:
        assert rank["b"]["master_diff"] <= MASTER_ATOL
        # Under gloo both ZeRO-1 collectives run as all-to-alls.
        assert rank["b"]["routes"].get("all_to_all+sum", 0) > 0
        assert rank["b"]["routes"].get("all_to_all", 0) > 0


def _update_excess(params, start, end):
    """The largest ``|Δgot − Δwant| − UPDATE_RTOL·|Δwant|`` of one
    device's masters against the masters saved in ``end``, each step
    taken from those saved in ``start``."""
    a, b = _saved(start)["params"], _saved(end)["params"]
    return max(float(((params[k] - a[k]) - (b[k] - a[k])).abs().sub(
        UPDATE_RTOL * (b[k] - a[k]).abs()).max()) for k in params)


def test_zero1_checkpoint_holds_every_ranks_blocks(run):
    """The saved file's global masters, moments and step counts: each
    dp4×tp2 ZeRO-1 rank's tensors are its block (and ZeRO-1 row) of
    them, bit for bit."""
    for r in run["ranks"]:
        assert r["c"]["saved_unequal"] == []


@pytest.mark.parametrize("onto", ["dp2xtp4", "dp2xtp4_zero1", "one_device"])
def test_restore_across_mesh_layouts_steps_the_same(run, onto):
    """JAX's ``test_checkpoint_restores_across_mesh_layouts``: a dp4×tp2
    ZeRO-1 state, restored elsewhere, holds the saved masters, moments
    and step counts bit for bit (each rank its block and ZeRO-1 row), and
    takes the step one more step on the old mesh takes: the same loss,
    and the masters through AdamW's update, which reads the moments."""
    old = run["ranks"][0]["c"]["old"]
    ckpt, after = run["tmp"] / "c_ckpt", run["tmp"] / "c_next"
    if onto == "one_device":
        model = tl.LlamaModel(tl.LlamaConfig(**CFGS["mha"]))
        state = restore_train_state(str(ckpt), device="cpu")
        assert int(state.step) == 1
        held = _saved(ckpt)
        for name, t in state.opt_tensors().items():
            assert torch.equal(state.params[name], held["params"][name])
            st = state.opt_state.state[t]
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[key], held[key][name]), (name, key)
            assert float(st["step"]) == held["adam_step"][name] == 1.0
        ttrain.load_params_(model, state.params)
        step = ttrain.make_train_step(model, ttrain.make_optimizer())
        state, loss = step(state, *_t(*run["batches"][1]))
        got = float(loss)
        assert _update_excess(state.params, ckpt, after) <= UPDATE_ATOL
    else:
        got = run["ranks"][0]["c"][onto]["loss"]
        for r in run["ranks"]:
            assert r["c"][onto]["loss"] == got
            assert r["c"][onto]["step"] == 2
            assert r["c"][onto]["unequal"] == []
            assert r["c"][onto]["update_excess"] <= UPDATE_ATOL
    np.testing.assert_allclose(got, old, rtol=LOSS_RTOL)


def test_one_device_state_restores_onto_the_mesh(run):
    for r in run["ranks"]:
        assert r["c"]["from_one_device_unequal"] == []
        np.testing.assert_allclose(r["c"]["from_one_device"],
                                   run["want"]["one_device_next"],
                                   rtol=LOSS_RTOL)


def test_segment_ids_through_the_mesh_step_match_jax(run):
    r = run["ranks"][0]["d"]
    np.testing.assert_allclose(r["packed"], run["want"]["packed"],
                               rtol=LOSS_RTOL)
    assert abs(r["packed"] - r["unpacked"]) > 1e-4   # the mask bears load


def test_prefetch_batches_hands_each_rank_its_rows(run):
    for r in run["ranks"]:
        assert r["e"]["rows"] == [True, True]
        assert r["e"]["int16"] == ["torch.int16", "torch.int16"]
        assert "does not split over dp=4" in r["e"]["uneven"]


@pytest.mark.parametrize("leaf", ["lm_head.weight", "tok_embeddings.weight",
                                  "norm.weight"])
def test_tp2_gradients_are_blocks_of_one_devices(run, leaf):
    """The lost-gather trap: each rank's gradient is its block of one
    device's; without the f operator (no sum over tp in the backward)
    the embedding's and the norm's are not."""
    want = run["want"]["grads"][leaf]
    atol = 1e-5 * float(np.abs(want).max())
    for r in run["ranks"]:
        got = np.asarray(r["f"]["grads"][leaf])
        if leaf != "norm.weight":
            rows = want.shape[0] // 2
            block = want[r["f"]["coord"] * rows:(r["f"]["coord"] + 1) * rows]
        else:
            block = want
        np.testing.assert_allclose(got, block, rtol=0, atol=atol)
        if leaf != "lm_head.weight":
            bad = np.asarray(r["f_without_copy"]["grads"][leaf])
            assert np.abs(bad - block).max() > 100 * atol
