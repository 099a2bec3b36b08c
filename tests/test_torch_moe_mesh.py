"""The port's MoE under a mesh of ranks ≡ JAX's MoE on its device mesh.

JAX runs in this process on the 8-device CPU mesh; the port runs as 8 gloo
ranks (``tests/torch_ranks.py``), one launch shared by every case through
a module fixture, with JAX's weights carried over by ``params_from_jax``
and seeded numpy inputs, in float32.  The ranks build two meshes, dp2×ep4
and dp2×ep2×tp2, and take the ep4 and ep2×tp2 meshes inside them (the
ranks of one ``dp`` coordinate).  The configuration is JAX's
``test_moe_expert_parallel_step`` one (dim 64, 2 layers, 4 / 2 heads,
hidden 128, 4 experts, top-2, capacity 1.25) in float32 with vocab 512.

JAX runs the MoE dispatch as one global program: capacity from the global
token count, one cumsum over the global assignment order.  The port's
``dp`` ranks hold one block of that order each, so their capacity and
slots come from the global counts (``parallel/mesh.py:counts_before``); the
cases hold the port to JAX where that matters (drops at capacity 1.25
while the dp ranks compete for one expert) and show that local capacity
and slots do not.

Tolerances (f32 on both sides, sums in another order):

- losses: rtol 1e-5 (``tests/test_torch_train_mesh.py``'s);
- masters through their update from the common start: ``|Δport − Δjax|
  ≤ 1e-6 + 2e-2·|Δjax|`` (that file's), except on at most 1e-4 of a
  leaf's elements, which must stay within one lr a step of JAX's.  AdamW
  moves an element by ~lr a step whatever its gradient's size, except
  where the gradient is near Adam's eps (1e-8): there the update follows
  the gradient's last bits.  An expert's hidden unit that its few routed
  tokens barely reach has such gradients (one element of 32,768 in a
  stack: 1.43e-6 off JAX's 1.9e-5 after one step, 5.8e-6 after two); the
  gradients themselves are held below at 1e-5 of their scale;
- layer outputs: atol 1e-5; router and expert gradients: atol 1e-5 ·
  max|g| of the leaf (``tests/test_torch_train.py``'s);
- logits: atol 1e-4 (``tests/test_torch_sharded_inference.py``'s), greedy
  text and labels byte-identical;
- drops: exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.engines import train as jtrain
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu.models import moe as jmoe
from music_analyst_tpu.parallel.mesh import MeshSpec, build_mesh
from music_analyst_tpu_torch.engines import train as ttrain
from music_analyst_tpu_torch.engines.checkpoint import (
    TRAIN_STATE_FILE,
    restore_train_state,
)
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.models import moe as tmoe
from tests.torch_ranks import launch_ranks

torch.set_num_threads(1)

CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           hidden_dim=128, rope_theta=1e4, max_seq_len=128, dtype="float32",
           n_experts=4, moe_top_k=2)
B, S, STEPS = 4, 17, 2
LOSS_RTOL = 1e-5
UPDATE_ATOL, UPDATE_RTOL = 1e-6, 2e-2
LR = 3e-4                       # make_optimizer's default
NEAR_EPS_SHARE = 1e-4
OUT_ATOL = 1e-5
GRAD_RTOL = 1e-5
LOGIT_ATOL = 1e-4
DP2XEP4 = (("dp", 2), ("ep", 4))
DP2XEP2XTP2 = (("dp", 2), ("ep", 2), ("tp", 2))
# The layer cases: x [LB, LS, 64] split over dp 2.
LB, LS = 4, 16
GEN_PROMPTS = [
    "golden sunshine on the river",
    "rain",
    "shadows fall across the empty street tonight",
    "la la la la",
    "winter wind and summer fire",
    "the long road home winds past the silver lake",
]
PAGED = dict(max_new_tokens=8, n_slots=4, prefill_chunk=16)
LOGIT_IDS = [[5 + (7 * i + 3 * j) % 500 for j in range(12)] for i in range(2)]


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(1, 512, (B, S)).astype(np.int32)
        lengths = rng.integers(S // 2, S + 1, (B,)).astype(np.int32)
        out.append((ids, lengths))
    return out


def _jax_mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return build_mesh(MeshSpec(axes), devices=jax.devices()[:n])


def _port_tree(tree):
    """A JAX parameter-shaped tree as the port's ``{name: array}``, copied
    (a donated train state reuses its buffers)."""
    return {k: np.array(v) for k, v in tl.params_from_jax(
        jax.tree_util.tree_map(np.array, tree)).items()}


def _layer_inputs():
    """The MoE layer's JAX parameters and inputs.  Rank 0's dp rows (the
    first two) all score expert 0 highest, and half the tokens of rank 1's
    rows do too: the ranks compete for expert 0's slots.  Under global
    slots rank 0's assignments come first and rank 1 loses the overflow;
    under local ones each rank keeps a quarter of the global capacity."""
    layer = jmoe.MoESwiGLU(n_experts=4, hidden_dim=128, top_k=2,
                           dtype=jnp.float32, capacity_factor=1.25)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(LB, LS, 64)).astype(np.float32)
    x[:, :, 0] = -3.0
    x[: LB // 2, :, 0] = 3.0
    x[LB // 2:, : LS // 2, 0] = 3.0
    params = jax.device_get(layer.init(jax.random.PRNGKey(2),
                                       jnp.asarray(x))["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    kernel = np.array(params["router"]["kernel"])
    kernel[0, 0] = 5.0
    params["router"]["kernel"] = kernel
    cot = rng.normal(size=x.shape).astype(np.float32)
    return layer, params, x, cot


_CHILD = r"""
import json, sys
import numpy as np, torch
rank, n, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from music_analyst_tpu_torch.engines import train as T
from music_analyst_tpu_torch.engines.checkpoint import (
    restore_train_state, save_train_state)
from music_analyst_tpu_torch.models import llama as tl, moe as tmoe
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
from music_analyst_tpu_torch.parallel.sharding import shard_params
mh.initialize(f"localhost:{port}", n, rank, timeout_s=120)
data = dict(np.load(f"{work}/inputs.npz"))
spec = json.loads(open(f"{work}/spec.json").read())
cfg = spec["cfg"]
batches = [(data[f"ids{i}"], data[f"len{i}"]) for i in range(spec["steps"])]

def weights(key):
    return {k[len(key) + 2:]: torch.tensor(v)
            for k, v in data.items() if k.startswith(key + "::")}

def model_of(key, **over):
    m = tl.LlamaModel(tl.LlamaConfig(**dict(cfg, **over)))
    m.load_state_dict(weights(key))
    return m

def rows(mesh, *arrays):
    return tuple(torch.tensor(M.batch_sharding(mesh, a)) for a in arrays)

def block_of(state, name, full):
    piece = state.tp_layout.get(name)
    return piece.take(full) if piece is not None else full

def saved(path):
    return torch.load(f"{path}/train_state.pt", weights_only=True)

# This rank's masters, moments and step counts that differ from its block
# (and ZeRO-1 row) of the global tensors saved in path.
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

def update_excess(state, start, end, rtol):
    a, b = saved(start)["params"], saved(end)["params"]
    excess = 0.0
    for name, master in state.params.items():
        base = block_of(state, name, a[name])
        want = block_of(state, name, b[name]) - base
        excess = max(excess, float(((master - base - want).abs()
                                    - rtol * want.abs()).max()))
    return excess

def sub_mesh(grid, axes):
    # The ranks of this rank's dp coordinate of grid, on axes.
    line = [r for r in range(n) if r // (n // 2) == rank // (n // 2)]
    return M.DeviceMesh(tuple(grid.devices[r] for r in line), axes,
                        line.index(rank),
                        {a: grid.group(a) for a, _ in axes})

A = M.build_mesh(M.MeshSpec((("dp", 2), ("ep", 4))), device="cpu")
Bm = M.build_mesh(M.MeshSpec((("dp", 2), ("ep", 2), ("tp", 2))), device="cpu")
opt = T.make_optimizer()
out, blocks = {}, {}

# (a) JAX's dp2 x ep4 step, with ZeRO-1: the blocks, one step, saved; one
# more step on the same mesh.
model = model_of("train")
state = T.init_train_state(model, opt, seed=None, mesh=A, zero1=True)
for name in ("gate_experts", "up_experts", "down_experts"):
    blocks[f"init.{name}"] = state.params[
        f"layers.0.feed_forward_moe.{name}"].clone().numpy()
step = T.make_train_step(model, opt, mesh=A)
state, loss = step(state, *rows(A, *batches[0]))
save_train_state(state, f"{work}/a_ckpt")
out["a"] = dict(loss=float(loss), saved_unequal=unequal(state, f"{work}/a_ckpt"),
                moment_numel={name: state.opt_state.state[t]["exp_avg"].numel()
                              for name, t in state.opt_tensors().items()},
                sharded=sorted(state.zero1))
state, old = step(state, *rows(A, *batches[1]))
save_train_state(state, f"{work}/a_next")
out["a"]["old"] = float(old)

# (b) two steps on dp2 x ep2 x tp2, plain and ZeRO-1.
for tag, zero1 in (("plain", False), ("zero1", True)):
    bmodel = model_of("train")
    bstate = T.init_train_state(bmodel, opt, seed=None, mesh=Bm, zero1=zero1)
    bstep = T.make_train_step(bmodel, opt, mesh=Bm)
    losses = []
    for ids, lens in batches:
        bstate, loss = bstep(bstate, *rows(Bm, ids, lens))
        losses.append(float(loss))
    save_train_state(bstate, f"{work}/b_{tag}")
    out[f"b_{tag}"] = dict(losses=losses)

# (e) the dp2 x ep4 ZeRO-1 state restored onto dp2 x ep2 x tp2 (ZeRO-1),
# then the step one more step on the old mesh took.
emodel = tl.LlamaModel(tl.LlamaConfig(**cfg))
like = T.init_train_state(emodel, opt, seed=1, mesh=Bm, zero1=True)
restored = restore_train_state(f"{work}/a_ckpt", like=like)
out["e"] = dict(unequal=unequal(restored, f"{work}/a_ckpt"))
estep = T.make_train_step(emodel, opt, mesh=Bm)
restored, loss = estep(restored, *rows(Bm, *batches[1]))
out["e"].update(loss=float(loss), step=int(restored.step),
                update_excess=update_excess(restored, f"{work}/a_ckpt",
                                            f"{work}/a_next",
                                            spec["update_rtol"]))

# (c, d) one MoE layer over the dp rows: output, drops and gradients; with
# local capacity and slots; with the router's gradient left unsummed.
x_all = torch.tensor(data["layer_x"])
cot_all = torch.tensor(data["layer_cot"])
real_router = tmoe.MoESwiGLU._router_weight
for mname, mesh in (("dp2xep4", A), ("dp2xep2xtp2", Bm)):
    layer = tmoe.MoESwiGLU(64, 4, 128, top_k=2, dtype=torch.float32,
                           capacity_factor=1.25)
    layer.load_state_dict(weights("layer"))
    shard_params(layer, mesh)
    x = torch.tensor(M.batch_sharding(mesh, x_all.numpy()))
    cot = torch.tensor(M.batch_sharding(mesh, cot_all.numpy()))
    res = {}
    for variant in ("global", "local", "router_unsummed"):
        if variant == "router_unsummed":
            tmoe.MoESwiGLU._router_weight = lambda self: self.router.weight
        try:
            layer.zero_grad(set_to_none=True)
            y = layer(x, dp_rows=variant != "local")
            (y * cot).sum().backward()
        finally:
            tmoe.MoESwiGLU._router_weight = real_router
        grads = {name: M.all_reduce(p.grad, mesh, "dp").numpy()
                 for name, p in layer.named_parameters()}
        for name, g in grads.items():
            blocks[f"{mname}.{variant}.grad.{name}"] = g
        blocks[f"{mname}.{variant}.out"] = y.detach().numpy()
        res[variant] = dict(dropped=int(layer.last_dropped))
    res["expert_start"] = layer.expert_start
    res["hidden_start"] = (None if layer.down_rows is None
                           else layer.down_rows.start)
    out[f"layer_{mname}"] = res

# (f) the MoE classifier at ep4 and at dp2 x ep2 x tp2; (g) int8 experts
# at ep2 x tp2.
ids = torch.tensor(spec["logit_ids"])
L = ids.shape[1]
from music_analyst_tpu_torch.models import layers as Ly
for tag, mesh, over in (("ep4", sub_mesh(A, (("ep", 4),)), {}),
                        ("dp2xep2xtp2", Bm, {}),
                        ("ep2xtp2_int8", sub_mesh(Bm, (("ep", 2), ("tp", 2))),
                         {"quant": "int8"})):
    clf = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig(**dict(cfg, **over)), max_prompt_len=64,
        state_dict=weights("clf"), mesh=mesh)
    res = dict(paged=clf.generate_batch_continuous(spec["prompts"],
                                                   **spec["paged"]),
               static=clf.generate_batch(spec["prompts"], max_new_tokens=8),
               score=clf.classify_batch(spec["prompts"]))
    with torch.no_grad():
        logits, _ = clf.model(ids, torch.arange(L).expand(len(ids), L),
                              Ly.causal_mask(L, L))
    res["logits"] = logits.tolist()
    res["expert_rows"] = clf.model.layers[0].feed_forward_moe.gate_experts.shape[0]
    out[tag] = res
np.savez(f"{work}/rank{rank}.npz", **blocks)
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's runs in this process, the port's 8 ranks in one launch."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    batches = _batches()
    jids = [(jnp.asarray(i), jnp.asarray(n)) for i, n in batches]
    cfg = jl.LlamaConfig(**CFG)
    model = jl.LlamaModel(cfg)
    jopt = jtrain.make_optimizer()
    mesh_a, mesh_b = _jax_mesh(DP2XEP4), _jax_mesh(DP2XEP2XTP2)
    inputs = {}
    want = {}
    state = jtrain.init_train_state(model, jopt, jids[0], seed=7,
                                    mesh=mesh_a, zero1=True)
    weights = _port_tree(state.params)
    inputs.update({f"train::{k}": v for k, v in weights.items()})
    moe = state.params["layer_0"]["feed_forward_moe"]
    want["shards"] = [{name: np.array(next(
        s.data for s in moe[name].addressable_shards if s.device == dev))
        for name in ("gate_experts", "up_experts", "down_experts")}
        for dev in mesh_a.devices.flat]
    mu = state.opt_state[0].mu
    want["moment_numel"] = [
        {name: int(v.flat[0]) for name, v in _port_tree(
            jax.tree_util.tree_map(
                lambda leaf, dev=dev: np.full(leaf.shape, {
                    s.device: s.data.size for s in leaf.addressable_shards
                }[dev]), mu)).items()}
        for dev in mesh_a.devices.flat]
    step = jtrain.make_train_step(model, jopt, mesh=mesh_a)
    state, loss = step(state, *jids[0])
    want["a_loss"] = float(loss)
    want["a_masters"] = _port_tree(state.params)
    for tag, zero1 in (("plain", False), ("zero1", True)):
        bstate = jtrain.init_train_state(model, jopt, jids[0], seed=7,
                                         mesh=mesh_b, zero1=zero1)
        bstep = jtrain.make_train_step(model, jopt, mesh=mesh_b)
        losses = []
        for ids, lengths in jids:
            bstate, loss = bstep(bstate, ids, lengths)
            losses.append(float(loss))
        want[f"b_{tag}"] = dict(losses=losses,
                                masters=_port_tree(bstate.params))
    for i, (ids, lengths) in enumerate(batches):
        inputs[f"ids{i}"], inputs[f"len{i}"] = ids, lengths

    layer, lparams, x, cot = _layer_inputs()
    want["layer_out"] = np.asarray(layer.apply({"params": lparams},
                                               jnp.asarray(x)))
    grads = jax.grad(lambda p: jnp.sum(
        layer.apply({"params": p}, jnp.asarray(x)) * cot))(lparams)
    want["layer_grads"] = {
        "gate_experts": np.asarray(grads["gate_experts"]),
        "up_experts": np.asarray(grads["up_experts"]),
        "down_experts": np.asarray(grads["down_experts"]),
        "router.weight": np.asarray(grads["router"]["kernel"]).T}
    layer_weights = {
        "gate_experts": lparams["gate_experts"],
        "up_experts": lparams["up_experts"],
        "down_experts": lparams["down_experts"],
        "router.weight": np.asarray(lparams["router"]["kernel"]).T}
    inputs.update({f"layer::{k}": np.asarray(v)
                   for k, v in layer_weights.items()})
    inputs["layer_x"], inputs["layer_cot"] = x, cot
    # Drops of the whole batch on one device (the port's layer equals
    # JAX's there, tests/test_torch_moe.py), global and per dp half.
    one = tmoe.MoESwiGLU(64, 4, 128, top_k=2, dtype=torch.float32,
                         capacity_factor=1.25)
    one.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in layer_weights.items()})
    with torch.no_grad():
        one(torch.tensor(x))
        want["dropped"] = int(one.last_dropped)
        halves = 0
        for half in (x[: LB // 2], x[LB // 2:]):
            one(torch.tensor(half))
            halves += int(one.last_dropped)
        want["dropped_local"] = halves

    clf = jl.LlamaZeroShotClassifier(config=cfg, max_prompt_len=64, seed=11)
    inputs.update({f"clf::{k}": v for k, v in _port_tree(clf.params).items()})
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "spec.json").write_text(json.dumps(dict(
        cfg=CFG, steps=STEPS, update_rtol=UPDATE_RTOL, prompts=GEN_PROMPTS,
        paged=PAGED, logit_ids=LOGIT_IDS)))
    outs = launch_ranks(_CHILD, 8, [tmp], tmp / "ranks", timeout=300.0)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    blocks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(8)]
    return dict(want=want, ranks=ranks, blocks=blocks, tmp=tmp,
                batches=batches, weights=weights, cfg=cfg, x=x)


def _saved(path):
    return torch.load(path / TRAIN_STATE_FILE, weights_only=True)


def _assert_updates(saved, want, start, steps):
    """The masters' updates against JAX's: within the update tolerance
    but for a share of near-eps elements, each within ``steps`` lr."""
    for name, w in want.items():
        got = saved["params"][name].numpy()
        assert got.shape == w.shape, name
        d_got, d_want = got - start[name], w - start[name]
        off = np.abs(d_got - d_want)
        beyond = off > UPDATE_ATOL + UPDATE_RTOL * np.abs(d_want)
        assert beyond.mean() <= NEAR_EPS_SHARE, (name, int(beyond.sum()))
        assert off.max() <= steps * LR, (name, float(off.max()))


def test_dp2xep4_step_matches_jax(run):
    """JAX's ``test_moe_expert_parallel_step`` (dp2×ep4, ZeRO-1): the
    loss, every rank's expert blocks equal to JAX's addressable shard on
    the device of its index, and the masters after the step."""
    want = run["want"]
    for rank, (r, b) in enumerate(zip(run["ranks"], run["blocks"])):
        np.testing.assert_allclose(r["a"]["loss"], want["a_loss"],
                                   rtol=LOSS_RTOL)
        for name, shard in want["shards"][rank].items():
            np.testing.assert_array_equal(b[f"init.{name}"], shard)
        assert r["a"]["saved_unequal"] == []
    _assert_updates(_saved(run["tmp"] / "a_ckpt"), want["a_masters"],
                    run["weights"], 1)


def test_dp2xep4_zero1_shares_equal_jax_addressable_shards(run):
    """Each rank's moments hold as many elements as JAX's addressable
    shard of the leaf (the expert stacks: their ep block cut over dp)."""
    for rank, r in enumerate(run["ranks"]):
        assert r["a"]["moment_numel"] == run["want"]["moment_numel"][rank]
    sharded = run["ranks"][0]["a"]["sharded"]
    assert "layers.0.feed_forward_moe.gate_experts" in sharded


@pytest.mark.parametrize("tag", ["plain", "zero1"])
def test_dp2xep2xtp2_steps_match_jax(run, tag):
    want = run["want"][f"b_{tag}"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r[f"b_{tag}"]["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
    _assert_updates(_saved(run["tmp"] / f"b_{tag}"), want["masters"],
                    run["weights"], STEPS)


@pytest.mark.parametrize("mesh", ["dp2xep4", "dp2xep2xtp2"])
def test_layer_output_and_drops_match_jax_across_dp(run, mesh):
    """The dp ranks compete for expert 0's slots: each rank's output rows
    equal JAX's global program's, and the drops are the whole batch's."""
    want = run["want"]
    assert want["dropped"] != want["dropped_local"]   # the inputs bear load
    half = LB // 2
    for rank, (r, b) in enumerate(zip(run["ranks"], run["blocks"])):
        rows = want["layer_out"][(rank // 4) * half:(rank // 4 + 1) * half]
        np.testing.assert_allclose(b[f"{mesh}.global.out"], rows,
                                   atol=OUT_ATOL)
        assert r[f"layer_{mesh}"]["global"]["dropped"] == want["dropped"]


@pytest.mark.parametrize("mesh", ["dp2xep4", "dp2xep2xtp2"])
def test_local_capacity_and_slots_fail(run, mesh):
    """Local capacity and slots (each dp rank its own program) drop other
    assignments than JAX and move the output."""
    want = run["want"]
    # Each dp rank counts its own drops under local slots (ranks 0 and 4
    # are the two dp rows' first ranks).
    local = sum(run["ranks"][r][f"layer_{mesh}"]["local"]["dropped"] for r in (0, 4))
    assert local == want["dropped_local"] != want["dropped"]
    half = LB // 2
    worst = 0.0
    for rank, b in enumerate(run["blocks"]):
        rows = want["layer_out"][(rank // 4) * half:(rank // 4 + 1) * half]
        worst = max(worst, float(np.abs(b[f"{mesh}.local.out"] - rows).max()))
    assert worst > 100 * OUT_ATOL


@pytest.mark.parametrize("mesh", ["dp2xep4", "dp2xep2xtp2"])
def test_router_and_expert_gradients_match_jax(run, mesh):
    """The router's gradient (summed over dp here, as the train step
    does) equals JAX's on every rank, and each rank's expert-stack
    gradients are its blocks of JAX's; with the router's f taken out, a
    rank holds only its own experts' share and the check fails."""
    want = run["want"]["layer_grads"]
    for r, b in zip(run["ranks"], run["blocks"]):
        e0 = r[f"layer_{mesh}"]["expert_start"]
        h0 = r[f"layer_{mesh}"]["hidden_start"] or 0
        for name, g in want.items():
            got = b[f"{mesh}.global.grad.{name}"]
            if name != "router.weight":
                el = got.shape[0]
                hl = got.shape[2] if name != "down_experts" else got.shape[1]
                g = g[e0:e0 + el]
                g = (g[:, h0:h0 + hl] if name == "down_experts"
                     else g[:, :, h0:h0 + hl])
            atol = GRAD_RTOL * float(np.abs(g).max())
            np.testing.assert_allclose(got, g, rtol=0, atol=atol,
                                       err_msg=name)
        bad = b[f"{mesh}.router_unsummed.grad.router.weight"]
        router = want["router.weight"]
        assert np.abs(bad - router).max() > 100 * GRAD_RTOL * np.abs(
            router).max()


def test_zero1_checkpoint_restores_across_layouts(run):
    """A dp2×ep4 ZeRO-1 state restored onto dp2×ep2×tp2 (ZeRO-1) holds the
    saved masters, moments and step counts bit for bit (each rank its
    block and ZeRO-1 row) and takes the step one more step on the old
    mesh takes."""
    old = run["ranks"][0]["a"]["old"]
    for r in run["ranks"]:
        assert r["e"]["unequal"] == []
        assert r["e"]["step"] == 2
        assert r["e"]["update_excess"] <= UPDATE_ATOL
        np.testing.assert_allclose(r["e"]["loss"], old, rtol=LOSS_RTOL)


def test_zero1_checkpoint_restores_onto_one_device(run):
    ckpt, after = run["tmp"] / "a_ckpt", run["tmp"] / "a_next"
    state = restore_train_state(str(ckpt), device="cpu")
    held = _saved(ckpt)
    assert int(state.step) == 1
    for name, t in state.opt_tensors().items():
        assert torch.equal(state.params[name], held["params"][name])
        st = state.opt_state.state[t]
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], held[key][name]), (name, key)
        assert float(st["step"]) == held["adam_step"][name] == 1.0
    model = tl.LlamaModel(tl.LlamaConfig(**CFG))
    ttrain.load_params_(model, state.params)
    step = ttrain.make_train_step(model, ttrain.make_optimizer())
    state, loss = step(state, *(torch.tensor(a) for a in run["batches"][1]))
    np.testing.assert_allclose(float(loss), run["ranks"][0]["a"]["old"],
                               rtol=LOSS_RTOL)
    a, b = _saved(ckpt)["params"], _saved(after)["params"]
    for k, got in state.params.items():
        np.testing.assert_allclose((got - a[k]).numpy(), (b[k] - a[k]).numpy(),
                                   rtol=UPDATE_RTOL, atol=UPDATE_ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_clfs(run):
    cfg = run["cfg"]
    out = {}
    for tag, axes, over in (("ep4", (("ep", 4),), {}),
                            ("dp2xep2xtp2", DP2XEP2XTP2, {}),
                            ("ep2xtp2_int8", (("ep", 2), ("tp", 2)),
                             {"quant": "int8"})):
        c = jl.LlamaConfig(**dict(CFG, **over))
        out[tag] = jl.LlamaZeroShotClassifier(
            config=c, max_prompt_len=64, seed=11, mesh=_jax_mesh(axes))
    return out


CLASSIFIERS = ["ep4", "dp2xep2xtp2", "ep2xtp2_int8"]


@pytest.mark.parametrize("route", ["paged", "static", "score"])
@pytest.mark.parametrize("tag", CLASSIFIERS)
def test_moe_classifier_on_ranks_equals_jax(run, jax_clfs, tag, route):
    clf = jax_clfs[tag]
    if route == "paged":
        want = clf.generate_batch_continuous(GEN_PROMPTS, **PAGED)
    elif route == "static":
        want = clf.generate_batch(GEN_PROMPTS, max_new_tokens=8)
    else:
        want = clf.classify_batch(GEN_PROMPTS)
    for r in run["ranks"]:
        assert r[tag][route] == want


@pytest.mark.parametrize("tag", CLASSIFIERS)
def test_moe_classifier_logits_on_ranks_equal_jax(run, jax_clfs, tag):
    clf = jax_clfs[tag]
    ids = jnp.asarray(LOGIT_IDS, dtype=jnp.int32)
    L = ids.shape[1]
    pos = jnp.broadcast_to(jnp.arange(L), ids.shape)
    want, _ = clf.model.apply({"params": clf.params}, ids, pos,
                              jl.causal_mask(L, L, 0))
    experts = {"ep4": 1, "dp2xep2xtp2": 2, "ep2xtp2_int8": 2}[tag]
    for r in run["ranks"]:
        assert r[tag]["expert_rows"] == experts
        np.testing.assert_allclose(np.asarray(r[tag]["logits"]),
                                   np.asarray(want), atol=LOGIT_ATOL)
