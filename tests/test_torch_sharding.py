"""The sharding rules and the sharded training paths against the reference.

``_param_spec`` is held to the reference's for every leaf of every LM
config at full size (the reference's shapes from ``jax.eval_shape``) on
meshes (16,16), (2,16,16), (2,2), (4,1) and (1,4), FSDP on and off: a
port leaf's spec is the reference's with the group axis removed.

Then four gloo ranks on the CPU (a 2x2 ('data', 'model') ``DeviceMesh``,
or a 4-way 'data' mesh) run the sharded paths while the reference runs the
same cases in a subprocess on 4 forced host devices, as
``tests/test_dist.py`` runs it:

- the sharded step (``deepseek-moe-16b`` reduced, FSDP): every rank holds
  only its shards (elements counted per leaf), and the step equals the
  single-device step within the reference's own bounds (loss 1e-3,
  parameters 5e-3; ``tests/test_dist.py``), and the reference's sharded
  step within the same; with int8 moments too;
- ``_moe_fwd_dist`` under ``set_mesh``: output, auxiliary loss and the
  gradients of every operand within 1e-5 of the reference's ``shard_map``
  dispatch, and the output within 1e-5 of the port's one-device path;
- local SGD (R=4, ``sync_every=2``, 3 outer steps on ``h2o-danube-1.8b``
  reduced): each outer loss within 1e-5 of the reference's, the replicas
  equal after every sync, the parameters within 1e-4; the same run with
  its four replicas in one process equal within 1e-6;
- the EF all-reduce: its mean within 1e-6 of the reference's (and of 1.5
  within 0.05 on ``tests/test_dist.py``'s input), its error state too;
- ``opt_shardings`` (int8), ``cache_shardings`` and ``batch_shardings`` on
  the (2,2) mesh: the reference's specs with the group axis removed.
"""

import functools
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.models.lm import build_model
from repro_torch.sharding.rules import (P, _param_spec, batch_shardings,
                                        cache_shardings, mesh_sizes,
                                        opt_shardings, params_shardings)
from repro_torch.train.tree import tree_paths

SRC = Path(__file__).resolve().parents[1] / "src"
LM_CONFIGS = [n for n, c in sorted(list_configs().items())
              if c.family != "ising"]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}, "4x1": {"data": 4, "model": 1},
          "1x4": {"data": 1, "model": 4}}
GROUP_KEYS = ("['groups']", "['enc_groups']", "['dec_groups']")


class FakeMesh:
    """What the reference's ``_param_spec`` reads of a mesh."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


@functools.lru_cache(maxsize=None)
def ref_leaves(name):
    """(keystr, shape) of every leaf of the reference's full-size
    parameter tree (``jax.eval_shape``: no memory)."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models.lm import build_model as ref_build_model
    model = ref_build_model(ref_get_config(name))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in flat]


def port_path(ref_path, g):
    """The port's path of a reference leaf in group ``g`` (the port's
    groups are a list of per-group trees)."""
    for key in GROUP_KEYS:
        if ref_path.startswith(key):
            return f"{key}[{g}]{ref_path[len(key):]}"
    return ref_path


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_port_paths_are_the_reference_paths_per_group(name):
    """The mapping the spec test relies on, on the reduced tree: the
    port's leaf paths and shapes are the reference's, group by group."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models.lm import build_model as ref_build_model
    cfg = get_config(name).reduced()
    mine = {p: tuple(x.shape) for p, x in
            tree_paths(build_model(cfg, "cpu").init(0))}
    shapes = jax.eval_shape(ref_build_model(ref_get_config(name).reduced())
                            .init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        ps, sh = jax.tree_util.keystr(path), tuple(leaf.shape)
        if ps.startswith(GROUP_KEYS):
            for g in range(sh[0]):
                want[port_path(ps, g)] = sh[1:]
        else:
            want[ps] = sh
    assert mine == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", LM_CONFIGS)
def test_param_spec_equals_the_reference_at_full_size(name, mesh):
    from repro.sharding.rules import _n_lead_for
    from repro.sharding.rules import _param_spec as ref_param_spec
    sizes = MESHES[mesh]
    fake = FakeMesh(sizes)
    n = 0
    for ps, shape in ref_leaves(name):
        lead = _n_lead_for(ps)
        for fsdp in (False, True):
            want = tuple(ref_param_spec(ps, shape, fake, fsdp, lead))
            got = _param_spec(port_path(ps, 0), shape[lead:], sizes, fsdp)
            assert isinstance(got, P)
            assert tuple(got) == want[lead:], (ps, fsdp)
            n += 1
    assert n > 10


# -- four gloo ranks against the reference on four forced host devices -----

def moe_case():
    """deepseek-moe-16b reduced: layer 0's MoE weights (the port's init,
    seed 0) and an input of (8, 32, d_model)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    cfg = get_config("deepseek-moe-16b").reduced()
    p = build_model(cfg, "cpu").init(0)["groups"][0][0]["moe"]
    x = np.random.default_rng(5).standard_normal(
        (8, 32, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def moe_leaves(p):
    """The MoE operands in a fixed order: router, wi, wg, wo, shared."""
    return [p["router"], p["wi"], p["wg"], p["wo"], p["shared"]["wi"]["w"],
            p["shared"]["wg"]["w"], p["shared"]["wo"]["w"]]


def step_case():
    """The sharded step's case: deepseek-moe-16b reduced (FSDP), the
    port's init(0), a (8, 32) batch of numpy draws."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    cfg = get_config("deepseek-moe-16b").reduced()
    params = build_model(cfg, "cpu").init(0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)).astype(
        np.int32)
    return cfg, params, {"tokens": toks, "targets": toks,
                         "mask": np.ones((8, 32), np.int32)}


def sgd_case():
    """Local SGD: h2o-danube-1.8b reduced, 4 replicas, sync_every 2,
    3 outer steps of (4, 2, 4, 32) batches."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.train.data import MarkovLM
    cfg = get_config("h2o-danube-1.8b").reduced()
    params = build_model(cfg, "cpu").init(0)
    data = MarkovLM(cfg.vocab, seed=2)
    batches = []
    for _ in range(3):
        t = data.sample(4 * 2 * 4, 32).reshape(4, 2, 4, 32)
        batches.append({"tokens": t, "targets": t, "mask": np.ones_like(t)})
    return cfg, params, batches


def ef_case():
    """Per-replica gradients: tests/test_dist.py's constant rows, and
    random ones of a shape that is not a multiple of the 128-block."""
    rng = np.random.default_rng(9)
    return {"w": np.stack([np.full((256,), float(i), np.float32)
                           for i in range(4)]),
            "r": rng.standard_normal((4, 3, 200)).astype(np.float32)}


CASES = "".join(textwrap.dedent(inspect.getsource(f)) for f in
                (moe_case, moe_leaves, step_case, sgd_case, ef_case))

REF = CASES + """
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as JP
from repro.compat import make_mesh, auto_axes, set_mesh
from repro.configs import get_config as ref_get_config
from repro.models.lm import build_model as ref_build_model
from repro.models.moe import moe_fwd
from repro.sharding.rules import (train_state_shardings, batch_shardings,
                                  cache_shardings)
from repro.train.compression import make_ef_allreduce
from repro.train.optimizer import AdamW
from repro.train.train_step import (TrainState, make_train_step,
                                    make_local_sgd_step)
from repro_torch.interop import lm_params_to_numpy
from repro_torch.train.tree import tree_paths

out = sys.argv[1]
mesh22 = make_mesh((2, 2), ("data", "model"), axis_types=auto_axes(2))
mesh4 = make_mesh((4,), ("data",), axis_types=auto_axes(1))
J = lambda t: jax.tree.map(jnp.asarray, t)
res = {}

# the sharded step
cfg, params, batch = step_case()
model = ref_build_model(ref_get_config(cfg.name).reduced())
rp = J(lm_params_to_numpy(params))
opt = AdamW(lr=1e-3, warmup=1)
st = TrainState(params=rp, opt=opt.init(rp))
st1, m1 = jax.jit(make_train_step(model, opt))(st, J(batch))
sh = train_state_shardings(st, mesh22, True, False)
st2 = jax.tree.map(jax.device_put, st, sh)
bb = jax.tree.map(jax.device_put, J(batch), batch_shardings(J(batch), mesh22))
with set_mesh(mesh22):
    st2, m2 = jax.jit(make_train_step(model, opt))(st2, bb)
for tag, s, m in (("single", st1, m1), ("sharded", st2, m2)):
    res[f"step_{tag}_loss"] = np.float32(m["loss"])
    for i, x in enumerate(jax.tree.leaves(jax.tree.map(np.asarray,
                                                       s.params))):
        res[f"step_{tag}_p{i}"] = np.asarray(x)

# the MoE dispatch under the mesh, and its gradients
cfg, p, x = moe_case()
rcfg = ref_get_config(cfg.name).reduced()
jp = J({k: (v.numpy() if hasattr(v, "numpy") else
            jax.tree.map(lambda t: t.numpy(), v)) for k, v in p.items()})
w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

def f(x, pp):
    out, aux = moe_fwd(pp, x, top_k=rcfg.moe_top_k,
                       capacity_factor=rcfg.moe_capacity)
    return (out * w).sum() + aux, (out, aux)

xs = jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(
    mesh22, JP("data")))
with set_mesh(mesh22):
    (_, (o, a)), (gx, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(xs, jp)
res["moe_out"], res["moe_aux"] = np.asarray(o), np.asarray(a)
res["moe_gx"] = np.asarray(gx)
for i, g in enumerate(moe_leaves(gp)):
    res[f"moe_g{i}"] = np.asarray(g)

# local SGD over four devices
cfg, params, batches = sgd_case()
model = ref_build_model(ref_get_config(cfg.name).reduced())
rp = J(lm_params_to_numpy(params))
opt = AdamW(lr=3e-3, warmup=5)
outer, repl = make_local_sgd_step(model, opt, mesh4, "data", sync_every=2)
st = repl(TrainState(params=rp, opt=opt.init(rp)))
for k, b in enumerate(batches):
    st, m = outer(st, J(b))
    res[f"sgd_loss{k}"] = np.float32(m["loss"])
for i, x in enumerate(jax.tree.leaves(jax.tree.map(np.asarray, st.params))):
    res[f"sgd_p{i}"] = x

# the EF all-reduce
ef = make_ef_allreduce(mesh4, "data")
g = J(ef_case())
avg, err = ef(g, jax.tree.map(jnp.zeros_like, g))
avg2, err2 = ef(g, err)          # the error fed back once
for k in g:
    res[f"ef_avg_{k}"], res[f"ef_err_{k}"] = np.asarray(avg[k]), \\
        np.asarray(err[k])
    res[f"ef_avg2_{k}"] = np.asarray(avg2[k])

# specs on the (2,2) mesh: int8 optimizer state, caches, batches
specs = {}
cfg = ref_get_config("deepseek-moe-16b").reduced()
m = ref_build_model(cfg)
rp = m.init(jax.random.PRNGKey(0))
opt8 = AdamW(int8_state=True)
st = TrainState(params=rp, opt=opt8.init(rp))
sh = train_state_shardings(st, mesh22, True, True)
for path, s in jax.tree_util.tree_flatten_with_path(
        sh, is_leaf=lambda z: isinstance(z, jax.sharding.NamedSharding))[0]:
    specs["state" + jax.tree_util.keystr(path)] = [
        list(a) if isinstance(a, tuple) else a for a in s.spec]
for name in ("h2o-danube-1.8b", "mamba2-370m", "deepseek-7b"):
    cm = ref_build_model(ref_get_config(name).reduced())
    caches = cm.init_cache(4, 8)
    for path, s in jax.tree_util.tree_flatten_with_path(
            cache_shardings(caches, mesh22),
            is_leaf=lambda z: isinstance(z, jax.sharding.NamedSharding))[0]:
        specs[name + jax.tree_util.keystr(path)] = [
            list(a) if isinstance(a, tuple) else a for a in s.spec]
bt = {"tokens": jnp.zeros((4, 8), jnp.int32), "positions3":
      jnp.zeros((3, 4, 8), jnp.int32), "mask": jnp.zeros((6, 8), jnp.int32)}
for path, s in jax.tree_util.tree_flatten_with_path(
        batch_shardings(bt, mesh22),
        is_leaf=lambda z: isinstance(z, jax.sharding.NamedSharding))[0]:
    specs["batch" + jax.tree_util.keystr(path)] = [
        list(a) if isinstance(a, tuple) else a for a in s.spec]
np.savez(f"{out}/reference.npz", **res)
with open(f"{out}/specs.json", "w") as fh:
    json.dump(specs, fh)
"""

WORKER = CASES + """
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.core.mesh import make_mesh
from repro_torch.models.layers import set_mesh
from repro_torch.models.lm import build_model
from repro_torch.models.moe import moe_fwd
from repro_torch.sharding.rules import (batch_shardings, device_put,
                                        params_shardings,
                                        train_state_shardings)
from repro_torch.train.compression import make_ef_allreduce
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import (TrainState, make_train_step,
                                          make_local_sgd_step)
from repro_torch.train.tree import tree_leaves, tree_map

torch.set_num_threads(1)
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous",
                        world_size=world, rank=rank)
mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
T = lambda b: {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
full = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x
res = {}

# the sharded step
cfg, params, batch = step_case()
model = build_model(cfg, "cpu")
opt = AdamW(lr=1e-3, warmup=1)
st = TrainState(params=params, opt=opt.init(params))
sh = train_state_shardings(st, mesh22, True, False)
st = tree_map(device_put, st, sh)
for i, (x, m) in enumerate(zip(tree_leaves(st.params), tree_leaves(st.opt.m))):
    res[f"local_numel_p{i}"] = x.to_local().numel()
    res[f"local_numel_m{i}"] = m.to_local().numel()
bb = tree_map(device_put, T(batch), batch_shardings(T(batch), mesh22))
with set_mesh(mesh22):
    st, m = make_train_step(model, opt)(st, bb)
res["step_loss"] = float(m["loss"])
for i, x in enumerate(tree_leaves(st.params)):
    res[f"step_local_numel{i}"] = x.to_local().numel()
    res[f"step_p{i}"] = full(x).numpy()

# the same step with int8 moments (their leaves gathered for the update)
opt8 = AdamW(lr=1e-3, warmup=1, int8_state=True)
st = TrainState(params=params, opt=opt8.init(params))
st = tree_map(device_put, st, train_state_shardings(st, mesh22, True, True))
with set_mesh(mesh22):
    st, m = make_train_step(model, opt8)(st, bb)
res["int8_loss"] = float(m["loss"])
for i, x in enumerate(tree_leaves(st.params)):
    res[f"int8_p{i}"] = full(x).numpy()
for i, x in enumerate(tree_leaves(st.opt.m)):
    res[f"int8_m{i}"] = full(x).numpy()

# the MoE dispatch
cfg, p, x = moe_case()
w = torch.from_numpy(np.random.default_rng(6).standard_normal(
    x.shape).astype(np.float32))
shard = params_shardings({"groups": [({"moe": p},)]}, mesh22, True)
dp = tree_map(device_put, {"groups": [({"moe": p},)]}, shard)
dp = dp["groups"][0][0]["moe"]
leaves = tree_leaves(dp)
for t in leaves:
    t.requires_grad_()
xd = device_put(torch.from_numpy(x), batch_shardings(
    {"x": torch.from_numpy(x)}, mesh22)["x"]).requires_grad_()
with set_mesh(mesh22), implicit_replication():
    o, a = moe_fwd(dp, xd, top_k=cfg.moe_top_k,
                   capacity_factor=cfg.moe_capacity)
    loss = (o * w).sum() + a
    grads = torch.autograd.grad(loss, [xd] + moe_leaves(dp))
res["moe_out"], res["moe_aux"] = full(o).detach().numpy(), \\
    full(a).detach().numpy()
res["moe_gx"] = full(grads[0]).numpy()
for i, g in enumerate(grads[1:]):
    res[f"moe_g{i}"] = full(g).numpy()

# local SGD, one replica per rank
cfg, params, batches = sgd_case()
model = build_model(cfg, "cpu")
opt = AdamW(lr=3e-3, warmup=5)
mesh4 = make_mesh((world,), ("data",), group=dist.group.WORLD)
outer, repl = make_local_sgd_step(model, opt, mesh4, "data", sync_every=2)
st = repl(TrainState(params=params, opt=opt.init(params)))
for k, b in enumerate(batches):
    st, m = outer(st, {kk: v[rank:rank + 1] for kk, v in T(b).items()})
    res[f"sgd_loss{k}"] = float(m["loss"])
    for i, x in enumerate(tree_leaves(st.params)):
        res[f"sgd_{k}_p{i}"] = x.numpy()

# the EF all-reduce
ef = make_ef_allreduce(mesh4, "data")
g = {k: v[rank:rank + 1] for k, v in T(ef_case()).items()}
avg, err = ef(g, tree_map(torch.zeros_like, g))
avg2, _ = ef(g, err)
for k in g:
    res[f"ef_avg_{k}"], res[f"ef_err_{k}"] = avg[k].numpy(), err[k].numpy()
    res[f"ef_avg2_{k}"] = avg2[k].numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
"""

HEAD = "import json, sys\nimport numpy as np\nimport torch\n"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the four ranks, started together."""
    out = tmp_path_factory.mktemp("sharding")
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen([sys.executable, "-c", HEAD + REF, str(out)],
                              env=ref_env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    for rank in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", HEAD + WORKER, str(rank), "4", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        logs = [p.communicate(timeout=420)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=120)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return (dict(np.load(out / "reference.npz")), ranks,
            json.loads((out / "specs.json").read_text()))


def test_each_rank_holds_only_its_shards(runs):
    _, ranks, _ = runs
    cfg, params, _ = step_case()
    sizes = {"data": 2, "model": 2}
    specs = [s.spec for s in tree_paths_values(
        params_shardings(params, sizes, True))]
    leaves = [x for _, x in tree_paths(params)]
    assert len(specs) == len(leaves) and any(
        any(a is not None for a in s) for s in specs)
    for i, (x, spec) in enumerate(zip(leaves, specs)):
        k = int(np.prod([sizes[a] for a in spec if a is not None]))
        for r in ranks:
            assert r[f"local_numel_p{i}"] == x.numel() // k
            assert r[f"local_numel_m{i}"] == x.numel() // k
            assert r[f"step_local_numel{i}"] == x.numel() // k
    total = sum(int(r[f"local_numel_p{i}"]) for r in ranks
                for i in range(len(leaves)))
    assert total < 4 * sum(x.numel() for x in leaves)


def tree_paths_values(tree):
    return [x for _, x in tree_paths(tree)]


def test_sharded_step_equals_single_device_step(runs):
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainState, make_train_step
    ref, ranks, _ = runs
    cfg, params, batch = step_case()
    opt = AdamW(lr=1e-3, warmup=1)
    st, m = make_train_step(build_model(cfg, "cpu"), opt)(
        TrainState(params, opt.init(params)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    single = [x.numpy() for x in tree_paths_values(st.params)]
    for r in ranks:
        assert abs(float(r["step_loss"]) - float(m["loss"])) < 1e-3
        assert abs(float(r["step_loss"]) - float(ref["step_sharded_loss"])) \
            < 1e-3
        d = max(float(np.abs(r[f"step_p{i}"] - x).max())
                for i, x in enumerate(single))
        assert d < 5e-3
    assert all(np.array_equal(ranks[0][f"step_p{i}"], r[f"step_p{i}"])
               for r in ranks for i in range(len(single)))


def test_sharded_int8_step_equals_single_device_step(runs):
    """The sharded step with int8 moments (codes and scales laid out by
    ``opt_shardings``; each leaf gathered for its update and cut again)
    within the same bounds; its codes equal on every rank."""
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainState, make_train_step
    _, ranks, _ = runs
    cfg, params, batch = step_case()
    opt = AdamW(lr=1e-3, warmup=1, int8_state=True)
    st, m = make_train_step(build_model(cfg, "cpu"), opt)(
        TrainState(params, opt.init(params)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    single = [x.numpy() for x in tree_paths_values(st.params)]
    codes = [x.numpy() for x in tree_paths_values(st.opt.m)]
    for r in ranks:
        assert abs(float(r["int8_loss"]) - float(m["loss"])) < 1e-3
        assert max(float(np.abs(r[f"int8_p{i}"] - x).max())
                   for i, x in enumerate(single)) < 5e-3
        assert all(r[f"int8_m{i}"].dtype == np.int8
                   and r[f"int8_m{i}"].shape == c.shape
                   and np.array_equal(r[f"int8_m{i}"], ranks[0][f"int8_m{i}"])
                   for i, c in enumerate(codes))


def ref_in_port_order(ref, prefix, cfg):
    """The reference's leaves (saved in its order) in the port's order."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models.lm import build_model as ref_build_model
    from repro_torch.interop import lm_params_from_numpy
    shapes = jax.eval_shape(ref_build_model(ref_get_config(cfg.name)
                                            .reduced()).init,
                            jax.random.PRNGKey(0))
    leaves, tdef = jax.tree.flatten(shapes)
    tree = jax.tree.unflatten(tdef, [ref[f"{prefix}{i}"]
                                     for i in range(len(leaves))])
    return [x.numpy() for x in tree_paths_values(
        lm_params_from_numpy(cfg, tree, device="cpu"))]


def test_sharded_step_equals_the_reference_sharded_step(runs):
    ref, ranks, _ = runs
    cfg, _, _ = step_case()
    for tag in ("sharded", "single"):
        want = ref_in_port_order(ref, f"step_{tag}_p", cfg)
        d = max(float(np.abs(ranks[0][f"step_p{i}"] - x).max())
                for i, x in enumerate(want))
        assert d < 5e-3, tag


def test_moe_dist_dispatch_equals_the_reference(runs):
    from repro_torch.models.moe import _moe_fwd_local
    ref, ranks, _ = runs
    cfg, p, x = moe_case()
    xt = torch.from_numpy(x).requires_grad_()
    leaves = moe_leaves(p)
    for t in leaves:
        t.requires_grad_()
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        x.shape).astype(np.float32))
    o, a = _moe_fwd_local(p, xt, top_k=cfg.moe_top_k,
                          capacity_factor=cfg.moe_capacity)
    grads = torch.autograd.grad((o * w).sum() + a, [xt] + leaves)
    local = {"moe_out": o.detach().numpy(), "moe_aux": a.detach().numpy(),
             "moe_gx": grads[0].numpy()}
    local.update({f"moe_g{i}": g.numpy() for i, g in enumerate(grads[1:])})
    for key, want in local.items():
        scale = max(1.0, float(np.abs(want).max()))
        for r in ranks:
            assert np.abs(r[key] - ref[key]).max() <= 1e-5 * scale, key
    # the one-device path: the same output (its auxiliary loss is of the
    # whole batch, the dispatch's the mean of each data shard's, as in the
    # reference, so it and the gradients through it differ)
    for r in ranks:
        assert np.abs(r["moe_out"] - local["moe_out"]).max() <= 1e-5 * max(
            1.0, float(np.abs(local["moe_out"]).max()))


def test_local_sgd_equals_the_reference(runs):
    ref, ranks, _ = runs
    cfg, _, _ = sgd_case()
    for k in range(3):
        want = float(ref[f"sgd_loss{k}"])
        for r in ranks:
            assert abs(float(r[f"sgd_loss{k}"]) - want) <= 1e-5 * abs(want)
            n = sum(1 for key in r if key.startswith(f"sgd_{k}_p"))
            # the replicas are equal after every sync
            assert all(np.array_equal(r[f"sgd_{k}_p{i}"],
                                      ranks[0][f"sgd_{k}_p{i}"])
                       for i in range(n))
    n = sum(1 for key in ref if key.startswith("sgd_p"))
    want = ref_in_port_order({f"p{i}": ref[f"sgd_p{i}"][0]
                              for i in range(n)}, "p", cfg)
    d = max(float(np.abs(ranks[0][f"sgd_2_p{i}"][0] - x).max())
            for i, x in enumerate(want))
    assert d < 1e-4
    assert all(np.array_equal(ref[f"sgd_p{i}"][0], ref[f"sgd_p{i}"][3])
               for i in range(n))


def test_local_sgd_replicas_in_one_process_equal_the_ranks(runs):
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import (TrainState,
                                              make_local_sgd_step)
    _, ranks, _ = runs
    cfg, params, batches = sgd_case()
    opt = AdamW(lr=3e-3, warmup=5)
    outer, repl = make_local_sgd_step(build_model(cfg, "cpu"), opt,
                                      make_mesh((4,), ("data",)), "data",
                                      sync_every=2)
    st = repl(TrainState(params=params, opt=opt.init(params)))
    for k, b in enumerate(batches):
        st, m = outer(st, {kk: torch.from_numpy(v) for kk, v in b.items()})
        assert abs(float(m["loss"]) - float(ranks[0][f"sgd_loss{k}"])) \
            <= 1e-6 * abs(float(m["loss"]))
    for i, x in enumerate(tree_paths_values(st.params)):
        assert all(torch.equal(x[0], x[j]) for j in range(4))
        for r, rk in enumerate(ranks):
            assert np.abs(x[r].numpy() - rk[f"sgd_2_p{i}"][0]).max() <= 1e-6


def test_ef_allreduce_equals_the_reference(runs):
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train.compression import make_ef_allreduce
    ref, ranks, _ = runs
    for r, rk in enumerate(ranks):
        for key in ("w", "r"):
            for f in ("ef_avg", "ef_err", "ef_avg2"):
                got, want = rk[f"{f}_{key}"][0], ref[f"{f}_{key}"][r]
                assert np.abs(got - want).max() <= 1e-6, (f, key)
        # tests/test_dist.py: the mean of rows 0..3 is 1.5
        assert np.abs(rk["ef_avg_w"][0] - 1.5).max() < 0.05
    # the same replicas stacked in one process
    g = {k: torch.from_numpy(v) for k, v in ef_case().items()}
    avg, err = make_ef_allreduce(make_mesh((4,), ("data",)))(
        g, {k: torch.zeros_like(v) for k, v in g.items()})
    for r, rk in enumerate(ranks):
        for key in g:
            assert np.array_equal(avg[key][r].numpy(), rk[f"ef_avg_{key}"][0])
            assert np.array_equal(err[key][r].numpy(), rk[f"ef_err_{key}"][0])


def specs_of(tree, prefix):
    return {prefix + p: [list(a) if isinstance(a, tuple) else a
                         for a in s.spec]
            for p, s in tree_paths(tree)}


def drop_group_axis(ref_specs, prefix):
    """The reference's specs of a tree with stacked groups, as the port's
    per-group paths (group 0) without the group axis."""
    out = {}
    for k, v in ref_specs.items():
        if not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        hit = next((key for key in GROUP_KEYS if key in rest), None)
        if hit is None:
            out[k] = v
        else:
            i = rest.index(hit) + len(hit)
            out[prefix + rest[:i] + "[0]" + rest[i:]] = v[1:]
    return out


def group0(specs):
    """The port's specs outside the groups and of group 0 (every group
    has the same; the reference's one spec covers them all)."""
    return {k: v for k, v in specs.items()
            if "['groups'][" not in k or "['groups'][0]" in k}


def test_opt_cache_and_batch_specs_equal_the_reference(runs):
    import dataclasses
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainState
    _, _, ref_specs = runs
    mesh = {"data": 2, "model": 2}
    cfg = get_config("deepseek-moe-16b").reduced()
    params = build_model(cfg, "cpu").init(0)
    pss = params_shardings(params, mesh, True)
    opt = AdamW(int8_state=True).init(params)
    st = TrainState(params=pss, opt=opt_shardings(opt, pss, mesh, True))
    assert group0(specs_of(st, "state")) == drop_group_axis(ref_specs,
                                                            "state")
    for name in ("h2o-danube-1.8b", "mamba2-370m", "deepseek-7b"):
        model = build_model(get_config(name).reduced(), "cpu")
        mine = specs_of(cache_shardings(model.init_cache(4, 8), mesh), name)
        assert group0(mine) == drop_group_axis(ref_specs, name)
    bt = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
          "positions3": torch.zeros((3, 4, 8), dtype=torch.int32),
          "mask": torch.zeros((6, 8), dtype=torch.int32)}
    assert specs_of(batch_shardings(bt, mesh), "batch") == {
        k: v for k, v in ref_specs.items() if k.startswith("batch")}
    assert mesh_sizes(mesh) == mesh and dataclasses.is_dataclass(st)
