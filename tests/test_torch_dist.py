"""One brick (or partition) per rank: the mesh engines over a
``torch.distributed`` process group against the same mesh in one process.

Two groups of gloo ranks on the CPU (2 and 4 processes, started together)
run every case of their ``CASES``, each rank holding one brick: halos
travel as point-to-point messages (1-bit ``pack_pm1`` bytes on int8 and
f32 with ``bitpack_halos=True``, int32 views of the word planes on the
bit-plane path), flips and energies are summed with ``all_reduce``, and
the global state is gathered with ``all_gather``.  Every rank's energies,
flips, its own brick and the gathered global state must equal the
one-process mesh's bitwise.

The distributed DSIM (``make_engine("dsim_dist")``) runs its ``DIST_CASES``
in the same ranks, one partition per rank: the boundary travels as the
reference's wire payload through one ``all_gather`` (``pack_pm1`` bytes
on f32 with ``bitpack``, int8 spins, f32 window means on cmft, int32
views of the words on the bit-plane path), flips are summed with
``all_reduce``, and every rank's energies, flips, gathered global state
and own partition must equal the one-process engine's bitwise.

Each rank's engine holds one brick's or one partition's share of the
problem (``tests/test_torch_residency.py``): no tensor it holds has the
whole lattice's (X, Y, Z) as its trailing dims, or leads with more than one
partition, apart from the caller's problem and the whole index tables
listed there, and its brick's or partition's constants equal the
one-process engine's there bitwise.

Both mesh engines also run their ``DEG_CASES`` with a degrade policy and
injected fault codes in the same ranks: the lattice's checked exchange
sends each face's header [seq, checksum] as a message of its own and
takes the worst health over the ranks with ``all_reduce(MAX)``, the
distributed DSIM gathers the headers with the pool.  Every rank's state
(after the last chunk, or before the chunk whose check raised), energies,
flips, health report and the point where it raised must equal the
one-process engine's bitwise.
"""

import dataclasses
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

from repro_torch import make_engine
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.bricks import BrickState
from repro_torch.core.mesh import make_mesh
from repro_torch.interop import state_to_numpy
from test_torch_residency import (WHOLE_TABLES, dist_problem, held_tensors,
                                  partition_tensors)

SRC = Path(__file__).resolve().parents[1] / "src"
AXES = ("x", "y", "z")
SEED, INIT_SEED = 1, 3
SWEEPS, POINTS = 16, [8, 16]

# world size -> name: (L, mesh shape, precision, R, sync_every,
# bitpack_halos, fused)
CASES = {
    2: {"x2-int8": (6, (2, 1, 1), "int8", 3, 4, True, True),
        "z2-int8-unpacked-per-phase": (6, (1, 1, 2), "int8", 2, 1, False,
                                       False),
        "y2-bitplane40": (6, (1, 2, 1), "bitplane", 40, 4, True, True),
        "x2-f32": (6, (2, 1, 1), "f32", 2, 1, True, True)},
    4: {"xz-int8": (6, (2, 1, 2), "int8", 3, 1, True, True),
        "xy-bitplane5": (6, (2, 2, 1), "bitplane", 5, 4, True, True),
        "yz-f32-unpacked": (6, (1, 2, 2), "f32", 2, 4, False, True),
        "z4-int8": (8, (1, 1, 4), "int8", 2, 4, True, True)},
}

# world size -> name: (problem, precision, R, sync_every, mode, bitpack);
# the partition count is the world size
DIST_CASES = {
    2: {"dist-reg-int8": ("regular", "int8", 3, 4, "dsim", True),
        "dist-reg-f32-bitpack": ("regular", "f32", 2, 1, "dsim", True),
        "dist-ea3d-bitplane40": ("ea3d", "bitplane", 40, "phase", "dsim",
                                 True)},
    4: {"dist-reg-int8-phase": ("regular", "int8", 2, "phase", "dsim",
                                True),
        "dist-reg-cmft": ("regular", "f32", 2, 4, "cmft", True),
        "dist-ea3d-f32-unpacked": ("ea3d", "f32", 2, 4, "dsim", False),
        "dist-ea3d-bitplane5": ("ea3d", "bitplane", 5, 1, "dsim", True)},
}
DIST_FIELDS = ("m", "ghosts", "macc", "rng", "sweep", "flips")

# world size -> name: (engine, its CASES or DIST_CASES tuple, degrade
# policy, fault codes)
DEG_CASES = {
    2: {"deg-x2-int8-hold": ("lattice", (6, (2, 1, 1), "int8", 3, 2, True,
                                         True), "stale_hold:4",
                             [0, 2, 0, 1, 0, 0, 0, 0]),
        "deg-dist-reg-int8-freeze": ("dsim_dist", ("regular", "int8", 3, 2,
                                                   "dsim", True),
                                     "freeze_boundary", [0, 0, 2])},
    4: {"deg-xz-bitplane5-failfast": ("lattice", (6, (2, 1, 2), "bitplane",
                                                  5, 2, True, True),
                                      "fail_fast", [0, 0, 0, 0, 0, 1]),
        "deg-yz-f32-hold": ("lattice", (6, (1, 2, 2), "f32", 2, 2, False,
                                        True), "stale_hold:2",
                            [0, 1, 2, 0]),
        "deg-dist-ea3d-bitplane40-hold": ("dsim_dist", ("ea3d", "bitplane",
                                                        40, 2, "dsim",
                                                        True),
                                          "stale_hold:8", [0, 1, 0, 2]),
        "deg-dist-reg-f32-failfast": ("dsim_dist", ("regular", "f32", 2, 2,
                                                    "dsim", True),
                                      "fail_fast", [0, 0, 0, 0, 0, 2])},
}


def degraded_run(engine, case, policy, codes, world, group=None):
    """A DEG_CASES case chunk by chunk: (handle, cursor, raised), the
    cursor stopped after the last chunk or before the one that raised."""
    from repro_torch import make_engine
    from repro_torch.core.annealing import ea_schedule
    from repro_torch.core.degrade import StateCorruption
    from repro_torch.core.mesh import make_mesh
    if engine == "lattice":
        L, shape, prec, R, sync, bp, fused = case
        h = make_engine("lattice", L=L, seed=1, replicas=R, precision=prec,
                        mesh=make_mesh(shape, ("x", "y", "z"), group=group),
                        dim_axes=("x", "y", "z"), bitpack_halos=bp,
                        fused=fused, degrade=policy, device="cpu")
    else:
        kind, prec, R, sync, mode, bp = case
        h = make_engine("dsim_dist", dist_problem(kind, world), rng="lfsr",
                        precision=prec, replicas=R, mode=mode, bitpack=bp,
                        degrade=policy, device="cpu",
                        mesh=None if group is None else
                        make_mesh((world,), ("data",), group=group))
    h.eng.set_exchange_faults(codes)
    cur = h.start_recorded(h.init_state(seed=3), ea_schedule(16), [8, 16],
                           sync_every=sync)
    raised = False
    while not cur.done:
        try:
            cur.advance(1)
        except StateCorruption:
            raised = True
            break
    return h, cur, raised


def brick_consts(b):
    """A brick's problem constants by name, tuples flattened (w60, ...)."""
    out = {}
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        for i, x in enumerate(v if isinstance(v, tuple) else (v,)):
            if x is not None:
                out[f.name + (str(i) if isinstance(v, tuple) else "")] = x
    return out


WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import make_engine
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.mesh import make_mesh
from repro_torch.interop import state_to_numpy

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cases, dist_cases = json.loads(sys.argv[4]), json.loads(sys.argv[5])
deg_cases = json.loads(sys.argv[6])
dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous-{world}",
                        world_size=world, rank=rank)


def host(t):
    return (t.view(torch.int32) if t.dtype == torch.uint32 else t).numpy()


for name, (L, shape, prec, R, sync, bp, fused) in cases.items():
    mesh = make_mesh(shape, ("x", "y", "z"), group=dist.group.WORLD)
    h = make_engine("lattice", L=L, seed=%(seed)d, replicas=R,
                    precision=prec, mesh=mesh, dim_axes=("x", "y", "z"),
                    bitpack_halos=bp, fused=fused, device="cpu")
    st0 = h.init_state(seed=%(init_seed)d)
    e0 = h.energy(st0)
    st, rec = h.run_recorded(st0, ea_schedule(%(sweeps)d), %(points)r,
                             sync_every=sync)
    g = state_to_numpy(h.eng.global_state(st))
    brick = {f"brick_{f}": host(getattr(st, f)) for f in ("m", "s")}
    brick.update({f"brick_halo{i}": host(x) for i, x in enumerate(st.halos)})
    # the problem constants the rank holds: its brick's, no tensor with
    # the whole lattice's (X, Y, Z) as its trailing dims
    brick["n_wide"] = sum(tuple(t.shape[-3:]) == tuple(h.eng.p.dims)
                          for _, t in held_tensors(h.eng))
    brick["n_bricks"] = len(h.eng._bricks)
    brick.update({f"const_{k}": host(t)
                  for k, t in brick_consts(h.eng._bricks[0]).items()})
    np.savez(f"{out}/{name}-{rank}.npz", e0=e0.numpy(),
             energies=rec.energies.numpy(), total_flips=rec.flips,
             spins=h.global_spins(st).numpy(), coord=h.eng.coords[0],
             m=g["m"], s=g["s"], sweep=g["sweep"], flips=g["flips"],
             **{f"halo{i}": x for i, x in enumerate(g["halos"])}, **brick)
for name, (kind, prec, R, sync, mode, bp) in dist_cases.items():
    h = make_engine("dsim_dist", dist_problem(kind, world), rng="lfsr",
                    precision=prec, replicas=R, mode=mode, bitpack=bp,
                    mesh=make_mesh((world,), ("data",),
                                   group=dist.group.WORLD), device="cpu")
    st0 = h.init_state(seed=%(init_seed)d)
    e0 = h.energy(st0)
    st, rec = h.run_recorded(st0, ea_schedule(%(sweeps)d), %(points)r,
                             sync_every=sync)
    g = state_to_numpy(h.eng.global_state(st))
    own = {f"own_{f}": host(getattr(st, f)) for f in ("m", "ghosts", "rng")}
    # the problem constants the rank holds: one partition's rows
    held = partition_tensors(h.eng)
    own["n_wide"] = sum(t.shape[0] != 1 for _, t in held)
    own.update({f"const_{i}": host(t) for i, (_, t) in enumerate(held)})
    with open(f"{out}/{name}-{rank}.paths.json", "w") as f:
        json.dump([p for p, _ in held], f)
    np.savez(f"{out}/{name}-{rank}.npz", e0=e0.numpy(),
             energies=rec.energies.numpy(), total_flips=rec.flips,
             spins=h.global_spins(st).numpy(), **g, **own)
for name, (engine, case, pol, codes) in deg_cases.items():
    h, cur, raised = degraded_run(engine, case, pol, codes, world,
                                  dist.group.WORLD)
    g = state_to_numpy(h.eng.global_state(cur.state))
    g.update({f"halo{i}": x for i, x in enumerate(g.pop("halos", ()))})
    rec = cur.record()
    np.savez(f"{out}/{name}-{rank}.npz", energies=rec.energies.numpy(),
             total_flips=rec.flips, sweeps_done=cur.sweeps_done, **g)
    with open(f"{out}/{name}-{rank}.json", "w") as f:
        json.dump(dict(raised=raised, report=h.eng.health.report()), f)
# drop the engines (they hold the group) while it is alive, and let every
# rank finish before any tears its connections down: released only at
# interpreter exit, after the group, they can abort the process there
for name in ("h", "cur", "st0", "st", "rec"):
    globals().pop(name, None)
import gc
gc.collect()
dist.barrier()
dist.destroy_process_group()
""" % dict(seed=SEED, init_seed=INIT_SEED, sweeps=SWEEPS, points=POINTS)
WORKER = "import dataclasses\nimport torch\n" \
    + f"WHOLE_TABLES = {WHOLE_TABLES!r}\n" + "".join(
        textwrap.dedent(inspect.getsource(f)) for f in (
            dist_problem, degraded_run, held_tensors, partition_tensors,
            brick_consts)) + WORKER


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start every group's ranks together; wait for all of them.  Each
    group meets in a rendezvous file of its own in the test's directory,
    so no port is claimed before the ranks start."""
    out = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = []
    for world, cases in CASES.items():
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(rank), str(world),
                 str(out), json.dumps(cases),
                 json.dumps(DIST_CASES[world]),
                 json.dumps(DEG_CASES[world])],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=120)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return out


def in_process(case):
    L, shape, prec, R, sync, bp, fused = case
    h = make_engine("lattice", L=L, seed=SEED, replicas=R, precision=prec,
                    mesh=make_mesh(shape, AXES), dim_axes=AXES,
                    bitpack_halos=bp, fused=fused, device="cpu")
    st0 = h.init_state(seed=INIT_SEED)
    e0 = h.energy(st0)
    st, rec = h.run_recorded(st0, ea_schedule(SWEEPS), POINTS,
                             sync_every=sync)
    return h, e0, st, rec


def as_numpy(t):
    return (t.view(torch.int32) if t.dtype == torch.uint32 else t).numpy()


@pytest.mark.parametrize("world,name", [(w, n) for w, cases in CASES.items()
                                        for n in cases])
def test_ranks_equal_the_one_process_mesh(ranks, world, name):
    h, e0, st, rec = in_process(CASES[world][name])
    assert isinstance(st, BrickState) and st.m.shape[0] == world
    g = state_to_numpy(st)
    spins = h.global_spins(st).numpy()
    coords = []
    for rank in range(world):
        r = np.load(ranks / f"{name}-{rank}.npz")
        np.testing.assert_array_equal(r["e0"], e0.numpy())
        np.testing.assert_array_equal(r["energies"], rec.energies.numpy())
        assert int(r["total_flips"]) == rec.flips > 0
        np.testing.assert_array_equal(r["spins"], spins)
        for f in ("m", "s", "sweep", "flips"):
            assert r[f].dtype == g[f].dtype
            np.testing.assert_array_equal(r[f], g[f], err_msg=f)
        for i, x in enumerate(g["halos"]):
            np.testing.assert_array_equal(r[f"halo{i}"], x)
        # the rank's own brick is the one-process mesh's brick there
        k = h.eng.coords.index(tuple(int(c) for c in r["coord"]))
        coords.append(k)
        np.testing.assert_array_equal(r["brick_m"][0], as_numpy(st.m[k]))
        np.testing.assert_array_equal(r["brick_s"][0], as_numpy(st.s[k]))
        for i, x in enumerate(st.halos):
            np.testing.assert_array_equal(r[f"brick_halo{i}"][0],
                                          as_numpy(x[k]))
        # it holds that brick's constants and nothing of the whole lattice
        assert int(r["n_bricks"]) == 1 and int(r["n_wide"]) == 0
        want = brick_consts(h.eng._bricks[k])
        assert {f"const_{n}" for n in want} == \
            {f for f in r.files if f.startswith("const_")}
        for n, x in want.items():
            assert r[f"const_{n}"].dtype == as_numpy(x).dtype, n
            np.testing.assert_array_equal(r[f"const_{n}"], as_numpy(x),
                                          err_msg=n)
    assert sorted(coords) == list(range(world))


@pytest.mark.parametrize("world,name", [(w, n)
                                        for w, cases in DIST_CASES.items()
                                        for n in cases])
def test_dsim_dist_ranks_equal_the_one_process_mesh(ranks, world, name):
    kind, prec, R, sync, mode, bp = DIST_CASES[world][name]
    h = make_engine("dsim_dist", dist_problem(kind, world), rng="lfsr",
                    precision=prec, replicas=R, mode=mode, bitpack=bp,
                    device="cpu")
    assert h.eng.group is None
    st0 = h.init_state(seed=INIT_SEED)
    e0 = h.energy(st0)
    st, rec = h.run_recorded(st0, ea_schedule(SWEEPS), POINTS,
                             sync_every=sync)
    g = state_to_numpy(st)
    spins = h.global_spins(st).numpy()
    whole = dict(partition_tensors(h.eng))
    for rank in range(world):
        r = np.load(ranks / f"{name}-{rank}.npz")
        np.testing.assert_array_equal(r["e0"], e0.numpy())
        np.testing.assert_array_equal(r["energies"], rec.energies.numpy())
        assert int(r["total_flips"]) == rec.flips > 0
        np.testing.assert_array_equal(r["spins"], spins)
        for f in DIST_FIELDS:
            assert r[f].dtype == g[f].dtype, f
            np.testing.assert_array_equal(r[f], g[f], err_msg=f)
        # the rank's own partition is the one-process engine's there
        for f in ("m", "ghosts", "rng"):
            np.testing.assert_array_equal(r[f"own_{f}"][0],
                                          as_numpy(getattr(st, f)[rank]))
        # and so are the constants it holds, of that partition alone
        assert int(r["n_wide"]) == 0
        paths = json.loads((ranks / f"{name}-{rank}.paths.json")
                           .read_text())
        assert paths and all(p in whole for p in paths)
        for i, p in enumerate(paths):
            x = whole[p]
            x = x[rank:rank + 1] if x.shape[0] == world else x
            np.testing.assert_array_equal(r[f"const_{i}"], as_numpy(x),
                                          err_msg=p)


@pytest.mark.parametrize("world,name", [(w, n)
                                        for w, cases in DEG_CASES.items()
                                        for n in cases])
def test_degraded_ranks_equal_the_one_process_mesh(ranks, world, name):
    engine, case, policy, codes = DEG_CASES[world][name]
    h, cur, raised = degraded_run(engine, case, policy, codes, world)
    g = state_to_numpy(h.eng.global_state(cur.state))
    g.update({f"halo{i}": x for i, x in enumerate(g.pop("halos", ()))})
    rec = cur.record()
    report = h.eng.health.report()
    assert report["detections"] > 0
    for rank in range(world):
        r = np.load(ranks / f"{name}-{rank}.npz")
        meta = json.loads((ranks / f"{name}-{rank}.json").read_text())
        assert meta == dict(raised=raised, report=report)
        assert int(r["sweeps_done"]) == cur.sweeps_done
        np.testing.assert_array_equal(r["energies"], rec.energies.numpy())
        assert int(r["total_flips"]) == rec.flips
        for f, x in g.items():
            assert r[f].dtype == x.dtype, f
            np.testing.assert_array_equal(r[f], x, err_msg=f)
