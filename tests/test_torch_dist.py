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
"""

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


def dist_problem(kind, K):
    """A random regular graph cut by the greedy partitioner, or an L=6
    EA3D lattice cut into K slabs (at K=4 of 2, 1, 2 and 1 planes): both
    pad colour slot lists."""
    from repro_torch.core import graph
    from repro_torch.core.coloring import greedy_coloring, lattice3d_coloring
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.partition import greedy_partition, slab_partition
    if kind == "regular":
        g = graph.random_regular(48, 4, seed=3, device="cpu")
        col = greedy_coloring(g.idx, g.w)
        labels = greedy_partition(g.idx, g.w, K, seed=0)
    else:
        g, col = graph.ea3d(6, seed=1, device="cpu"), lattice3d_coloring(6)
        labels = slab_partition(6, K)
    return build_partitioned(g, col, labels, K)


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
    np.savez(f"{out}/{name}-{rank}.npz", e0=e0.numpy(),
             energies=rec.energies.numpy(), total_flips=rec.flips,
             spins=h.global_spins(st).numpy(), **g, **own)
dist.destroy_process_group()
""" % dict(seed=SEED, init_seed=INIT_SEED, sweeps=SWEEPS, points=POINTS)
WORKER = textwrap.dedent(inspect.getsource(dist_problem)) + WORKER


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
                 json.dumps(DIST_CASES[world])],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
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
