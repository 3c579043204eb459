"""One brick per rank: the mesh engine over a ``torch.distributed`` process
group against the same mesh in one process.

Two groups of gloo ranks on the CPU (2 and 4 processes, started together)
run every case of their ``CASES``, each rank holding one brick: halos
travel as point-to-point messages (1-bit ``pack_pm1`` bytes on int8 and
f32 with ``bitpack_halos=True``, int32 views of the word planes on the
bit-plane path), flips and energies are summed with ``all_reduce``, and
the global state is gathered with ``all_gather``.  Every rank's energies,
flips, its own brick and the gathered global state must equal the
one-process mesh's bitwise.
"""

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
cases = json.loads(sys.argv[4])
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
dist.destroy_process_group()
""" % dict(seed=SEED, init_seed=INIT_SEED, sweeps=SWEEPS, points=POINTS)


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
                [sys.executable, "-c", textwrap.dedent(WORKER), str(rank),
                 str(world), str(out), json.dumps(cases)],
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
