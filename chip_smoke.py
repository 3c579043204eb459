#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases; every check raises on failure and the script then exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc/`` (nvcc,
   one process per source) and print the card's name and power limit;
2. hold each kernel to its plain PyTorch version on the card, at the
   L=100 shapes of the main path: the int8 sweep (both LFSR modes of its
   persistent kernel: shared memory at R=4, device memory at R=16), the
   int8 phase (one thread per word of 4 z-sites at L=100, per site at
   Z=99, its in-kernel flip count included) and the bit-plane sweep
   bitwise; the energy exactly on the +-J problem (and the same for every
   x tile ``bx``) at R=4 and 64, on Gaussian couplings within 1e-5 of the
   energy's scale (another summation order), with equal bits on repeated
   calls, and its word-plane readout equal to the int8 route bitwise at
   R=20 and 64; the
   f32 sweep (both LFSR modes) and the f32 phase (word path at L=100, site
   path at Z=99) with LFSR states bitwise and spins bitwise or differing
   only at sites within 8 ulp of the tanh decision boundary (counted and
   printed); the word and site paths counted by the launch counters;
3. drive the L=100 EA3D main path through ``make_engine("lattice", ...)``
   with no ``impl`` given, each configuration with the launch counters
   set to 0 just before it and read just after (every kernel it runs
   above 0; the int8 and f32 sweeps one persistent launch per call, with
   the LFSR states in shared memory; the phases and the energy one thread
   per word; the bit-plane energy read from the word planes, with no
   unpacking of lanes):
   int8, bit-plane, f32 (the default precision,
   with and without the paper's s{4}{1} format) and the per-phase
   dispatch (``fused=False``, ``kernel_bx``).  The first 16 sweeps equal
   an ``impl="ref"`` run on the card bitwise (int8, bit-plane), the
   per-phase runs equal the fused ones bitwise, the golden values
   recomputed from the JAX reference by ``tests/test_torch_golden.py``
   match (f32 to 0.5%, its LFSR digest exactly), and bit-plane lane
   (w, b) equals int8 replica w*32+b;
4. drive the mesh path: ``make_engine("lattice", L=100, mesh=make_mesh(
   ...), dim_axes=("x", "y", "z"))`` with every brick on the card: the
   JAX reference's (2,2,2) mesh golden values (int8 R=2 bitwise with its
   spin and LFSR digests, bit-plane R=32 lanes 0-1, f32 within 0.5% with
   the LFSR digest), the first 16 sweeps of int8 R=4 on (2,2,2) and
   (2,2,1), bit-plane R=64 and f32 R=4 on (2,2,2) against their
   ``impl="ref"`` runs on the card (bitwise, f32 to 0.5%), their full
   runs timed with the launches counted per kernel and path (one sweep
   launch per brick and call, one energy launch per brick and record
   point), the exchange's time per call and the measured eta
   (``EtaMeter``) at ``sync_every`` 1 and 8, and one profiled mesh run;
5. time the main path (p-bit updates per second, the repository's
   "flips/s"), profile it (device busy share, time by kernel, the
   redesigned kernels' mode and time per launch), time the bit-plane
   path's energy readout against the unpack-first readout it replaces,
   and time each kernel against its plain version and its bound: the
   largest of its bytes
   over the HBM bandwidth and its INT32 and FP32 operations over their
   own peaks (64 and 128 per SM per clock at the card's SM count and
   maximum SM clock);
6. drive the general-graph engines, ``make_engine("gibbs", graph)`` and
   ``make_engine("dsim", partitioned)``, on the L=100 instance as an ELL
   graph (and Max-Cut on a G81-size torus): the JAX reference's golden
   values (dsim int8 on the (2,2,2) brick partition bitwise with its
   spin and LFSR digests, gibbs f32 within 0.5% with its LFSR digest),
   every configuration against the same engine on the CPU over 16
   sweeps (int8 bitwise; f32 with each colour phase held to the CPU's:
   LFSR states bitwise, a differing spin only within 8 ulp of its
   boundary; philox within 0.5% and repeatable on the card), then timed
   (two runs each; none of the six kernels may launch: these engines are
   PyTorch operations), and one profiled run of each engine (device
   busy share, device operations and time per colour phase beside the
   phase's byte floor);
7. drive the distributed DSIM, ``make_engine("dsim_dist", partitioned)``
   with every one of the K=8 partitions on the card: the ELL word
   gather-count kernel against its plain version bitwise (at the L=100
   operands of each colour, and at D = 3, 4 and 12 on random rows), the
   JAX reference's golden values (int8 R=2 and bit-plane R=32 lanes 0-1
   reproduce ``DSIM_GOLDEN``, f32 R=2 ``DIST_GOLDEN`` within 0.5% with its
   LFSR digest), every ``DIST_RUNS`` configuration against its
   ``device="cpu"`` twin over 16 sweeps (int8 and bit-plane bitwise, f32
   phase by phase as in phase 6), then timed (two runs each; the
   bit-plane run launches the gather-count once per colour phase, no run
   launches a lattice kernel), the exchange's time per call and the
   measured eta (``dist_eta_meter``) at ``sync_every`` 1 and 8, one
   profiled bit-plane run (device busy share, the gather-count's share of
   the device time) and the gather-count timed against its plain version
   and its bound;
8. the degraded mesh and the sampling server: (a) both mesh engines'
   checked exchange at L=100 (``degrade=``): the lattice's ``MESH_RUNS``
   under ``stale_hold:8`` with no faults bitwise the unchecked run (and
   the (2,2,2) ``MESH_GOLDEN`` still reproduced), with ``DEG_CODES`` of
   drops and corruptions bitwise the ``impl="ref"`` run with the same
   codes (f32: LFSR states bitwise, energies within 0.5%), with the same
   health report as the codes predict; ``freeze_boundary`` against its
   ``impl="ref"`` run, ``resync`` clearing the staleness, ``fail_fast``
   raising at the chunk of its code; (b) the same for ``dsim_dist``
   K=8 at int8 R=4 and bit-plane R=64 (with codes against the
   ``device="cpu"`` twin), the checked exchange's time per call beside
   the unchecked one's (CUDA events) for both engines, and measured eta
   with ``effective_eta`` at ``sync_every`` 1 and 8 under injected
   drops; (c) ``repro_torch.serve.SampleServer`` on the card answering
   ``SERVER_JOBS`` at L=100 (a packed int8 pair, bit-plane, f32, a
   degraded mesh job with a drop, a ``fail_fast`` dsim_dist job that ends
   ``failed`` with ``StateCorruption``), every job equal to a direct
   ``make_engine`` run of its seeds, the packed job equal to its solo
   run, the launch counters (0 just before the server is driven) showing
   kernels #1-#4 and the gather-count launched from within it, and the
   server's jobs/s and flips/s beside the direct runs';
9. APT+ICM (``repro_torch.core.apt_icm.APTICM``) on the G81 shape
   (N=20,000, 2 chains x 64 temperatures): with ``HostDraws`` the card
   reproduces ``APT_GOLDEN`` (the JAX reference's digests, recomputed by
   ``tests/test_torch_golden.py``) in ``rng="lfsr"`` and packed mode and
   equals its ``device="cpu"`` twin bitwise over 16 sweeps; the
   gather-count kernel against its plain version at the packed shape
   (K=1, W=4); ``philox`` f32, ``lfsr`` and packed (W=4) timed over 256
   sweeps with an ICM every 10th (sweeps/s, p-bit updates/s, best cut;
   packed launches the gather-count once per colour phase, the others no
   kernel), packed == lfsr bitwise with the card's generator, the ICM's
   share of the time and host syncs per ICM, one profiled packed run, and
   one ``adapt_ladder`` call;
10. ``repro_torch.analyze``'s IR audit with every one-process chunk on the
   card: IR-A, IR-D and IR-E (no float arithmetic in integer bodies, host
   syncs as declared, modular counters) over the glue of the hand
   kernels;
11. print one JSON line of kernels (``launches`` over the main and mesh
   paths, and the bit-plane dist run's and the packed APT run's for the
   gather-count; ``mesh_launches`` the mesh path's, ``server_launches``
   the server path's, ``apt_launches`` the APT path's), the card's name
   and power limit, and last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is absent or the
script stands outside a checkout of the repository.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

L = 100
SEED = 0
SYNC = 8
MAIN_SWEEPS = 256
MAIN_POINTS = [16, 64, 128, 256]
# the reference's x tile of the per-phase kernels (kernel_bx); divides L
BX = 25
# The main path's configurations: label -> make_engine keywords (fmt by
# name), each run at L=100 over ea_schedule(MAIN_SWEEPS).
MAIN_RUNS = {
    "int8 R=4": dict(precision="int8", replicas=4),
    "bitplane R=64": dict(precision="bitplane", replicas=64),
    "f32 R=4": dict(replicas=4),
    "f32 s41 R=4": dict(replicas=4, fmt="S41"),
    "int8 per-phase R=4": dict(precision="int8", replicas=4, fused=False),
    "f32 per-phase bx R=4": dict(replicas=4, kernel_bx=BX),
}
PROFILED = ("int8 R=4", "bitplane R=64", "f32 R=4", "f32 s41 R=4",
            "int8 per-phase R=4", "f32 per-phase bx R=4")
LATTICE_KERNELS = ("pbit_brick_sweep_int", "pbit_bitplane_sweep",
                   "brick_energy", "pbit_brick_sweep", "pbit_brick_update_int",
                   "pbit_brick_update")
# the kernels line: the six lattice kernels and the ELL word gather-count
# of the distributed DSIM's bit-plane path (phase 7)
KERNELS = LATTICE_KERNELS + ("bitplane_gather_count",)
# an f32 site may be decided differently from the plain version only
# within this many ulp of tanh(act) of its boundary
TANH_ULPS = 8
# the energy on Gaussian couplings sums its sites in another order than
# the plain version: difference allowed, relative to the energy's scale
# (the larger of |E| and the root sum of squares of its site terms)
ENERGY_RTOL = 1e-5

# The JAX reference at L=100, seed 0, ea_schedule(16), record points
# [8, 16], sync_every=8 (int8, R=2; bit-plane R=32 lanes 0-1 equal it).
# tests/test_torch_golden.py recomputes these from the JAX package.
GOLDEN = {
    "energies": [[-1588460.0, -1588156.0], [-1640684.0, -1640154.0]],
    "flips": [1371830, 1372900],
    "m_sha256": "f516868da9a1efb7486e5cdd7df58b20"
                "2634147068cdbbd884f3dbe2bf5fba98",
    "s_sha256": "905250766f8dad54e31f56f3f05db473"
                "4793481ad86ce2426567059e5a87975d",
}
# The same run at precision="f32" (the default); its LFSR states do not
# depend on the precision, so GOLDEN["s_sha256"] holds for it too.
GOLDEN_F32 = {
    "energies": [[-1588460.0, -1588156.0], [-1640684.0, -1640154.0]],
    "flips": [1371830, 1372900],
}

# The mesh path: the lattice cut into bricks on one card (make_mesh with
# no process group), each configuration at L=100 over
# ea_schedule(MAIN_SWEEPS) as the main path, and its exchange cadence eta
# read at sync_every 1 and SYNC.
AXES = ("x", "y", "z")
MESH_RUNS = {
    "int8 R=4 mesh (2,2,2)": dict(precision="int8", replicas=4,
                                  mesh=(2, 2, 2)),
    "int8 R=4 mesh (2,2,1)": dict(precision="int8", replicas=4,
                                  mesh=(2, 2, 1)),
    "bitplane R=64 mesh (2,2,2)": dict(precision="bitplane", replicas=64,
                                       mesh=(2, 2, 2)),
    "f32 R=4 mesh (2,2,2)": dict(replicas=4, mesh=(2, 2, 2)),
}
ETA_RUN = "int8 R=4 mesh (2,2,2)"
MESH_PROFILED = "int8 R=4 mesh (2,2,2)"
# The JAX reference on 8 forced host devices, mesh (2,2,2), otherwise the
# GOLDEN run (int8, R=2; bit-plane R=32 lanes 0-1 and f32 equal it; the
# LFSR states do not depend on the partition or the precision).
# tests/test_torch_golden.py recomputes these from the JAX package.
MESH_GOLDEN = {
    "energies": [[-1572742.0, -1572536.0], [-1632230.0, -1630884.0]],
    "flips": [1389820, 1389756],
    "m_sha256": "5d1ac3b1de493f930528ea18c44051d6"
                "c5a2235ecb64b5e739446face9b855fb",
    "s_sha256": "905250766f8dad54e31f56f3f05db473"
                "4793481ad86ce2426567059e5a87975d",
}

# The general-graph engines on the same instance as an ELL graph
# (ea3d(L, SEED), lattice3d_coloring(L); dsim on the (2,2,2) brick
# partition, K=8), rng="lfsr" unless named, each at full width over
# ea_schedule(MAIN_SWEEPS) from init_state(seed=SEED), record points
# MAIN_POINTS; "sync" is run_recorded's sync_every.
BRICKS = (2, 2, 2)
GRAPH_RUNS = {
    "gibbs f32 R=4": dict(engine="gibbs", replicas=4),
    "gibbs f32 s41 R=4": dict(engine="gibbs", replicas=4, fmt="S41"),
    "gibbs philox R=4": dict(engine="gibbs", replicas=4, rng="philox"),
    "dsim int8 R=4 K=8": dict(engine="dsim", replicas=4, precision="int8",
                              sync=SYNC),
    "dsim int8 R=4 K=8 phase": dict(engine="dsim", replicas=4,
                                    precision="int8", sync="phase"),
    "dsim f32 R=4 K=8": dict(engine="dsim", replicas=4, sync=SYNC),
    "cmft f32 R=4 K=8": dict(engine="dsim", replicas=4, mode="cmft",
                             sync=SYNC),
    # the G81 shape (Max-Cut, J = -w on a 100x200 +-1 torus; greedy
    # colouring), as benchmarks/tableS2_maxcut.py anneals it
    "maxcut G81 gibbs R=4": dict(engine="gibbs", replicas=4, graph="g81"),
}
GRAPH_PROFILED = ("gibbs f32 R=4", "dsim int8 R=4 K=8")
G81 = dict(rows=100, cols=200, seed=81)
# The JAX reference's GibbsEngine (f32) and DSIMEngine (int8, K=8,
# sync_every=SYNC) at L=100, rng="lfsr", R=2, every replica started from
# graph_m0(L^3) (the reference draws initial spins with jax.random, which
# PyTorch cannot reproduce), ea_schedule(16), record points [8, 16].
# tests/test_torch_golden.py recomputes these from the JAX package.
GRAPH_M0_SEED = 1
GIBBS_GOLDEN = {
    "energies": [[-1594412.0, -1593918.0], [-1644082.0, -1643616.0]],
    "flips": [1366814, 1364108],
    "s_sha256": "fb1e5f4bbba32792de4c54c18737f3ea"
                "b46dce4046fd6572679d8124a6e8f48a",
}
DSIM_GOLDEN = {
    "energies": [[-1572812.0, -1574028.0], [-1632730.0, -1632706.0]],
    "flips": [1391343, 1387169],
    "m_sha256": "d09d941741d30b43a256d64953fa1cd6"
                "d911c468f9690220aa38ffbfbb24657a",
    "s_sha256": "fb1e5f4bbba32792de4c54c18737f3ea"
                "b46dce4046fd6572679d8124a6e8f48a",
}

# APT+ICM (phase 9) on the G81 shape: APT_CHAINS chains over an APT_T
# ladder apt_betas(), in three modes (f32 philox, lfsr, lfsr packed into
# W = 4 word planes), each over APT_SWEEPS sweeps with an ICM every
# APT_ICM_EVERY-th, from init_state(seed=SEED).
APT_CHAINS, APT_T = 2, 64
APT_SWEEPS, APT_ICM_EVERY = 256, 10
APT_MODES = {"philox": dict(rng="philox"), "lfsr": dict(rng="lfsr"),
             "packed": dict(rng="lfsr", packed=True)}
APT_PROFILED = "packed"
# The JAX reference's APTICM (rng="lfsr", run eagerly, every uniform from
# HostDraws(APT_DRAW_SEED) through a patched jax.random.uniform) from the
# port's init_state(seed=SEED): APT_GOLDEN_SWEEPS sweeps, an ICM and a
# record point every APT_GOLDEN_ICM-th; digests of its (P, T, N) spins,
# (P, T) energies and LFSR states.  tests/test_torch_golden.py recomputes
# these from the JAX package.
APT_DRAW_SEED = 81
APT_GOLDEN_SWEEPS, APT_GOLDEN_ICM = 16, 4
APT_GOLDEN = {
    "m_sha256": "1a4829ca3d1f619bdc8cc997bc0ea2f7"
                "833eb047b2b66fc9bf134a0ef1d6804e",
    "E_sha256": "c9b192acf64ff7474214141f7b400ba8"
                "ec207ea857c83de98fefbd859cd64ca7",
    "lfsr_sha256": "1723525f7fda837664cd048519862f2c"
                   "403685b4a98baa47115586ed9216539a",
    "swaps": 1043, "icms": 256, "sweeps": [4, 8, 12, 16],
    "best": [-24360.0, -25620.0, -26064.0, -26368.0],
}


def apt_betas() -> np.ndarray:
    """Phase 9's ladder, the reference's T=64 case
    (tests/test_problems.py)."""
    return np.linspace(0.2, 3.0, APT_T)


# The distributed DSIM on the same K=8 brick partition, every partition on
# the card (make_engine("dsim_dist") with no mesh), rng="lfsr", each at
# full width over ea_schedule(MAIN_SWEEPS) from init_state(seed=SEED),
# record points MAIN_POINTS; "sync" is run_recorded's sync_every.
DIST_RUNS = {
    "dsim_dist int8 R=4 K=8": dict(replicas=4, precision="int8", sync=SYNC),
    "dsim_dist int8 R=4 K=8 phase": dict(replicas=4, precision="int8",
                                         sync="phase"),
    "dsim_dist bitplane R=64 K=8": dict(replicas=64, precision="bitplane",
                                        sync=SYNC),
    "dsim_dist f32 R=4 K=8": dict(replicas=4, sync=SYNC),
    "dsim_dist cmft f32 R=4 K=8": dict(replicas=4, mode="cmft", sync=SYNC),
}
DIST_ETA_RUN = "dsim_dist int8 R=4 K=8"
DIST_PROFILED = "dsim_dist bitplane R=64 K=8"
# the gather-count is also held to its plain version at these degrees
GATHER_DEGREES = (3, 4, 12)
# The JAX reference's DistDSIMEngine on 8 forced host devices, f32
# (bitpack), rng="lfsr", R=2, sync_every=SYNC, every replica started from
# graph_m0(L^3), ea_schedule(16), record points [8, 16]; s_sha256 digests
# its (K, R, n_max) LFSR states, the stream lfsr_init(K*R*n_max, SEED).
# Its int8 run reproduces DSIM_GOLDEN.  tests/test_torch_golden.py
# recomputes these from the JAX package.
DIST_GOLDEN = {
    "energies": [[-1572182.0, -1571498.0], [-1631570.0, -1631110.0]],
    "flips": [1391410, 1393303],
    "s_sha256": "55d48bd5a64cf87bcc8904e204c4f4b7"
                "207778984a7f44badfdb469252d3ac3f",
}

# The degraded mesh (phase 8): DEG_SWEEPS sweeps at sync_every DEG_SYNC
# (eight exchanges), record points DEG_POINTS; DEG_CODES[seq] injects a
# drop (1) or a corruption (2) on the received planes of exchange seq:
# four bad exchanges of eight, two of them consecutive.
DEG_SWEEPS, DEG_SYNC, DEG_POINTS = 32, 4, [16, 32]
DEG_CODES = [0, 1, 0, 2, 2, 0, 1, 0]
DEG_POLICY = "stale_hold:8"
# The server path (phase 8c): label -> (problem, submit keywords), each
# job over ea_schedule(MAIN_SWEEPS) at sync_every SYNC; the first two pack
# into one R=8 call.  The server's FaultPlan corrupts exchange 1 and drops
# exchange SERVER_DROP of every degraded job: the mesh job holds both, the
# dsim_dist job fails at the first.
SERVER_JOBS = {
    "int8 R=4 seed 0": ("lat", dict(precision="int8", replicas=4, seed=0)),
    "int8 R=4 seed 1": ("lat", dict(precision="int8", replicas=4, seed=1)),
    "bitplane R=64": ("lat", dict(precision="bitplane", replicas=64,
                                  seed=2)),
    "f32 R=4": ("lat", dict(replicas=4, seed=3)),
    "mesh (2,2,2) int8 R=4 stale_hold:8": ("mesh", dict(
        precision="int8", replicas=4, seed=4, degrade_policy=DEG_POLICY)),
}
SERVER_DROP = 5
SERVER_FAILING = ("graph", dict(engine="dsim_dist", precision="bitplane",
                                replicas=64, seed=5,
                                degrade_policy="fail_fast"))


def graph_m0(n: int) -> np.ndarray:
    """The golden runs' initial spins, one draw shared by every replica."""
    return np.random.default_rng(GRAPH_M0_SEED).choice(
        np.array([-1, 1], np.int8), size=n)


# H100 SXM published HBM3 bandwidth (NVIDIA data sheet).  The operation
# peaks are taken from the card in the run: Hopper issues 64 INT32 and
# 128 FP32 lane operations per SM per clock (no FMA here: the library
# builds with --fmad=false), at the SM count PyTorch reports and the
# maximum SM clock nvidia-smi reports.
HBM_BYTES_PER_S = 3.35e12
INT32_PER_SM_CLOCK = 64
FP32_PER_SM_CLOCK = 128
# the redesigned kernels, by what the profiler's CUDA kernel names hold
# (the energy: both of its passes)
REDESIGNED = {"pbit_bitplane_sweep": ("bitplane_color_kernel",),
              "pbit_brick_sweep": ("persistent_sweep", "F32Update"),
              "pbit_brick_sweep_int": ("persistent_sweep", "Int8Update"),
              "pbit_brick_update": ("word_phase_kernel", "F32Update"),
              "pbit_brick_update_int": ("word_phase_kernel", "Int8Update"),
              "brick_energy": ("energy_",)}


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok  {what}", flush=True)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's entry points run on "
              "the card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    return Smoke(torch).run()


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.results = {}     # kernel name -> dict of measured fields
        self.inputs_energy = {}   # R -> the energy's +-J inputs

    # -- helpers ---------------------------------------------------------

    def same(self, a, b) -> bool:
        """Bitwise equality of two tensors (uint32 via its int32 view)."""
        t = self.torch
        if a.dtype == t.uint32:
            a = a.view(t.int32)
        if b.dtype == t.uint32:
            b = b.view(t.int32)
        return a.dtype == b.dtype and a.shape == b.shape and \
            bool(t.equal(a, b))

    def max_abs(self, a, b) -> float:
        t = self.torch
        if a.dtype == t.uint32:
            from repro_torch.core.bits import u32_to_i64
            a, b = u32_to_i64(a), u32_to_i64(b)
        return float((a.double() - b.double()).abs().max()) \
            if a.numel() else 0.0

    def time_ms(self, fn, reps: int, warm: int = 2) -> float:
        t = self.torch
        for _ in range(warm):
            fn()
        t.cuda.synchronize()
        a = t.cuda.Event(enable_timing=True)
        b = t.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def rand_halos(self, rng, lead: int, shapes, words: bool):
        from repro_torch.core.bits import u32_from_numpy
        if words:
            return tuple(u32_from_numpy(rng.integers(
                0, 2 ** 32, size=sh, dtype=np.uint32), self.dev)
                for sh in shapes)
        return tuple(self.torch.from_numpy(rng.choice(
            np.array([-1, 1], np.int8), size=sh)).to(self.dev)
            for sh in shapes)

    # -- phases ----------------------------------------------------------

    def run(self) -> int:
        t = self.torch
        t.backends.cuda.matmul.allow_tf32 = False
        t.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(f"card: {card}  ({t.cuda.get_device_name(0)}, "
              f"{t.cuda.device_count()} visible)", flush=True)
        print(f"python {sys.version.split()[0]}  torch {t.__version__}  "
              f"cuda {t.version.cuda}", flush=True)
        self.phase_build()
        self.phase_kernels()
        self.phase_main_path()
        self.phase_mesh(card)
        self.phase_timing(card)
        self.phase_graph(card)
        self.phase_dist(card)
        self.phase_degraded(card)
        self.phase_server(card)
        self.phase_apt(card)
        self.phase_audit(card)
        r = self.results["bitplane_gather_count"]
        r["launches"] += self.apt_launches
        r["apt_launches"] = self.apt_launches
        for k in KERNELS:
            self.results[k]["mesh_launches"] = self.mesh_launches[k]
            self.results[k]["server_launches"] = self.server_launches[k]
        print(json.dumps({"kernels": [self.results[k] for k in KERNELS]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": t.cuda.get_device_name(0),
            "count": t.cuda.device_count()}}))
        return 0

    def phase_build(self):
        from repro_torch.kernels import _build
        print("== 1. build", flush=True)
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        print(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        log = (lib.parent / "build.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "==" in line:
                    print(f"  {line.strip()}")

    def phase_kernels(self):
        """Each kernel against its plain version on the card, L=100."""
        t = self.torch
        from repro_torch import make_engine
        from repro_torch.core.annealing import (beta_table, ea_schedule,
                                                beta_row_indices)
        from repro_torch.core.bits import u32_from_numpy
        from repro_torch.core.lattice import build_ea3d_lattice
        from repro_torch.core.packing import pack_lanes
        from repro_torch.core.pbit import threshold_lut
        from repro_torch.kernels import ref
        from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
        from repro_torch.kernels import _build
        from repro_torch.kernels.pbit_lattice import (halo_shapes,
                                                      pbit_brick_sweep_int,
                                                      persistent_mode)
        print("== 2. kernels against their plain versions (L=100)",
              flush=True)
        self.prob = prob = build_ea3d_lattice(L, seed=SEED, device=self.dev)
        rng = self.rng = np.random.default_rng(1234)
        n = L ** 3
        betas = ea_schedule(MAIN_SWEEPS).beta_array()
        table = beta_table(betas)
        S = 3

        # int8 sweep: shared rows and per-replica rows, R = 4
        R = 4
        eng = make_engine("lattice", lattice=prob, replicas=R,
                          precision="int8", device=self.dev).eng
        lut = u32_from_numpy(threshold_lut(table, eng.q_scale, eng.f_max),
                             self.dev)
        m = t.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                    size=(R, L, L, L))).to(self.dev)
        s = u32_from_numpy(rng.integers(1, 2 ** 32, size=(R, L, L, L),
                                        dtype=np.uint32), self.dev)
        halos = self.rand_halos(rng, R, halo_shapes(R, L, L, L), False)
        errs = []
        for rows in (beta_row_indices(betas[[0, 100, 255]], table),
                     rng.integers(0, len(table), size=(S, R))
                     .astype(np.int32)):
            rows_t = t.from_numpy(rows).to(self.dev)
            got = pbit_brick_sweep_int(m, s, rows_t, prob.masks, eng.h_q,
                                       eng.w6_q, halos, lut)
            want = ref.pbit_brick_sweep_int_ref(m, s, rows_t, prob.masks,
                                                eng.h_q, eng.w6_q, halos,
                                                lut)
            t.cuda.synchronize()
            errs += [self.max_abs(g, w) for g, w in zip(got, want)]
            check(all(self.same(g, w) for g, w in zip(got, want)),
                  f"int8 sweep == plain, bitwise (R={R}, S={S}, rows "
                  f"{tuple(rows.shape)}, flips {want[2].tolist()})")
        check(persistent_mode(m) == "lfsr_smem",
              f"int8 sweep at L={L}, R={R}: LFSR states in shared memory")
        self.inputs_int8 = (m, s, prob.masks, eng.h_q, eng.w6_q, halos, lut,
                            beta_row_indices(betas[:SYNC], table))

        # the same kernel with its LFSR states in device memory: R = 16
        R16 = 16
        m16 = t.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                      size=(R16, L, L, L))).to(self.dev)
        s16 = u32_from_numpy(rng.integers(1, 2 ** 32, size=(R16, L, L, L),
                                          dtype=np.uint32), self.dev)
        halos16 = self.rand_halos(rng, R16, halo_shapes(R16, L, L, L),
                                  False)
        check(persistent_mode(m16) == "lfsr_global",
              f"int8 sweep at L={L}, R={R16}: LFSR states in device memory")
        rows16 = t.from_numpy(rng.integers(0, len(table), size=(S, R16))
                              .astype(np.int32)).to(self.dev)
        args16 = (m16, s16, rows16, prob.masks, eng.h_q, eng.w6_q, halos16,
                  lut)
        want = ref.pbit_brick_sweep_int_ref(*args16)
        before = _build.launch_counts["pbit_brick_sweep_int:lfsr_global"]
        got = pbit_brick_sweep_int(*args16)
        t.cuda.synchronize()
        check(_build.launch_counts["pbit_brick_sweep_int:lfsr_global"]
              == before + 1, "one launch in device-memory mode")
        errs += [self.max_abs(g, w) for g, w in zip(got, want)]
        check(all(self.same(g, w) for g, w in zip(got, want)),
              f"int8 sweep, device-memory LFSR == plain, bitwise "
              f"(R={R16}, S={S}, per-replica rows, flips "
              f"{want[2].tolist()[:4]}...)")
        self.results["pbit_brick_sweep_int"] = {"max_abs_err": max(errs)}
        self.inputs_int8_global = (m16, s16, t.from_numpy(beta_row_indices(
            betas[:SYNC], table)).to(self.dev)) + args16[3:]

        # bit-plane sweep: a full word, a partial word and two words
        errs = []
        for R in (32, 20, 64):
            eng = make_engine("lattice", lattice=prob, replicas=R,
                              precision="bitplane", device=self.dev).eng
            W = eng.words
            lut = u32_from_numpy(threshold_lut(table, eng.q_scale,
                                               eng.f_max), self.dev)
            mw = pack_lanes(t.from_numpy(rng.choice(
                np.array([-1, 1], np.int8), size=(R, L, L, L))).to(self.dev))
            s = u32_from_numpy(rng.integers(1, 2 ** 32, size=(R, L, L, L),
                                            dtype=np.uint32), self.dev)
            hw = self.rand_halos(rng, W, halo_shapes(W, L, L, L), True)
            for rows in (beta_row_indices(betas[[0, 100, 255]], table),
                         rng.integers(0, len(table), size=(S, R))
                         .astype(np.int32)):
                rows_t = t.from_numpy(rows).to(self.dev)
                args = (mw, s, rows_t, eng.masks_w, eng.signs6_w, eng.nz6_w,
                        eng.base_w, hw, lut)
                got = pbit_bitplane_sweep(*args)
                want = ref.pbit_bitplane_sweep_ref(*args)
                t.cuda.synchronize()
                errs += [self.max_abs(g, w) for g, w in zip(got, want)]
                check(all(self.same(g, w) for g, w in zip(got, want)),
                      f"bit-plane sweep == plain, bitwise (R={R}, W={W}, "
                      f"rows {tuple(rows.shape)}, lane-0 flips "
                      f"{int(want[2][0])})")
            if R == 64:
                self.inputs_bp = args[:2] + (t.from_numpy(
                    beta_row_indices(betas[:SYNC], table)).to(self.dev),) + \
                    args[3:]
        self.results["pbit_bitplane_sweep"] = {"max_abs_err": max(errs)}

        self.n = n
        self.phase_kernels_energy()
        self.phase_kernels_f32_and_per_phase(betas, table, S)

    def gaussian(self, shape):
        """Gaussian f32 couplings on the card: h (0.3) and six w6 (1.0)."""
        on_card = lambda a: self.torch.from_numpy(a).to(self.dev)  # noqa: E731
        return (on_card(self.rng.normal(0, 0.3, shape).astype(np.float32)),
                tuple(on_card(self.rng.normal(0, 1.0, shape)
                              .astype(np.float32)) for _ in range(6)))

    def check_energy(self, what, got, want, args, exact: bool) -> float:
        """An energy against its plain version on inputs ``args``: bitwise
        where ``exact`` (+-J), else within ENERGY_RTOL of the energy's
        scale.  Returns the largest difference."""
        from repro_torch.kernels import ref
        if exact:
            check(self.same(got, want), f"{what}: exact (E[0]="
                  f"{float(want[0])})")
        else:
            sites = ref.brick_energy_sites_ref(*args).double()
            scale = self.torch.maximum(
                want.double().abs(),
                sites.square().sum(dim=(-3, -2, -1)).sqrt())
            rel = float(((got.double() - want.double()).abs()
                         / scale).max())
            check(rel <= ENERGY_RTOL, f"{what}: within {ENERGY_RTOL} of the "
                  f"energy's scale (largest difference {rel:.3e} of it, "
                  f"E[0]={float(want[0])})")
        return self.max_abs(got, want)

    def phase_kernels_energy(self):
        """The energy against its plain version on the card: the int8
        route at R=4 and 64 (word path) and at Z=99 (site path), +-J and
        Gaussian couplings, repeated calls; the word-plane route against
        the int8 route at R=20 and 64."""
        t = self.torch
        from repro_torch.core.packing import (lane_words, pack_lanes,
                                              unpack_lanes)
        from repro_torch.kernels import _build, ref
        from repro_torch.kernels.lattice_energy import (brick_energy,
                                                        brick_energy_words)
        from repro_torch.kernels.pbit_lattice import halo_shapes
        rng, prob = self.rng, self.prob
        spins = lambda R, shape: t.from_numpy(rng.choice(  # noqa: E731
            np.array([-1, 1], np.int8), size=(R,) + shape)).to(self.dev)
        cube = (L, L, L)
        couplings = {"+-J": (prob.h, prob.w6), "Gaussian": self.gaussian(cube)}
        errs = []
        for R in (4, 64):
            m = spins(R, cube)
            halos = self.rand_halos(rng, R, halo_shapes(R, *cube), False)
            for label, (h, w6) in couplings.items():
                args = (m, prob.active, h, w6, halos)
                words = _build.launch_counts["brick_energy:word"]
                got = brick_energy(*args)
                again = brick_energy(*args)
                want = ref.brick_energy_ref(*args)
                t.cuda.synchronize()
                check(_build.launch_counts["brick_energy:word"] == words + 2,
                      f"energy at L={L}: one thread per word of 4 z-sites")
                errs.append(self.check_energy(
                    f"energy == plain ({label}, R={R})", got, want, args,
                    label == "+-J"))
                check(self.same(again, got), f"energy ({label}, R={R}): "
                      f"equal bits on a repeated call")
                if label == "+-J":
                    check(self.same(brick_energy(*args, bx=BX), got),
                          f"energy with bx={BX} == bx=None (R={R})")
                    self.inputs_energy[R] = args

        # rows not word-aligned (Z = 99): one site per thread
        shape = (L, L, L - 1)
        active = t.from_numpy((rng.random(shape) < 0.9).astype(np.int8)).to(
            self.dev)
        h, w6 = self.gaussian(shape)
        R = 4
        args = (spins(R, shape), active, h, w6,
                self.rand_halos(rng, R, halo_shapes(R, *shape), False))
        sites = _build.launch_counts["brick_energy:site"]
        got = brick_energy(*args)
        want = ref.brick_energy_ref(*args)
        t.cuda.synchronize()
        check(_build.launch_counts["brick_energy:site"] == sites + 1,
              f"energy at Z={shape[2]}: one thread per site")
        errs.append(self.check_energy(
            f"energy == plain (Gaussian, R={R}, shape {shape})", got, want,
            args, False))
        check(self.same(brick_energy(*args), got),
              f"energy at Z={shape[2]}: equal bits on a repeated call")

        # the word-plane readout of the bit-plane path: a partial word and
        # two words
        for R in (20, 64):
            W = lane_words(R)
            m = spins(R, cube)
            mw = pack_lanes(m)
            hw = self.rand_halos(rng, W, halo_shapes(W, *cube), True)
            halos = tuple(unpack_lanes(x, R) for x in hw)
            for label, (h, w6) in couplings.items():
                before = _build.launch_counts["brick_energy:bitplane"]
                got = brick_energy_words(mw, R, prob.active, h, w6, hw)
                int8 = brick_energy(m, prob.active, h, w6, halos)
                want = ref.brick_energy_words_ref(mw, R, prob.active, h, w6,
                                                  hw)
                t.cuda.synchronize()
                check(_build.launch_counts["brick_energy:bitplane"] ==
                      before + 1, f"one word-plane energy launch (R={R})")
                check(self.same(got, int8), f"energy of word planes == int8 "
                      f"route on the unpacked spins, bitwise ({label}, "
                      f"R={R}, W={W})")
                errs.append(self.check_energy(
                    f"word-plane energy == plain ({label}, R={R})", got,
                    want, (m, prob.active, h, w6, halos), label == "+-J"))
                if label == "+-J" and R == 64:
                    self.inputs_energy_words = (mw, R, prob.active, h, w6,
                                                hw)
        self.results["brick_energy"] = {"max_abs_err": max(errs)}

    def phase_kernels_f32_and_per_phase(self, betas, table, S: int):
        """The f32 sweep and the two single-phase kernels against their
        plain versions, on the int8 check's L=100, R=4 spins and states."""
        t = self.torch
        from repro_torch import S41
        from repro_torch.core.bits import u32_from_numpy
        from repro_torch.core.pbit import (field_bound, quantize_couplings,
                                           threshold_lut)
        from repro_torch.kernels import _build, ref
        from repro_torch.kernels.pbit_lattice import (halo_shapes,
                                                      pbit_brick_sweep,
                                                      pbit_brick_update,
                                                      pbit_brick_update_int,
                                                      persistent_mode)
        rng, prob = self.rng, self.prob
        m, s, masks, h_q, w6_q, halos, lut, _ = self.inputs_int8
        R = int(m.shape[0])
        on_card = lambda a: t.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(self.dev)

        # f32 sweep: shared and per-replica betas, fmt None and s{4}{1}
        errs = []
        for fmt in (None, S41):
            for b in (betas[[0, 100, 255]],
                      rng.uniform(0.3, 5.0, size=(S, R)).astype(np.float32)):
                args = (m, s, on_card(b), masks, prob.h, prob.w6, halos)
                got = pbit_brick_sweep(*args, fmt=fmt)
                want = ref.pbit_brick_sweep_ref(*args, fmt=fmt)
                t.cuda.synchronize()
                errs += [self.max_abs(g, w) for g, w in zip(got, want)]
                what = (f"f32 sweep == plain (R={R}, S={S}, betas "
                        f"{tuple(b.shape)}, fmt {fmt}, flips "
                        f"{want[2].tolist()})")
                self.check_f32(what, got, want, lambda what, args=args,
                               fmt=fmt, got=got: self.f32_steps(
                                   what, args, fmt, got))
        check(persistent_mode(m) == "lfsr_smem",
              f"f32 sweep at L={L}, R={R}: LFSR states in shared memory")
        self.inputs_f32 = (m, s, on_card(betas[:SYNC]), masks, prob.h,
                           prob.w6, halos)

        # the same kernel with its LFSR states in device memory: R = 16
        R16 = 16
        m16 = t.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                      size=(R16, L, L, L))).to(self.dev)
        s16 = u32_from_numpy(rng.integers(1, 2 ** 32, size=(R16, L, L, L),
                                          dtype=np.uint32), self.dev)
        halos16 = self.rand_halos(rng, R16, halo_shapes(R16, L, L, L),
                                  False)
        check(persistent_mode(m16) == "lfsr_global",
              f"f32 sweep at L={L}, R={R16}: LFSR states in device memory")
        for fmt in (None, S41):
            args = (m16, s16, on_card(rng.uniform(0.3, 5.0, size=(S, R16))
                                      .astype(np.float32)),
                    masks, prob.h, prob.w6, halos16)
            before = _build.launch_counts["pbit_brick_sweep:lfsr_global"]
            got = pbit_brick_sweep(*args, fmt=fmt)
            want = ref.pbit_brick_sweep_ref(*args, fmt=fmt)
            t.cuda.synchronize()
            check(_build.launch_counts["pbit_brick_sweep:lfsr_global"]
                  == before + 1, "one launch in device-memory mode")
            errs += [self.max_abs(g, w) for g, w in zip(got, want)]
            what = (f"f32 sweep, device-memory LFSR == plain (R={R16}, "
                    f"S={S}, per-replica betas, fmt {fmt}, flips "
                    f"{want[2].tolist()[:4]}...)")
            self.check_f32(what, got, want, lambda what, args=args,
                           fmt=fmt, got=got: self.f32_steps(
                               what, args, fmt, got))
        self.results["pbit_brick_sweep"] = {"max_abs_err": max(errs)}
        self.inputs_f32_global = (m16, s16, on_card(betas[:SYNC]), masks,
                                  prob.h, prob.w6, halos16)

        # int8 phase: shared and per-replica LUT rows, bx None and BX
        errs_int = []
        words = _build.launch_counts["pbit_brick_update_int:word"]
        for bx in (None, BX):
            for row in (3, on_card(rng.integers(0, len(table), size=R)
                                   .astype(np.int32))):
                args = (m, s, row, masks[0], h_q, w6_q, halos, lut)
                got = pbit_brick_update_int(*args, bx=bx)
                want = ref.pbit_brick_update_int_ref(*args)
                t.cuda.synchronize()
                errs_int += [self.max_abs(g, w) for g, w in zip(got, want)]
                check(all(self.same(g, w) for g, w in zip(got, want)),
                      f"int8 phase == plain, bitwise (R={R}, bx={bx}, row "
                      f"{'per replica' if isinstance(row, t.Tensor) else row})")
        check(_build.launch_counts["pbit_brick_update_int:word"] ==
              words + 4, f"int8 phase at L={L}: one thread per word of 4 "
              f"z-sites")
        self.inputs_update_int = (m, s, row, masks[0], h_q, w6_q, halos,
                                  lut)
        self.check_int_flips(self.inputs_update_int)

        # f32 phase: per-replica betas, fmt None and s{4}{1}, bx None and BX
        errs = []
        words = _build.launch_counts["pbit_brick_update:word"]
        for bx in (None, BX):
            for fmt in (None, S41):
                beta = on_card(rng.uniform(0.3, 5.0, size=R)
                               .astype(np.float32))
                args = (m, s, beta, masks[1], prob.h, prob.w6, halos)
                got = pbit_brick_update(*args, fmt=fmt, bx=bx)
                want = ref.pbit_brick_update_ref(*args, fmt=fmt)
                t.cuda.synchronize()
                errs += [self.max_abs(g, w) for g, w in zip(got, want)]
                self.check_f32(
                    f"f32 phase == plain (R={R}, bx={bx}, fmt {fmt})", got,
                    want, lambda what, args=args, fmt=fmt, got=got, want=want:
                    self.f32_boundary(what, args, fmt, got[0], want[0]))
        check(_build.launch_counts["pbit_brick_update:word"] == words + 4,
              f"f32 phase at L={L}: one thread per word of 4 z-sites")
        self.inputs_update_f32 = (m, s, beta, masks[1], prob.h, prob.w6,
                                  halos)

        # the phases at an odd Z (rows not word-aligned: one site per
        # thread), random Gaussian constants (int8: quantized, multi-bit),
        # a checkerboard
        shape = (L, L, L - 1)
        par = np.indices(shape).sum(0) % 2
        h_o, w6_o = self.gaussian(shape)
        m_o = on_card(rng.choice(np.array([-1, 1], np.int8),
                                 size=(R,) + shape))
        s_o = u32_from_numpy(rng.integers(1, 2 ** 32, size=(R,) + shape,
                                          dtype=np.uint32), self.dev)
        halos_o = self.rand_halos(rng, R, halo_shapes(R, *shape), False)
        for fmt in (None, S41):
            args = (m_o, s_o, beta, on_card((par == 1).astype(np.int8)), h_o,
                    w6_o, halos_o)
            sites = _build.launch_counts["pbit_brick_update:site"]
            got = pbit_brick_update(*args, fmt=fmt)
            want = ref.pbit_brick_update_ref(*args, fmt=fmt)
            t.cuda.synchronize()
            check(_build.launch_counts["pbit_brick_update:site"] == sites + 1,
                  f"f32 phase at Z={shape[2]}: one thread per site")
            errs += [self.max_abs(g, w) for g, w in zip(got, want)]
            self.check_f32(
                f"f32 phase == plain (R={R}, shape {shape}, fmt {fmt})", got,
                want, lambda what, args=args, fmt=fmt, got=got, want=want:
                self.f32_boundary(what, args, fmt, got[0], want[0]))
        self.results["pbit_brick_update"] = {"max_abs_err": max(errs)}

        h_q, w6_q, scale = quantize_couplings(
            h_o.cpu().numpy(), [w.cpu().numpy() for w in w6_o])
        lut_o = u32_from_numpy(threshold_lut(
            table, scale, field_bound(h_q, w6_q)), self.dev)
        args = (m_o, s_o, on_card(rng.integers(0, len(table), size=R)
                                  .astype(np.int32)),
                on_card((par == 1).astype(np.int8)), on_card(h_q),
                tuple(on_card(w) for w in w6_q), halos_o, lut_o)
        sites = _build.launch_counts["pbit_brick_update_int:site"]
        got = pbit_brick_update_int(*args)
        want = ref.pbit_brick_update_int_ref(*args)
        t.cuda.synchronize()
        check(_build.launch_counts["pbit_brick_update_int:site"] ==
              sites + 1, f"int8 phase at Z={shape[2]}: one thread per site")
        errs_int += [self.max_abs(g, w) for g, w in zip(got, want)]
        check(all(self.same(g, w) for g, w in zip(got, want)),
              f"int8 phase == plain, bitwise (R={R}, shape {shape}, "
              f"multi-bit couplings, LUT width {lut_o.shape[1]})")
        self.check_int_flips(args)
        self.results["pbit_brick_update_int"] = {"max_abs_err": max(errs_int)}

    def check_int_flips(self, args):
        """The int8 phase's in-kernel flip count (the per-phase engine's)
        equals the sites its plain version changes, added in place."""
        t = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.ops import pbit_update_int_op
        R = int(args[0].shape[0])
        flips = t.full((R,), 7, dtype=t.int32, device=self.dev)
        got = pbit_update_int_op(*args, flips=flips)
        want = ref.pbit_brick_update_int_ref(*args)
        changed = (want[0] != args[0]).reshape(R, -1).sum(1)
        t.cuda.synchronize()
        check(all(self.same(g, w) for g, w in zip(got, want)) and
              flips.tolist() == (changed + 7).tolist(),
              f"int8 phase with its flip count == plain, bitwise, flips "
              f"{changed.tolist()} (shape {tuple(args[0].shape)})")

    def check_f32(self, what, got, want, boundary_ok):
        """An f32 kernel's (m, s[, flips]) against its plain version: LFSR
        states bitwise; spins (and flips) bitwise, or else every differing
        site confirmed by ``boundary_ok(what)`` to lie within TANH_ULPS ulp
        of the decision boundary."""
        check(self.same(got[1], want[1]), f"{what}: LFSR states bitwise")
        n_diff = int((got[0] != want[0]).sum())
        print(f"  {what}: {n_diff} sites decided differently", flush=True)
        if n_diff == 0:
            check(all(self.same(g, w) for g, w in zip(got, want)),
                  f"{what}: spins bitwise")
        else:
            boundary_ok(what)

    def f32_boundary(self, what, args, fmt, got_m, want_m):
        """One f32 phase: every site where the kernel and the plain version
        disagree lies within TANH_ULPS ulp of the boundary."""
        from repro_torch.kernels import ref
        m, s, beta, _, h, w6, halos = args
        ulps = ref.decision_ulps_ref(m, s, beta, h, w6, halos, fmt)
        diff = got_m != want_m
        far = int((diff & (ulps > TANH_ULPS)).sum())
        check(far == 0, f"{what}: {int(diff.sum())} differing sites, each "
              f"within {TANH_ULPS} ulp of the boundary ({far} beyond)")

    def f32_steps(self, what, args, fmt, got):
        """An f32 sweep whose spins differ from the plain sweep's: run the
        kernel one phase at a time, each from its own last output, and hold
        each phase to one plain phase from the same input (LFSR bitwise,
        differing sites within TANH_ULPS ulp); the phases in turn must give
        the whole call's result bitwise."""
        from repro_torch.kernels import ref
        from repro_torch.kernels.pbit_lattice import pbit_brick_sweep
        m, s, betas, masks, h, w6, halos = args
        for ti in range(int(betas.shape[0])):
            for c in range(int(masks.shape[0])):
                km, ks, _ = pbit_brick_sweep(m, s, betas[ti:ti + 1],
                                             masks[c:c + 1], h, w6, halos,
                                             fmt=fmt)
                pm, ps = ref.pbit_brick_update_ref(m, s, betas[ti], masks[c],
                                                   h, w6, halos, fmt)
                check(self.same(ks, ps), f"{what}, phase ({ti}, {c}): LFSR "
                      f"states bitwise")
                self.f32_boundary(f"{what}, phase ({ti}, {c})",
                                  (m, s, betas[ti], masks[c], h, w6, halos),
                                  fmt, km, pm)
                m, s = km, ks
        check(self.same(m, got[0]) and self.same(s, got[1]),
              f"{what}: the sweep equals its phases run one at a time")

    def f32_mesh_steps(self, label, h, st0, got):
        """The first 16 sweeps of an f32 mesh engine on the card, one
        SYNC-sweep iteration at a time: each brick's sweep against the
        halos the engine gave it is held to the plain sweep by
        ``check_f32`` (LFSR states bitwise, every differing spin within
        TANH_ULPS ulp of the boundary, phase by phase); the engine's
        iteration is those brick sweeps and its exchange, bitwise; and the
        iterations in turn are the engine's 16-sweep run ``got``."""
        t = self.torch
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.kernels import ref
        from repro_torch.kernels.pbit_lattice import pbit_brick_sweep
        eng, st = h.eng, st0
        betas = ea_schedule(MAIN_SWEEPS).beta_array()
        for it in range(MAIN_POINTS[0] // SYNC):
            b_it = np.ascontiguousarray(betas[it * SYNC:(it + 1) * SYNC],
                                        np.float32)
            nxt = eng._chunk(st, b_it[None], 1, SYNC, None)
            same = True
            for k, (b, hk) in enumerate(zip(eng._bricks,
                                            eng._brick_halos(st.halos))):
                args = (st.m[k], st.s[k], t.from_numpy(b_it).to(self.dev),
                        b.masks, b.h, b.w6, hk)
                kern = pbit_brick_sweep(*args, fmt=eng.fmt)
                want = ref.pbit_brick_sweep_ref(*args, fmt=eng.fmt)
                self.check_f32(
                    f"{label}, iteration {it}, brick {eng.coords[k]}", kern,
                    want, lambda what, args=args, kern=kern: self.f32_steps(
                        what, args, eng.fmt, kern))
                same &= self.same(nxt.m[k], kern[0]) and \
                    self.same(nxt.s[k], kern[1])
            same &= all(self.same(p, q) for p, q in
                        zip(eng._exchange(nxt.m), nxt.halos))
            check(same, f"{label}, iteration {it}: the engine's "
                  f"{len(eng.coords)} brick sweeps and exchange, bitwise")
            st = nxt
        check(self.same(st.m, got.m) and self.same(st.s, got.s) and
              self.same(st.flips, got.flips) and
              all(self.same(p, q) for p, q in zip(st.halos, got.halos)),
              f"{label}: its iterations in turn are its 16-sweep run, "
              f"bitwise")

    def phase_main_path(self):
        t = self.torch
        from repro_torch import make_engine
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.bits import u32_to_numpy
        from repro_torch.core import lattice_dsim
        from repro_torch.core.packing import unpack_lanes
        from repro_torch.kernels import _build, ref
        print("== 3. main path: make_engine('lattice', L=100)", flush=True)

        # golden values from the JAX reference
        h = make_engine("lattice", L=L, seed=SEED, replicas=2,
                        precision="int8")
        check(h.device.type == "cuda" and h.kernel_path == "fused",
              f"int8 engine on {h.device}, kernel_path {h.kernel_path}")
        st, rec = h.run_recorded(h.init_state(seed=SEED), ea_schedule(16),
                                 [8, 16], sync_every=SYNC)
        check(rec.energies.tolist() == GOLDEN["energies"],
              f"int8 R=2 golden energies {rec.energies.tolist()}")
        check(st.flips.tolist() == GOLDEN["flips"],
              f"int8 R=2 golden per-replica flips {st.flips.tolist()}")
        m_sha = hashlib.sha256(st.m.cpu().numpy().tobytes()).hexdigest()
        s_sha = hashlib.sha256(u32_to_numpy(st.s).tobytes()).hexdigest()
        check(m_sha == GOLDEN["m_sha256"], f"int8 R=2 sha256(m) {m_sha[:16]}")
        check(s_sha == GOLDEN["s_sha256"], f"int8 R=2 sha256(s) {s_sha[:16]}")
        h = make_engine("lattice", L=L, seed=SEED, replicas=32,
                        precision="bitplane")
        st, rec = h.run_recorded(h.init_state(seed=SEED), ea_schedule(16),
                                 [8, 16], sync_every=SYNC)
        check(rec.energies[:, :2].tolist() == GOLDEN["energies"],
              "bit-plane R=32 golden energies, lanes 0-1")
        check(st.flips[:2].tolist() == GOLDEN["flips"],
              "bit-plane R=32 golden flips, lanes 0-1")

        # the default precision (f32): the same run, held to JAX's f32
        h = make_engine("lattice", L=L, seed=SEED, replicas=2)
        check(h.device.type == "cuda" and h.precision == "f32" and
              h.kernel_path == "fused",
              f"default engine: {h.precision} on {h.device}, kernel_path "
              f"{h.kernel_path}")
        st, rec = h.run_recorded(h.init_state(seed=SEED), ea_schedule(16),
                                 [8, 16], sync_every=SYNC)
        s_sha = hashlib.sha256(u32_to_numpy(st.s).tobytes()).hexdigest()
        check(s_sha == GOLDEN["s_sha256"], f"f32 R=2 sha256(s) {s_sha[:16]}")
        e_rel = float(np.max(np.abs(rec.energies.cpu().numpy()
                                    / np.array(GOLDEN_F32["energies"]) - 1)))
        f_rel = float(np.max(np.abs(st.flips.cpu().numpy()
                                    / np.array(GOLDEN_F32["flips"]) - 1)))
        check(e_rel < 0.005 and f_rel < 0.005,
              f"f32 R=2 energies {rec.energies.tolist()} and flips "
              f"{st.flips.tolist()} within 0.5% of JAX f32 (max relative "
              f"differences {e_rel:.3e}, {f_rel:.3e})")

        # the first 16 sweeps: kernels == impl="ref" (int8, bit-plane),
        # per-phase == fused (int8, f32), bit-plane lanes == int8 replicas
        first16 = {k: v for k, v in MAIN_RUNS.items() if "s41" not in k}
        first16.update({
            "int8 R=4 ref": dict(MAIN_RUNS["int8 R=4"], impl="ref"),
            "bitplane R=64 ref": dict(MAIN_RUNS["bitplane R=64"],
                                      impl="ref"),
            "int8 R=64": dict(precision="int8", replicas=64),
            "f32 per-phase R=4": dict(replicas=4, fused=False)})
        first = {}
        for label, kw in first16.items():
            h = self.engine(kw)
            cur = h.start_recorded(h.init_state(seed=SEED),
                                   ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                   sync_every=SYNC)
            cur.advance(1)
            check(cur.sweeps_done == 16 and cur.points_recorded == 1,
                  f"{label} ({h.kernel_path}): first chunk is 16 sweeps")
            first[label] = (cur.state, cur.record().energies,
                            cur.flips_per_replica())

        def same_run(x, y):
            (a, ea, fa), (b, eb, fb) = first[x], first[y]
            return (self.same(a.m, b.m) and self.same(a.s, b.s) and
                    self.same(a.flips, b.flips) and self.same(ea, eb) and
                    bool((fa == fb).all()) and
                    all(self.same(p, q) for p, q in zip(a.halos, b.halos)))
        for x, y in (("int8 R=4", "int8 R=4 ref"),
                     ("bitplane R=64", "bitplane R=64 ref"),
                     ("int8 per-phase R=4", "int8 R=4"),
                     ("f32 per-phase R=4", "f32 R=4"),
                     ("f32 per-phase bx R=4", "f32 R=4")):
            check(same_run(x, y), f"16 sweeps: {x} == {y}, bitwise (spins, "
                  f"LFSR, halos, flips, energies; E[0]="
                  f"{float(first[x][1][0, 0])})")

        (bp, ebp, fbp), (i8, ei8, fi8) = first["bitplane R=64"], \
            first["int8 R=64"]
        check(self.same(unpack_lanes(bp.m, 64), i8.m) and
              self.same(bp.s, i8.s) and self.same(bp.flips, i8.flips) and
              self.same(ebp, ei8) and (fbp == fi8).all(),
              "bit-plane lane (w, b) == int8 replica w*32+b (R=64, 16 "
              "sweeps: spins, LFSR, flips, energies)")

        # the main path: each configuration's launches counted on their own,
        # and the lanes unpacked (by the engine or a plain version) counted
        handles = {label: self.engine(kw) for label, kw in MAIN_RUNS.items()}
        inits = {label: hh.init_state(seed=SEED)
                 for label, hh in handles.items()}
        t.cuda.synchronize()
        self.rates = {}
        self.launches = dict.fromkeys(_build.launch_counts, 0)
        unpacked = [0]

        def counting(fn):
            def wrapped(*a, **k):
                unpacked[0] += 1
                return fn(*a, **k)
            return wrapped
        patched = [(mod, mod.unpack_lanes) for mod in (lattice_dsim, ref)]
        for label, hh in handles.items():
            _build.reset_launch_counts()
            unpacked[0] = 0
            for mod, fn in patched:
                mod.unpack_lanes = counting(fn)
            try:
                t0 = time.perf_counter()
                st, rec = hh.run_recorded(inits[label],
                                          ea_schedule(MAIN_SWEEPS),
                                          MAIN_POINTS, sync_every=SYNC)
                t.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                for mod, fn in patched:
                    mod.unpack_lanes = fn
            counts = {k: v for k, v in _build.launch_counts.items() if v}
            for k, v in counts.items():
                self.launches[k] += v
            R = hh.replicas
            e = rec.energies
            self.rates[label] = (L ** 3 * R * MAIN_SWEEPS / dt, dt, rec.flips)
            check(tuple(e.shape) == (len(MAIN_POINTS), R) and
                  bool(t.isfinite(e).all()),
                  f"{label}: energies finite, shape {tuple(e.shape)}")
            per_spin = (e[-1] / L ** 3).cpu()
            # the 3D +-J EA ground state is near -1.70 per spin; an anneal
            # of 256 sweeps ends a little above it
            check(bool((e[-1] < e[0]).all()) and
                  bool(((per_spin > -1.75) & (per_spin < -1.55)).all()),
                  f"{label}: annealed, E/N at {MAIN_SWEEPS} sweeps in "
                  f"[{float(per_spin.min()):.4f}, "
                  f"{float(per_spin.max()):.4f}]")
            sweep = {"bitplane": "pbit_bitplane_sweep",
                     "int8": "pbit_brick_sweep_int",
                     "f32": "pbit_brick_sweep"}[hh.precision]
            if hh.kernel_path == "per_phase":
                sweep = {"int8": "pbit_brick_update_int",
                         "f32": "pbit_brick_update"}[hh.precision]
            check(counts.get(sweep, 0) > 0 and
                  counts.get("brick_energy", 0) > 0,
                  f"{label} ({hh.kernel_path}) launched {counts}")
            if sweep in ("pbit_brick_sweep", "pbit_brick_sweep_int"):
                check(counts.get(f"{sweep}:lfsr_smem", 0) ==
                      counts.get(sweep, 0) == MAIN_SWEEPS // SYNC,
                      f"{label}: {counts.get(sweep, 0)} {sweep} launches, "
                      f"one persistent launch per {SYNC}-sweep call, each "
                      f"with its LFSR states in shared memory")
            if sweep in ("pbit_brick_update", "pbit_brick_update_int"):
                check(counts.get(f"{sweep}:word", 0) ==
                      counts.get(sweep, 0) == MAIN_SWEEPS * 2,
                      f"{label}: one {hh.precision} phase launch per color "
                      f"phase, one thread per word of 4 z-sites")
            n_energy = counts.get("brick_energy", 0)
            check(n_energy == counts.get("brick_energy:word", 0) ==
                  len(MAIN_POINTS), f"{label}: one energy launch per record "
                  f"point, one thread per word of 4 z-sites")
            if hh.precision == "bitplane":
                check(counts.get("brick_energy:bitplane", 0) == n_energy and
                      unpacked[0] == 0, f"{label}: every energy read from "
                      f"the word planes; lanes unpacked {unpacked[0]} times")
        for name in LATTICE_KERNELS:
            check(self.launches[name] > 0,
                  f"main path launched {name} {self.launches[name]} times")
        self.handles, self.inits = handles, inits

    def engine(self, kw):
        """``make_engine("lattice", L=100)`` of the main path with ``kw``
        (``fmt`` by name, ``mesh`` by its shape over AXES), on the card
        with no ``impl`` unless given."""
        from repro_torch import make_engine
        from repro_torch.core.mesh import make_mesh
        import repro_torch
        kw = dict(kw)
        if "fmt" in kw:
            kw["fmt"] = getattr(repro_torch, kw["fmt"])
        if "mesh" in kw:
            kw["mesh"] = make_mesh(kw["mesh"], AXES)
            kw["dim_axes"] = AXES
        return make_engine("lattice", L=L, seed=SEED, **kw)

    def phase_mesh(self, card: str):
        """The mesh path: the golden values of the JAX reference's (2,2,2)
        mesh, the first 16 sweeps of each MESH_RUNS configuration against
        its impl="ref" run on the card, the full runs timed with their
        launches counted, eta at two exchange cadences, a profiled run."""
        t = self.torch
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.bits import u32_to_numpy
        from repro_torch.kernels import _build
        print("== 4. mesh path: make_engine('lattice', L=100, mesh=...)",
              flush=True)
        # golden values: int8 R=2, bit-plane R=32 lanes 0-1, f32 R=2
        for label, kw in (("int8 R=2", dict(precision="int8", replicas=2)),
                          ("bitplane R=32", dict(precision="bitplane",
                                                 replicas=32)),
                          ("f32 R=2", dict(replicas=2))):
            h = self.engine(dict(kw, mesh=(2, 2, 2)))
            st, rec = h.run_recorded(h.init_state(seed=SEED),
                                     ea_schedule(16), [8, 16],
                                     sync_every=SYNC)
            g = h.eng.global_state(st)
            e, fl = rec.energies[:, :2].cpu().numpy(), \
                st.flips[:2].cpu().numpy()
            s_sha = hashlib.sha256(u32_to_numpy(g.s[:2]).tobytes()) \
                .hexdigest()
            check(s_sha == MESH_GOLDEN["s_sha256"],
                  f"mesh (2,2,2) {label}: sha256(s) of lanes 0-1 "
                  f"{s_sha[:16]}")
            if label.startswith("f32"):
                e_rel = float(np.max(np.abs(
                    e / np.array(MESH_GOLDEN["energies"]) - 1)))
                f_rel = float(np.max(np.abs(
                    fl / np.array(MESH_GOLDEN["flips"]) - 1)))
                check(e_rel < 0.005 and f_rel < 0.005,
                      f"mesh (2,2,2) {label}: energies {e.tolist()} and "
                      f"flips {fl.tolist()} within 0.5% of JAX (max "
                      f"relative differences {e_rel:.3e}, {f_rel:.3e})")
                continue
            check(e.tolist() == MESH_GOLDEN["energies"] and
                  fl.tolist() == MESH_GOLDEN["flips"],
                  f"mesh (2,2,2) {label}: golden energies {e.tolist()} and "
                  f"flips {fl.tolist()}")
            if label.startswith("int8"):
                m_sha = hashlib.sha256(g.m.cpu().numpy().tobytes()) \
                    .hexdigest()
                check(m_sha == MESH_GOLDEN["m_sha256"],
                      f"mesh (2,2,2) {label}: sha256(m) {m_sha[:16]}")

        # the first 16 sweeps of each configuration: CUDA == impl="ref"
        for label, kw in MESH_RUNS.items():
            first = []
            for impl in ("auto", "ref"):
                h = self.engine(dict(kw, impl=impl))
                st0 = h.init_state(seed=SEED)
                cur = h.start_recorded(st0, ea_schedule(MAIN_SWEEPS),
                                       MAIN_POINTS, sync_every=SYNC)
                cur.advance(1)
                if impl == "auto":
                    auto = (h, st0, cur.state)
                first.append((h.eng.global_state(cur.state),
                              cur.record().energies,
                              cur.flips_per_replica()))
            (a, ea, fa), (b, eb, fb) = first
            if h.precision == "f32":
                rel_e = float(((ea - eb).abs() / eb.abs()).max())
                rel_f = float(np.max(np.abs(fa / fb - 1)))
                n_diff = int((a.m != b.m).sum())
                check(self.same(a.s, b.s) and rel_e < 0.005 and
                      rel_f < 0.005, f"16 sweeps: {label} == impl='ref': "
                      f"LFSR states bitwise, energies and flips within 0.5% "
                      f"(largest {rel_e:.3e}, {rel_f:.3e}; "
                      f"{n_diff} spins differ)")
                self.f32_mesh_steps(label, *auto)
                if n_diff:
                    continue
            check(self.same(a.m, b.m) and self.same(a.s, b.s) and
                  self.same(a.flips, b.flips) and self.same(ea, eb) and
                  bool((fa == fb).all()) and
                  all(self.same(p, q) for p, q in zip(a.halos, b.halos)),
                  f"16 sweeps: {label} == impl='ref', bitwise (spins, LFSR, "
                  f"halos, flips, energies; E[0]={float(ea[0, 0])})")

        # the full runs, each with its launches counted on their own
        self.mesh_handles = {label: self.engine(kw)
                             for label, kw in MESH_RUNS.items()}
        inits = {label: hh.init_state(seed=SEED)
                 for label, hh in self.mesh_handles.items()}
        self.mesh_inits = inits
        self.mesh_launches = dict.fromkeys(_build.launch_counts, 0)
        self.mesh_rates = {}
        for label, hh in self.mesh_handles.items():
            K = len(hh.eng.coords)
            # a first run (the engine's first: its exchange maps and, on
            # the bit-plane path, its bricks' layouts are built in it),
            # its launches counted, then a second run timed again
            walls = []
            for turn in range(2):
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                st, rec = hh.run_recorded(inits[label],
                                          ea_schedule(MAIN_SWEEPS),
                                          MAIN_POINTS, sync_every=SYNC)
                t.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if turn == 0:
                    counts = {k: v for k, v in _build.launch_counts.items()
                              if v}
            dt = walls[1]
            for k, v in counts.items():
                self.mesh_launches[k] += v
            R = hh.replicas
            e = rec.energies
            rate = L ** 3 * R * MAIN_SWEEPS / dt
            self.mesh_rates[label] = (rate, dt, rec.flips)
            per_spin = (e[-1] / L ** 3).cpu()
            check(tuple(e.shape) == (len(MAIN_POINTS), R) and
                  bool(t.isfinite(e).all()) and bool((e[-1] < e[0]).all())
                  and bool(((per_spin > -1.75) & (per_spin < -1.55)).all()),
                  f"{label}: energies finite, annealed, E/N at "
                  f"{MAIN_SWEEPS} sweeps in [{float(per_spin.min()):.4f}, "
                  f"{float(per_spin.max()):.4f}]")
            sweep = {"bitplane": "pbit_bitplane_sweep",
                     "int8": "pbit_brick_sweep_int",
                     "f32": "pbit_brick_sweep"}[hh.precision]
            calls = K * MAIN_SWEEPS // SYNC
            if hh.precision == "bitplane":
                check(counts.get(sweep, 0) == calls * SYNC * 2,
                      f"{label}: {counts.get(sweep, 0)} {sweep} launches, "
                      f"one per color phase of each of {K} bricks")
            else:
                check(counts.get(sweep, 0) == calls,
                      f"{label}: {counts.get(sweep, 0)} {sweep} launches, "
                      f"one persistent launch per {SYNC}-sweep call of each "
                      f"of {K} bricks")
            path = "word" if hh.eng.brick[2] % 4 == 0 else "site"
            check(counts.get("brick_energy", 0) == K * len(MAIN_POINTS) and
                  (hh.precision == "bitplane" or
                   counts.get(f"brick_energy:{path}", 0) ==
                   K * len(MAIN_POINTS)),
                  f"{label}: one energy launch per brick and record point, "
                  f"brick {hh.eng.brick} on the {path} path")
            unit = "lane-flips/s" if hh.precision == "bitplane" \
                else "flips/s"
            print(f"  mesh path {label}: {K} bricks of {hh.eng.brick}, "
                  f"{MAIN_SWEEPS} sweeps in {dt:.4f} s = {rate:.4e} {unit} "
                  f"(first run {walls[0]:.4f} s; {rec.flips} accepted "
                  f"flips); launches {counts}; on {card}", flush=True)
        for name in ("pbit_brick_sweep_int", "pbit_bitplane_sweep",
                     "pbit_brick_sweep", "brick_energy"):
            check(self.mesh_launches[name] > 0,
                  f"mesh path launched {name} {self.mesh_launches[name]} "
                  f"times")
            self.launches[name] += self.mesh_launches[name]
        self.mesh_eta(card)
        self.profile_mesh(card)

    def mesh_eta(self, card: str):
        """The exchange alone (boundary_exchange_fn, CUDA events) and the
        EtaMeter's measured eta of ETA_RUN at sync_every 1 and SYNC."""
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.obs.timing import EtaMeter
        hh = self.mesh_handles[ETA_RUN]
        st = self.mesh_inits[ETA_RUN]
        fn = hh.eng.boundary_exchange_fn()
        ms = self.time_ms(lambda: fn(st), reps=200, warm=5)
        print(f"  mesh exchange ({ETA_RUN}, {len(hh.eng.coords)} bricks): "
              f"{ms * 1e3:.1f} us per call (CUDA events); an in-process "
              f"gather on one card, not a network link; on {card}",
              flush=True)
        for sync in (1, SYNC):
            hh.run_recorded(st, ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                            sync_every=sync)                    # warm
            cur = hh.start_recorded(st, ea_schedule(MAIN_SWEEPS),
                                    MAIN_POINTS, sync_every=sync)
            meter = EtaMeter(n_color=hh.eng.p.n_colors,
                             sync_every=sync).attach(cur)
            while not cur.done:
                cur.advance(1)
            meter.measure_exchange(lambda: fn(cur.state), reps=100,
                                   warmup=5)
            r = meter.report()
            check(np.isnan(r["eta_threshold"]) and
                  all(np.isfinite(r[k]) and r[k] > 0 for k in (
                      "measured_eta", "f_comm_hz", "f_pbit_hz")),
                  f"eta at sync_every={sync}: finite")
            print(f"  eta {ETA_RUN}, sync_every={sync}: measured eta "
                  f"{r['measured_eta']:.4e}, f_comm {r['f_comm_hz']:.4e} "
                  f"Hz (exchange {r['t_exchange_s'] * 1e6:.1f} us), f_pbit "
                  f"{r['f_pbit_hz']:.4e} Hz (sweep "
                  f"{r['t_pbit_sweep_s'] * 1e6:.1f} us), "
                  f"{r['chunks_recorded']} chunks, "
                  f"{r['exchanges_attributed']:.0f} exchanges attributed; "
                  f"the exchange is an in-process gather on one card, not "
                  f"a network link; on {card}", flush=True)

    def profile_mesh(self, card: str):
        """Device time by kernel over one more run of MESH_PROFILED at
        ``sync_every`` SYNC and 1, and the device's busy share of its wall
        time; the int8 sweep's launch shape on one brick and its device
        time per launch."""
        t = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.kernels.pbit_lattice import (_persistent_config,
                                                      persistent_mode)
        hh = self.mesh_handles[MESH_PROFILED]
        m = self.mesh_inits[MESH_PROFILED].m[0]
        mode = persistent_mode(m)
        grid, tile, smem, per_sm = _persistent_config(
            0, "int8", mode == "lfsr_smem", int(m.shape[0]),
            int(m[0].numel()))
        print(f"  {MESH_PROFILED}: the int8 sweep on one brick of "
              f"{tuple(m.shape[1:])}: persistent, {mode} (grid {grid} = "
              f"{per_sm} per SM, tile {tile} sites, {smem} B shared)",
              flush=True)
        for sync in (SYNC, 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                hh.run_recorded(self.mesh_inits[MESH_PROFILED],
                                ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                sync_every=sync)
                t.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = [(e.key, e.count, e.self_device_time_total)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0]
            what = f"profile {MESH_PROFILED}, sync_every={sync}"
            if not rows:
                print(f"  {what}: the profiler saw no device time; device "
                      f"busy share not measured", flush=True)
                continue
            busy = sum(us for _, _, us in rows) / 1e6
            hits = [(c, us) for key, c, us in rows if all(
                p in key for p in REDESIGNED["pbit_brick_sweep_int"])]
            count, us = sum(c for c, _ in hits), sum(u for _, u in hits)
            print(f"  {what}: wall {wall:.4f} s under the profiler, device "
                  f"busy {busy:.4f} s ({100 * busy / wall:.1f}%); int8 "
                  f"sweep {count} launches, {us / max(count, 1):.1f} us per "
                  f"launch of {sync} sweeps on {card}", flush=True)
            for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
                print(f"    {us / 1e3:10.3f} ms  {count:5d} x  {key[:90]}",
                      flush=True)

    def phase_timing(self, card: str):
        t = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.lattice_energy import (brick_energy,
                                                        brick_energy_words)
        from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
        from repro_torch.kernels.pbit_lattice import (phase_width,
                                                      pbit_brick_sweep,
                                                      pbit_brick_sweep_int,
                                                      pbit_brick_update,
                                                      pbit_brick_update_int)
        print(f"== 5. timing on {card}", flush=True)
        sms = t.cuda.get_device_properties(0).multi_processor_count
        clock = max_sm_clock_hz()
        self.int_peak = sms * INT32_PER_SM_CLOCK * clock
        self.f32_peak = sms * FP32_PER_SM_CLOCK * clock
        print(f"  peaks: {sms} SMs at {clock / 1e6:.0f} MHz: "
              f"{self.int_peak:.4e} INT32 and {self.f32_peak:.4e} FP32 "
              f"operations/s; HBM {HBM_BYTES_PER_S:.3e} B/s", flush=True)
        for label, (rate, dt, flips) in self.rates.items():
            unit = "lane-flips/s" if "bitplane" in label else "flips/s"
            print(f"  main path {label}: {MAIN_SWEEPS} sweeps in "
                  f"{dt:.4f} s = {rate:.4e} {unit} (p-bit updates; "
                  f"{flips} accepted flips) on {card}", flush=True)
        self.profile_main_path(card)
        n = self.n
        plane = 6 * L * L

        # Operations each function needs on this run's data (the bound is
        # the least time, so only what the result needs is counted): per
        # replica-site and phase one LFSR step (6 integer ops); per
        # replica-site decided (the sites in the phase's mask): int8, the
        # field's 12 ops, index, clamp, LUT load and compare, 19 in all;
        # f32, the field's 12, the draw's 2, the activation, tanh counted
        # once, the add and compare, 18 f32 ops in all; bit-plane, per
        # decided word-site the 26 ops of the word math and per decided
        # lane-site 13 (bit-slice count, index, clamp, LUT, accept bit).
        m, s, masks, h_q, w6_q, halos, lut, rows = self.inputs_int8
        R, nc = int(m.shape[0]), int(masks.shape[0])
        decided = int((masks != 0).sum())      # masked sites over a sweep
        args = (m, s, t.from_numpy(rows).to(self.dev), masks, h_q, w6_q,
                halos, lut)
        byts = (2 * 5 * R * n + (nc + 7) * n + 4 * R + R * plane
                + 4 * lut.numel() + 4 * SYNC)
        self._timed("pbit_brick_sweep_int", "src/repro_torch/kernels/csrc/"
                    "pbit_lattice.cu", "src/repro/kernels/pbit_lattice.py:235",
                    lambda: pbit_brick_sweep_int(*args),
                    lambda: ref.pbit_brick_sweep_int_ref(*args), byts,
                    SYNC * R * (6 * nc * n + 19 * decided), 0,
                    f"{SYNC} sweeps, R={R}, 1 launch")
        g = self.inputs_int8_global
        R16 = int(g[0].shape[0])
        byts16 = (2 * 5 * R16 * n + (nc + 7) * n + 4 * R16 + R16 * plane
                  + 4 * lut.numel() + 4 * SYNC * R16)
        ms = self.time_ms(lambda: pbit_brick_sweep_int(*g), reps=20)
        print(f"  pbit_brick_sweep_int, R={R16}, LFSR in device memory "
              f"({SYNC} sweeps, 1 launch): {ms:.4f} ms; on {card}",
              flush=True)

        mw, s, rows, masks_w, signs6, nz6, base, hw, lut = self.inputs_bp
        W, R, nc = int(mw.shape[0]), int(s.shape[0]), int(masks_w.shape[0])
        decided = int((masks_w.view(t.int32)[:, 0] != 0).sum())
        args = (mw, s, rows, masks_w, signs6, nz6, base, hw, lut)
        byts = (2 * 4 * (W + R) * n + 4 * nc * W * n + 52 * n + 4 * R
                + 4 * W * plane + 4 * lut.numel() + 4 * SYNC)
        self._timed("pbit_bitplane_sweep", "src/repro_torch/kernels/csrc/"
                    "pbit_bitplane.cu",
                    "src/repro/kernels/pbit_bitplane.py:135",
                    lambda: pbit_bitplane_sweep(*args),
                    lambda: ref.pbit_bitplane_sweep_ref(*args), byts,
                    SYNC * (6 * nc * R * n + decided * (26 * W + 13 * R)),
                    0, f"{SYNC} sweeps, R={R}, W={W}, {SYNC * nc} launches")

        # the energy: its bound is the work of R int8 replicas (1 B per
        # replica-site), whichever layout holds the spins
        args = self.inputs_energy[64]
        R = int(args[0].shape[0])
        byts = R * n + 29 * n + R * plane + 4 * R
        self._timed("brick_energy", "src/repro_torch/kernels/csrc/"
                    "lattice_energy.cu",
                    "src/repro/kernels/lattice_energy.py:57",
                    lambda: brick_energy(*args),
                    lambda: ref.brick_energy_ref(*args),
                    byts, 0, 17 * R * n, f"R={R} int8 spins, 2 launches")
        for what, fn, r in (
                ("int8 spins", lambda: brick_energy(*self.inputs_energy[4]),
                 4),
                ("word planes", lambda: brick_energy_words(
                    *self.inputs_energy_words), 64)):
            ms = self.time_ms(fn, reps=50)
            byts = r * n + 29 * n + r * plane + 4 * r
            bound = max(byts / HBM_BYTES_PER_S, 17 * r * n / self.f32_peak)
            print(f"  brick_energy, R={r} {what}: {ms:.4f} ms per call, "
                  f"bound {bound * 1e3:.4f} ms; on {card}", flush=True)
        self.time_readout(card)

        args = self.inputs_f32
        m, masks = args[0], args[3]
        R, nc = int(m.shape[0]), int(masks.shape[0])
        decided = int((masks != 0).sum())
        byts = (2 * 5 * R * n + (nc + 28) * n + R * plane + 4 * R
                + 4 * SYNC * R)
        self._timed("pbit_brick_sweep", "src/repro_torch/kernels/csrc/"
                    "pbit_lattice.cu", "src/repro/kernels/pbit_lattice.py:287",
                    lambda: pbit_brick_sweep(*args),
                    lambda: ref.pbit_brick_sweep_ref(*args), byts,
                    SYNC * 6 * nc * R * n, SYNC * 18 * R * decided,
                    f"{SYNC} sweeps, R={R}, 1 launch")
        g = self.inputs_f32_global
        R16 = int(g[0].shape[0])
        ms16 = self.time_ms(lambda: pbit_brick_sweep(*g), reps=20)
        byts16 = (2 * 5 * R16 * n + (nc + 28) * n + R16 * plane + 4 * R16
                  + 4 * SYNC * R16)
        print(f"  pbit_brick_sweep, LFSR in device memory (R={R16}, "
              f"{SYNC} sweeps, 1 launch): {ms16:.4f} ms, byte floor "
              f"{byts16 / HBM_BYTES_PER_S * 1e3:.4f} ms; on {card}",
              flush=True)

        # one phase: each input read once and each output written once
        args = self.inputs_update_int
        lut = args[-1]
        R = int(args[0].shape[0])
        byts = 2 * 5 * R * n + 8 * n + R * plane + 4 * lut.numel() + 4 * R
        decided = int((args[3] != 0).sum())
        self._timed("pbit_brick_update_int", "src/repro_torch/kernels/csrc/"
                    "pbit_lattice.cu", "src/repro/kernels/pbit_lattice.py:450",
                    lambda: pbit_brick_update_int(*args),
                    lambda: ref.pbit_brick_update_int_ref(*args),
                    byts, R * (6 * n + 19 * decided), 0,
                    f"one phase, R={R}, 1 launch")
        args = self.inputs_update_f32
        byts = 2 * 5 * R * n + 29 * n + R * plane + 4 * R
        decided = int((args[3] != 0).sum())
        self._timed("pbit_brick_update", "src/repro_torch/kernels/csrc/"
                    "pbit_lattice.cu", "src/repro/kernels/pbit_lattice.py:340",
                    lambda: pbit_brick_update(*args),
                    lambda: ref.pbit_brick_update_ref(*args),
                    byts, 6 * R * n, 18 * R * decided,
                    f"one phase, R={R}, 1 launch")
        # the host time of the wrapper's word-or-site choice (14 pointers
        # read, their alignment tested), part of each call above
        m, s, _, mask, h, w6, halos = args
        wide, narrow = (s, s, h, *w6), (m, m, mask, *halos)
        t0 = time.perf_counter()
        for _ in range(10000):
            phase_width(int(m.shape[-1]), [x.data_ptr() for x in wide],
                        [x.data_ptr() for x in narrow])
        print(f"  pbit_brick_update: the word-or-site choice takes "
              f"{(time.perf_counter() - t0) * 100:.2f} us of host time "
              f"per call; on {card}", flush=True)
        for name, r in self.results.items():
            print(f"  {name}: {r['ms']:.4f} ms ({r['work']}), plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"by {r['bound_by']} ({r['bounds']}); {r['launches']} "
                  f"launches on the main path; on {card}", flush=True)
            del r["work"], r["bounds"]

    def time_readout(self, card: str):
        """The bit-plane main path's energy readout (exchange of the word
        planes, the word-plane energy) against the readout it replaces
        (unpack the lanes, an int8 exchange, the int8 energy), on the same
        state; they must agree bitwise (+-J)."""
        from repro_torch.core.packing import unpack_lanes
        from repro_torch.kernels.lattice_energy import brick_energy
        eng = self.handles["bitplane R=64"].eng
        st = self.inits["bitplane R=64"]
        R = eng.replicas

        def unpack_first():
            m = unpack_lanes(st.m, R)
            return brick_energy(m, eng.p.active, eng.p.h, eng.p.w6,
                                eng._squeeze(eng._exchange(m)))
        check(self.same(eng.energy(st), unpack_first()),
              f"bit-plane readout (R={R}) == the unpack-first readout, "
              f"bitwise")
        new = self.time_ms(lambda: eng.energy(st), reps=50)
        old = self.time_ms(unpack_first, reps=50)
        unpack = self.time_ms(lambda: unpack_lanes(st.m, R), reps=50)
        exch = self.time_ms(lambda: eng._exchange(st.m), reps=50)
        print(f"  bit-plane readout (R={R}): {new:.4f} ms per record point "
              f"(word exchange {exch:.4f} ms + word-plane energy); the "
              f"unpack-first readout {old:.4f} ms (unpack {unpack:.4f} ms); "
              f"on {card}", flush=True)

    def profile_main_path(self, card: str):
        """Device time by kernel over one more run of each main-path
        configuration, and the device's busy share of its wall time (the
        profiler's own cost is in that wall time); the redesigned kernels'
        mode and device time per launch."""
        t = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.kernels import _build
        from repro_torch.kernels.pbit_lattice import (_persistent_config,
                                                      persistent_mode)
        for label in PROFILED:
            hh = self.handles[label]
            _build.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                hh.run_recorded(self.inits[label],
                                ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                sync_every=SYNC)
                t.cuda.synchronize()
                wall = time.perf_counter() - t0
            # device events only: an aten operator's row repeats the
            # device time of the kernels it launched
            rows = [(e.key, e.count, e.self_device_time_total)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0]
            busy = sum(us for _, _, us in rows) / 1e6
            if not rows:
                print(f"  profile {label}: the profiler saw no device "
                      f"time; device busy share not measured", flush=True)
                continue
            print(f"  profile {label}: wall {wall:.4f} s under the "
                  f"profiler, device busy {busy:.4f} s "
                  f"({100 * busy / wall:.1f}%) on {card}", flush=True)
            for key, count, us in sorted(rows, key=lambda r: -r[2])[:6]:
                print(f"    {us / 1e3:10.3f} ms  {count:5d} x  {key[:90]}",
                      flush=True)
            for name, parts in REDESIGNED.items():
                hits = [(c, us) for key, c, us in rows
                        if all(p in key for p in parts)]
                if not hits or not _build.launch_counts[name]:
                    continue
                count, us = sum(c for c, _ in hits), sum(u for _, u in hits)
                calls = _build.launch_counts[name]
                mode = "per color phase"
                if name in ("pbit_brick_sweep", "pbit_brick_sweep_int"):
                    m = self.inits[label].m
                    mode = persistent_mode(m)
                    kind = "f32" if name == "pbit_brick_sweep" else "int8"
                    grid, tile, smem, per_sm = _persistent_config(
                        0, kind, mode == "lfsr_smem", int(m.shape[0]),
                        int(m[0].numel()))
                    mode = (f"persistent, {mode} (grid {grid} = {per_sm} "
                            f"per SM, tile {tile} sites, {smem} B shared)")
                elif name in ("pbit_brick_update", "pbit_brick_update_int"):
                    mode = "per color phase, one thread per word"
                elif name == "brick_energy":
                    mode = "per record point, two passes, one thread per word"
                print(f"  redesigned {name} in {label}: {mode}; {count} "
                      f"kernel launches in {calls} calls, {us / calls:.1f} "
                      f"us per call (profiler) on {card}", flush=True)

    # -- the general-graph engines -----------------------------------------

    def phase_graph(self, card: str):
        """The general-graph engines at L=100 through make_engine("gibbs")
        and make_engine("dsim"): the JAX golden values, every GRAPH_RUNS
        configuration against its device="cpu" twin over the first 16
        sweeps, then timed over MAIN_SWEEPS with the kernel launch counts
        read (these engines are PyTorch operations; they launch none of
        the six kernels), and one profiled run of each engine."""
        t = self.torch
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.coloring import (greedy_coloring,
                                               lattice3d_coloring)
        from repro_torch.core.dsim import build_partitioned
        from repro_torch.core.graph import ea3d
        from repro_torch.core.partition import brick_partition
        from repro_torch.kernels import _build
        from repro_torch.problems.maxcut import (cut_of, gset_like_toroidal,
                                                 maxcut_to_ising)
        print(f"== 6. general-graph engines: make_engine('gibbs' | 'dsim') "
              f"at L={L}", flush=True)
        t0 = time.perf_counter()
        self.g = ea3d(L, seed=SEED)
        self.col = lattice3d_coloring(L)
        self.prob = build_partitioned(
            self.g, self.col, brick_partition((L, L, L), BRICKS),
            int(np.prod(BRICKS)))
        t1 = time.perf_counter()
        self.g81 = gset_like_toroidal(**G81)
        self.g81_ising = maxcut_to_ising(self.g81)
        self.col81 = greedy_coloring(self.g81_ising.idx, self.g81_ising.w)
        check(self.g.device.type == self.prob.device.type ==
              self.g81.device.type == "cuda",
              f"graph ({self.g.n} p-bits), partition (K={self.prob.K}, "
              f"n_max {self.prob.n_max}, g_max {self.prob.g_max}) and G81 "
              f"graph ({self.g81.n} p-bits, {self.col81.n_colors} colours) "
              f"built on {self.g.device} in {t1 - t0:.2f} s and "
              f"{time.perf_counter() - t1:.2f} s of host time")
        self.graph_golden()
        self.graph_rates = {}
        for label, kw in GRAPH_RUNS.items():
            self.graph_vs_cpu(label, kw)
        for label, kw in GRAPH_RUNS.items():
            hh, sync = self.graph_engine(kw)
            n = hh.n_sites
            st0 = hh.init_state(seed=SEED)
            walls = []
            for _ in range(2):      # the engine's first run, then a second
                t.cuda.synchronize()
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                st, rec = hh.run_recorded(st0, ea_schedule(MAIN_SWEEPS),
                                          MAIN_POINTS, sync_every=sync)
                t.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            dt = walls[1]
            counts = {k: v for k, v in _build.launch_counts.items() if v}
            check(not counts, f"{label}: plain PyTorch operations, none of "
                  f"the six kernels launched ({counts})")
            R = hh.replicas
            e = rec.energies
            per_spin = (e[-1] / n).cpu()
            lo, hi = (-1.45, -1.25) if kw.get("graph") == "g81" else \
                (-1.75, -1.55)
            check(tuple(e.shape) == (len(MAIN_POINTS), R) and
                  bool(t.isfinite(e).all()) and bool((e[-1] < e[0]).all())
                  and bool(((per_spin > lo) & (per_spin < hi)).all()),
                  f"{label}: energies finite, shape {tuple(e.shape)}, "
                  f"annealed, E/N at {MAIN_SWEEPS} sweeps in "
                  f"[{float(per_spin.min()):.4f}, {float(per_spin.max()):.4f}]"
                  f" (within ({lo}, {hi}))")
            if kw.get("graph") == "g81":
                w_tot = float(self.g81.w.sum()) / 2
                cuts = [cut_of(self.g81, st.m[r]) for r in range(R)]
                check(all(c == (w_tot - float(er)) / 2
                          for c, er in zip(cuts, e[-1].tolist())),
                      f"{label}: Max-Cut values {cuts} == (W - E) / 2")
            self.graph_rates[label] = (n * R * MAIN_SWEEPS / dt, dt,
                                       rec.flips)
            print(f"  {label}: {MAIN_SWEEPS} sweeps of {n} p-bits x R={R} in "
                  f"{dt:.4f} s = {n * R * MAIN_SWEEPS / dt:.4e} flips/s "
                  f"(first run {walls[0]:.4f} s; {rec.flips} accepted "
                  f"flips) on {card}", flush=True)
        for label in GRAPH_PROFILED:
            self.profile_graph(label, card)

    def graph_engine(self, kw, device=None):
        """(handle, sync_every) of a GRAPH_RUNS configuration, on the card
        or on ``device``."""
        import repro_torch
        from repro_torch import make_engine
        kw = dict(kw)
        engine, sync = kw.pop("engine"), kw.pop("sync", 1)
        graph = kw.pop("graph", None)
        if "fmt" in kw:
            kw["fmt"] = getattr(repro_torch, kw["fmt"])
        kw.setdefault("rng", "lfsr")
        if engine == "dsim":
            return make_engine("dsim", self.prob, device=device, **kw), sync
        g, col = (self.g81_ising, self.col81) if graph == "g81" else \
            (self.g, self.col)
        return make_engine("gibbs", g, coloring=col, device=device,
                           **kw), sync

    def graph_golden(self):
        """The JAX reference's L=100 runs from graph_m0: gibbs f32 (LFSR
        digest exactly, energies and flips to 0.5%), dsim int8 on K=8
        (energies, flips, spin and LFSR digests bitwise)."""
        from repro_torch import make_engine
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.bits import u32_to_numpy
        sha = lambda a: hashlib.sha256(a.tobytes()).hexdigest()  # noqa: E731
        m0 = graph_m0(L ** 3)
        h = make_engine("gibbs", self.g, coloring=self.col, rng="lfsr",
                        replicas=2)
        st, rec = h.run_recorded(h.eng.init_state(SEED, m0=m0, replicas=2),
                                 ea_schedule(16), [8, 16])
        s_sha = sha(u32_to_numpy(st.rng))
        check(s_sha == GIBBS_GOLDEN["s_sha256"],
              f"gibbs f32 R=2 golden sha256(LFSR) {s_sha[:16]}")
        e_rel = float(np.max(np.abs(rec.energies.cpu().numpy()
                                    / np.array(GIBBS_GOLDEN["energies"]) - 1)))
        f_rel = float(np.max(np.abs(st.flips.cpu().numpy()
                                    / np.array(GIBBS_GOLDEN["flips"]) - 1)))
        check(e_rel < 0.005 and f_rel < 0.005,
              f"gibbs f32 R=2 energies {rec.energies.tolist()} and flips "
              f"{st.flips.tolist()} within 0.5% of JAX (max relative "
              f"differences {e_rel:.3e}, {f_rel:.3e})")
        h = make_engine("dsim", self.prob, rng="lfsr", precision="int8",
                        replicas=2)
        st, rec = h.run_recorded(h.eng.init_state(SEED, m0=m0, replicas=2),
                                 ea_schedule(16), [8, 16], sync_every=SYNC)
        check(rec.energies.tolist() == DSIM_GOLDEN["energies"] and
              st.flips.tolist() == DSIM_GOLDEN["flips"],
              f"dsim int8 K=8 R=2 golden energies {rec.energies.tolist()} "
              f"and flips {st.flips.tolist()}")
        m_sha, s_sha = sha(st.m.cpu().numpy()), sha(u32_to_numpy(st.rng))
        check(m_sha == DSIM_GOLDEN["m_sha256"] and
              s_sha == DSIM_GOLDEN["s_sha256"],
              f"dsim int8 K=8 R=2 golden sha256(m) {m_sha[:16]}, "
              f"sha256(LFSR) {s_sha[:16]}")

    def graph_vs_cpu(self, label: str, kw):
        """The first 16 sweeps of a configuration on the card against its
        device="cpu" twin.  int8: bitwise.  f32 with LFSR: the card's
        engine runs with every colour phase held to the twin's phase from
        the same input (LFSR states bitwise, each differing spin within
        TANH_ULPS ulp of its decision boundary, the twin's spins carried
        on), and the whole run must then equal the twin's own run bitwise.
        philox (another stream on each device): energies within 0.5%, and
        the card's run repeated from the same state bitwise."""
        hg, sync = self.graph_engine(kw)
        hc, _ = self.graph_engine(kw, device="cpu")
        held = None
        if hg.precision == "f32" and hg.eng.rng_kind == "lfsr":
            held = self.hold_phases(hg.eng, hc.eng)
        try:
            got = self.first16(hg, sync)
        finally:
            if held is not None:
                del hg.eng._phase
        want = self.first16(hc, sync)
        (a, ea, fa), (b, eb, fb) = got, want
        if hg.eng.rng_kind == "philox":
            rel = float(((ea.cpu() - eb) / eb).abs().max())
            check(rel < 0.005, f"{label}: 16 sweeps on the card vs the CPU "
                  f"(another philox stream): energies within 0.5% "
                  f"({rel:.2e})")
            again = self.first16(hg, sync)
            check(self.same(again[1], ea) and self.same(again[0].m, a.m),
                  f"{label}: the card's philox run repeats bitwise")
            return
        same = all(self.same(getattr(a, f).cpu(), getattr(b, f))
                   for f in ("m", "rng", "sweep", "flips")) and \
            self.same(ea.cpu(), eb) and bool((fa == fb).all())
        for f in ("E", "ghosts", "macc"):
            if hasattr(a, f):
                same &= self.same(getattr(a, f).cpu(), getattr(b, f))
        what = "bitwise" if held is None else (
            f"bitwise, each of its {held['phases']} phases held to the CPU's "
            f"({held['differ']} decisions differed, all within {TANH_ULPS} "
            f"ulp of the boundary)")
        check(same, f"{label}: 16 sweeps on the card == device='cpu', "
              f"{what} (spins, LFSR, flips, energies; E[0]="
              f"{float(ea[0, 0])})")

    def first16(self, hh, sync):
        from repro_torch.core.annealing import ea_schedule
        cur = hh.start_recorded(hh.init_state(seed=SEED),
                                ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                sync_every=sync)
        cur.advance(1)
        check(cur.sweeps_done == 16 and cur.points_recorded == 1,
              f"{hh.name} on {hh.device}: first chunk is 16 sweeps")
        return cur.state, cur.record().energies, cur.flips_per_replica()

    def hold_phases(self, eng, twin) -> dict:
        """Wrap the card engine's colour phase: each call also runs the CPU
        twin's phase on CPU copies of its inputs; the LFSR states must be
        equal and every differing spin within TANH_ULPS ulp of its
        boundary; the card then carries the twin's spins and returns its
        counts, so the two runs cannot drift apart.  Returns the tally."""
        t = self.torch
        from repro_torch.core.gibbs import color_fields
        from repro_torch.core.pbit import lfsr_next, lfsr_uniform, quantize
        tally = {"phases": 0, "differ": 0}
        phase = eng._phase
        gibbs = not hasattr(eng, "_colors")

        def host(x):
            return x.to("cpu", copy=True)

        def held(*args):
            if gibbs:
                c, m, s, gens, beta = args
                sites = twin._nodes[c]
                field = color_fields(host(m), twin._idx[c], twin._w[c],
                                     twin._h[c])
                rest = ()
            else:
                col, m, ghosts, s, gens, beta, thr = args
                k = next(i for i, x in enumerate(eng._colors) if x is col)
                c = twin._colors[k]
                sites = c.slots
                field = twin._field(c, host(m), host(ghosts))
                rest = (host(ghosts),)
            # the colour's sites in the state's layout, on its last axis
            sites = sites.expand(field.shape)
            mc, sc = host(m), host(s)
            r = lfsr_uniform(lfsr_next(t.gather(sc, -1, sites)))
            want = twin._phase(c, mc, *rest, sc, None, beta, *(
                () if gibbs else (None,)))
            got = phase(*args)
            if not self.same(s.cpu(), sc):
                raise CheckFailed(f"phase {tally['phases']}: LFSR states "
                                  f"differ from the CPU's")
            diff = m.cpu() != mc
            if bool(diff.any()):
                th = t.tanh(quantize(beta * field, eng.fmt))
                a = th.abs()
                ulp = t.nextafter(a, t.full_like(a, float("inf"))) - a
                ulps = t.full(diff.shape, float("inf"))
                ulps.scatter_(-1, sites, (th + r).abs() / ulp)
                far = int((diff & (ulps > TANH_ULPS)).sum())
                if far:
                    raise CheckFailed(
                        f"phase {tally['phases']}: {int(diff.sum())} spins "
                        f"differ from the CPU's, {far} beyond {TANH_ULPS} "
                        f"ulp of the boundary")
                tally["differ"] += int(diff.sum())
                m.copy_(mc)
            tally["phases"] += 1
            if gibbs:
                return tuple(x.to(got[0].device) for x in want)
            return want.to(got.device)
        eng._phase = held
        return tally

    def phase_bytes(self, hh) -> float:
        """Bytes one colour phase must move, averaged over the colours:
        the colour's ELL rows (int32 neighbours, f32 couplings, its
        biases) read once, every replica's spins (and on dsim its ghosts,
        f32) read once, the colour's LFSR states read and written, its
        spins written."""
        R, eng = hh.replicas, hh.eng
        if hh.name == "gibbs":
            sites = [int(x.numel()) for x in eng._nodes]
            D, spins = eng.g.max_degree, eng.n
        else:
            sites = [int(c.slots.numel()) for c in eng._colors]
            D = int(eng.p.local_idx.shape[-1])
            spins = eng.p.K * (eng.p.n_max + 4 * eng.p.g_max)
        nc = sum(sites) / len(sites)
        return nc * (8 * D + 4) + R * spins + R * nc * (4 + 4 + 1)

    def profile_graph(self, label: str, card: str):
        """One profiled run of a GRAPH_RUNS configuration: the device's
        busy share of the wall time, device operations per colour phase,
        the costliest operations."""
        t = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.annealing import ea_schedule
        hh, sync = self.graph_engine(GRAPH_RUNS[label])
        st0 = hh.init_state(seed=SEED)
        t.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hh.run_recorded(st0, ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                            sync_every=sync)
            t.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if not rows:
            print(f"  profile {label}: the profiler saw no device time; "
                  f"device busy share not measured", flush=True)
            return
        busy = sum(us for _, _, us in rows) / 1e6
        ops = sum(c for _, c, _ in rows)
        phases = MAIN_SWEEPS * self.col.n_colors
        bound = self.phase_bytes(hh) / HBM_BYTES_PER_S
        print(f"  profile {label}: wall {wall:.4f} s under the profiler, "
              f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
              f"{ops} device operations = {ops / phases:.1f} per colour "
              f"phase ({phases} phases, record points included); device "
              f"time per phase {busy / phases * 1e3:.4f} ms against a "
              f"byte floor of {bound * 1e3:.4f} ms on {card}", flush=True)
        for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
            print(f"    {us / 1e3:10.3f} ms  {count:6d} x  {key[:90]}",
                  flush=True)

    # -- the distributed DSIM -----------------------------------------------

    def phase_dist(self, card: str):
        """The distributed DSIM at L=100 through make_engine("dsim_dist"),
        all K partitions on the card: the gather-count kernel against its
        plain version, the JAX golden values, every DIST_RUNS
        configuration against its device="cpu" twin over the first 16
        sweeps, then timed over MAIN_SWEEPS with the launches counted, the
        exchange and eta at two cadences, and a profiled bit-plane run."""
        t = self.torch
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.kernels import _build
        print(f"== 7. distributed DSIM: make_engine('dsim_dist') at L={L}, "
              f"K={self.prob.K} partitions on one card", flush=True)
        self.dist_kernel()
        self.dist_golden()
        for label, kw in DIST_RUNS.items():
            self.dist_vs_cpu(label, kw)
        self.dist_rates = {}
        phases = MAIN_SWEEPS * self.col.n_colors
        for label, kw in DIST_RUNS.items():
            hh, sync = self.dist_engine(kw)
            n, R = hh.n_sites, hh.replicas
            st0 = hh.init_state(seed=SEED)
            walls = []
            for _ in range(2):      # the engine's first run, then a second
                t.cuda.synchronize()
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                st, rec = hh.run_recorded(st0, ea_schedule(MAIN_SWEEPS),
                                          MAIN_POINTS, sync_every=sync)
                t.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            counts = {k: v for k, v in _build.launch_counts.items() if v}
            gathers = counts.pop("bitplane_gather_count", 0)
            if hh.precision == "bitplane":
                self.launches["bitplane_gather_count"] = gathers
                check(gathers == phases and not counts,
                      f"{label}: the gather-count kernel launched {gathers} "
                      f"times, once per colour phase ({phases}); no lattice "
                      f"kernel ({counts})")
            else:
                check(gathers == 0 and not counts,
                      f"{label}: plain PyTorch operations, no kernel "
                      f"launched ({counts}, gather-count {gathers})")
            e = rec.energies
            per_spin = (e[-1] / n).cpu()
            check(tuple(e.shape) == (len(MAIN_POINTS), R) and
                  bool(t.isfinite(e).all()) and bool((e[-1] < e[0]).all())
                  and bool(((per_spin > -1.75) & (per_spin < -1.55)).all()),
                  f"{label}: energies finite, shape {tuple(e.shape)}, "
                  f"annealed, E/N at {MAIN_SWEEPS} sweeps in "
                  f"[{float(per_spin.min()):.4f}, {float(per_spin.max()):.4f}]")
            dt = walls[1]
            unit = "lane-flips/s" if hh.precision == "bitplane" \
                else "flips/s"
            self.dist_rates[label] = (n * R * MAIN_SWEEPS / dt, dt, rec.flips)
            print(f"  {label}: {MAIN_SWEEPS} sweeps of {n} p-bits x R={R} in "
                  f"{dt:.4f} s = {n * R * MAIN_SWEEPS / dt:.4e} {unit} "
                  f"(first run {walls[0]:.4f} s; {rec.flips} accepted "
                  f"flips; payload {hh.eng.boundary_payload()['bytes']} B "
                  f"per partition and exchange) on {card}", flush=True)
        self.dist_eta(card)
        self.profile_dist(card)
        self.time_gather_count(card)

    def dist_engine(self, kw, device=None):
        """(handle, sync_every) of a DIST_RUNS configuration on the K=8
        brick partition, on the card or on ``device``."""
        from repro_torch import make_engine
        kw = dict(kw)
        sync = kw.pop("sync")
        return make_engine("dsim_dist", self.prob, rng="lfsr", device=device,
                           **kw), sync

    def dist_start(self, hh, m0):
        """hh's init_state(SEED) with every replica's (lane's) spins taken
        from m0 and the ghosts they give, built on the host and brought in
        through interop (the engines take no m0, as the reference's)."""
        t = self.torch
        from repro_torch.core.bits import u32_to_numpy
        from repro_torch.core.packing import pack_lanes
        from repro_torch.interop import state_from_numpy, state_to_numpy
        p, R = hh.eng.p, hh.replicas
        d = state_to_numpy(hh.init_state(seed=SEED))
        gid = p.global_ids.cpu().numpy()
        m = np.where(gid < p.n, m0[np.minimum(gid, p.n - 1)], 1) \
            .astype(np.int8)                                  # (K, n_max)
        lanes = np.repeat(m[:, None], R, axis=1)              # (K, R, n_max)
        if hh.precision == "bitplane":
            lanes = u32_to_numpy(pack_lanes(t.from_numpy(
                lanes.transpose(1, 0, 2).copy()))).transpose(1, 0, 2)
        lead = lanes.shape[1]
        pool = lanes.transpose(1, 0, 2).reshape(lead, -1)
        ghosts = pool[:, p.ghost_src.cpu().numpy()].transpose(1, 0, 2)
        d.update(m=np.ascontiguousarray(lanes),
                 ghosts=np.ascontiguousarray(ghosts))
        return hh.eng.shard_state(state_from_numpy(**d, device=self.dev))

    def dist_kernel(self):
        """The gather-count kernel against its plain version on the card,
        bitwise: on the bit-plane run's L=100 operands (each colour, from
        its initial state), and at D in GATHER_DEGREES on random rows of
        the same K, W, nc and word pool."""
        t = self.torch
        from repro_torch.core.bits import u32_from_numpy
        from repro_torch.kernels import ref
        from repro_torch.kernels.bitplane_gather import bitplane_gather_count
        hh, _ = self.dist_engine(DIST_RUNS[DIST_PROFILED])
        st = hh.init_state(seed=SEED)
        mext = t.cat([st.m.view(t.int32), st.ghosts.view(t.int32)],
                     dim=2).view(t.uint32)
        K, W, n_ext = (int(d) for d in mext.shape)
        cases = [(f"colour {c}", (mext, col.idx, col.signs, col.nz))
                 for c, col in enumerate(hh.eng._colors)]
        nc = int(cases[0][1][1].shape[1])
        rng = np.random.default_rng(7)
        ones = np.uint32(0xFFFFFFFF)
        for D in GATHER_DEGREES:
            planes = [u32_from_numpy(np.where(
                rng.random((K, nc, D)) < q, ones, 0).astype(np.uint32),
                self.dev) for q in (0.5, 0.8)]
            idx = t.from_numpy(rng.integers(0, n_ext, (K, nc, D),
                                            dtype=np.int32)).to(self.dev)
            cases.append((f"random rows, D={D}", (mext, idx, *planes)))
        errs = []
        for what, args in cases:
            got = bitplane_gather_count(*args)
            want = ref.bitplane_gather_count_ref(*args)
            t.cuda.synchronize()
            errs += [self.max_abs(a, b) for a, b in zip(got, want)]
            D = int(args[1].shape[2])
            check(len(got) == len(want) == D.bit_length() and
                  all(self.same(a, b) for a, b in zip(got, want)),
                  f"bitplane_gather_count at L={L}, {what}: K={K}, W={W}, "
                  f"nc={nc}, n_ext={n_ext}, D={D}: its {len(got)} planes "
                  f"== the plain version's, bitwise")
        self.results["bitplane_gather_count"] = {"max_abs_err": max(errs)}
        self.gather_inputs = cases[0][1]

    def dist_golden(self):
        """The JAX reference's L=100 dist runs from graph_m0: int8 R=2 and
        bit-plane R=32 lanes 0-1 reproduce DSIM_GOLDEN (int8 with its
        spin and LFSR digests in the stacked engine's (R, K, n_max)
        layout), f32 R=2 (bitpack) DIST_GOLDEN (LFSR digest exactly,
        energies and flips within 0.5%)."""
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.bits import u32_to_numpy
        sha = lambda a: hashlib.sha256(a.tobytes()).hexdigest()  # noqa: E731
        m0 = graph_m0(L ** 3)
        for label, kw in (("int8 R=2", dict(precision="int8", replicas=2)),
                          ("bitplane R=32", dict(precision="bitplane",
                                                 replicas=32)),
                          ("f32 R=2", dict(replicas=2))):
            hh, _ = self.dist_engine(dict(kw, sync=SYNC))
            st, rec = hh.run_recorded(self.dist_start(hh, m0),
                                      ea_schedule(16), [8, 16],
                                      sync_every=SYNC)
            e = rec.energies[:, :2].cpu().numpy()
            fl = st.flips[:2].cpu().numpy()
            what = f"dsim_dist {label} K={hh.eng.p.K}"
            if label.startswith("f32"):
                s_sha = sha(u32_to_numpy(st.rng))
                check(s_sha == DIST_GOLDEN["s_sha256"],
                      f"{what} golden sha256(LFSR) {s_sha[:16]}")
                e_rel = float(np.max(np.abs(
                    e / np.array(DIST_GOLDEN["energies"]) - 1)))
                f_rel = float(np.max(np.abs(
                    fl / np.array(DIST_GOLDEN["flips"]) - 1)))
                check(e_rel < 0.005 and f_rel < 0.005,
                      f"{what} energies {e.tolist()} and flips "
                      f"{fl.tolist()} within 0.5% of JAX (max relative "
                      f"differences {e_rel:.3e}, {f_rel:.3e})")
                continue
            check(e.tolist() == DSIM_GOLDEN["energies"] and
                  fl.tolist() == DSIM_GOLDEN["flips"],
                  f"{what} golden energies {e.tolist()} and flips "
                  f"{fl.tolist()} (lanes 0-1)")
            if label.startswith("int8"):
                m_sha = sha(np.ascontiguousarray(
                    st.m.cpu().numpy().transpose(1, 0, 2)))
                s_sha = sha(np.ascontiguousarray(
                    u32_to_numpy(st.rng).transpose(1, 0, 2)))
                check(m_sha == DSIM_GOLDEN["m_sha256"] and
                      s_sha == DSIM_GOLDEN["s_sha256"],
                      f"{what} golden sha256(m) {m_sha[:16]}, "
                      f"sha256(LFSR) {s_sha[:16]}")

    def dist_vs_cpu(self, label: str, kw):
        """The first 16 sweeps of a DIST_RUNS configuration on the card
        against its device="cpu" twin: int8 and bit-plane bitwise; f32
        with every colour phase held to the twin's (hold_phases)."""
        hg, sync = self.dist_engine(kw)
        hc, _ = self.dist_engine(kw, device="cpu")
        held = None
        if hg.precision == "f32":
            held = self.hold_phases(hg.eng, hc.eng)
        try:
            got = self.first16(hg, sync)
        finally:
            if held is not None:
                del hg.eng._phase
        want = self.first16(hc, sync)
        (a, ea, fa), (b, eb, fb) = got, want
        same = all(self.same(getattr(a, f).cpu(), getattr(b, f)) for f in (
            "m", "ghosts", "macc", "rng", "sweep", "flips")) and \
            self.same(ea.cpu(), eb) and bool((fa == fb).all())
        what = "bitwise" if held is None else (
            f"bitwise, each of its {held['phases']} phases held to the CPU's "
            f"({held['differ']} decisions differed, all within {TANH_ULPS} "
            f"ulp of the boundary)")
        check(same, f"{label}: 16 sweeps on the card == device='cpu', "
              f"{what} (spins, ghosts, LFSR, flips, energies; E[0]="
              f"{float(ea[0, 0])})")

    def dist_eta(self, card: str):
        """The exchange alone (boundary_exchange_fn, CUDA events) and
        dist_eta_meter's measured eta of DIST_ETA_RUN at sync_every 1 and
        SYNC."""
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.obs.timing import dist_eta_meter
        hh, _ = self.dist_engine(DIST_RUNS[DIST_ETA_RUN])
        st = hh.init_state(seed=SEED)
        fn = hh.eng.boundary_exchange_fn()
        ms = self.time_ms(lambda: fn(st), reps=200, warm=5)
        pay = hh.eng.boundary_payload()
        print(f"  dist exchange ({DIST_ETA_RUN}): {ms * 1e3:.1f} us per call "
              f"(CUDA events; {pay['bytes']} B of {pay['dtype']} payload per "
              f"partition); an in-process gather on one card, not a network "
              f"link; on {card}", flush=True)
        for sync in (1, SYNC):
            hh.run_recorded(st, ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                            sync_every=sync)                    # warm
            cur = hh.start_recorded(st, ea_schedule(MAIN_SWEEPS),
                                    MAIN_POINTS, sync_every=sync)
            meter = dist_eta_meter(hh.eng, sync_every=sync).attach(cur)
            while not cur.done:
                cur.advance(1)
            meter.measure_exchange(lambda: fn(cur.state), reps=100,
                                   warmup=5)
            r = meter.report()
            check(all(np.isfinite(r[k]) and r[k] > 0 for k in (
                "measured_eta", "eta_threshold", "f_comm_hz", "f_pbit_hz")),
                f"dist eta at sync_every={sync}: finite")
            print(f"  dist eta {DIST_ETA_RUN}, sync_every={sync}: measured "
                  f"eta {r['measured_eta']:.4e} against the threshold "
                  f"{r['eta_threshold']:.4e} (n_color {r['n_color']}, C_max "
                  f"{r['c_max']:.0f}; margin {r['margin']:.4e}), f_comm "
                  f"{r['f_comm_hz']:.4e} Hz (exchange "
                  f"{r['t_exchange_s'] * 1e6:.1f} us), f_pbit "
                  f"{r['f_pbit_hz']:.4e} Hz (sweep "
                  f"{r['t_pbit_sweep_s'] * 1e6:.1f} us), "
                  f"{r['chunks_recorded']} chunks; the exchange is an "
                  f"in-process gather on one card; on {card}", flush=True)

    def profile_dist(self, card: str):
        """One profiled run of DIST_PROFILED: the device's busy share of
        the wall time and the gather-count kernel's launches, time per
        launch and share of the device time."""
        t = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.annealing import ea_schedule
        hh, sync = self.dist_engine(DIST_RUNS[DIST_PROFILED])
        st0 = hh.init_state(seed=SEED)
        t.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hh.run_recorded(st0, ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                            sync_every=sync)
            t.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if not rows:
            print(f"  profile {DIST_PROFILED}: the profiler saw no device "
                  f"time; device busy share not measured", flush=True)
            return
        busy = sum(us for _, _, us in rows) / 1e6
        hits = [(c, us) for key, c, us in rows
                if "bitplane_gather_count" in key]
        count, us = sum(c for c, _ in hits), sum(u for _, u in hits)
        phases = MAIN_SWEEPS * self.col.n_colors
        print(f"  profile {DIST_PROFILED}: wall {wall:.4f} s under the "
              f"profiler, device busy {busy:.4f} s ({100 * busy / wall:.1f}"
              f"%), device time per colour phase "
              f"{busy / phases * 1e3:.4f} ms; gather-count kernel {count} "
              f"launches, {us / max(count, 1):.1f} us per launch, "
              f"{100 * us / 1e6 / busy:.1f}% of the device time; on {card}",
              flush=True)
        for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
            print(f"    {us / 1e3:10.3f} ms  {count:6d} x  {key[:90]}",
                  flush=True)

    def time_gather_count(self, card: str):
        """The gather-count wrapper against its plain version at one
        colour of the bit-plane run; bound: every input read once (the
        rows' D indices, signs and nonzero masks, and of the word pool
        only the words the rows reach with a nonzero mask: the distinct
        slots per partition), every output plane written once, and per
        (partition, word, site) the XOR and AND of each neighbour plus 2
        ops per slice it ripples through."""
        from repro_torch.kernels import ref
        from repro_torch.kernels.bitplane_gather import bitplane_gather_count
        args = self.gather_inputs
        K, W, n_ext = (int(d) for d in args[0].shape)
        nc, D = int(args[1].shape[1]), int(args[1].shape[2])
        byts, int_ops, reached = self.gather_work(args)
        self._timed("bitplane_gather_count", "src/repro_torch/kernels/csrc/"
                    "bitplane_gather.cu", "src/repro/kernels/ops.py:120",
                    lambda: bitplane_gather_count(*args),
                    lambda: ref.bitplane_gather_count_ref(*args), byts,
                    int_ops, 0,
                    f"one colour, K={K}, W={W}, nc={nc}, D={D}, {reached} of "
                    f"{K * n_ext} pool slots reached, 1 launch")
        r = self.results["bitplane_gather_count"]
        print(f"  bitplane_gather_count: {r['ms']:.4f} ms ({r['work']}), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']} ({r['bounds']}); {r['launches']} "
              f"launches on the bit-plane dist run; on {card}", flush=True)
        del r["work"], r["bounds"]

    def gather_work(self, args):
        """(bytes, INT32 operations, pool slots reached) of one
        gather-count call on ``args``, as ``time_gather_count`` bounds
        it."""
        mext, idx, nz = args[0], args[1], args[3]
        K, W = int(mext.shape[0]), int(mext.shape[1])
        nc, D = int(idx.shape[1]), int(idx.shape[2])
        live = nz.view(self.torch.int32) != 0
        reached = sum(int(self.torch.unique(idx[k][live[k]]).numel())
                      for k in range(K))
        byts = 4 * W * reached + 3 * 4 * K * nc * D \
            + 4 * D.bit_length() * K * W * nc
        ops = sum(2 + 2 * (n - 1).bit_length() for n in range(1, D + 1))
        return byts, K * W * nc * ops, reached

    # -- phase 8: the degraded mesh and the sampling server ---------------

    def deg_run(self, hh, codes, st0=None):
        """A degraded run of DEG_SWEEPS chunk by chunk with ``codes``
        armed: (state in the reference's shapes, record, report, raised,
        sweeps done)."""
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.degrade import StateCorruption
        hh.eng.set_exchange_faults(codes)
        cur = hh.start_recorded(hh.init_state(seed=SEED) if st0 is None
                                else st0, ea_schedule(DEG_SWEEPS),
                                DEG_POINTS, sync_every=DEG_SYNC)
        raised = False
        while not cur.done:
            try:
                cur.advance(1)
            except StateCorruption:
                raised = True
                break
        health = hh.eng.health
        return (hh.eng.global_state(cur.state), cur.record(),
                None if health is None else health.report(), raised,
                cur.sweeps_done, cur.state)

    def same_state(self, a, b, fields) -> bool:
        return all(self.same(getattr(a, f), getattr(b, f))
                   for f in fields) and \
            all(self.same(x, y) for x, y in zip(getattr(a, "halos", ()),
                                                getattr(b, "halos", ())))

    def phase_degraded(self, card: str):
        """(a) the lattice mesh and (b) dsim_dist with a degrade policy at
        L=100: without faults bitwise the unchecked run, with DEG_CODES
        equal to the plain run (impl="ref" on the card, or the CPU twin)
        with the same codes and the report the codes predict, freeze,
        resync and fail_fast; the checked exchange timed against the
        unchecked one; eta and effective_eta under injected drops."""
        print(f"== 8. degraded mesh at L={L}: checked exchange, stale hold, "
              f"freeze, resync", flush=True)
        lat_fields = ("m", "s", "sweep", "flips")
        bad = [i for i, c in enumerate(DEG_CODES) if c]
        want = dict(detections=len(bad), stale_exchanges=len(bad),
                    exchanges_total=len(DEG_CODES), max_staleness_seen=2,
                    delivered_fraction=1 - len(bad) / len(DEG_CODES))
        for label, kw in MESH_RUNS.items():
            f32 = "precision" not in kw
            clean = self.deg_run(self.engine(kw), None)
            hd = self.engine(dict(kw, degrade=DEG_POLICY))
            chk = self.deg_run(hd, None)
            check(self.same_state(clean[0], chk[0], lat_fields) and
                  self.same(clean[1].energies, chk[1].energies) and
                  clean[1].flips == chk[1].flips and
                  chk[2]["detections"] == 0,
                  f"{label} {DEG_POLICY}, no faults: bitwise the unchecked "
                  f"run over {DEG_SWEEPS} sweeps ({chk[2]['exchanges_total']}"
                  f" exchanges, 0 detections)")
            got = self.deg_run(hd, DEG_CODES)
            ref = self.deg_run(self.engine(dict(kw, degrade=DEG_POLICY,
                                                impl="ref")), DEG_CODES)
            rep = got[2]
            check(rep == ref[2] and all(rep[k] == v for k, v in
                                        want.items()),
                  f"{label} codes {DEG_CODES}: report == impl='ref' and "
                  f"the codes' ({ {k: rep[k] for k in want} })")
            if f32:
                rel = float(((got[1].energies - ref[1].energies).abs()
                             / ref[1].energies.abs()).max())
                check(self.same(got[0].s, ref[0].s) and rel < 0.005,
                      f"{label} codes: LFSR states == impl='ref' bitwise, "
                      f"energies within 0.5% (largest {rel:.3e}; "
                      f"{int((got[0].m != ref[0].m).sum())} spins differ)")
            else:
                check(self.same_state(got[0], ref[0], lat_fields) and
                      self.same(got[1].energies, ref[1].energies) and
                      got[1].flips == ref[1].flips,
                      f"{label} codes: == impl='ref' bitwise (spins, LFSR, "
                      f"halos, flips, energies)")
        # MESH_GOLDEN through the checked exchange
        from repro_torch.core.annealing import ea_schedule
        hg = self.engine(dict(precision="int8", replicas=2, mesh=(2, 2, 2),
                              degrade=DEG_POLICY))
        st, rec = hg.run_recorded(hg.init_state(seed=SEED), ea_schedule(16),
                                  [8, 16], sync_every=SYNC)
        g = hg.eng.global_state(st)
        check(rec.energies.cpu().numpy().tolist() == MESH_GOLDEN["energies"]
              and st.flips.cpu().numpy().tolist() == MESH_GOLDEN["flips"]
              and hashlib.sha256(g.m.cpu().numpy().tobytes()).hexdigest()
              == MESH_GOLDEN["m_sha256"],
              f"mesh (2,2,2) int8 R=2 {DEG_POLICY}: MESH_GOLDEN energies, "
              f"flips and sha256(m)")
        # freeze, resync, fail_fast on int8 R=4 (2,2,2)
        kw = MESH_RUNS[ETA_RUN]
        freeze = [0, 0, 2]
        hf = self.engine(dict(kw, degrade="freeze_boundary"))
        got = self.deg_run(hf, freeze)
        ref = self.deg_run(self.engine(dict(kw, degrade="freeze_boundary",
                                            impl="ref")), freeze)
        rep = got[2]
        check(self.same_state(got[0], ref[0], lat_fields) and
              rep == ref[2] and rep["detections"] == 1 and
              rep["stale_exchanges"] == 6 and rep["staleness"] == [6] * 6
              and rep["suspect"],
              f"{ETA_RUN} freeze_boundary codes {freeze}: == impl='ref' "
              f"bitwise; 1 detection, every face held from exchange 2 on "
              f"({rep['stale_exchanges']} held, staleness "
              f"{rep['staleness']})")
        st2 = hf.eng.resync(got[5])
        fresh = hf.eng._refresh_halos(got[5])
        check(all(self.same(x, y) for x, y in zip(st2.halos, fresh.halos))
              and not hf.eng.health.suspect and
              hf.eng.health.report()["staleness"] == [0] * 6,
              "resync: every halo == a fresh exchange of the current "
              "spins, staleness cleared")
        ff = [0, 0, 0, 0, 0, 2, 0, 0]
        got = self.deg_run(self.engine(dict(kw, degrade="fail_fast")), ff)
        check(got[3] and got[4] == 16 and got[2]["detections"] == 1,
              f"{ETA_RUN} fail_fast codes {ff}: StateCorruption at the "
              f"chunk of exchange 5 (stopped at sweep {got[4]})")
        self.deg_lattice_exchange(card)
        self.deg_dist(card)

    def time_exchange(self, label, unchecked, checked, corrupt, card):
        """µs per call of an exchange, unchecked, checked without faults
        and checked with a corrupt code (CUDA events)."""
        us = [self.time_ms(fn, reps=200, warm=5) * 1e3
              for fn in (unchecked, checked, corrupt)]
        print(f"  {label}: exchange {us[0]:.1f} us per call unchecked, "
              f"{us[1]:.1f} us checked ({us[1] / us[0]:.2f}x), {us[2]:.1f} "
              f"us checked with a corrupt code (CUDA events); an in-process "
              f"gather on one card; on {card}", flush=True)
        self.deg_exchange_us[label] = us

    def deg_lattice_exchange(self, card: str):
        t = self.torch
        from repro_torch.core.degrade import carry_to_device, health_init
        self.deg_exchange_us = {}
        hh = self.engine(dict(MESH_RUNS[ETA_RUN], degrade=DEG_POLICY))
        eng = hh.eng
        st = hh.init_state(seed=SEED)
        m = eng._bricks_of(st.m)
        ex = eng._exchanger(int(m.shape[1]), m.dtype)
        buf = ex.buffer(st.halos)
        hc = carry_to_device(health_init(6), len(eng.coords), self.dev)
        codes = t.tensor([2], dtype=t.int64, device=self.dev)
        self.time_exchange(f"lattice {ETA_RUN}", lambda: ex(m),
                           lambda: ex.checked(m, buf, hc, None, False),
                           lambda: ex.checked(m, buf, hc, codes, False),
                           card)
        self.deg_eta(f"lattice {ETA_RUN}", hh, n_color=eng.p.n_colors,
                     exchange=lambda s: ex.checked(
                         eng._bricks_of(s.m), buf, hc, None, False),
                     card=card)

    def deg_eta(self, label, hh, exchange, card, n_color=None):
        """Measured eta and effective_eta at sync_every 1 and SYNC under
        DEG_POLICY with every eighth exchange dropped: the checked
        exchange timed alone, the held exchanges fed to the meter from
        the health report."""
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.obs.timing import EtaMeter, dist_eta_meter
        for sync in (1, SYNC):
            n_ex = MAIN_SWEEPS // sync
            codes = [1 if i % 8 == 3 else 0 for i in range(n_ex)]
            hh.eng.set_exchange_faults(codes)
            st = hh.init_state(seed=SEED)
            hh.run_recorded(st, ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                            sync_every=sync)                    # warm
            cur = hh.start_recorded(st, ea_schedule(MAIN_SWEEPS),
                                    MAIN_POINTS, sync_every=sync)
            meter = (EtaMeter(n_color=n_color, sync_every=sync)
                     if n_color is not None else
                     dist_eta_meter(hh.eng, sync_every=sync)).attach(cur)
            while not cur.done:
                cur.advance(1)
            meter.measure_exchange(lambda: exchange(cur.state), reps=100,
                                   warmup=5)
            rep = hh.eng.health.report()
            meter.note_stale(rep["stale_exchanges"], rep["exchanges_total"],
                             rep["max_staleness_seen"])
            r = meter.report()
            check(rep["stale_exchanges"] == n_ex // 8 and
                  abs(r["effective_eta"] - r["measured_eta"] * 7 / 8)
                  <= 1e-9 * r["measured_eta"] and
                  np.isfinite(r["effective_eta"]) and r["effective_eta"] > 0,
                  f"{label} sync_every={sync}: {rep['stale_exchanges']} of "
                  f"{n_ex} exchanges held, effective eta = 7/8 of eta")
            print(f"  {label}, {DEG_POLICY}, sync_every={sync}: measured "
                  f"eta {r['measured_eta']:.4e}, effective eta "
                  f"{r['effective_eta']:.4e} (delivered "
                  f"{r['delivered_fraction']:.4f}), checked exchange "
                  f"{r['t_exchange_s'] * 1e6:.1f} us, sweep "
                  f"{r['t_pbit_sweep_s'] * 1e6:.1f} us; on {card}",
                  flush=True)
        hh.eng.set_exchange_faults(None)

    def deg_dist(self, card: str):
        t = self.torch
        from repro_torch import make_engine
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.degrade import carry_to_device, health_init
        fields = ("m", "ghosts", "macc", "rng", "sweep", "flips")
        for prec, R in (("int8", 4), ("bitplane", 64)):
            label = f"dsim_dist {prec} R={R} K={self.prob.K}"

            def mk(policy, device=None):
                return make_engine("dsim_dist", self.prob if device is None
                                   else self.prob.to(device), rng="lfsr",
                                   precision=prec, replicas=R,
                                   degrade=policy, device=device)
            clean = self.deg_run(mk(None), None)
            hd = mk(DEG_POLICY)
            chk = self.deg_run(hd, None)
            check(self.same_state(clean[0], chk[0], fields) and
                  self.same(clean[1].energies, chk[1].energies) and
                  chk[2]["detections"] == 0,
                  f"{label} {DEG_POLICY}, no faults: bitwise the unchecked "
                  f"run over {DEG_SWEEPS} sweeps")
            # with codes against the CPU twin over the first 8 sweeps
            codes = [0, 2, 1, 0]
            twin = {}
            for dev in (None, "cpu"):
                hh = mk(DEG_POLICY, dev)
                hh.eng.set_exchange_faults(codes)
                st, rec = hh.run_recorded(hh.init_state(seed=SEED),
                                          ea_schedule(8), [8],
                                          sync_every=2)
                twin[dev] = (st, rec, hh.eng.health.report())
            (a, ra, pa), (b, rb, pb) = twin[None], twin["cpu"]
            def host(x):
                return (x.view(t.int32) if x.dtype == t.uint32 else x).cpu()
            check(all(self.same(host(getattr(a, f)), host(getattr(b, f)))
                      for f in fields) and
                  self.same(ra.energies.cpu(), rb.energies) and
                  pa == pb and pa["detections"] == 2,
                  f"{label} codes {codes}: == device='cpu' bitwise (state, "
                  f"energies) with the same report ({pa['detections']} "
                  f"detections, {pa['stale_exchanges']} held)")
            # freeze and fail_fast on the card
            got = self.deg_run(mk("freeze_boundary"), [0, 0, 2])
            rep = got[2]
            check(rep["detections"] == 1 and rep["stale_exchanges"] == 6 and
                  rep["staleness"] == [6] * self.prob.K and rep["suspect"],
                  f"{label} freeze_boundary: 1 detection, every partition "
                  f"held from exchange 2 on (staleness {rep['staleness']})")
            got = self.deg_run(mk("fail_fast"), [0, 0, 0, 0, 0, 2, 0, 0])
            check(got[3] and got[4] == 16,
                  f"{label} fail_fast: StateCorruption at the chunk of "
                  f"exchange 5 (stopped at sweep {got[4]})")
            # the exchange alone: unchecked, checked, checked and corrupt
            eng = hd.eng
            st = hd.init_state(seed=SEED)
            word = prec == "bitplane"
            x = st.m.view(t.int32) if word else st.m
            gh = st.ghosts.view(t.int32) if word else st.ghosts
            hc = carry_to_device(health_init(self.prob.K), 1, self.dev)
            one = t.tensor([2], dtype=t.int64, device=self.dev)
            self.time_exchange(label, lambda: eng._refresh(x),
                               lambda: eng._exchange_checked(
                                   x, gh, hc, None, False),
                               lambda: eng._exchange_checked(
                                   x, gh, hc, one, False), card)
            if prec == "int8":
                self.deg_eta(label, hd, card=card, exchange=lambda s:
                             eng._exchange_checked(s.m, s.ghosts, hc, None,
                                                   False))

    def server_direct(self, name, kw, sweeps, pts, seeds, hh=None):
        """The server's job run directly through make_engine (or on the
        handle ``hh`` such a call built): the same problem, width, seeds,
        record points and fault codes."""
        from repro_torch import make_engine
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.mesh import make_mesh
        if hh is None:
            extra = {} if name != "mesh" else dict(
                mesh=make_mesh((2, 2, 2), AXES), dim_axes=AXES)
            hh = make_engine("lattice", L=L, seed=SEED,
                             precision=kw.get("precision", "f32"),
                             replicas=len(seeds),
                             degrade=kw.get("degrade_policy"), **extra)
        if name == "mesh":
            hh.eng.set_exchange_faults(
                self.server_plan().exchange_codes(sweeps // SYNC))
        st, rec = hh.run_recorded(hh.init_state_packed(seeds),
                                  ea_schedule(sweeps), pts,
                                  sync_every=SYNC)
        return hh, st, rec

    @staticmethod
    def server_plan():
        from repro_torch.serve import FaultPlan, FaultRule
        return FaultPlan([FaultRule(site="exchange_corrupt", index=1),
                          FaultRule(site="exchange_drop", index=SERVER_DROP)])

    def phase_server(self, card: str):
        """(c) repro_torch.serve.SampleServer on the card at L=100."""
        t = self.torch
        from repro_torch.core.partition import brick_partition
        from repro_torch.engines.base import spawn_seeds
        from repro_torch.kernels import _build
        from repro_torch.core.mesh import make_mesh
        from repro_torch.serve import SampleServer
        print(f"== 8c. sampling server: repro_torch.serve.SampleServer at "
              f"L={L} on the card", flush=True)

        def server():
            srv = SampleServer(fault_plan=self.server_plan(), max_retries=0)
            srv.register_problem("lat", L=L, seed=SEED)
            srv.register_problem("mesh", L=L, seed=SEED,
                                 mesh=make_mesh((2, 2, 2), AXES),
                                 dim_axes=AXES)
            srv.register_problem("graph", graph=self.g, coloring=self.col,
                                 K=int(np.prod(BRICKS)), rng="lfsr",
                                 labels=brick_partition((L, L, L), BRICKS))
            return srv

        def submit(srv, jobs):
            return {label: srv.submit(prob, engine=kw.get(
                "engine", "lattice"), sweeps=MAIN_SWEEPS, sync_every=SYNC,
                **{k: v for k, v in kw.items() if k != "engine"})
                for label, (prob, kw) in jobs.items()}

        srv = server()
        check(srv.device.type == "cuda",
              f"SampleServer() builds its engines on {srv.device}")
        t.cuda.synchronize()
        _build.reset_launch_counts()
        ids = submit(srv, dict(SERVER_JOBS, failing=SERVER_FAILING))
        srv.drain()
        t.cuda.synchronize()
        self.server_launches = dict(_build.launch_counts)
        out = {label: srv.result(j) for label, j in ids.items()}
        for name in ("pbit_brick_sweep_int", "pbit_bitplane_sweep",
                     "pbit_brick_sweep", "brick_energy",
                     "bitplane_gather_count"):
            check(self.server_launches[name] > 0,
                  f"server path launched {name} "
                  f"{self.server_launches[name]} times")
        bad = out.pop("failing")
        check(bad["status"] == "failed" and
              "StateCorruption" in (bad["error"] or "") and
              bad["degrade"]["detections"] == 1,
              f"dsim_dist bitplane R=64 K=8 fail_fast with a corrupt "
              f"exchange: failed, {bad['error'][:60]!r}")
        first = list(SERVER_JOBS)[:2]
        check(all(out[k]["packed_with"] == 1 for k in first) and
              all(out[k]["packed_with"] == 0 for k in list(SERVER_JOBS)[2:]),
              f"{first} packed into one call, the others solo")
        pts = sorted(set(range(MAIN_SWEEPS // 8, MAIN_SWEEPS + 1,
                               MAIN_SWEEPS // 8)))
        # every job == a direct make_engine run of its seeds
        seeds = {k: spawn_seeds(kw["seed"], kw["replicas"])
                 for k, (_, kw) in SERVER_JOBS.items()}
        packed = seeds[first[0]] + seeds[first[1]]
        for label, (name, kw) in SERVER_JOBS.items():
            r = out[label]
            sd = packed if label in first else seeds[label]
            hh, st, rec = self.server_direct(name, kw, MAIN_SWEEPS, pts, sd)
            lo = 0 if label != first[1] else kw["replicas"]
            e = rec.energies.cpu().numpy()[:, lo:lo + kw["replicas"]]
            if "precision" not in kw:
                rel = float(np.max(np.abs(r["energies"] / e - 1)))
                check(r["status"] == "done" and rel < 0.005,
                      f"server {label}: energies within 0.5% of the direct "
                      f"run (largest {rel:.3e}; bitwise: "
                      f"{bool(np.array_equal(r['energies'], e))})")
            else:
                check(r["status"] == "done" and
                      np.array_equal(r["energies"], e),
                      f"server {label}: energies == the direct run's "
                      f"bitwise (E[-1] {r['energies'][-1].tolist()})")
            if float(e[-1].min()) < float(e[:-1].min()):
                # the best first reached at the last point: the final spins
                best = int(np.argmin(e[-1]))
                spins = hh.global_spins(st).cpu().numpy()[lo + best]
                check(r["best_replica"] == best and
                      r["best_energy"] == float(e[-1, best]) and
                      np.array_equal(r["best_spins"], spins),
                      f"server {label}: best replica, energy and spins == "
                      f"the direct run's final ones")
            if name == "mesh":
                rep = hh.eng.health.report()
                check(r["degrade"] == rep and rep["detections"] == 2 and
                      rep["stale_exchanges"] == 2 and
                      rep["max_staleness_seen"] == 1,
                      f"server {label}: degrade report == the direct run's "
                      f"(a corruption and a drop detected and held, "
                      f"delivered {rep['delivered_fraction']:.4f})")
        # the packed job equals its solo run
        solo = server()
        sid = solo.submit("lat", engine="lattice", sweeps=MAIN_SWEEPS,
                          sync_every=SYNC, **SERVER_JOBS[first[1]][1])
        rs = solo.drain().result(sid)
        check(rs["packed_with"] == 0 and
              np.array_equal(rs["energies"], out[first[1]]["energies"]) and
              rs["flips"] == out[first[1]]["flips"] and
              np.array_equal(rs["best_spins"], out[first[1]]["best_spins"]),
              f"packed job {first[1]!r} == its solo run bitwise (energies, "
              f"flips, best spins)")
        # throughput: the jobs again on the warm server, then directly
        walls, flips = [], 0
        for _ in range(2):
            t.cuda.synchronize()
            t0 = time.perf_counter()
            ids = submit(srv, SERVER_JOBS)
            srv.drain()
            t.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res = [srv.result(j) for j in ids.values()]
        check(all(r["status"] == "done" and r["pool_hit"] for r in res),
              "warm rounds: every job done from a pooled engine")
        flips = sum(r["flips"] for r in res)
        dt = walls[1]
        updates = sum(L ** 3 * kw["replicas"] * MAIN_SWEEPS
                      for _, kw in SERVER_JOBS.values())
        # the direct baseline: each job on its own engine, built and run
        # once before the timed pass (as the server's pooled engines)
        handles = {}
        for label, (name, kw) in SERVER_JOBS.items():
            handles[label] = self.server_direct(name, kw, MAIN_SWEEPS, pts,
                                             seeds[label])[0]
        t.cuda.synchronize()
        t0 = time.perf_counter()
        for label, (name, kw) in SERVER_JOBS.items():
            self.server_direct(name, kw, MAIN_SWEEPS, pts, seeds[label],
                               hh=handles[label])
        t.cuda.synchronize()
        dd = time.perf_counter() - t0
        # the part of each job that is host work: its initial state (spins
        # and LFSR columns drawn per replica with numpy, then copied in)
        t0 = time.perf_counter()
        for label, (_, kw) in SERVER_JOBS.items():
            handles[label].init_state_packed(seeds[label])
        t.cuda.synchronize()
        di = time.perf_counter() - t0
        n = len(SERVER_JOBS)
        print(f"  server: {n} jobs in {dt:.4f} s (first warm round "
              f"{walls[0]:.4f} s) = {n / dt:.4f} jobs/s, "
              f"{updates / dt:.4e} flips/s ({flips} accepted flips); "
              f"the same jobs run one by one on warm make_engine handles "
              f"{dd:.4f} s = {n / dd:.4f} jobs/s, {updates / dd:.4e} "
              f"flips/s; their initial states alone {di:.4f} s; on {card}",
              flush=True)

    # -- phase 9: APT+ICM on the G81 shape ----------------------------------

    def apt(self, mode, device=None, draws=None):
        from repro_torch.core.apt_icm import APTICM
        return APTICM(self.g81_ising, self.col81, apt_betas(),
                      chains=APT_CHAINS, device=device, draws=draws,
                      **APT_MODES[mode])

    @staticmethod
    def apt_digest(apt, st, ts, best) -> dict:
        """The APT_GOLDEN fields of a run (spins unpacked, LFSR states in
        the reference's byte order in either mode)."""
        from repro_torch.core.bits import u32_to_numpy
        sha = lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()  # noqa: E731
        return dict(m_sha256=sha(apt.spins(st).cpu().numpy()),
                    E_sha256=sha(st.E.cpu().numpy()),
                    lfsr_sha256=sha(u32_to_numpy(st.lfsr)),
                    swaps=int(st.swaps), icms=int(st.icms),
                    sweeps=np.asarray(ts).tolist(),
                    best=np.asarray(best).tolist())

    def phase_apt(self, card: str):
        """APT+ICM (repro_torch.core.apt_icm) on the G81 shape at full
        width: APT_GOLDEN and the device="cpu" twin with HostDraws, the
        gather-count kernel against its plain version at the packed
        shape, the three modes timed over APT_SWEEPS sweeps with the
        launches counted, packed == lfsr with the card's generator, the
        ICM's share of the time and its host syncs, one profiled packed
        run and one adapt_ladder call."""
        t = self.torch
        from repro_torch.core.apt_icm import HostDraws, adapt_ladder
        from repro_torch.core.energy import energy
        from repro_torch.kernels import _build
        from repro_torch.problems.maxcut import cut_of
        g, col = self.g81_ising, self.col81
        N, P, T = g.n, APT_CHAINS, APT_T
        print(f"== 9. APT+ICM on the G81 shape: N={N}, P={P} chains x T={T} "
              f"temperatures, {col.n_colors} colours", flush=True)
        for mode in ("lfsr", "packed"):
            got = {}
            for dev in (None, "cpu"):
                apt = self.apt(mode, dev, HostDraws(APT_DRAW_SEED))
                t0 = time.perf_counter()
                st, (ts, best) = apt.run(
                    apt.init_state(seed=SEED), APT_GOLDEN_SWEEPS,
                    icm_every=APT_GOLDEN_ICM, record_every=APT_GOLDEN_ICM)
                if dev is None:
                    t.cuda.synchronize()
                    check(apt.device.type == "cuda" and
                          st.m.device.type == "cuda",
                          f"APT {mode} runs on {apt.device}")
                got[dev] = (self.apt_digest(apt, st, ts, best),
                            time.perf_counter() - t0)
            check(got[None][0] == APT_GOLDEN,
                  f"APT {mode} on the card with HostDraws({APT_DRAW_SEED}) "
                  f"reproduces APT_GOLDEN: spins, energies and LFSR digests, "
                  f"{APT_GOLDEN['swaps']} swaps, {APT_GOLDEN['icms']} ICMs, "
                  f"best-energy trace {APT_GOLDEN['best']}")
            check(got["cpu"][0] == got[None][0],
                  f"APT {mode}: card == device='cpu' twin bitwise over "
                  f"{APT_GOLDEN_SWEEPS} sweeps ({got[None][1]:.2f} s on the "
                  f"card, {got['cpu'][1]:.2f} s on the CPU)")
        self.apt_kernel(card)
        runs = {}
        for mode in APT_MODES:
            runs[mode] = self.apt_main(mode, card)
        (lu, lst, lb), (pk, pst, pb) = runs["lfsr"][:3], runs["packed"][:3]
        check(t.equal(lu.spins(lst), pk.spins(pst)) and t.equal(lst.E, pst.E)
              and self.same(lst.lfsr.reshape(-1), pst.lfsr.reshape(-1))
              and int(lst.swaps) == int(pst.swaps) and
              int(lst.icms) == int(pst.icms) and t.equal(lst.key, pst.key)
              and np.array_equal(lb, pb),
              f"packed == lfsr bitwise over {APT_SWEEPS} sweeps with the "
              f"card's generator (spins, energies, LFSR, {int(pst.swaps)} "
              f"swaps, {int(pst.icms)} ICMs, generator state, trace)")
        w_tot = float(self.g81.w.sum()) / 2
        for mode, (apt, st, best, wall, launches) in runs.items():
            spins, e_best = apt.best_config(st)
            cut = cut_of(self.g81, spins)
            E = st.E
            check(tuple(E.shape) == (P, T) and bool(t.isfinite(E).all()) and
                  t.equal(E, energy(g, apt.spins(st))) and
                  cut == (w_tot - e_best) / 2 and best[-1] <= best[0],
                  f"APT {mode}: energies finite (P, T), tracked == direct, "
                  f"best cut {cut:.0f} == (W - E_best) / 2, best energy "
                  f"{best[0]:.0f} -> {best[-1]:.0f}")
            rate = N * P * T * APT_SWEEPS / wall
            print(f"  APT {mode}: {APT_SWEEPS} sweeps of {N} p-bits x "
                  f"{P * T} replicas in {wall:.4f} s = "
                  f"{APT_SWEEPS / wall:.2f} sweeps/s, {rate:.4e} p-bit "
                  f"updates/s; best cut {cut:.0f}; on {card}", flush=True)
        self.apt_shares(card)
        self.profile_apt(card)
        t.cuda.synchronize()
        t0 = time.perf_counter()
        ladder = adapt_ladder(g, col, 1.0, 6.0, T)
        t.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(len(ladder) == T and bool((np.diff(ladder) > 0).all()) and
              abs(ladder[0] - 1.0) < 1e-9 and abs(ladder[-1] - 6.0) < 1e-9,
              f"adapt_ladder(G81, 1.0, 6.0, {T}) on the card: increasing "
              f"from 1.0 to 6.0, in {dt:.3f} s on {card}")

    def apt_main(self, mode, card):
        """One warm short run, then APT_SWEEPS sweeps timed with the launch
        counters at 0 just before; returns (engine, state, best trace,
        wall seconds, launches)."""
        t = self.torch
        from repro_torch.kernels import _build
        apt = self.apt(mode)
        st0 = apt.init_state(seed=SEED)
        apt.run(st0, 2, icm_every=1, record_every=2)
        t.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        st, (_, best) = apt.run(st0, APT_SWEEPS, icm_every=APT_ICM_EVERY,
                                record_every=APT_ICM_EVERY)
        t.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _build.launch_counts.items() if v}
        gathers = counts.pop("bitplane_gather_count", 0)
        phases = APT_SWEEPS * self.col81.n_colors
        if mode == "packed":
            self.apt_launches = gathers
            check(gathers == phases and not counts,
                  f"APT packed: the gather-count kernel launched {gathers} "
                  f"times, once per colour phase ({phases}); no other "
                  f"kernel ({counts})")
        else:
            check(gathers == 0 and not counts,
                  f"APT {mode}: plain PyTorch operations, no kernel "
                  f"launched ({counts})")
        return apt, st, best, wall, gathers

    def apt_kernel(self, card):
        """The gather-count kernel against its plain version at the packed
        APT shape (K=1, W=4, every colour), bitwise, and timed."""
        t = self.torch
        from repro_torch.core.bits import u32_to_i64
        from repro_torch.kernels import ref
        from repro_torch.kernels.bitplane_gather import bitplane_gather_count
        apt = self.apt("packed")
        st = apt.init_state(seed=SEED)
        errs = []
        for c in range(self.col81.n_colors):
            args = (st.m[None], apt._idx32[c], apt._signs[c], apt._nz[c])
            got = bitplane_gather_count(*args)
            want = ref.bitplane_gather_count_ref(*args)
            t.cuda.synchronize()
            errs += [self.max_abs(a, b) for a, b in zip(got, want)]
            K, nc, D = (int(d) for d in args[1].shape)
            check(len(got) == len(want) and
                  all(self.same(a, b) for a, b in zip(got, want)),
                  f"bitplane_gather_count at the APT shape, colour {c}: "
                  f"K={K}, W={apt.words}, nc={nc}, n_ext={apt.n}, D={D}: "
                  f"== the plain version bitwise")
        r = self.results["bitplane_gather_count"]
        r["max_abs_err"] = max([r["max_abs_err"]] + errs)
        args = (st.m[None], apt._idx32[0], apt._signs[0], apt._nz[0])
        ms = self.time_ms(lambda: bitplane_gather_count(*args), reps=50)
        plain = self.time_ms(lambda: ref.bitplane_gather_count_ref(*args),
                             reps=3, warm=1)
        byts, int_ops, _ = self.gather_work(args)
        bound = self.bound(byts, int_ops, 0)
        # the whole packed sweep, to see what the per-lane tail costs
        lfsr = u32_to_i64(st.lfsr)
        sweep = self.time_ms(lambda: apt._gibbs_sweep_packed(
            st.m, st.E, lfsr.clone()), reps=10)
        n_col = self.col81.n_colors
        print(f"  bitplane_gather_count at the APT shape: {ms:.4f} ms per "
              f"colour (plain {plain:.4f} ms, bound {bound[1]:.4f} ms by "
              f"{bound[0]}: {byts} bytes, {int_ops} INT32 ops); one "
              f"packed sweep "
              f"{sweep:.4f} ms, of which the {n_col} gather-counts "
              f"{100 * n_col * ms / sweep:.1f}% and the per-lane tail the "
              f"rest; on {card}", flush=True)

    def apt_shares(self, card):
        """Per mode, one run with every ICM bracketed by synchronises: the
        ICM's share of the wall time and its host syncs per ICM."""
        t = self.torch
        for mode in APT_MODES:
            apt = self.apt(mode)
            st0 = apt.init_state(seed=SEED)
            spent = [0.0]
            for name in ("_icm", "_icm_packed"):
                fn = getattr(apt, name)

                def timed(*a, fn=fn):
                    t.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(*a)
                    t.cuda.synchronize()
                    spent[0] += time.perf_counter() - t0
                    return out
                setattr(apt, name, timed)
            t.cuda.synchronize()
            t0 = time.perf_counter()
            apt.run(st0, APT_SWEEPS, icm_every=APT_ICM_EVERY,
                    record_every=APT_ICM_EVERY)
            t.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"  APT {mode}: ICM {spent[0]:.4f} s of {wall:.4f} s "
                  f"({100 * spent[0] / wall:.1f}%), {apt.icm_calls} ICMs, "
                  f"{apt.icm_syncs / max(apt.icm_calls, 1):.2f} host syncs "
                  f"per ICM; on {card}", flush=True)

    def profile_apt(self, card):
        """One profiled APT_PROFILED run: device busy share and the
        gather-count kernel's share of the device time."""
        t = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        apt = self.apt(APT_PROFILED)
        st0 = apt.init_state(seed=SEED)
        apt.run(st0, 2, icm_every=1, record_every=2)
        t.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            apt.run(st0, APT_SWEEPS, icm_every=APT_ICM_EVERY,
                    record_every=APT_ICM_EVERY)
            t.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if not rows:
            print(f"  profile APT {APT_PROFILED}: the profiler saw no device "
                  f"time; device busy share not measured", flush=True)
            return
        busy = sum(us for _, _, us in rows) / 1e6
        hits = [(c, us) for key, c, us in rows
                if "bitplane_gather_count" in key]
        count, us = sum(c for c, _ in hits), sum(u for _, u in hits)
        print(f"  profile APT {APT_PROFILED}: wall {wall:.4f} s under the "
              f"profiler, device busy {busy:.4f} s "
              f"({100 * busy / wall:.1f}%); gather-count {count} launches, "
              f"{us / max(count, 1):.1f} us each, "
              f"{100 * us / 1e6 / busy:.1f}% of the device time; on {card}",
              flush=True)
        for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
            print(f"    {us / 1e3:10.3f} ms  {count:6d} x  {key[:90]}",
                  flush=True)

    # -- phase 10: the static audit on the card's path ----------------------

    def phase_audit(self, card: str):
        """``repro_torch.analyze``'s IR audit with every one-process chunk
        on the card (the hand kernels launch; their glue is recorded):
        IR-A, IR-D and IR-E hold there as on the CPU.  The gloo rank
        cases (IR-B, IR-C) are CPU processes, audited by the CPU gate."""
        from repro_torch.analyze.configs import build_audits
        from repro_torch.analyze.findings import Waivers
        from repro_torch.analyze.ir_rules import audit_chunk
        from repro_torch.analyze.runner import DEFAULT_WAIVER_FILE
        print("== 10. static audit: python -m repro_torch.analyze ir on the "
              "card's path", flush=True)
        t0 = time.perf_counter()
        audits, failures = build_audits(self.dev, ranks=False)
        waivers = Waivers.load(DEFAULT_WAIVER_FILE)
        found = [f for a in audits for f in audit_chunk(a)]
        bad = [f for f in found if waivers.match(f) is None]
        for f in bad:
            print("  " + f.render(), flush=True)
        syncs = sum(len(a.syncs) for a in audits)
        check(not failures and not bad,
              f"{len(audits)} configurations, one chunk each on "
              f"{self.dev}: no float arithmetic in an integer body, "
              f"{syncs} host syncs as declared, modular counters "
              f"({len(failures)} failed to run, {len(bad)} unwaived "
              f"findings; {time.perf_counter() - t0:.1f} s)")

    def bound(self, byts, int_ops, f32_ops):
        """(what bounds it, bound ms, {bytes, int32, fp32: ms}): the
        largest of the bytes over HBM bandwidth and the INT32 and FP32
        operations over their own peaks."""
        times = {"bytes": byts / HBM_BYTES_PER_S * 1e3,
                 "int32": int_ops / self.int_peak * 1e3,
                 "fp32": f32_ops / self.f32_peak * 1e3}
        by = max(times, key=times.get)
        return by, times[by], times

    def _timed(self, name, source, replaces, kernel, plain, byts, int_ops,
               f32_ops, work):
        """Time a kernel's wrapper and its plain version beside its
        bound (``bound``)."""
        by, _, times = self.bound(byts, int_ops, f32_ops)
        r = self.results[name]
        r.update({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": self.launches[name],
            "ms": self.time_ms(kernel, reps=50),
            "plain_ms": self.time_ms(plain, reps=3, warm=1),
            "bound_ms": times[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "library_ms": None, "work": work,
            "bounds": ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())})
        # key order of the kernels line
        self.results[name] = {k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "work",
            "bounds")}


if __name__ == "__main__":
    sys.exit(main())
