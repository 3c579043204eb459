#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``
(``python3 chip_smoke.py --build-peaks <src>`` prints phase 4's
construction bytes for the package under another tree's ``src``.)

This script checks correctness only: every check compares the port with
its plain version, its CPU twin, a golden value of the JAX reference, a
launch count, a byte count or a record the program wrote.  It times
nothing; the port's speed is measured by the benchmark (``perf_bench/``).

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
   match (f32 to 0.5%, its LFSR digest exactly), bit-plane lane
   (w, b) equals int8 replica w*32+b, and the bit-plane engine's energy
   readout equals the unpack-first readout it replaced bitwise;
4. drive the mesh path: ``make_engine("lattice", L=100, mesh=make_mesh(
   ...), dim_axes=("x", "y", "z"))`` with every brick on the card: each
   MESH_RUNS engine built in a fresh process holding its bricks'
   constants and nothing else of the build (the problem is built on the
   host), its peak and held bytes printed beside the same build's when
   the whole problem lay on the card; the
   JAX reference's (2,2,2) mesh golden values (int8 R=2 bitwise with its
   spin and LFSR digests, bit-plane R=32 lanes 0-1, f32 within 0.5% with
   the LFSR digest), the first 16 sweeps of int8 R=4 on (2,2,2) and
   (2,2,1), bit-plane R=64 and f32 R=4 on (2,2,2) against their
   ``impl="ref"`` runs on the card (bitwise, f32 to 0.5%), their full
   runs with the launches counted per kernel and path (one sweep
   launch per brick and call, one energy launch per brick and record
   point), and ``EtaMeter``'s report of a run at ``sync_every`` 8 finite;
5. drive the general-graph engines, ``make_engine("gibbs", graph)`` and
   ``make_engine("dsim", partitioned)``, on the L=100 instance as an ELL
   graph (and Max-Cut on a G81-size torus): the JAX reference's golden
   values (dsim int8 on the (2,2,2) brick partition bitwise with its
   spin and LFSR digests, gibbs f32 within 0.5% with its LFSR digest),
   every configuration against the same engine on the CPU over its first
   4 sweeps or its first sync period (``TWIN_SWEEPS``; int8 bitwise; f32
   with each colour phase
   held to the CPU's:
   LFSR states bitwise, a differing spin only within 8 ulp of its
   boundary; philox within 0.5% and repeatable on the card), then run
   over the whole schedule (none of the six kernels may launch: these
   engines are PyTorch operations);
6. drive the distributed DSIM, ``make_engine("dsim_dist", partitioned)``
   with every one of the K=8 partitions on the card: B7's fused colour
   phase against its plain version bitwise (words, LFSR states and
   flips: at the L=100 operands of each colour from the initial state
   and after 16 sweeps, at D = 3, 4 and 12 on random rows with the odd
   partitions padded, and at R=40), the
   JAX reference's golden values (int8 R=2 and bit-plane R=32 lanes 0-1
   reproduce ``DSIM_GOLDEN``, f32 R=2 ``DIST_GOLDEN`` within 0.5% with its
   LFSR digest), every ``DIST_RUNS`` configuration against its
   ``device="cpu"`` twin over 4 sweeps or its first sync period (int8
   and bit-plane bitwise, f32
   phase by phase as in phase 5), then run over the whole schedule (the
   bit-plane run launches the fused colour phase once per colour phase,
   no run launches a lattice kernel), and ``dist_eta_meter``'s report of
   a run at ``sync_every`` 8 finite;
7. the degraded mesh and the sampling server: (a) both mesh engines'
   checked exchange at L=100 (``degrade=``): the lattice's ``MESH_RUNS``
   under ``stale_hold:8`` with no faults bitwise the unchecked run (and
   the (2,2,2) ``MESH_GOLDEN`` still reproduced), with ``DEG_CODES`` of
   drops and corruptions bitwise the ``impl="ref"`` run with the same
   codes (f32: LFSR states bitwise, energies within 0.5%), with the same
   health report as the codes predict; ``freeze_boundary`` against its
   ``impl="ref"`` run, ``resync`` clearing the staleness, ``fail_fast``
   raising at the chunk of its code; (b) the same for ``dsim_dist``
   K=8 at int8 R=4 and bit-plane R=64 (with codes against the
   ``device="cpu"`` twin), and ``effective_eta`` at ``sync_every`` 8
   under injected drops 7/8 of the measured eta; (c)
   ``repro_torch.serve.SampleServer`` on the card answering
   ``SERVER_JOBS`` at L=100 (a packed int8 pair, bit-plane, f32, a
   degraded mesh job with a drop, a ``fail_fast`` dsim_dist job that ends
   ``failed`` with ``StateCorruption``), every job equal to a direct
   ``make_engine`` run of its seeds, the packed job equal to its solo
   run, the launch counters (0 just before the server is driven) showing
   kernels #1-#4 and B7 (as the fused colour phase) launched from within
   it, and the same jobs again on the warm server each from a pooled
   engine;
8. APT+ICM (``repro_torch.core.apt_icm.APTICM``) on the G81 shape
   (N=20,000, 2 chains x 64 temperatures): with ``HostDraws`` the card
   reproduces ``APT_GOLDEN`` (the JAX reference's digests, recomputed by
   ``tests/test_torch_golden.py``) in ``rng="lfsr"`` and packed mode and
   equals its ``device="cpu"`` twin bitwise over 16 sweeps; the fused
   colour phase against its plain version at the packed shape (K=1, W=4,
   words, LFSR states and energies bitwise, from the initial state and
   after 16 sweeps); ``philox`` f32, ``lfsr`` and packed (W=4) over 256
   sweeps with an ICM every 10th (packed launches the fused phase once
   per colour phase, the others no kernel), packed == lfsr bitwise with
   the card's generator, and one ``adapt_ladder`` call;
9. ``repro_torch.analyze``'s IR audit with every one-process chunk on the
   card: IR-A, IR-D and IR-E (no float arithmetic in integer bodies, host
   syncs as declared, modular counters) over the glue of the hand
   kernels;
10. the paper's six examples on the port (``examples/torch_*.py``), each
   ``main`` in its own subprocess at the reference's defaults with a
   timeout of its own, reporting its result and launch counts through a
   record file (``example_child``): quickstart's int8 per-replica
   energies and its bit-plane best energy and lane-flips equal the JAX
   reference's exactly (``QUICKSTART_GOLDEN``), and it launches kernels
   #1-#4 and B7's fused colour phase; sat3 satisfies at least 90% of its
   clauses; maxcut prints a cut per trial and the hex line; eta_sweep a
   finite kappa in every row; serve_sampling's recovered jobs are
   bitwise its uninterrupted ones; the dashboard's degraded job has a
   detection and a held exchange, its probe launches the fused phase,
   and its Prometheus head is not empty; then, in this process,
   quickstart's three lattice runs and packed APT+ICM and the
   dashboard's eta probe again at the examples' defaults, with every
   kernel launch held to its plain version on the same inputs (f32 as in
   phase 2, the rest bitwise);
11. LM serving through ``repro_torch.configs.get_config``,
   ``repro_torch.models.lm.build_model`` and
   ``repro_torch.serve.serve_step``: (a) six reduced configs
   (``LM_GOLDEN_ARCHS``, f32) from ``init(LM_SEED)``, their greedy tokens
   equal to the JAX reference's and their prefill logits within 1e-4 of
   their largest magnitude (``LM_GOLDEN``, recomputed by
   ``tests/test_torch_golden.py``), and the same runs on the CPU equal;
   (b) h2o-danube-1.8b at its published widths and depth in f32: decode
   == forward and the rolling ring at its full 4,096-token window within
   the reference's bound; (c) the same weights in bf16 serving 4 requests
   of 512 prompt tokens, 64 new tokens each, with their peak memory;
   (d) mamba2-370m at full width: f32 decode == forward and the SSD's
   chunk invariance, then bf16 serving as (c); (e)
   ``examples/torch_serve_lm.py`` at its defaults in a subprocess; (f)
   none of the hand kernels launched in the phase;
12. LM training through ``repro_torch.train`` (``make_train_step``,
   ``AdamW``, ``checkpoint``, ``compression``) and ``launch.train``: (a)
   the seven ``TRAIN_RUNS`` (``LM_GOLDEN_ARCHS`` reduced in f32, and
   deepseek-7b with int8 moments) from ``init(LM_SEED)``, four steps on
   ``train_batches``: each step's loss and gradient norm within 1e-4
   relative of the JAX reference's (``TRAIN_GOLDEN``, recomputed by
   ``tests/test_torch_golden.py``) and within 1e-5 of the same runs on the
   CPU; (b) h2o-danube-1.8b at its published widths in f32 (phase 11's
   host draw), B=2 x S=512: ``grad_accum=2`` == ``grad_accum=1`` within
   the reference's bounds (loss 1e-4, parameters 1e-5) and the gradients
   with remat on == off within 1e-6 of their largest magnitude, with the
   peak memory of each run; (c) the same weights in bf16 with f32 AdamW
   moments and remat, B=2 x S=4096 (the train_4k sequence; its global
   batch of 256 cut to one card) on ``MarkovLM(4096)`` batches through
   ``prefetch``: 8 finite steps after a first, then 2 steps with int8
   moments and their bytes per parameter; (d) mamba2-370m the same at
   B=4 x S=2048;
   (e) (c)'s int8 state saved with ``blocking=False``, restored bitwise,
   one further step from each equal bitwise; (f) local SGD with 2
   replicas in one process against its CPU twin, and the EF all-reduce's
   mean; (g) ``examples/torch_train_lm.py`` at its defaults in a
   subprocess (loss falls), and again to 140 steps: it resumes at step
   120; (h) none of the hand kernels launched in the phase;
13. the dry run (``python -m repro_torch.launch.dryrun``): kernel #3 held
   to its plain version (as in phase 2) at the dry run's bricks, rank
   17's 7x7x100 (16x16 mesh) and 7x7x50 (2x16x16) and rank 255's
   all-padding 7x7x100; then ``--all``
   (both meshes) and rank 255 alone, each a subprocess with its own
   timeout on a "fake" process group of 256 or 512 ranks: every record
   ``ok`` on the card with the reference's chips, extras and wire bytes
   per rank (``collective-permute`` 704.0 and 380.0, rank 255 its two
   faces), #3 launched once per iteration, ``chunk_s`` no less than the
   record's roofline bound / 1.05, the memory within the card's, the rank
   holding only its brick's constants (``resident_problem_bytes`` 31 B a
   site: 151,900 B at 7x7x100, 75,950 B at 7x7x50) and the chunk's peak
   allocation below 1,000,000 B;
14. print the seconds of each phase, one JSON line of kernels (each
   kernel's largest difference from its plain version, and its
   ``launches`` over the main and mesh paths, the bit-plane dist run's
   and the packed APT run's for B7's fused colour phase, the examples'
   and the dry run's; ``mesh_launches`` the mesh path's,
   ``server_launches`` the server path's, ``apt_launches`` the APT
   path's, ``example_launches`` each example's, ``dryrun_launches`` the
   dry run's records'), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is absent or the
script stands outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import inspect
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
LATTICE_KERNELS = ("pbit_brick_sweep_int", "pbit_bitplane_sweep",
                   "brick_energy", "pbit_brick_sweep", "pbit_brick_update_int",
                   "pbit_brick_update")
# the kernels line: the six lattice kernels and B7, the ELL word
# gather-count of the bit-plane general-graph path, launched as the fused
# colour phase (phases 6 and 8)
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
# ea_schedule(MAIN_SWEEPS) as the main path.
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
# the MESH_RUNS engine that the meters (phases 4 and 7) and phase 7's
# freeze, resync and fail_fast drive
ONE_MESH = "int8 R=4 mesh (2,2,2)"
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
# phases 5 and 6 hold each configuration to its device="cpu" twin over
# the first TWIN_SWEEPS sweeps, or its first sync period where that is
# longer (cut from 16 to 8, then to 4, to keep the whole script within
# one call: the CPU twins at L=100 take most of those phases)
TWIN_SWEEPS = 4


def twin_sweeps(sync) -> int:
    """Sweeps of a twin comparison's first chunk: TWIN_SWEEPS, or the sync
    period where that is longer (a chunk ends at an exchange)."""
    return max(TWIN_SWEEPS, sync) if isinstance(sync, int) else TWIN_SWEEPS
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

# APT+ICM (phase 8) on the G81 shape: APT_CHAINS chains over an APT_T
# ladder apt_betas(), in three modes (f32 philox, lfsr, lfsr packed into
# W = 4 word planes), each over APT_SWEEPS sweeps with an ICM every
# APT_ICM_EVERY-th, from init_state(seed=SEED).
APT_CHAINS, APT_T = 2, 64
APT_SWEEPS, APT_ICM_EVERY = 256, 10
APT_MODES = {"philox": dict(rng="philox"), "lfsr": dict(rng="lfsr"),
             "packed": dict(rng="lfsr", packed=True)}
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

# Phase 10: the port's examples, each run as ``python3
# examples/torch_<name>.py`` with its seconds allowed.
EXAMPLES = {"quickstart": 150, "sat3_invertible": 120, "maxcut_gset": 150,
            "eta_sweep": 300, "serve_sampling": 180, "serve_dashboard": 120}
# the longest example runs beside the other five (to keep the whole
# script inside one call)
EXAMPLE_BESIDE = "eta_sweep"
# a process run beside others drives the card from one host thread: no
# pool of CPU threads to contend with theirs
BESIDE_ENV = {"OMP_NUM_THREADS": "1"}
# The JAX reference's examples/quickstart.py (L=10, budget 2048): its int8
# lattice's per-replica energies, and its bit-plane lattice's best energy
# and lane-flips.  tests/test_torch_examples.py recomputes these from the
# JAX package.
QUICKSTART_GOLDEN = {"int8": [-1684.0, -1700.0, -1688.0, -1692.0],
                     "bitplane_best": -1710.0, "bitplane_flips": 2837134}
# The reference's examples/eta_sweep.py kappa_DSIM at S=1 and S=256 on
# the CPU (reported beside the card's, not gated: the ground run draws
# from philox).
ETA_REFERENCE_KAPPA = {1: 0.646, 256: 0.900}


# Phase 11: LM serving.  (a) LM_GOLDEN: for each LM_GOLDEN_ARCHS config's
# reduced() variant, the JAX reference's greedy_generate over the
# lm_prompt batch (max_new LM_MAX_NEW) on the port's init(LM_SEED)
# weights: its tokens, and its prefill's last-position logits digested by
# lm_digest.  tests/test_torch_golden.py recomputes these from the JAX
# package.  (b)-(d) two published configs at full width.
LM_SEED = 0
LM_GOLDEN_ARCHS = ("deepseek-7b", "h2o-danube-1.8b", "mamba2-370m",
                   "jamba-v0.1-52b", "deepseek-moe-16b",
                   "seamless-m4t-medium")
LM_PROMPT, LM_MAX_NEW = (2, 16), 8
LM_LOGIT_TOL = 1e-4          # of the logits' largest magnitude
LM_GOLDEN = {
    "deepseek-7b": {
        "tokens": [
            [241, 156, 125, 215, 251, 200, 145, 92],
            [215, 215, 209, 100, 174, 15, 215, 153],
        ],
        "logits_at": [
            [2.832101, 0.983238, -1.237308, 0.3164822, -1.832422, 1.41625,
             -0.1653998, -0.4155436, -0.04307489, -0.7873837, -1.232342,
             -1.171476, -0.5340856, 0.06597072, -0.6104801, -1.371543],
            [-0.5580463, -0.1795695, 0.1499764, 0.1174837, 1.156285,
             0.7326642, -0.3147198, 0.5453089, -0.7424611, 0.8880565, 2.332816,
             -0.9137109, 0.7152172, 0.9176957, 1.446579, 0.724735],
        ],
        "absmax": [3.186565, 2.745797],
        "l2": [15.32573, 15.85822],
    },
    "h2o-danube-1.8b": {
        "tokens": [
            [241, 156, 73, 48, 121, 142, 142, 142],
            [215, 215, 153, 119, 217, 181, 92, 62],
        ],
        "logits_at": [
            [2.832101, 0.9832386, -1.237307, 0.3164828, -1.832422, 1.416251,
             -0.165401, -0.4155446, -0.04307546, -0.7873849, -1.232344,
             -1.171476, -0.5340859, 0.06597076, -0.6104808, -1.371542],
            [-0.5580463, -0.1795704, 0.1499764, 0.1174835, 1.156285,
             0.7326646, -0.3147202, 0.5453081, -0.7424612, 0.8880557, 2.332815,
             -0.9137117, 0.7152173, 0.9176952, 1.446579, 0.7247352],
        ],
        "absmax": [3.186565, 2.745797],
        "l2": [15.32572, 15.85822],
    },
    "mamba2-370m": {
        "tokens": [
            [1, 178, 42, 93, 110, 132, 211, 200],
            [61, 175, 199, 133, 35, 188, 214, 201],
        ],
        "logits_at": [
            [-1.157078, -1.374344, 0.01968432, 0.7118489, -0.3728584,
             -2.632576, -0.9701234, 2.144363, 0.7619892, 0.6763504,
             -0.07379441, -0.6804114, -0.8036385, -0.6861641, 0.1779088,
             1.758213],
            [0.4923631, 0.1522083, 0.2679593, -1.116009, -0.9611572, 1.995158,
             -0.3367978, 0.8635296, 0.07236376, 0.449971, -0.7294083,
             -1.007289, -0.3955976, 0.1107077, 0.9095826, -0.4031285],
        ],
        "absmax": [2.811734, 2.653112],
        "l2": [16.1548, 16.2886],
    },
    "jamba-v0.1-52b": {
        "tokens": [
            [3, 214, 122, 100, 243, 100, 126, 29],
            [103, 26, 229, 196, 156, 62, 197, 209],
        ],
        "logits_at": [
            [1.733728, -0.9624028, 0.228791, 0.7934014, 0.1333711, -0.5543106,
             -0.7625684, 2.19372, 0.5918518, -0.3586381, 0.001819758,
             0.5875515, 1.137355, -0.7377827, -1.626033, 1.346818],
            [-0.4318311, 0.5361231, 0.6045761, 0.3593118, 0.3808406,
             0.2082025, -0.06873598, 1.119103, -0.5147385, 0.3915426,
             -3.468952, -1.019461, -0.2901396, -0.02660241, -0.2323041,
             0.6840794],
        ],
        "absmax": [2.956446, 3.468952],
        "l2": [15.65629, 16.05048],
    },
    "deepseek-moe-16b": {
        "tokens": [
            [14, 136, 44, 2, 117, 118, 94, 176],
            [224, 1, 137, 40, 171, 215, 70, 171],
        ],
        "logits_at": [
            [2.405584, 0.6045603, -2.430984, -1.611446, -1.593751, -0.3183598,
             0.2479752, -2.469303, 0.544871, -1.407656, -0.1851996, -0.8109486,
             0.9271124, -1.198428, -0.3686903, 0.7677527],
            [-0.8460585, -0.3269142, 0.5696063, -0.384426, 1.65034, 0.6195712,
             0.9904804, 1.159232, -1.688223, 0.9278261, 0.9612809, -0.1548869,
             -0.3212979, 1.140561, 2.31367, 0.2350108],
        ],
        "absmax": [3.520609, 3.022104],
        "l2": [15.50707, 15.79724],
    },
    "seamless-m4t-medium": {
        "tokens": [
            [110, 226, 77, 225, 77, 225, 77, 225],
            [33, 113, 117, 113, 117, 33, 113, 33],
        ],
        "logits_at": [
            [0.7584512, 1.431812, -0.8296189, -0.5032073, 1.399542, 0.3243932,
             -1.062742, -0.2433267, 0.9681044, 0.1562665, -0.5553572,
             0.7544894, 0.004042653, 1.393957, 0.5698424, 1.075734],
            [-0.338294, 0.08561859, -1.097326, 1.085389, -1.159111, -1.774078,
             -1.523079, 1.002615, 1.266741, 0.3986889, -1.845378, -0.04971166,
             1.734541, 0.09107825, -0.4051859, 0.9454969],
        ],
        "absmax": [3.274681, 2.489507],
        "l2": [15.95217, 14.97122],
    },
}
# decode == forward and the rolling ring: the reference's bound
# (tests/test_models.py); SSD chunk invariance: its rtol = atol
LM_REL_TOL, LM_CHUNK_TOL = 2e-2, 2e-4
LM_SERVE = dict(batch=4, prompt=512, max_new=64)
LM_FULL = ("h2o-danube-1.8b", "mamba2-370m")   # at full width, phases 11-12
EXAMPLE_SERVE_LM_TIMEOUT = 180

# Phase 12 (LM training).  (a) TRAIN_GOLDEN: each TRAIN_RUNS run (name,
# int8 moments) on its reduced config in f32 from init(LM_SEED) takes
# TRAIN_STEPS make_train_step steps on train_batches(cfg) with
# AdamW(lr=TRAIN_LR, warmup=TRAIN_WARMUP): each step's loss and gradient
# norm from the JAX reference on the port's weights (train_digest),
# recomputed by tests/test_torch_golden.py.
TRAIN_RUNS = tuple((n, False) for n in LM_GOLDEN_ARCHS) + \
    (("deepseek-7b", True),)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR, TRAIN_WARMUP = 4, (8, 32), 3e-3, 5
TRAIN_GOLDEN_RTOL, TRAIN_CPU_RTOL = 1e-4, 1e-5
TRAIN_GOLDEN = {
    "deepseek-7b": {
        "loss": [6.045444, 5.964139, 5.983004, 6.084452],
        "grad_norm": [7.218721, 7.473717, 6.78096, 7.068876]},
    "h2o-danube-1.8b": {
        "loss": [6.061244, 5.983212, 6.026865, 6.045413],
        "grad_norm": [7.260598, 7.882169, 7.041128, 7.481542]},
    "mamba2-370m": {
        "loss": [5.977046, 6.070703, 5.852524, 5.906239],
        "grad_norm": [6.780799, 6.88784, 6.63175, 6.851837]},
    "jamba-v0.1-52b": {
        "loss": [6.126198, 6.157936, 6.052875, 6.225353],
        "grad_norm": [27.18451, 26.81006, 24.91469, 28.59667]},
    "deepseek-moe-16b": {
        "loss": [6.06565, 6.125332, 6.086535, 6.033928],
        "grad_norm": [8.061266, 8.532034, 7.485616, 7.827768]},
    "seamless-m4t-medium": {
        "loss": [6.147382, 5.983605, 6.022362, 6.049466],
        "grad_norm": [6.198826, 5.299795, 5.668701, 5.426592]},
    "deepseek-7b int8": {
        "loss": [6.045444, 5.964139, 5.983026, 6.083364],
        "grad_norm": [7.218721, 7.473717, 6.781579, 7.074529]},
}
# (b) h2o-danube-1.8b in f32 at full width: grad_accum 2 == 1 within the
# reference's bounds (tests/test_train.py: loss 1e-4, parameters 1e-5),
# remat on == off within REMAT_TOL of the gradients' largest magnitude
TRAIN_CHECK = dict(batch=2, seq=512)
ACCUM_LOSS_TOL, ACCUM_PARAM_TOL, REMAT_TOL = 1e-4, 1e-5, 1e-6
# At full width Adam's first step turns a gradient near eps = 1e-8 into
# an update near lr whatever its rounding, so a gradient's last ulp moves
# such a parameter by up to lr: the parameter bound holds where |g| >=
# 1e-6 (m = 0.1 g >= ACCUM_SURE_M), and the clipped gradients themselves
# within ACCUM_GRAD_TOL of their largest magnitude (f32 sums over 1,024
# rows against two of 512)
ACCUM_SURE_M, ACCUM_GRAD_TOL = 1e-7, 1e-5
# (c)-(d) at full width in bf16 with remat, TRAIN_TIMED_STEPS steps
# after a first; the train_4k cell's sequence, its global batch of 256
# cut to fit one card.  Tokens from
# MarkovLM(TRAIN_DATA_VOCAB): its vocab x vocab f64 table would be 8.2 GB
# at 32,000, and every id below 4,096 is valid in both vocabularies.
TRAIN_TIMED = {"h2o-danube-1.8b": dict(batch=2, seq=4096),
               "mamba2-370m": dict(batch=4, seq=2048)}
TRAIN_TIMED_STEPS, TRAIN_INT8_STEPS, TRAIN_DATA_VOCAB = 8, 2, 4096
# (f) local SGD with its replicas in one process, and the EF all-reduce
SGD_RUN = dict(name="h2o-danube-1.8b", replicas=2, sync_every=2, outer=3,
               batch=4, seq=32)
SGD_RTOL = 1e-5
EXAMPLE_TRAIN_LM_TIMEOUT = 240


def train_batches(cfg) -> list:
    """Phase 12a's TRAIN_STEPS batches (numpy) for ``cfg``: MarkovLM(256,
    seed=1) tokens, and standard-normal frames for an encoder-decoder."""
    from repro_torch.train.data import MarkovLM
    B, S = TRAIN_BATCH
    out = []
    for i, b in zip(range(TRAIN_STEPS), MarkovLM(256, seed=1).batches(B, S)):
        if cfg.encdec:
            b["frames"] = np.random.default_rng(LM_SEED + i).standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def train_digest(losses, norms) -> dict:
    """Per-step losses and gradient norms to 7 digits (TRAIN_GOLDEN)."""
    rnd = lambda a: [float(f"{float(v):.7g}") for v in a]  # noqa: E731
    return {"loss": rnd(losses), "grad_norm": rnd(norms)}


def train_key(name: str, int8: bool) -> str:
    return f"{name} int8" if int8 else name


def lm_param_count(cfg) -> int:
    """The parameters of ``cfg``'s model, from its shapes (the tree
    ``init`` builds; tests/test_torch_models.py holds the two equal on
    every reduced config)."""
    d, dh = cfg.d_model, cfg.d_head
    attn = d * cfg.n_heads * dh * 2 + 2 * d * cfg.n_kv_heads * dh
    di, n = 2 * d, cfg.ssm_state
    heads = di // cfg.ssm_headdim
    mixer = {"attn": attn, "swa": attn, "cross_attn": attn,
             "mamba": d * (2 * di + 2 * n + heads) + 5 * (di + 2 * n)
             + 3 * heads + di + di * d}
    shared = 0
    if cfg.moe_shared:
        shared = 3 * d * (cfg.moe_d_ff_shared or
                          cfg.moe_shared * cfg.moe_d_ff)
    ffn = {None: 0, "dense": d + 3 * d * cfg.d_ff,
           "moe": d + d * cfg.moe_experts
           + 3 * cfg.moe_experts * d * cfg.moe_d_ff + shared}
    block = lambda b: d + mixer[b.mixer] + ffn[b.ffn]  # noqa: E731
    head = 2 * cfg.vocab_padded * d + d
    if cfg.encdec:
        enc = block(type(cfg.group[0])("attn", "dense"))
        dec = block(type(cfg.group[0])("attn", None)) + block(
            type(cfg.group[0])("cross_attn", "dense"))
        return head + d + cfg.enc_layers * enc + cfg.n_groups * dec
    return head + sum(block(b) for b in cfg.prelude) + \
        cfg.n_groups * sum(block(b) for b in cfg.group)


def lm_prompt(cfg) -> dict:
    """Phase 11a's batch (numpy): LM_PROMPT tokens, and frames for an
    encoder-decoder config."""
    rng = np.random.default_rng(LM_SEED)
    b = {"tokens": rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)}
    if cfg.encdec:
        b["frames"] = rng.standard_normal(
            LM_PROMPT + (cfg.d_model,)).astype(np.float32)
    return b


def lm_digest(tokens, logits) -> dict:
    """(B, max_new) tokens and (B, V) prefill logits -> LM_GOLDEN's entry:
    the tokens, and each row's logits at 16 evenly spaced vocabulary
    indices, its largest magnitude and its L2 norm, to 7 digits."""
    logits = np.asarray(logits, np.float64)
    rnd = lambda a: [[float(f"{v:.7g}") for v in row] for row in a]  # noqa
    step = logits.shape[1] // 16
    return {"tokens": np.asarray(tokens).tolist(),
            "logits_at": rnd(logits[:, ::step][:, :16]),
            "absmax": [float(f"{v:.7g}") for v in np.abs(logits).max(1)],
            "l2": [float(f"{v:.7g}") for v in np.linalg.norm(logits, axis=1)]}


def apt_betas() -> np.ndarray:
    """Phase 8's ladder, the reference's T=64 case
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
# the dsim_dist run whose meter phase 6 checks, and the bit-plane run
# whose operands phase 6 holds the fused colour phase to its plain
# version on
DIST_ETA_RUN = "dsim_dist int8 R=4 K=8"
DIST_BITPLANE = "dsim_dist bitplane R=64 K=8"
# the fused colour phase is also held to its plain version at these
# degrees
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

# The degraded mesh (phase 7): DEG_SWEEPS sweeps at sync_every DEG_SYNC
# (eight exchanges), record points DEG_POINTS; DEG_CODES[seq] injects a
# drop (1) or a corruption (2) on the received planes of exchange seq:
# four bad exchanges of eight, two of them consecutive.
DEG_SWEEPS, DEG_SYNC, DEG_POINTS = 32, 4, [16, 32]
DEG_CODES = [0, 1, 0, 2, 2, 0, 1, 0]
DEG_POLICY = "stale_hold:8"
# The server path (phase 7c): label -> (problem, submit keywords), each
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


# Phase 13, the dry run: its records of rank 17 on the two production
# meshes (the wire per rank is the JAX reference's, which
# tests/test_torch_dryrun.py holds on the CPU), and rank 255, whose brick
# is all padding (x and y from 105 to 111) and which has two neighbours.
DRYRUN_TIMEOUT = 180
DRYRUN_MESHES = {
    "single_pod_16x16": dict(chips=256, permute=704.0, brick=[7, 7, 100]),
    "multi_pod_2x16x16": dict(chips=512, permute=380.0, brick=[7, 7, 50])}
DRYRUN_PADDING = dict(rank=255, permute=352.0)
DRYRUN_EXTRAS = {"p_bits": 1_000_000, "padded_sites": 1_254_400,
                 "n_colors": 2, "sync_every": 4}
DRYRUN_ITERS = 2
# a reading above 1 / DRYRUN_SLACK of the card's bound fails
DRYRUN_SLACK = 1.05
# a rank holds its brick's f32 constants on the card: masks (2 colours,
# int8), h and w6 (f32) and active (int8), 31 B a site; the chunk's peak
# allocation (constants, state, halos and temporaries) stays below
# DRYRUN_PEAK_MAX
DRYRUN_SITE_BYTES = 31
DRYRUN_PEAK_MAX = 1_000_000
# the peak of the same chunk when every rank held the whole padded
# problem on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6)
DRYRUN_PEAK_WHOLE = {"single_pod_16x16": 40_125_952,
                     "multi_pod_2x16x16": 39_962_624}

# Phase 4, the construction of each MESH_RUNS engine in a fresh process
# (``build_peaks``): the bytes it allocated at its peak and held after it
# on the tree before per-rank residency, when the registry built the
# problem on the card and each engine held it whole beside its bricks
# (NVIDIA H100 80GB HBM3, 700 W; ``python3 chip_smoke.py --build-peaks
# <src of that tree>``; PERF.md section 6).
MESH_BUILD_WHOLE = {
    "int8 R=4 mesh (2,2,2)": {"peak": 77_145_088, "held": 77_019_648},
    "int8 R=4 mesh (2,2,1)": {"peak": 77_251_584, "held": 77_001_216},
    "bitplane R=64 mesh (2,2,2)": {"peak": 216_461_312,
                                   "held": 215_961_088},
    "f32 R=4 mesh (2,2,2)": {"peak": 63_366_656, "held": 62_991_872}}
# the allocator's rounding of a build's tensors, which neither the peak
# nor the held bytes may exceed the bricks' constants by
BUILD_SLACK = 1 << 20


class CheckFailed(RuntimeError):
    pass


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module (its ``main`` not run)."""
    path = Path(__file__).resolve().parent / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_example_record(mod, argv, record: str) -> dict:
    """Run an example's ``main(argv)`` and write its result and this
    process's launch counts to ``record`` as one JSON object."""
    from repro_torch.kernels import _build
    out = mod.main(argv)
    Path(record).write_text(json.dumps(
        {"result": out, "launches": dict(_build.launch_counts)},
        default=float))
    return out


def example_child(name: str, record: str, *argv) -> None:
    """The process ``Smoke.run_example`` starts for one example."""
    write_example_record(load_example(name), list(argv), record)


def check(cond, what: str):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok  {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


BUILD_PEAKS = r"""
import dataclasses, json, sys
import torch
from repro_torch import make_engine
from repro_torch.core.mesh import make_mesh
L, SEED, AXES, kw = json.loads(sys.argv[1])
shape = kw.pop("mesh")
torch.cuda.init()
a0 = torch.cuda.memory_allocated()
h = make_engine("lattice", L=L, seed=SEED, mesh=make_mesh(shape, AXES),
                dim_axes=AXES, **kw)
torch.cuda.synchronize()
bricks = 0
for b in h.eng._bricks:
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        for x in (v if isinstance(v, tuple) else (v,)):
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                bricks += x.numel() * x.element_size()
print(json.dumps({"peak": torch.cuda.max_memory_allocated() - a0,
                  "held": torch.cuda.memory_allocated() - a0,
                  "bricks": bricks}))
"""


def build_peaks(src: Path) -> dict:
    """{MESH_RUNS label: {"peak", "held", "bricks"}}: the bytes building
    the MESH_RUNS engine (``make_engine("lattice", L=100, mesh=...)``)
    allocated on the card at its peak and still held after it, and the
    bytes of its bricks' constants there, each in a fresh process of its
    own (started together) over the package under ``src`` (this
    checkout's, or another tree's)."""
    env = dict(os.environ, PYTHONPATH=str(src))
    procs = {label: subprocess.Popen(
        [sys.executable, "-c", BUILD_PEAKS, json.dumps([L, SEED, AXES, kw])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for label, kw in MESH_RUNS.items()}
    out = {}
    for label, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.communicate()
            raise CheckFailed(f"building {label} under {src} ran past 300 s")
        if proc.returncode != 0:
            raise CheckFailed(f"building {label} under {src} failed: "
                              f"{stderr[-3000:]}")
        out[label] = json.loads(stdout.strip().splitlines()[-1])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's entry points run on "
              "the card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--build-peaks"]:
        # phase 4's construction peaks over another tree's package
        print(card_line())
        print(json.dumps(build_peaks(Path(sys.argv[2]).resolve())))
        return 0
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
        # kernel name -> {"max_abs_err": its largest difference from its
        # plain version over every comparison}
        self.results = {}

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
        laps, t0 = [], time.perf_counter()
        for phase, args in (
                (self.phase_build, ()), (self.phase_kernels, ()),
                (self.phase_main_path, ()), (self.phase_mesh, (card,)),
                (self.phase_graph, ()), (self.phase_dist, (card,)),
                (self.phase_degraded, ()), (self.phase_server, ()),
                (self.phase_apt, ()), (self.phase_audit, ()),
                (self.phase_examples, ()), (self.phase_lm, ()),
                (self.phase_train, (card,)), (self.phase_dryrun, ())):
            phase(*args)
            t1 = time.perf_counter()
            laps.append(f"{phase.__name__[6:]} {t1 - t0:.1f}")
            t0 = t1
        print("seconds per phase: " + ", ".join(laps), flush=True)
        self.launches["bitplane_gather_count"] += self.apt_launches
        kernels = []
        for k in KERNELS:
            per = {n: c[k] for n, c in self.example_launches.items()}
            kernels.append(dict(
                name=k, **self.results[k],
                launches=self.launches[k] + sum(per.values())
                + self.dryrun_launches[k],
                mesh_launches=self.mesh_launches[k],
                server_launches=self.server_launches[k],
                example_launches=per,
                dryrun_launches=self.dryrun_launches[k]))
        kernels[-1]["apt_launches"] = self.apt_launches
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": t.cuda.get_device_name(0),
            "count": t.cuda.device_count()}}))
        return 0

    def phase_build(self):
        from repro_torch.kernels import _build
        print("== 1. build", flush=True)
        lib = _build.build()
        _build.library()
        print(f"  built {lib.name}", flush=True)
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
        self.inputs_int8 = (m, s, prob.masks, eng.h_q, eng.w6_q, halos, lut)

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
        self.results["pbit_bitplane_sweep"] = {"max_abs_err": max(errs)}

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
        m, s, masks, h_q, w6_q, halos, lut = self.inputs_int8
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
        self.check_int_flips((m, s, row, masks[0], h_q, w6_q, halos, lut))

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
        from repro_torch.kernels.lattice_energy import brick_energy
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
            # in the reference's shapes: the bit-plane engine on the card
            # holds its LFSR columns in the kernel's color-major order
            first[label] = (h.eng.global_state(cur.state),
                            cur.record().energies, cur.flips_per_replica())

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
                st, rec = hh.run_recorded(inits[label],
                                          ea_schedule(MAIN_SWEEPS),
                                          MAIN_POINTS, sync_every=SYNC)
            finally:
                for mod, fn in patched:
                    mod.unpack_lanes = fn
            counts = {k: v for k, v in _build.launch_counts.items() if v}
            for k, v in counts.items():
                self.launches[k] += v
            R = hh.replicas
            e = rec.energies
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

        # the bit-plane engine's energy readout (exchange of the word
        # planes, the word-plane energy) against the readout it replaced
        # (unpack the lanes, an int8 exchange, the int8 energy), on the
        # same state
        eng = handles["bitplane R=64"].eng
        st = inits["bitplane R=64"]
        m = unpack_lanes(st.m, eng.replicas)
        check(self.same(eng.energy(st), brick_energy(
            m, eng.p.active, eng.p.h, eng.p.w6,
            eng._squeeze(eng._exchange(m)))),
            f"bit-plane readout (R={eng.replicas}) == the unpack-first "
            f"readout, bitwise")

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

    def mesh_build(self, card: str):
        """Each MESH_RUNS engine's construction on the card
        (``build_peaks``): the registry builds the problem on the host and
        the engine moves only its bricks, so the card holds their
        constants and nothing else of the build, at its peak and after,
        below the same build's peak when the whole problem lay on the card
        (MESH_BUILD_WHOLE).  The check's line carries the bytes."""
        got = build_peaks(Path(__file__).resolve().parent / "src")
        for label in MESH_RUNS:
            g, was = got[label], MESH_BUILD_WHOLE[label]
            check(0 <= g["held"] - g["bricks"] < BUILD_SLACK and
                  0 <= g["peak"] - g["held"] < BUILD_SLACK and
                  g["peak"] < was["peak"],
                  f"mesh {label}: the build holds its bricks' "
                  f"{g['bricks']} B of constants on the card (held "
                  f"{g['held']} B, peak {g['peak']} B; with the whole "
                  f"problem on the card peak {was['peak']} B, held "
                  f"{was['held']} B); on {card}")

    def phase_mesh(self, card: str):
        """The mesh path: the golden values of the JAX reference's (2,2,2)
        mesh, the first 16 sweeps of each MESH_RUNS configuration against
        its impl="ref" run on the card, the full runs with their
        launches counted, and the eta meter's report."""
        t = self.torch
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.bits import u32_to_numpy
        from repro_torch.kernels import _build
        print("== 4. mesh path: make_engine('lattice', L=100, mesh=...)",
              flush=True)
        self.mesh_build(card)
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
        handles = {label: self.engine(kw) for label, kw in MESH_RUNS.items()}
        inits = {label: hh.init_state(seed=SEED)
                 for label, hh in handles.items()}
        self.mesh_launches = dict.fromkeys(_build.launch_counts, 0)
        for label, hh in handles.items():
            K = len(hh.eng.coords)
            _build.reset_launch_counts()
            st, rec = hh.run_recorded(inits[label], ea_schedule(MAIN_SWEEPS),
                                      MAIN_POINTS, sync_every=SYNC)
            counts = {k: v for k, v in _build.launch_counts.items() if v}
            for k, v in counts.items():
                self.mesh_launches[k] += v
            R = hh.replicas
            e = rec.energies
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
        for name in ("pbit_brick_sweep_int", "pbit_bitplane_sweep",
                     "pbit_brick_sweep", "brick_energy"):
            check(self.mesh_launches[name] > 0,
                  f"mesh path launched {name} {self.mesh_launches[name]} "
                  f"times")
            self.launches[name] += self.mesh_launches[name]
        self.mesh_eta(handles[ONE_MESH], inits[ONE_MESH])

    def mesh_eta(self, hh, st):
        """The EtaMeter's report of one run of ``hh`` from ``st`` at
        sync_every SYNC, its exchange measured alone: finite."""
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.obs.timing import EtaMeter
        fn = hh.eng.boundary_exchange_fn()
        cur = hh.start_recorded(st, ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                sync_every=SYNC)
        meter = EtaMeter(n_color=hh.eng.p.n_colors,
                         sync_every=SYNC).attach(cur)
        while not cur.done:
            cur.advance(1)
        meter.measure_exchange(lambda: fn(cur.state), reps=100, warmup=5)
        r = meter.report()
        check(np.isnan(r["eta_threshold"]) and
              all(np.isfinite(r[k]) and r[k] > 0 for k in (
                  "measured_eta", "f_comm_hz", "f_pbit_hz")),
              f"eta at sync_every={SYNC}: finite")

    # -- the general-graph engines -----------------------------------------

    def phase_graph(self):
        """The general-graph engines at L=100 through make_engine("gibbs")
        and make_engine("dsim"): the JAX golden values, every GRAPH_RUNS
        configuration against its device="cpu" twin over the first
        TWIN_SWEEPS sweeps, then run over MAIN_SWEEPS with the kernel
        launch counts read (these engines are PyTorch operations; they
        launch none of the six kernels)."""
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
        print(f"== 5. general-graph engines: make_engine('gibbs' | 'dsim') "
              f"at L={L}", flush=True)
        self.g = ea3d(L, seed=SEED)
        self.col = lattice3d_coloring(L)
        self.prob = build_partitioned(
            self.g, self.col, brick_partition((L, L, L), BRICKS),
            int(np.prod(BRICKS)))
        self.g81 = gset_like_toroidal(**G81)
        self.g81_ising = maxcut_to_ising(self.g81)
        self.col81 = greedy_coloring(self.g81_ising.idx, self.g81_ising.w)
        check(self.g.device.type == self.prob.device.type ==
              self.g81.device.type == "cuda",
              f"graph ({self.g.n} p-bits), partition (K={self.prob.K}, "
              f"n_max {self.prob.n_max}, g_max {self.prob.g_max}) and G81 "
              f"graph ({self.g81.n} p-bits, {self.col81.n_colors} colours) "
              f"built on {self.g.device}")
        self.graph_golden()
        for label, kw in GRAPH_RUNS.items():
            self.graph_vs_cpu(label, kw)
        for label, kw in GRAPH_RUNS.items():
            hh, sync = self.graph_engine(kw)
            n = hh.n_sites
            st0 = hh.init_state(seed=SEED)
            _build.reset_launch_counts()
            st, rec = hh.run_recorded(st0, ea_schedule(MAIN_SWEEPS),
                                      MAIN_POINTS, sync_every=sync)
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
        """The first TWIN_SWEEPS sweeps of a configuration on the card
        against its device="cpu" twin.  int8: bitwise.  f32 with LFSR: the card's
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
            got = self.first_chunk(hg, sync)
        finally:
            if held is not None:
                del hg.eng._phase
        want = self.first_chunk(hc, sync)
        (a, ea, fa), (b, eb, fb) = got, want
        if hg.eng.rng_kind == "philox":
            rel = float(((ea.cpu() - eb) / eb).abs().max())
            check(rel < 0.005, f"{label}: {twin_sweeps(sync)} sweeps on the "
                  f"card "
                  f"vs the CPU "
                  f"(another philox stream): energies within 0.5% "
                  f"({rel:.2e})")
            again = self.first_chunk(hg, sync)
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
        check(same, f"{label}: {twin_sweeps(sync)} sweeps on the card == "
              f"device='cpu', {what} (spins, LFSR, flips, energies; E[0]="
              f"{float(ea[0, 0])})")

    def first_chunk(self, hh, sync):
        """The first chunk of the main schedule, TWIN_SWEEPS sweeps (or one
        sync period where that is longer): (state, energies, flips per
        replica)."""
        from repro_torch.core.annealing import ea_schedule
        cur = hh.start_recorded(hh.init_state(seed=SEED),
                                ea_schedule(MAIN_SWEEPS),
                                [TWIN_SWEEPS] + MAIN_POINTS, sync_every=sync)
        cur.advance(1)
        n = twin_sweeps(sync)
        check(cur.sweeps_done == n and cur.points_recorded == 1,
              f"{hh.name} on {hh.device}: first chunk is {n} sweeps")
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

    # -- the distributed DSIM -----------------------------------------------

    def dist_whole_tables(self, eng, card: str):
        """The bytes of the tables ``dsim_dist`` keeps whole, K partitions
        wide, over a process group too: on the card the global slot ids
        ``global_spins`` scatters by and the graph ``energy`` reads, on
        the host the ghosts' source slots ``init_state`` gathers by
        (here, with every partition in one process, on the card)."""
        def nbytes(*ts):
            return sum(x.numel() * x.element_size() for x in ts)
        g = eng._graph
        ids, graph = nbytes(eng._global_ids), nbytes(g.idx, g.w, g.h)
        ghosts = nbytes(*eng._ghost_src.values())
        check(ids > 0 and graph > 0 and ghosts > 0,
              f"dsim_dist K={eng.p.K}: the whole tables are held")
        print(f"  dsim_dist K={eng.p.K} (n_max {eng.p.n_max}, g_max "
              f"{eng.p.g_max}, D {int(g.idx.shape[1])}), tables kept whole "
              f"over a process group: _global_ids {ids} B and the graph "
              f"{graph} B on the card, _ghost_src {ghosts} B on the host; "
              f"one partition's constants on the card instead of K's; on "
              f"{card}", flush=True)

    def phase_dist(self, card: str):
        """The distributed DSIM at L=100 through make_engine("dsim_dist"),
        all K partitions on the card: B7's fused colour phase against its
        plain version, the JAX golden values, every DIST_RUNS
        configuration against its device="cpu" twin over the first
        TWIN_SWEEPS sweeps, then run over MAIN_SWEEPS with the launches
        counted, and the eta meter's report."""
        t = self.torch
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.kernels import _build
        print(f"== 6. distributed DSIM: make_engine('dsim_dist') at L={L}, "
              f"K={self.prob.K} partitions on one card", flush=True)
        self.dist_phase_kernel()
        self.dist_golden()
        for label, kw in DIST_RUNS.items():
            self.dist_vs_cpu(label, kw)
        phases = MAIN_SWEEPS * self.col.n_colors
        for label, kw in DIST_RUNS.items():
            hh, sync = self.dist_engine(kw)
            n, R = hh.n_sites, hh.replicas
            if label == next(iter(DIST_RUNS)):
                self.dist_whole_tables(hh.eng, card)
            st0 = hh.init_state(seed=SEED)
            _build.reset_launch_counts()
            st, rec = hh.run_recorded(st0, ea_schedule(MAIN_SWEEPS),
                                      MAIN_POINTS, sync_every=sync)
            counts = {k: v for k, v in _build.launch_counts.items() if v}
            gathers, fused = self.pop_b7(counts)
            if hh.precision == "bitplane":
                self.launches["bitplane_gather_count"] = fused
                check(gathers == fused == phases and not counts,
                      f"{label}: the fused colour-phase kernel launched "
                      f"{fused} times, once per colour phase ({phases}); no "
                      f"lattice kernel ({counts})")
            else:
                check(gathers == 0 and not counts,
                      f"{label}: plain PyTorch operations, no kernel "
                      f"launched ({counts}, B7 {gathers})")
            e = rec.energies
            per_spin = (e[-1] / n).cpu()
            check(tuple(e.shape) == (len(MAIN_POINTS), R) and
                  bool(t.isfinite(e).all()) and bool((e[-1] < e[0]).all())
                  and bool(((per_spin > -1.75) & (per_spin < -1.55)).all()),
                  f"{label}: energies finite, shape {tuple(e.shape)}, "
                  f"annealed, E/N at {MAIN_SWEEPS} sweeps in "
                  f"[{float(per_spin.min()):.4f}, {float(per_spin.max()):.4f}]")
        self.dist_eta()

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

    @staticmethod
    def pop_b7(counts):
        """(B7's launches, the fused colour phase's), popped from a dict
        of launch counts."""
        return tuple(counts.pop(k, 0) for k in (
            "bitplane_gather_count", "bitplane_gather_count:phase"))

    def hold_phase(self, what, kernel, plain, mutable, consts):
        """One fused colour-phase launch against its plain version on
        copies of the same inputs: ``kernel`` and ``plain`` take the
        mutable tensors then ``consts``; every mutable tensor (words, LFSR
        states, flips or energies) must come out bitwise equal.  Returns
        the largest difference."""
        t = self.torch
        from repro_torch.kernels import _build
        got = [x.clone() for x in mutable]
        want = [x.clone() for x in mutable]
        before = dict(_build.launch_counts)
        kernel(*got, *consts)
        plain(*want, *consts)
        t.cuda.synchronize()
        n = {k: _build.launch_counts[k] - before[k] for k in (
            "bitplane_gather_count", "bitplane_gather_count:phase")}
        err = max(self.max_abs(a, b) for a, b in zip(got, want))
        moved = [not self.same(a, b) for a, b in zip(want, mutable)]
        check(all(self.same(a, b) for a, b in zip(got, want))
              and all(moved),
              f"{what}: fused colour phase == its plain version bitwise "
              f"(every output changed by the phase)")
        check(set(n.values()) == {1}, f"{what}: one launch ({n})")
        return err

    def dist_phase_kernel(self):
        """The fused dsim_dist colour phase against its plain version on
        the card, bitwise (words, LFSR states, flips): the bit-plane run's
        L=100 operands of each colour from its initial state and from its
        state after 16 sweeps; at D in GATHER_DEGREES on random rows of
        the same sites with every odd partition padded (colour 0 holds
        slot 0: its real slot-0 entries are lost; colour 1 does not: its
        padding steps slot 0's states); and at R=40 (two words, the last
        half empty)."""
        t = self.torch
        from repro_torch.core.annealing import beta_table, ea_schedule
        from repro_torch.core.bits import u32_from_numpy, u32_to_i64
        from repro_torch.kernels import ops
        from repro_torch.kernels.bitplane_phase import (bitplane_phase,
                                                        phase_sites)
        rng = np.random.default_rng(11)
        errs = []

        def run(hh, st, what, colors=None):
            e = hh.eng
            lut = u32_to_i64(e._lut_for(beta_table(
                ea_schedule(MAIN_SWEEPS).beta_array())))
            row = int(lut.shape[0]) // 2
            mw, gh = st.m.view(t.int32), st.ghosts.view(t.int32)
            s = u32_to_i64(st.rng)
            flips = t.zeros(hh.replicas, dtype=t.int64, device=self.dev)
            for c, sites in enumerate(colors or [c.sites for c in
                                                 e._colors]):
                errs.append(self.hold_phase(
                    f"dsim_dist bit-plane at L={L}, {what}, colour {c}: "
                    f"K={int(mw.shape[0])}, W={int(mw.shape[1])}, "
                    f"R={hh.replicas}, nc={int(sites.idx.shape[1])}, "
                    f"D={int(sites.idx.shape[2])}",
                    lambda m, s_, f: bitplane_phase(m, gh, s_, sites, lut,
                                                    row, e.f_max, f),
                    lambda m, s_, f: ops.bitplane_phase_op(
                        m, gh, s_, sites, lut, row, e.f_max, f,
                        impl="ref"), (mw, s, flips), ()))

        hh, sync = self.dist_engine(DIST_RUNS[DIST_BITPLANE])
        st0 = hh.init_state(seed=SEED)
        run(hh, st0, "initial state")
        st16, _ = hh.run_recorded(st0, ea_schedule(16), [16],
                                  sync_every=sync)
        run(hh, st16, "after 16 sweeps")
        # random rows over the other colour's slots and the ghosts, odd
        # partitions padded
        e = hh.eng
        p = e.p
        K, n_max, g_max = p.K, p.n_max, p.g_max
        ones = np.uint32(0xFFFFFFFF)
        for D in GATHER_DEGREES:
            colors = []
            for c, col in enumerate(e._colors):
                other = e._colors[1 - c].sites.slots.cpu().numpy()
                sl = col.sites.slots.cpu().numpy().copy()
                nc = sl.shape[1]
                mask = np.ones((K, nc), bool)
                for k in range(1, K, 2):
                    cut = nc - min(97 * k, nc // 2)
                    sl[k, cut:], mask[k, cut:] = 0, False
                lost = (sl == 0) & mask & ~mask.all(1, keepdims=True)
                pick = rng.integers(0, other.shape[1] + g_max, (K, nc, D))
                idx = np.where(pick < other.shape[1], np.take_along_axis(
                    other, np.minimum(pick, other.shape[1] - 1).reshape(
                        K, -1), 1).reshape(K, nc, D), n_max + pick
                    - other.shape[1])
                zero = rng.random((K, nc, D)) < 0.1
                idx = np.where(zero, 0, idx).astype(np.int32)
                nz = np.where(zero, 0, ones).astype(np.uint32)
                signs = np.where(rng.random((K, nc, D)) < 0.5, ones,
                                 0).astype(np.uint32)
                base = col.sites.base.cpu().numpy() + rng.integers(
                    -2, 3, (K, nc))
                on = lambda a: t.from_numpy(a).to(self.dev)  # noqa: E731
                colors.append(phase_sites(
                    on(sl), on(mask), on(lost) if lost.any() else None,
                    on(idx), u32_from_numpy(signs, self.dev),
                    u32_from_numpy(nz, self.dev), on(base)))
            check(colors[0].lost is not None and colors[1].lost is None
                  and bool((colors[1].flags == 4).any()),
                  f"random rows D={D}: colour 0 has lost slot-0 entries, "
                  f"colour 1's padding owns slot 0")
            run(hh, st16, f"random rows D={D}, odd partitions padded",
                colors)
        hh40, _ = self.dist_engine(dict(DIST_RUNS[DIST_BITPLANE],
                                        replicas=40))
        run(hh40, hh40.init_state(seed=SEED), "R=40")
        self.results["bitplane_gather_count"] = {"max_abs_err": max(errs)}

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
        """The first TWIN_SWEEPS sweeps of a DIST_RUNS configuration on the
        card against its device="cpu" twin: int8 and bit-plane bitwise; f32
        with every colour phase held to the twin's (hold_phases)."""
        hg, sync = self.dist_engine(kw)
        hc, _ = self.dist_engine(kw, device="cpu")
        held = None
        if hg.precision == "f32":
            held = self.hold_phases(hg.eng, hc.eng)
        try:
            got = self.first_chunk(hg, sync)
        finally:
            if held is not None:
                del hg.eng._phase
        want = self.first_chunk(hc, sync)
        (a, ea, fa), (b, eb, fb) = got, want
        same = all(self.same(getattr(a, f).cpu(), getattr(b, f)) for f in (
            "m", "ghosts", "macc", "rng", "sweep", "flips")) and \
            self.same(ea.cpu(), eb) and bool((fa == fb).all())
        what = "bitwise" if held is None else (
            f"bitwise, each of its {held['phases']} phases held to the CPU's "
            f"({held['differ']} decisions differed, all within {TANH_ULPS} "
            f"ulp of the boundary)")
        check(same, f"{label}: {twin_sweeps(sync)} sweeps on the card == "
              f"device='cpu', {what} (spins, ghosts, LFSR, flips, energies; "
              f"E[0]="
              f"{float(ea[0, 0])})")

    def dist_eta(self):
        """dist_eta_meter's report of one run of DIST_ETA_RUN at
        sync_every SYNC, its exchange measured alone: finite."""
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.obs.timing import dist_eta_meter
        hh, _ = self.dist_engine(DIST_RUNS[DIST_ETA_RUN])
        st = hh.init_state(seed=SEED)
        fn = hh.eng.boundary_exchange_fn()
        cur = hh.start_recorded(st, ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                sync_every=SYNC)
        meter = dist_eta_meter(hh.eng, sync_every=SYNC).attach(cur)
        while not cur.done:
            cur.advance(1)
        meter.measure_exchange(lambda: fn(cur.state), reps=100, warmup=5)
        r = meter.report()
        check(all(np.isfinite(r[k]) and r[k] > 0 for k in (
            "measured_eta", "eta_threshold", "f_comm_hz", "f_pbit_hz")),
            f"dist eta at sync_every={SYNC}: finite")

    # -- phase 7: the degraded mesh and the sampling server ---------------

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

    def phase_degraded(self):
        """(a) the lattice mesh and (b) dsim_dist with a degrade policy at
        L=100: without faults bitwise the unchecked run, with DEG_CODES
        equal to the plain run (impl="ref" on the card, or the CPU twin)
        with the same codes and the report the codes predict, freeze,
        resync and fail_fast; effective_eta under injected drops."""
        print(f"== 7. degraded mesh at L={L}: checked exchange, stale hold, "
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
        kw = MESH_RUNS[ONE_MESH]
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
              f"{ONE_MESH} freeze_boundary codes {freeze}: == impl='ref' "
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
              f"{ONE_MESH} fail_fast codes {ff}: StateCorruption at the "
              f"chunk of exchange 5 (stopped at sweep {got[4]})")
        self.deg_lattice_eta()
        self.deg_dist()

    def deg_lattice_eta(self):
        """``deg_eta`` of ONE_MESH under DEG_POLICY, its checked exchange
        measured alone."""
        from repro_torch.core.degrade import carry_to_device, health_init
        hh = self.engine(dict(MESH_RUNS[ONE_MESH], degrade=DEG_POLICY))
        eng = hh.eng
        st = hh.init_state(seed=SEED)
        m = eng._bricks_of(st.m)
        ex = eng._exchanger(int(m.shape[1]), m.dtype)
        buf = ex.buffer(st.halos)
        hc = carry_to_device(health_init(6), len(eng.coords), self.dev)
        self.deg_eta(f"lattice {ONE_MESH}", hh, n_color=eng.p.n_colors,
                     exchange=lambda s: ex.checked(
                         eng._bricks_of(s.m), buf, hc, None, False))

    def deg_eta(self, label, hh, exchange, n_color=None):
        """Measured eta and effective_eta of one run at sync_every SYNC
        under DEG_POLICY with every eighth exchange dropped, the held
        exchanges fed to the meter from the health report: effective eta
        is 7/8 of eta."""
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.obs.timing import EtaMeter, dist_eta_meter
        n_ex = MAIN_SWEEPS // SYNC
        hh.eng.set_exchange_faults([1 if i % 8 == 3 else 0
                                    for i in range(n_ex)])
        cur = hh.start_recorded(hh.init_state(seed=SEED),
                                ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                sync_every=SYNC)
        meter = (EtaMeter(n_color=n_color, sync_every=SYNC)
                 if n_color is not None else
                 dist_eta_meter(hh.eng, sync_every=SYNC)).attach(cur)
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
              f"{label} sync_every={SYNC}: {rep['stale_exchanges']} of "
              f"{n_ex} exchanges held, effective eta = 7/8 of eta")
        hh.eng.set_exchange_faults(None)

    def deg_dist(self):
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
            if prec == "int8":
                eng = hd.eng
                hc = carry_to_device(health_init(self.prob.K), 1, self.dev)
                self.deg_eta(label, hd, exchange=lambda s:
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

    def phase_server(self):
        """(c) repro_torch.serve.SampleServer on the card at L=100."""
        t = self.torch
        from repro_torch.core.partition import brick_partition
        from repro_torch.engines.base import spawn_seeds
        from repro_torch.kernels import _build
        from repro_torch.core.mesh import make_mesh
        from repro_torch.serve import SampleServer
        print(f"== 7c. sampling server: repro_torch.serve.SampleServer at "
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
                     "bitplane_gather_count", "bitplane_gather_count:phase"):
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
        # the jobs again on the warm server
        ids = submit(srv, SERVER_JOBS)
        srv.drain()
        res = [srv.result(j) for j in ids.values()]
        check(all(r["status"] == "done" and r["pool_hit"] for r in res),
              "a warm round: every job done from a pooled engine")

    # -- phase 8: APT+ICM on the G81 shape ----------------------------------

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

    def phase_apt(self):
        """APT+ICM (repro_torch.core.apt_icm) on the G81 shape at full
        width: APT_GOLDEN and the device="cpu" twin with HostDraws, the
        fused colour phase against its plain version at the packed
        shape, the three modes over APT_SWEEPS sweeps with the launches
        counted, packed == lfsr with the card's generator, and one
        adapt_ladder call."""
        t = self.torch
        from repro_torch.core.apt_icm import HostDraws, adapt_ladder
        from repro_torch.core.energy import energy
        from repro_torch.problems.maxcut import cut_of
        g, col = self.g81_ising, self.col81
        N, P, T = g.n, APT_CHAINS, APT_T
        print(f"== 8. APT+ICM on the G81 shape: N={N}, P={P} chains x T={T} "
              f"temperatures, {col.n_colors} colours", flush=True)
        for mode in ("lfsr", "packed"):
            got = {}
            for dev in (None, "cpu"):
                apt = self.apt(mode, dev, HostDraws(APT_DRAW_SEED))
                st, (ts, best) = apt.run(
                    apt.init_state(seed=SEED), APT_GOLDEN_SWEEPS,
                    icm_every=APT_GOLDEN_ICM, record_every=APT_GOLDEN_ICM)
                if dev is None:
                    check(apt.device.type == "cuda" and
                          st.m.device.type == "cuda",
                          f"APT {mode} runs on {apt.device}")
                    if mode == "packed":
                        self.apt_golden_state = st
                got[dev] = self.apt_digest(apt, st, ts, best)
            check(got[None] == APT_GOLDEN,
                  f"APT {mode} on the card with HostDraws({APT_DRAW_SEED}) "
                  f"reproduces APT_GOLDEN: spins, energies and LFSR digests, "
                  f"{APT_GOLDEN['swaps']} swaps, {APT_GOLDEN['icms']} ICMs, "
                  f"best-energy trace {APT_GOLDEN['best']}")
            check(got["cpu"] == got[None],
                  f"APT {mode}: card == device='cpu' twin bitwise over "
                  f"{APT_GOLDEN_SWEEPS} sweeps")
        self.apt_kernel(self.apt_golden_state)
        runs = {mode: self.apt_main(mode) for mode in APT_MODES}
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
        for mode, (apt, st, best) in runs.items():
            spins, e_best = apt.best_config(st)
            cut = cut_of(self.g81, spins)
            E = st.E
            check(tuple(E.shape) == (P, T) and bool(t.isfinite(E).all()) and
                  t.equal(E, energy(g, apt.spins(st))) and
                  cut == (w_tot - e_best) / 2 and best[-1] <= best[0],
                  f"APT {mode}: energies finite (P, T), tracked == direct, "
                  f"best cut {cut:.0f} == (W - E_best) / 2, best energy "
                  f"{best[0]:.0f} -> {best[-1]:.0f}")
        ladder = adapt_ladder(g, col, 1.0, 6.0, T)
        check(len(ladder) == T and bool((np.diff(ladder) > 0).all()) and
              abs(ladder[0] - 1.0) < 1e-9 and abs(ladder[-1] - 6.0) < 1e-9,
              f"adapt_ladder(G81, 1.0, 6.0, {T}) on the card: increasing "
              f"from 1.0 to 6.0")

    def apt_main(self, mode):
        """APT_SWEEPS sweeps with the launch counters at 0 just before;
        returns (engine, state, best trace)."""
        from repro_torch.kernels import _build
        apt = self.apt(mode)
        st0 = apt.init_state(seed=SEED)
        _build.reset_launch_counts()
        st, (_, best) = apt.run(st0, APT_SWEEPS, icm_every=APT_ICM_EVERY,
                                record_every=APT_ICM_EVERY)
        counts = {k: v for k, v in _build.launch_counts.items() if v}
        gathers, fused = self.pop_b7(counts)
        phases = APT_SWEEPS * self.col81.n_colors
        if mode == "packed":
            self.apt_launches = fused
            check(gathers == fused == phases and not counts,
                  f"APT packed: the fused colour-phase kernel launched "
                  f"{fused} times, once per colour phase ({phases}); no "
                  f"other kernel ({counts})")
        else:
            check(gathers == 0 and not counts,
                  f"APT {mode}: plain PyTorch operations, no kernel "
                  f"launched ({counts})")
        return apt, st, best

    def apt_kernel(self, st16):
        """The fused colour phase against its plain version at the packed
        APT shape (K=1, W=4, every colour), bitwise (words, LFSR states,
        energies), from the initial state and from ``st16`` (the golden
        run's state after APT_GOLDEN_SWEEPS sweeps)."""
        from repro_torch.core.bits import u32_to_i64
        from repro_torch.kernels import ops
        from repro_torch.kernels.bitplane_phase import bitplane_phase_apt
        apt = self.apt("packed")
        errs = []
        for label, st in (("initial state", apt.init_state(seed=SEED)),
                          (f"after {APT_GOLDEN_SWEEPS} sweeps", st16)):
            mw, s = st.m, u32_to_i64(st.lfsr)
            E = st.E.reshape(-1).clone()
            for c, sites in enumerate(apt._sites):
                consts = (sites, apt._thr_lanes, apt.f_max, apt._scale_f32)
                errs.append(self.hold_phase(
                    f"APT packed, {label}, colour {c}: W={apt.words}, "
                    f"L={apt.L}, nc={int(sites.idx.shape[1])}, "
                    f"D={int(sites.idx.shape[2])}",
                    lambda m, s_, e, *k: bitplane_phase_apt(m, s_, k[0], k[1],
                                                            k[2], e, k[3]),
                    lambda m, s_, e, *k: ops.bitplane_phase_apt_op(
                        m, s_, k[0], k[1], k[2], e, k[3], impl="ref"),
                    (mw, s, E), consts))
        r = self.results["bitplane_gather_count"]
        r["max_abs_err"] = max([r["max_abs_err"]] + errs)

    # -- phase 9: the static audit on the card's path ----------------------

    def phase_audit(self):
        """``repro_torch.analyze``'s IR audit with every one-process chunk
        on the card (the hand kernels launch; their glue is recorded):
        IR-A, IR-D and IR-E hold there as on the CPU.  The gloo rank
        cases (IR-B, IR-C) are CPU processes, audited by the CPU gate."""
        from repro_torch.analyze.configs import build_audits
        from repro_torch.analyze.findings import Waivers
        from repro_torch.analyze.ir_rules import audit_chunk
        from repro_torch.analyze.runner import DEFAULT_WAIVER_FILE
        print("== 9. static audit: python -m repro_torch.analyze ir on the "
              "card's path", flush=True)
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
              f"findings)")

    def start_example(self, name: str, args=(), timeout=None, env=None):
        """Start ``examples/torch_<name>.py``'s ``main`` in a process of its
        own (``example_child``) with ``timeout`` seconds
        (``EXAMPLES[name]`` by default); ``finish_example`` waits for it."""
        timeout = timeout or EXAMPLES[name]
        root = Path(__file__).resolve().parent
        env = dict(os.environ, **(env or {}))
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root), str(root / "src")] + ([env["PYTHONPATH"]]
                                              if env.get("PYTHONPATH")
                                              else []))
        tmp = tempfile.TemporaryDirectory()
        record = Path(tmp.name) / "record.json"
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; chip_smoke.example_child(*sys.argv[1:])",
             name, str(record), *args],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        return name, proc, tmp, record, time.perf_counter(), timeout

    def finish_example(self, started):
        """Wait for a ``start_example`` process; returns its stdout and its
        record (result and launch counts).  A timeout or a non-zero exit
        fails the phase."""
        name, proc, tmp, record, t0, timeout = started
        with tmp:
            try:
                out, err = proc.communicate(
                    timeout=max(1.0, t0 + timeout - time.perf_counter()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise CheckFailed(f"examples/torch_{name}.py ran past "
                                  f"{timeout} s")
            for line in out.splitlines():
                print(f"  | {line}")
            if proc.returncode != 0:
                print(err[-4000:], file=sys.stderr)
            check(proc.returncode == 0,
                  f"examples/torch_{name}.py exited 0")
            rec = json.loads(record.read_text())
        return out, rec

    def run_example(self, name: str, args=(), timeout=None, env=None):
        """``start_example`` then ``finish_example``."""
        return self.finish_example(
            self.start_example(name, args, timeout, env))

    def phase_examples(self, args=()):
        """The paper's six examples on the port, at the reference's
        defaults, each in its own process (``EXAMPLES``): the longest,
        ``EXAMPLE_BESIDE``, runs beside the other five, one at a time;
        meanwhile this process draws the LM host weights of phases 11 and
        12 (``lm_prefetch``)."""
        print("== 10. the examples (examples/torch_*.py)", flush=True)
        self.lm_prefetch()
        beside = self.start_example(EXAMPLE_BESIDE, args, env=BESIDE_ENV)
        runs = {name: self.run_example(name, args) for name in EXAMPLES
                if name != EXAMPLE_BESIDE}
        runs[EXAMPLE_BESIDE] = self.finish_example(beside)
        self.example_launches, self.example_b7 = {}, {}
        for name in EXAMPLES:
            out, rec = runs[name]
            self.example_launches[name] = {k: rec["launches"][k]
                                           for k in KERNELS}
            self.example_b7[name] = rec["launches"][
                "bitplane_gather_count:phase"]
            getattr(self, f"check_{name}")(out, rec["result"])
        self.hold_examples()

    def hold_examples(self):
        """The kernels at the examples' own shapes, in this process:
        quickstart's three lattice runs (L=10; f32 and int8 R=4, bit-plane
        R=32) and its packed APT+ICM (L=6, 128 lanes in 4 words), and the
        dashboard's eta probe (K=1 bit-plane ``dsim_dist``), each at the
        example's defaults on the card with every kernel launch held to
        its plain version on the same inputs (``held_kernels``); the
        int8 and bit-plane runs also reproduce ``QUICKSTART_GOLDEN``."""
        from repro_torch.kernels import _build
        from repro_torch.obs import eta_probe
        qs, dash = load_example("quickstart"), load_example("serve_dashboard")
        d = {k: v.default for k, v in
             inspect.signature(qs.run).parameters.items()}
        lat = lambda **kw: qs.lattice_run(  # noqa: E731
            d["L"], d["budget"], self.dev, **kw)
        runs = {
            f"quickstart f32 L={d['L']} R={d['R']}":
                lambda: lat(replicas=d["R"]),
            f"quickstart int8 L={d['L']} R={d['R']}":
                lambda: lat(replicas=d["R"], precision="int8"),
            f"quickstart bit-plane L={d['L']} R=32":
                lambda: lat(replicas=32, precision="bitplane"),
            f"quickstart packed APT+ICM L={d['apt_L']}, 128 lanes":
                lambda: qs.apt_run(d["apt_L"], d["apt_sweeps"], self.dev),
            f"dashboard eta probe {dash.ETA_PROBE}":
                lambda: eta_probe(**dash.ETA_PROBE, device=self.dev),
        }
        for label, fn in runs.items():
            before = dict(_build.launch_counts)
            with self.held_kernels() as (tally, covered):
                out = fn()
            launched = {k: v - before[k]
                        for k, v in _build.launch_counts.items()}
            # a count of the LFSR columns' permutations, not of launches:
            # the engine makes them outside the sweeps, where it hands a
            # state in and out
            covered.pop("pbit_bitplane_sweep:lfsr_permute")
            launched.pop("pbit_bitplane_sweep:lfsr_permute")
            check(covered == launched and tally,
                  f"{label}: every launch made within a call held to its "
                  f"plain version (" + ", ".join(
                      f"{k}: {n} calls, largest difference {err}"
                      for k, (n, err) in tally.items()) + "; launches "
                  + ", ".join(f"{k} {n}" for k, n in launched.items()
                              if n and ":" not in k) + ")")
            for k, (_, err) in tally.items():
                r = self.results[k]
                r["max_abs_err"] = max(r["max_abs_err"], err)
            if "int8" in label:
                got = out[2].tolist()
                check(got == QUICKSTART_GOLDEN["int8"],
                      f"{label}: per-replica energies {got} == the JAX "
                      f"reference's")
            if "bit-plane" in label:
                best, flips = float(out[2].min()), out[1].flips
                check(best == QUICKSTART_GOLDEN["bitplane_best"]
                      and flips == QUICKSTART_GOLDEN["bitplane_flips"],
                      f"{label}: best E {best}, {flips:,} lane-flips == "
                      f"the JAX reference's")

    @contextlib.contextmanager
    def held_kernels(self):
        """Within the scope every launch of a lattice kernel or of B7
        (the fused colour phase, on copies of what it updates in place)
        first runs its plain version on the same inputs
        and is held to it: the f32 sweep's LFSR states bitwise and its spins
        bitwise or, where they differ, phase by phase within TANH_ULPS ulp
        of the boundary (``f32_steps``); every other kernel bitwise.
        Yields ({kernel: [calls held, largest difference]}, the launch
        counters' increments made within the held calls, comparisons
        included)."""
        from repro_torch.kernels import (_build, bitplane_phase,
                                         lattice_energy, ops, pbit_bitplane,
                                         pbit_lattice, ref)
        tally, busy, saved = {}, [], []
        covered = dict.fromkeys(_build.launch_counts, 0)

        def hold(mod, attr, key, plain):
            kernel = getattr(mod, attr)

            def held(*args, **kw):
                if busy:             # f32_steps' own launches
                    return kernel(*args, **kw)
                b0 = dict(_build.launch_counts)
                want = plain(*args, **kw)
                got = kernel(*args, **kw)
                seq = isinstance(got, (tuple, list))
                pair = list(zip(got, want)) if seq else [(got, want)]
                if seq and len(got) != len(want):
                    raise CheckFailed(f"{attr}: {len(got)} outputs, its "
                                      f"plain version {len(want)}")
                t = tally.setdefault(key, [0, 0.0])
                what = f"{attr} launch {t[0]}"
                busy.append(1)
                try:
                    if attr == "pbit_brick_sweep":
                        if not self.same(got[1], want[1]):
                            raise CheckFailed(f"{what}: LFSR states differ")
                        if not all(self.same(g, w) for g, w in pair):
                            self.f32_steps(what, args, kw.get("fmt"), got)
                    elif not all(self.same(g, w) for g, w in pair):
                        raise CheckFailed(f"{what} differs from its plain "
                                          f"version")
                finally:
                    busy.pop()
                for k, v in _build.launch_counts.items():
                    covered[k] += v - b0[k]
                t[0] += 1
                t[1] = max([t[1]] + [self.max_abs(g, w) for g, w in pair])
                return got

            saved.append((mod, attr, kernel))
            setattr(mod, attr, held)

        hold(pbit_lattice, "pbit_brick_sweep", "pbit_brick_sweep",
             lambda *a, fmt=None: ref.pbit_brick_sweep_ref(*a, fmt))
        hold(pbit_lattice, "pbit_brick_sweep_int", "pbit_brick_sweep_int",
             ref.pbit_brick_sweep_int_ref)
        hold(pbit_bitplane, "pbit_bitplane_sweep", "pbit_bitplane_sweep",
             ref.pbit_bitplane_sweep_ref)
        hold(pbit_bitplane, "pbit_bitplane_sweep_cm", "pbit_bitplane_sweep",
             lambda *a: ops.pbit_bitplane_sweep_cm_op(*a, impl="ref"))
        hold(lattice_energy, "brick_energy", "brick_energy",
             lambda *a, bx=None: ref.brick_energy_ref(*a))
        hold(lattice_energy, "brick_energy_words", "brick_energy",
             lambda *a, bx=None: ref.brick_energy_words_ref(*a))

        def hold_inplace(attr, mut, plain):
            """The fused colour phases update the arguments at positions
            ``mut`` in place: the plain version runs on copies of them,
            the kernel on the caller's tensors, and those are compared."""
            kernel = getattr(bitplane_phase, attr)

            def held(*args):
                b0 = dict(_build.launch_counts)
                copies = [a.clone() if i in mut else a
                          for i, a in enumerate(args)]
                plain(*copies, impl="ref")
                out = kernel(*args)
                pair = [(args[i], copies[i]) for i in mut]
                t = tally.setdefault("bitplane_gather_count", [0, 0.0])
                if not all(self.same(g, w) for g, w in pair):
                    raise CheckFailed(f"{attr} launch {t[0]} differs from "
                                      f"its plain version")
                for k, v in _build.launch_counts.items():
                    covered[k] += v - b0[k]
                t[0] += 1
                t[1] = max([t[1]] + [self.max_abs(g, w) for g, w in pair])
                return out

            saved.append((bitplane_phase, attr, kernel))
            setattr(bitplane_phase, attr, held)

        hold_inplace("bitplane_phase", (0, 2, 7), ops.bitplane_phase_op)
        hold_inplace("bitplane_phase_apt", (0, 1, 5),
                     ops.bitplane_phase_apt_op)
        try:
            yield tally, covered
        finally:
            for mod, attr, kernel in saved:
                setattr(mod, attr, kernel)

    def check_quickstart(self, out, res):
        lines = out.splitlines()

        def line(prefix):
            hit = [x for x in lines if x.startswith(prefix)]
            check(len(hit) == 1, f"quickstart prints one {prefix!r} line")
            return hit[0]

        int8 = re.search(r"per-replica \[([^\]]*)\]",
                         line("lattice x4 replicas (int8 pipeline"))
        got = [float(v) for v in int8.group(1).split()]
        check(got == QUICKSTART_GOLDEN["int8"],
              f"quickstart int8 per-replica energies {got} == the JAX "
              f"reference's {QUICKSTART_GOLDEN['int8']}")
        bp = re.search(r"best E =\s*(-?[\d.]+) \(([\d,]+) lane-flips\)",
                       line("lattice x32 lanes (bit-plane words"))
        best, flips = float(bp.group(1)), int(bp.group(2).replace(",", ""))
        check(best == QUICKSTART_GOLDEN["bitplane_best"]
              and flips == QUICKSTART_GOLDEN["bitplane_flips"],
              f"quickstart bit-plane best E {best}, {flips:,} lane-flips == "
              f"the JAX reference's {QUICKSTART_GOLDEN['bitplane_best']}, "
              f"{QUICKSTART_GOLDEN['bitplane_flips']:,}")
        f32 = re.search(r"per-replica \[([^\]]*)\]",
                        line("lattice x4 replicas (fused kernel)"))
        print(f"  f32 lattice per-replica energies (not gated: f32 holds "
              f"to tanh ties; its kernel launches are held to the plain "
              f"version by hold_examples) [{f32.group(1)}]")
        check("coloring: 2 colors" in out
              and "C_max = 6.2, eta threshold = 2*N_color*C_max = 25" in out,
              "quickstart: 2 colours, C_max 6.2, eta threshold 25")
        want = ("pbit_brick_sweep_int", "pbit_bitplane_sweep",
                "pbit_brick_sweep", "brick_energy", "bitplane_gather_count")
        got = self.example_launches["quickstart"]
        b7 = self.example_b7["quickstart"]
        check(all(got[k] > 0 for k in want)
              and b7 == got["bitplane_gather_count"],
              "quickstart launched #1, #2, #3, #4 and B7 as the fused "
              "colour phase (packed APT): "
              + ", ".join(f"{k} {got[k]}" for k in want)
              + f", the fused colour phase {b7}")

    def check_sat3_invertible(self, out, res):
        m = re.search(r"^best: (\d+)/(\d+) ", out, re.M)
        best, m_cl = int(m.group(1)), int(m.group(2))
        check(best >= 0.9 * m_cl,
              f"sat3: best {best}/{m_cl} satisfied >= 90%")

    def check_maxcut_gset(self, out, res):
        cuts = re.findall(r"^trial \d+: cut = (\d+) ", out, re.M)
        check(len(cuts) == 5, f"maxcut: a cut for each of 5 trials {cuts}")
        lines = out.splitlines()
        at = lines.index("verification hex (paper S9 format):")
        check(re.fullmatch(r"[0-9A-F]+\.\.\.", lines[at + 1]) is not None,
              f"maxcut: the hex line {lines[at + 1][:40]}")

    def check_eta_sweep(self, out, res):
        mono = re.findall(r"^\s+mono\s+(\S+)", out, re.M)
        rows = re.findall(r"^\s*(\d+)\s+(\S+)\s+(\S+)$", out, re.M)
        vals = [float(mono[0])] + [float(v) for r in rows for v in r[1:]] \
            if mono else []
        check(len(mono) == 1 and [int(r[0]) for r in rows] == [1, 8, 64, 256]
              and all(math.isfinite(v) for v in vals),
              "eta_sweep: the mono row and the S = 1, 8, 64, 256 rows, "
              "every kappa finite")
        kd = {int(r[0]): float(r[1]) for r in rows}
        print("  eta_sweep kappa_DSIM (not gated; statistical): " + ", ".join(
            f"S={s} {kd[s]:.3f} (reference on the CPU {k:.3f})"
            for s, k in ETA_REFERENCE_KAPPA.items()))

    def check_serve_sampling(self, out, res):
        verdicts = re.findall(r"bitwise == uninterrupted run: (\w+)", out)
        check(verdicts == ["True", "True"] and res["recovered_bitwise"],
              "serve_sampling: both recovered jobs bitwise-identical to "
              "their uninterrupted runs")

    def check_serve_dashboard(self, out, res):
        m = re.search(r"(\d+) detection\(s\), (\d+)/(\d+) held", out)
        check(m is not None and int(m.group(1)) >= 1
              and int(m.group(2)) >= 1,
              f"serve_dashboard: the degraded job "
              f"{m.group(0) if m else 'missing'}")
        head = out.split("-- Prometheus exposition (head) --", 1)
        check(len(head) == 2 and head[1].strip() != "",
              "serve_dashboard: the Prometheus head is not empty")
        n = self.example_launches["serve_dashboard"]["bitplane_gather_count"]
        b7 = self.example_b7["serve_dashboard"]
        check(n > 0 and b7 == n,
              f"serve_dashboard's eta probe launched B7 {n} times, as the "
              f"fused colour phase ({b7})")

    # -- phase 11: LM serving ------------------------------------------------

    def phase_lm(self):
        """LM serving through ``repro_torch.configs``, ``build_model`` and
        ``serve_step`` (``LM_*``): the reduced golden runs, then
        h2o-danube-1.8b and mamba2-370m at full width, then the serve_lm
        example; none of the seven hand kernels may launch."""
        from repro_torch.kernels import _build
        print("== 11. LM serving (repro_torch.models, serve.serve_step)",
              flush=True)
        _build.reset_launch_counts()
        self.lm_fit()
        self.lm_golden()
        self.lm_danube()
        self.lm_mamba2()
        ex = self.lm_example()
        launched = {k: v for k, v in _build.launch_counts.items() if v}
        check(not launched and not ex,
              f"phase 11 launched none of the seven hand kernels (this "
              f"process {launched or 'none'}, the example "
              f"{ex or 'none'})")

    def lm_fit(self):
        """Each LM config's parameters at full width and whether its bf16
        weights fit the card's memory (weights only: no cache, no
        activations)."""
        t = self.torch
        from repro_torch.configs import list_configs
        total = t.cuda.get_device_properties(0).total_memory
        for name, cfg in list_configs().items():
            if cfg.family == "ising":
                continue
            n = lm_param_count(cfg)
            print(f"  {name}: {n:,} parameters, {2 * n / 1e9:.2f} GB in "
                  f"bf16: {'fits' if 2 * n < total else 'does not fit'} "
                  f"the card's {total / 1e9:.1f} GB", flush=True)

    def lm_golden(self):
        """(a) LM_GOLDEN on the card at reduced widths (f32), and the same
        runs on the CPU in this process."""
        t = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models.lm import build_model
        from repro_torch.serve.serve_step import (cache_len_for,
                                                  greedy_generate,
                                                  make_prefill_step)
        B, S = LM_PROMPT
        for name in LM_GOLDEN_ARCHS:
            cfg = get_config(name).reduced()
            s_max = S + LM_MAX_NEW
            s_max = s_max if cfg.encdec else cache_len_for(cfg, s_max)
            got = []
            for dev in (self.dev, t.device("cpu")):
                model = build_model(cfg, dev)
                params = model.init(LM_SEED)
                batch = {k: t.from_numpy(v).to(dev)
                         for k, v in lm_prompt(cfg).items()}
                toks = greedy_generate(model, cfg, params, batch, LM_MAX_NEW,
                                       device=dev)
                with t.no_grad():
                    logits, _, _ = make_prefill_step(model, cfg)(
                        params, batch, model.init_cache(B, s_max,
                                                        dtype=t.float32))
                got.append((toks.cpu().numpy(), logits[:, -1].cpu().numpy()))
            (toks, logits), cpu = got
            gold, mine = LM_GOLDEN[name], lm_digest(toks, logits)
            scale = max(gold["absmax"])
            err = max(abs(a - b) for ra, rb in zip(mine["logits_at"],
                                                   gold["logits_at"])
                      for a, b in zip(ra, rb))
            err = max([err] + [abs(a - b) for a, b in
                               zip(mine["absmax"], gold["absmax"])])
            l2 = max(abs(a - b) / b for a, b in zip(mine["l2"], gold["l2"]))
            check(mine["tokens"] == gold["tokens"]
                  and err <= LM_LOGIT_TOL * scale and l2 <= LM_LOGIT_TOL,
                  f"{name} reduced, f32, on the card: {B}x{LM_MAX_NEW} greedy "
                  f"tokens == the JAX reference's; prefill logits within "
                  f"{err / scale:.2e} of their largest magnitude, L2 norm "
                  f"within {l2:.2e} (limit {LM_LOGIT_TOL})")
            cpu_err = float(np.abs(cpu[1] - logits).max()) / scale
            check(np.array_equal(cpu[0], toks)
                  and cpu_err <= LM_LOGIT_TOL,
                  f"{name}: the same run with device='cpu' gives the card's "
                  f"tokens, every logit within {cpu_err:.2e}")

    def lm_prefetch(self):
        """Draw the host weights of LM_FULL (``lm_host``) and phase 12's
        Markov table on a thread of this process, while phase 10's
        examples run in theirs (numpy fills release the GIL)."""
        import threading

        def draw():
            for name in LM_FULL:
                self.lm_host(name)
            self.train_data()
        self._lm_draw = threading.Thread(target=draw, daemon=True)
        self._lm_draw.start()

    def lm_host(self, name):
        """``name``'s f32 weights at its published widths, ``init(LM_SEED)``
        drawn on the host once for phases 11 and 12 (the card's ``init``
        draws the same numbers on the host and copies them over)."""
        from repro_torch.configs import get_config
        from repro_torch.models.lm import build_model
        import threading
        draw = self.__dict__.get("_lm_draw")
        if draw is not None and draw is not threading.current_thread():
            draw.join()
        cache = self.__dict__.setdefault("lm_host_params", {})
        if name not in cache:
            cfg = dataclasses.replace(get_config(name), dtype="float32")
            cache[name] = build_model(cfg, "cpu").init(LM_SEED)
            print(f"  {name}: init(LM_SEED) drawn on the host (kept for "
                  f"phases 11 and 12)", flush=True)
        return cache[name]

    def lm_full(self, name, dtype):
        """``name`` at its published widths and depth in ``dtype`` on the
        card: (model, params); f32 weights are the host draw copied over,
        others that cast as ``init`` casts (``lm_cast``)."""
        t = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models.lm import build_model
        from repro_torch.train.tree import tree_map
        cfg = dataclasses.replace(get_config(name), dtype=dtype)
        model = build_model(cfg)
        host = self.lm_host(name)
        params = tree_map(lambda x: x.to(self.dev), host)
        if dtype != "float32":
            params = self.lm_cast(params, getattr(t, dtype))
        n, byts = self.lm_size(params)
        print(f"  {name}: {cfg.n_layers} layers, d={cfg.d_model}, "
              f"{n:,} parameters, {byts / 1e9:.3f} GB in {dtype}",
              flush=True)
        return model, params

    def lm_size(self, tree):
        from repro_torch.train.tree import tree_leaves
        leaves = tree_leaves(tree)
        return (sum(x.numel() for x in leaves),
                sum(x.numel() * x.element_size() for x in leaves))

    def lm_decode_vs_forward(self, label, model, params, B, S, smax, steps):
        """The reference's invariant (tests/test_models.py): prefill
        S - steps tokens into an f32 ``init_cache(B, smax)``, decode the
        rest one at a time, and hold the last logits to the full
        forward's last position."""
        t = self.torch
        cfg = model.cfg
        rng = np.random.default_rng(LM_SEED + S)
        toks = t.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)).to(self.dev)
        with t.no_grad():
            full, _, _ = model.forward(params, toks)
            want = full[:, -1].clone()
            del full
            caches = model.init_cache(B, smax, dtype=t.float32)
            _, c, _ = model.forward(params, toks[:, :S - steps], caches=caches)
            for i in range(S - steps, S):
                last, c, _ = model.forward(params, toks[:, i:i + 1], caches=c)
        got = last[:, 0]
        rel = float((got - want).abs().max()) / float(want.abs().max())
        check(bool(t.isfinite(got).all()) and rel < LM_REL_TOL,
              f"{label}: relative difference {rel:.3e} (bound "
              f"{LM_REL_TOL})")

    def lm_danube(self):
        """(b) h2o-danube-1.8b at full width in f32: decode == forward and
        the rolling ring at its full window; (c) the same weights cast
        to bf16, serving."""
        t = self.torch
        name = "h2o-danube-1.8b"
        model, params = self.lm_full(name, "float32")
        cfg = model.cfg
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.d_head, cfg.d_ff, cfg.vocab, cfg.window)
              == (24, 2560, 32, 8, 80, 6912, 32000, 4096),
              f"{name} at its published widths (24 layers, d=2560, 32 "
              f"heads, 8 KV heads of 80, d_ff 6912, vocab 32000, window "
              f"4096)")
        t.cuda.reset_peak_memory_stats()
        self.lm_decode_vs_forward(f"{name} f32 decode == forward (B=2, "
                                  f"S=128)", model, params, 2, 128, 136, 1)
        self.lm_decode_vs_forward(
            f"{name} f32 rolling ring at the full window (B=1, S=5120: the "
            f"chunked forward; 5116 tokens prefilled into {cfg.window} "
            f"slots, 4 decode steps)", model, params, 1, 5120, cfg.window, 4)
        peak = t.cuda.max_memory_allocated() / 1e9
        print(f"  {name} f32 checks: peak {peak:.2f} GB allocated",
              flush=True)
        params16 = self.lm_cast(params, t.bfloat16)
        del params
        t.cuda.empty_cache()
        self.lm_serve(name, params16)

    def lm_serve(self, name, params):
        """(c)/(d) ``greedy_generate`` at LM_SERVE on the bf16 ``params``
        of ``name`` (its published dtype), with bf16 caches: the tokens'
        shape and range, and the peak memory."""
        t = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models.lm import build_model
        from repro_torch.serve.serve_step import greedy_generate
        cfg = get_config(name)
        model = build_model(cfg)
        B, P, M = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["max_new"]
        rng = np.random.default_rng(LM_SEED + 1)
        batch = {"tokens": t.from_numpy(rng.integers(
            0, cfg.vocab, (B, P)).astype(np.int32)).to(self.dev)}
        t.cuda.reset_peak_memory_stats()
        out = greedy_generate(model, cfg, params, batch, M,
                              cache_dtype=t.bfloat16).cpu()
        peak = t.cuda.max_memory_allocated()
        check(tuple(out.shape) == (B, M) and int(out.min()) >= 0
              and int(out.max()) < cfg.vocab_padded,
              f"{name} bf16 greedy_generate: {B} requests of {P} prompt "
              f"tokens, {M} new tokens each; peak {peak / 1e9:.2f} GB "
              f"allocated")

    def lm_mamba2(self):
        """(d) mamba2-370m at full width: f32 decode == forward and the
        SSD's chunk invariance (its first layer, B=2, S=512, chunks 64,
        128 and 256); then bf16 serving as (c)."""
        t = self.torch
        from repro_torch.models.mamba2 import mamba2_fwd
        name = "mamba2-370m"
        model, params = self.lm_full(name, "float32")
        cfg = model.cfg
        d_inner = 2 * cfg.d_model
        check((cfg.n_layers, cfg.d_model, cfg.ssm_state,
               d_inner // cfg.ssm_headdim, cfg.ssm_headdim, cfg.vocab_padded)
              == (48, 1024, 128, 32, 64, 50304),
              f"{name} at its published widths (48 SSD layers, d=1024, "
              f"d_state 128, 32 heads of 64, vocab 50280 padded to 50304)")
        self.lm_decode_vs_forward(f"{name} f32 decode == forward (B=2, "
                                  f"S=128)", model, params, 2, 128, 136, 1)
        p0 = params["groups"][0][0]["mamba"]
        x = t.from_numpy(np.random.default_rng(LM_SEED).standard_normal(
            (2, 512, cfg.d_model)).astype(np.float32)).to(self.dev)
        with t.no_grad():
            ys = {c: mamba2_fwd(p0, x, d_state=cfg.ssm_state,
                                headdim=cfg.ssm_headdim, chunk=c)[0]
                  for c in (64, 128, 256)}
        worst = max(float(((ys[c] - ys[64]).abs() - LM_CHUNK_TOL
                           * (1 + ys[64].abs())).max()) for c in (128, 256))
        diff = max(float((ys[c] - ys[64]).abs().max()) for c in (128, 256))
        check(worst <= 0,
              f"{name} SSD chunk invariance at full width (layer 0, B=2, "
              f"S=512, chunk 64 vs 128 and 256): largest difference "
              f"{diff:.3e} within rtol = atol = {LM_CHUNK_TOL}")
        params16 = self.lm_cast(params, t.bfloat16)
        del params, p0, ys
        t.cuda.empty_cache()
        self.lm_serve(name, params16)

    def lm_example(self) -> dict:
        """(e) examples/torch_serve_lm.py at its defaults in a process of
        its own; returns the kernels it launched."""
        out, rec = self.run_example("serve_lm",
                                    timeout=EXAMPLE_SERVE_LM_TIMEOUT)
        res = rec["result"]
        lines = [x for x in out.splitlines() if "reduced config" in x]
        check(len(lines) == 4 and all(v["shape"] == [4, 16]
                                      for v in res.values()),
              f"examples/torch_serve_lm.py: one line per architecture, "
              f"(4, 16) tokens each: " + ", ".join(res))
        return {k: v for k, v in rec["launches"].items() if v}

    def lm_cast(self, tree, dtype, key=None):
        """An f32 parameter tree as ``init`` builds it at ``dtype``: every
        leaf cast, but the leaves the reference keeps in f32 (the MoE
        router, Mamba-2's A_log, D and dt_bias)."""
        if isinstance(tree, dict):
            return {k: self.lm_cast(v, dtype, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.lm_cast(v, dtype) for v in tree)
        return tree if key in ("router", "A_log", "D", "dt_bias") \
            else tree.to(dtype)

    # -- phase 12: LM training -----------------------------------------------

    def phase_train(self, card: str):
        """LM training through ``repro_torch.train``, ``sharding`` and
        ``launch.train``: TRAIN_GOLDEN at reduced widths, h2o-danube-1.8b
        at full width in f32 (grad_accum, remat), then in bf16 with its
        checkpoint, mamba2-370m in bf16, local SGD and the EF all-reduce,
        the train_lm example; none of the seven hand kernels may launch."""
        t = self.torch
        from repro_torch.kernels import _build
        print("== 12. LM training (repro_torch.train, launch.train)",
              flush=True)
        _build.reset_launch_counts()
        # (g)'s first run, in its own process beside (a) and (b)
        tmp = tempfile.TemporaryDirectory()
        child = self.start_example(
            "train_lm", timeout=EXAMPLE_TRAIN_LM_TIMEOUT,
            env={"TMPDIR": tmp.name, **BESIDE_ENV})
        try:
            self.train_golden()
            self.train_checks(card)
            ex = self.train_example(child, tmp.name)
        finally:
            if child[1].poll() is None:
                child[1].kill()
                child[1].wait()
            tmp.cleanup()
        run = self.train_bf16("h2o-danube-1.8b")
        self.train_checkpoint(*run)
        del run
        t.cuda.empty_cache()
        self.train_bf16("mamba2-370m")
        self.__dict__.pop("lm_host_params", None)
        t.cuda.empty_cache()
        self.train_local_sgd()
        launched = {k: v for k, v in _build.launch_counts.items() if v}
        check(not launched and not ex,
              f"phase 12 launched none of the seven hand kernels (this "
              f"process {launched or 'none'}, the example runs "
              f"{ex or 'none'})")

    def train_data(self):
        """MarkovLM(TRAIN_DATA_VOCAB, seed=1), built once (by
        ``lm_prefetch``'s thread in the whole script)."""
        import threading
        draw = self.__dict__.get("_lm_draw")
        if draw is not None and draw is not threading.current_thread():
            draw.join()
        if "_train_data" not in self.__dict__:
            from repro_torch.train.data import MarkovLM
            self._train_data = MarkovLM(TRAIN_DATA_VOCAB, seed=1)
        return self._train_data

    def on_card(self, b, dev=None):
        t = self.torch
        return {k: t.from_numpy(np.asarray(v)).to(dev or self.dev)
                for k, v in b.items()}

    def train_golden(self):
        """(a) TRAIN_GOLDEN on the card at reduced widths (f32), and each
        of its steps taken again on the CPU from the card's state before
        it (a CPU twin per step: four chained steps amplify rounding, and
        jamba's fourth moves 2.4e-5 when its weights move by an ulp,
        tests/test_torch_train.py)."""
        t = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models.lm import build_model
        from repro_torch.train.optimizer import AdamW
        from repro_torch.train.train_step import TrainState, make_train_step
        from repro_torch.train.tree import tree_map
        rel = lambda a, b: max(abs(x - y) / abs(y)  # noqa: E731
                               for x, y in zip(a, b))
        cpu = t.device("cpu")
        for name, int8 in TRAIN_RUNS:
            cfg = get_config(name).reduced()
            key = train_key(name, int8)
            opt = AdamW(lr=TRAIN_LR, warmup=TRAIN_WARMUP, int8_state=int8)
            model = build_model(cfg, self.dev)
            twin = build_model(cfg, cpu)
            params = model.init(LM_SEED)
            state = TrainState(params, opt.init(params))
            step, twin_step = make_train_step(model, opt), \
                make_train_step(twin, opt)
            got = {"card": [], "twin": []}
            for b in train_batches(cfg):
                before = tree_map(lambda x: x.to(cpu), state)
                state, m = step(state, self.on_card(b))
                got["card"].append((float(m["loss"]), float(m["grad_norm"])))
                _, m = twin_step(before, self.on_card(b, cpu))
                got["twin"].append((float(m["loss"]), float(m["grad_norm"])))
            col = lambda tag, i: [x[i] for x in got[tag]]  # noqa: E731
            gold = TRAIN_GOLDEN[key]
            err = max(rel(col("card", 0), gold["loss"]),
                      rel(col("card", 1), gold["grad_norm"]))
            twin_err = max(rel(col("card", i), col("twin", i))
                           for i in (0, 1))
            check(err <= TRAIN_GOLDEN_RTOL,
                  f"{key} reduced, f32, on the card: {TRAIN_STEPS} steps' "
                  f"loss and gradient norm within {err:.2e} relative of "
                  f"the JAX reference's (limit {TRAIN_GOLDEN_RTOL}; losses "
                  + ", ".join(f"{x:.6f}" for x in col("card", 0)) + ")")
            check(twin_err <= TRAIN_CPU_RTOL,
                  f"{key}: each step on the CPU from the card's state "
                  f"within {twin_err:.2e} relative (limit {TRAIN_CPU_RTOL})")

    def grads(self, model, params, batch):
        """(loss, gradient leaves, peak bytes) of ``model.loss`` with
        ``train=True``."""
        t = self.torch
        from repro_torch.train.tree import tree_flatten
        leaves, unflatten = tree_flatten(params)
        xs = [p.detach().requires_grad_() for p in leaves]
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        loss = model.loss(unflatten(xs), batch, train=True)
        g = t.autograd.grad(loss, xs)
        t.cuda.synchronize()
        return loss.detach(), g, t.cuda.max_memory_allocated()

    def train_checks(self, card: str):
        """(b) h2o-danube-1.8b at its published widths in f32, B x S of
        TRAIN_CHECK: one step with grad_accum=2 against grad_accum=1
        (AdamW(lr=1e-3, warmup=1), the reference's case), and the
        gradients with remat on against remat off."""
        t = self.torch
        from repro_torch.models.lm import build_model
        from repro_torch.train.optimizer import AdamW
        from repro_torch.train.train_step import TrainState, make_train_step
        from repro_torch.train.tree import tree_leaves
        name = "h2o-danube-1.8b"
        model, params = self.lm_full(name, "float32")
        cfg = model.cfg
        B, S = TRAIN_CHECK["batch"], TRAIN_CHECK["seq"]
        toks = self.train_data().sample(B, S)
        batch = self.on_card({"tokens": toks, "targets": toks,
                              "mask": np.ones_like(toks)})
        opt = AdamW(lr=1e-3, warmup=1)
        b2 = {k: v.reshape(2, B // 2, S) for k, v in batch.items()}
        runs = []
        for accum, b in ((1, batch), (2, b2)):
            t.cuda.synchronize()
            t.cuda.reset_peak_memory_stats()
            st, m = make_train_step(model, opt, grad_accum=accum)(
                TrainState(params, opt.init(params)), b)
            t.cuda.synchronize()
            runs.append((float(m["loss"]), t.cuda.max_memory_allocated()))
            # after one step from zero moments m = 0.1 g, the clipped
            # gradient; the first run's waits on the host
            pm = list(zip(tree_leaves(st.params), tree_leaves(st.opt.m)))
            if accum == 1:
                first = [(a.cpu(), g.cpu()) for a, g in pm]
                pm = None
            del st, m
        (l1, pk1), (l2, pk2) = runs
        scale = max(float(g.abs().max()) for _, g in first)
        dm = dp = dp_all = 0.0
        loose = 0
        for (a, ga), (b, gb) in zip(first, pm):
            a, ga = a.to(self.dev), ga.to(self.dev)
            dm = max(dm, float((ga - gb).abs().max()))
            d = (a - b).abs()
            sure = (ga.abs() >= ACCUM_SURE_M) & (gb.abs() >= ACCUM_SURE_M)
            dp_all = max(dp_all, float(d.max()))
            dp = max(dp, float(t.where(sure, d, 0).max()))
            loose += int(((d >= ACCUM_PARAM_TOL) & ~sure).sum())
        del first, pm, a, b, ga, gb, d, sure
        check(abs(l1 - l2) < ACCUM_LOSS_TOL and dm <= ACCUM_GRAD_TOL * scale
              and dp < ACCUM_PARAM_TOL,
              f"{name} f32 at full width, B={B} x S={S}: grad_accum=2 == "
              f"grad_accum=1 through one AdamW step: loss {l1:.6f} vs "
              f"{l2:.6f} (difference {abs(l1 - l2):.2e} < {ACCUM_LOSS_TOL}), "
              f"clipped gradients within {dm / scale:.2e} of their largest "
              f"magnitude (limit {ACCUM_GRAD_TOL}), parameters within "
              f"{dp:.2e} < {ACCUM_PARAM_TOL} wherever the gradient is at "
              f"least {10 * ACCUM_SURE_M:.0e} in both runs (there Adam's "
              f"first update g / (|g| + eps) is within 1% of sign(g)); "
              f"over all {self.lm_size(params)[0]:,} parameters within "
              f"{dp_all:.2e}, {loose:,} of them beyond {ACCUM_PARAM_TOL}, "
              f"all where |g| < {10 * ACCUM_SURE_M:.0e}; peak "
              f"{pk1 / 1e9:.2f} and {pk2 / 1e9:.2f} GB allocated, on {card}")
        t.cuda.empty_cache()
        lon, gon, pkon = self.grads(model, params, batch)
        loff, goff, pkoff = self.grads(
            build_model(dataclasses.replace(cfg, remat=False)), params,
            batch)
        scale = max(float(g.abs().max()) for g in gon)
        diff = max(float((a - b).abs().max()) for a, b in zip(gon, goff))
        check(cfg.remat and diff <= REMAT_TOL * scale,
              f"{name} f32 at full width: gradients with remat on within "
              f"{diff / scale:.2e} of their largest magnitude of remat off "
              f"(limit {REMAT_TOL}; loss {float(lon):.6f} and "
              f"{float(loff):.6f}); peak {pkon / 1e9:.2f} GB allocated "
              f"with remat, {pkoff / 1e9:.2f} GB without, on {card}")
        del gon, goff, params
        t.cuda.empty_cache()

    def train_bf16(self, name: str):
        """(c)/(d) ``name`` at its published widths in bf16, f32 AdamW
        moments, remat on: TRAIN_TIMED_STEPS finite steps after a first on
        MarkovLM(TRAIN_DATA_VOCAB) batches through ``prefetch`` (a host
        read of the loss per step, as the launcher's), and one more; then
        TRAIN_INT8_STEPS steps with int8 moments on the weights it
        reached.  Returns (step, state, batch) of the int8 run."""
        t = self.torch
        from repro_torch.train.data import prefetch
        from repro_torch.train.optimizer import AdamW
        from repro_torch.train.train_step import TrainState, make_train_step
        from repro_torch.train.tree import tree_leaves
        B, S = TRAIN_TIMED[name]["batch"], TRAIN_TIMED[name]["seq"]
        model, params = self.lm_full(name, "bfloat16")
        cfg = model.cfg
        n = sum(x.numel() for x in tree_leaves(params))
        opt = AdamW()
        state = TrainState(params, opt.init(params))
        f32_opt = self.lm_size(state.opt)[1]
        del params
        step = make_train_step(model, opt)
        it = prefetch(self.train_data().batches(B, S), depth=2)
        state, m = step(state, self.on_card(next(it)))
        losses = []
        for _ in range(TRAIN_TIMED_STEPS):
            state, m = step(state, self.on_card(next(it)))
            losses.append(float(m["loss"]))
        check(all(math.isfinite(x) for x in losses),
              f"{name} bf16 at its published widths ({cfg.n_layers} "
              f"layers, d={cfg.d_model}, {n:,} parameters), f32 AdamW "
              f"moments, remat: {TRAIN_TIMED_STEPS} finite steps at B={B} x "
              f"S={S} (one card's cut of the train_4k cell's global batch "
              f"of 256), losses " + ", ".join(f"{x:.4f}" for x in losses))
        params = step(state, self.on_card(next(it)))[0].params
        del state
        t.cuda.empty_cache()
        opt8 = AdamW(int8_state=True)
        st8 = TrainState(params, opt8.init(params))
        del params
        step8 = make_train_step(model, opt8)
        loss8 = []
        for _ in range(TRAIN_INT8_STEPS):
            st8, m = step8(st8, self.on_card(next(it)))
            loss8.append(float(m["loss"]))
        byts = self.lm_size(st8.opt)[1]
        check(all(math.isfinite(x) for x in loss8),
              f"{name}: {TRAIN_INT8_STEPS} steps with AdamW(int8_state=True) "
              f"on the same weights, losses " + ", ".join(
                  f"{x:.4f}" for x in loss8) + f"; optimizer state "
              f"{byts / n:.4f} B per parameter read from its tensors "
              f"(f32 moments {f32_opt / n:.4f})")
        return step8, st8, self.on_card(next(it))

    def train_checkpoint(self, step, state, batch):
        """(e) ``checkpoint.save(blocking=False)`` of (c)'s int8 state,
        ``wait_pending``, ``restore`` into a fresh template: bitwise; then
        one further step from each, with deterministic algorithms: the
        same loss and state bitwise."""
        t = self.torch
        import shutil
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train.tree import tree_leaves, tree_map
        k = int(state.opt.step)
        with tempfile.TemporaryDirectory() as d:
            free = shutil.disk_usage(d).free
            ckpt.save(d, k, state, meta={"phase": 12}, blocking=False)
            ckpt.wait_pending()
            restored = ckpt.restore(d, tree_map(t.empty_like, state))
            on_disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                          if f.is_file())
        pairs = list(zip(tree_leaves(state), tree_leaves(restored)))
        same = all(a.dtype == b.dtype and a.device == b.device
                   and self.same(a, b) for a, b in pairs)
        check(same,
              f"checkpoint of the h2o-danube-1.8b int8 state at step {k} "
              f"({len(pairs)} tensors, {on_disk / 1e9:.3f} GB on disk of "
              f"{free / 1e9:.0f} GB free): save(blocking=False), "
              f"wait_pending, restore; restored == saved bitwise")
        t.use_deterministic_algorithms(True, warn_only=True)
        try:
            a, ma = step(state, batch)
            del state
            b, mb = step(restored, batch)
        finally:
            t.use_deterministic_algorithms(False)
        same = float(ma["loss"]) == float(mb["loss"]) and all(
            self.same(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
        check(same, f"one further step from the restored state == one "
                    f"from the live state bitwise (loss "
                    f"{float(ma['loss']):.6f}; deterministic algorithms)")

    def train_local_sgd(self):
        """(f) local SGD with SGD_RUN's replicas in one process on the card
        against its device='cpu' twin (losses within SGD_RTOL, the
        replicas equal after each sync), and the EF all-reduce's mean
        (tests/test_dist.py's check)."""
        t = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core.mesh import make_mesh
        from repro_torch.models.lm import build_model
        from repro_torch.train.compression import make_ef_allreduce
        from repro_torch.train.data import MarkovLM
        from repro_torch.train.optimizer import AdamW
        from repro_torch.train.train_step import (TrainState,
                                                  make_local_sgd_step)
        from repro_torch.train.tree import tree_leaves
        r = SGD_RUN
        R, sync, B, S = r["replicas"], r["sync_every"], r["batch"], r["seq"]
        cfg = get_config(r["name"]).reduced()
        runs = []
        for dev in (self.dev, t.device("cpu")):
            model = build_model(cfg, dev)
            params = model.init(LM_SEED)
            opt = AdamW(lr=3e-3, warmup=5)
            outer, repl = make_local_sgd_step(
                model, opt, make_mesh((R,), ("data",)), "data",
                sync_every=sync)
            st = repl(TrainState(params, opt.init(params)))
            data = MarkovLM(cfg.vocab, seed=2)
            losses, synced = [], True
            for _ in range(r["outer"]):
                tk = data.sample(R * sync * B, S).reshape(R, sync, B, S)
                st, m = outer(st, self.on_card(
                    {"tokens": tk, "targets": tk, "mask": np.ones_like(tk)},
                    dev))
                losses.append(float(m["loss"]))
                synced &= all(self.same(x[0], x[j])
                              for x in tree_leaves(st.params)
                              for j in range(1, R))
            runs.append((losses, synced))
        (loss, synced), (cpu, cpu_synced) = runs
        err = max(abs(a - b) / abs(b) for a, b in zip(loss, cpu))
        check(synced and cpu_synced and err <= SGD_RTOL,
              f"local SGD, {cfg.name} reduced, R={R} replicas in one "
              f"process on the card, sync_every={sync}, {r['outer']} outer "
              f"steps: the replicas equal after every sync, losses "
              + ", ".join(f"{x:.6f}" for x in loss) + f" within {err:.2e} "
              f"of the device='cpu' twin's (limit {SGD_RTOL})")
        ef = make_ef_allreduce(make_mesh((4,), ("data",)))
        g = {"w": t.stack([t.full((256,), float(i), device=self.dev)
                           for i in range(4)])}
        avg, _ = ef(g, {"w": t.zeros_like(g["w"])})
        dev = float((avg["w"] - 1.5).abs().max())
        check(dev < 0.05, f"EF int8 all-reduce of rows 0..3 on the card: "
                          f"every replica's mean within {dev:.2e} of 1.5")

    def train_example(self, child, tmp: str) -> dict:
        """(g) examples/torch_train_lm.py at its defaults in a process of
        its own (``child``, started with TMPDIR ``tmp``, a fresh
        directory, so its checkpoints start there), then its ``main``
        again in this process to 140 steps: it resumes at step 120.
        Returns the kernels the child launched (this process's launches
        are counted with the phase's)."""
        out, rec = self.finish_example(child)
        losses = rec["result"]["losses"]
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        check(len(losses) == 120 and last < first and "final loss" in out,
              f"examples/torch_train_lm.py at its defaults (mamba2-370m "
              f"reduced, 120 steps, beside (a) and (b)): final loss "
              f"{last:.4f} < start {first:.4f}")
        args = ["--arch", "mamba2-370m", "--reduced", "--steps", "140",
                "--batch", "8", "--seq", "64", "--ckpt",
                os.path.join(tmp, "repro_torch_ck"), "--ckpt-every", "60"]
        out2 = io.StringIO()
        with contextlib.redirect_stdout(out2):
            res = load_example("train_lm").main(args)
        for line in out2.getvalue().splitlines():
            print(f"  | {line}")
        check(res["start_step"] == 120 and len(res["losses"]) == 20
              and "restored checkpoint at step 120" in out2.getvalue()
              and all(math.isfinite(x) for x in res["losses"]),
              f"a second invocation (in this process) to 140 steps resumed "
              f"from the checkpoint at step 120 and took 20 finite steps")
        return {k: v for k, v in rec["launches"].items() if v}

    # -- phase 14: the dry run --------------------------------------------

    def phase_dryrun(self):
        """#3 at the dry run's bricks (``dryrun_bricks``), then the dry run
        itself as two subprocesses on the card, started together: ``--all``
        (rank 17 of both meshes) and rank 255 of 16x16, each record checked
        against the reference's wire bytes, extras and mesh size, its
        launches and its reading against the bound the record holds."""
        print("== 13. the dry run (python -m repro_torch.launch.dryrun)",
              flush=True)
        self.dryrun_bricks()
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(root / "src") + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        runs = {"all": ["--all"],
                "padding": ["--arch", "ea3d-1m", "--rank",
                            str(DRYRUN_PADDING["rank"])]}
        self.dryrun_launches = {k: 0 for k in KERNELS}
        with tempfile.TemporaryDirectory() as tmp:
            procs = {k: subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *a,
                 "--report-dir", os.path.join(tmp, k)], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for k, a in runs.items()}
            t0 = time.perf_counter()
            for k, proc in procs.items():
                try:
                    out, err = proc.communicate(timeout=max(
                        1.0, t0 + DRYRUN_TIMEOUT - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    for p in procs.values():
                        p.kill()
                        p.communicate()
                    raise CheckFailed(f"the dry run ran past "
                                      f"{DRYRUN_TIMEOUT} s")
                for line in out.splitlines():
                    print(f"  | {line}")
                if proc.returncode != 0:
                    print(err[-4000:], file=sys.stderr)
                check(proc.returncode == 0,
                      f"python -m repro_torch.launch.dryrun {' '.join(runs[k])}"
                      f" exited 0")
            tag = "ea3d-1m__sample_chunk__"
            recs = {m: json.loads(Path(tmp, "all", f"{tag}{m}.json")
                                  .read_text()) for m in DRYRUN_MESHES}
            pad = json.loads(Path(
                tmp, "padding", f"{tag}single_pod_16x16__rank"
                f"{DRYRUN_PADDING['rank']}.json").read_text())
        for mesh, want in DRYRUN_MESHES.items():
            self.check_dryrun(mesh, recs[mesh], want["chips"],
                              want["permute"], want["brick"])
        self.check_dryrun("single_pod_16x16, the all-padding rank", pad, 256,
                          DRYRUN_PADDING["permute"], [7, 7, 100])

    def check_dryrun(self, label, r, chips, permute, brick):
        """One dry-run record: ``ok`` on the card with the reference's
        chips, extras and wire per rank, #3 launched once per iteration,
        the reading no faster than the bound allows, the memory within the
        card's; its launches go to the kernels line."""
        rf, mem = r["roofline"], r["memory_analysis"]
        check(r["ok"] and r["chips"] == chips and r["brick"] == brick and
              r["device"].startswith("cuda") and
              r["extras"] == DRYRUN_EXTRAS,
              f"dry run {label}: ok on the card, {chips} chips, rank "
              f"{r['rank']} {r['coords']}, brick {brick}, extras "
              f"{r['extras']}")
        check(rf["per_kind"] == {"collective-permute": permute,
                                 "all-reduce": 8.0 * (chips - 1) / chips},
              f"dry run {label}: wire bytes per rank {rf['per_kind']} (the "
              f"reference's collective-permute {permute} and all-reduce "
              f"2 x 4 B x {chips - 1}/{chips})")
        check(r["launches"] == {"pbit_brick_sweep": DRYRUN_ITERS},
              f"dry run {label}: kernel #3 launched once per iteration "
              f"({r['launches']})")
        check(r["chunk_s"] >= r["bound_s"] / DRYRUN_SLACK,
              f"dry run {label}: the chunk's {r['chunk_s'] * 1e3:.4f} ms is "
              f"no less than the roofline's bound "
              f"{r['bound_s'] * 1e3:.6f} ms / {DRYRUN_SLACK}")
        check(mem["fits"] and mem["peak_allocated_bytes"] is not None,
              f"dry run {label}: peak {mem['peak_allocated_bytes']} B "
              f"allocated by the chunk and the resident problem's "
              f"{mem['resident_problem_bytes']} B within the card's "
              f"{mem['hbm_bytes']:.0f} B")
        brick_bytes = DRYRUN_SITE_BYTES * int(np.prod(brick))
        was = DRYRUN_PEAK_WHOLE.get(label)
        check(mem["resident_problem_bytes"] == brick_bytes and
              mem["peak_allocated_bytes"] < DRYRUN_PEAK_MAX,
              f"dry run {label}: the rank holds its brick's "
              f"{brick_bytes} B of constants on the card (resident "
              f"{mem['resident_problem_bytes']} B) and the chunk's peak "
              f"{mem['peak_allocated_bytes']} B is below "
              f"{DRYRUN_PEAK_MAX} B ("
              + ("not measured" if was is None else f"{was} B")
              + " when every rank held the whole problem)")
        for k, n in r["launches"].items():
            self.dryrun_launches[k] += n

    def dryrun_bricks(self):
        """#3 against its plain version at the dry run's bricks of the
        padded L=100 instance, as phase 2 holds f32 (LFSR states bitwise,
        spins bitwise or phase by phase within TANH_ULPS ulp): R=1, the
        chunk's S=4 betas, random spins, states and halos."""
        t = self.torch
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.bits import u32_from_numpy
        from repro_torch.core.lattice import build_ea3d_lattice
        from repro_torch.kernels import ref
        from repro_torch.kernels.pbit_lattice import (halo_shapes,
                                                      pbit_brick_sweep,
                                                      persistent_mode)
        prob = build_ea3d_lattice(L, seed=SEED, pad_xy=(112, 112),
                                  device=self.dev)
        rng = np.random.default_rng(SEED)
        S = DRYRUN_EXTRAS["sync_every"]
        betas = t.from_numpy(np.asarray(ea_schedule(DRYRUN_ITERS * S)
                                        .beta_array(), np.float32)[:S]) \
            .to(self.dev)
        errs = []
        for label, x0, Z in (("rank 17 of 16x16", 7, 100),
                             ("rank 17 of 2x16x16", 7, 50),
                             ("rank 255 of 16x16, all padding", 105, 100)):
            def cut(a, x0=x0, Z=Z):
                return a[..., x0:x0 + 7, x0:x0 + 7, :Z].contiguous()
            shape = (1, 7, 7, Z)
            masks = cut(prob.masks)
            args = (t.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                            size=shape)).to(self.dev),
                    u32_from_numpy(rng.integers(1, 2 ** 32, size=shape,
                                                dtype=np.uint32), self.dev),
                    betas, masks, cut(prob.h), tuple(cut(w) for w in prob.w6),
                    self.rand_halos(rng, 1, halo_shapes(*shape), False))
            got = pbit_brick_sweep(*args)
            want = ref.pbit_brick_sweep_ref(*args)
            t.cuda.synchronize()
            errs += [self.max_abs(g, w) for g, w in zip(got, want)]
            what = (f"f32 sweep at the dry run's brick {shape[1:]} ({label}), "
                    f"R=1, S={S} == plain ({persistent_mode(args[0])}, "
                    f"{int((masks != 0).sum())} decided sites, flips "
                    f"{want[2].tolist()})")
            self.check_f32(what, got, want, lambda what, args=args, got=got:
                           self.f32_steps(what, args, None, got))
        r = self.results["pbit_brick_sweep"]
        r["max_abs_err"] = max([r["max_abs_err"]] + errs)


if __name__ == "__main__":
    sys.exit(main())
