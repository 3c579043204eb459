#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases; every check raises on failure and the script then exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc/`` (nvcc,
   one process per source) and print the card's name and power limit;
2. hold each kernel to its plain PyTorch version on the card, at the
   L=100 shapes of the main path: the int8 sweep (both LFSR modes of its
   persistent kernel: shared memory at R=4, device memory at R=16), the
   int8 phase and the bit-plane
   sweep bitwise, the energy exactly on the +-J problem (and the same for
   every x tile ``bx``); the f32 sweep (both LFSR modes) and the f32 phase
   (one thread per word of 4 z-sites at L=100, per site at an odd Z) with
   LFSR states bitwise and spins bitwise or differing only at sites within
   8 ulp of the tanh decision boundary (counted and printed);
3. drive the L=100 EA3D main path through ``make_engine("lattice", ...)``
   with no ``impl`` given, each configuration with the launch counters
   set to 0 just before it and read just after (every kernel it runs
   above 0; the int8 and f32 sweeps one persistent launch per call, with
   the LFSR states in shared memory; the f32 phase one thread per word):
   int8, bit-plane, f32 (the default precision,
   with and without the paper's s{4}{1} format) and the per-phase
   dispatch (``fused=False``, ``kernel_bx``).  The first 16 sweeps equal
   an ``impl="ref"`` run on the card bitwise (int8, bit-plane), the
   per-phase runs equal the fused ones bitwise, the golden values
   recomputed from the JAX reference by ``tests/test_torch_golden.py``
   match (f32 to 0.5%, its LFSR digest exactly), and bit-plane lane
   (w, b) equals int8 replica w*32+b;
4. time the main path (p-bit updates per second, the repository's
   "flips/s"), profile it (device busy share, time by kernel, the
   redesigned kernels' mode and time per launch) and time each kernel
   against its plain version and its bound: the largest of its bytes
   over the HBM bandwidth and its INT32 and FP32 operations over their
   own peaks (64 and 128 per SM per clock at the card's SM count and
   maximum SM clock);
5. print one JSON line of kernels, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

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
KERNELS = ("pbit_brick_sweep_int", "pbit_bitplane_sweep", "brick_energy",
           "pbit_brick_sweep", "pbit_brick_update_int", "pbit_brick_update")
# an f32 site may be decided differently from the plain version only
# within this many ulp of tanh(act) of its boundary
TANH_ULPS = 8

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

# H100 SXM published HBM3 bandwidth (NVIDIA data sheet).  The operation
# peaks are taken from the card in the run: Hopper issues 64 INT32 and
# 128 FP32 lane operations per SM per clock (no FMA here: the library
# builds with --fmad=false), at the SM count PyTorch reports and the
# maximum SM clock nvidia-smi reports.
HBM_BYTES_PER_S = 3.35e12
INT32_PER_SM_CLOCK = 64
FP32_PER_SM_CLOCK = 128
# the redesigned kernels, by what the profiler's CUDA kernel name holds
REDESIGNED = {"pbit_bitplane_sweep": ("bitplane_color_kernel",),
              "pbit_brick_sweep": ("persistent_sweep", "F32Update"),
              "pbit_brick_sweep_int": ("persistent_sweep", "Int8Update"),
              "pbit_brick_update": ("word_phase_kernel", "F32Update")}


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
        self.phase_timing(card)
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
        from repro_torch.kernels.lattice_energy import brick_energy
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

        # energy on the +-J problem, exact, for R = 4 and R = 64 spins
        errs = []
        for R in (4, 64):
            m = t.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        size=(R, L, L, L))).to(self.dev)
            halos = self.rand_halos(rng, R, halo_shapes(R, L, L, L), False)
            args = (m, prob.active, prob.h, prob.w6, halos)
            got = brick_energy(*args)
            want = ref.brick_energy_ref(*args)
            t.cuda.synchronize()
            errs.append(self.max_abs(got, want))
            check(self.same(got, want),
                  f"energy == plain, exact on +-J (R={R}, E[0]="
                  f"{float(want[0])})")
            check(self.same(brick_energy(*args, bx=BX), got),
                  f"energy with bx={BX} == bx=None (R={R})")
        self.results["brick_energy"] = {"max_abs_err": max(errs)}
        self.inputs_energy = args
        self.n = n
        self.phase_kernels_f32_and_per_phase(betas, table, S)

    def phase_kernels_f32_and_per_phase(self, betas, table, S: int):
        """The f32 sweep and the two single-phase kernels against their
        plain versions, on the int8 check's L=100, R=4 spins and states."""
        t = self.torch
        from repro_torch import S41
        from repro_torch.core.bits import u32_from_numpy
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
        errs = []
        for bx in (None, BX):
            for row in (3, on_card(rng.integers(0, len(table), size=R)
                                   .astype(np.int32))):
                args = (m, s, row, masks[0], h_q, w6_q, halos, lut)
                got = pbit_brick_update_int(*args, bx=bx)
                want = ref.pbit_brick_update_int_ref(*args)
                t.cuda.synchronize()
                errs += [self.max_abs(g, w) for g, w in zip(got, want)]
                check(all(self.same(g, w) for g, w in zip(got, want)),
                      f"int8 phase == plain, bitwise (R={R}, bx={bx}, row "
                      f"{'per replica' if isinstance(row, t.Tensor) else row})")
        self.results["pbit_brick_update_int"] = {"max_abs_err": max(errs)}
        self.inputs_update_int = (m, s, row, masks[0], h_q, w6_q, halos,
                                  lut)

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

        # f32 phase at an odd Z (rows not word-aligned: one site per
        # thread), random Gaussian constants, a checkerboard
        shape = (L, L, L - 1)
        par = np.indices(shape).sum(0) % 2
        h_o = on_card(rng.normal(0, 0.3, shape).astype(np.float32))
        w6_o = tuple(on_card(rng.normal(0, 1.0, shape).astype(np.float32))
                     for _ in range(6))
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

    def phase_main_path(self):
        t = self.torch
        from repro_torch import make_engine
        from repro_torch.core.annealing import ea_schedule
        from repro_torch.core.bits import u32_to_numpy
        from repro_torch.core.packing import unpack_lanes
        from repro_torch.kernels import _build
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

        # the main path: each configuration's launches counted on their own
        handles = {label: self.engine(kw) for label, kw in MAIN_RUNS.items()}
        inits = {label: hh.init_state(seed=SEED)
                 for label, hh in handles.items()}
        t.cuda.synchronize()
        self.rates = {}
        self.launches = dict.fromkeys(_build.launch_counts, 0)
        for label, hh in handles.items():
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            st, rec = hh.run_recorded(inits[label], ea_schedule(MAIN_SWEEPS),
                                      MAIN_POINTS, sync_every=SYNC)
            t.cuda.synchronize()
            dt = time.perf_counter() - t0
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
            if sweep == "pbit_brick_update":
                check(counts.get(f"{sweep}:word", 0) ==
                      counts.get(sweep, 0) == MAIN_SWEEPS * 2,
                      f"{label}: one f32 phase launch per color phase, one "
                      f"thread per word of 4 z-sites")
        for name in KERNELS:
            check(self.launches[name] > 0,
                  f"main path launched {name} {self.launches[name]} times")
        self.handles, self.inits = handles, inits

    def engine(self, kw):
        """``make_engine("lattice", L=100)`` of the main path with ``kw``
        (``fmt`` by name), on the card with no ``impl`` unless given."""
        from repro_torch import make_engine
        import repro_torch
        kw = dict(kw)
        if "fmt" in kw:
            kw["fmt"] = getattr(repro_torch, kw["fmt"])
        return make_engine("lattice", L=L, seed=SEED, **kw)

    def phase_timing(self, card: str):
        t = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.lattice_energy import brick_energy
        from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
        from repro_torch.kernels.pbit_lattice import (phase_width,
                                                      pbit_brick_sweep,
                                                      pbit_brick_sweep_int,
                                                      pbit_brick_update,
                                                      pbit_brick_update_int)
        print(f"== 4. timing on {card}", flush=True)
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

        args = self.inputs_energy
        R = int(args[0].shape[0])
        byts = R * n + 29 * n + R * plane + 4 * R
        self._timed("brick_energy", "src/repro_torch/kernels/csrc/"
                    "lattice_energy.cu",
                    "src/repro/kernels/lattice_energy.py:57",
                    lambda: brick_energy(*args),
                    lambda: ref.brick_energy_ref(*args),
                    byts, 0, 17 * R * n, f"R={R} spins, 1 launch")

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
                elif name == "pbit_brick_update":
                    mode = "per color phase, one thread per word"
                print(f"  redesigned {name} in {label}: {mode}; {count} "
                      f"launches, {us / count:.1f} us per launch "
                      f"(profiler) on {card}", flush=True)

    def _timed(self, name, source, replaces, kernel, plain, byts, int_ops,
               f32_ops, work):
        """Time a kernel's wrapper and its plain version; its bound is the
        largest of the bytes over HBM bandwidth and the INT32 and FP32
        operations over their own peaks."""
        times = {"bytes": byts / HBM_BYTES_PER_S * 1e3,
                 "int32": int_ops / self.int_peak * 1e3,
                 "fp32": f32_ops / self.f32_peak * 1e3}
        by = max(times, key=times.get)
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
