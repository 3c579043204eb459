#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases; every check raises on failure and the script then exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc/`` (nvcc,
   one process per source) and print the card's name and power limit;
2. hold each kernel to its plain PyTorch version on the card, at the
   L=100 shapes of the main path: the int8 sweep and the bit-plane sweep
   bitwise, the energy exactly on the +-J problem;
3. drive the L=100 EA3D main path through ``make_engine("lattice", ...)``
   with no ``impl`` given: the launch counters of every kernel are above 0,
   the first 16 sweeps equal an ``impl="ref"`` run on the card bitwise, the
   golden values recomputed from the JAX reference by
   ``tests/test_torch_golden.py`` match, and bit-plane lane (w, b) equals
   int8 replica w*32+b;
4. time the main path (p-bit updates per second, the repository's
   "flips/s") and each kernel against its plain version and its bound;
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
MAIN_RUNS = (("int8", 4), ("bitplane", 64))   # (precision, replicas)

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

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor-core rate used for the kernels' 32-bit integer and f32 ops.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


class CheckFailed(RuntimeError):
    pass


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's entry points run on "
              "the card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
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
        print(json.dumps({"kernels": [self.results[k] for k in
                                      ("pbit_brick_sweep_int",
                                       "pbit_bitplane_sweep",
                                       "brick_energy")]}))
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
        from repro_torch.kernels.pbit_lattice import (halo_shapes,
                                                      pbit_brick_sweep_int)
        print("== 2. kernels against their plain versions (L=100)",
              flush=True)
        rng = np.random.default_rng(1234)
        prob = build_ea3d_lattice(L, seed=SEED, device=self.dev)
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
        self.results["pbit_brick_sweep_int"] = {"max_abs_err": max(errs)}
        self.inputs_int8 = (m, s, prob.masks, eng.h_q, eng.w6_q, halos, lut,
                            beta_row_indices(betas[:SYNC], table))

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
        self.results["brick_energy"] = {"max_abs_err": max(errs)}
        self.inputs_energy = args
        self.n = n

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

        # the first 16 sweeps of the main configuration against impl="ref"
        first = {}
        for prec, R in MAIN_RUNS + (("int8", 64),):
            states = {}
            for impl in (("auto", "ref") if (prec, R) in MAIN_RUNS
                         else ("auto",)):
                h = make_engine("lattice", L=L, seed=SEED, replicas=R,
                                precision=prec, impl=impl)
                cur = h.start_recorded(h.init_state(seed=SEED),
                                       ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                       sync_every=SYNC)
                cur.advance(1)
                check(cur.sweeps_done == 16 and cur.points_recorded == 1,
                      f"{prec} R={R} impl={impl}: first chunk is 16 sweeps")
                states[impl] = (cur.state, cur.record().energies,
                                cur.flips_per_replica())
            first[(prec, R)] = states["auto"]
            if "ref" not in states:
                continue
            (a, ea, fa), (b, eb, fb) = states["auto"], states["ref"]
            check(self.same(a.m, b.m) and self.same(a.s, b.s) and
                  self.same(a.flips, b.flips) and self.same(ea, eb) and
                  (fa == fb).all() and
                  all(self.same(x, y) for x, y in zip(a.halos, b.halos)),
                  f"{prec} R={R}: 16 sweeps on the kernels == impl='ref' "
                  f"on the card, bitwise (E[0]={float(ea[0, 0])})")

        # bit-plane lane (w, b) == int8 replica w*32+b
        (bp, ebp, fbp), (i8, ei8, fi8) = first[("bitplane", 64)], \
            first[("int8", 64)]
        check(self.same(unpack_lanes(bp.m, 64), i8.m) and
              self.same(bp.s, i8.s) and self.same(bp.flips, i8.flips) and
              self.same(ebp, ei8) and (fbp == fi8).all(),
              "bit-plane lane (w, b) == int8 replica w*32+b (R=64, 16 "
              "sweeps: spins, LFSR, flips, energies)")

        # the main path, launches counted
        handles = {run: make_engine("lattice", L=L, seed=SEED,
                                    replicas=run[1], precision=run[0])
                   for run in MAIN_RUNS}
        inits = {run: hh.init_state(seed=SEED) for run, hh in handles.items()}
        t.cuda.synchronize()
        _build.reset_launch_counts()
        self.rates = {}
        for run, hh in handles.items():
            t0 = time.perf_counter()
            st, rec = hh.run_recorded(inits[run], ea_schedule(MAIN_SWEEPS),
                                      MAIN_POINTS, sync_every=SYNC)
            t.cuda.synchronize()
            dt = time.perf_counter() - t0
            prec, R = run
            e = rec.energies
            self.rates[run] = (L ** 3 * R * MAIN_SWEEPS / dt, dt, rec.flips)
            check(tuple(e.shape) == (len(MAIN_POINTS), R) and
                  bool(t.isfinite(e).all()),
                  f"{prec} R={R}: energies finite, shape {tuple(e.shape)}")
            per_spin = (e[-1] / L ** 3).cpu()
            # the 3D +-J EA ground state is near -1.70 per spin; an anneal
            # of 256 sweeps ends a little above it
            check(bool((e[-1] < e[0]).all()) and
                  bool(((per_spin > -1.75) & (per_spin < -1.55)).all()),
                  f"{prec} R={R}: annealed, E/N at {MAIN_SWEEPS} sweeps in "
                  f"[{float(per_spin.min()):.4f}, "
                  f"{float(per_spin.max()):.4f}]")
        self.launches = dict(_build.launch_counts)
        for name, count in self.launches.items():
            check(count > 0, f"main path launched {name} {count} times")
        self.handles, self.inits = handles, inits

    def phase_timing(self, card: str):
        t = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.lattice_energy import brick_energy
        from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
        from repro_torch.kernels.pbit_lattice import pbit_brick_sweep_int
        print(f"== 4. timing on {card}", flush=True)
        for (prec, R), (rate, dt, flips) in self.rates.items():
            unit = "lane-flips/s" if prec == "bitplane" else "flips/s"
            print(f"  main path {prec} R={R}: {MAIN_SWEEPS} sweeps in "
                  f"{dt:.4f} s = {rate:.4e} {unit} (p-bit updates; "
                  f"{flips} accepted flips) on {card}", flush=True)
        self.profile_main_path(card)
        n = self.n

        m, s, masks, h_q, w6_q, halos, lut, rows = self.inputs_int8
        R, nc = int(m.shape[0]), int(masks.shape[0])
        args = (m, s, t.from_numpy(rows).to(self.dev), masks, h_q, w6_q,
                halos, lut)
        plane = 6 * L * L
        byts = (2 * 5 * R * n + (nc + 7) * n + 4 * R + R * plane
                + 4 * lut.numel() + 4 * SYNC)
        ops = 25 * R * n * nc * SYNC
        self._timed("pbit_brick_sweep_int", "src/repro_torch/kernels/csrc/"
                    "pbit_lattice.cu", "src/repro/kernels/pbit_lattice.py:235",
                    lambda: pbit_brick_sweep_int(*args),
                    lambda: ref.pbit_brick_sweep_int_ref(*args),
                    byts, ops, f"{SYNC} sweeps, R={R}, {SYNC * nc} launches")

        mw, s, rows, masks_w, signs6, nz6, base, hw, lut = self.inputs_bp
        W, R, nc = int(mw.shape[0]), int(s.shape[0]), int(masks_w.shape[0])
        args = (mw, s, rows, masks_w, signs6, nz6, base, hw, lut)
        byts = (2 * 4 * (W + R) * n + 4 * nc * W * n + 52 * n + 4 * R
                + 4 * W * plane + 4 * lut.numel() + 4 * SYNC)
        ops = nc * n * (26 * W + 15 * R) * SYNC
        self._timed("pbit_bitplane_sweep", "src/repro_torch/kernels/csrc/"
                    "pbit_bitplane.cu",
                    "src/repro/kernels/pbit_bitplane.py:135",
                    lambda: pbit_bitplane_sweep(*args),
                    lambda: ref.pbit_bitplane_sweep_ref(*args),
                    byts, ops,
                    f"{SYNC} sweeps, R={R}, W={W}, {SYNC * nc} launches")

        args = self.inputs_energy
        R = int(args[0].shape[0])
        byts = R * n + 29 * n + R * plane + 4 * R
        ops = 17 * R * n
        self._timed("brick_energy", "src/repro_torch/kernels/csrc/"
                    "lattice_energy.cu",
                    "src/repro/kernels/lattice_energy.py:57",
                    lambda: brick_energy(*args),
                    lambda: ref.brick_energy_ref(*args),
                    byts, ops, f"R={R} spins, 1 launch")
        for name, r in self.results.items():
            print(f"  {name}: {r['ms']:.4f} ms ({r['work']}), plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"by {r['bound_by']}; {r['launches']} launches on the "
                  f"main path; on {card}", flush=True)
            del r["work"]

    def profile_main_path(self, card: str):
        """Device time by kernel over one more run of each main-path
        configuration, and the device's busy share of its wall time (the
        profiler's own cost is in that wall time)."""
        t = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.annealing import ea_schedule
        for (prec, R), hh in self.handles.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                hh.run_recorded(self.inits[(prec, R)],
                                ea_schedule(MAIN_SWEEPS), MAIN_POINTS,
                                sync_every=SYNC)
                t.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = [(e.key, e.count, e.self_device_time_total)
                    for e in prof.key_averages()
                    if e.self_device_time_total > 0]
            busy = sum(us for _, _, us in rows) / 1e6
            if not rows:
                print(f"  profile {prec} R={R}: the profiler saw no device "
                      f"time; device busy share not measured", flush=True)
                continue
            print(f"  profile {prec} R={R}: wall {wall:.4f} s under the "
                  f"profiler, device busy {busy:.4f} s "
                  f"({100 * busy / wall:.1f}%) on {card}", flush=True)
            for key, count, us in sorted(rows, key=lambda r: -r[2])[:6]:
                print(f"    {us / 1e3:10.3f} ms  {count:5d} x  {key[:90]}",
                      flush=True)

    def _timed(self, name, source, replaces, kernel, plain, byts, ops,
               work):
        bytes_ms = byts / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / CORE_OPS_PER_S * 1e3
        r = self.results[name]
        r.update({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": self.launches[name],
            "ms": self.time_ms(kernel, reps=50),
            "plain_ms": self.time_ms(plain, reps=3, warm=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "work": work})
        # key order of the kernels line
        self.results[name] = {k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "work")}


if __name__ == "__main__":
    sys.exit(main())
