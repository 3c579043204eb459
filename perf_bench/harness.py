"""The benchmark's one loop, driven by ``BENCHMARK.json``: a cell names a
configuration (``configs/<config>.json``, whose ``engine`` names the
adapter ``engines/<engine>.py`` and whose ``reference`` the plain reference
``reference/<reference>.py``), a traffic mix (``traffic/<mix>.json``) and
the metrics it reports (``metrics/<metric>.py`` for each per-layer one).

A run builds the system under test from the seed, warms it with a short
job at the cell's shapes, then runs jobs back to back in a closed loop
with one client for ``--seconds``: each job's state is drawn on the device
from (seed, job index) and handed over, the anneal runs, and its recorded
energies and per-lane flips come back to the host.  After the window a
sample of the jobs and of their lanes, drawn from the seed, is run again
by the plain reference and compared; the last line of standard output is
the result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from perf_bench import jobs as J
from perf_bench import timeline as TL
from perf_bench import work as W

PKG = "perf_bench"
ROOT = Path(__file__).resolve().parents[1]
# what may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the numbers a check compares, each with its limit: every one is exact
LIMITS = {"energy_gap": 0, "flips_gap": 0, "spins_differ": 0,
          "states_differ": 0, "points_differ": 0, "jobs_unchecked": 0}


class NoCard(RuntimeError):
    """The run has not the cards its cell asks for."""


# -- finding a cell's files by name ------------------------------------------------

def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration and traffic files read, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / PKG / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return {"root": root, "cell": cell, "config": config, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def module(root: Path, *parts: str):
    """The module ``root/perf_bench/<parts>.py``, loaded by its path."""
    path = root.joinpath(PKG, *parts[:-1], parts[-1] + ".py")
    name = "perf_bench_" + "_".join(
        "".join(ch if ch.isalnum() else "_" for ch in p) for p in parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(timeline)`` of ``metrics/<metric>.py``."""
    return module(root, "metrics", metric).read


def adapter(config: dict, root: Path = ROOT):
    """``engines/<engine>.py`` of a configuration: its ``System``."""
    return module(root, "engines", config["engine"])


def reference(config: dict, root: Path = ROOT):
    """``reference/<reference>.py`` of a configuration: its ``Machine``,
    ``compare`` and ``lanes_to_spins``."""
    return module(root, "reference", config["reference"])


def passes(checks: dict) -> bool:
    """Every number a check compared is within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


# -- the card --------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"
    return out[0] if out else "nvidia-smi read nothing"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- one run ---------------------------------------------------------------------

class Run:
    """One run of one cell: set-up, window, check.  ``device`` None takes
    the card (and raises :class:`NoCard` without one); a CPU device skips
    the look for a card, which is how the tests drive the rest of a run."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device=None, t_start=None, log=print):
        self.spec, self.seed = spec, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.root = spec["root"]
        self.log = log
        self.t_start = time.perf_counter() if t_start is None else t_start
        chips = int(spec["cell"]["chips"])
        if device is None:
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() < chips:
                raise NoCard(
                    f"the cell asks for {chips} CUDA device(s); "
                    f"torch.cuda.is_available()={torch.cuda.is_available()}"
                    f", device_count()={torch.cuda.device_count()}")
            device = torch.device("cuda", 0)
        self.device = torch.device(device)
        self.chips = chips

    # one job -----------------------------------------------------------------

    def one_job(self, system, job: int, traced: bool = False,
                plan: str = "job"):
        """(seconds, answers, final state) of job ``job``: its state drawn
        (outside its clock), then the clock from the hand-over to the
        answers on the host, ended by a synchronise."""
        t_d = time.perf_counter()
        st0 = system.program_state(*J.draw(
            self.seed, job, system.words, system.lanes, system.dims,
            self.device))
        sync(self.device)
        self._draw_s += time.perf_counter() - t_d
        with (torch.profiler.record_function(TL.JOB_SPAN) if traced
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            st = system.start(st0)
            del st0
            st, rec = system.run(st, plan)
            ans = system.answers(st, rec)
            sync(self.device)
            return time.perf_counter() - t0, ans, st

    # the run -------------------------------------------------------------------

    def execute(self) -> dict:
        """Set-up, window and check; returns the result line's object."""
        dev, tr = self.device, self.traffic
        t_build = time.perf_counter()
        system = adapter(self.cfg, self.root).System(self.cfg, tr, self.seed,
                                                     dev)
        t_warm = time.perf_counter()
        self._draw_s = 0.0
        # warm: the job's chunks and record point, over fewer sweeps
        self.one_job(system, -1, plan="warm")
        if self.trace:
            self._warm_profiler()
        sync(dev)
        t_end = time.perf_counter()
        setup_s = t_end - self.t_start
        self.log(f"set-up {setup_s:.4f} s: start and imports "
                 f"{t_build - self.t_start:.4f} s, the engine with its "
                 f"instance {t_warm - t_build:.4f} s, the warm job (the "
                 f"kernels loaded or built) {t_end - t_warm:.4f} s")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times, failed, timeline = self.window(system)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        if dev.type == "cuda":
            self.log(f"card: {card_line()}; torch {torch.__version__}, "
                     f"CUDA {torch.version.cuda}")
        n_jobs = len(times)
        self.log(f"window: {n_jobs} jobs, {len(failed)} failed, "
                 f"{sum(times):.4f} s in jobs; draws and hand-over states "
                 f"{self._draw_s:.4f} s in all (outside the jobs' clocks)")
        lanes = self.lanes_checked
        kept = [(job, dict(times=ans["times"],
                           energies=ans["energies"][:, lanes],
                           flips=ans["flips"][lanes],
                           **system.lattice_form(raw, lanes)))
                for job, (ans, raw) in self.kept.items()]
        del system
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks = self.check(kept, n_jobs)
        result = {"correct": not failed and n_jobs > 0 and passes(checks),
                  "attempted": n_jobs, "failed": len(failed)}
        if self.trace:
            result["metrics"] = self.per_layer(timeline)
        else:
            result["metrics"] = self.end_to_end(times, failed, setup_s)
        result["device"] = {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "count": self.chips, "memory_peak_bytes": int(peak)}
        if self.trace and timeline is not None:
            result["device"].update(busy_s=timeline.busy_s,
                                    window_s=timeline.window_s)
            result["breakdown"] = TL.breakdown(timeline)
        result["checks"] = checks
        return result

    def window(self, system):
        """Jobs back to back for ``seconds`` (and, traced, until the traced
        stretch is done); returns (job seconds, failures, timeline)."""
        tr = self.traffic
        self.kept = J.Reservoir(int(tr["checked_jobs"]), self.seed)
        lanes = self.lanes_checked
        first = int(tr["traced_from_job"])
        last = first + int(tr["traced_jobs"]) - 1 if self.trace else -1
        times, failed, prof, notes, timeline = [], [], None, None, None
        self._draw_s = 0.0
        deadline = time.perf_counter() + self.seconds
        job = 0
        while job == 0 or job <= last or time.perf_counter() < deadline:
            if job == first and self.trace:
                prof, notes = self._start_trace()
            t0 = time.perf_counter()
            try:
                dt, ans, st = self.one_job(system, job, prof is not None)
            except Exception:          # a job that fails is counted, not fatal
                if not failed:
                    traceback.print_exc(file=sys.stderr)
                failed.append(job)
                dt, ans, st = time.perf_counter() - t0, None, None
            times.append(dt)
            if job == last:
                timeline = self._stop_trace(prof, notes, job - first + 1)
                prof = None
            if ans is not None:
                self.kept.offer(job, lambda: (ans, system.keep(st, lanes)))
            del st
            job += 1
        return times, failed, timeline

    # the trace -----------------------------------------------------------------

    def _warm_profiler(self):
        """The profiler's first start costs seconds: pay it in set-up."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device=self.device).add_(1)
            sync(self.device)

    @property
    def lanes_checked(self) -> list:
        """The lanes of every sampled job that the reference runs again."""
        return J.lane_sample(self.seed, int(self.traffic["replicas"]),
                             int(self.traffic["checked_lanes_per_word"]))

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels import _build
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        notes = _build.launch_log = []
        return prof, notes

    def _stop_trace(self, prof, notes, n_jobs: int):
        from repro_torch.kernels import _build
        sync(self.device)
        prof.__exit__(None, None, None)
        _build.launch_log = None
        calls = TL.cost_notes(notes, program_model())
        tl = TL.from_profiler(prof, n_jobs * int(self.traffic["sweeps"]),
                              calls)
        self._report_calls(tl)
        return tl

    def _report_calls(self, tl):
        """The bound of every kind of kernel call in the traced jobs, by
        the frozen model and by the program's own, and what was traced."""
        for c in tl.calls:
            by, t, terms = W.bound(c.work)
            try:
                p = c.program
                tp = W.bound(W.Work(p.bytes, p.int32, p.fp32))[1]
                theirs = (f"{tp * 1e3:.6f} ms ({p.bytes} B, {p.int32} int32,"
                          f" {p.fp32} fp32 ops)")
            except (AttributeError, TypeError):
                theirs = "unavailable"
            self.log(
                f"kernel call {c.name} x {c.count} ({c.launches} launches "
                f"each): bound {t * 1e3:.6f} ms by {by} (bytes "
                f"{terms['bytes'] * 1e3:.6f} ms for {c.work.bytes} B, int32 "
                f"{terms['int32'] * 1e3:.6f} ms for {c.work.int32} ops, fp32 "
                f"{terms['fp32'] * 1e3:.6f} ms for {c.work.fp32} ops); the "
                f"program's model: {theirs}")
        self.log(f"traced: {len(tl.jobs)} jobs, {tl.window_s:.6f} s, device "
                 f"busy {tl.busy_s:.6f} s, {len(tl.device_ops())} device "
                 f"operations, {tl.sweeps} sweeps; peaks {W.PEAKS}")

    # the metrics ---------------------------------------------------------------

    def end_to_end(self, times, failed, setup_s) -> dict:
        L = int(self.cfg["L"])
        ok = len(times) - len(failed)
        updates = ok * L ** 3 * int(self.traffic["replicas"]) * \
            int(self.traffic["sweeps"])
        values = {"updates_per_s": updates / sum(times), "setup_s": setup_s}
        self.log(f"jobs: {len(times)}, median "
                 f"{1e3 * statistics.median(times):.4f} ms, min "
                 f"{1e3 * min(times):.4f} ms, max {1e3 * max(times):.4f} ms")
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in self.spec["end_to_end"]}

    def per_layer(self, tl) -> dict:
        out = {}
        for m in self.spec["per_layer"]:
            v = None if tl is None else reader(m["name"], self.root)(tl)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    # the check -----------------------------------------------------------------

    def check(self, kept, n_jobs: int, program=None) -> dict:
        """The sampled jobs' sampled lanes run again by the plain reference
        from the same drawn states, in one batch of lanes: every number
        compared, with its limit.  ``kept`` holds (job, the program's
        answers at :attr:`lanes_checked`); given ``program``, a reference
        ``Machine`` put in the program's place (the control), its answers
        are taken instead of ``kept``'s."""
        cfg, tr = self.cfg, self.traffic
        ref = reference(cfg, self.root)
        t0 = time.perf_counter()
        sound = ref.Machine(int(cfg["L"]), self.seed, cfg["format"],
                            self.device)
        lanes, jobs = self.lanes_checked, [job for job, _ in kept]
        words = -(-int(tr["replicas"]) // 32)
        m0, s0 = [], []
        for job in jobs:
            w, s = J.draw(self.seed, job, words, int(tr["replicas"]),
                          (int(cfg["L"]),) * 3, self.device)
            m0.append(ref.lanes_to_spins(w, int(tr["replicas"]))[lanes])
            s0.append(s[lanes].to(torch.int64) & 0xFFFFFFFF)
        plan = (tr["beta_levels"], int(tr["sweeps"]), tr["record_points"],
                int(tr["sync_every"]))
        worst = {k: 0 for k in LIMITS}
        if jobs:
            m0, s0 = torch.cat(m0), torch.cat(s0)
            want = self._per_job(sound.run(m0, s0, *plan), len(jobs))
            if program is not None:
                got = self._per_job(program.run(m0, s0, *plan), len(jobs))
                kept = [(job, dict(g, times=list(tr["record_points"])))
                        for job, g in zip(jobs, got)]
            for (job, g), w in zip(kept, want):
                g = dict(g, energies=g["energies"].to(torch.float64))
                for k, v in ref.compare(g, w).items():
                    worst[k] = max(worst[k], v)
                worst["points_differ"] += int(
                    list(g["times"]) != list(tr["record_points"]))
        worst["jobs_unchecked"] = int(not jobs)
        self.log(f"check: jobs {jobs} of {n_jobs}, lanes {lanes} of each, "
                 f"against the plain reference in "
                 f"{time.perf_counter() - t0:.3f} s")
        return {k: {"value": v, "limit": LIMITS[k]} for k, v in worst.items()}

    @staticmethod
    def _per_job(out: dict, n: int) -> list:
        """A batch of lanes of ``n`` jobs, split into each job's, on the
        host."""
        def part(v, i, axis):
            k = v.shape[axis] // n
            return v.narrow(axis, i * k, k).cpu()
        return [{"energies": part(out["energies"], i, 1),
                 "flips": part(out["flips"], i, 0),
                 "m": part(out["m"], i, 0), "s": part(out["s"], i, 0)}
                for i in range(n)]


def program_model():
    """The program's own work model of a noted call, ``(name, operands)``
    to an object with ``bytes``, ``int32`` and ``fp32``, or None where the
    program has none by that name: it may change or go, the benchmark's
    frozen model stays."""
    try:
        from repro_torch.kernels import work as program_work
        model = program_work.launch_work
    except (ImportError, AttributeError):
        return None

    def read(name, operands):
        try:
            return model(name, operands)
        except Exception:          # a model that no longer fits its notes
            return None
    return read


# -- the command ------------------------------------------------------------------

def main(argv=None, t_start=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    log = lambda *x: print(*x, flush=True)  # noqa: E731
    try:
        run = Run(load_spec(a.workload), a.seed, a.seconds, bool(a.trace),
                  t_start=t_start, log=log)
    except NoCard as e:
        print(f"perf_bench: {e}", file=sys.stderr)
        return 3
    result = run.execute()
    loaded = sorted({m.split(".")[0] for m in sys.modules} &
                    set(FORBIDDEN))
    if loaded:
        print(f"perf_bench: the run loaded {loaded}; no result",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
