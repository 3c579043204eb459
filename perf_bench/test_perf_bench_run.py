"""A whole run of the cell at a tiny size on the CPU (the look for a card
skipped, the program on its plain kernels): the job loop held to the plain
reference; the same run with the timed path broken underneath, once for
each fault the cell can have, reading not correct; and the control, the
reference one precision lower in the program's place, judged by the run's
own check and reading not correct."""

import dataclasses

import pytest
import torch

from perf_bench import control as C
from perf_bench import harness as H
from repro_torch.core.lattice_dsim import LatticeDSIM
from repro_torch.engines import registry

LATTICE = "ea3d-L100-lattice.bitplane-R64"
SEED = 2 ** 31 + 17


def tiny(workload, L=4, **traffic):
    """The cell's own configuration and traffic at L=4 and 8 sweeps."""
    spec = H.load_spec(workload)
    spec["config"] = dict(spec["config"], L=L)
    spec["traffic"] = dict(spec["traffic"], **dict(
        dict(sweeps=8, record_points=[8], sync_every=4, warm_sweeps=4),
        **traffic))
    return spec


def run(workload, seconds=0.0, seed=SEED, **traffic):
    out = H.Run(tiny(workload, **traffic), seed, seconds, False,
                device="cpu", log=lambda *a: None).execute()
    return out, {k: c["value"] for k, c in out["checks"].items()}


@pytest.mark.parametrize("traffic", [
    {}, {"record_points": [4, 8]},
    {"beta_levels": [0.5, 1.5, 3.0], "sweeps": 12, "record_points": [4, 12]},
    {"checked_lanes_per_word": 32}],
    ids=["the_mix", "record_points", "staircase", "every_lane"])
def test_a_tiny_run_matches_the_reference(traffic):
    out, checks = run(LATTICE, seconds=0.3, **traffic)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"updates_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert checks == {k: 0 for k in H.LIMITS}
    assert list(out)[-1] == "checks"


def _second_word_kept(new, old):
    """``new`` with the lanes of word plane 1 as in ``old``."""
    def keep(a, b, lo):
        a = a.clone()
        a.narrow(0, lo, a.shape[0] - lo).copy_(b.narrow(0, lo,
                                                        b.shape[0] - lo))
        return a
    return dataclasses.replace(new, m=keep(new.m.view(torch.int32),
                                           old.m.view(torch.int32), 1)
                               .view(torch.uint32),
                               s=keep(new.s.view(torch.int32),
                                      old.s.view(torch.int32), 32)
                               .view(torch.uint32))


def fault(name, monkeypatch):
    """Break the timed path underneath the harness."""
    chunk = LatticeDSIM._chunk
    if name == "state_unchanged":
        monkeypatch.setattr(LatticeDSIM, "_chunk",
                            lambda self, st, *a, **k: st)
    elif name == "half_the_lanes_left_out":
        monkeypatch.setattr(
            LatticeDSIM, "_chunk", lambda self, st, *a, _c=chunk, **k:
            _second_word_kept(_c(self, st, *a, **k), st))
    elif name == "exchange_left_out":
        from repro_torch.core import bricks
        monkeypatch.setattr(bricks.GatherExchange, "__call__",
                            lambda self, m: bricks._as(self.fill.clone(),
                                                       self.dtype))
    elif name == "answer_altered":
        recorded = registry._Handle.run_recorded

        def altered(self, *a, **k):
            st, rec = recorded(self, *a, **k)
            # every lane of word plane 0 at one site
            st.m.view(torch.int32).view(-1)[0] ^= -1
            return st, rec
        monkeypatch.setattr(registry._Handle, "run_recorded", altered)


@pytest.mark.parametrize("name", ["state_unchanged",
                                  "half_the_lanes_left_out",
                                  "exchange_left_out", "answer_altered"])
def test_a_broken_timed_path_reads_not_correct(name, monkeypatch):
    fault(name, monkeypatch)
    out, checks = run(LATTICE)
    assert not out["correct"]
    assert checks["spins_differ"] + checks["flips_gap"] + \
        checks["energy_gap"] + checks["states_differ"] > 0


# Seeds on which the control's decisions differ at L=8: a float32
# threshold differs from float64's by one (5 of the 13 entries at beta 3),
# and a decision differs only where the 24-bit draw equals that threshold,
# about once in 2^24 decisions at those fields.  L=8, 256 sweeps and every
# lane of 2 jobs make some 10^7 decisions a seed, so it shows on some seeds
# only (9 of seeds 1-29); at the cell's size, some 10^10 decisions a run,
# it fails on every seed (PERF.md).
CONTROL_SEEDS = [1, 9]


@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_the_control_reads_not_correct(seed):
    spec = tiny(LATTICE, L=8, sweeps=256, record_points=[256],
                checked_lanes_per_word=32)
    checks, lut_differ = C.control(spec, seed, "cpu")
    assert lut_differ == 5
    assert not H.passes(checks)
    assert checks["flips_gap"]["value"] > 0
