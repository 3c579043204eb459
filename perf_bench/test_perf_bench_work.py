"""The frozen work model against hand-computed bytes and operations, at
the cell's shapes and at the shapes of the port's other kernels, B7's
4-byte xorshift32 states included; and the program's own model, which a
traced run prints beside the frozen one, read so that its change or its
absence costs that line alone."""

import pytest

from perf_bench import harness as H
from perf_bench import work as W

# B7 at the colour phase of the port's dsim_dist bit-plane run (chip_smoke.py
# phase 7, no cell yet): K=8 partitions of 62,500 colour
# sites, degree 6, W=2 words of 64 lanes, every entry real, kept and its
# slot's owner, 67,500 slots reached per partition (the other colour's
# 62,500 and 5,000 ghosts), a 13-entry int64 LUT row
B7 = dict(K=8, nc=62_500, D=6, W=2, R=64, real=500_000, keep=500_000,
          owners=500_000, reached=540_000, lut_bytes=104)
# #2 at the lattice cell's call: 8 sweeps of 2 colours over 100^3 sites
BITPLANE = dict(W=2, R=64, X=100, Y=100, Z=100, n_colors=2, S=8,
                decided=1_000_000, lut_entries=130, sched_entries=8)


def test_colour_phase_counts_four_bytes_per_lane_each_way():
    w = W.colour_phase(**B7)
    # 4 B read + 4 B written per lane and owned slot, the own words read
    # and written, the reached words, 76 B of row per entry, 5 B of slot
    # and flags per entry, the flips, the LUT row
    assert w.bytes == (8 * 64 * 500_000 + 4 * 2 * 1_000_000
                       + 4 * 2 * 540_000 + 500_000 * 76 + 62_500 * 8 * 5
                       + 16 * 64 + 104) == 308_821_128
    # the gather-count's 34 per word-site, 20 per lane-site
    assert w.int32 == 500_000 * 2 * 34 + 500_000 * 64 * 20
    by, t, _ = W.bound(w)
    assert by == "bytes" and t == pytest.approx(308_821_128 / 3.35e12)


def test_bitplane_sweep_at_the_lattice_cell():
    w = W.bitplane_sweep(**BITPLANE)
    assert w.bytes == (2 * 4 * 66 * 10 ** 6 + 4 * 2 * 2 * 10 ** 6
                       + 52 * 10 ** 6 + 4 * 64 + 4 * 2 * 60_000 + 4 * 130
                       + 4 * 8) == 596_480_808
    assert w.int32 == 8 * (6 * 2 * 64 * 10 ** 6 + 10 ** 6 * (26 * 2
                                                              + 13 * 64))
    by, t, _ = W.bound(w)
    # 49.4 us per colour launch: the INT32 peak of 132 SMs x 64 x 1.98 GHz
    assert by == "int32" and t / 16 == pytest.approx(49.38e-6, rel=1e-3)


N, M = 100 ** 3, 50 ** 3
HALO100, HALO50 = 6 * 100 * 100, 6 * 50 * 50


@pytest.mark.parametrize("name, kw, want", [
    # 8 sweeps of 4 int8 replicas: spins and states 5 B each way, masks
    # and couplings 9 B a site, halos, flips, LUT and rows; 6 per colour
    # and replica-site for the steps, 19 per decided replica-site
    ("sweep_int", dict(R=4, X=100, Y=100, Z=100, n_colors=2, S=8,
                       decided=N, lut_entries=130, sched_entries=8),
     (40 * N + 9 * N + 4 * HALO100 + 16 + 520 + 32, 8 * 4 * (12 + 19) * N,
      0)),
    ("sweep_f32", dict(R=4, X=100, Y=100, Z=100, n_colors=2, S=8,
                       decided=N),
     (40 * N + 30 * N + 4 * HALO100 + 16 + 128, 8 * 6 * 2 * 4 * N,
      8 * 18 * 4 * N)),
    ("energy", dict(R=64, X=100, Y=100, Z=100),
     (64 * N + 29 * N + 64 * HALO100 + 256, 0, 17 * 64 * N)),
    ("update_int", dict(R=4, X=50, Y=50, Z=50, decided=62_500,
                        lut_entries=130),
     (40 * M + 8 * M + 4 * HALO50 + 520 + 16, 4 * (6 * M + 19 * 62_500),
      0)),
    ("update_f32", dict(R=4, X=50, Y=50, Z=50, decided=62_500),
     (40 * M + 29 * M + 4 * HALO50 + 16, 6 * 4 * M, 18 * 4 * 62_500)),
    # 34 operations per (partition, word, site): the XOR and AND of each of
    # 6 neighbours and 2 per slice rippled through (0, 1, 2, 2, 3, 3)
    ("gather_count", dict(K=8, W=2, nc=62_500, D=6, reached=540_000),
     (8 * 540_000 + 12 * 8 * 62_500 * 6 + 12 * 8 * 2 * 62_500,
      8 * 2 * 62_500 * 34, 0)),
])
def test_every_other_model_is_the_programs(name, kw, want):
    w = getattr(W, name)(**kw)
    assert (w.bytes, w.int32, w.fp32) == want


def _program_work(monkeypatch, **attrs):
    """The program's work module replaced by one with ``attrs``."""
    import sys
    import types
    import repro_torch.kernels as kernels
    fake = types.ModuleType("repro_torch.kernels.work")
    fake.__dict__.update(attrs)
    monkeypatch.setattr(kernels, "work", fake, raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.work", fake)


def test_the_notes_are_read_as_the_program_notes_them(monkeypatch):
    # the program's model, while it has one, costs a noted call
    _program_work(monkeypatch, launch_work=lambda name, operands:
                  W.Work(len(name), operands["n"]))
    assert H.program_model()("abc", {"n": 5}) == W.Work(3, 5)
    # a model that no longer fits its notes, or none at all, reads nothing
    _program_work(monkeypatch, launch_work=lambda name, operands: 1 / 0)
    assert H.program_model()("pbit_bitplane_sweep", {}) is None
    _program_work(monkeypatch)
    assert H.program_model() is None
    # and the frozen model costs every call the lattice cell notes
    assert {"pbit_bitplane_sweep", "brick_energy"} <= set(W.MODELS)
