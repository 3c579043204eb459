"""Each per-layer metric's reader, and the timeline arithmetic it rests on,
on synthetic profiler events."""

import pytest
import torch

from perf_bench import harness as H
from perf_bench import timeline as TL
from perf_bench import work as W


def synthetic(calls=()):
    """Two traced jobs of 8 sweeps each: [0, 100) and [200, 300) us, with
    device work [10, 40) (two overlapping kernels), [50, 60) and
    [210, 290), one kernel before the first job and one host operation in
    each gap."""
    device = [("void bitplane_color_kernel<2>(unsigned int*)", 10.0, 30.0),
              ("void bitplane_color_kernel<2>(unsigned int*)", 25.0, 40.0),
              ("Memcpy DtoH (Device -> Pageable)", 50.0, 60.0),
              ("void bitplane_phase_kernel<8, false>(unsigned int*)",
               210.0, 290.0),
              ("void bitplane_color_kernel<2>(unsigned int*)", -50.0, -10.0)]
    host = [("aten::index_select", 40.0, 50.0), ("aten::item", 60.0, 100.0),
            ("aten::empty", 61.0, 62.0), ("perf_bench.job", 0.0, 100.0)]
    return TL.Timeline(device=device, host=host,
                       jobs=[(0.0, 100.0), (200.0, 300.0)], sweeps=16,
                       calls=list(calls))


def test_busy_window_and_gaps():
    tl = synthetic()
    assert tl.window_s == pytest.approx(200e-6)
    assert tl.busy_intervals() == [(10.0, 40.0), (50.0, 60.0),
                                   (210.0, 290.0)]
    assert tl.busy_s == pytest.approx(120e-6)
    assert tl.idle_gaps() == [(0.0, 10.0), (40.0, 50.0), (60.0, 100.0),
                              (200.0, 210.0), (290.0, 300.0)]
    assert tl.host_at(40.0, 50.0) == "aten::index_select"
    assert tl.host_at(60.0, 100.0) == "aten::item"
    assert tl.host_at(0.0, 10.0) == "host: between operations"


def test_device_idle_share():
    assert H.reader("device_idle_share")(synthetic()) == pytest.approx(40.0)
    empty = TL.Timeline(device=[], host=[], jobs=[(0.0, 1.0)], sweeps=1)
    assert H.reader("device_idle_share")(empty) is None


def test_device_ops_per_sweep_counts_only_inside_the_jobs():
    assert H.reader("device_ops_per_sweep")(synthetic()) == pytest.approx(
        4 / 16)


def _call(name, launches, count, work):
    return TL.Call(name, launches, count, work)


def test_roofline_shares_read_their_own_kernel():
    # two #2 calls of 2 launches, 33.5 MB each: 2 x 10 us over 35 us; a
    # call of another kernel (B7's, on the same timeline) is not counted
    w2 = W.Work(bytes=33_500_000)
    w7 = W.Work(bytes=0, int32=int(40e-6 * W.PEAKS["int32"]))
    tl = synthetic([_call("pbit_bitplane_sweep", 2, 2, w2),
                    _call("bitplane_gather_count:phase", 1, 1, w7)])
    assert H.reader("roofline_share.bitplane_sweep")(tl) == pytest.approx(
        100 * 20 / 35)
    assert TL.roofline_share(tl, "bitplane_gather_count:phase",
                             "bitplane_phase_kernel") == pytest.approx(
        100 * 40 / 80)


def test_a_roofline_with_nothing_to_read_reads_nothing():
    tl = synthetic()
    assert H.reader("roofline_share.bitplane_sweep")(tl) is None
    tl = synthetic([_call("pbit_bitplane_sweep", 2, 1, W.Work(10))])
    tl.device = [e for e in tl.device if "color" not in e[0]]
    assert H.reader("roofline_share.bitplane_sweep")(tl) is None


def test_breakdown_ranks_device_ops_and_labels_gaps():
    b = TL.breakdown(synthetic())
    assert b["device_ops"][0] == [
        "void bitplane_phase_kernel<8, false>(unsigned int*)",
        pytest.approx(80e-6)]
    assert len(b["device_ops"]) == 3
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(40e-6)
    assert gaps["host: between operations"] == pytest.approx(30e-6)


def test_notes_alike_are_costed_once():
    masks = torch.ones((2, 4, 4, 4), dtype=torch.int32)
    op = dict(W=2, R=64, X=4, Y=4, Z=4, n_colors=2, S=8, masks=masks,
              lut_entries=130, sched_entries=8)
    seen = []

    def program(name, operands):
        seen.append(name)
        return W.Work(1, 2, 3)
    calls = TL.cost_notes([("pbit_bitplane_sweep", 16, op)] * 3 +
                          [("pbit_bitplane_sweep", 16, dict(op, S=4))],
                          program)
    assert [(c.count, c.launches) for c in calls] == [(3, 16), (1, 16)]
    assert seen == ["pbit_bitplane_sweep"] * 2
    assert calls[0].work == W.bitplane_sweep(2, 64, 4, 4, 4, 2, 8, 128, 130,
                                             8)
