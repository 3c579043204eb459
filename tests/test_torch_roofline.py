"""``repro_torch.launch.roofline`` and the kernels' work model against the
reference's ``repro.launch.roofline``, on the CPU.

The reference parses HLO text; the port costs the ``torch.distributed``
calls, aten ops and kernel launches of a recorded chunk.  The same dtype,
shape and group give the same bytes and group size here as in the
reference's parser, and the same collectives the same ring accounting per
kind.  Collectives are recorded on a ``torch.distributed`` "fake" process
group (every call returns at once), made and torn down per case.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.roofline import (_group_size, _shape_bytes,
                                   collective_bytes as ref_collective_bytes)
from repro_torch.analyze.ops_trace import (ChunkTrace, CommRecord,
                                           CommRecorder, LaunchRecord,
                                           LaunchRecorder, OpRecord,
                                           trace_call)
from repro_torch.kernels import _build, work
from repro_torch.launch.roofline import (HW, collective_bytes,
                                         parse_collectives, roofline,
                                         work_bound)


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


# (HLO type text, the tensors of one recorded call): the cases of
# tests/test_property.py::test_hlo_shape_parser
SHAPES = {
    "f32[4,8]{1,0}": [(torch.float32, (4, 8))],
    "(bf16[2,2], u8[16])": [(torch.bfloat16, (2, 2)), (torch.uint8, (16,))],
    "pred[7]": [(torch.bool, (7,))],
    "s32[]": [(torch.int32, ())],
}


@pytest.mark.parametrize("hlo", list(SHAPES))
def test_recorded_bytes_match_the_hlo_shape_parser(hlo):
    """The bytes of a recorded call (one tensor, or a batch of a send and
    a receive) equal the reference's ``_shape_bytes`` of its HLO type."""
    ts = [torch.zeros(sh, dtype=dt) for dt, sh in SHAPES[hlo]]
    with fake_group(2), CommRecorder() as rec:
        if len(ts) == 1:
            dist.all_reduce(ts[0])
        else:
            dist.batch_isend_irecv([dist.P2POp(dist.isend, ts[0], 1),
                                    dist.P2POp(dist.irecv, ts[1], 1)])
    assert rec.calls[0].nbytes == _shape_bytes(hlo)


@pytest.mark.parametrize("line,world", [
    ("replica_groups={{0,1,2,3}}", 4), ("replica_groups=[2,8]<=[16]", 8),
    ("source_target_pairs={{0,1}}", None)])
def test_recorded_group_matches_the_hlo_group_parser(line, world):
    """The group size of a recorded call equals the reference's
    ``_group_size``: an all_reduce over a group of 4 or 8 ranks, and a
    point-to-point pair."""
    t = torch.zeros(4)
    with fake_group(world or 2), CommRecorder() as rec:
        if world is None:
            dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1),
                                    dist.P2POp(dist.irecv, t.clone(), 1)])
        else:
            dist.all_reduce(t)
    assert {c.group for c in rec.calls} == {_group_size(line)}


def _hlo(K: int) -> str:
    """Three collectives over groups of K (one 8-float operand each)."""
    groups = "{{" + ",".join(str(i) for i in range(K)) + "}}"
    return "\n".join([
        "HloModule m", "",
        "ENTRY %main (p: f32[8]) -> f32[8] {",
        "  %p = f32[8]{0} parameter(0)",
        f"  %ag = f32[{8 * K}]{{0}} all-gather(f32[8]{{0}} %p), "
        f"replica_groups={groups}, dimensions={{0}}",
        f"  %ar = f32[8]{{0}} all-reduce(f32[8]{{0}} %p), "
        f"replica_groups={groups}, to_apply=%add",
        "  ROOT %cp = f32[8]{0} collective-permute(f32[8]{0} %p), "
        "source_target_pairs={{0,1}}",
        "}", ""])


@pytest.mark.parametrize("K", [2, 4, 256])
def test_ring_accounting_per_kind_matches_the_reference(K):
    """The same all-gather, all-reduce and point-to-point message give the
    reference's per-kind wire bytes (its ``collective_bytes`` on the HLO
    text) from the port's records, which hold what each rank gives (an
    all_gather's input) and both sides of a message."""
    calls = [CommRecord("all_gather", "float32", (8,), 32, K),
             CommRecord("all_reduce", "float32", (8,), 32, K),
             CommRecord("batch_isend_irecv", "float32", (2,), 64, 2),
             CommRecord("isend", "float32", (8,), 32, 2),
             CommRecord("irecv", "float32", (8,), 32, 2)]
    want_total, want = ref_collective_bytes(_hlo(K))
    got_total, got = collective_bytes(calls)
    assert got == pytest.approx(want) and set(got) == set(want)
    assert got_total == pytest.approx(want_total)
    assert [r["kind"] for r in parse_collectives(calls)] == [
        "all-gather", "all-reduce", "collective-permute"]


def test_work_model_at_the_packed_apt_shape():
    """B7's fused colour phase at phase 9's packed APT shape (G81, 2 x 64
    lanes in W=4 words, colour 0), built on the CPU: the bytes its bound
    read before the model moved into the package, 21,542,288."""
    from repro_torch.core.apt_icm import APTICM
    from repro_torch.core.coloring import greedy_coloring
    from repro_torch.problems.maxcut import gset_like_toroidal, maxcut_to_ising
    g = maxcut_to_ising(gset_like_toroidal(rows=100, cols=200, seed=81,
                                           device="cpu"))
    apt = APTICM(g, greedy_coloring(g.idx, g.w), np.linspace(0.2, 3.0, 64),
                 chains=2, rng="lfsr", packed=True, device="cpu")
    L, lw = apt.L, int(apt._thr_lanes.shape[1])
    w = work.launch_work("bitplane_gather_count:phase", dict(
        sites=apt._sites[0], W=apt.words, R=L, lut_bytes=8 * L * lw + 8 * L))
    assert (apt.words, L) == (4, 128)
    assert w.bytes == 21_542_288 and w.fp32 == 0
    assert work_bound(w)[0] == "bytes"


def test_a_launch_is_never_costed_at_zero():
    """A kernel with no model raises, and so does a counted launch that
    its wrapper did not note."""
    with pytest.raises(ValueError, match="no work model"):
        work.launch_work("pbit_brick_sweep_v2", {})
    with pytest.raises(ValueError, match="not noted"):
        with LaunchRecorder():
            _build.launch_counts["pbit_brick_sweep"] += 1
    _build.launch_counts["pbit_brick_sweep"] -= 1


def test_noted_launches_are_costed_by_the_model():
    """A noted launch becomes a LaunchRecord with its shape and the
    model's work (the f32 sweep at a 7x7x50 brick)."""
    masks = torch.ones((2, 7, 7, 50), dtype=torch.int8)
    shape = dict(R=1, X=7, Y=7, Z=50, n_colors=2, S=4)
    with LaunchRecorder() as rec:
        _build.launch_counts["pbit_brick_sweep"] += 1
        _build.note_launch("pbit_brick_sweep", masks=masks, **shape)
    _build.launch_counts["pbit_brick_sweep"] -= 1
    want = work.sweep_f32(decided=2 * 7 * 7 * 50, **shape)
    assert rec.launches == [LaunchRecord(
        "pbit_brick_sweep", 1, tuple(shape.items()), want.bytes, want.int32,
        want.fp32)]


def test_trace_call_records_bytes_and_matrix_flops():
    a, b = torch.ones(3, 5), torch.ones(5, 2)
    tr = trace_call(lambda: (a @ b) + 1.0)
    byname = {o.name: o for o in tr.ops}
    assert byname["mm"].flops == 2 * 3 * 2 * 5
    assert byname["mm"].nbytes == 4 * (15 + 10 + 6)
    assert tr.out.shape == (3, 2) and tr.launches == [] and tr.comms == []


def test_roofline_terms():
    """Bytes from the glue (views free) and the kernels, operations from
    the kernels, wire from the collectives; the largest term bounds."""
    hw = HW()
    trace = ChunkTrace(
        ops=[OpRecord("view", ("float32",), 400),
             OpRecord("add", ("float32",) * 3, 12_000),
             OpRecord("mm", ("bfloat16",) * 3, 0, 989_000)],
        syncs=[], comms=[CommRecord("irecv", "uint8", (88,), 88, 2)],
        launches=[LaunchRecord("pbit_brick_sweep", 1, (), 3_000, 0,
                               int(hw.fp32_peak * 1e-6))],
        published=[], seconds=0.0, out=None)
    rep = roofline(trace, 256, hw=hw)
    assert rep.bytes_accessed == 15_000 and rep.kernel_bytes == 3_000
    assert rep.t_memory == pytest.approx(15_000 / hw.hbm_bw)
    assert rep.t_compute == pytest.approx(1e-6, rel=1e-6)
    assert rep.t_collective == pytest.approx(88 / hw.link_bw)
    assert rep.bottleneck == "compute" and rep.bound_s == rep.t_compute
    assert rep.per_kind == {"collective-permute": 88.0}
    assert rep.as_dict()["useful_ratio"] is None
