"""The four readers of the program's own spans (``spans.py``;
``metrics/host_syncs_per_job.py``, ``sync_idle_share.py``,
``entry_self_ms_per_job.py``, ``wrapper_host_us.bitplane_sweep.py``) on a
synthetic timeline, on one with no program span, and on the profile of a
small job of the port on the CPU."""

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from perf_bench import harness as H
from perf_bench import spans as P
from perf_bench import timeline as TL

CELL = "ea3d-L100-lattice.bitplane-R64"
METRICS = ("host_syncs_per_job", "sync_idle_share", "entry_self_ms_per_job",
           "wrapper_host_us.bitplane_sweep")


def rt(name, a, b):
    return ("repro_torch." + name, float(a), float(b))


def synthetic(shift=0.0):
    """Two traced jobs, [0, 100) and [200, 300) us.  Job 0: the hand-over,
    then run_recorded with a flip read, two chunks (each opened by a
    schedule upload, with wrappers and an exchange inside), a record point
    and its flip read.  Job 1: one chunk with two wrappers.  One sync and
    one wrapper lie outside the jobs.  Each sync in the jobs holds the
    host's wait, which returns at 10, 19, 57, 92.5 and 214; the host next
    puts work on the card at 13.5 (a copy), 23, 61, never in job 0 after
    92.5, and at 229.  ``shift`` moves the card's clock against the
    host's."""
    host = [rt("entry.shard_state", 1, 3),
            rt("entry.run_recorded", 5, 95),
            rt("sync.flips_read", 6, 10),
            ("cudaMemcpyAsync", 6.0, 6.4),
            ("cudaStreamSynchronize", 6.5, 10.0),
            rt("driver.chunk", 12, 50),
            rt("sync.schedule_upload", 12, 20),
            ("aten::to", 12.0, 20.0), ("cudaMemcpyAsync", 13.5, 14.0),
            ("cudaStreamSynchronize", 14.5, 19.0),
            rt("wrapper.pbit_bitplane_sweep", 22, 30),
            ("cudaLaunchKernel", 23.0, 23.5),
            rt("engine.exchange", 31, 33),
            rt("wrapper.pbit_bitplane_sweep", 34, 43),
            ("cudaLaunchKernel", 35.0, 35.5),
            rt("driver.chunk", 52, 80),
            rt("sync.schedule_upload", 52, 58),
            ("cudaMemcpyAsync", 52.5, 53.0),
            ("cudaStreamSynchronize", 53.0, 57.0),
            rt("wrapper.pbit_bitplane_sweep", 60, 70),
            ("cudaLaunchKernel", 61.0, 61.5),
            rt("driver.record", 82, 90),
            rt("sync.flips_read", 91, 93),
            ("cudaStreamSynchronize", 91.5, 92.5),
            rt("sync.flips_read", 150, 160),
            ("cudaStreamSynchronize", 151.0, 159.0),
            rt("wrapper.pbit_bitplane_sweep", 150, 151),
            rt("entry.run_recorded", 205, 290),
            rt("driver.chunk", 210, 250),
            rt("sync.schedule_upload", 210, 215),
            ("cudaMemcpyAsync", 210.5, 211.0),
            ("cudaStreamSynchronize", 211.0, 214.0),
            rt("wrapper.pbit_bitplane_sweep", 220, 240),
            ("cudaLaunchKernel", 229.0, 229.5),
            rt("wrapper.pbit_bitplane_sweep", 242, 245)]
    device = [("k", 0.0, 7.0), ("k", 7.5, 8.5), ("Memcpy HtoD", 14.0, 16.5),
              ("k", 24.0, 55.0), ("k", 62.0, 85.0), ("k", 200.0, 212.0),
              ("k", 230.0, 300.0)]
    device = [(n, a + shift, b + shift) for n, a, b in device]
    return TL.Timeline(device=device, host=host,
                       jobs=[(0.0, 100.0), (200.0, 300.0)], sweeps=16)


def read(name, tl):
    return H.reader(name)(tl)


def test_program_spans_are_those_in_the_jobs():
    spans = P.program_spans(synthetic())
    assert len(spans) == 18
    assert all(n.startswith("repro_torch.") for n, _, _ in spans)
    assert [s[1] for s in spans] == sorted(s[1] for s in spans)


def test_host_syncs_per_job_counts_the_sync_spans():
    # job 0: two flip reads and two uploads; job 1: one upload
    assert read("host_syncs_per_job", synthetic()) == pytest.approx(2.5)


def test_sync_idle_share_runs_from_each_wait_to_the_next_enqueue():
    # 3.5 + 4 + 4 + 7.5 (to job 0's end) + 15 us of 200 us; the copy
    # inside the first upload, before its wait, does not end a drain
    assert read("sync_idle_share", synthetic()) == pytest.approx(17.0)


@pytest.mark.parametrize("shift", [-2000.0, -4.0, 6.0, 2000.0])
def test_sync_idle_share_needs_no_match_to_the_card_clock(shift):
    # the card's clock ahead of the host's or behind it, by a few us or by
    # a whole job: every time the reader takes is the host's
    assert read("sync_idle_share", synthetic(shift)) == pytest.approx(17.0)


def test_a_sync_without_a_wait_adds_no_idle():
    tl = synthetic()
    host = [h for h in tl.host if h[0] != "cudaStreamSynchronize"]
    bare = TL.Timeline(device=tl.device, host=host, jobs=tl.jobs,
                       sweeps=tl.sweeps)
    assert read("sync_idle_share", bare) == 0.0


def test_entry_self_time_leaves_out_the_nested_spans():
    # shard_state 2 us; run_recorded 90 - (4 + 38 + 28 + 8 + 2) = 10 us;
    # job 1's 85 - 40 = 45 us: 57 us over 2 jobs
    assert read("entry_self_ms_per_job", synthetic()) == \
        pytest.approx(0.0285)


def test_self_time_takes_the_union_of_nested_spans():
    spans = [rt("entry.run_recorded", 0, 100), rt("driver.chunk", 10, 50),
             rt("wrapper.x", 20, 30), rt("driver.chunk", 40, 60)]
    assert P.self_us(spans[0], spans) == pytest.approx(50.0)
    assert P.self_us(spans[1], spans) == pytest.approx(30.0)


def test_wrapper_median_of_an_odd_number_of_calls():
    # 8, 9, 10 us in job 0 and 20, 3 us in job 1; the call outside is not
    assert read("wrapper_host_us.bitplane_sweep", synthetic()) == \
        pytest.approx(9.0)


def test_union_merges_overlapping_and_touching_intervals():
    assert P.union([(15.0, 30.0), (10.0, 20.0), (30.0, 31.0),
                    (40.0, 41.0)]) == [(10.0, 31.0), (40.0, 41.0)]


@pytest.mark.parametrize("name", METRICS)
def test_no_program_span_reads_none(name):
    tl = synthetic()
    bare = TL.Timeline(device=tl.device,
                       host=[h for h in tl.host
                             if not h[0].startswith("repro_torch.")],
                       jobs=tl.jobs, sweeps=tl.sweeps)
    assert read(name, bare) is None
    # spans outside the jobs only, or no jobs at all
    outside = TL.Timeline(device=tl.device,
                          host=[rt("sync.flips_read", 150, 160)],
                          jobs=tl.jobs, sweeps=tl.sweeps)
    assert read(name, outside) is None
    assert read(name, TL.Timeline(device=[], host=tl.host, jobs=[],
                                  sweeps=0)) is None


def test_the_cell_reports_the_four():
    spec = H.load_spec(CELL)
    names = [m["name"] for m in spec["per_layer"]]
    assert set(METRICS) <= set(names)
    for m in spec["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL]
            assert m["moves"] == "updates_per_s"
            assert m["source"] == "device_trace"


def test_a_profiled_job_of_the_port_is_read():
    """An L=8 bit-plane job on the CPU inside a ``perf_bench.job`` range:
    the readers count the spans the port left (no device events, so the
    card's gaps are the whole job, which begins outside every sync)."""
    from repro_torch import make_engine
    from repro_torch.core.annealing import constant_schedule
    h = make_engine("lattice", L=8, seed=3, replicas=64,
                    precision="bitplane", device="cpu")
    st0 = h.init_state(seed=5)
    sched = constant_schedule(3.0, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(TL.JOB_SPAN):
            st, rec = h.run_recorded(h.eng.shard_state(st0), sched, [64],
                                     sync_every=8)
    tl = TL.from_profiler(prof, 64, [])
    assert len(tl.jobs) == 1
    # one chunk of 8 iterations: one upload, a flip read at the cursor's
    # start and one at the record point
    assert read("host_syncs_per_job", tl) == 3
    assert read("sync_idle_share", tl) == 0.0
    assert read("entry_self_ms_per_job", tl) > 0
    assert read("wrapper_host_us.bitplane_sweep", tl) > 0
