"""The port's static-analysis gate (``repro_torch.analyze``): every rule
catches its seeded violation with the right rule id and location, the
modular publish and the declared streams pass, and the committed tree
gates green (``python -m repro_torch.analyze`` exits 0).

The IR rules read recordings: the seeded chunks here run under the same
``OpRecorder`` / ``CommRecorder`` the audit uses (the collectives on a
one-rank gloo group of this process), so the recorders are tested with
the rules.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analyze import deadcode
from repro_torch.analyze.findings import Finding, Waivers, render_report
from repro_torch.analyze.ir_rules import ChunkAudit, audit_chunk
from repro_torch.analyze.lint import lint_file
from repro_torch.analyze.ops_trace import (CommRecorder, OpRecorder,
                                           record_published)

ROOT = Path(__file__).resolve().parents[1]


def _audit(precision="int8", ops=(), syncs=(), comms=(), predicted=None,
           declared_syncs=0, payload_dtypes=(), payload_bytes=(),
           counters=None):
    return ChunkAudit(engine="test", precision=precision, variant="seeded",
                      ops=list(ops), syncs=list(syncs), comms=list(comms),
                      predicted=predicted or {},
                      declared_syncs=declared_syncs,
                      payload_dtypes=tuple(payload_dtypes),
                      payload_bytes=tuple(payload_bytes),
                      counters=counters or {})


def _fired(findings):
    return {f.rule for f in findings}


def _record(fn):
    with OpRecorder() as rec:
        fn()
    return rec


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """A one-rank gloo group of this process (torn down after the
    module's tests)."""
    import torch.distributed as dist
    rdv = tmp_path_factory.mktemp("gloo") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=1, rank=0)
    yield dist
    dist.destroy_process_group()


# ---------------------------------------------------------------- IR layer

def test_ir_a_catches_float_arith_in_int8_body():
    x = torch.arange(8, dtype=torch.int8)
    rec = _record(lambda: (x.to(torch.float32) * 2.0).to(torch.int8))
    found = audit_chunk(_audit("int8", ops=rec.ops))
    assert any(f.rule == "IR-A" and f.loc == "ir:test/int8/seeded"
               and "`mul`" in f.msg for f in found)
    # the same body is legal on the f32 path; integer math is legal on int8
    assert "IR-A" not in _fired(audit_chunk(_audit("f32", ops=rec.ops)))
    ok = _record(lambda: (x.to(torch.int32) * 2 + 1) & 7)
    assert "IR-A" not in _fired(audit_chunk(_audit("bitplane",
                                                   ops=ok.ops)))


def test_ir_b_catches_8bit_wire_in_bitplane_chunk(gloo):
    x = torch.zeros((4, 8), dtype=torch.int8)
    with CommRecorder() as comms:
        gloo.all_gather([torch.empty_like(x)], x)
    assert [c.op for c in comms.calls] == ["all_gather"]
    found = audit_chunk(_audit("bitplane", comms=comms.calls,
                               predicted={"all_gather": 1}))
    assert any(f.rule == "IR-B" and "on the wire" in f.msg for f in found)
    # int32-viewed words are the bit-plane wire
    w = torch.zeros((2, 8), dtype=torch.int32)
    with CommRecorder() as comms:
        gloo.all_gather([torch.empty_like(w)], w)
    assert "IR-B" not in _fired(audit_chunk(_audit(
        "bitplane", comms=comms.calls, predicted={"all_gather": 1},
        payload_dtypes=("int32",), payload_bytes=(64,))))


def test_ir_b_catches_payload_byte_mismatch_and_wide_header(gloo):
    w = torch.zeros((2, 8), dtype=torch.int32)
    with CommRecorder() as comms:
        gloo.all_gather([torch.empty_like(w)], w)      # 64 B, declared 4
        hdr = torch.zeros(2, dtype=torch.int64)        # a 16 B header
        gloo.all_gather([torch.empty_like(hdr)], hdr)
    found = audit_chunk(_audit("int8", comms=comms.calls,
                               payload_dtypes=("int32",),
                               payload_bytes=(4,),
                               predicted={"all_gather": 2}))
    msgs = [f.msg for f in found if f.rule == "IR-B"]
    assert any("declared boundary payload" in m for m in msgs)
    assert any("header" in m and "int64" in m for m in msgs)


def test_ir_c_catches_collective_count_mismatch(gloo):
    t = torch.ones(4)
    with CommRecorder() as comms:
        gloo.all_reduce(t)
    found = audit_chunk(_audit("f32", comms=comms.calls,
                               predicted={"all_reduce": 3}))
    assert any(f.rule == "IR-C" and "all_reduce" in f.msg for f in found)
    ok = audit_chunk(_audit("f32", comms=comms.calls,
                            predicted={"all_reduce": 1}))
    assert "IR-C" not in _fired(ok)


def test_ir_c_counts_every_call_of_a_loop(gloo):
    t = torch.ones(4)
    with CommRecorder() as comms:
        for _ in range(5):
            gloo.all_reduce(t)
        gloo.all_gather([torch.empty_like(t)], t)
    assert comms.counts() == {"all_reduce": 5, "all_gather": 1}
    ok = audit_chunk(_audit("f32", comms=comms.calls,
                            predicted={"all_reduce": 5, "all_gather": 1}))
    assert "IR-C" not in _fired(ok)


def test_ir_d_catches_hidden_host_reads():
    x = torch.arange(6)
    for read in (lambda: x.sum().item(), lambda: bool(x.max() > 2),
                 lambda: x.tolist(), lambda: x.numpy(),
                 lambda: x[torch.tensor(1)], lambda: torch.equal(x, x)):
        rec = _record(read)
        assert len(rec.syncs) == 1, rec.syncs
        found = audit_chunk(_audit("f32", syncs=rec.syncs))
        assert any(f.rule == "IR-D" and f.loc == "ir:test/f32/seeded"
                   for f in found)
        assert "IR-D" not in _fired(audit_chunk(_audit(
            "f32", syncs=rec.syncs, declared_syncs=1)))
    # device work and a CPU tensor's .cpu() (a no-op) read nothing
    rec = _record(lambda: (x * 2).cpu().sum())
    assert rec.syncs == []
    # the recorder put the host-read methods back
    assert torch.Tensor.numpy.__name__ == "numpy"


def test_ir_e_catches_unpublished_counter_and_accepts_modular_publish():
    from repro_torch.core import gibbs
    published = []
    with record_published(published):
        out = gibbs.flips_publish(torch.tensor(2 ** 31 - 1, dtype=torch.int32),
                                  torch.tensor(5, dtype=torch.int64))
    assert published and published[0] is out and out.dtype == torch.int32
    assert gibbs.flips_publish.__name__ == "flips_publish"
    ok = audit_chunk(_audit("f32", counters={"flips": ("int32", True)}))
    assert "IR-E" not in _fired(ok)
    for bad in (("int32", False), ("int64", True)):
        found = audit_chunk(_audit("f32", counters={"flips": bad}))
        assert any(f.rule == "IR-E" and "flips_publish" in f.msg
                   for f in found)


def test_ir_e_checks_seq_modular():
    ok = audit_chunk(_audit("f32", counters={"seq": (1, 1)}))
    assert "IR-E" not in _fired(ok)
    for got in ((1 << 32) + 1, 5, -3):
        found = audit_chunk(_audit("f32", counters={"seq": (got, 1)}))
        assert any(f.rule == "IR-E" and "seq" in f.msg for f in found)


# --------------------------------------------------------------- AST layer

def _lint(tmp_path, src):
    p = tmp_path / "seeded.py"
    p.write_text(textwrap.dedent(src))
    return lint_file(p, "seeded.py")


def test_al_random_catches_undeclared_streams(tmp_path):
    found = _lint(tmp_path, """\
        import numpy as np
        import torch
        import random

        def f(x, g):
            a = torch.rand(4)
            b = np.random.rand(3)
            c = np.random.default_rng()
            x.uniform_()
            torch.manual_seed(0)
            return random.random()
    """)
    assert sorted(int(f.loc.split(":")[1]) for f in found
                  if f.rule == "AL-RANDOM") == [6, 7, 8, 9, 10, 11]


def test_al_random_accepts_declared_streams(tmp_path):
    found = _lint(tmp_path, """\
        import numpy as np
        import torch

        def f(x, g, seed):
            a = torch.rand(4, generator=g)
            b = np.random.default_rng(seed).random(3)
            s = np.random.SeedSequence(seed).generate_state(1)
            x.uniform_(generator=g)
            return torch.randint(0, 4, (2,), generator=g)
    """)
    assert not found


def test_al_key_catches_tensor_in_cache_key(tmp_path):
    found = _lint(tmp_path, """\
        import torch
        _pool_cache = {}

        def put(labels, n):
            k = torch.as_tensor(labels)
            _pool_cache[(k, n)] = 1
    """)
    assert any(f.rule == "AL-KEY" and f.loc == "seeded.py:6" for f in found)


def test_al_key_accepts_digested_keys(tmp_path):
    found = _lint(tmp_path, """\
        import hashlib
        import numpy as np
        _pool_cache = {}

        def put(labels, n):
            k = hashlib.sha1(np.asarray(labels).tobytes()).hexdigest()
            _pool_cache[(k, n)] = 1
    """)
    assert not found


def test_al_lock_catches_unlocked_counter(tmp_path):
    found = _lint(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)  # lock_alias: _lock
                self.n = 0   # guarded_by: _lock

            def bump(self):
                self.n += 1

            def read_ok(self):
                with self._lock:
                    return self.n

            def wait_ok(self):
                with self._cv:
                    return self.n

            def held_ok(self):  # lock_held: _lock
                return self.n
    """)
    assert [f.loc for f in found if f.rule == "AL-LOCK"] == ["seeded.py:10"]


def test_al_except_catches_silent_swallow_around_collectives(tmp_path):
    found = _lint(tmp_path, """\
        import torch.distributed as dist

        def pump(t, ops):
            try:
                dist.all_reduce(t)
            except Exception:
                pass
            try:
                dist.batch_isend_irecv(ops)
            except RuntimeError:
                pass
            try:
                dist.all_reduce(t)
            except Exception as e:
                raise RuntimeError("exchange failed") from e
    """)
    assert [f.loc for f in found if f.rule == "AL-EXCEPT"] == \
        ["seeded.py:6", "seeded.py:10"]


# ---------------------------------------------------------------- deadcode

def _tree(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


def test_al_dead_flags_unreachable_module(tmp_path):
    _tree(tmp_path, {
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/used.py": "X = 1\n",
        "src/repro_torch/by_smoke.py": "Y = 2\n",
        "src/repro_torch/dead.py": "Z = 3\n",
        # the reference package is not the port's: its imports reach nothing
        "src/repro/__init__.py": "",
        "tests/test_used.py": "from repro_torch.used import X\n"
                              "from repro.dead import Q\n",
        "chip_smoke.py": "def f():\n    from repro_torch import by_smoke\n"})
    assert [f.loc for f in deadcode.run(tmp_path)] == \
        ["src/repro_torch/dead.py"]


def test_al_dead_sees_imports_inside_runpy_strings(tmp_path):
    _tree(tmp_path, {
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/sub.py": "Z = 3\n",
        "tests/test_sub.py": 'SNIPPET = """\nfrom repro_torch.sub import Z\n'
                             '"""\n'})
    assert deadcode.run(tmp_path) == []


# ----------------------------------------------------------------- waivers

def test_waivers_match_strip_lines_and_report_unused(tmp_path):
    wf = tmp_path / "waivers.txt"
    wf.write_text("AL-DEAD  src/repro_torch/x.py   # entry point\n"
                  "IR-D     ir:lattice/*           # never matched\n")
    w = Waivers.load(wf)
    assert w.match(Finding("AL-DEAD", "src/repro_torch/x.py:12", "d")) == \
        "entry point"
    assert w.match(Finding("AL-DEAD", "src/repro_torch/y.py", "d")) is None
    assert [e[0] for e in w.unused()] == ["IR-D"]
    wf.write_text("AL-DEAD src/repro_torch/x.py\n")
    with pytest.raises(ValueError):
        Waivers.load(wf)


def test_render_report_exit_code():
    w = Waivers([], path=None)
    text, code = render_report({"lint": []}, w)
    assert code == 0 and "CLEAN" in text
    text, code = render_report(
        {"lint": [Finding("AL-KEY", "a.py:1", "bad key")]}, w)
    assert code == 1 and "FAIL" in text and "AL-KEY" in text


# --------------------------------------------------- the tree's own gate

def test_audit_list_covers_every_engine_precision():
    from repro_torch.analyze.configs import audit_specs
    from repro_torch.engines.base import ENGINE_PRECISIONS
    specs = list(audit_specs())
    covered = {(e, p) for e, p, *_ in specs}
    assert covered == {(e, p) for e, ps in ENGINE_PRECISIONS.items()
                       for p in ps}
    variants = {(e, v) for e, _, v, *_ in specs}
    for eng in ("dsim_dist", "lattice"):
        assert (eng, "degrade") in variants
        assert (eng, "degrade+codes") in variants


def test_repo_gates_green(tmp_path):
    """``python -m repro_torch.analyze`` on the committed tree: every
    configuration recorded (in this process's device and on two gloo
    ranks), the lint and the dead-code report, exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "findings.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.analyze",
                        "--device", "cpu", "--json", str(out)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert "analyze: CLEAN" in r.stdout
    import json
    sections = json.loads(out.read_text())["sections"]
    assert set(sections) == {"ir", "lint", "deadcode"}
    assert "ir:ranks" not in r.stdout
