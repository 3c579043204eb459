"""The paper's examples on the port (``examples/torch_*.py``) on the CPU.

Each example's ``run(device="cpu", ...)`` runs at a reduced size and
prints the reference's lines.  Quickstart's int8 and bit-plane lattice
numbers are held bitwise to the JAX reference's engines at the same
size and seeds, and chip_smoke.py's QUICKSTART_GOLDEN (the reference's
quickstart at its own defaults) is recomputed from the JAX package.
"""

import functools
import importlib.util
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "sat3_invertible", "maxcut_gset", "eta_sweep",
         "serve_sampling", "serve_dashboard")


def load(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_lattice(L, budget, **kw):
    """The reference quickstart's lattice stage: (per-replica energies,
    exact flips)."""
    from repro.core.annealing import ea_schedule
    from repro.engines import make_engine
    eng = make_engine("lattice", L=L, seed=0, **kw)
    st = eng.init_state(seed=0)
    st, rec = eng.run_recorded(st, ea_schedule(budget), [budget],
                               sync_every=8)
    return np.asarray(rec.energies[-1]), rec.flips


@pytest.fixture(scope="module")
def quickstart_small():
    return load("quickstart").run("cpu", L=6, budget=256, apt_sweeps=20)


@pytest.mark.parametrize("precision,replicas", [("int8", 4),
                                                ("bitplane", 32)])
def test_quickstart_lattice_bitwise_to_reference(quickstart_small,
                                                 precision, replicas):
    out = quickstart_small[precision]
    want, flips = ref_lattice(6, 256, replicas=replicas,
                              precision=precision)
    np.testing.assert_array_equal(np.asarray(out["energies"]), want)
    assert out["flips"] == flips


def test_quickstart_prints_the_reference_lines(quickstart_small, capsys):
    out = quickstart_small
    assert out["n_colors"] == 2
    assert set(out["dsim"]) == {"phase", "1", "16", "128", "None"}
    assert all(math.isfinite(v) for v in out["dsim"].values())
    # f32 holds to the int8 pipeline except at tanh ties
    assert len(out["f32"]["energies"]) == 4
    assert out["apt"]["icms"] > 0 and out["apt"]["best"] < 0


def test_quickstart_golden_values_match_jax():
    cs = load_chip_smoke()
    gold = cs.QUICKSTART_GOLDEN
    int8, _ = ref_lattice(10, 2048, replicas=4, precision="int8")
    assert int8.tolist() == gold["int8"]
    bp, flips = ref_lattice(10, 2048, replicas=32, precision="bitplane")
    assert (float(bp.min()), flips) == (gold["bitplane_best"],
                                        gold["bitplane_flips"])


def test_quickstart_output_format(capsys):
    # the budget must reach the largest exchange interval (128)
    load("quickstart").run("cpu", L=4, K=2, budget=128, R=2, apt_L=4,
                           apt_sweeps=10)
    text = capsys.readouterr().out
    assert text.startswith("EA spin glass L=4 (N=64), 2-FPGA-style chain, "
                           "128 sweeps\n")
    assert re.search(r"^lattice x2 replicas \(int8 pipeline, fused\): "
                     r"best E = +-?\d+\.\d, per-replica \[", text, re.M)
    assert re.search(r"^lattice x32 lanes \(bit-plane words, bitplane\): "
                     r"best E = +-?\d+\.\d \([\d,]+ lane-flips\)$", text,
                     re.M)
    assert re.search(r"^APT\+ICM packed \(L=4, 128 lanes / 4 words\)",
                     text, re.M)


def test_sat3_runs_small(capsys):
    out = load("sat3_invertible").run("cpu", n_vars=20, sweeps=256)
    text = capsys.readouterr().out
    assert out["clauses"] == 85
    assert len(out["satisfied"]) == 6 and out["best"] >= 0.85 * 85
    assert re.search(r"^best: \d+/85 = [\d.]+% \(paper", text, re.M)


def test_maxcut_runs_small(capsys):
    out = load("maxcut_gset").run("cpu", rows=4, cols=6, sweeps=40,
                                  trials=2, pilot_sweeps=16)
    text = capsys.readouterr().out
    assert len(out["cuts"]) == 2 and out["best"] == max(out["cuts"])
    assert len(re.findall(r"^trial \d+: cut = \d+ ", text, re.M)) == 2
    assert re.fullmatch(r"[0-9A-F]+\.\.\.", out["hex"])
    assert "verification hex (paper S9 format):\n" + out["hex"] in text


def test_eta_sweep_runs_small(capsys):
    out = load("eta_sweep").run("cpu", L=4, K=2, budget=128, runs=1,
                                S=(1, 8))
    text = capsys.readouterr().out
    assert math.isfinite(out["kappa_mono"])
    assert sorted(out["kappa"]) == [1, 8]
    assert all(math.isfinite(v) for k in out["kappa"].values()
               for v in k.values())
    assert re.search(r"^\s+mono\s+-?\d+\.\d{3}\s+—$", text, re.M)


def test_serve_sampling_runs_small(capsys):
    out = load("serve_sampling").run("cpu", sweeps=64, long_sweeps=512,
                                     stream_at=128)
    text = capsys.readouterr().out
    assert out["recovered_bitwise"]
    assert out["victim"] == "cancelled" and out["preemptions"] >= 0
    assert out["burst_jobs"] == 6 and out["engine_calls"] >= 2
    assert text.count("bitwise == uninterrupted run: True") == 2


def test_serve_dashboard_runs_small(capsys):
    out = load("serve_dashboard").run("cpu", ticks=2, tick_s=0.2)
    text = capsys.readouterr().out
    assert out["job_status"] == "done"
    assert out["degrade"]["detections"] == 1
    assert out["degrade"]["stale_exchanges"] == 1
    assert out["prometheus_head"] > 0
    assert math.isfinite(out["eta"]["measured_eta"])
    assert text.count("[tick ") == 2


@pytest.mark.parametrize("name", NAMES)
def test_main_parses_device_and_reference_flags(name, monkeypatch):
    mod = load(name)
    seen = {}

    def fake_run(device, **kw):
        seen.update(device=device, **kw)
        return {"ok": True}

    monkeypatch.setattr(mod, "run", fake_run)
    assert mod.main(["--device", "cpu"]) == {"ok": True}
    assert seen["device"] == "cpu"
    if name == "sat3_invertible":
        assert seen == dict(device="cpu", n_vars=80, alpha=4.26,
                            sweeps=4000, partitions=4)
    if name == "maxcut_gset":
        assert seen == dict(device="cpu", rows=10, cols=16, sweeps=1500,
                            trials=5)
    with pytest.raises(SystemExit):
        mod.main(["--bogus"])


@pytest.mark.parametrize("name,defaults", [
    ("quickstart", dict(L=10, K=4, budget=2048, R=4, apt_L=6,
                        apt_sweeps=60)),
    ("eta_sweep", dict(L=8, K=4, budget=4096, runs=3, S=(1, 8, 64, 256))),
    ("serve_sampling", dict(sweeps=512, long_sweeps=8192, stream_at=1024)),
    ("serve_dashboard", dict(ticks=8, jobs_per_tick=4, tick_s=1.0)),
    ("sat3_invertible", dict(n_vars=80, alpha=4.26, sweeps=4000,
                             partitions=4)),
    ("maxcut_gset", dict(rows=10, cols=16, sweeps=1500, trials=5, temps=8,
                         pilot_sweeps=80)),
])
def test_run_defaults_are_the_reference_constants(name, defaults):
    import inspect
    sig = inspect.signature(load(name).run)
    got = {k: p.default for k, p in sig.parameters.items()
           if k != "device"}
    assert sig.parameters["device"].default == "cuda"
    assert got == defaults


def test_main_runs_at_reduced_defaults_and_writes_its_record(
        monkeypatch, tmp_path, capsys):
    """``main`` through chip_smoke.py's child, which writes the example's
    result and launch counts to its record file."""
    mod = load("sat3_invertible")
    monkeypatch.setattr(mod, "run", functools.partial(mod.run, sweeps=128))
    record = tmp_path / "record.json"
    out = load_chip_smoke().write_example_record(
        mod, ["--device", "cpu", "--vars", "20"], str(record))
    assert "3SAT n=20 m=85" in capsys.readouterr().out
    rec = json.loads(record.read_text())
    assert rec["result"]["best"] == out["best"]
    assert set(rec["launches"]) >= {"pbit_brick_sweep_int",
                                    "bitplane_gather_count"}
    assert all(v == 0 for v in rec["launches"].values())   # the CPU


def test_examples_import_only_the_port():
    for name in NAMES:
        load(name)
    src = [(ROOT / "examples" / f"torch_{n}.py").read_text() for n in NAMES]
    assert not any(re.search(r"^\s*(from|import) (jax|repro)\b", s, re.M)
                   for s in src)


def test_serve_lm_mirrors_the_reference_example():
    """examples/torch_serve_lm.py: the reference's architectures and
    flags (plus ``--device``), its defaults as ``run``'s, no JAX."""
    import ast
    import inspect
    ref_src = (ROOT / "examples" / "serve_lm.py").read_text()
    tree = ast.parse(ref_src)
    archs = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "ARCHS")
    flags = {c.args[0].value: ast.literal_eval(
        next(k.value for k in c.keywords if k.arg == "default"))
        for c in ast.walk(tree) if isinstance(c, ast.Call)
        and getattr(c.func, "attr", None) == "add_argument"}
    mod = load("serve_lm")
    assert mod.ARCHS == archs
    sig = inspect.signature(mod.run)
    assert sig.parameters["device"].default == "cuda"
    assert {f"--{k.replace('_', '-')}": p.default
            for k, p in sig.parameters.items() if k != "device"} == flags
    src = (ROOT / "examples" / "torch_serve_lm.py").read_text()
    assert not re.search(r"^\s*(from|import) (jax|repro)\b", src, re.M)


def test_serve_lm_main_writes_its_record(tmp_path, capsys):
    """chip_smoke.py phase 11e runs the example through the same child:
    its result per architecture and no hand kernel launched."""
    record = tmp_path / "record.json"
    out = load_chip_smoke().write_example_record(
        load("serve_lm"), ["--device", "cpu", "--max-new", "2", "--batch",
                           "1", "--prompt-len", "4"], str(record))
    rec = json.loads(record.read_text())
    assert list(rec["result"]) == list(out) and len(out) == 4
    assert all(v == 0 for v in rec["launches"].values())
    assert capsys.readouterr().out.count("reduced config") == 4


def _flags(src):
    """{flag: default} of every ``add_argument`` call in ``src``."""
    import ast
    out = {}
    for c in ast.walk(ast.parse(src)):
        if isinstance(c, ast.Call) and getattr(c.func, "attr", None) == \
                "add_argument":
            kw = {k.arg: k.value for k in c.keywords}
            out[c.args[0].value] = (ast.literal_eval(kw["default"])
                                    if "default" in kw else None)
    return out


def test_train_lm_mirrors_the_reference_example():
    """examples/torch_train_lm.py and repro_torch.launch.train: the
    reference's flags and defaults (plus ``--device``, default cuda), the
    reference example's default arguments but for the checkpoint's
    directory (the temp directory, not /tmp), no JAX."""
    import ast
    ref = (ROOT / "src" / "repro" / "launch" / "train.py").read_text()
    mine = (ROOT / "src" / "repro_torch" / "launch" / "train.py").read_text()
    want = _flags(ref)
    got = _flags(mine)
    assert got.pop("--device") == "cuda" and got == want
    tree = ast.parse((ROOT / "examples" / "train_lm.py").read_text())
    ref_argv = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                    if isinstance(n, ast.AugAssign))
    mod = load("train_lm")
    i = ref_argv.index("--ckpt")
    assert mod.DEFAULTS[:i + 1] == ref_argv[:i + 1]
    assert mod.DEFAULTS[i + 2:] == ref_argv[i + 2:]
    assert mod.DEFAULTS[i + 1].startswith(__import__("tempfile")
                                          .gettempdir())
    src = (ROOT / "examples" / "torch_train_lm.py").read_text()
    assert not re.search(r"^\s*(from|import) (jax|repro)\b", src, re.M)


def test_train_lm_main_writes_its_record(tmp_path, capsys):
    """chip_smoke.py phase 12g runs the example through the same child:
    its losses, the step it started from, and no hand kernel launched;
    a second run resumes from the newest checkpoint."""
    args = ["--arch", "mamba2-370m", "--reduced", "--steps", "6", "--batch",
            "2", "--seq", "16", "--ckpt", str(tmp_path / "ck"),
            "--ckpt-every", "3", "--log-every", "3", "--device", "cpu"]
    record = tmp_path / "record.json"
    out = load_chip_smoke().write_example_record(load("train_lm"), args,
                                                 str(record))
    rec = json.loads(record.read_text())
    assert rec["result"]["losses"] == out["losses"] and len(out["losses"]) == 6
    assert rec["result"]["start_step"] == 0
    assert all(v == 0 for v in rec["launches"].values())
    args[args.index("--steps") + 1] = "8"
    again = load("train_lm").main(args)
    assert again["start_step"] == 6 and len(again["losses"]) == 2
    text = capsys.readouterr().out
    assert "restored checkpoint at step 6" in text and "final loss" in text
