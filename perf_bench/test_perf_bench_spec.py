"""BENCHMARK.json against the rules its names, units and entries keep, and
the harness finding a configuration, a traffic mix and a per-layer metric
that were added as files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perf_bench import harness as H

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
ONE_LINE = re.compile(r"[^\t\n\r]{1,200}")


def names():
    out = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out += [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [k for c in BENCH["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perf_bench/run.py"]
    assert BENCH["paths"] == ["perf_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", names())
def test_names_use_the_allowed_characters(name):
    assert NAME.fullmatch(name), name


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        got = [x["name"] for x in group]
        assert len(got) == len(set(got))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"updates_per_s", "setup_s"} <= set(e2e)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                            "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.fullmatch(m["unit"]) and ONE_LINE.fullmatch(m["layer"])
        assert m["moves"] == "updates_per_s"
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "perf_bench" / "metrics" /
                f"{m['name']}.py").is_file()
        if m["name"].startswith("roofline_share."):
            assert m["unit"] == "%"


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and ONE_LINE.fullmatch(w["why"])
        assert (ROOT / "perf_bench" / "traffic" /
                f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perf_bench/")
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert (ROOT / "perf_bench" / "engines" /
                f"{f['engine']}.py").is_file()
        assert (ROOT / "perf_bench" / "reference" /
                f"{f['reference']}.py").is_file()


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    shutil.copytree(ROOT / "perf_bench", tmp_path / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    (tmp_path / "perf_bench/configs/ea3d-L8-new.json").write_text(
        json.dumps(dict(cfg, name="ea3d-L8-new", L=8)))
    (tmp_path / "perf_bench/traffic/new-mix.json").write_text(
        json.dumps({"replicas": 32, "sweeps": 16}))
    (tmp_path / "perf_bench/metrics/new_metric.py").write_text(
        "def read(tl):\n    return 2.0 * tl.sweeps\n")
    bench["configs"].append(dict(bench["configs"][0], name="ea3d-L8-new",
                                 file="perf_bench/configs/ea3d-L8-new.json"))
    bench["workloads"].append({"name": "ea3d-L8-new.new-mix",
                               "config": "ea3d-L8-new", "traffic": "new-mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "x",
                               "better": "lower", "source": "device_trace",
                               "layer": "engine", "moves": "updates_per_s",
                               "workloads": ["ea3d-L8-new.new-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = H.load_spec("ea3d-L8-new.new-mix", tmp_path)
    assert spec["config"]["L"] == 8
    assert spec["traffic"] == {"replicas": 32, "sweeps": 16}
    assert [m["name"] for m in spec["per_layer"]] == [
        "device_idle_share", "device_ops_per_sweep", "new_metric"]
    tl = H.TL.Timeline(device=[], host=[], jobs=[], sweeps=5)
    assert H.reader("new_metric", tmp_path)(tl) == 10.0
    assert H.adapter(spec["config"], tmp_path).System
    assert H.reference(spec["config"], tmp_path).Machine


@pytest.mark.parametrize("lanes, per_word", [(64, 2), (64, 32), (40, 4)])
def test_the_checked_lanes_cover_every_word_plane(lanes, per_word):
    got = H.J.lane_sample(2 ** 31 + 5, lanes, per_word)
    assert got == sorted(set(got)) and all(0 <= x < lanes for x in got)
    for lo in range(0, lanes, 32):
        assert sum(lo <= x < lo + 32 for x in got) == min(per_word,
                                                          lanes - lo)
    assert got == H.J.lane_sample(2 ** 31 + 5, lanes, per_word)
    if per_word < 32:
        assert any(H.J.lane_sample(s, lanes, per_word) != got
                   for s in range(3))
