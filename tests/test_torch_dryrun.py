"""``python -m repro_torch.launch.dryrun`` against ``python -m
repro.launch.dryrun``, on the CPU.

Both run as their own processes, started together: the reference lowers
one chunk of the L=100 instance for 256 and 512 placeholder devices, the
port records one rank's chunk on a "fake" process group of that size.
Their records agree key by key on the wire (``per_kind``), the extras,
the mesh size and the bytes of the brick's arguments; a difference is a
fault of the port, never a tolerance.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
MESHES = {"single_pod_16x16": (256, 704.0),
          "multi_pod_2x16x16": (512, 380.0)}
# the rank's brick's f32 constants: 7 x 7 x 100 and 7 x 7 x 50 sites of
# masks (2 colours, int8), h and w6 (f32) and active (int8), 31 B a site
RESIDENT = {"single_pod_16x16": 151_900, "multi_pod_2x16x16": 75_950}


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **kw)
    return env


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"port"|"reference": {mesh tag: record}} of one ``--all`` run each."""
    tmp = tmp_path_factory.mktemp("dryrun")
    runs = {
        "port": ([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                  "--device", "cpu", "--report-dir", str(tmp / "port")],
                 _env(CUDA_VISIBLE_DEVICES="")),
        "reference": ([sys.executable, "-m", "repro.launch.dryrun", "--all",
                       "--report-dir", str(tmp / "reference")],
                      _env(JAX_PLATFORMS="cpu")),
    }
    procs = {k: subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, (cmd, env) in runs.items()}
    out = {}
    for k, p in procs.items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, f"{k}: {log[-3000:]}"
        out[k] = {m: json.load(open(tmp / k / f"ea3d-1m__sample_chunk__{m}"
                                                f".json"))
                  for m in MESHES}
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_wire_equals_the_reference(records, mesh):
    port, ref = records["port"][mesh], records["reference"][mesh]
    chips, permute = MESHES[mesh]
    assert port["ok"] and ref["ok"]
    assert port["chips"] == ref["chips"] == chips
    assert port["roofline"]["per_kind"] == ref["roofline"]["per_kind"]
    assert port["roofline"]["per_kind"]["collective-permute"] == permute
    assert port["roofline"]["wire_bytes"] == ref["roofline"]["wire_bytes"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_extras_and_arguments_equal_the_reference(records, mesh):
    port, ref = records["port"][mesh], records["reference"][mesh]
    assert port["extras"] == ref["extras"] == {
        "p_bits": 1_000_000, "padded_sites": 1_254_400, "n_colors": 2,
        "sync_every": 4}
    assert port["memory_analysis"]["argument_size_in_bytes"] == \
        ref["memory_analysis"]["argument_size_in_bytes"]
    # each rank holds only its brick's constants on its device
    assert port["memory_analysis"]["resident_problem_bytes"] == \
        RESIDENT[mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_record_of_an_interior_rank(records, mesh):
    """The recorded rank has every neighbour: its keys hold the
    reference's, with the port's times, rank and brick beside them."""
    from repro_torch.launch.dryrun import interior_rank
    port, ref = records["port"][mesh], records["reference"][mesh]
    assert set(ref) - {"lower_s", "compile_s"} <= set(port)
    assert port["build_s"] >= 0 and port["chunk_s"] > 0
    multi = mesh.startswith("multi")
    assert port["rank"] == interior_rank(multi) == 17
    assert port["brick"] == ([7, 7, 50] if multi else [7, 7, 100])
    assert port["device"] == "cpu" and port["launches"] == {}
    assert port["bound_s"] == max(port["roofline"][t] for t in (
        "t_compute", "t_memory", "t_collective"))


def test_dryrun_raises_without_a_card():
    """With no CUDA device and no ``--device cpu`` the dry run raises
    before it starts a process group."""
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all"],
        env=_env(CUDA_VISIBLE_DEVICES=""), cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0
    assert "runs on a CUDA device" in p.stderr and "OK" not in p.stdout
