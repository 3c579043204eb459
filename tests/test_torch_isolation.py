"""The port stands alone: no JAX, nothing of the JAX package, no CPU
fallback.

Each check runs in a fresh interpreter, since this test process has
already imported JAX for the parity tests.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def run_python(code: str, cwd=ROOT, hide_cuda=True, argv=None):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    if hide_cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    cmd = [sys.executable, "-c", code] if argv is None \
        else [sys.executable, *argv]
    return subprocess.run(cmd, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax():
    mods = port_modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LOADED', bad)\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_no_source_of_the_port_imports_jax_or_the_reference():
    # the card's tests run where only PyTorch is installed
    files = sorted(PORT.rglob("*.py")) + EXAMPLES + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    found = [(str(p.relative_to(ROOT)), line, root)
             for p in files for line, root in imported_roots(p)
             if root in ("jax", "jaxlib", "repro")]
    assert found == []


def test_entry_points_raise_without_cuda():
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from repro_torch import make_engine\n"
        "from repro_torch.core.graph import ea3d\n"
        "from repro_torch.core.lattice import build_ea3d_lattice\n"
        "g = ea3d(3, device='cpu')\n"
        "for fn in (lambda: make_engine('lattice', L=4, precision='int8'),\n"
        "           lambda: build_ea3d_lattice(4), lambda: ea3d(3),\n"
        "           lambda: make_engine('gibbs', g),\n"
        "           lambda: make_engine('dsim', g, K=2),\n"
        "           lambda: make_engine('dsim_dist', g, K=2)):\n"
        "    try:\n"
        "        fn()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('ran without CUDA')\n"
        "h = make_engine('lattice', L=4, precision='int8', device='cpu')\n"
        "for name in ('gibbs', 'dsim', 'dsim_dist'):\n"
        "    assert make_engine(name, g, device='cpu').device.type == 'cpu'\n"
        "print('CPU', h.device)\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert "CPU cpu" in out.stdout


def test_chip_smoke_fails_without_cuda_or_outside_the_repo(tmp_path):
    code = "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')"
    out = run_python(code)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run_python(code, cwd=tmp_path, hide_cuda=False)
    assert out.returncode != 0 and '"ok"' not in out.stdout


LM_EXAMPLES = ("torch_serve_lm.py", "torch_train_lm.py")


def test_the_port_has_six_examples():
    """The paper's six examples, and the LM serving and training examples
    beside them."""
    assert [p.name for p in EXAMPLES if p.name not in LM_EXAMPLES] == [
        "torch_eta_sweep.py", "torch_maxcut_gset.py", "torch_quickstart.py",
        "torch_sat3_invertible.py", "torch_serve_dashboard.py",
        "torch_serve_sampling.py"]
    assert all(ROOT / "examples" / n in EXAMPLES for n in LM_EXAMPLES)


def test_lm_entry_points_raise_without_cuda():
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.layers import init_kv_cache\n"
        "from repro_torch.models.lm import build_model\n"
        "from repro_torch.serve.serve_step import greedy_generate\n"
        "cfg = get_config('h2o-danube-1.8b').reduced()\n"
        "m = build_model(cfg, device='cpu')\n"
        "p = m.init(0)\n"
        "b = {'tokens': torch.zeros((1, 4), dtype=torch.int32)}\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.launch.train import main\n"
        "for fn in (lambda: build_model(cfg),\n"
        "           lambda: build_model(get_config('seamless-m4t-medium')),\n"
        "           lambda: init_kv_cache(1, 2, 4, 16),\n"
        "           lambda: greedy_generate(m, cfg, p, b, 2),\n"
        "           lambda: main(['--arch', 'mamba2-370m', '--reduced']),\n"
        "           lambda: make_production_mesh()):\n"
        "    try:\n"
        "        fn()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('ran without CUDA')\n"
        "out = greedy_generate(m, cfg, p, b, 2, device='cpu')\n"
        "print('CPU', tuple(out.shape))\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert "CPU (1, 2)" in out.stdout


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_imports_no_jax(path):
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({str(path)!r}, run_name='not_main')\n"
        "import repro_torch.obs.probe\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LOADED', bad)\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_raises_without_cuda(path):
    # no --device: the example asks for the card and must not run on
    # the CPU
    out = run_python("", argv=[str(path)])
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "CUDA" in out.stderr, out.stderr
    assert out.stdout == ""


def test_eta_probe_raises_without_cuda():
    code = (
        "from repro_torch.obs import eta_probe\n"
        "try:\n"
        "    eta_probe(L=3, sweeps=8)\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA' in str(e), e\n"
        "    print('RAISED')\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout
