"""Nothing under perf_bench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either: each module's imports are
read with ``ast`` and their top-level names compared as whole words (the
port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def modules():
    return sorted(HERE.rglob("*.py"))


def test_the_walk_finds_every_part():
    rel = {p.relative_to(HERE).as_posix() for p in modules()}
    assert {"run.py", "harness.py", "work.py", "reference/ea3d.py",
            "engines/lattice.py"} <= rel


@pytest.mark.parametrize("path", modules(),
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.relative_to(HERE).as_posix())
def test_the_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"repro_torch"})


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro.core import x\n"
                 "import jaxlib\nimportlib.import_module('jax.numpy')\n")
    assert top_level_imports(f) == {"repro_torch", "repro", "jaxlib", "jax"}
    assert top_level_imports(f) & JAX == {"repro", "jaxlib", "jax"}
