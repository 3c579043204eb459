"""AL-DEAD: import-graph reachability over ``src/repro_torch``; port of
``repro.analyze.deadcode``, following ``repro_torch.*`` imports.

Builds the static module import graph by parsing every file (never
importing it), roots the walk at everything ``tests/``, ``benchmarks/``,
``tools/``, ``examples/`` and ``chip_smoke.py`` import, and reports the
modules nothing reaches.  Importing ``repro_torch.x.y`` also executes
``repro_torch/__init__.py`` and ``repro_torch/x/__init__.py``, so package
ancestors (and whatever they import) are implicit edges.

A module that is an entry point (run by ``python -m`` or as a script,
not imported) gets a waiver with that rationale.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Set, Tuple

from .findings import Finding

__all__ = ["import_graph", "reachable", "dead_modules", "run"]

_PKG = "repro_torch"
_ROOT_DIRS = ("tests", "benchmarks", "tools", "examples")
_ROOT_FILES = ("chip_smoke.py",)


def _module_name(py: Path, src: Path) -> str:
    rel = py.relative_to(src).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports_of(py: Path, pkg: str) -> Set[str]:
    """Absolute repro_torch.* module names this file imports (best
    effort)."""
    try:
        tree = ast.parse(py.read_text(), filename=str(py))
    except SyntaxError:
        return set()
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _PKG or a.name.startswith(_PKG + "."):
                    out.add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")
                # level=1 → current package, each extra level pops one
                base = base[:len(base) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if not (mod == _PKG or mod.startswith(_PKG + ".")):
                continue
            out.add(mod)
            for a in node.names:
                out.add(f"{mod}.{a.name}")   # may be a submodule; filtered
    return out


def import_graph(root: Path) -> Tuple[Dict[str, Set[str]], Dict[str, Path]]:
    """(edges, module -> file) over every module in src/repro_torch."""
    src = root / "src"
    files = {_module_name(p, src): p
             for p in sorted((src / _PKG).rglob("*.py"))}
    edges: Dict[str, Set[str]] = {}
    for mod, py in files.items():
        pkg = mod if py.name == "__init__.py" else mod.rpartition(".")[0]
        deps = {d for d in _imports_of(py, pkg) if d in files}
        # importing a module executes every ancestor package __init__
        for d in list(deps) + [mod]:
            parts = d.split(".")
            for i in range(1, len(parts)):
                anc = ".".join(parts[:i])
                if anc in files and anc != mod:
                    deps.add(anc)
        deps.discard(mod)
        edges[mod] = deps
    return edges, files


# imports embedded in code snippets the tests exec in subprocesses
# (run_py("""...""")) are invisible to ast - a raw-text scan of the root
# files catches them
_IMPORT_RE = re.compile(
    r"(?:^|[\s(])(?:from|import)\s+(repro_torch(?:\.\w+)*)", re.MULTILINE)


def _roots(root: Path, known: Set[str]) -> Set[str]:
    out: Set[str] = set()
    files = [root / f for f in _ROOT_FILES if (root / f).is_file()]
    for d in _ROOT_DIRS:
        if (root / d).is_dir():
            files += sorted((root / d).rglob("*.py"))
    for py in files:
        out |= {m for m in _imports_of(py, "") if m in known}
        out |= {m for m in _IMPORT_RE.findall(py.read_text()) if m in known}
    return out


def reachable(edges: Dict[str, Set[str]], roots: Set[str]) -> Set[str]:
    seen, stack = set(), list(roots)
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(edges.get(m, ()))
        # reaching a module pulls in its ancestor packages too
        parts = m.split(".")
        stack.extend(".".join(parts[:i]) for i in range(1, len(parts)))
    return seen & set(edges)


def dead_modules(root: Path) -> List[Tuple[str, Path]]:
    edges, files = import_graph(root)
    live = reachable(edges, _roots(root, set(files)))
    return [(m, files[m]) for m in sorted(files)
            if m not in live and files[m].name != "__init__.py"]


def run(root: Path) -> List[Finding]:
    return [Finding(
        "AL-DEAD", str(py.relative_to(root)),
        f"module `{mod}` is unreachable from tests/, benchmarks/, tools/, "
        "examples/ and chip_smoke.py",
        "delete it, wire it into the tested surface, or waive it with a "
        "rationale (e.g. 'entry point, run via python -m')")
        for mod, py in dead_modules(root)]
