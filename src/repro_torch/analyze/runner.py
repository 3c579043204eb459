"""Sections, waivers and the exit code of the port's audit; port of
``repro.analyze.runner``."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from .findings import Finding, Waivers, render_report

__all__ = ["run_ir", "run_lint", "run_deadcode", "run_all",
           "DEFAULT_WAIVER_FILE", "repo_root", "SECTIONS"]

DEFAULT_WAIVER_FILE = Path(__file__).resolve().parent / "waivers.txt"
SECTIONS = ("ir", "lint", "deadcode")


def repo_root() -> Path:
    """The checkout holding this source tree."""
    return Path(__file__).resolve().parents[3]


def run_ir(device=None) -> List[Finding]:
    """Record one chunk of every configuration on ``device`` (``None``:
    the CUDA device) and of the mesh engines on gloo ranks, and audit
    it."""
    from .configs import build_audits, trace_failures
    from .ir_rules import audit_chunk

    audits, failures = build_audits(device)
    out: List[Finding] = trace_failures(failures)
    for a in audits:
        out.extend(audit_chunk(a))
    return out


def run_lint(root: Optional[Path] = None) -> List[Finding]:
    from .lint import lint_tree
    return lint_tree(root or repo_root())


def run_deadcode(root: Optional[Path] = None) -> List[Finding]:
    from . import deadcode
    return deadcode.run(root or repo_root())


def run_all(root: Optional[Path] = None,
            sections: Optional[List[str]] = None,
            waiver_file=None, json_path: Optional[str] = None,
            device=None):
    """(report text, exit code); ``sections`` defaults to all three."""
    root = root or repo_root()
    results: Dict[str, List[Finding]] = {}
    for name in sections or SECTIONS:
        if name == "ir":
            results["ir"] = run_ir(device)
        elif name == "lint":
            results["lint"] = run_lint(root)
        elif name == "deadcode":
            results["deadcode"] = run_deadcode(root)
        else:
            raise ValueError(f"unknown section {name!r}")
    waivers = Waivers.load(waiver_file or DEFAULT_WAIVER_FILE)
    return render_report(results, waivers, json_path=json_path)
