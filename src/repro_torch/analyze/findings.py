"""Structured findings and the committed waiver file; port of
``repro.analyze.findings``.

A :class:`Finding` is one rule violation: rule id, location (``file:line``
for AST rules, ``ir:<engine>/<precision>/<variant>`` for IR rules), a
one-line message, and a fix-it hint.  Waivers live in a committed text
file (``waivers.txt`` beside this module), so every suppression carries a
rationale reviewed like code.

Waiver file syntax (one per line, ``#`` starts the rationale)::

    AL-DEAD  src/repro_torch/analyze/__main__.py  # python -m entry point
    IR-D     ir:dsim_dist/*/degrade*              # <why it is exempt>

The location pattern is fnmatch-matched against the finding location with
any trailing ``:line`` stripped, so waivers do not rot when a file is
edited above the waived line.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import List, Optional, Tuple

__all__ = ["Finding", "Waivers", "render_report"]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # "IR-A".."IR-E", "AL-RANDOM", "AL-KEY", ...
    loc: str             # "src/repro_torch/x.py:123" | "ir:lattice/int8/x"
    msg: str             # one-line statement of the violation
    hint: str = ""       # how to fix (or how to waive with a rationale)

    @property
    def loc_base(self) -> str:
        """Location with any trailing line number stripped (waiver key)."""
        head, sep, tail = self.loc.rpartition(":")
        if sep and tail.isdigit():
            return head
        return self.loc

    def render(self) -> str:
        s = f"{self.rule:10s} {self.loc}: {self.msg}"
        if self.hint:
            s += f"\n{'':10s} fix: {self.hint}"
        return s

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Waivers:
    """Parsed waiver file: (rule, location-pattern, rationale) triples."""

    def __init__(self, entries: List[Tuple[str, str, str]],
                 path: Optional[str] = None):
        self.entries = entries
        self.path = path
        self._hits = [0] * len(entries)

    @classmethod
    def load(cls, path) -> "Waivers":
        entries = []
        try:
            with open(path) as f:
                lines = f.readlines()
        except FileNotFoundError:
            return cls([], path=str(path))
        for ln in lines:
            code, _, rationale = ln.partition("#")
            parts = code.split()
            if not parts:
                continue
            if len(parts) != 2 or not rationale.strip():
                raise ValueError(
                    f"{path}: bad waiver line {ln.rstrip()!r} - expected "
                    "'RULE location-pattern  # rationale'")
            entries.append((parts[0], parts[1], rationale.strip()))
        return cls(entries, path=str(path))

    def match(self, finding: Finding) -> Optional[str]:
        """Rationale of the first waiver covering this finding, else None."""
        for i, (rule, pat, rationale) in enumerate(self.entries):
            if rule == finding.rule and (
                    fnmatch.fnmatch(finding.loc_base, pat)
                    or fnmatch.fnmatch(finding.loc, pat)):
                self._hits[i] += 1
                return rationale
        return None

    def unused(self) -> List[Tuple[str, str, str]]:
        """Waivers that matched nothing this run (candidates for removal)."""
        return [e for e, h in zip(self.entries, self._hits) if h == 0]


def render_report(sections: dict, waivers: Waivers,
                  json_path: Optional[str] = None) -> Tuple[str, int]:
    """(report text, exit code) for {section: [Finding, ...]}.

    Waived findings are listed with their rationale and don't gate; the
    exit code is the number of unwaived findings (0 == green).
    """
    lines, unwaived_total = [], 0
    payload = {}
    for name, findings in sections.items():
        active, waived = [], []
        for f in findings:
            rationale = waivers.match(f)
            (waived if rationale is not None else active).append(
                (f, rationale))
        unwaived_total += len(active)
        lines.append(f"== {name}: {len(active)} finding(s)"
                     f"{f', {len(waived)} waived' if waived else ''} ==")
        for f, _ in active:
            lines.append(f.render())
        for f, rationale in waived:
            lines.append(f"  [waived: {rationale}] {f.rule} {f.loc}")
        payload[name] = {
            "findings": [f.as_dict() for f, _ in active],
            "waived": [dict(f.as_dict(), rationale=r) for f, r in waived],
        }
    for rule, pat, rationale in waivers.unused():
        lines.append(f"note: unused waiver {rule} {pat!r} ({rationale})")
    verdict = "CLEAN" if unwaived_total == 0 else "FAIL"
    lines.append(f"analyze: {verdict} - {unwaived_total} unwaived "
                 "finding(s)")
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"sections": payload,
                       "unwaived": unwaived_total}, f, indent=2)
    return "\n".join(lines), (1 if unwaived_total else 0)
