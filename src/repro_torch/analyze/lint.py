"""AST lint over ``src/repro_torch/``; port of ``repro.analyze.lint``.

Four rules:

  AL-RANDOM  randomness only from declared streams: a torch random call
             without ``generator=`` (it reads the global default
             generator), global seeding (``torch.manual_seed``), numpy's
             legacy global-state ``np.random.*`` calls and
             ``default_rng()`` with no seed, and the stdlib ``random``
             module.  ``np.random.default_rng(seed)``, ``SeedSequence``
             and a ``torch.Generator`` are declared streams.
  AL-KEY     unhashable values (arrays, tensors, lists, dicts) in
             cache/pool keys; keys must be hashable by construction
  AL-LOCK    attributes annotated ``# guarded_by: <lock>`` accessed
             outside ``with self.<lock>:`` or ``# lock_held:`` methods
  AL-EXCEPT  a silent ``except: pass`` around a collective or exchange
             call (``torch.distributed``'s included): a swallowed
             boundary failure desynchronises the mesh

Pure ``ast`` and ``tokenize``: the scanned code is never imported.
"""

from __future__ import annotations

import ast
import io
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import Finding

__all__ = ["lint_file", "lint_tree", "LINT_RULES"]

# torch calls that draw from a generator: without generator= they take
# the global default one
_TORCH_RANDOM = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
}
_TENSOR_RANDOM = {
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
}
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                      "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                      "torch.random.manual_seed", "torch.set_rng_state"}
# numpy's declared-stream constructors; every other np.random call reads
# or writes the legacy global state
_NP_STREAMS = {"default_rng", "SeedSequence", "Generator", "PCG64",
               "PCG64DXSM", "Philox", "SFC64", "MT19937", "BitGenerator"}
_STDLIB_RANDOM = {"random", "randint", "choice", "choices", "shuffle",
                  "uniform", "gauss", "sample", "randrange", "seed",
                  "getrandbits", "normalvariate"}

_ARRAY_CONSTRUCTORS = {
    "np.array", "np.asarray", "np.zeros", "np.ones", "np.arange",
    "np.empty", "np.full", "numpy.array", "numpy.asarray",
    "torch.tensor", "torch.as_tensor", "torch.zeros", "torch.ones",
    "torch.arange", "torch.empty", "torch.full", "torch.from_numpy",
}

_KEYED_CONTAINER_MARKERS = ("cache", "pool", "memo")

_COLLECTIVE_CALL_MARKERS = (
    "all_gather", "all_reduce", "batch_isend_irecv", "isend", "irecv",
    "broadcast", "all_to_all", "reduce_scatter", "exchange",
)


def _dotted(node: ast.AST) -> Optional[str]:
    """'np.random.rand' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _comments_by_line(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenizeError:
        pass
    return out


# ---------------------------------------------------------------- AL-RANDOM

def _aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> module for ``import numpy as np`` style imports (and
    ``from numpy import random``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _random_call(name: str, node: ast.Call) -> Optional[str]:
    """Why the call ``name`` (module names resolved) is not a declared
    stream, or None."""
    kws = {k.arg for k in node.keywords}
    parts = name.split(".")
    if name in _TORCH_GLOBAL_SEED:
        return "seeds the global torch generator"
    if parts[0] == "torch" and parts[-1] in _TORCH_RANDOM and \
            "generator" not in kws:
        return "draws from the global torch generator (no generator=)"
    if parts[0] == "numpy" and len(parts) >= 3 and parts[1] == "random":
        if parts[2] not in _NP_STREAMS:
            return "uses numpy's legacy global random state"
        if parts[2] == "default_rng" and not node.args and not kws:
            return "seeds a numpy stream from the OS (no seed)"
    if parts[0] == "random" and len(parts) == 2 and \
            parts[1] in _STDLIB_RANDOM:
        return "uses the stdlib random module's global state"
    return None


def rule_random(path: str, tree: ast.Module, source: str,
                comments: Dict[int, str]) -> List[Finding]:
    out: List[Finding] = []
    alias = _aliases(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func) or "<expr>"
        head, _, rest = name.partition(".")
        why = _random_call(alias.get(head, head) + ("." + rest if rest
                                                     else ""), node)
        if why is None and isinstance(node.func, ast.Attribute) and \
                node.func.attr in _TENSOR_RANDOM and \
                "generator" not in {k.arg for k in node.keywords}:
            why = "draws from the global torch generator (no generator=)"
        if why is None:
            continue
        out.append(Finding(
            "AL-RANDOM", f"{path}:{node.lineno}",
            f"`{name}` {why}",
            "draw from a declared stream: a torch.Generator passed as "
            "generator=, an LFSR state, or np.random.default_rng(seed)"))
    return out


# ------------------------------------------------------------------- AL-KEY

def _array_like_names(fn: ast.AST) -> Set[str]:
    """Names assigned from array constructors within this function."""
    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            cname = _dotted(node.value.func) or ""
            if cname in _ARRAY_CONSTRUCTORS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _key_exprs(node: ast.AST) -> Iterable[Tuple[ast.AST, ast.AST]]:
    """(container expr, key expr) for cache/pool-style keyed stores."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                yield t.value, t.slice
    elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        yield node.value, node.slice
    elif isinstance(node, ast.Call):
        name = _dotted(node.func) or ""
        if name.rsplit(".", 1)[-1] in ("get", "setdefault", "pop") \
                and isinstance(node.func, ast.Attribute) and node.args:
            yield node.func.value, node.args[0]


def _is_keyed_container(expr: ast.AST) -> bool:
    name = (_dotted(expr) or "").lower()
    return any(m in name for m in _KEYED_CONTAINER_MARKERS)


def _unhashable_part(key: ast.AST, array_names: Set[str]) -> Optional[str]:
    parts = list(key.elts) if isinstance(key, ast.Tuple) else [key]
    for p in parts:
        if isinstance(p, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
            return type(p).__name__.lower()
        if isinstance(p, ast.Call):
            cname = _dotted(p.func) or ""
            if cname in _ARRAY_CONSTRUCTORS:
                return cname
        if isinstance(p, ast.Name) and p.id in array_names:
            return f"array-valued `{p.id}`"
    return None


def rule_key(path: str, tree: ast.Module, source: str,
             comments: Dict[int, str]) -> List[Finding]:
    out: List[Finding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Module)):
            continue
        array_names = _array_like_names(fn)
        body = fn.body if isinstance(fn, ast.Module) else [fn]
        for stmt in body:
            for node in ast.walk(stmt):
                for container, key in _key_exprs(node):
                    if not _is_keyed_container(container):
                        continue
                    bad = _unhashable_part(key, array_names)
                    if bad is None:
                        continue
                    out.append(Finding(
                        "AL-KEY", f"{path}:{node.lineno}",
                        f"cache/pool key into "
                        f"`{_dotted(container) or '<expr>'}` contains "
                        f"unhashable {bad}",
                        "build keys hashable by construction: digest "
                        "arrays and tensors, use tuples, never lists, "
                        "dicts or raw arrays"))
    return out


# ------------------------------------------------------------------ AL-LOCK

def _guard_decls(cls: ast.ClassDef, comments: Dict[int, str]):
    """(guarded: attr -> lock, aliases: attr -> lock) from __init__."""
    guarded: Dict[str, str] = {}
    aliases: Dict[str, str] = {}
    for meth in cls.body:
        if not (isinstance(meth, ast.FunctionDef)
                and meth.name == "__init__"):
            continue
        for node in ast.walk(meth):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            cm = comments.get(node.lineno, "")
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                if "guarded_by:" in cm:
                    guarded[t.attr] = cm.split("guarded_by:")[1].split()[0]
                elif "lock_alias:" in cm:
                    aliases[t.attr] = cm.split("lock_alias:")[1].split()[0]
    return guarded, aliases


def _with_lock_spans(meth: ast.FunctionDef, locks: Set[str]):
    """Line spans of ``with self.<lock>:`` blocks (lexical containment)."""
    spans = []
    for node in ast.walk(meth):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            ce = item.context_expr
            if isinstance(ce, ast.Attribute) \
                    and isinstance(ce.value, ast.Name) \
                    and ce.value.id == "self" and ce.attr in locks:
                spans.append((node.lineno, node.end_lineno))
    return spans


def rule_lock(path: str, tree: ast.Module, source: str,
              comments: Dict[int, str]) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded, aliases = _guard_decls(cls, comments)
        if not guarded:
            continue
        for meth in cls.body:
            if not isinstance(meth, ast.FunctionDef) \
                    or meth.name == "__init__":
                continue
            held: Set[str] = set()
            for ln in range(meth.lineno, min(meth.body[0].lineno,
                                             meth.lineno + 3) + 1):
                cm = comments.get(ln, "")
                if "lock_held:" in cm:
                    held.add(cm.split("lock_held:")[1].split()[0])
            for node in ast.walk(meth):
                if not (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"
                        and node.attr in guarded):
                    continue
                lock = guarded[node.attr]
                alias_of = {a for a, l in aliases.items() if l == lock}
                if lock in held or held & alias_of:
                    continue
                spans = _with_lock_spans(meth, {lock} | alias_of)
                if any(lo <= node.lineno <= hi for lo, hi in spans):
                    continue
                out.append(Finding(
                    "AL-LOCK", f"{path}:{node.lineno}",
                    f"`self.{node.attr}` (guarded_by: {lock}) accessed in "
                    f"`{cls.name}.{meth.name}` outside `with "
                    f"self.{lock}:`",
                    f"take the lock, or annotate the method "
                    f"`# lock_held: {lock}` if every caller holds it"))
    return out


# ---------------------------------------------------------------- AL-EXCEPT

def _is_silent(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # docstring / Ellipsis
        return False
    return True


def rule_except(path: str, tree: ast.Module, source: str,
                comments: Dict[int, str]) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        calls = []
        for sub in node.body:
            for n in ast.walk(sub):
                if isinstance(n, ast.Call):
                    name = (_dotted(n.func) or "").rsplit(".", 1)[-1]
                    if any(m in name for m in _COLLECTIVE_CALL_MARKERS):
                        calls.append(name)
        if not calls:
            continue
        for handler in node.handlers:
            if _is_silent(handler):
                out.append(Finding(
                    "AL-EXCEPT", f"{path}:{handler.lineno}",
                    f"silent except around collective/exchange call(s) "
                    f"{sorted(set(calls))}",
                    "a swallowed boundary failure desynchronises the "
                    "mesh: record it in the health state or re-raise"))
    return out


LINT_RULES = (rule_random, rule_key, rule_lock, rule_except)


def lint_file(path: Path, rel: str) -> List[Finding]:
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding("AL-PARSE", f"{rel}:{e.lineno or 0}",
                        f"syntax error: {e.msg}", "")]
    comments = _comments_by_line(source)
    out: List[Finding] = []
    for rule in LINT_RULES:
        out.extend(rule(rel, tree, source, comments))
    return out


def lint_tree(root: Path, subdir: str = "src/repro_torch") -> List[Finding]:
    out: List[Finding] = []
    for path in sorted((root / subdir).rglob("*.py")):
        out.extend(lint_file(path, str(path.relative_to(root))))
    return out
