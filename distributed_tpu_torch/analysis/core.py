"""dtt-lint core: source model, findings, allowlist, baseline, runner.

The port's counterpart of ``distributed_tpu/analysis/core.py``, the same
engine: an AST-level analyzer with a pluggable rule registry, run as the
``dtt-lint`` console script. The port's hardest cross-cutting rules (no
JAX anywhere and no torch in its controller-side modules at import,
writer threads that never reach a collective, purity of the code a CUDA
graph captures, event-schema agreement, thread hygiene) are checked by
parsing the source; nothing here imports the code under analysis.

Vocabulary:

- :class:`SourceFile` / :class:`SourceTree` — parsed ``.py`` files with
  repo-relative paths and dotted module names. Parsing is the only I/O,
  so the linter can lint a tree that would not even import.
- :class:`Finding` — one violation, rendered ``path:line: RULE-ID
  message``. The baseline identity is ``(rule, path, message)``: line
  numbers drift with unrelated edits and are deliberately excluded.
- Allowlist — ``# dtpu-lint: allow[rule-id]`` on (or one line above)
  the offending line suppresses that rule there. The syntax is the JAX
  package's, so one comment means the same to both linters. For a
  finding anchored at a multi-line statement the comment goes on the
  statement's first line.
- Baseline — a checked-in text file of findings deliberately kept
  (``<rule> <path> :: <message>`` lines, ``#`` comments). ``dtt-lint
  --write-baseline`` regenerates it from the current findings.

Rules register via :func:`register` and implement
``check(tree) -> List[Finding]``.

Free of torch (and of JAX) at import.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ALLOW_RE = re.compile(r"dtpu-lint:\s*allow\[([a-z0-9_,-]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    @property
    def baseline_key(self) -> str:
        # Line-number-free: a baselined finding survives unrelated edits
        # above it. Messages therefore must not embed line numbers.
        return f"{self.rule} {self.path} :: {self.message}"


class SourceFile:
    """One parsed module: AST + text + allowlist-comment lookup."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        parts = path.relative_to(root).with_suffix("").parts
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        self.module = ".".join(parts)

    def _line_allows(self, rule: str, lineno: int) -> bool:
        if not (1 <= lineno <= len(self.lines)):
            return False
        m = ALLOW_RE.search(self.lines[lineno - 1])
        return bool(m) and rule in m.group(1).split(",")

    def allows(self, rule: str, lineno: int) -> bool:
        """True when ``# dtpu-lint: allow[rule]`` sits on the line or the
        line immediately above it (the comment-above idiom for lines
        already at width)."""
        return (self._line_allows(rule, lineno)
                or self._line_allows(rule, lineno - 1))


class SourceTree:
    """Every ``.py`` file under the scan roots, parsed once.

    Module names derive from the path relative to each root's PARENT, so
    scanning ``<repo>/distributed_tpu_torch`` yields
    ``distributed_tpu_torch.x.y`` names and a synthetic fixture tree
    ``tmp/pkg`` yields ``pkg.mod``: the import-graph rule works
    identically on both.
    """

    def __init__(self, paths: Sequence[Path]):
        self.files: List[SourceFile] = []
        self.errors: List[str] = []
        by_module: Dict[str, SourceFile] = {}
        for p in paths:
            p = Path(p).resolve()
            # A package dir (has __init__.py) contributes its own name to
            # module paths (scan distributed_tpu_torch/ -> its .x.y);
            # a plain workspace dir does not (scan tmp/ -> pkg.mod for
            # tmp/pkg/mod.py).
            is_pkg = p.is_dir() and (p / "__init__.py").exists()
            root = p.parent if (is_pkg or p.is_file()) else p
            candidates = (
                sorted(p.rglob("*.py")) if p.is_dir() else [p]
            )
            for f in candidates:
                if "__pycache__" in f.parts:
                    continue
                try:
                    sf = SourceFile(f, root)
                except (OSError, SyntaxError, ValueError) as e:
                    self.errors.append(f"{f}: unparseable ({e})")
                    continue
                self.files.append(sf)
                by_module[sf.module] = sf
        self.by_module = by_module

    def find_file(self, name: str) -> Optional[SourceFile]:
        """The first file whose basename matches ``name`` (e.g. a tree's
        own ``event_schema.py``)."""
        for sf in self.files:
            if sf.path.name == name:
                return sf
        return None


# ------------------------------------------------------------ registry
_RULES: Dict[str, type] = {}


def register(cls):
    """Class decorator: adds the rule to the registry under ``cls.name``."""
    _RULES[cls.name] = cls
    return cls


def rule_names() -> List[str]:
    _load_builtin_rules()
    return sorted(_RULES)


def _load_builtin_rules():
    # Imported here (not at module top) so core stays import-cycle-free:
    # the rule modules import core for Finding/register.
    from . import events as _e  # noqa: F401
    from . import imports as _i  # noqa: F401
    from . import purity as _p  # noqa: F401
    from . import threads as _t  # noqa: F401


def make_rules(names: Optional[Iterable[str]] = None, **overrides):
    """Instantiate rules by name (default: all registered). ``overrides``
    maps rule name -> kwargs dict for that rule's constructor (the CLI
    uses it for --jax-free manifest additions)."""
    _load_builtin_rules()
    selected = list(names) if names is not None else sorted(_RULES)
    out = []
    for n in selected:
        if n not in _RULES:
            raise KeyError(
                f"unknown rule {n!r} (known: {', '.join(sorted(_RULES))})"
            )
        out.append(_RULES[n](**overrides.get(n, {})))
    return out


def run_rules(tree: SourceTree, rules) -> List[Finding]:
    """All findings from ``rules`` over ``tree``, allowlist applied,
    sorted by (path, line, rule)."""
    findings: List[Finding] = []
    for rule in rules:
        for f in rule.check(tree):
            sf = next((s for s in tree.files if s.rel == f.path), None)
            if sf is not None and sf.allows(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


# ------------------------------------------------------------ baseline
def load_baseline(path) -> List[str]:
    """Baseline keys from a checked-in file: one ``<rule> <path> ::
    <message>`` per line, ``#`` comments and blanks ignored. Missing
    file = empty baseline."""
    try:
        text = Path(path).read_text()
    except OSError:
        return []
    keys = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        keys.append(line)
    return keys


def write_baseline(path, findings: Sequence[Finding]) -> None:
    lines = [
        "# dtt-lint baseline — findings deliberately kept, with rationale.",
        "# One `<rule> <path> :: <message>` per line; regenerate with",
        "#   dtt-lint --write-baseline",
        "# Prefer a `# dtpu-lint: allow[rule]` comment AT the code site for",
        "# single-line keeps; use this file for tree-level decisions.",
        "",
    ]
    lines += [f.baseline_key for f in findings]
    Path(path).write_text("\n".join(lines) + "\n")


def apply_baseline(findings: Sequence[Finding],
                   keys: Sequence[str]) -> Tuple[List[Finding], int]:
    """(kept findings, suppressed count)."""
    keyset = set(keys)
    kept = [f for f in findings if f.baseline_key not in keyset]
    return kept, len(findings) - len(kept)


# ---------------------------------------------------------- AST helpers
def dotted_name(node) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None. ``self.x`` and
    ``cls.x`` drop the receiver (``x``) so method calls resolve by name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        if node.id not in ("self", "cls"):
            parts.append(node.id)
    elif parts:
        # computed receiver (f(x).attr, d[k].attr): keep the attr chain
        pass
    else:
        return None
    return ".".join(reversed(parts)) if parts else None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def iter_module_scope(tree: ast.Module):
    """Statements that execute at import time: module-level statements,
    recursing into If/Try/With and ClassDef bodies (all run at import)
    but never into function bodies (those run at call time)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With, ast.For,
                             ast.While, ast.ClassDef)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                for child in getattr(node, field, []):
                    if isinstance(child, ast.ExceptHandler):
                        stack.extend(child.body)
                    else:
                        stack.append(child)


def literal_str_prefix(node) -> Optional[str]:
    """The static string prefix of a str constant or f-string (the part
    before the first interpolation); None for non-strings."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant) \
                and isinstance(node.values[0].value, str):
            return node.values[0].value
        return ""  # f-string starting with an interpolation
    return None
