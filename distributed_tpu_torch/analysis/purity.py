"""Rule ``trace-purity``: no host-impure calls in the code a CUDA graph
captures.

The port's counterpart of the JAX rule, which guards ``jax.jit`` and
``lax.scan`` bodies. Here ``compile(steps_per_execution=K)`` captures
each step's forward, loss and backward as a CUDA graph
(``training/step_graph.py``) and replays it K times a dispatch with no
host sync. A host effect inside the captured code runs once, at capture:
``time.*``, a host random draw, an environment read or ``print`` is
frozen into every replay, and a transfer to the host (``.item()``,
``.cpu()``, ``.numpy()``, ``.tolist()``, ``np.asarray`` on a tensor,
``float(tensor)``) or ``torch.cuda.synchronize`` is refused by the
capture, or, outside it, syncs every step of the dispatch.

Captured regions (heuristic, over-approximating):

- the resolved first argument of any ``StepGraph(...)`` construction: a
  function name, a ``lambda`` (with the same-file functions its body
  calls: the lambda only forwards, as ``Model._graph_grad_eval``'s
  forwards to ``Model._grad_eval``), a ``functools.partial(fn, ...)``,
  or a factory call (the factory's body);
- the def that constructs the ``StepGraph`` (``Model._graph_grad_eval``:
  it runs once a step of the dispatch, between replays);
- the body of a ``with torch.cuda.graph(...)`` block;
- any def whose name ends in ``_body`` (the JAX package's naming of
  trace-scoped code, kept for code carried over).

Host work that is outside the capture, or deliberate, escapes with
``# dtpu-lint: allow[trace-purity]`` at the line, with the reason.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from .core import Finding, SourceTree, call_name, dotted_name, register
from .threads import function_index

_CAPTURE_NAMES = frozenset({"StepGraph", "step_graph.StepGraph"})
_GRAPH_CONTEXTS = frozenset({"torch.cuda.graph", "cuda.graph"})
_HOST_TRANSFERS = frozenset({"item", "cpu", "numpy", "tolist"})


def _resolve_captured(node, idx) -> Iterable[ast.AST]:
    """AST regions captured for a ``StepGraph`` argument expression."""
    if isinstance(node, ast.Lambda):
        yield node
        for sub in ast.walk(node.body):
            if isinstance(sub, ast.Call):
                dotted = call_name(sub)
                if dotted is not None:
                    yield from idx.get(dotted.split(".")[-1], ())
    elif isinstance(node, ast.Name):
        yield from idx.get(node.id, ())
    elif isinstance(node, ast.Attribute):
        yield from idx.get(node.attr, ())
    elif isinstance(node, ast.Call):
        dotted = call_name(node)
        if dotted in ("functools.partial", "partial") and node.args:
            yield from _resolve_captured(node.args[0], idx)
        elif dotted is not None:
            yield from idx.get(dotted.split(".")[-1], ())


def traced_regions(sf) -> List[ast.AST]:
    idx = function_index(sf.tree)
    regions: List[ast.AST] = []
    seen: Set[int] = set()

    def add(node):
        if id(node) not in seen:
            seen.add(id(node))
            regions.append(node)

    defs = [n for n in ast.walk(sf.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for node in defs:
        if node.name.endswith("_body"):
            add(node)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and call_name(sub) in \
                    _CAPTURE_NAMES:
                add(node)
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and call_name(node) in _CAPTURE_NAMES \
                and node.args:
            for region in _resolve_captured(node.args[0], idx):
                add(region)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(item.context_expr, ast.Call)
                   and call_name(item.context_expr) in _GRAPH_CONTEXTS
                   for item in node.items):
                for stmt in node.body:
                    add(stmt)
    return regions


def _param_names(region) -> Set[str]:
    if not isinstance(region, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
        return set()
    a = region.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    for extra in (a.vararg, a.kwarg):
        if extra is not None:
            names.append(extra.arg)
    return set(names)


def _impure_call(dotted: str) -> Optional[str]:
    parts = dotted.split(".")
    if parts[0] == "time" and len(parts) > 1:
        return "wall-clock read"
    if dotted.startswith(("np.random.", "numpy.random.")):
        return "host RNG"
    if parts[0] == "random" and len(parts) > 1:
        return "host RNG"
    if dotted in ("os.getenv",) or dotted.startswith("os.environ."):
        return "environment read"
    if dotted == "print":
        return "host I/O"
    if dotted in ("datetime.now", "datetime.datetime.now",
                  "datetime.utcnow", "datetime.datetime.utcnow"):
        return "wall-clock read"
    if dotted in ("np.asarray", "numpy.asarray", "np.array", "numpy.array"):
        return "host transfer"
    if dotted == "torch.cuda.synchronize":
        return "device sync"
    return None


@register
class TracePurityRule:
    name = "trace-purity"

    def check(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        for sf in tree.files:
            for region in traced_regions(sf):
                params = _param_names(region)
                reported: Set[Tuple[int, str]] = set()

                def flag(node, what, why):
                    key = (node.lineno, what)
                    if key in reported:
                        return
                    reported.add(key)
                    findings.append(Finding(
                        self.name, sf.rel, node.lineno,
                        f"{why} '{what}' inside code a CUDA graph "
                        f"captures (a capture freezes a host value into "
                        f"every replay, or refuses a transfer or sync; "
                        f"hoist it out of the captured step, or escape "
                        f"with # dtpu-lint: allow[trace-purity])",
                    ))

                for node in ast.walk(region):
                    if isinstance(node, ast.Call):
                        dotted = call_name(node)
                        if dotted is not None:
                            why = _impure_call(dotted)
                            if why is not None:
                                flag(node, dotted, why)
                                continue
                        if isinstance(node.func, ast.Attribute) \
                                and node.func.attr in _HOST_TRANSFERS:
                            flag(node, f".{node.func.attr}()",
                                 "host transfer")
                        elif isinstance(node.func, ast.Name) \
                                and node.func.id in ("float", "int") \
                                and len(node.args) == 1 \
                                and isinstance(node.args[0], ast.Name) \
                                and node.args[0].id in params:
                            flag(node, f"{node.func.id}(...)",
                                 "host transfer of a captured argument")
                    elif isinstance(node, ast.Attribute):
                        if dotted_name(node) == "os.environ":
                            flag(node, "os.environ", "environment read")
        return findings
