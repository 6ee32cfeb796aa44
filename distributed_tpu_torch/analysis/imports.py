"""Rule ``jax-free-import``, the port's form: two checks in one rule.

(i) No module of the port imports ``jax``, ``jaxlib`` or
``distributed_tpu`` at module scope: the port stands alone at run time
(its card machine has no JAX). Every scanned file is checked, and the
finding names the import.

(ii) The modules of the manifest ``JAX_FREE_MODULES`` (the port's copies
of the JAX package's manifest modules: the obs surface, the event
transport and schema, logging, the supervisor's controller side, the
fleet's control plane, the launcher and what it stands on, the serving
scheduler, the service's router side, and this linter) stay free of
``torch`` TRANSITIVELY at module scope, as the JAX package's stay free
of ``jax``: a controller process (the supervisor, the event CLI, the
linter on a CI box) imports them without paying for torch.

Mechanics, as the JAX rule's: every file's MODULE-SCOPE imports
(top-level statements, recursing into if/try/with/class bodies, which
all run at import, but never into function bodies) become graph edges.
``from pkg import sub`` resolves to the submodule when one exists in
the scanned tree, else to ``pkg`` (its ``__init__`` defines the symbol,
and runs). The rule walks the closure from each manifest module and
reports the full chain to ``torch`` when one exists.

Scope note: ancestor-package ``__init__`` execution is deliberately NOT
an edge (importing ``a.b.c`` runs ``a/__init__``). The port's top-level
``__init__`` builds the training world, so the file-level graph is the
contract these modules can keep: it bounds what the MODULE ITSELF drags
in.

``dtt-lint --jax-free mod`` appends manifest entries for one run
(fixture trees in tests use this).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from .core import Finding, SourceTree, iter_module_scope, register

#: Never imported by the port, anywhere (check i).
POISON = ("jax", "jaxlib", "distributed_tpu")

#: Never imported at module scope, transitively, by the manifest (ii).
TORCH = ("torch",)

_P = "distributed_tpu_torch."

#: Modules free of torch at import: the port's copies of the JAX
#: package's manifest (which has ``utils.compile_cache``; the port has no
#: counterpart of it). Grow this list whenever a docstring claims a
#: module is free of torch.
JAX_FREE_MODULES: Tuple[str, ...] = tuple(_P + m for m in (
    # observability: importable on controller boxes next to the event log
    "obs",
    "obs.aggregate",
    "obs.cli",
    "obs.export",
    "obs.flight",
    "obs.registry",
    "obs.spans",
    # event transport + schema + logging
    "utils.event_schema",
    "utils.events",
    "utils.logging",
    # resilience controller side (the supervisor runs where torch may not)
    "resilience.elastic",
    "resilience.markers",
    "resilience.policy",
    "resilience.supervisor",
    # fleet control plane (pure host arithmetic)
    "fleet.autoscale",
    "fleet.router",
    # gang launcher + the pieces it stands on
    "cluster.config",
    "cluster.net",
    "launch.core",
    "serving.scheduler",
    # serving service router side (serve_service.worker is spawned,
    # never imported, by these)
    "serve_service",
    "serve_service.protocol",
    "serve_service.quotas",
    "serve_service.service",
    "serve_service.transport",
    # the linter itself
    "analysis",
    "analysis.cli",
    "analysis.core",
    "analysis.events",
    "analysis.imports",
    "analysis.purity",
    "analysis.threads",
))


def module_scope_imports(sf) -> List[Tuple[str, int]]:
    """``(dotted-target, lineno)`` per module-scope import of ``sf``,
    resolved to absolute dotted names (relative levels applied)."""
    is_init = sf.path.name == "__init__.py"
    pkg_parts = sf.module.split(".") if sf.module else []
    if not is_init:
        pkg_parts = pkg_parts[:-1]  # containing package
    out: List[Tuple[str, int]] = []
    for node in iter_module_scope(sf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.append((alias.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                up = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                base = ".".join(up + ([node.module] if node.module else []))
            if not base:
                continue
            for alias in node.names:
                out.append((f"{base}.{alias.name}", node.lineno))
    return out


class ImportGraph:
    """Module-scope import edges over a SourceTree, with resolution:
    ``pkg.sub`` that exists as a scanned module stays itself; ``pkg.sym``
    (a symbol import) falls back to ``pkg``; anything outside the tree
    collapses to its top-level name (``jax.numpy`` -> ``jax``)."""

    def __init__(self, tree: SourceTree):
        self.tree = tree
        self.edges: Dict[str, List[Tuple[str, int]]] = {}
        for sf in tree.files:
            deps: List[Tuple[str, int]] = []
            for target, lineno in module_scope_imports(sf):
                deps.append((self._resolve(target), lineno))
            self.edges[sf.module] = deps

    def _resolve(self, dotted: str) -> str:
        if dotted in self.tree.by_module:
            return dotted
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            cand = ".".join(parts[:cut])
            if cand in self.tree.by_module:
                return cand
        return parts[0]  # external: top-level distribution name

    def chain_to(self, start: str,
                 targets: Sequence[str]) -> Optional[List[str]]:
        """Shortest module chain ``[start, ..., target]`` reaching any of
        ``targets`` through module-scope imports, else None."""
        if start not in self.edges:
            return None
        parent: Dict[str, Optional[str]] = {start: None}
        queue = [start]
        while queue:
            cur = queue.pop(0)
            for dep, _ in self.edges.get(cur, ()):
                if dep in parent:
                    continue
                parent[dep] = cur
                if dep in targets:
                    chain = [dep]
                    at: Optional[str] = cur
                    while at is not None:
                        chain.append(at)
                        at = parent[at]
                    return list(reversed(chain))
                queue.append(dep)
        return None

    def first_hop_line(self, start: str, nxt: str) -> int:
        for dep, lineno in self.edges.get(start, ()):
            if dep == nxt:
                return lineno
        return 1


@register
class JaxFreeImportRule:
    """See module docstring."""

    name = "jax-free-import"

    def __init__(self, manifest: Optional[Sequence[str]] = None,
                 extra_manifest: Sequence[str] = ()):
        base = tuple(manifest) if manifest is not None else JAX_FREE_MODULES
        self.manifest = tuple(base) + tuple(extra_manifest)

    def check(self, tree: SourceTree) -> List[Finding]:
        graph = ImportGraph(tree)
        findings: List[Finding] = []
        for sf in tree.files:
            for dep, lineno in graph.edges.get(sf.module, ()):
                if dep in POISON:
                    findings.append(Finding(
                        self.name, sf.rel, lineno,
                        f"module '{sf.module}' imports '{dep}' at module "
                        f"scope (the port never imports {', '.join(POISON)}"
                        f": it runs where they are not installed)",
                    ))
        tops = {m.split(".")[0] for m in tree.by_module if m}
        for mod in self.manifest:
            sf = tree.by_module.get(mod)
            if sf is None:
                # Only a full scan of the module's package can judge a
                # missing entry (partial/fixture scans skip silently).
                if mod.split(".")[0] in tops:
                    findings.append(Finding(
                        self.name, "<manifest>", 1,
                        f"manifest names unknown module '{mod}' "
                        f"(typo, or the file moved without updating "
                        f"analysis/imports.py)",
                    ))
                continue
            chain = graph.chain_to(mod, TORCH)
            if chain is None:
                continue
            line = graph.first_hop_line(mod, chain[1]) if len(chain) > 1 \
                else 1
            findings.append(Finding(
                self.name, sf.rel, line,
                f"module '{mod}' is declared free of torch at import but "
                f"its module-scope imports reach '{chain[-1]}' via "
                + " -> ".join(chain[1:])
                + " (defer the import into the function that needs it, "
                  "or remove the module from the manifest)",
            ))
        return findings
