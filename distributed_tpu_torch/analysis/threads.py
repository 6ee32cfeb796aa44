"""Rules ``thread-hygiene`` and ``writer-thread``.

``thread-hygiene`` — every ``threading.Thread(...)`` in the tree must be
``daemon=True`` and carry a literal ``dtpu-*`` name (the JAX package's
rule and prefix, which the port's threads share): the tests' autouse
teardown (``tests/conftest.py``) asserts that no live ``dtpu-*`` thread
survives a test, which polices only threads that ARE named. A thread
that must be abandonable escapes with ``# dtpu-lint:
allow[thread-hygiene]`` and a rationale.

``writer-thread`` — background checkpoint and mirror writers (a
``Thread`` whose name matches ``dtpu-*writer``: the port's
``dtpu-ckpt-writer``, ``dtpu-shard-writer`` and ``dtpu-buddy-writer``)
must never reach a collective or wait on the card. A collective on a
writer thread deadlocks the gang the moment one process's writer runs
ahead of a peer's main thread (the reason ``ShardedCheckpointer`` defers
its commit barrier to the next main-thread save or wait). The rule walks
the writer target's static call graph (same-file function and method
resolution by name) and flags any reachable call of

- a ``torch.distributed`` collective or barrier (``dist.all_reduce``,
  ``dist.barrier``, ...; the names no other library uses are flagged
  on any receiver, as the JAX rule flags ``psum``),
- a function of the port's ``parallel/collectives.py`` (each issues
  collectives over a process group),
- a synchronization with the card: ``torch.cuda.synchronize`` or
  ``.item()`` (the writers copy on a side stream after an event; a
  device-wide sync would wait on the training step's work).

Findings anchor at the ``Thread(...)`` construction site (the place that
decides what runs on the writer), with the call chain in the message.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Tuple

from .core import (
    Finding,
    SourceTree,
    call_name,
    dotted_name,
    literal_str_prefix,
    register,
)

WRITER_NAME_RE = re.compile(r"dtpu-[\w.-]*writer")

#: torch.distributed's collectives whose names nothing else uses: flagged
#: on any receiver (a bare name imported from torch.distributed too).
_DIST_TERMINALS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "barrier", "monitored_barrier",
    "broadcast_object_list", "batch_isend_irecv", "isend", "irecv",
})

#: torch.distributed's collectives with common names: flagged only on
#: ``dist.`` / ``torch.distributed.``.
_DIST_ONLY = frozenset({
    "broadcast", "reduce", "gather", "scatter", "send", "recv",
    "gather_object", "scatter_object_list",
})

#: The functions of the port's ``parallel/collectives.py`` that run
#: collectives over a process group (on ``collectives.`` or bare).
PORT_COLLECTIVES = frozenset({
    "gather", "gather_leaf", "start_gather", "start_owner_copy",
    "gather_full", "all_gather_blocks", "leaf_sums", "copy_to_group",
    "reduce_from_group", "gather_last", "split_last", "ppermute",
    "move_chunks", "ulysses_to_heads", "ulysses_to_seq",
})


def denied_on_writer(dotted: str) -> Optional[str]:
    """Why a call is forbidden on a dtpu-*writer thread, or None."""
    parts = dotted.split(".")
    tail = parts[-1]
    on_dist = parts[0] == "dist" or dotted.startswith("torch.distributed.")
    if tail in _DIST_TERMINALS or (on_dist and tail in _DIST_ONLY):
        return "collective"
    if tail in PORT_COLLECTIVES and (len(parts) == 1
                                     or parts[-2] == "collectives"):
        return "collective"
    if dotted == "torch.cuda.synchronize" or tail == "item":
        return "device sync"
    return None


def function_index(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """Every function/method def in the file, keyed by bare name (the
    resolution unit for the same-file call-graph walk; same-name defs
    are all visited — an over-approximation that errs toward flagging)."""
    idx: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            idx.setdefault(node.name, []).append(node)
    return idx


def _thread_calls(sf) -> Iterable[ast.Call]:
    bare_ok = any(
        isinstance(n, ast.ImportFrom) and n.module == "threading"
        and any(a.name == "Thread" for a in n.names)
        for n in ast.walk(sf.tree)
    )
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = call_name(node)
        if dotted == "threading.Thread" or (bare_ok and dotted == "Thread"):
            yield node


def _kw(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _has_spread(call: ast.Call) -> bool:
    return any(kw.arg is None for kw in call.keywords)


@register
class ThreadHygieneRule:
    name = "thread-hygiene"

    def check(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        for sf in tree.files:
            for call in _thread_calls(sf):
                if _has_spread(call):
                    continue  # **kwargs: statically opaque
                probs = []
                daemon = _kw(call, "daemon")
                if not (isinstance(daemon, ast.Constant)
                        and daemon.value is True):
                    probs.append("missing daemon=True (a non-daemon "
                                 "background thread blocks interpreter "
                                 "exit on a crash)")
                name_val = _kw(call, "name")
                prefix = literal_str_prefix(name_val) \
                    if name_val is not None else None
                if prefix is None or not prefix.startswith("dtpu-"):
                    probs.append("missing a literal name='dtpu-*' (the "
                                 "conftest leak checker only polices "
                                 "named dtpu-* threads)")
                for p in probs:
                    findings.append(Finding(
                        self.name, sf.rel, call.lineno, f"Thread(...) {p}",
                    ))
        return findings


@register
class WriterThreadRule:
    name = "writer-thread"

    def check(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        for sf in tree.files:
            idx = function_index(sf.tree)
            for call in _thread_calls(sf):
                name_val = _kw(call, "name")
                label = literal_str_prefix(name_val) \
                    if name_val is not None else None
                if label is None or not WRITER_NAME_RE.match(label):
                    continue
                target = _kw(call, "target")
                tname = dotted_name(target) if target is not None else None
                if tname is None:
                    continue
                tname = tname.split(".")[-1]
                for dotted, chain, why in self._walk(tname, idx):
                    findings.append(Finding(
                        self.name, sf.rel, call.lineno,
                        f"writer thread '{label}' statically reaches "
                        f"{why} '{dotted}' via "
                        + " -> ".join(chain)
                        + " (collectives and device syncs are "
                          "forbidden on dtpu-*writer threads: a writer "
                          "ahead of a peer's main thread deadlocks the "
                          "gang — defer to the next main-thread "
                          "save/wait)",
                    ))
        return findings

    def _walk(self, root: str, idx) -> List[Tuple[str, List[str], str]]:
        """Denied calls reachable from ``root`` through same-file defs:
        ``(denied dotted name, [root, ..., enclosing fn], reason)``."""
        out: List[Tuple[str, List[str], str]] = []
        seen_fn = set()
        seen_bad = set()
        stack: List[Tuple[str, Tuple[str, ...]]] = [(root, (root,))]
        while stack:
            fname, chain = stack.pop()
            if fname in seen_fn:
                continue
            seen_fn.add(fname)
            for node in idx.get(fname, ()):
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    dotted = call_name(sub)
                    if dotted is None:
                        continue
                    why = denied_on_writer(dotted)
                    if why is not None:
                        if dotted not in seen_bad:
                            seen_bad.add(dotted)
                            out.append((dotted, list(chain), why))
                        continue
                    tail = dotted.split(".")[-1]
                    if tail in idx and tail not in seen_fn:
                        stack.append((tail, chain + (tail,)))
        return out
