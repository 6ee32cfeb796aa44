"""Repo-aware static analysis of the port (``dtt-lint``).

The JAX package's linter (``dtpu-lint``), carried over to check the
port's own cross-cutting rules by parsing its source:

- ``jax-free-import``   — no module of the port imports ``jax`` or
  ``distributed_tpu`` at module scope, and the manifest's controller-side
  modules stay free of ``torch`` through their TRANSITIVE module-scope
  import graph (imports.py);
- ``writer-thread``     — ``dtpu-*writer`` background threads never
  statically reach a collective or a device sync (threads.py);
- ``trace-purity``      — no host-impure calls in the code a CUDA graph
  captures (purity.py);
- ``event-schema``      — every ``emit(...)`` site agrees with the
  declared event schema in ``utils/event_schema.py`` (events.py);
- ``thread-hygiene``    — every ``threading.Thread`` is daemonized and
  ``dtpu-*``-named (threads.py).

Entry points: the ``dtt-lint`` console script (cli.py, pyproject),
``python -m distributed_tpu_torch.analysis.cli``, and the library
surface below (tests drive rules directly on synthetic trees). The
escape comment ``# dtpu-lint: allow[rule]`` and the baseline file work
as in the JAX package (``docs/ANALYSIS.md``).

Free of torch at import: the linter never imports the code it analyzes.
"""

from .core import (
    Finding,
    SourceTree,
    apply_baseline,
    load_baseline,
    make_rules,
    rule_names,
    run_rules,
    write_baseline,
)
from .imports import JAX_FREE_MODULES

__all__ = [
    "Finding",
    "JAX_FREE_MODULES",
    "SourceTree",
    "apply_baseline",
    "load_baseline",
    "make_rules",
    "rule_names",
    "run_rules",
    "write_baseline",
]
