"""``dtt-lint``: the port's repo-aware static analysis gate.

    dtt-lint                        # lint the distributed_tpu_torch tree
    dtt-lint path/to/pkg            # lint an arbitrary tree
    dtt-lint --rules event-schema,thread-hygiene
    dtt-lint --write-baseline       # accept current findings
    dtt-lint --list-rules
    python -m distributed_tpu_torch.analysis.cli   # the same, uninstalled

Findings print as ``path:line: RULE-ID message`` and the exit status is
1 when any survive the allowlist comments and the baseline file (default
``<scan-parent>/.dtt-lint-baseline``), 2 for a usage error (an unknown
path or rule, an unparseable file), else 0: the JAX package's
``dtpu-lint`` codes and flags.

Free of torch at import: the linter parses source, it never imports the
code under analysis.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

from . import core


def _default_paths() -> List[Path]:
    return [Path(__file__).resolve().parents[1]]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="dtt-lint", description=__doc__)
    ap.add_argument("paths", nargs="*", type=Path,
                    help="directories/files to lint (default: the "
                         "distributed_tpu_torch package itself)")
    ap.add_argument("--rules", type=str, default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline file of findings deliberately kept "
                         "(default: .dtt-lint-baseline next to the "
                         "first scanned tree)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the baseline "
                         "and exit 0")
    ap.add_argument("--jax-free", action="append", default=[],
                    metavar="MODULE",
                    help="extra module(s) for the jax-free-import "
                         "manifest of modules free of torch (repeatable)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as one JSON array")
    args = ap.parse_args(argv)

    if args.list_rules:
        for n in core.rule_names():
            print(n)
        return 0

    paths = [p.resolve() for p in (args.paths or _default_paths())]
    for p in paths:
        if not p.exists():
            print(f"dtt-lint: no such path: {p}", file=sys.stderr)
            return 2
    baseline_path = args.baseline
    if baseline_path is None:
        baseline_path = paths[0].parent / ".dtt-lint-baseline"

    t0 = time.perf_counter()
    tree = core.SourceTree(paths)
    if tree.errors:
        for e in tree.errors:
            print(f"dtt-lint: {e}", file=sys.stderr)
        return 2

    try:
        rules = core.make_rules(
            args.rules.split(",") if args.rules else None,
            **{"jax-free-import": {"extra_manifest": tuple(args.jax_free)}},
        )
    except KeyError as e:
        print(f"dtt-lint: {e.args[0]}", file=sys.stderr)
        return 2

    findings = core.run_rules(tree, rules)
    if args.write_baseline:
        core.write_baseline(baseline_path, findings)
        print(f"dtt-lint: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")
        return 0
    kept, suppressed = core.apply_baseline(
        findings, core.load_baseline(baseline_path)
    )
    elapsed = time.perf_counter() - t0

    if args.json:
        print(json.dumps([f.__dict__ for f in kept]))
    else:
        for f in kept:
            print(f.render())
        print(
            f"dtt-lint: {len(kept)} finding(s) "
            f"({suppressed} baselined) over {len(tree.files)} files "
            f"in {elapsed:.2f}s"
        )
    return 1 if kept else 0


if __name__ == "__main__":
    sys.exit(main())
