"""The port's linter (``dtt-lint``, ``distributed_tpu_torch/analysis/``)
against the JAX package's (``dtpu-lint``).

- The port's linter finds nothing in ``distributed_tpu_torch/``, as a
  library call and as ``python -m distributed_tpu_torch.analysis.cli``.
- The rules kept from the reference (``event-schema``,
  ``thread-hygiene``, ``writer-thread``, the allow comment, the baseline
  round trip, the CLI's exit codes) give JAX's ``(rule, line)`` findings
  on the same synthetic trees.
- The port's own forms: ``jax-free-import`` (no JAX anywhere; no torch in
  the manifest's modules, transitively) and ``trace-purity`` (the code a
  CUDA graph captures), one seeded violation per family; the writer
  rule's torch collectives and device syncs.
- Every module of the manifest imports in a process where ``torch``,
  ``jax`` and ``distributed_tpu`` cannot be imported.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from distributed_tpu.analysis import cli as jcli
from distributed_tpu.analysis import core as jcore
from distributed_tpu_torch.analysis import cli as pcli
from distributed_tpu_torch.analysis import core as pcore
from distributed_tpu_torch.analysis import imports as pimports
from distributed_tpu_torch.analysis import threads as pthreads

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_tpu_torch"


def write_tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return root


def findings(core, root: Path, rules, **overrides):
    tree = core.SourceTree([root])
    assert not tree.errors, tree.errors
    return [(f.rule, f.path, f.line, f.message)
            for f in core.run_rules(tree, core.make_rules(rules, **overrides))]


def port(root, rule, **kw):
    return findings(pcore, root, [rule], **kw)


# ------------------------------------------------------------ the tree
def test_port_tree_has_no_finding():
    out = findings(pcore, PKG, None)
    assert out == [], "\n".join(map(str, out))


def test_cli_module_exits_zero_on_the_port():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tpu_torch.analysis.cli"],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("dtt-lint: 0 finding(s) (0 baselined)")


def test_console_script_is_declared():
    text = (ROOT / "pyproject.toml").read_text()
    assert 'dtt-lint = "distributed_tpu_torch.analysis.cli:main"' in text


def test_rule_names_match_jax():
    assert pcore.rule_names() == jcore.rule_names()


# ------------------------------------------- shared rules, both linters
SCHEMA = """
    FOO = "foo"
    BAR = "bar"
    EVENTS = {
        FOO: {"required": ("a", "b"), "optional": ("c",)},
        BAR: {"required": ("x",), "optional": ()},
        "open": {"required": (), "optional": (), "extra": True},
    }
"""

SHARED = {
    "event-schema": {
        "pkg/__init__.py": "",
        "pkg/event_schema.py": SCHEMA,
        "pkg/p.py": """
            from . import event_schema as evs

            def emit(kind, **fields):
                pass

            class Log:
                def _emit(self, kind, **fields):
                    pass

            emit("foo", a=1)
            emit("foo", a=1, b=2, c=3)
            emit("foo", a=1, b=2, d=4)
            emit(evs.BAR, y=1)
            emit("nope", a=1)
            emit("foo", **{"a": 1})
            emit("open", anything=1)
            Log()._emit(evs.FOO, a=1, b=2)
            emit("foo", a=1)  # dtpu-lint: allow[event-schema]
            # dtpu-lint: allow[event-schema]
            emit("bar")
            emit(kind_from_somewhere, q=1)
        """,
    },
    "thread-hygiene": {
        "pkg/__init__.py": "",
        "pkg/h.py": """
            import threading
            from threading import Thread

            def go(**kw):
                threading.Thread(target=go)
                threading.Thread(target=go, daemon=True)
                threading.Thread(target=go, name="dtpu-x")
                threading.Thread(target=go, daemon=False, name="dtpu-y")
                for i in range(2):
                    Thread(target=go, daemon=True, name=f"dtpu-drain-{i}")
                Thread(target=go, daemon=True, name="worker-1")
                Thread(target=go, daemon=True, name=f"{i}-dtpu")
                threading.Thread(target=go, **kw)
                # dtpu-lint: allow[thread-hygiene]
                threading.Thread(target=go, daemon=True)
                threading.Thread(target=go)  # dtpu-lint: allow[thread-hygiene]
        """,
    },
    "writer-thread": {
        "pkg/__init__.py": "",
        "pkg/w.py": """
            import threading

            import torch.distributed as dist

            def flush():
                dist.all_gather([], None)

            def helper():
                flush()

            def write():
                helper()

            def exchange():
                dist.all_to_all([], [])

            def clean():
                return 1

            def start():
                threading.Thread(target=write, daemon=True,
                                 name="dtpu-test-writer").start()
                threading.Thread(target=exchange, daemon=True,
                                 name="dtpu-mirror-writer").start()
                threading.Thread(target=clean, daemon=True,
                                 name="dtpu-clean-writer").start()
                threading.Thread(target=write, daemon=True,
                                 name="dtpu-prefetch").start()
                # dtpu-lint: allow[writer-thread]
                threading.Thread(target=exchange, daemon=True,
                                 name="dtpu-kept-writer").start()
        """,
    },
}


def _lines(rows):
    return sorted((r[0], r[2]) for r in rows)


@pytest.mark.parametrize("rule", sorted(SHARED))
def test_shared_rule_gives_jax_findings(rule, tmp_path):
    root = write_tree(tmp_path / "scan", SHARED[rule])
    jax_rows = findings(jcore, root, [rule])
    port_rows = findings(pcore, root, [rule])
    assert jax_rows, "the synthetic tree must seed violations"
    assert _lines(port_rows) == _lines(jax_rows)


@pytest.mark.parametrize("rule", sorted(SHARED))
def test_shared_rule_on_a_clean_tree(rule, tmp_path):
    root = write_tree(tmp_path / "scan", {
        "pkg/__init__.py": "",
        "pkg/event_schema.py": SCHEMA,
        "pkg/ok.py": """
            import threading

            def emit(kind, **fields):
                pass

            def work():
                emit("foo", a=1, b=2)

            threading.Thread(target=work, daemon=True,
                             name="dtpu-ok-writer")
        """,
    })
    assert findings(jcore, root, [rule]) == []
    assert findings(pcore, root, [rule]) == []


def _run_cli(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def _body(out):
    """The CLI's findings as ``path:line: RULE-ID``, without the messages
    (worded for each package) and the tool-named summary line."""
    return [l.split(" ", 2)[:2] for l in out.splitlines()
            if "finding(s)" not in l]


@pytest.mark.parametrize("rule", sorted(SHARED))
def test_cli_exit_codes_and_findings_as_jax(rule, tmp_path, capsys):
    root = write_tree(tmp_path / "scan", SHARED[rule])
    jrc, jout = _run_cli(jcli, [str(root), "--rules", rule], capsys)
    prc, pout = _run_cli(pcli, [str(root), "--rules", rule], capsys)
    assert (prc, _body(pout)) == (jrc, _body(jout)) and prc == 1
    jrc, jout = _run_cli(jcli, [str(root), "--rules", rule, "--json"],
                         capsys)
    prc, pout = _run_cli(pcli, [str(root), "--rules", rule, "--json"],
                         capsys)
    assert prc == jrc == 1
    assert [(r["rule"], r["path"], r["line"]) for r in json.loads(pout)] \
        == [(r["rule"], r["path"], r["line"]) for r in json.loads(jout)]


SEEDED = {
    "event-schema": SHARED["event-schema"],
    "thread-hygiene": SHARED["thread-hygiene"],
    "writer-thread": SHARED["writer-thread"],
    "jax-free-import": {"pkg/__init__.py": "", "pkg/c.py": "import jax\n"},
    "trace-purity": {"pkg/__init__.py": "", "pkg/t.py": """
        import time

        from .step_graph import StepGraph

        def step(x):
            return x * time.time()

        g = StepGraph(step, None)
    """},
}


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_seeded_violation_of_each_rule_exits_nonzero(rule, tmp_path,
                                                      capsys):
    root = write_tree(tmp_path / "scan", SEEDED[rule])
    rc, out = _run_cli(pcli, [str(root)], capsys)
    assert rc == 1 and f" {rule} " in out, out
    rc, out = _run_cli(pcli, [str(root), "--rules",
                              ",".join(r for r in SEEDED if r != rule)],
                       capsys)
    assert f" {rule} " not in out


@pytest.mark.parametrize("case", ["clean", "missing_path", "unknown_rule",
                                  "unparseable", "list_rules"])
def test_cli_usage_exit_codes_as_jax(case, tmp_path, capsys):
    clean = write_tree(tmp_path / "scan", {"pkg/ok.py": "x = 1\n"})
    bad = write_tree(tmp_path / "bad", {"pkg/x.py": "def broken(:\n"})
    argv = {
        "clean": [str(clean)],
        "missing_path": [str(tmp_path / "missing")],
        "unknown_rule": [str(clean), "--rules", "nope"],
        "unparseable": [str(bad)],
        "list_rules": ["--list-rules"],
    }[case]
    jrc, jout = _run_cli(jcli, argv, capsys)
    prc, pout = _run_cli(pcli, argv, capsys)
    assert prc == jrc
    if case == "list_rules":
        assert pout == jout
    if case == "clean":
        assert prc == 0 and "0 finding(s)" in pout


@pytest.mark.parametrize("rule", sorted(SHARED))
def test_baseline_round_trip_as_jax(rule, tmp_path, capsys):
    root = write_tree(tmp_path / "scan", SHARED[rule])
    keys = []
    for cli, core in ((jcli, jcore), (pcli, pcore)):
        bl = tmp_path / f"{core.__name__}.baseline"
        argv = [str(root), "--rules", rule, "--baseline", str(bl)]
        assert cli.main(argv) == 1
        assert cli.main(argv + ["--write-baseline"]) == 0
        rc, out = _run_cli(cli, argv, capsys)
        assert rc == 0 and "baselined)" in out
        keys.append(core.load_baseline(bl))
        # A finding the baseline does not hold is not shadowed by it.
        extra = core.Finding(rule, "pkg/new.py", 3, "new")
        kept, _ = core.apply_baseline([extra], keys[-1])
        assert kept == [extra]
    # The same (rule, path) keys; the messages are worded for each package.
    assert [k.split(" :: ")[0] for k in keys[0]] == \
        [k.split(" :: ")[0] for k in keys[1]] and keys[1]


def test_default_baseline_sits_beside_the_scanned_tree(tmp_path, capsys):
    root = write_tree(tmp_path / "scan", SHARED["thread-hygiene"])
    assert pcli.main([str(root)]) == 1
    assert pcli.main([str(root), "--write-baseline"]) == 0
    assert (tmp_path / ".dtt-lint-baseline").exists()
    rc, out = _run_cli(pcli, [str(root)], capsys)
    assert rc == 0 and "baselined)" in out


# --------------------------------------------- the port's own forms
@pytest.mark.parametrize("source,line", [
    ("import jax\n", 1),
    ("x = 1\nimport jax.numpy as jnp\n", 2),
    ("from jaxlib import xla_client\n", 1),
    ("import distributed_tpu\n", 1),
    ("from distributed_tpu.nn import core\n", 1),
    ("try:\n    import jax\nexcept ImportError:\n    jax = None\n", 2),
    ("class A:\n    import jax\n", 2),
])
def test_jax_import_anywhere_is_a_finding(source, line, tmp_path):
    root = write_tree(tmp_path / "scan", {"pkg/__init__.py": "",
                                          "pkg/m.py": source})
    rows = port(root, "jax-free-import")
    assert [(r[1], r[2]) for r in rows] == [("pkg/m.py", line)]


def test_lazy_jax_import_is_clean(tmp_path):
    root = write_tree(tmp_path / "scan", {"pkg/__init__.py": "",
                                          "pkg/m.py": """
        import numpy as np

        def f():
            import jax
            return jax
    """})
    assert port(root, "jax-free-import") == []


TORCH_TREE = {
    "pkg/__init__.py": "import torch\n",
    "pkg/ctl.py": "from . import helper\nfrom .leaf import VALUE\n",
    "pkg/helper.py": "import os\nfrom .dev import cast\n",
    "pkg/dev.py": "import torch.distributed as dist\n\ndef cast():\n    pass\n",
    "pkg/leaf.py": "VALUE = 1\n",
    "pkg/lazy.py": "def f():\n    import torch\n    return torch\n",
    "pkg/free.py": "from . import leaf\n",
}


@pytest.mark.parametrize("manifest,want", [
    (["pkg.ctl"], [("pkg/ctl.py", 1, "pkg.helper -> pkg.dev -> torch")]),
    (["pkg.helper"], [("pkg/helper.py", 2, "pkg.dev -> torch")]),
    (["pkg.dev"], [("pkg/dev.py", 1, "via torch")]),
    (["pkg.lazy", "pkg.free", "pkg.leaf"], []),
    (["pkg.gone"], [("<manifest>", 1, "unknown module 'pkg.gone'")]),
])
def test_torch_in_the_manifest_is_a_finding(manifest, want, tmp_path):
    """Transitive, at module scope only; the package's own ``__init__``
    (which imports torch) is not an edge."""
    root = write_tree(tmp_path / "scan", TORCH_TREE)
    rows = port(root, "jax-free-import",
                **{"jax-free-import": {"manifest": manifest}})
    assert [(r[1], r[2]) for r in rows] == [(p, l) for p, l, _ in want]
    for row, (_, _, needle) in zip(rows, want):
        assert needle in row[3]


def test_cli_jax_free_flag_extends_the_manifest(tmp_path, capsys):
    root = write_tree(tmp_path / "scan", TORCH_TREE)
    assert pcli.main([str(root), "--rules", "jax-free-import"]) == 0
    rc, out = _run_cli(pcli, [str(root), "--rules", "jax-free-import",
                              "--jax-free", "pkg.ctl"], capsys)
    assert rc == 1 and "pkg/ctl.py:1: jax-free-import" in out


def test_manifest_is_the_references_less_compile_cache():
    from distributed_tpu.analysis.imports import JAX_FREE_MODULES as ref

    want = {"distributed_tpu_torch" + m[len("distributed_tpu"):]
            for m in ref if m != "distributed_tpu.utils.compile_cache"}
    assert set(pimports.JAX_FREE_MODULES) == want


IMPURE = [
    ("time.time()", "time.time"),
    ("time.perf_counter()", "time.perf_counter"),
    ("np.random.rand()", "np.random.rand"),
    ("random.random()", "random.random"),
    ("os.environ.get('X')", "os.environ.get"),
    ("os.getenv('X')", "os.getenv"),
    ("os.environ['X']", "os.environ"),
    ("print(x)", "print"),
    ("datetime.datetime.now()", "datetime.datetime.now"),
    ("x.item()", ".item()"),
    ("x.cpu()", ".cpu()"),
    ("x.numpy()", ".numpy()"),
    ("x.tolist()", ".tolist()"),
    ("np.asarray(x)", "np.asarray"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("float(x)", "float(...)"),
]


@pytest.mark.parametrize("expr,needle", IMPURE)
def test_trace_purity_flags_each_family(expr, needle, tmp_path):
    root = write_tree(tmp_path / "scan", {"pkg/__init__.py": "",
                                          "pkg/m.py": f"""
        import datetime, os, random, time

        import numpy as np
        import torch

        from .step_graph import StepGraph

        def grad_eval(x):
            y = {expr}
            return y

        def run(x):
            return StepGraph(grad_eval, x).replay(x)
    """})
    rows = port(root, "trace-purity")
    assert {r[2] for r in rows} == {10}, rows
    assert any(f"'{needle}'" in r[3] for r in rows), rows


CAPTURE_FORMS = {
    # Model._graph_grad_eval's idiom: a lambda forwarding to a method.
    "lambda": """
        class M:
            def _grad_eval(self, a):
                return a.item()

            def _graph_grad_eval(self, x):
                return StepGraph(lambda a: self._grad_eval(a), x)
    """,
    "partial": """
        import functools

        def ge(a, k):
            return a.cpu()

        def setup(x):
            return StepGraph(functools.partial(ge, k=1), x)
    """,
    "graph_block": """
        import torch

        def capture(g, f, x):
            with torch.cuda.graph(g):
                out = f(x).tolist()
            return out
    """,
    "body_suffix": """
        import time

        def _train_step_body(x):
            return x * time.time()
    """,
    "constructing_def": """
        def _graph_grad_eval(self, x):
            n = x.sum().item()
            return StepGraph(self._grad_eval, x, n)
    """,
}


@pytest.mark.parametrize("form", sorted(CAPTURE_FORMS))
def test_trace_purity_captured_regions(form, tmp_path):
    root = write_tree(tmp_path / "scan", {
        "pkg/__init__.py": "",
        "pkg/m.py": "from .step_graph import StepGraph\n"
                    + textwrap.dedent(CAPTURE_FORMS[form])})
    rows = port(root, "trace-purity")
    assert len(rows) == 1, rows


def test_trace_purity_clean_outside_capture_and_allowlisted(tmp_path):
    root = write_tree(tmp_path / "scan", {"pkg/__init__.py": "",
                                          "pkg/m.py": """
        import time

        from .step_graph import StepGraph

        def eager(x):
            return x.item() + time.time()

        def grad_eval(x):
            t = time.time()  # dtpu-lint: allow[trace-purity]
            return x * 2

        def make(x):
            return StepGraph(grad_eval, x)
    """})
    assert port(root, "trace-purity") == []


@pytest.mark.parametrize("call,flagged", [
    ("dist.barrier()", True),
    ("dist.all_reduce(t)", True),
    ("dist.broadcast(t, 0)", True),
    ("torch.distributed.reduce(t, 0)", True),
    ("all_gather_into_tensor(t, t)", True),
    ("collectives.gather(t, lay)", True),
    ("copy_to_group(t, None)", True),
    ("t.item()", True),
    ("torch.cuda.synchronize()", True),
    ("np.broadcast(t, t)", False),
    ("stream.wait_event(ev)", False),
    ("save_npz(p, t)", False),
])
def test_writer_thread_port_denylist(call, flagged, tmp_path):
    root = write_tree(tmp_path / "scan", {"pkg/__init__.py": "",
                                          "pkg/w.py": f"""
        import threading

        import numpy as np
        import torch
        import torch.distributed as dist

        def write(t=None, lay=None, ev=None, stream=None, p=None):
            {call}

        threading.Thread(target=write, daemon=True, name="dtpu-ckpt-writer")
    """})
    rows = port(root, "writer-thread")
    assert bool(rows) == flagged, rows
    if flagged:
        assert rows[0][2] == 11


def test_port_collectives_are_defined_in_collectives_py():
    text = (PKG / "parallel" / "collectives.py").read_text()
    for name in pthreads.PORT_COLLECTIVES:
        assert f"\ndef {name}(" in text, name


def test_port_writer_threads_are_the_three_writers():
    tree = pcore.SourceTree([PKG])
    names = set()
    for sf in tree.files:
        for call in pthreads._thread_calls(sf):
            label = pcore.literal_str_prefix(pthreads._kw(call, "name"))
            if label and pthreads.WRITER_NAME_RE.match(label):
                names.add((sf.rel, label))
    assert names == {
        ("distributed_tpu_torch/checkpoint/core.py", "dtpu-ckpt-writer"),
        ("distributed_tpu_torch/checkpoint/sharded.py", "dtpu-shard-writer"),
        ("distributed_tpu_torch/resilience/redundancy.py",
         "dtpu-buddy-writer"),
    }


# ---------------------------------------- the manifest without torch
def test_manifest_imports_with_torch_blocked():
    """Each manifest module imports with ``torch``, ``jax`` and
    ``distributed_tpu`` blocked. The ancestor packages outside the
    manifest (the port's top level builds the training world) stand in as
    bare packages, as the rule's scope note has it."""
    manifest = list(pimports.JAX_FREE_MODULES)
    code = textwrap.dedent(f"""
        import importlib, sys, types
        for name in ("torch", "jax", "jaxlib", "distributed_tpu"):
            sys.modules[name] = None
        manifest = {manifest!r}
        root = {str(PKG)!r}
        for mod in manifest:
            parts = mod.split(".")
            for i in range(1, len(parts)):
                pkg = ".".join(parts[:i])
                if pkg in manifest or pkg in sys.modules:
                    continue
                stub = types.ModuleType(pkg)
                stub.__path__ = [root + "/" + "/".join(parts[1:i])]
                sys.modules[pkg] = stub
        for mod in manifest:
            importlib.import_module(mod)
        assert "torch" not in [m for m in sys.modules
                               if sys.modules[m] is not None]
        print("ok", len(manifest))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(manifest))]
