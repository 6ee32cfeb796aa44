"""Rule ``event-schema``: emit sites agree with the declared event schema.

The JAX package's rule, unchanged: ``utils/event_schema.py`` declares
every event kind on the JSONL stream with the keys its consumers require
(the postmortem CLI, the cross-rank aggregation, ``recovery_rows``), and
every ``emit(...)`` / ``log.emit(...)`` / ``self._emit(...)`` call site
whose event name is statically resolvable (a string literal or a schema
name constant) is checked:

- the event name must be declared in the schema;
- all required keys must be passed as literal keywords (unless the call
  spreads ``**fields``, which is statically opaque: then only the keys
  that ARE literal are validated);
- no undeclared keys, unless the event is marked ``extra``.

The schema is read statically (AST, never imported). A scanned tree
containing its own ``event_schema.py`` (the port's, or a fixture tree's
in tests) is preferred over the port's packaged one.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, SourceFile, SourceTree, register

_EMIT_NAMES = frozenset({"emit", "_emit"})


def _schema_ast(tree: SourceTree):
    sf = tree.find_file("event_schema.py")
    if sf is not None:
        return sf.tree
    default = Path(__file__).resolve().parent.parent / "utils" \
        / "event_schema.py"
    return ast.parse(default.read_text(), filename=str(default))


def load_schema(tree: SourceTree) -> Tuple[Dict[str, dict], Dict[str, str]]:
    """(schemas, constants): ``schemas`` maps event name -> {"required",
    "optional", "extra"}; ``constants`` maps CONSTANT identifier -> event
    name, for resolving ``emit(event_schema.RESTORE_BEGIN, ...)``."""
    mod = _schema_ast(tree)
    constants: Dict[str, str] = {}
    events_node = None
    for node in mod.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            tgt = node.targets[0].id
            if isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                constants[tgt] = node.value.value
            elif tgt == "EVENTS" and isinstance(node.value, ast.Dict):
                events_node = node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.target.id == "EVENTS" \
                and isinstance(node.value, ast.Dict):
            events_node = node.value
    schemas: Dict[str, dict] = {}
    if events_node is None:
        return schemas, constants
    for key, val in zip(events_node.keys, events_node.values):
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            name = key.value
        elif isinstance(key, ast.Name) and key.id in constants:
            name = constants[key.id]
        else:
            continue
        if not isinstance(val, ast.Dict):
            continue
        row = {"required": (), "optional": (), "extra": False}
        for k, v in zip(val.keys, val.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            if k.value in ("required", "optional") \
                    and isinstance(v, (ast.Tuple, ast.List)):
                row[k.value] = tuple(
                    e.value for e in v.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                )
            elif k.value == "extra" and isinstance(v, ast.Constant):
                row["extra"] = bool(v.value)
        schemas[name] = row
    return schemas, constants


def _emit_event_name(call: ast.Call,
                     constants: Dict[str, str]) -> Optional[str]:
    """The statically-resolved event name of an emit call, or None when
    the first argument is dynamic (wrapper functions forwarding a
    parameter are not checkable — their CALLERS are)."""
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    ident = None
    if isinstance(arg, ast.Name):
        ident = arg.id
    elif isinstance(arg, ast.Attribute):
        ident = arg.attr
    if ident is not None and ident in constants:
        return constants[ident]
    return None


def _is_emit(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in _EMIT_NAMES
    if isinstance(f, ast.Attribute):
        return f.attr in _EMIT_NAMES
    return False


@register
class EventSchemaRule:
    name = "event-schema"

    def check(self, tree: SourceTree) -> List[Finding]:
        schemas, constants = load_schema(tree)
        findings: List[Finding] = []
        if not schemas:
            return findings
        for sf in tree.files:
            if sf.path.name == "event_schema.py":
                continue
            findings.extend(self._check_file(sf, schemas, constants))
        return findings

    def _check_file(self, sf: SourceFile, schemas, constants):
        out: List[Finding] = []
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and _is_emit(node)):
                continue
            name = _emit_event_name(node, constants)
            if name is None:
                continue
            if name not in schemas:
                out.append(Finding(
                    self.name, sf.rel, node.lineno,
                    f"emit of undeclared event '{name}' (declare it in "
                    f"utils/event_schema.py with its required/optional "
                    f"keys, or fix the typo)",
                ))
                continue
            row = schemas[name]
            explicit: Set[str] = {
                kw.arg for kw in node.keywords if kw.arg is not None
            }
            spread = any(kw.arg is None for kw in node.keywords)
            required = set(row["required"])
            declared = required | set(row["optional"])
            missing = sorted(required - explicit)
            if missing and not spread:
                out.append(Finding(
                    self.name, sf.rel, node.lineno,
                    f"emit('{name}') is missing required key(s) "
                    f"{', '.join(missing)} (consumers index these "
                    f"unconditionally — see utils/event_schema.py)",
                ))
            unknown = sorted(explicit - declared)
            if unknown and not row["extra"]:
                out.append(Finding(
                    self.name, sf.rel, node.lineno,
                    f"emit('{name}') passes undeclared key(s) "
                    f"{', '.join(unknown)} (add them to the event's "
                    f"schema in utils/event_schema.py so consumers know "
                    f"they exist)",
                ))
        return out
