"""``dtt-events``: summarize an event log + flight dumps into a postmortem.

    python -m distributed_tpu_torch.obs.cli run.events.jsonl
    python -m distributed_tpu_torch.obs.cli run.events.jsonl --flight flight-rank1-pid33.jsonl
    python -m distributed_tpu_torch.obs.cli run.events.jsonl --json
    python -m distributed_tpu_torch.obs.cli run.events.jsonl --follow

The port's copy of the JAX package's ``obs/cli.py`` (``dtpu-events``): the
same summary from the same event log, key for key.

Reads a supervised run's JSONL event log (``utils.events``) and renders a
human postmortem: the attempt timeline, injected faults, per-recovery
MTTR rows, cross-rank skew / straggler attribution (``obs.aggregate``),
and the tail of every flight-recorder dump the run referenced
(``flight_dump`` events; ``--flight`` adds files by hand) — the seconds
before each death, not just the lifecycle facts. ``--json`` emits the
same summary as one machine-readable object.

``--follow`` tails a LIVE log instead: one rendered line per event as
it lands, surviving the writer's rotate/truncate the same way
``EventLog`` survives its reader's (stat the inode, reopen on change)
and skipping a torn tail line until its newline arrives — watch a
supervised training run without re-running the postmortem.

Runs on any controller box against a copied log file; needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

from ..utils import event_schema as evs
from ..utils.events import read_events
from . import aggregate
from .flight import read_dump


def _fmt_ts(ts) -> str:
    try:
        return time.strftime("%H:%M:%S", time.localtime(float(ts)))
    except (TypeError, ValueError):
        return "?"


def summarize(events: List[dict], flight_paths=(),
              straggler_threshold: float = aggregate.DEFAULT_THRESHOLD
              ) -> dict:
    """The postmortem as data; ``render`` turns it into text."""
    attempts = [e for e in events if e["event"] == evs.ATTEMPT_START]
    ends = [e for e in events if e["event"] == evs.ATTEMPT_END]
    faults = [e for e in events if e["event"] == evs.FAULT_INJECTED]
    recoveries = [e for e in events if e["event"] == evs.RECOVERY]
    resizes = [e for e in events if e["event"] == evs.GANG_RESIZE]
    terminal = next(
        (e for e in reversed(events)
         if e["event"] in (evs.RUN_COMPLETE, evs.BUDGET_EXHAUSTED,
                           evs.PREEMPTION_CAP_EXHAUSTED)),
        None,
    )
    dump_paths: List[str] = [
        e["path"] for e in events
        if e["event"] == evs.FLIGHT_DUMP and e.get("path")
    ]
    for p in flight_paths:
        if str(p) not in dump_paths:
            dump_paths.append(str(p))
    dumps = []
    for p in dump_paths:
        records = read_dump(p)
        header = next(
            (r for r in records if r.get("kind") == "flight_header"), None
        )
        dumps.append({
            "path": str(p),
            "readable": bool(records),
            "reason": (header or {}).get("reason"),
            "rank": (header or {}).get("rank"),
            "records": [r for r in records
                        if r.get("kind") != "flight_header"],
        })
    return {
        "events": len(events),
        "attempts": [
            {
                "attempt": a.get("attempt"),
                "world_size": a.get("world_size"),
                "started": a.get("ts"),
                "ok": next(
                    (e.get("ok") for e in ends
                     if e.get("attempt") == a.get("attempt")), None
                ),
                "failed_ranks": next(
                    (e.get("failed_ranks") for e in ends
                     if e.get("attempt") == a.get("attempt")), None
                ),
            }
            for a in attempts
        ],
        "terminal": terminal,
        "faults": faults,
        "resizes": resizes,
        "recoveries": recoveries,
        "rank_skew": aggregate.skew_report(events),
        "straggler": aggregate.straggler(events, straggler_threshold),
        "straggler_events": [e for e in events if e["event"] == evs.STRAGGLER],
        # Last-writer-wins: one schedule/bubble row per postmortem (each
        # fit re-emits; the latest reflects the run that ended the log).
        "pipeline_schedule": next(
            (e for e in reversed(events)
             if e["event"] == evs.PIPELINE_SCHEDULE_SELECTED), None
        ),
        "bubble": next(
            (e for e in reversed(events)
             if e["event"] == evs.BUBBLE_REPORT), None
        ),
        # Speculation-that-pays timeline: last spec_verify aggregate,
        # every draft sync / per-tenant k move, and the gossip traffic.
        "spec_verify": next(
            (e for e in reversed(events)
             if e["event"] == evs.SPEC_VERIFY), None
        ),
        "draft_syncs": [e for e in events if e["event"] == evs.DRAFT_SYNC],
        "spec_k_adjusts": [e for e in events
                           if e["event"] == evs.SPEC_K_ADJUST],
        "gossip_advertises": [e for e in events
                              if e["event"] == evs.PREFIX_GOSSIP_ADVERTISE],
        "gossip_adopts": [e for e in events
                          if e["event"] == evs.PREFIX_GOSSIP_ADOPT],
        "flight_dumps": dumps,
    }


def render(summary: dict, *, tail: int = 10) -> str:
    lines = [f"postmortem: {summary['events']} events"]
    for a in summary["attempts"]:
        status = ("ok" if a["ok"] else
                  "FAILED" if a["ok"] is not None else "no end record")
        extra = (f" failed_ranks={a['failed_ranks']}"
                 if a.get("failed_ranks") else "")
        lines.append(
            f"  attempt {a['attempt']} [{_fmt_ts(a['started'])}] "
            f"world={a['world_size']}: {status}{extra}"
        )
    term = summary["terminal"]
    if term is not None:
        lines.append(f"  terminal: {term['event']}")
    for f in summary["faults"]:
        where = f" replica={f['replica']}" if f.get("replica") else ""
        lines.append(
            f"  fault injected: {f.get('mode')} at step {f.get('step')}"
            f"{where} [{_fmt_ts(f.get('ts'))}]"
        )
    for rs in summary["resizes"]:
        lines.append(
            f"  gang resize {rs.get('from_world')} -> {rs.get('to_world')} "
            f"({rs.get('reason')}, {rs.get('trigger')})"
        )
    for r in summary["recoveries"]:
        lines.append(
            f"  recovery (attempt {r.get('failed_attempt')} -> "
            f"{r.get('recovered_attempt')}): detect={r.get('detect_s')}s "
            f"gang_reform={r.get('gang_reform_s')}s "
            f"restore={r.get('restore_s')}s[{r.get('restore_tier')}] "
            f"recompile={r.get('recompile_s')}s"
        )
        for p in r.get("flight_dumps") or ():
            lines.append(f"    flight dump: {p}")
    skew = summary["rank_skew"]
    if skew is not None:
        lines.append(
            f"  rank skew: gang median {skew['gang_median_step_s']}s/step, "
            f"max skew {skew['max_skew']}x (rank {skew['slowest_rank']})"
        )
        for row in skew["ranks"]:
            lines.append(
                f"    rank {row['rank']}: median {row['median_step_s']}s "
                f"(x{row['skew']}, {row['samples']} samples)"
            )
    sched = summary.get("pipeline_schedule")
    if sched is not None:
        lines.append(
            f"  pipeline schedule: {sched.get('schedule')} "
            f"(interleave={sched.get('interleave')}, "
            f"stages={sched.get('num_stages')}, "
            f"microbatches={sched.get('num_microbatches')})"
        )
    bub = summary.get("bubble")
    if bub is not None:
        lines.append(
            f"  pipeline bubble: {bub.get('bubble_fraction')} idle "
            f"over {bub.get('ticks')} ticks"
        )
    sv = summary.get("spec_verify")
    if sv is not None:
        lines.append(
            f"  speculative decode: accept_rate={sv.get('accept_rate')} "
            f"({sv.get('accepted')}/{sv.get('proposed')} over "
            f"{sv.get('rounds')} rounds, "
            f"{sv.get('tokens_per_dispatch')} tok/dispatch)"
        )
    for ds in summary.get("draft_syncs", ()):
        lines.append(
            f"  draft sync [{_fmt_ts(ds.get('ts'))}]: "
            f"weights_version={ds.get('weights_version')} "
            f"staleness={ds.get('staleness')} source={ds.get('source')}"
        )
    for ka in summary.get("spec_k_adjusts", ()):
        lines.append(
            f"  spec_k adjust [{_fmt_ts(ka.get('ts'))}]: "
            f"tenant={ka.get('tenant')} {ka.get('old_k')} -> "
            f"{ka.get('new_k')} (accept_ema={ka.get('accept_ema')})"
        )
    adv = summary.get("gossip_advertises", ())
    adp = summary.get("gossip_adopts", ())
    if adv or adp:
        lines.append(
            f"  prefix gossip: {len(adv)} advertise(s) "
            f"({sum(int(e.get('blocks', 0)) for e in adv)} blocks), "
            f"{len(adp)} adopt(s) "
            f"({sum(int(e.get('blocks', 0)) for e in adp)} blocks)"
        )
        for e in adp:
            lines.append(
                f"    adopt [{_fmt_ts(e.get('ts'))}]: {e.get('source')} "
                f"-> {e.get('replica')} ({e.get('blocks')} blocks, "
                f"weights_version={e.get('weights_version')})"
            )
    strag = summary["straggler"] or next(
        iter(summary["straggler_events"]), None
    )
    if strag is not None:
        lines.append(
            f"  STRAGGLER: rank {strag.get('rank')} at "
            f"{strag.get('skew')}x the gang median "
            f"(threshold {strag.get('threshold')})"
        )
    for d in summary["flight_dumps"]:
        if not d["readable"]:
            lines.append(f"  flight dump {d['path']}: unreadable/empty")
            continue
        lines.append(
            f"  flight dump {d['path']} (rank {d['rank']}, "
            f"reason={d['reason']!r}): last {min(tail, len(d['records']))} "
            f"of {len(d['records'])} records"
        )
        for rec in d["records"][-tail:]:
            body = {k: v for k, v in rec.items() if k not in ("ts", "kind")}
            lines.append(
                f"    [{_fmt_ts(rec.get('ts'))}] {rec.get('kind')} "
                + " ".join(f"{k}={v}" for k, v in body.items())
            )
    return "\n".join(lines)


def event_line(event: dict) -> str:
    """One event as one follow-mode line: timestamp, kind, then the
    payload keys in emit order (the transport's own ts/event/pid are
    folded into the prefix)."""
    body = {k: v for k, v in event.items()
            if k not in ("ts", "event", "pid")}
    fields = " ".join(f"{k}={v}" for k, v in body.items())
    return (f"[{_fmt_ts(event.get('ts'))}] {event.get('event')}"
            + (f" {fields}" if fields else ""))


def follow(path, *, poll_s: float = 0.2, stop=None):
    """Yield events appended to ``path`` as they land, forever (or until
    ``stop()`` returns true — the test seam). The reader mirrors
    ``EventLog``'s writer idiom from the other side: on EOF, stat the
    path and reopen when the inode changed or the file shrank (rotation/
    truncation), and hold back a torn tail line until its newline
    arrives — a half-written record is pending, not corrupt. A path that
    does not exist yet is waited for, so the tail can start before the
    gang does."""
    path = str(path)
    f = None
    ino = None
    buf = ""
    try:
        while True:
            if f is None:
                try:
                    f = open(path, "r")
                    ino = os.fstat(f.fileno()).st_ino
                    buf = ""
                except FileNotFoundError:
                    if stop is not None and stop():
                        return
                    time.sleep(poll_s)
                    continue
            chunk = f.read()
            if chunk:
                buf += chunk
                while "\n" in buf:
                    line, buf = buf.split("\n", 1)
                    if not line.strip():
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn mid-rotation: skip, keep tailing
                continue
            try:
                st = os.stat(path)
                rotated = (st.st_ino != ino
                           or st.st_size < f.tell() - len(buf))
            except FileNotFoundError:
                rotated = True
            if rotated:
                f.close()
                f = None
                continue
            if stop is not None and stop():
                return
            time.sleep(poll_s)
    finally:
        if f is not None:
            f.close()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="dtt-events", description=__doc__)
    ap.add_argument("event_log", type=str,
                    help="JSONL event log (the supervisor's DTPU_EVENT_LOG)")
    ap.add_argument("--flight", action="append", default=[],
                    help="extra flight-dump file(s) to include (dumps "
                         "referenced by flight_dump events are found "
                         "automatically)")
    ap.add_argument("--tail", type=int, default=10,
                    help="flight records to show per dump (default 10)")
    ap.add_argument("--straggler-threshold", type=float,
                    default=aggregate.DEFAULT_THRESHOLD)
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as one JSON object instead of "
                         "the human rendering")
    ap.add_argument("--follow", action="store_true",
                    help="tail the log live (one line per event as it "
                         "lands; waits for the file if it does not exist "
                         "yet; ctrl-C to stop)")
    args = ap.parse_args(argv)
    if args.follow:
        try:
            for event in follow(args.event_log):
                print(json.dumps(event) if args.json
                      else event_line(event), flush=True)
        except KeyboardInterrupt:
            pass
        return 0
    if not Path(args.event_log).exists():
        print(f"dtt-events: no such event log: {args.event_log}",
              file=sys.stderr)
        return 2
    events = read_events(args.event_log)
    summary = summarize(events, flight_paths=args.flight,
                        straggler_threshold=args.straggler_threshold)
    if args.json:
        print(json.dumps(summary))
    else:
        print(render(summary, tail=args.tail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
