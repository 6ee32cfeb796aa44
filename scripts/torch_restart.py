#!/usr/bin/env python3
"""A killed gang resumed by the launcher: ``run_with_restart`` on the cards.

    python3 scripts/torch_restart.py [--num-workers 4] [--timeout 900]
    python3 scripts/torch_restart.py --liveness [--num-workers 4]
    python3 scripts/torch_restart.py --supervise [--num-workers 4]
        [--cases kill preempt corrupt pair elastic]

Trains the LM at GPT-2-small width with 2 blocks (vocab 32,768, d_model
768, 12 heads, max_len 1,024, bf16 layers; ``fused_adamw(3e-4,
weight_decay=0.01)``, the pallas loss; 8 x 1,024 tokens a card, 3 epochs of
4 steps from ``chip_smoke.lm_rows``) under ``DataParallel()`` on N cards
(one worker each, ``launch.LocalLauncher``), with
``ModelCheckpoint(restore=True, save_freq=3)``:

1. ``run_with_restart``: on the first attempt rank ``N - 1`` ends itself
   with ``os._exit`` after step 5; the launcher kills its peers and
   relaunches the gang, which restores step 3 and finishes.
2. The same command once more in a fresh directory with no failure.

The resumed run's parameters and optimizer state must be bit-identical to
the uninterrupted run's on every rank (a SHA-256 of every leaf's bytes),
and its last epoch's loss equal. Prints, per rank, the restore's seconds
(``ModelCheckpoint``'s ``on_train_begin``) and the seconds from the
relaunched worker's start (its interpreter's first statement) to the end
of its first step (synchronized): the time to recover that a user feels.

With ``--liveness`` it instead checks the liveness probe: rank ``N - 1``
stops itself (SIGSTOP) after step 2, and the launcher
(``liveness_timeout=10``) must kill it (its peers, blocked at a
collective with it, stop beating too and are killed by the probe or with
the gang); prints the seconds from the stop to the launcher's return.

With ``--supervise`` every gang runs under ``python -m
distributed_tpu_torch.launch --supervise`` (``resilience.Supervisor``,
``--event-log``, ``--checkpoint-dir``): the same LM and data, the global
batch ``8 x N`` held fixed, under ``DataParallel()`` on one card and
``FSDP()`` on more, with ``ModelCheckpoint(sharded=True, restore=True,
save_freq=3, buddy=..., buddy_refresh_every=5)``, a ``PreemptionHandler``
and ``FaultInjector.from_env()``. The buddy store (``--buddy-store-dir``)
is a ``resilience.ram_dir()`` under ``/dev/shm``; the mirrors are
refreshed every 5 steps (a refresh copies, CRCs and writes the whole
state, ~1.6 s on one card against a step of ~0.1 s) asynchronously, as
``ModelCheckpoint(buddy=True)`` does: a snapshot on the card, then the
writer thread's copy to the host once the snapshot's CUDA event is
reached. At step 5, where the faults and the signal come, a callback
ordered before them waits out the writer, so the mirror they find is
the one the writer committed. Given ``--buddy-store-dir``, the supervisor treats the memory
of a rank that failed as lost with it (its segment is dropped before the
relaunch); on one card the store is exported to the worker as
``DTPU_BUDDY_STORE`` instead, so that a process killed on a host that
stays up keeps its mirror, as tmpfs does. One uninterrupted gang is the reference (or ``--reference``, a JSON list
of an uninterrupted run's result values, e.g. the plain run's
``uninterrupted`` rows: the same LM, data and optimizer); each case must
end with its parameters and optimizer state bit-identical to it (the
elastic case: every rank of the smaller gang resumed from the disk's
step 3, and its last epoch's loss within ``ELASTIC_RTOL``):

- ``kill``: ``DTPU_FAULT=kill:at_step=5`` on rank ``N - 1``; resumed from
  the buddy tier at step 5 with 0 disk block reads (on more cards, from
  the mirror rank 0 holds of rank ``N - 1``'s blocks).
- ``preempt``: rank 0 sends itself SIGTERM after step 5; every rank exits
  75 (on more cards the ranks' vote stops them all at step 6) and the
  restart spends no budget.
- ``corrupt``: the buddy tier off; ``corrupt_checkpoint`` at step 7
  clobbers step 6's shard and dies; the restore falls back to step 3.
- ``pair``: ``buddy_kill`` of rank ``N - 1`` and its ring holder (rank 0):
  no complete mirror set survives, so the restore reads the disk.
- ``elastic``: rank ``N - 1`` dies at step 5 on every attempt, with
  ``--elastic-min-workers 2 --elastic-divisor 8N``: after two attempts the
  gang re-forms at world ``N / 2`` from the sharded checkpoint (resharded)
  and finishes.

The cases run one after another. For each case it prints
the ``recovery`` rows (detect, gang re-form, restore, first step), the
restore tier and disk block reads, the bytes the store holds and ``/dev/shm``'s free space, and the postmortem of the
kill case's event log (``python -m distributed_tpu_torch.obs.cli``, with
the flight dump's tail). The last line is a JSON object with every
figure.

Needs the cards; imports nothing of JAX.
"""

import time

T_START = time.time()  # the worker's start, before any import

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LAYERS, BATCH, EPOCHS, STEPS = 2, 8, 3, 4
KILL_STEP, STOP_STEP, LIVENESS = 5, 2, 10.0
CORRUPT_STEP, ELASTIC_RTOL, REFRESH_EVERY = 7, 1e-5, 5


def digest(dtt, model) -> str:
    """SHA-256 of every parameter's and optimizer statistic's bytes."""
    import numpy as np
    import torch

    h = hashlib.sha256()
    for _, v in dtt.interop.iter_leaf_paths({
            "params": model.params, "opt": model._opt_tree("full")}):
        a = (v.detach().cpu().contiguous().view(torch.uint8).numpy()
             if isinstance(v, torch.Tensor) else np.asarray(v))
        h.update(a.tobytes())
    return h.hexdigest()


def worker(ckpt_dir, marker, mode):
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.training.callbacks import (Callback,
                                                          ModelCheckpoint)

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = dtt.cluster.initialize(timeout=120)
    n = torch.distributed.get_world_size()
    relaunch = os.path.exists(marker)
    clock = {}

    class Clock(Callback):
        """Brackets ModelCheckpoint's restore, and the first step."""

        def __init__(self, key):
            self.key = key

        def on_train_begin(self, model):
            clock[self.key] = time.time()

        def on_batch_end(self, model, step, logs):
            if "first_step" not in clock:
                torch.cuda.synchronize()
                clock["first_step"] = time.time()

    class Fault(Callback):
        def on_batch_end(self, model, step, logs):
            if relaunch or spec.index != n - 1:
                return
            if mode == "kill" and step == KILL_STEP:
                open(marker, "w").close()
                os._exit(17)
            if mode == "stop" and step == STOP_STEP:
                with open(marker, "w") as f:
                    f.write(repr(time.time()))
                signal.raise_signal(signal.SIGSTOP)

    x, y = chip_smoke.lm_rows(BATCH * n * STEPS, chip_smoke.LM["max_len"])
    with dtt.DataParallel().scope():
        model = dtt.Model(dtt.models.transformer_lm(
            chip_smoke.VOCAB, dtype="bfloat16",
            **dict(chip_smoke.LM, num_layers=LAYERS)))
        model.compile(optimizer=dtt.optim.fused_adamw(3e-4, weight_decay=0.01),
                      loss=chip_smoke.PALLAS, metrics=[])
    cbs = [Clock("restore_begin"),
           ModelCheckpoint(ckpt_dir, save_freq=3, restore=True),
           Clock("restore_end"), Fault()]
    hist = model.fit(x, y, batch_size=BATCH * n, epochs=EPOCHS,
                     steps_per_epoch=STEPS, shuffle=True, seed=0, verbose=0,
                     callbacks=cbs)
    dtt.launch.report_result({
        "rank": spec.index, "relaunch": relaunch,
        "loss": hist.history["loss"], "digest": digest(dtt, model),
        "restore_s": clock["restore_end"] - clock["restore_begin"],
        "start_to_first_step_s": clock["first_step"] - T_START,
        "device": torch.cuda.get_device_name(0)})
    dtt.cluster.shutdown()


def sup_worker(ckpt_dir, strategy, global_batch, sigterm_step, marker):
    """One rank of a supervised gang (``--supervise``)."""
    import shutil

    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.ops import flash_attention as flash_ops
    from distributed_tpu_torch.ops import fused_update as adam_ops
    from distributed_tpu_torch.ops import pallas_kernels as xent_ops
    from distributed_tpu_torch.resilience import (BuddyRedundancy,
                                                  FaultInjector,
                                                  PreemptionHandler)
    from distributed_tpu_torch.training.callbacks import (Callback,
                                                          ModelCheckpoint)

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = dtt.cluster.initialize(timeout=120)
    global_batch, sigterm_step = int(global_batch), int(sigterm_step)
    x, y = chip_smoke.lm_rows(global_batch * STEPS, chip_smoke.LM["max_len"])
    cls = dtt.FSDP if strategy == "fsdp" else dtt.DataParallel
    with cls().scope():
        model = dtt.Model(dtt.models.transformer_lm(
            chip_smoke.VOCAB, dtype="bfloat16",
            **dict(chip_smoke.LM, num_layers=LAYERS)))
        model.compile(optimizer=dtt.optim.fused_adamw(3e-4, weight_decay=0.01),
                      loss=chip_smoke.PALLAS, metrics=[])
    # The asynchronous refresh of ModelCheckpoint(buddy=True).
    buddy = BuddyRedundancy.from_env()
    mc = ModelCheckpoint(ckpt_dir, save_freq=3, restore=True, sharded=True,
                         buddy=buddy, buddy_refresh_every=REFRESH_EVERY)
    resumed = {}

    class Settle(Callback):
        """Notes the step the restore resumed from; at the fault step
        waits out the refresh writer, so that the kill or the signal
        after it finds that step's mirror committed."""

        def on_train_begin(self, model):
            resumed["step"] = model._resumed_step

        def on_batch_end(self, model, step, logs):
            if step == KILL_STEP and buddy is not None:
                buddy.wait()

    class Preempt(Callback):
        """Rank 0 sends itself SIGTERM after ``sigterm_step`` (once)."""

        def on_batch_end(self, model, step, logs):
            if (step == sigterm_step and spec.index == 0
                    and not os.path.exists(marker)):
                open(marker, "w").close()
                os.kill(os.getpid(), signal.SIGTERM)

    cbs = [mc, Settle(), Preempt(), PreemptionHandler(ckpt_dir, checkpointer=mc.ckpt),
           *filter(None, [FaultInjector.from_env()])]
    for mod in (xent_ops, flash_ops, adam_ops):
        mod.reset_launch_counts()
    hist = model.fit(x, y, batch_size=global_batch, epochs=EPOCHS,
                     steps_per_epoch=STEPS, shuffle=True, seed=0, verbose=0,
                     callbacks=cbs)
    torch.cuda.synchronize()
    launches = {k: n for mod in (xent_ops, flash_ops, adam_ops)
                for k, n in mod.launches.items()}
    shm = shutil.disk_usage("/dev/shm") if os.path.isdir("/dev/shm") else None
    value = {
        "rank": spec.index, "world": torch.distributed.get_world_size(),
        "attempt": os.environ.get("DTPU_ATTEMPT"),
        "resumed_step": resumed["step"],
        "loss": hist.history["loss"], "digest": digest(dtt, model),
        "launches": launches,
        "store_bytes": (buddy.store.bytes_held(spec.index)
                        if buddy is not None else None),
        "redundancy": model.last_fit_telemetry.get("redundancy"),
        "shm_free_bytes": shm.free if shm else None,
        "device": torch.cuda.get_device_name(0)}
    dtt.launch.report_result(value)
    dtt.cluster.shutdown()


CASES = {
    # name: (fault spec, buddy store, SIGTERM step, elastic)
    "reference": (None, False, 0, False),
    "kill": ("kill:at_step={k},rank={last}", True, 0, False),
    "preempt": (None, True, KILL_STEP, False),
    "corrupt": ("corrupt_checkpoint:at_step={c},rank=0,directory={ckpt}",
                False, 0, False),
    "pair": ("buddy_kill:at_step={k},rank={last}", True, 0, False),
    "elastic": ("kill:at_step={k},rank={last}", False, 0, True),
}


def run_case(n, timeout, tmp, case, strategy):
    """One gang of ``case`` under ``python -m distributed_tpu_torch.launch
    --supervise``: ``(exit code, result rows, events, store dir)``."""
    from distributed_tpu_torch.resilience import ram_dir
    from distributed_tpu_torch.utils.events import read_events

    fault, buddy, sigterm, elastic = CASES[case]
    d = os.path.join(tmp, case)
    os.makedirs(d)
    ckpt, log = os.path.join(d, "ckpt"), os.path.join(d, "events.jsonl")
    rows_path = os.path.join(d, "rows.json")
    argv = [sys.executable, "-m", "distributed_tpu_torch.launch",
            "--supervise", "--num-workers", str(n), "--timeout", str(timeout),
            "--max-restarts", "3", "--checkpoint-dir", ckpt, "--event-log",
            log, "--results-json", rows_path]
    store = None
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for var in ("DTPU_FAULT", "DTPU_FAULT_MARKER", "DTPU_BUDDY_STORE"):
        env.pop(var, None)
    if buddy:
        store = str(ram_dir(prefix="dtt-buddy-"))
        if n > 1:
            argv += ["--buddy-store-dir", store]
        else:  # one host that stays up: its tmpfs outlives the process
            env["DTPU_BUDDY_STORE"] = store
    if elastic:
        argv += ["--elastic-min-workers", "2", "--elastic-divisor",
                 str(BATCH * n)]
    argv += [os.path.abspath(__file__), "--sup-worker", ckpt, strategy,
             str(BATCH * n), str(sigterm), os.path.join(d, "sigterm-sent")]
    if fault:
        env["DTPU_FAULT"] = fault.format(k=KILL_STEP, c=CORRUPT_STEP,
                                         last=n - 1, ckpt=ckpt)
        if not elastic:  # the elastic case's fault fires on every attempt
            env["DTPU_FAULT_MARKER"] = os.path.join(d, "fault-fired")
    t = time.time()
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=timeout + 120)
    print(f"  {case}: {time.time() - t:.1f} s, exit {proc.returncode}; "
          + " | ".join(line for line in proc.stdout.splitlines()
                       if line.startswith("supervisor:")))
    rows = []
    if os.path.exists(rows_path):
        with open(rows_path) as f:
            rows = json.load(f)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
    events = read_events(log) if os.path.exists(log) else []
    return proc.returncode, rows, events, store


def supervise_cases(n, timeout, cases, reference=None):
    """``--supervise``: the reference gang (unless ``reference``, a path to
    its result values), then each case (module docstring), one after
    another; returns the summary printed as the last line."""
    import shutil

    strategy = "dp" if n == 1 else "fsdp"
    tmp = tempfile.mkdtemp(prefix="torch_supervise_")
    out, ok = {"world": n, "strategy": strategy, "cases": {}}, True
    if reference:
        with open(reference) as f:
            want = {v["rank"]: v for v in json.load(f)}
    else:
        rc, ref, _, _ = run_case(n, timeout, tmp, "reference", strategy)
        if rc != 0:
            return False, out
        want = {r["index"]: r["value"] for r in ref}
    out["reference_loss"] = want[0]["loss"]
    for case in cases:
        rc, rows, events, store = run_case(n, timeout, tmp, case, strategy)
        got = {r["index"]: r["value"] for r in rows}
        rec = [e for e in events if e["event"] == "recovery"]
        row = {"exit": rc, "recovery": rec,
               "attempts": [(e["attempt"], e["world_size"]) for e in events
                            if e["event"] == "attempt_start"],
               "restarts": [(e["reason"], e.get("restarts_used"),
                             e.get("preemptions")) for e in events
                            if e["event"] == "restart"],
               "corrupt_skipped": [e["step"] for e in events if e["event"]
                                   == "corrupt_checkpoint_skipped"],
               "restore_end": [(e["rank"], e["tier"], e["step"],
                                e.get("disk_block_reads"), e["seconds"])
                               for e in events
                               if e["event"] == "restore_end"],
               "store_bytes": [v.get("store_bytes") for v in got.values()],
               "shm_free_bytes": [v.get("shm_free_bytes")
                                  for v in got.values()],
               "redundancy": [v.get("redundancy") for v in got.values()],
               "launches": got.get(0, {}).get("launches")}
        if case == "elastic":
            loss = got.get(0, {}).get("loss", [None])[-1]
            ref_loss = want[0]["loss"][-1]
            row["last_loss"], row["reference_last_loss"] = loss, ref_loss
            # Every rank of the smaller gang resumed from the disk's step 3,
            # the last save before the kill at step 5.
            row["resumed_steps"] = [v.get("resumed_step")
                                    for v in got.values()]
            same = (loss is not None
                    and abs(loss - ref_loss) <= ELASTIC_RTOL * abs(ref_loss)
                    and len(got) == n // 2
                    and all(v["world"] == n // 2 for v in got.values())
                    and row["resumed_steps"] == [3] * (n // 2))
        else:
            same = rc == 0 and len(got) == n and all(
                got[r]["digest"] == want[r]["digest"]
                and got[r]["loss"][-1] == want[r]["loss"][-1]
                for r in range(n))
        tiers = [(t, s, reads) for _, t, s, reads, _ in row["restore_end"]]
        expect = {"kill": ("buddy", KILL_STEP, 0),
                  "pair": ("disk", 3, None)}.get(case)
        if expect is not None and (not tiers or any(
                t != expect[0] or s != expect[1]
                or (expect[2] is not None and r != expect[2])
                for t, s, r in tiers)):
            same = False
        if case == "pair" and any(not r for _, _, r in tiers):
            same = False  # the disk tier reads blocks
        if case == "preempt" and (
                row["restarts"] != [("preempted", 0, 1)]):
            same = False
        if case == "corrupt" and set(row["corrupt_skipped"]) != {6}:
            same = False
        row["ok"] = bool(same and rc == 0)
        ok &= row["ok"]
        for r in rec:
            print(f"  {case} recovery: detect {r.get('detect_s')} s, gang "
                  f"re-form {r.get('gang_reform_s')} s, restore "
                  f"{r.get('restore_s')} s [{r.get('restore_tier')} at step "
                  f"{r.get('restore_step')}, {r.get('disk_block_reads')} "
                  f"disk block reads], first step {r.get('recompile_s')} s; "
                  f"to first step {r.get('total_to_first_step_s')} s")
        print(f"  {case}: {'OK' if row['ok'] else 'FAILED'}; attempts "
              f"{row['attempts']}, restarts {row['restarts']}, restores "
              f"{row['restore_end']}, store bytes {row['store_bytes']}, "
              f"/dev/shm free {row['shm_free_bytes']}"
              + (f", resumed from steps {row['resumed_steps']}, last loss "
                 f"{row['last_loss']!r} vs {row['reference_last_loss']!r} "
                 f"(rtol {ELASTIC_RTOL:g})" if case == "elastic" else ""))
        if case == "kill":
            log = os.path.join(tmp, case, "events.jsonl")
            post = subprocess.run(
                [sys.executable, "-m", "distributed_tpu_torch.obs.cli", log,
                 "--tail", "4"], capture_output=True, text=True, timeout=120,
                env=dict(os.environ, PYTHONPATH=ROOT))
            print("  postmortem (python -m distributed_tpu_torch.obs.cli):")
            for line in post.stdout.splitlines():
                print(f"    {line}")
            row["postmortem_ok"] = post.returncode == 0 and \
                "recovery (attempt 1 -> 2)" in post.stdout
            ok &= row["postmortem_ok"]
        if store:
            shutil.rmtree(store, ignore_errors=True)
        out["cases"][case] = row
    return ok, out


def run(dtt, n, timeout, mode, tmp):
    """The launcher's rows of one gang: ``mode`` "none" (uninterrupted),
    "kill" (under run_with_restart) or "stop" (liveness)."""
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    argv = [sys.executable, os.path.abspath(__file__), "--worker",
            os.path.join(tmp, f"ckpt-{mode}"), os.path.join(tmp, f"marker-"
                                                             f"{mode}"), mode]
    launcher = dtt.launch.LocalLauncher(env_extra=env)
    if mode == "kill":
        return dtt.launch.run_with_restart(
            launcher, argv, n, max_restarts=1, restart_backoff=0.0,
            timeout=timeout, grace=5.0)
    kw = {"liveness_timeout": LIVENESS, "grace": 5.0} if mode == "stop" else {}
    return launcher.run(argv, n, timeout=timeout, **kw)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--liveness", action="store_true")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--cases", nargs="+", default=None,
                    choices=[c for c in CASES if c != "reference"],
                    help="--supervise cases (default: kill preempt corrupt "
                         "on one card, kill pair elastic preempt on more)")
    ap.add_argument("--reference", default=None,
                    help="--supervise: a JSON list of an uninterrupted "
                         "run's result values to hold the cases to, in place "
                         "of a reference gang")
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--sup-worker", nargs=5, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    if args.sup_worker:
        sup_worker(*args.sup_worker)
        return 0
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt

    if not torch.cuda.is_available():
        print("needs NVIDIA cards", file=sys.stderr)
        return 2
    n = args.num_workers
    print(chip_smoke.card_line(), f"x {torch.cuda.device_count()}")
    if args.supervise:
        cases = args.cases or (["kill", "preempt", "corrupt"] if n == 1
                               else ["kill", "pair", "elastic", "preempt"])
        ok, out = supervise_cases(n, args.timeout, cases, args.reference)
        print(json.dumps({"supervise": dict(out, ok=ok)}))
        return 0 if ok else 1
    tmp = tempfile.mkdtemp(prefix="torch_restart_")
    if args.liveness:
        t = time.time()
        rows = run(dtt, n, args.timeout, "stop", tmp)
        end = time.time()
        with open(os.path.join(tmp, "marker-stop")) as f:
            stopped = float(f.read())
        hung = [r for r in rows if r.disposition == "liveness_killed"]
        print(f"liveness: {n} worker(s), rows "
              f"{[(r.index, r.disposition, r.error) for r in rows]}; "
              f"{end - stopped:.3f} s from the stop to the launcher's "
              f"return (liveness_timeout {LIVENESS:g} s, grace 5 s), "
              f"{end - t:.1f} s in all")
        # Its peers stop beating too, blocked at a collective with it: each
        # is killed by the probe or with the gang.
        ok = n - 1 in {r.index for r in hung} and not any(r.ok for r in rows)
        print(json.dumps({"liveness": {"stop_to_kill_s": end - stopped,
                                       "ok": ok}}))
        return 0 if ok else 1
    got = run(dtt, n, args.timeout, "kill", tmp)
    want = run(dtt, n, args.timeout, "none", tmp)
    failed = [r for r in got + want if not r.ok]
    for r in failed:
        print(f"worker {r.index} FAILED ({r.error})\n{r.log_tail}")
    if failed:
        return 1
    ok = True
    for g, w in zip(got, want):
        a, b = g.value, w.value
        same = a["digest"] == b["digest"] and a["loss"][-1] == b["loss"][-1]
        ok &= same and a["relaunch"] and not b["relaunch"]
        print(f"rank {a['rank']}: resumed run {'bit-identical to' if same else 'DIFFERS from'} "
              f"the uninterrupted one (last epoch loss {a['loss'][-1]!r} vs "
              f"{b['loss'][-1]!r}); restore {a['restore_s']:.3f} s; start "
              f"to first step {a['start_to_first_step_s']:.3f} s after the "
              f"relaunch ({b['start_to_first_step_s']:.3f} s uninterrupted)"
              f" | {a['device']}")
    print(json.dumps({"restart": {"ok": ok, "resumed": [r.value for r in got],
                                  "uninterrupted": [r.value for r in want]}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
