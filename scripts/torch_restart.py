#!/usr/bin/env python3
"""A killed gang resumed by the launcher: ``run_with_restart`` on the cards.

    python3 scripts/torch_restart.py [--num-workers 4] [--timeout 900]

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

Needs the cards; imports nothing of JAX.
"""

import time

T_START = time.time()  # the worker's start, before any import

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LAYERS, BATCH, EPOCHS, STEPS = 2, 8, 3, 4
KILL_STEP, STOP_STEP, LIVENESS = 5, 2, 10.0


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
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt

    if not torch.cuda.is_available():
        print("needs NVIDIA cards", file=sys.stderr)
        return 2
    n = args.num_workers
    print(chip_smoke.card_line(), f"x {torch.cuda.device_count()}")
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
