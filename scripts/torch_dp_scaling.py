#!/usr/bin/env python3
"""Data-parallel training across the cards of one host, through the launcher.

    python3 scripts/torch_dp_scaling.py [--num-workers 1 4] [--timeout 900]
        [--strategy dp zero1 fsdp]

For each worker count N, starts N processes with the port's
``launch.LocalLauncher`` (one per card, each with its own DTPU_CONFIG).
Every worker forms the NCCL group with ``cluster.initialize()``, builds
under ``DataParallel()`` and trains, with TF32 off, chip_smoke.py's
phase-k and phase-l configurations at N times their global batch (the
same rows per card as on one card, the reference's scaling rule): the
mnist_cnn (256 images per card, ``SGD(0.001)``, 10 warm-up and 100 timed
steps as one ``fit`` epoch), the cifar_cnn (256 per card, ``SGD(0.01,
momentum=0.9)``, 5 + 50 steps), ResNet-50 as chip_smoke.py's phase n
configures it (bf16, sync-BN, 256 images of 224x224 per card, ``SGD(0.1,
momentum=0.9)``, 3 + 20 steps) and the GPT-2-small LM (32 x 1024 tokens
per card, ``fused_adamw(3e-4, weight_decay=0.01)``, the pallas loss, 2 + 5
one-step epochs). After each model the replicas, parameters and
BatchNorm buffers alike, must be bit-identical (``utils.sync_check``). It also times one all-reduce of each model's
gradient bucket on its own (CUDA events, after a barrier). Then each
worker count trains both models 3 steps more at one global batch for
every N (mnist_cnn 256 images; phase o's small f32 ResNet, 32 images of
32x32, ``SGD(0.01, momentum=0.9)``; the LM 32 x 1024 tokens; fresh
weights from seed 1): the losses at N workers must match those at the
first N, to 1e-5 relative (mnist), 1e-4 (the ResNet: sync-BN makes each
BatchNorm's statistics those of the global batch, summed in another
order) and 2e-3 (the LM's bf16 layers round partial gradients at other
places).

``--strategy`` picks the strategies, each run in turn for every N:
``dp`` (``DataParallel``: every model above), ``zero1``
(``ZeroDataParallel``) and ``fsdp`` (``FSDP``); the sharded two train the
LM only (its timed run and its parity run at one global batch for every
N), which is where their memory shows: each row also carries the model
state a card holds (``model_state_bytes_per_device`` of ``fit``'s
telemetry, the largest over the ranks).

Prints, per strategy, N and model, steps/s, images or tokens per second
(in all and per card), the all-reduce's ms, the model state a card holds
and its ratio to ``dp``'s at the same N where both ran, and one JSON
line; exits non-zero when a worker fails, the replicas differ or the
losses disagree.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Per card: (batch, warm-up steps, timed steps).
CNN_RUN = {"mnist_cnn": (256, 10, 100), "cifar_cnn": (256, 5, 50),
           "resnet50": (256, 3, 20)}
LM_RUN = (32, 2, 5)
# The same global batch at every N: (model, global batch, loss rtol).
PARITY = (("mnist_cnn", 256, 1e-5), ("small_resnet", 32, 1e-4), ("lm", 32, 2e-3))
STRATEGIES = {"dp": "DataParallel", "zero1": "ZeroDataParallel",
              "fsdp": "FSDP"}


def worker(strategy_name="dp"):
    import numpy as np
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.utils import sync_check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = dtt.cluster.initialize(timeout=300)
    strategy = getattr(dtt, STRATEGIES[strategy_name])()
    sharded = strategy_name != "dp"
    n = strategy.num_replicas_in_sync
    rows = {}

    def allreduce_ms(numel):
        flat = torch.zeros(numel, device=strategy.device)
        for _ in range(3):
            torch.distributed.all_reduce(flat)
        torch.distributed.barrier()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            torch.distributed.all_reduce(flat)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 10

    def run(name, model, x, y, batch, warmup, epochs, steps, unit, per_row):
        model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=warmup,
                  shuffle=False, verbose=0)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t = time.perf_counter()
        hist = model.fit(x, y, batch_size=batch, epochs=epochs,
                         steps_per_epoch=steps, shuffle=False, verbose=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        sync_check.assert_model_replicas_identical(model)
        sps = epochs * steps / wall
        rows[name] = {"steps_per_s": sps, "unit": unit,
                      "per_s": sps * batch * per_row,
                      "loss": hist.history["loss"],
                      "allreduce_ms": allreduce_ms(model.num_params),
                      "model_state_bytes_per_device": model.last_fit_telemetry[
                          "model_state_bytes_per_device"]}

    def setup(name, batch, seed=0):
        """(model, x, y) of one configuration at a global batch."""
        if name == "lm":
            x, y = chip_smoke.lm_batch(batch, chip_smoke.LM["max_len"])
            module = dtt.models.transformer_lm(
                chip_smoke.VOCAB, dtype="bfloat16", **chip_smoke.LM)
            opt = dtt.optim.fused_adamw(3e-4, weight_decay=0.01)
            loss, shape = ("pallas_sparse_categorical_crossentropy",
                           (chip_smoke.LM["max_len"],))
        elif name == "resnet50":
            x, y = chip_smoke.resnet_batch(batch)
            module = dtt.models.resnet(50, 1000, dtype="bfloat16")
            opt = dtt.optim.SGD(0.1, momentum=0.9)
            loss, shape = "sparse_categorical_crossentropy", (224, 224, 3)
        elif name == "small_resnet":
            # The parity run: phase o's f32 ResNet. (ResNet-50's own
            # stage-4 kernel gradients at initialisation move by 8-12 %
            # when the rows of one batch are merely summed in reverse
            # order, f32 on one process: no reduction order can be held
            # to them.)
            x, y = chip_smoke.resnet_batch(batch, size=32, classes=10, seed=1)
            module = dtt.models.resnet(50, 10, small_inputs=True,
                                       stage_blocks=(1, 1, 1, 1), width=16)
            opt = dtt.optim.SGD(0.01, momentum=0.9)
            loss, shape = "sparse_categorical_crossentropy", (32, 32, 3)
        else:
            if name == "mnist_cnn":
                x, y = dtt.data.synthetic_images(batch, (28, 28), 10, 0)
                x = x[..., None].astype(np.float32) / 255.0
                opt, shape = dtt.optim.SGD(0.001), (28, 28, 1)
            else:
                rng = np.random.default_rng(0)
                x = rng.standard_normal((batch, 32, 32, 3), dtype=np.float32)
                y = rng.integers(0, 10, (batch,), dtype=np.int64).astype(
                    np.int32)
                opt, shape = dtt.optim.SGD(0.01, momentum=0.9), (32, 32, 3)
            module, loss = getattr(dtt.models, name)(), (
                "sparse_categorical_crossentropy")
        with strategy.scope():
            model = dtt.Model(module)
            model.compile(optimizer=opt, loss=loss, metrics=["accuracy"])
        model.build(shape, seed=seed)
        return model, x, y

    for name, (per_card, warmup, steps) in CNN_RUN.items():
        if sharded:
            break
        model, x, y = setup(name, per_card * n)
        run(name, model, x, y, per_card * n, warmup, 1, steps, "images", 1)
        del model
    per_card, warmup, steps = LM_RUN
    model, x, y = setup("lm", per_card * n)
    run("lm", model, x, y, per_card * n, warmup, steps, 1, "tokens",
        chip_smoke.LM["max_len"])
    del model
    parity = {}
    for name, batch, _ in PARITY:
        if sharded and name != "lm":
            continue
        model, x, y = setup(name, batch, seed=1)
        parity[name] = model.fit(x, y, batch_size=batch, epochs=3,
                                 steps_per_epoch=1, shuffle=False,
                                 verbose=0).history["loss"]
        sync_check.assert_model_replicas_identical(model)
        del model
    dtt.launch.report_result({"rank": spec.index, "world": n,
                              "device": str(strategy.device), "rows": rows,
                              "parity": parity})
    dtt.cluster.shutdown()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-workers", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--strategy", nargs="+", default=["dp"],
                    choices=sorted(STRATEGIES))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.strategy[0])
        return 0
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt

    if not torch.cuda.is_available():
        print("needs NVIDIA cards", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), f"x {torch.cuda.device_count()}")
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    out, failed = {}, False
    for strat in args.strategy:
        out[strat] = run_strategy(dtt, env, args, strat)
        if out[strat] is None:
            failed = True
            break
        for n, res in out[strat].items():
            dp = out.get("dp", {}).get(n)
            for name, row in res["rows"].items():
                total = row["per_s"]
                state = row["model_state_bytes_per_device"]
                vs = ""
                if dp is not None and name in dp["rows"]:
                    ref = dp["rows"][name]
                    vs = (f" ({state / ref['model_state_bytes_per_device']:.4f}"
                          f" of dp's; per-card rate "
                          f"{total / ref['per_s']:.4f} of dp's)")
                print(f"{strat} N={n} {name:9s} {row['steps_per_s']:8.3f} "
                      f"steps/s, {total:12.1f} {row['unit']}/s "
                      f"({total / n:12.1f} per card), all-reduce of the "
                      f"gradients {row['allreduce_ms']:.3f} ms, model state "
                      f"{state / 1e9:.4f} GB a card{vs}, losses "
                      f"{[round(v, 5) for v in row['loss']]}")
            first = out[strat][args.num_workers[0]]["parity"]
            for name, batch, rtol in PARITY:
                if name not in res["parity"]:
                    continue
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(res["parity"][name], first[name]))
                print(f"{strat} N={n} {name:9s} at global batch {batch}: "
                      f"losses {res['parity'][name]}, max relative "
                      f"difference from N={args.num_workers[0]} {rel:.3e} "
                      f"(limit {rtol:g})")
                failed |= rel > rtol
    print(json.dumps(out))
    return 1 if failed else 0


def run_strategy(dtt, env, args, strat):
    """{N: {"devices", "rows", "parity"}} of one strategy at every worker
    count, or None when a worker failed (its log printed)."""
    res = {}
    for n in args.num_workers:
        results = dtt.launch.LocalLauncher(env_extra=env).run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--strategy", strat], n, timeout=args.timeout)
        bad = [r for r in results if not r.ok]
        for r in bad:
            print(f"{strat} N={n} worker {r.index} FAILED ({r.error})\n"
                  f"{r.log_tail}")
        if bad:
            return None
        res[n] = {"devices": [r.value["device"] for r in results],
                  "rows": results[0].value["rows"],
                  "parity": results[0].value["parity"]}
    return res


if __name__ == "__main__":
    sys.exit(main())
