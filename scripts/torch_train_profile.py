#!/usr/bin/env python3
"""Where the PyTorch port's training step time goes, on one NVIDIA card.

    python3 scripts/torch_train_profile.py [--workload lm] [--layers 12]
                                           [--steps 3]

Trains one of chip_smoke.py's configurations through ``Model.fit``:
``lm`` is phase h (the GPT-2-small LM at full width, bf16 layers, random
weights from seed 0, ``Adam(1e-4)``, the pallas loss, batch 32 x 1024
tokens from ``numpy.random.default_rng(0)``); ``lm_dp`` is phase l (the
same under a world-1 ``DataParallel`` with ``fused_adamw(3e-4)``);
``mnist_cnn`` and ``cifar_cnn`` are phase k's (world-1 ``DataParallel``,
global batch 256, TF32 off); ``resnet50`` is phase n (ResNet-50 in bf16 as
the JAX package's ``bench_resnet50`` configures it, world-1
``DataParallel``, global batch 256 at 224x224, ``SGD(0.1, momentum=0.9)``);
``vit_base`` is phase v4 (ViT-B/16 with ``scan=True``, bf16 layers, 128
seeded uint8 images at 224x224, 1,000 classes, ``fused_adamw(1e-3)``,
the pallas loss, ``SingleDevice``).
Two warm-up steps, a timed run of ``--steps``
steps (host clock, ending in a synchronize), then the same number of
steps under ``torch.profiler`` (CPU and CUDA): device time by kernel,
grouped into the port's CUDA kernels, GEMMs, convolutions and the rest,
and the device's busy share of the timed run's wall time.

Prints a summary; ``--out PATH`` also writes the numbers there as JSON.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the workload definition)
import distributed_tpu_torch as dtt  # noqa: E402

# Kernel-name fragments of each group (first match wins).
GROUPS = (
    ("flash attention (port)", ("flash_fwd_", "flash_dq_", "flash_dkv_")),
    ("cross-entropy (port)", ("xent_fwd_kernel", "xent_bwd_kernel")),
    ("fused Adam (port)", ("fused_adam_kernel",)),
    ("1x1-conv GEMM K12 (port)", ("conv1x1_wgmma_kernel",
                                  "conv1x1_f32_kernel")),
    ("BatchNorm reductions K13/K14 (port)", ("bn_reduce_kernel",)),
    ("layout copies (NCHW<->NHWC, contiguous)", (
        "nchwToNhwc", "nhwcToNchw", "direct_copy", "CatArrayBatchedCopy")),
    ("convolution (cuDNN)", ("conv", "Conv", "wgrad", "dgrad", "implicit")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "Gemm", "xmma", "cutlass")),
    ("softmax", ("softmax", "Softmax")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("all-reduce (NCCL)", ("nccl",)),
)


def group_of(name):
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other (elementwise, reductions, copies)"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lm",
                    choices=("lm", "lm_dp", "mnist_cnn", "cifar_cnn",
                             "resnet50", "vit_base"))
    ap.add_argument("--layers", type=int, default=chip_smoke.LM["num_layers"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.workload.startswith("lm"):
        lm = dict(chip_smoke.LM, num_layers=args.layers)
        t_len, batch = lm["max_len"], 32
        x, y = chip_smoke.lm_batch(batch, t_len)
        module = dtt.models.transformer_lm(chip_smoke.VOCAB, dtype="bfloat16",
                                           **lm)
        input_shape = (t_len,)
        loss = "pallas_sparse_categorical_crossentropy"
    elif args.workload == "vit_base":
        batch, rng = 128, np.random.default_rng(0)
        x = rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
        y = rng.integers(0, 1000, (batch,)).astype(np.int32)
        module = dtt.models.vit_base(1000, dtype="bfloat16", scan=True)
        input_shape = (224, 224, 3)
        loss = "pallas_sparse_categorical_crossentropy"
    elif args.workload == "resnet50":
        batch = chip_smoke.RESNET_BATCH
        x, y = chip_smoke.resnet_batch(batch)
        module = dtt.models.resnet(50, 1000, dtype="bfloat16")
        input_shape, loss = (224, 224, 3), "sparse_categorical_crossentropy"
    else:
        batch = 256
        if args.workload == "mnist_cnn":
            x, y = dtt.data.synthetic_images(batch, (28, 28), 10, 0)
            x = x[..., None].astype("float32") / 255.0
            module, input_shape = dtt.models.mnist_cnn(), (28, 28, 1)
        else:
            rng = np.random.default_rng(0)
            x = rng.standard_normal((batch, 32, 32, 3), dtype=np.float32)
            y = rng.integers(0, 10, (batch,), dtype=np.int64).astype(np.int32)
            module, input_shape = dtt.models.cifar_cnn(), (32, 32, 3)
        loss = "sparse_categorical_crossentropy"
    optimizer = {"lm": dtt.optim.Adam(1e-4),
                 "lm_dp": dtt.optim.fused_adamw(3e-4, weight_decay=0.01),
                 "mnist_cnn": dtt.optim.SGD(0.001),
                 "cifar_cnn": dtt.optim.SGD(0.01, momentum=0.9),
                 "resnet50": dtt.optim.SGD(0.1, momentum=0.9),
                 "vit_base": dtt.optim.fused_adamw(1e-3)}[args.workload]
    strategy = (dtt.SingleDevice() if args.workload in ("lm", "vit_base")
                else dtt.DataParallel())
    with strategy.scope():
        model = dtt.Model(module)
        model.compile(optimizer=optimizer, loss=loss, metrics=["accuracy"])
    model.build(input_shape, seed=0)

    def fit(steps):
        t = time.perf_counter()
        model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=steps,
                  shuffle=False, verbose=0)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    fit(2)  # warm-up
    wall = fit(args.steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = fit(args.steps)
    cuda = torch.autograd.DeviceType.CUDA

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # The fit loop's spans (record_function ranges) also show on the
    # card's timeline, over the kernels they hold: left out.
    spans = ("input_wait", "dispatch", "checkpoint_wait")
    kernels = sorted(
        ({"name": e.key, "count": int(e.count), "device_ms": dev_us(e) / 1e3}
         for e in prof.key_averages()
         if e.device_type == cuda and dev_us(e) > 0 and e.key not in spans),
        key=lambda r: -r["device_ms"],
    )
    busy_ms = sum(k["device_ms"] for k in kernels)
    groups = {}
    for k in kernels:
        g = groups.setdefault(group_of(k["name"]), {"device_ms": 0.0,
                                                    "launches": 0})
        g["device_ms"] += k["device_ms"]
        g["launches"] += k["count"]
    steps = args.steps
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": chip_smoke.card_line(),
        "workload": args.workload,
        "layers": args.layers,
        "timed_run": {"steps": steps, "wall_s": wall,
                      "ms_per_step": 1e3 * wall / steps},
        "profiled_run": {
            "wall_s": prof_wall,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_busy_share_of_timed_run": busy_ms / (1e3 * wall),
            "groups_ms_per_step": {k: v["device_ms"] / steps
                                   for k, v in groups.items()},
            "group_launches_per_step": {k: v["launches"] / steps
                                        for k, v in groups.items()},
            "top_kernels": kernels[:25],
        },
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(f"{result['card']} | {args.workload} | layers {args.layers}")
    print(f"timed run: {steps} steps in {wall:.3f} s, "
          f"{1e3 * wall / steps:.1f} ms/step")
    p = result["profiled_run"]
    print(f"profiled run: {prof_wall:.3f} s wall; device busy "
          f"{busy_ms / steps:.1f} ms/step = "
          f"{p['device_busy_share_of_timed_run']:.1%} of the timed run")
    for k, v in sorted(groups.items(), key=lambda kv: -kv[1]["device_ms"]):
        print(f"  {v['device_ms'] / steps:9.2f} ms/step  "
              f"x{v['launches'] / steps:7.1f}  {k}")
    for k in kernels[:25]:
        print(f"  {k['device_ms'] / steps:9.2f} ms/step  x{k['count'] / steps:7.1f}"
              f"  {k['name'][:100]}")
    dtt.cluster.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
