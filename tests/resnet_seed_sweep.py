#!/usr/bin/env python3
"""How far the tiny-ResNet fit parity tests depend on their data seed.

    JAX_PLATFORMS=cpu python3 tests/resnet_seed_sweep.py \\
        [--config fit|dp] [--seeds 0 1 2 3 4 5 6 7] [--noise 100]

For each data seed, fits the tiny ResNet-50 of ``tests/test_torch_resnet.py``
(``--config fit``: 32 rows, batch 8) or of the sync-BN case in
``tests/test_torch_dp.py`` (``--config dp``: 64 rows, global batch 16, JAX
under ``DataParallel`` over 2 host devices; the port's ``SingleDevice``
stands in for its 2 ranks, which that test holds to it) for 3 steps of
``SGD(0.05, momentum=0.9)``, and prints two rows:

- port: the port (plain versions on the CPU) against JAX, from the same
  parameters and state;
- jax~: JAX against JAX whose initial parameters are each multiplied by
  ``1 + 2e-7 z`` (z standard normal, from ``--noise`` + the data seed),
  a change of the size by which summing in another order moves them.

Each row gives the per-step relative loss difference and the largest
parameter difference after 3 steps; the tests hold these to 1e-5 and 1e-4.
Where the jax~ row parts as far as the port row, the model itself is that
sensitive at that seed (a ReLU or BatchNorm input within rounding of its
kink), whatever the port does.
"""

import argparse
import contextlib
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = dict(small_inputs=True, stage_blocks=(1, 1, 1, 1), width=16)
COMPILE = dict(loss="sparse_categorical_crossentropy", metrics=["accuracy"])
# config: (rows, batch, JAX on 2 devices)
CONFIGS = {"fit": (32, 8, False), "dp": (64, 16, True)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS), default="fit")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--noise", type=int, default=100)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    import distributed_tpu as dtpu
    import distributed_tpu_torch as dtt

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    rows, batch, two = CONFIGS[args.config]
    fit = dict(batch_size=batch, epochs=3, steps_per_epoch=1, shuffle=True,
               seed=0, verbose=0)

    def jax_model():
        scope = (dtpu.DataParallel(jax.devices()[:2]).scope() if two
                 else contextlib.nullcontext())
        with scope:
            jm = dtpu.Model(dtpu.models.resnet(50, 10, **TINY))
            jm.compile(optimizer=dtpu.optim.SGD(0.05, momentum=0.9), **COMPILE)
        jm.build((16, 16, 3), seed=0)
        return jm

    def flat(tree):
        return dtt.interop.flatten_tree(jax.device_get(tree))

    def row(tag, seed, la, lb, pa, pb):
        rel = ", ".join(f"{abs(a - b) / abs(b):.2e}" for a, b in zip(la, lb))
        diff = max(float(np.abs(pa[k] - pb[k]).max()) for k in pb)
        print(f"{args.config} seed {seed} {tag}: loss rel [{rel}], "
              f"max |param diff| {diff:.2e}", flush=True)

    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((rows, 16, 16, 3)).astype(np.float32)
        y = rng.integers(0, 10, rows).astype(np.int32)
        jm = jax_model()
        pm = dtt.Model(dtt.models.resnet(50, 10, **TINY), device="cpu")
        pm.compile(optimizer=dtt.optim.SGD(0.05, momentum=0.9), **COMPILE)
        pm.build((16, 16, 3))
        pm.load_params({k: torch.tensor(v) for k, v in flat(jm.params).items()})
        pm.load_state({k: torch.tensor(v) for k, v in flat(jm.state).items()})
        moved = jax_model()
        z = np.random.default_rng(args.noise + seed)
        moved.params = jax.tree_util.tree_map(
            lambda p: p * (1 + 2e-7 * z.standard_normal(p.shape)).astype(
                np.float32), moved.params)
        lj = jm.fit(x, y, **fit).history["loss"]
        row("port", seed, pm.fit(x, y, **fit).history["loss"], lj,
            dtt.interop.params_to_numpy(pm.params), flat(jm.params))
        row("jax~", seed, moved.fit(x, y, **fit).history["loss"], lj,
            flat(moved.params), flat(jm.params))


if __name__ == "__main__":
    main()
