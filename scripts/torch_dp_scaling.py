#!/usr/bin/env python3
"""Data-parallel training across the cards of one host, through the launcher.

    python3 scripts/torch_dp_scaling.py [--num-workers 1 4] [--timeout 900]
        [--strategy dp zero1 fsdp tp2 tp4 sp_ring sp_ulysses pp2 pp4 pp2i
                    ep2 ep4 composite sp2tp2 fsdp2sp2 ep2tp2 ep2sp2
                    ep2fsdp2 ep2pp2 moe_sp_ring moe_sp_ulysses]
        [--dropout RATE] [--predict] [--shard-auto]

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
``dp`` (``DataParallel``), ``zero1`` (``ZeroDataParallel``), ``fsdp``
(``FSDP``), ``tp2`` and ``tp4`` (``DataTensorParallel(model_parallel=2
or 4)``: 32 x 1024 tokens a data rank, so data 2 or 1 on 4 cards). All
but ``dp`` train the LM only (its timed run and its parity run at one
global batch for every N), which is where their memory shows; ``dp``
trains every model above when it is listed alone, and the LM only, as
the others' baseline, when it is listed with them. Each row also carries
the model state a card holds (``model_state_bytes_per_device`` of
``fit``'s telemetry, the largest over the ranks). A strategy skips an N
its split axis does not divide, and its parity losses are held to
``dp``'s at the first N where it ran. Under ``tp2``/``tp4`` the
replicated leaves must stay bit-identical across the ranks too.

The pipeline, expert and composite strategies train the LM only, and
each runs its own one-card form at N=1 (the same model and global
batch, the split axis of size 1), to which its losses at N are held
(2e-3): ``pp2`` (``DataPipelineParallel(pipeline_parallel=2)``, GPipe,
M = 4), ``pp4`` (pipe 4, M = 8) and ``pp2i`` (pipe 2, the interleaved
schedule with v = 2, M = 4) train the LM with ``pipeline=True`` (its 12
blocks stacked; at pipe 1 the sequential scan); ``ep2`` and ``ep4``
(``DataExpertParallel(expert_parallel=2 or 4)``) chip_smoke.py's phase-y1
MoE LM (8 experts in every second block); ``composite``
(``CompositeParallel({"fsdp": 2, "model": 2})``) the LM. 32 x 1024
tokens a data rank. Their rows add the peak memory a card and the
pipeline's bubble fraction or the share of the routed choices the
experts' capacity dropped. So do ``CompositeParallel``'s other pairs,
each with a data axis of 1 where it has no fsdp axis: ``sp2tp2`` (seq 2
x model 2) and ``fsdp2sp2`` (fsdp 2 x seq 2) train the LM; ``ep2tp2``
(expert 2 x model 2), ``ep2sp2`` (expert 2 x seq 2) and ``ep2fsdp2``
(fsdp 2 x expert 2) phase y1's MoE LM; ``ep2pp2`` (expert 2 x pipe 2, M
= 4) the LM's 12 blocks pipelined with one MoE block of 8 experts after
the stack (an MoE inside the stack raises in both packages). And
``moe_sp_ring`` and ``moe_sp_ulysses`` (``DataSeqParallel(
seq_parallel=2)``: data N/2) phase y1's MoE LM, each rank 512 positions
of its rows, its routing groups over the global token order.

``sp_ring`` and ``sp_ulysses`` (``DataSeqParallel(seq_parallel=N)``,
ring with the zigzag schedule or Ulysses) train ``bench_longctx``'s LM
as chip_smoke.py's phase u1 configures it (GPT-2 width, vocab 32,768,
bf16 layers, remat with ``dots_with_no_batch_dims_saveable``,
``head_chunks=8``, ``Adam(1e-4)``, the pallas loss) at 1 x T tokens: T
65,536 first, with the same run on one card under ``DataParallel`` as
the reference (N=1), then doubling from 131,072 (up to ``SP_MAX``)
until a run fails, or halving below 65,536 when that one fails. Each T
is one group of workers (a failed one is killed after ``SP_TIMEOUT``
seconds); each row gives ms a step, tokens/s, the peak memory a card and
the losses. The losses are compared at the shortest T at which a mode
first ran, where the one-card reference and every other mode also run:
each mode's must match the reference's within 2e-3 (the bf16 layers) and
the other mode's.

``auto`` compiles the LM (32 x 1024 tokens a card, ``fused_adamw``, the
pallas loss) with ``strategy="auto"`` over the N ranks, three times:
uncapped, with ``hbm_cap_bytes`` halfway between the smallest need
(state and activations) of DP's and of FSDP's rows (at N > 1: the
planner's need adds its activation proxy to the state, and a cap on the
state alone leaves no candidate), and with ``measure=True, top_k=3``
(every rank must commit the same candidate). Each trains 2 + 5 one-step
epochs under its plan; its row adds the chosen label, the tie-break, the
planning seconds, the plan's state bytes a card and what a card holds
(which must equal the plan's bytes less the optimizer scalars the port
keeps on the host, and less the f32 accumulator the JAX planner prices
for ``grad_accum > 1``, which the port's fit holds only during a step),
and the tokens/s a card against ``dp``'s at the same N when ``dp`` is
listed.

``--dropout RATE`` puts ``Dropout(RATE)`` after each of the LM's 12
blocks (chip_smoke.py's phase-v5 arrangement) in every LM run, timed and
parity alike, so each strategy's parity losses are held to ``dp``'s at
the first N with the masks drawn: each rank draws its block of the
global mask (its rows, its positions of each row under a sequence
split). With it, ``sp_ring`` and ``sp_ulysses`` train phase l's LM as
the other strategies do (``DataSeqParallel(seq_parallel=2)``: data N/2,
each rank 512 positions of its rows), not the long-context search.

``--predict`` runs, after the strategies, one group at the last N:
each rank builds ResNet-50 (bf16, seed 0) under ``DataParallel()`` and
predicts 1,024 random uint8 images (224x224x3, seed 9) at a global batch
of 256 from ``data.Pipeline(shard="auto")``, which gives it 256/N rows of
each batch; ``predict`` gathers the logits over the group. Every rank's
result must equal, bit for bit, the predict of the same rows as a host
array at batch 256/N (each forward then has the shape of a rank's
shard; cuDNN deterministic, no autotuning). Both predicts are timed
warm: one untimed sharded predict first runs every shape, the group's
first all_gather (NCCL sets its communicator up lazily) and the first
reads. Each row gives both predicts' seconds and images/s: the sharded
one with its shard's reads from the pipeline inside, the host array's
on rows already read; and the reads alone of both (the shard's 1/N of
each batch, the whole array's every row).

``--shard-auto`` adds, for every strategy but ``dp`` and the
long-context search, a run of phase l's LM at 32 x 1024 tokens a data
rank fed by ``data.Pipeline(shard="auto")`` (built outside the
strategy's scope, so ``fit`` reshards it to the row line: the ranks of a
model, seq, expert or pipe line read the same rows): uint8 tokens below
256 (seed 11), each position's label its row's, 2 + 5 steps; the same
steps from the host arrays follow, and the two runs' losses must be
equal on every rank. Its row gives the pipeline run's tokens/s.

Prints, per strategy, N and model, steps/s, images or tokens per second
(in all and per card), the all-reduce's ms, the model state a card holds
and its ratio to ``dp``'s at the same N where both ran, and one JSON
line; exits non-zero when a worker fails, the replicas differ or the
losses disagree.
"""

import argparse
import json
import math
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
STRATEGIES = {"dp": ("DataParallel", {}),
              "zero1": ("ZeroDataParallel", {}), "fsdp": ("FSDP", {}),
              "tp2": ("DataTensorParallel", {"model_parallel": 2}),
              "tp4": ("DataTensorParallel", {"model_parallel": 4}),
              "sp_ring": ("DataSeqParallel", {}),
              "sp_ulysses": ("DataSeqParallel", {"attention": "ulysses"}),
              "pp2": ("DataPipelineParallel",
                      {"pipeline_parallel": 2, "num_microbatches": 4}),
              "pp4": ("DataPipelineParallel",
                      {"pipeline_parallel": 4, "num_microbatches": 8}),
              "pp2i": ("DataPipelineParallel",
                       {"pipeline_parallel": 2, "num_microbatches": 4}),
              "ep2": ("DataExpertParallel", {"expert_parallel": 2}),
              "ep4": ("DataExpertParallel", {"expert_parallel": 4}),
              "composite": ("CompositeParallel",
                            {"axes": {"fsdp": 2, "model": 2}}),
              "sp2tp2": ("CompositeParallel",
                         {"axes": {"data": 1, "seq": 2, "model": 2}}),
              "fsdp2sp2": ("CompositeParallel",
                           {"axes": {"fsdp": 2, "seq": 2}}),
              "ep2tp2": ("CompositeParallel",
                         {"axes": {"data": 1, "expert": 2, "model": 2}}),
              "ep2sp2": ("CompositeParallel",
                         {"axes": {"data": 1, "expert": 2, "seq": 2}}),
              "ep2fsdp2": ("CompositeParallel",
                           {"axes": {"fsdp": 2, "expert": 2}}),
              "ep2pp2": ("CompositeParallel",
                         {"axes": {"data": 1, "expert": 2, "pipe": 2},
                          "num_microbatches": 4}),
              "moe_sp_ring": ("DataSeqParallel", {"seq_parallel": 2}),
              "moe_sp_ulysses": ("DataSeqParallel",
                                 {"seq_parallel": 2, "attention": "ulysses"}),
              "auto": ("auto", {})}
SP = ("sp_ring", "sp_ulysses")
# Under --dropout the SP strategies train the LM at seq 2 (module
# docstring).
SP_LM = {"sp_ring": {"seq_parallel": 2},
         "sp_ulysses": {"seq_parallel": 2, "attention": "ulysses"}}
PREDICT = (1024, 256)  # images, global batch
# The strategies that run their own one-card form at N=1 (the keywords
# that make the split axis 1 there) and the LM's keywords each trains.
ONE_CARD = {"pp2": {"pipeline_parallel": 1}, "pp4": {"pipeline_parallel": 1},
            "pp2i": {"pipeline_parallel": 1},
            "ep2": {"expert_parallel": 1}, "ep4": {"expert_parallel": 1},
            "composite": {"axes": {"fsdp": 1, "model": 1}},
            "moe_sp_ring": {"seq_parallel": 1},
            "moe_sp_ulysses": {"seq_parallel": 1}}
# The composite pairs' one-card forms: every axis of size 1.
ONE_CARD.update({
    name: {"axes": dict.fromkeys(STRATEGIES[name][1]["axes"], 1)}
    for name in ("sp2tp2", "fsdp2sp2", "ep2tp2", "ep2sp2", "ep2fsdp2",
                 "ep2pp2")})
MOE = {"moe_experts": 8, "moe_every": 2}
LM_KW = {"pp2": {"pipeline": True}, "pp4": {"pipeline": True},
         "pp2i": {"pipeline": True, "pipeline_schedule": "interleaved",
                  "pipeline_interleave": 2},
         **dict.fromkeys(("ep2", "ep4", "ep2tp2", "ep2sp2", "ep2fsdp2",
                          "moe_sp_ring", "moe_sp_ulysses"), MOE),
         # Built by pipe_moe_lm: the stack pipelined, one MoE after it.
         "ep2pp2": {"moe_experts": 8}}
# The long-context LM's first T, and its timed steps after one warm-up;
# the longest T the search tries, and the seconds a group of workers at
# one T may take.
SP_FIRST, SP_STEPS = 65536, 2
SP_MAX, SP_TIMEOUT = 524288, 420.0


def strategy_kw(strat, dropout=None):
    """The keywords a strategy is built with (the SP ones' seq 2 under
    ``--dropout``)."""
    kw = STRATEGIES[strat][1]
    return dict(kw, **SP_LM[strat]) if dropout and strat in SP else kw


def split_of(strat, dropout=None):
    """The size of a strategy's split axis (1 for the data-parallel
    family, which any N divides)."""
    kw = strategy_kw(strat, dropout)
    for key in ("model_parallel", "pipeline_parallel", "expert_parallel",
                "seq_parallel"):
        if key in kw:
            return kw[key]
    return math.prod(kw.get("axes", {}).values()) or 1


def sp_worker(strat, t_len):
    """One long-context run at 1 x ``t_len`` under ``strat`` (an SP mode
    over every card, or ``dp`` on one card): 1 warm-up and ``SP_STEPS``
    timed steps; reports ms a step, the losses and the peak memory."""
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt

    torch.backends.cuda.matmul.allow_tf32 = False
    # A rank that runs out of memory leaves the others in a collective:
    # the group's watchdog ends them after this many seconds.
    spec = dtt.cluster.initialize(timeout=90)
    if strat in SP:
        strategy = dtt.DataSeqParallel(
            seq_parallel=torch.distributed.get_world_size(),
            **STRATEGIES[strat][1])
    else:
        strategy = dtt.DataParallel()
    x, y = chip_smoke.lm_batch(1, t_len)
    torch.cuda.reset_peak_memory_stats()
    with strategy.scope():
        model = dtt.Model(dtt.models.transformer_lm(
            chip_smoke.VOCAB, dtype="bfloat16", remat=True,
            remat_policy=chip_smoke.REMAT_POLICY,
            **dict(chip_smoke.LM, max_len=t_len)))
        model.compile(optimizer=dtt.optim.Adam(1e-4), loss=chip_smoke.PALLAS,
                      metrics=[], head_chunks=8)
    model.build((t_len,), seed=0)
    fit = dict(batch_size=1, steps_per_epoch=1, shuffle=False, verbose=0)
    losses = model.fit(x, y, epochs=1, **fit).history["loss"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses += model.fit(x, y, epochs=SP_STEPS, **fit).history["loss"]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / SP_STEPS
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                        device=strategy.device)
    torch.distributed.all_reduce(peak, op=torch.distributed.ReduceOp.MAX)
    dtt.launch.report_result({"rank": spec.index, "ms": ms,
                              "losses": losses, "peak_gb": float(peak),
                              "tokens_per_s": t_len / (ms / 1e3)})
    dtt.cluster.shutdown()


def auto_worker():
    """The three auto-compiled LM runs of one worker (module docstring)."""
    import dataclasses

    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.parallel import auto_shard
    from distributed_tpu_torch.utils import sync_check

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = dtt.cluster.initialize(timeout=300)
    n = torch.distributed.get_world_size()
    per_card, warmup, steps = LM_RUN
    batch, t_len = per_card * n, chip_smoke.LM["max_len"]
    x, y = chip_smoke.lm_batch(batch, t_len)
    device = torch.device("cuda", torch.cuda.current_device())

    def lm(**compile_kw):
        model = dtt.Model(dtt.models.transformer_lm(
            chip_smoke.VOCAB, dtype="bfloat16", **chip_smoke.LM))
        model.compile(optimizer=dtt.optim.fused_adamw(3e-4, weight_decay=0.01),
                      loss=chip_smoke.PALLAS, metrics=["accuracy"],
                      strategy="auto", **compile_kw)
        return model

    runs = {"lm_auto": {}, "lm_auto_measured": {
        "measure": True, "auto_options": {"batch_size": batch, "top_k": 3}}}
    if n > 1:
        pre = auto_shard.plan_sharding(
            dtt.models.transformer_lm(chip_smoke.VOCAB, dtype="bfloat16",
                                      **chip_smoke.LM), (t_len,),
            tx=dtt.optim.fused_adamw(3e-4, weight_decay=0.01),
            batch_size=batch)
        need = {}
        for r in pre.candidates:
            v = r["state_bytes_per_device"] + r["activation_bytes_per_device"]
            kind = r["config"]["strategy"]
            need[kind] = min(need.get(kind, v), v)
        runs["lm_auto_capped"] = {"hbm_cap_bytes": (need["dp"]
                                                    + need["fsdp"]) // 2}
    rows = {}
    for name, kw in runs.items():
        kw.setdefault("auto_options", {"batch_size": batch})
        model = lm(**kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.build((t_len,), seed=0)
        plan_s = time.perf_counter() - t
        plan = model.last_plan
        model.fit(x, y, batch_size=batch, epochs=warmup, steps_per_epoch=1,
                  shuffle=False, verbose=0)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        hist = model.fit(x, y, batch_size=batch, epochs=steps,
                         steps_per_epoch=1, shuffle=False, verbose=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        sync_check.assert_model_replicas_identical(model)
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                            device=device)
        torch.distributed.all_reduce(peak, op=torch.distributed.ReduceOp.MAX)
        host = chip_smoke.host_leaves(plan)
        cand = plan.chosen_candidate()
        accum_bytes = plan.chosen["state_bytes_per_device"] - \
            auto_shard._state_bytes(dataclasses.replace(cand, grad_accum=1),
                                    n, plan._ctx["abstracts"])
        sps = steps / wall
        rows[name] = {
            "steps_per_s": sps, "unit": "tokens", "per_s": sps * batch * t_len,
            "loss": hist.history["loss"],
            "model_state_bytes_per_device": model.last_fit_telemetry[
                "model_state_bytes_per_device"],
            "peak_gb": float(peak), "label": plan.chosen["label"],
            "config": plan.chosen["config"], "tie_break": plan.tie_break,
            "plan_seconds": plan_s,
            "planned_state": plan.chosen["state_bytes_per_device"],
            "host_bytes": host, "accum_bytes": accum_bytes,
            "hbm_cap_bytes": plan.hbm_cap_bytes, "measured": plan.measured,
            "estimates": {r["label"]: r["est_step_seconds"]
                          for r in plan.candidates},
            "pruned": len(plan.pruned)}
        del model
        torch.cuda.empty_cache()
    dtt.launch.report_result({"rank": spec.index, "world": n,
                              "device": str(device), "rows": rows,
                              "parity": {}})
    dtt.cluster.shutdown()


def dropout_lm(dtt, rate):
    """Phase l's LM (bf16 layers) with ``Dropout(rate)`` after each
    block, under ``transformer_lm``'s tree paths."""
    import chip_smoke

    nn, lm = dtt.nn, chip_smoke.LM
    d = lm["d_model"]
    layers = [nn.Embedding(chip_smoke.VOCAB, d, dtype="bfloat16"),
              nn.PositionalEmbedding(lm["max_len"])]
    for _ in range(lm["num_layers"]):
        layers += dtt.models.transformer.transformer_block(
            d, lm["num_heads"], 4 * d, dtype="bfloat16")
        layers.append(nn.Dropout(rate))
    layers += [nn.LayerNorm(), nn.Dense(chip_smoke.VOCAB, dtype="bfloat16")]
    return nn.Sequential(layers, name="transformer_lm")


def pipe_moe_lm(dtt):
    """Phase l's LM (bf16 layers) with its 12 blocks in one
    ``nn.PipelinedBlocks`` and one MoE block (8 experts, hidden 3,072)
    after the stack, for ``ep2pp2``."""
    import chip_smoke

    nn, lm = dtt.nn, chip_smoke.LM
    d = lm["d_model"]
    return nn.Sequential([
        nn.Embedding(chip_smoke.VOCAB, d, dtype="bfloat16"),
        nn.PositionalEmbedding(lm["max_len"]),
        nn.PipelinedBlocks(lambda: nn.Sequential(
            dtt.models.transformer.transformer_block(
                d, lm["num_heads"], 4 * d, dtype="bfloat16")),
            lm["num_layers"]),
        *dtt.models.transformer.transformer_block(
            d, lm["num_heads"], 4 * d, moe_experts=8, dtype="bfloat16"),
        nn.LayerNorm(), nn.Dense(chip_smoke.VOCAB, dtype="bfloat16")],
        name="transformer_lm")


def shard_auto_run(dtt, strategy, n, rows):
    """The ``--shard-auto`` run of one worker (module docstring): adds
    ``rows["lm_shard_auto"]``; raises when the pipeline's losses differ
    from the host arrays'."""
    import numpy as np
    import torch

    import chip_smoke

    per_card, warmup, steps = LM_RUN
    batch, t_len = per_card * n, chip_smoke.LM["max_len"]
    rng = np.random.default_rng(11)
    x8 = rng.integers(0, 256, (batch * (warmup + steps), t_len),
                      dtype=np.uint8)
    y = rng.integers(0, chip_smoke.VOCAB, (len(x8),), dtype=np.int32)
    pallas = dtt.ops.losses.get(chip_smoke.PALLAS)

    def loss(logits, labels):
        return pallas(logits, labels[:, None].expand(logits.shape[:2]))

    pipe = dtt.data.Pipeline(x8, y, batch, shard="auto", shuffle=False,
                             scale=1.0, use_native=False)
    out = {}
    for src in ("pipeline", "host"):
        with strategy.scope():
            model = dtt.Model(dtt.models.transformer_lm(
                chip_smoke.VOCAB, dtype="bfloat16", **chip_smoke.LM))
            model.compile(optimizer=dtt.optim.fused_adamw(
                3e-4, weight_decay=0.01), loss=loss, metrics=[])
        model.build((t_len,), seed=0)
        if src == "pipeline":
            def fit(epochs, k):
                return model.fit(pipe, epochs=epochs, steps_per_epoch=k,
                                 verbose=0).history["loss"]
        else:
            def fit(epochs, k):
                return model.fit(x8.astype(np.int32), y, batch_size=batch,
                                 epochs=epochs, steps_per_epoch=k,
                                 shuffle=False, verbose=0).history["loss"]
        losses = fit(1, warmup)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t = time.perf_counter()
        losses += fit(steps, 1)
        torch.cuda.synchronize()
        out[src] = (losses, steps / (time.perf_counter() - t),
                    model.last_fit_telemetry["model_state_bytes_per_device"])
        del model
        torch.cuda.empty_cache()
    shard = list(pipe.shard or (0, 1))
    pipe.close()
    (got, sps, state), (want, host_sps, _) = out.values()
    if got != want:
        raise SystemExit(f"--shard-auto: the pipeline's losses {got} differ "
                         f"from the host arrays' {want}")
    rows["lm_shard_auto"] = {
        "steps_per_s": sps, "unit": "tokens", "per_s": sps * batch * t_len,
        "loss": got, "allreduce_ms": float("nan"),
        "model_state_bytes_per_device": state, "shard": shard,
        "host_per_s": host_sps * batch * t_len}


def predict_worker():
    """One rank of the ``--predict`` group (module docstring)."""
    import numpy as np
    import torch

    import distributed_tpu_torch as dtt

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    spec = dtt.cluster.initialize(timeout=300)
    n_img, batch = PREDICT
    world = torch.distributed.get_world_size()
    with dtt.DataParallel().scope():
        model = dtt.Model(dtt.models.resnet(50, 1000, dtype="bfloat16"))
    model.build((224, 224, 3), seed=0)
    x8 = np.random.default_rng(9).integers(0, 256, (n_img, 224, 224, 3),
                                           dtype=np.uint8)
    y = np.zeros((n_img,), np.int32)
    kw = dict(shuffle=False, use_native=False)
    steps = n_img // batch
    times = {}

    def reads(pipe):
        t = time.perf_counter()
        got = [next(pipe)[0] for _ in range(steps)]
        return np.concatenate(got), time.perf_counter() - t

    with dtt.data.Pipeline(x8, y, batch, **kw) as pipe:
        host, times["host_reads_s"] = reads(pipe)
    with dtt.data.Pipeline(x8, y, batch, shard="auto", **kw) as pipe:
        _, times["shard_reads_s"] = reads(pipe)
    # Untimed: the first forwards at each shape, the first all_gather on
    # the group (its communicator is set up lazily) and the first reads.
    model.predict(host[:batch // world], batch_size=batch // world)
    with dtt.data.Pipeline(x8, y, batch, shard="auto", **kw) as pipe:
        model.predict(pipe)
    with dtt.data.Pipeline(x8, y, batch, shard="auto", **kw) as pipe:
        shard = list(pipe.shard or (0, 1))
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = model.predict(pipe)
        torch.cuda.synchronize()
        times["sharded_s"] = time.perf_counter() - t
    t = time.perf_counter()
    want = model.predict(host, batch_size=batch // world)
    torch.cuda.synchronize()
    times["host_s"] = time.perf_counter() - t
    dtt.launch.report_result({
        "rank": spec.index, "shard": shard, "shape": list(got.shape),
        "equal": bool(np.array_equal(got, want)),
        "finite": bool(np.isfinite(got).all()), **times})
    dtt.cluster.shutdown()


def run_predict(dtt, env, n, timeout):
    """The ``--predict`` group on ``n`` cards; True when it failed."""
    results = dtt.launch.LocalLauncher(env_extra=env).run(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--predict"], n, timeout=timeout)
    failed = False
    for r in results:
        if not r.ok:
            print(f"predict N={n} worker {r.index} FAILED ({r.error})\n"
                  f"{r.log_tail}")
            failed = True
            continue
        v = r.value
        print(f"predict N={n} rank {v['rank']}: shard {v['shard']}, logits "
              f"{v['shape']}, equal to the host array's bit for bit "
              f"{v['equal']}, finite {v['finite']}; sharded "
              f"{v['sharded_s']:.3f} s ({PREDICT[0] / v['sharded_s']:.1f} "
              f"images/s, its shard's reads included; the reads alone "
              f"{v['shard_reads_s']:.3f} s), host array "
              f"{v['host_s']:.3f} s ({PREDICT[0] / v['host_s']:.1f} "
              f"images/s, read before: {v['host_reads_s']:.3f} s)")
        failed |= not (v["equal"] and v["finite"]
                       and v["shape"] == [PREDICT[0], 1000]
                       and v["shard"] == ([v["rank"], n] if n > 1
                                          else [0, 1]))
    return failed


def worker(strategy_name="dp", lm_only=True, dropout=None,
           shard_auto=False):
    import numpy as np
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.parallel.collectives import layout_of
    from distributed_tpu_torch.utils import sync_check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = dtt.cluster.initialize(timeout=300)
    cls = STRATEGIES[strategy_name][0]
    kw = strategy_kw(strategy_name, dropout)
    if torch.distributed.get_world_size() < split_of(strategy_name, dropout):
        kw = dict(kw, **ONE_CARD[strategy_name])
    strategy = getattr(dtt, cls)(**kw)
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
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        hist = model.fit(x, y, batch_size=batch, epochs=epochs,
                         steps_per_epoch=steps, shuffle=False, verbose=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        sync_check.assert_model_replicas_identical(model)
        if strategy_name not in ("dp", "zero1", "fsdp"):
            sync_check.assert_replicas_identical({
                k: v for k, v in model.live_params().items()
                if layout_of(v) is None}, "replicated leaves")
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                            device=strategy.device)
        torch.distributed.all_reduce(peak, op=torch.distributed.ReduceOp.MAX)
        sps = epochs * steps / wall
        tel = model.last_fit_telemetry
        rows[name] = {"steps_per_s": sps, "unit": unit,
                      "per_s": sps * batch * per_row,
                      "loss": hist.history["loss"],
                      "allreduce_ms": allreduce_ms(model.num_params),
                      "model_state_bytes_per_device": tel[
                          "model_state_bytes_per_device"],
                      "peak_gb": float(peak)}
        if "pipeline" in tel:
            rows[name]["bubble_fraction"] = tel["pipeline"]["bubble_fraction"]
        if "moe_experts" in LM_KW.get(strategy_name, {}):
            # Over the global batch: every rank's (kept, routed) choices
            # (an expert line's ranks hold the same rows, which scales
            # both sums alike).
            routed = torch.stack([m.routed for m in model.module.modules()
                                  if isinstance(m, dtt.nn.MoE)]).sum(0)
            torch.distributed.all_reduce(routed)
            rows[name]["dropped_share"] = float(1 - routed[0] / routed[1])

    def setup(name, batch, seed=0):
        """(model, x, y) of one configuration at a global batch."""
        if name == "lm":
            x, y = chip_smoke.lm_batch(batch, chip_smoke.LM["max_len"])
            module = (dropout_lm(dtt, dropout) if dropout else
                      pipe_moe_lm(dtt) if strategy_name == "ep2pp2" else
                      dtt.models.transformer_lm(
                          chip_smoke.VOCAB, dtype="bfloat16", **chip_smoke.LM,
                          **LM_KW.get(strategy_name, {})))
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
        if lm_only:
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
        if lm_only and name != "lm":
            continue
        model, x, y = setup(name, batch, seed=1)
        parity[name] = model.fit(x, y, batch_size=batch, epochs=3,
                                 steps_per_epoch=1, shuffle=False,
                                 verbose=0).history["loss"]
        sync_check.assert_model_replicas_identical(model)
        del model
    if shard_auto and strategy_name != "dp":
        shard_auto_run(dtt, strategy, n, rows)
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
    ap.add_argument("--dropout", type=float, default=None,
                    help="Dropout(RATE) after each of the LM's blocks")
    ap.add_argument("--predict", action="store_true",
                    help="the sharded-source predict group at the last N")
    ap.add_argument("--shard-auto", action="store_true",
                    help="a Pipeline(shard='auto') run of the LM under each "
                    "strategy but dp")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--seq-len", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dropout is not None and args.dropout <= 0:
        args.dropout = None
    if args.worker:
        if args.predict:
            predict_worker()
        elif args.seq_len:
            sp_worker(args.strategy[0], args.seq_len)
        elif args.strategy[0] == "auto":
            auto_worker()
        else:
            # The first strategy listed is the worker's; dp trains every
            # model only when nothing else is listed.
            worker(args.strategy[0], args.strategy != ["dp"], args.dropout,
                   args.shard_auto)
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
    sp = [strat for strat in args.strategy
          if strat in SP and args.dropout is None]
    for strat in args.strategy:
        if strat in sp:
            continue
        out[strat] = run_strategy(dtt, env, args, strat)
        if strat == "auto":
            failed |= out[strat] is None or report_auto(out)
            continue
        if out[strat] is None:
            failed = True
            continue
        base = (out[strat] if strat in ONE_CARD else
                out.get("dp") or out[strat])
        for n, res in out[strat].items():
            # The same N's dp row; a one-card form's own N=1 row.
            dp = base.get(min(base) if strat in ONE_CARD else n)
            cards = n if strat in ONE_CARD else 1
            for name, row in res["rows"].items():
                total = row["per_s"]
                state = row["model_state_bytes_per_device"]
                vs = ""
                if dp is not None and name in dp["rows"]:
                    dp_row = dp["rows"][name]
                    ratio = state / dp_row["model_state_bytes_per_device"]
                    of = "one card's" if strat in ONE_CARD else "dp's"
                    vs = (f" ({ratio:.4f} of {of}; per-card rate "
                          f"{total / cards / dp_row['per_s']:.4f} of {of})")
                extra = "".join(
                    f", {key} {row[key]:.6f}" for key in
                    ("peak_gb", "bubble_fraction", "dropped_share",
                     "host_per_s")
                    if key in row)
                print(f"{strat} N={n} {name:9s} {row['steps_per_s']:8.3f} "
                      f"steps/s, {total:12.1f} {row['unit']}/s "
                      f"({total / n:12.1f} per card), all-reduce of the "
                      f"gradients {row['allreduce_ms']:.3f} ms, model state "
                      f"{state / 1e9:.4f} GB a card{vs}{extra}, losses "
                      f"{[round(v, 5) for v in row['loss']]}")
            ref_n = min(base)
            first = base[ref_n]["parity"]
            for name, batch, rtol in PARITY:
                if name not in res["parity"]:
                    continue
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(res["parity"][name], first[name]))
                print(f"{strat} N={n} {name:9s} at global batch {batch}: "
                      f"losses {res['parity'][name]}, max relative "
                      f"difference from N={ref_n} {rel:.3e} "
                      f"(limit {rtol:g})")
                failed |= rel > rtol
    if sp:
        out["sp"] = run_sp(dtt, env, args.num_workers[-1], sp)
        failed |= out["sp"]["failed"]
    if args.predict:
        out["predict_failed"] = run_predict(dtt, env, args.num_workers[-1],
                                            args.timeout)
        failed |= out["predict_failed"]
    # Again at the end: a long run's head falls outside a tail of its
    # output.
    print(chip_smoke.card_line(), f"x {torch.cuda.device_count()}")
    print(json.dumps(out))
    return 1 if failed else 0


def report_auto(out):
    """Print the auto rows beside dp's LM row at the same N; True when a
    card's state is not the plan's or the ranks committed differently."""
    failed = False
    for n, res in out["auto"].items():
        dp = (out.get("dp") or {}).get(n)
        for name, row in res["rows"].items():
            want = (row["planned_state"] - sum(row["host_bytes"].values())
                    - row["accum_bytes"])
            held = row["model_state_bytes_per_device"]
            vs = ""
            if dp is not None and "lm" in dp["rows"]:
                vs = (f", {row['per_s'] / dp['rows']['lm']['per_s']:.4f} of "
                      f"dp's tokens/s a card")
            print(f"auto N={n} {name}: chose {row['label']} "
                  f"(tie_break {row['tie_break']}, planned in "
                  f"{row['plan_seconds']:.2f} s, cap {row['hbm_cap_bytes']}, "
                  f"{row['pruned']} pruned); {row['steps_per_s']:.3f} steps/s,"
                  f" {row['per_s'] / n:.1f} tokens/s a card{vs}; state a "
                  f"card {held} B held, {row['planned_state']} B planned "
                  f"(less {sum(row['host_bytes'].values())} B of host "
                  f"scalars {sorted(row['host_bytes'])} and "
                  f"{row['accum_bytes']} B of accumulator: {want} B); peak "
                  f"{row['peak_gb']:.2f} GB; losses "
                  f"{[round(v, 5) for v in row['loss']]}")
            if row["measured"]:
                for m in row["measured"]:
                    print(f"    measured {m['label']:36s} "
                          f"{m['seconds_per_step']} s a step, estimated "
                          f"{row['estimates'][m['label']]:.6f} s")
            failed |= held != want
        same = all(c == res["committed"][0] for c in res["committed"])
        print(f"auto N={n}: every rank committed the same candidates: {same}")
        failed |= not same
    return failed


def sp_launch(dtt, env, strat, n, t_len):
    """One long-context group: the rank-0 row, or None (the failure
    printed) when a worker failed or was killed after ``SP_TIMEOUT``."""
    t = time.perf_counter()
    results = dtt.launch.LocalLauncher(env_extra=env).run(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--strategy", strat, "--seq-len", str(t_len)], n,
        timeout=SP_TIMEOUT)
    bad = [r for r in results if not r.ok]
    if bad:
        tail = bad[0].log_tail.strip().splitlines()[-3:]
        print(f"{strat} N={n} T={t_len}: FAILED after "
              f"{time.perf_counter() - t:.0f} s ({bad[0].error}): "
              + " | ".join(tail))
        return None
    row = results[0].value
    print(f"{strat} N={n} T={t_len}: {row['ms']:.1f} ms a step, "
          f"{row['tokens_per_s']:.1f} tokens/s, peak {row['peak_gb']:.2f} GB "
          f"a card, losses {[round(v, 5) for v in row['losses']]}")
    return row


def run_sp(dtt, env, n, modes):
    """The long-context rows on ``n`` cards: the one-card reference at
    SP_FIRST, each mode there, then the longest T that fits (doubling
    above SP_FIRST, halving below it); then the shortest T where a mode
    first ran, with the reference and every other mode run there too
    where they have not. The losses are compared at every T where the
    reference ran; a mode missing at that shortest T fails the run."""
    refs = {SP_FIRST: sp_launch(dtt, env, "dp", 1, SP_FIRST)}
    rows, first = {}, {}
    for mode in modes:
        got = rows[mode] = {SP_FIRST: sp_launch(dtt, env, mode, n, SP_FIRST)}
        step = 2 if got[SP_FIRST] is not None else 0.5
        t_len = int(SP_FIRST * step)
        while 4096 <= t_len <= SP_MAX:
            got[t_len] = sp_launch(dtt, env, mode, n, t_len)
            if (got[t_len] is None) == (step == 2):
                break
            t_len = int(t_len * step)
        fits = [t for t, r in got.items() if r is not None]
        print(f"{mode} N={n}: the longest T that ran: "
              f"{max(fits) if fits else None} (tried {sorted(got)})")
        first[mode] = (SP_FIRST if got[SP_FIRST] is not None
                       else max(fits) if fits else None)
    failed = any(t is None for t in first.values())
    if not failed:
        t_cmp = min(first.values())
        if t_cmp not in refs:
            refs[t_cmp] = sp_launch(dtt, env, "dp", 1, t_cmp)
        for mode in modes:
            if t_cmp not in rows[mode]:
                rows[mode][t_cmp] = sp_launch(dtt, env, mode, n, t_cmp)
        for t in sorted(refs):
            at = dict({"one card": refs[t]},
                      **{m: rows[m].get(t) for m in modes})
            for mode in modes:
                for other, against in at.items():
                    if other == mode:
                        continue
                    if at[mode] is None or against is None:
                        failed |= t == t_cmp
                        continue
                    rel = max(abs(a - b) / abs(b) for a, b in
                              zip(at[mode]["losses"], against["losses"]))
                    print(f"{mode} at T={t}: losses within {rel:.3e} of "
                          f"{other}'s (limit 2e-3)")
                    failed |= rel > 2e-3
    out = {mode: {str(t): r for t, r in sorted(got.items())}
           for mode, got in rows.items()}
    out["reference"] = {str(t): r for t, r in sorted(refs.items())}
    out["failed"] = failed
    return out


def run_strategy(dtt, env, args, strat):
    """{N: {"devices", "rows", "parity"}} of one strategy at every worker
    count, or None when a worker failed (its log printed)."""
    res = {}
    drop = [] if args.dropout is None else ["--dropout", str(args.dropout)]
    if args.shard_auto:
        drop.append("--shard-auto")
    for n in args.num_workers:
        if n % split_of(strat, args.dropout) and not (
                n == 1 and strat in ONE_CARD):
            continue
        results = dtt.launch.LocalLauncher(env_extra=env).run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--strategy", strat,
             *[other for other in args.strategy if other != strat], *drop],
            n, timeout=args.timeout)
        bad = [r for r in results if not r.ok]
        for r in bad:
            print(f"{strat} N={n} worker {r.index} FAILED ({r.error})\n"
                  f"{r.log_tail}")
        if bad:
            return None
        res[n] = {"devices": [r.value["device"] for r in results],
                  "rows": results[0].value["rows"],
                  "parity": results[0].value["parity"],
                  "committed": [{name: row.get("config") for name, row in
                                 r.value["rows"].items()} for r in results]}
    return res


if __name__ == "__main__":
    sys.exit(main())
