"""Every keyword the JAX package's entry points take, passed to the port.

For each pair below the port's signature has every parameter of the JAX
signature, and each JAX keyword, set away from its default, either works
(the layers' forward passes then match the JAX layers' on the same
weights at rtol 1e-5, atol 1e-6, f32) or raises ``NotImplementedError``
("not yet ported", naming its ROADMAP item). None raises ``TypeError``.
"""

import inspect
import os
import re
import stat
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.launch import core as jax_launch
from distributed_tpu.parallel import mesh as jax_mesh
from distributed_tpu import rl as jrl
from distributed_tpu.training import callbacks as jcb

torch.set_num_threads(1)

UNPORTED = NotImplementedError


def _lm(pkg, **kw):
    return pkg.models.transformer_lm(32, num_layers=1, d_model=16,
                                     num_heads=2, max_len=8, **kw)


def _model(pkg, **kw):
    if pkg is dtt:
        kw["device"] = "cpu"
    return pkg.Model(_lm(pkg), **kw)


def _compiled(**kw):
    m = _model(dtt)
    m.compile(optimizer="sgd", **kw)
    return m.build((8,))


XY = (np.zeros((4, 8), np.int32), np.zeros((4, 8), np.int32))


def _in_world1_group(f, **kw):
    """``f(device_type="cpu", **kw)`` inside a world-1 gloo group."""
    dtt.DataParallel(device="cpu")
    try:
        return f(device_type="cpu", **kw)
    finally:
        dtt.cluster.shutdown()

def _world1_strategy(f, split, **kw):
    """``f(device="cpu", **kw)`` (a TP, SP, PP or EP strategy, its
    ``split`` axis of size 1) inside a world-1 gloo group;
    ``mesh="world1_mesh"`` passes a data x ``split`` mesh of that
    group."""
    dtt.DataParallel(device="cpu")
    try:
        if kw.get("mesh") == "world1_mesh":
            kw["mesh"] = dtt.parallel.make_mesh({"data": 1, split: 1},
                                                device_type="cpu")
        size = {"model": "model_parallel", "seq": "seq_parallel",
                "pipe": "pipeline_parallel",
                "expert": "expert_parallel"}[split]
        return f(device="cpu", **{size: 1, **kw})
    finally:
        dtt.cluster.shutdown()


def _schedule_pair(kw, prefix="pipeline_"):
    """The keywords an interleaved schedule option needs beside it (JAX
    raises for ``interleave`` without ``schedule="interleaved"`` and the
    other way round); ``pipeline=True`` for the LM's."""
    out = {}
    if f"{prefix}schedule" in kw:
        out[f"{prefix}interleave"] = 2
    if f"{prefix}interleave" in kw:
        out[f"{prefix}schedule"] = "interleaved"
    if out and prefix:
        out["pipeline"] = True
    return out


def _world1_composite(f, **kw):
    """``CompositeParallel`` inside a world-1 gloo group, over ``{"data":
    1}`` (or a mesh of those axes)."""
    dtt.DataParallel(device="cpu")
    try:
        if kw.get("mesh") == "world1_mesh":
            kw["mesh"] = dtt.parallel.make_mesh({"data": 1, "pipe": 1},
                                                device_type="cpu")
        elif "axes" not in kw:
            kw["axes"] = {"data": 1}
        return f(device="cpu", **kw)
    finally:
        dtt.cluster.shutdown()


def _world1_data(f, **kw):
    """A data-parallel strategy inside a world-1 gloo group;
    ``mesh="world1_data"``/``"world1_fsdp"`` pass a one-axis mesh of that
    group (its axis given as ``axis``)."""
    dtt.DataParallel(device="cpu")
    try:
        if isinstance(kw.get("mesh"), str):
            axis = "fsdp" if kw["mesh"] == "world1_fsdp" else "data"
            kw["mesh"] = dtt.parallel.make_mesh({axis: 1}, device_type="cpu")
            kw["axis"] = axis
        elif "axis" in kw:
            pass
        return f(device="cpu", **kw)
    finally:
        dtt.cluster.shutdown()


def _compile(**kw):
    """``Model.compile(**kw)``; a keyword of the planner compiles with
    ``strategy="auto"`` and builds, so that the planner runs."""
    m = _model(dtt)
    auto = {"hbm_cap_bytes", "measure", "auto_options"} & set(kw)
    if auto or kw.get("strategy") == "auto":
        kw = {"strategy": "auto", "auto_options": {"batch_size": 4}, **kw}
    m.compile(**kw)
    if kw.get("strategy") == "auto":
        m.build((8,))
    return m


PASS = [sys.executable, "-c", "pass"]


def _fake_ssh():
    """An ssh stand-in in a fresh directory: drops the host argument and
    runs the command locally."""
    path = os.path.join(tempfile.mkdtemp(prefix="fake_ssh_"), "ssh")
    with open(path, "w") as f:
        f.write('#!/bin/sh\nshift\nexec bash -c "$1"\n')
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path


def _initialize(f, **kw):
    """``cluster.initialize(**kw)`` on the CPU, then left (a spec forms a
    world-1 gloo group)."""
    if kw.get("spec") == "world1":
        kw["spec"] = dtt.cluster.ClusterSpec(
            workers=[f"127.0.0.1:{dtt.cluster.free_port()}"], index=0)
    try:
        return f(device="cpu", **kw)
    finally:
        dtt.cluster.shutdown()


# (JAX callable, port callable, {keyword: (value to pass, ROADMAP item
# when it raises, or None when it works)}, call(port callable, **kw)).
PAIRS = {
    "transformer_lm": (
        dtpu.models.transformer_lm, dtt.models.transformer_lm, {
            "causal": (False, None), "moe_experts": (2, None),
            "moe_every": (3, None), "pipeline": (True, None),
            "pipeline_schedule": ("interleaved", None),
            "pipeline_interleave": (2, None), "scan": (True, None),
            "scan_overlap": ("off", None), "remat": (True, None),
            "remat_policy": ("dots_with_no_batch_dims_saveable", None),
            "flash": (True, None),
            "dtype": ("bfloat16", None), "d_ff": (24, None),
            "max_len": (16, None), "num_layers": (1, None),
            "d_model": (16, None), "num_heads": (2, None)},
        lambda f, **kw: f(32, **{"num_layers": 1, "d_model": 16,
                                 "num_heads": 2, **_schedule_pair(kw),
                                 **kw})),
    "transformer_block": (
        dtpu.models.transformer_block, dtt.models.transformer_block, {
            "causal": (False, None), "moe_experts": (2, None),
            "flash": (False, None), "dtype": ("bfloat16", None)},
        lambda f, **kw: f(16, 2, 32, **kw)),
    "Dense": (dtpu.nn.Dense, dtt.nn.Dense, {
        "activation": ("relu", None), "use_bias": (False, None),
        "kernel_initializer": ("he_normal", None),
        "dtype": ("bfloat16", None), "shard": ("col", None),
        "name": ("head", None)}, lambda f, **kw: f(4, **kw)),
    "MultiHeadAttention": (dtpu.nn.MultiHeadAttention,
                           dtt.nn.MultiHeadAttention, {
        "head_dim": (8, None), "causal": (True, None),
        "use_bias": (False, None), "dtype": ("bfloat16", None),
        "ring_axis": (None, None), "flash": (True, None),
        "name": ("attn", None)}, lambda f, **kw: f(2, **kw)),
    "LayerNorm": (dtpu.nn.LayerNorm, dtt.nn.LayerNorm, {
        "epsilon": (1e-3, None), "name": ("ln", None)},
        lambda f, **kw: f(**kw)),
    "Model": (dtpu.Model, dtt.Model, {"name": ("lm", None)},
              lambda f, **kw: _model(dtt, **kw)),
    "Model.compile": (dtpu.Model.compile, dtt.Model.compile, {
        "grad_clip": (1.0, None), "gradient_accumulation_steps": (2, None),
        "head_chunks": (2, None), "steps_per_execution": (2, None),
        "precision": ("mixed_bfloat16", None), "strategy": ("auto", None),
        "hbm_cap_bytes": (1 << 30, None), "measure": (True, None),
        "auto_options": ({"batch_size": 4, "grad_accums": (1,)}, None),
        "loss": ("pallas_sparse_categorical_crossentropy", None),
        "metrics": ((), None), "optimizer": ("adam", None)},
        lambda f, **kw: _compile(**kw)),
    "plan_sharding": (dtpu.parallel.plan_sharding,
                      dtt.parallel.plan_sharding, {
        "tx": (dtt.optim.SGD(0.1), None), "optimizer": ("sgd", None),
        "batch_size": (4, None), "devices": ([0], None),
        "hbm_cap_bytes": (1 << 30, None), "precisions": ((None,), None),
        "grad_accums": ((1,), None), "steps_per_execution": ((1,), None),
        "include_tp": (False, None), "include_pp": (False, None),
        "measure": (True, None), "measure_fn": (lambda c, ctx: 0.5, None),
        "top_k": (2, None), "seed": (1, None)},
        lambda f, **kw: f(_lm(dtt), (8,), device="cpu", **kw)),
    "LocalLauncher.run": (jax_launch.LocalLauncher.run,
                          dtt.launch.LocalLauncher.run, {
        "timeout": (30.0, None), "grace": (1.0, None),
        "workdir": (os.getcwd(), None), "base_port": ("free", None),
        "liveness_timeout": (30.0, None)},
        lambda f, **kw: dtt.launch.LocalLauncher().run(PASS, 1, **{
            **kw, **({"base_port": dtt.cluster.free_port()}
                     if "base_port" in kw else {})})),
    "SSHLauncher": (jax_launch.SSHLauncher, dtt.launch.SSHLauncher, {
        "ssh_cmd": ("ssh", None), "port": (8476, None)},
        lambda f, **kw: f(["127.0.0.1"], **kw)),
    "SSHLauncher.run": (jax_launch.SSHLauncher.run,
                        dtt.launch.SSHLauncher.run, {
        "timeout": (30.0, None), "grace": (1.0, None),
        "env_extra": ({"X": "1"}, None), "liveness_timeout": (30.0, None)},
        lambda f, **kw: dtt.launch.SSHLauncher(
            ["127.0.0.1"], ssh_cmd=_fake_ssh()).run(PASS, **kw)),
    "run_with_restart": (jax_launch.run_with_restart,
                         dtt.launch.run_with_restart, {
        "max_restarts": (1, None), "restart_backoff": (0.0, None)},
        lambda f, **kw: f(dtt.launch.LocalLauncher(), PASS, 1, **kw)),
    "initialize": (dtpu.cluster.initialize, dtt.cluster.initialize, {
        "spec": ("world1", None), "coordinator": ("127.0.0.1:1", None),
        "num_processes": (1, None), "process_id": (0, None)},
        lambda f, **kw: _initialize(f, **kw)),
    "Model.fit": (dtpu.Model.fit, dtt.Model.fit, {
        "batch_size": (2, None), "epochs": (1, None),
        "steps_per_epoch": (1, None), "validation_data": (XY, None),
        "validation_steps": (1, None), "shuffle": (False, None),
        "verbose": (0, None), "initial_epoch": (0, None), "seed": (3, None),
        "callbacks": ((), None), "prefetch": (0, None),
        "grad_accum": (2, None)},
        lambda f, **kw: _compiled().fit(*XY, **{"verbose": 0,
                                                 "batch_size": 2, **kw})),
    "Model.evaluate": (dtpu.Model.evaluate, dtt.Model.evaluate, {
        "batch_size": (2, None), "verbose": (0, None), "steps": (1, None)},
        lambda f, **kw: _compiled().evaluate(*XY, **{"verbose": 0, **kw})),
    "Model.predict": (dtpu.Model.predict, dtt.Model.predict, {
        "batch_size": (2, None), "steps": (1, None)},
        lambda f, **kw: _compiled().predict(XY[0], **kw)),
    "Model.generate": (dtpu.Model.generate, dtt.Model.generate, {
        "temperature": (0.5, None), "top_k": (3, None), "seed": (4, None)},
        lambda f, **kw: _compiled().generate(XY[0][:1, :2], 2, **kw)),
    "resnet": (dtpu.models.resnet, dtt.models.resnet, {
        "depth": (18, None), "num_classes": (10, None), "small_inputs": (True, None),
        "stage_blocks": ((1, 2, 1, 1), None), "width": (16, None),
        "stem": ("space_to_depth", None), "scan_stages": (True, None),
        "bn_shift": ("data", None), "dtype": ("bfloat16", None)},
        lambda f, **kw: f(**{"depth": 50, **kw})),
    "vit": (dtpu.models.vit, dtt.models.vit, {
        "num_classes": (10, None), "image_size": (32, None),
        "patch_size": (8, None), "num_layers": (2, None),
        "d_model": (32, None), "num_heads": (2, None), "d_ff": (16, None),
        "remat": (True, None), "scan": (True, None),
        "dtype": ("bfloat16", None)}, lambda f, **kw: f(**kw)),
    "ScannedBlocks": (dtpu.nn.ScannedBlocks, dtt.nn.ScannedBlocks, {
        "overlap": ("off", None), "name": ("stack", None)},
        lambda f, **kw: f(lambda: dtt.nn.Sequential([dtt.nn.Dense(4)]), 2,
                          **kw)),
    "ModelCheckpoint": (jcb.ModelCheckpoint, dtt.callbacks.ModelCheckpoint, {
        "save_freq": (2, None), "keep": (2, None), "restore": (True, None),
        "sharded": (True, None), "async_save": (True, None),
        "buddy": (True, None), "buddy_refresh_every": (2, None)},
        lambda f, **kw: f("ckpt_dir", **({"sharded": True} if "buddy" in kw
                                         else {}), **kw)),
    "ShardedCheckpointer": (dtpu.ShardedCheckpointer,
                            dtt.ShardedCheckpointer, {
        "keep": (2, None), "async_save": (True, None)},
        lambda f, **kw: f("ckpt_dir", **kw)),
    "make_mesh": (jax_mesh.make_mesh, dtt.parallel.make_mesh, {
        "axis_sizes": ({"fsdp": 1}, None), "devices": ([0], None),
        "dcn_axis": ("data", None), "slice_ids": ([0], None)},
        lambda f, **kw: _in_world1_group(f, **kw)),
    "DataTensorParallel": (dtpu.DataTensorParallel, dtt.DataTensorParallel, {
        "devices": ([0], None), "mesh": ("world1_mesh", None),
        "model_parallel": (1, None), "axis": ("fsdp", None),
        "model_axis": ("seq", None)},
        lambda f, **kw: _world1_strategy(f, "model", **kw)),
    "DataSeqParallel": (dtpu.DataSeqParallel, dtt.DataSeqParallel, {
        "devices": ([0], None), "mesh": ("world1_mesh", None),
        "seq_parallel": (1, None), "axis": ("fsdp", None),
        "seq_axis": ("model", None), "attention": ("ulysses", None)},
        lambda f, **kw: _world1_strategy(f, "seq", **kw)),
    "DataPipelineParallel": (dtpu.DataPipelineParallel,
                             dtt.DataPipelineParallel, {
        "devices": ([0], None), "mesh": ("world1_mesh", None),
        "pipeline_parallel": (1, None), "num_microbatches": (2, None),
        "axis": ("fsdp", None), "pipe_axis": ("seq", None)},
        lambda f, **kw: _world1_strategy(f, "pipe", **kw)),
    "DataExpertParallel": (dtpu.DataExpertParallel, dtt.DataExpertParallel, {
        "devices": ([0], None), "mesh": ("world1_mesh", None),
        "expert_parallel": (1, None), "axis": ("fsdp", None),
        "expert_axis": ("seq", None)},
        lambda f, **kw: _world1_strategy(f, "expert", **kw)),
    "CompositeParallel": (dtpu.CompositeParallel, dtt.CompositeParallel, {
        "axes": ({"data": 1}, None), "devices": ([0], None),
        "mesh": ("world1_mesh", None), "num_microbatches": (2, None),
        "seq_attention": ("ulysses", None)},
        lambda f, **kw: _world1_composite(f, **kw)),
    "DataParallel": (dtpu.DataParallel, dtt.DataParallel, {
        "devices": ([0], None), "mesh": ("world1_data", None),
        "axis": ("fsdp", None)},
        lambda f, **kw: _world1_data(f, **kw)),
    "ZeroDataParallel": (dtpu.ZeroDataParallel, dtt.ZeroDataParallel, {
        "devices": ([0], None), "mesh": ("world1_data", None),
        "axis": ("fsdp", None)},
        lambda f, **kw: _world1_data(f, **kw)),
    "FullyShardedDataParallel": (dtpu.FullyShardedDataParallel,
                                 dtt.FullyShardedDataParallel, {
        "devices": ([0], None), "mesh": ("world1_fsdp", None),
        "axis": ("data", None)},
        lambda f, **kw: _world1_data(f, **kw)),
    "FSDP": (dtpu.FSDP, dtt.FSDP, {
        "devices": ([0], None), "mesh": ("world1_data", None),
        "axis": ("fsdp", None)},
        lambda f, **kw: _world1_data(f, **kw)),
    "MultiWorkerMirroredStrategy": (
        dtpu.MultiWorkerMirroredStrategy, dtt.MultiWorkerMirroredStrategy, {
            "devices": ([0], None), "mesh": ("world1_data", None),
            "axis": ("fsdp", None)},
        lambda f, **kw: _world1_data(f, **kw)),
    "MoE": (dtpu.nn.MoE, dtt.nn.MoE, {
        "top_k": (1, None), "capacity_factor": (2.0, None),
        "group_size": (8, None), "activation": ("relu", None),
        "aux_loss_weight": (0.1, None), "dtype": ("bfloat16", None),
        "name": ("experts", None)}, lambda f, **kw: f(4, 8, **kw)),
    "PipelinedBlocks": (dtpu.nn.PipelinedBlocks, dtt.nn.PipelinedBlocks, {
        "schedule": ("interleaved", None), "interleave": (2, None),
        "name": ("stack", None)},
        lambda f, **kw: f(lambda: dtt.nn.Sequential([dtt.nn.Dense(4)]), 4,
                          **{**_schedule_pair(kw, ""), **kw})),
    "Dropout": (dtpu.nn.Dropout, dtt.nn.Dropout, {"name": ("drop", None)},
                lambda f, **kw: f(0.1, **kw)),
    "Lambda": (dtpu.nn.Lambda, dtt.nn.Lambda, {
        "output_shape": ((4,), None), "name": ("lam", None)},
        lambda f, **kw: f(lambda x: x, **kw)),
    "RMSprop": (dtpu.optim.RMSprop, dtt.optim.RMSprop, {
        "learning_rate": (0.01, None), "decay": (0.8, None),
        "momentum": (0.9, None), "eps": (1e-6, None)},
        lambda f, **kw: f(**kw)),
    "Adagrad": (dtpu.optim.Adagrad, dtt.optim.Adagrad, {
        "learning_rate": (0.01, None), "eps": (1e-6, None)},
        lambda f, **kw: f(**kw)),
    "Lamb": (dtpu.optim.Lamb, dtt.optim.Lamb, {
        "learning_rate": (0.01, None), "weight_decay": (0.1, None),
        "b1": (0.8, None), "b2": (0.99, None)}, lambda f, **kw: f(**kw)),
    "cosine_schedule": (dtpu.optim.cosine_schedule,
                        dtt.optim.cosine_schedule, {"warmup": (2, None)},
                        lambda f, **kw: f(0.1, 10, **kw)(3)),
    "exponential_schedule": (dtpu.optim.exponential_schedule,
                             dtt.optim.exponential_schedule,
                             {"warmup": (2, None)},
                             lambda f, **kw: f(0.1, 0.5, 2, **kw)(3)),
    "sgd_with_cosine": (dtpu.optim.sgd_with_cosine,
                        dtt.optim.sgd_with_cosine, {
                            "warmup": (2, None), "momentum": (0.5, None)},
                        lambda f, **kw: f(0.1, 10, **kw)),
}


from distributed_tpu import resilience as jres  # noqa: E402
from distributed_tpu.checkpoint import sharded as jsharded  # noqa: E402
from distributed_tpu.obs import aggregate as jagg  # noqa: E402
from distributed_tpu.obs import cli as jcli  # noqa: E402
from distributed_tpu.obs import export as jexport  # noqa: E402
from distributed_tpu.obs import flight as jflight  # noqa: E402
from distributed_tpu.utils import profiler as jprofiler  # noqa: E402
from distributed_tpu_torch import resilience as pres  # noqa: E402
from distributed_tpu_torch.obs import aggregate as pagg  # noqa: E402
from distributed_tpu_torch.obs import cli as pcli  # noqa: E402
from distributed_tpu_torch.obs import export as pexport  # noqa: E402
from distributed_tpu_torch.obs import flight as pflight  # noqa: E402
from distributed_tpu_torch.utils import profiler as pprofiler  # noqa: E402


def _tmp():
    return tempfile.mkdtemp(prefix="sig_")


def _buddy_cycle(method, **kw):
    """A world-1 mirror of a small compiled model, then ``method``."""
    buddy = pres.BuddyRedundancy(_tmp(), rank=0, world=1)
    m = _compiled()
    if method == "refresh":
        buddy.refresh(m, **kw)
        buddy.wait()
        return buddy.available_step()
    buddy.refresh(m, step=2)
    buddy.wait()
    return buddy.restore_into(m, **kw)


_EVENTS = [{"event": "metrics_snapshot", "ts": 1.0, "rank": r,
            "step_seconds": [s]} for r, s in ((0, 0.1), (1, 0.3))]

# The resilience and obs entry points (every keyword of the JAX callable
# that has a default, probed).
PAIRS.update({
    "RestartPolicy": (jres.RestartPolicy, pres.RestartPolicy, {
        "max_restarts": (2, None), "backoff": (0.5, None),
        "backoff_factor": (3.0, None), "backoff_max": (9.0, None),
        "preemption_exempt": (False, None), "max_preemptions": (4, None)},
        lambda f, **kw: f(**kw).delay(2)),
    "ElasticPolicy": (jres.ElasticPolicy, pres.ElasticPolicy, {
        "min_workers": (2, None), "max_workers": (4, None),
        "failure_threshold": (3, None), "probe": (lambda: 2, None),
        "divisor_of": (8, None), "max_resizes": (4, None)},
        lambda f, **kw: f(**kw).snap(3, 4)),
    "FailureLedger": (jres.FailureLedger, pres.FailureLedger, {},
                      lambda f, **kw: f(**kw).record([1])),
    "Supervisor": (jres.Supervisor, pres.Supervisor, {
        "num_workers": (2, None), "launcher": (dtt.launch.LocalLauncher(),
                                               None),
        "policy": (pres.RestartPolicy(max_restarts=1), None),
        "elastic": (pres.ElasticPolicy(min_workers=1), None),
        "checkpoint_dir": ("tmp", None), "buddy_store_dir": ("tmp", None),
        "event_log": ("tmp", None), "env_extra": ({"X": "1"}, None),
        "liveness_timeout": (30.0, None), "straggler_threshold": (2.0, None),
        "sleep": (lambda s: None, None)},
        lambda f, **kw: f(PASS, **{
            k: (_tmp() if v == "tmp" and k != "event_log" else
                pres.EventLog(os.path.join(_tmp(), "ev.jsonl"))
                if k == "event_log" else v) for k, v in kw.items()}).run(
                    timeout=60)),
    "Supervisor.run": (jres.Supervisor.run, pres.Supervisor.run, {
        "timeout": (60.0, None), "grace": (1.0, None)},
        lambda f, **kw: pres.Supervisor(PASS).run(**kw)),
    "supervise": (jres.supervise, pres.supervise, {
        "num_workers": (2, None)},
        lambda f, **kw: f(PASS, timeout=60, **kw)),
    "SupervisedResult": (jres.SupervisedResult, pres.SupervisedResult, {
        "event_log": ("ev.jsonl", None), "resizes": (1, None),
        "world_size": (2, None)},
        lambda f, **kw: f(True, 1, 0, 0, [], **kw).failed),
    "PreemptionHandler": (jres.PreemptionHandler, pres.PreemptionHandler, {
        "signals": ((15, 10), None), "exit_code": (None, None),
        "keep": (2, None), "checkpointer": (dtt.Checkpointer("ckpt_dir"),
                                            None)},
        lambda f, **kw: f(_tmp(), **kw)),
    "FaultInjector": (jres.FaultInjector, pres.FaultInjector, {
        "at_step": (3, None), "rank": (None, None),
        "once_marker": ("m", None), "exit_code": (9, None),
        "hang_seconds": (1.0, None), "slow_seconds": (0.1, None),
        "directory": ("ckpt_dir", None), "replica": ("decode-1", None)},
        lambda f, **kw: f("kill", **kw)),
    "corrupt_latest_checkpoint": (jres.corrupt_latest_checkpoint,
                                  pres.corrupt_latest_checkpoint, {},
                                  lambda f, **kw: f(_tmp(), **kw)),
    "BuddyStore": (jres.BuddyStore, pres.BuddyStore, {"keep": (2, None)},
                   lambda f, **kw: f(_tmp(), **kw).available_step()),
    "BuddyStore.write_mirror": (jres.BuddyStore.write_mirror,
                                pres.BuddyStore.write_mirror, {},
                                lambda f, **kw: None),
    "BuddyRedundancy": (jres.BuddyRedundancy, pres.BuddyRedundancy, {
        "rank": (0, None), "world": (1, None), "async_refresh": (False,
                                                                 None)},
        lambda f, **kw: f(_tmp(), **kw).available_step()),
    "BuddyRedundancy.refresh": (jres.BuddyRedundancy.refresh,
                                pres.BuddyRedundancy.refresh, {
        "step": (5, None)}, lambda f, **kw: _buddy_cycle("refresh", **kw)),
    "BuddyRedundancy.restore_into": (jres.BuddyRedundancy.restore_into,
                                     pres.BuddyRedundancy.restore_into, {
        "step": (2, None)}, lambda f, **kw: _buddy_cycle("restore", **kw)),
    "select_restore_tier": (jres.select_restore_tier,
                            pres.select_restore_tier, {},
                            lambda f, **kw: f(None, None)),
    "mirror_holder": (jres.mirror_holder, pres.mirror_holder, {},
                      lambda f, **kw: f(1, 4)),
    "mirror_source": (jres.mirror_source, pres.mirror_source, {},
                      lambda f, **kw: f(1, 4)),
    "ram_dir": (jres.ram_dir, pres.ram_dir, {"prefix": ("sig-buddy-", None)},
                lambda f, **kw: os.rmdir(f(**kw))),
    "recovery_rows": (jres.recovery_rows, pres.recovery_rows, {},
                      lambda f, **kw: f([])),
    "write_resume_marker": (jres.write_resume_marker,
                            pres.write_resume_marker, {
        "reason": ("maintenance", None)},
        lambda f, **kw: f(_tmp(), 3, **kw)),
    "read_resume_marker": (jres.read_resume_marker, pres.read_resume_marker,
                           {}, lambda f, **kw: f(_tmp())),
    "clear_resume_marker": (jres.clear_resume_marker,
                            pres.clear_resume_marker, {},
                            lambda f, **kw: f(_tmp())),
    "restore_from_index": (jsharded.restore_from_index,
                           dtt.checkpoint.sharded.restore_from_index, {},
                           lambda f, **kw: None),
    "redundancy_report": (jprofiler.redundancy_report,
                          pprofiler.redundancy_report, {"world": (4, None)},
                          lambda f, **kw: f(100, 50, **kw)),
    "FlightRecorder": (jflight.FlightRecorder, pflight.FlightRecorder, {
        "capacity": (8, None)}, lambda f, **kw: f(**kw).record("step")),
    "FlightRecorder.dump": (jflight.FlightRecorder.dump,
                            pflight.FlightRecorder.dump, {
        "path": ("tmp", None), "reason": ("test", None),
        "extra": ({"step": 1}, None)},
        lambda f, **kw: pflight.FlightRecorder().dump(**{
            k: (os.path.join(_tmp(), "f.jsonl") if v == "tmp" else v)
            for k, v in kw.items()})),
    "flight.dump": (jflight.dump, pflight.dump, {"reason": ("test", None)},
                    lambda f, **kw: f(**kw)),
    "read_dump": (jflight.read_dump, pflight.read_dump, {},
                  lambda f, **kw: f(os.path.join(_tmp(), "none.jsonl"))),
    "default_dump_path": (jflight.default_dump_path,
                          pflight.default_dump_path, {},
                          lambda f, **kw: f()),
    "default_recorder": (jflight.default_recorder, pflight.default_recorder,
                         {}, lambda f, **kw: f()),
    "skew_report": (jagg.skew_report, pagg.skew_report, {},
                    lambda f, **kw: f(_EVENTS)),
    "straggler": (jagg.straggler, pagg.straggler, {"threshold": (2.0, None)},
                  lambda f, **kw: f(_EVENTS, **kw)),
    "rank_step_seconds": (jagg.rank_step_seconds, pagg.rank_step_seconds, {},
                          lambda f, **kw: f(_EVENTS)),
    "prometheus_text": (jexport.prometheus_text, pexport.prometheus_text, {
        "snapshot": ({"counters": {"a": 1}}, None),
        "registry": (dtt.obs.MetricsRegistry(), None)},
        lambda f, **kw: f(**kw)),
    "write_prometheus": (jexport.write_prometheus, pexport.write_prometheus,
                         {"registry": (dtt.obs.MetricsRegistry(), None)},
                         lambda f, **kw: f(os.path.join(_tmp(), "m.prom"),
                                           **kw)),
    "append_snapshot": (jexport.append_snapshot, pexport.append_snapshot, {
        "registry": (dtt.obs.MetricsRegistry(), None)},
        lambda f, **kw: f(os.path.join(_tmp(), "s.jsonl"), step=1, **kw)),
    "cli.summarize": (jcli.summarize, pcli.summarize, {
        "flight_paths": ((), None), "straggler_threshold": (2.0, None)},
        lambda f, **kw: f(_EVENTS, **kw)),
    "cli.render": (jcli.render, pcli.render, {"tail": (3, None)},
                   lambda f, **kw: f(pcli.summarize(_EVENTS), **kw)),
    "cli.follow": (jcli.follow, pcli.follow, {
        "poll_s": (0.01, None), "stop": (lambda: True, None)},
        lambda f, **kw: list(f(os.path.join(_tmp(), "none.jsonl"),
                               **{"stop": lambda: True, **kw}))),
    "cli.main": (jcli.main, pcli.main, {"argv": (["--help"], None)},
                 lambda f, **kw: _exits_zero(f, **kw)),
})


from distributed_tpu import fleet as jfl  # noqa: E402
from distributed_tpu import serve_service as jsvc  # noqa: E402
from distributed_tpu.fleet import handoff as jhandoff  # noqa: E402
from distributed_tpu_torch import fleet as pfl  # noqa: E402
from distributed_tpu_torch import serve_service as psvc  # noqa: E402
from distributed_tpu_torch.fleet import handoff as phandoff  # noqa: E402

_FLEET = dict(max_slots=2, block_size=4, max_len=8)


def _fleet(**kw):
    if kw.get("prefix_gossip"):
        kw.setdefault("prefix_cache", True)
    if kw.get("programs") == "programs":
        kw["programs"] = pfl.EnginePrograms(_compiled())
    return pfl.ServingFleet(_compiled(), **{**_FLEET, **kw})


def _seq(n=3):
    return dtt.serving.Sequence(dtt.serving.Request(np.arange(n) % 32, 2))


def _pool(prefix_cache=False):
    return dtt.serving.PagedKVCache(
        _compiled().module, max_slots=2, block_size=4, max_blocks_per_seq=2,
        num_blocks=5, dtype=torch.float32, device="cpu",
        prefix_cache=prefix_cache)


def _handoff(**kw):
    kv = _pool()
    kv.reserve(0, 5)
    return pfl.pack_kv(kv, 0, 5, **kw)


def _decode_replica(**kw):
    return pfl.DecodeReplica("decode-0", pfl.EnginePrograms(_compiled()),
                             **{**_FLEET, **kw})


_SPEC = dict(model=dict(vocab_size=32, num_layers=1, d_model=16,
                        num_heads=2, max_len=8), build_len=8, device="cpu")


def _service(**kw):
    return psvc.ServeService(psvc.ServeSpec(**_SPEC), spawn=False, **kw)


def _stopped(svc, fn):
    try:
        return fn(svc)
    finally:
        svc.stop()


PAIRS.update({
    "ServingFleet": (jfl.ServingFleet, pfl.ServingFleet, {
        "decode_replicas": (1, None), "prefill_replicas": (0, None),
        "max_slots": (1, None), "block_size": (2, None), "max_len": (8, None),
        "num_blocks": (9, None), "prefill_chunk": (2, None),
        "transfer": ("none", None), "prefix_cache": (True, None),
        "prefix_gossip": (True, None), "temperature": (0.5, None),
        "top_k": (4, None), "eos_id": (1, None), "seed": (3, None),
        "router": (pfl.Router(), None),
        "autoscaler": (pfl.QueueAutoscaler(), None),
        "fault": (pres.FaultInjector("replica_kill", replica="decode-9"),
                  None),
        "programs": ("programs", None)},
        lambda f, **kw: _fleet(**kw).run([(np.arange(3), 2)])),
    "ServingFleet.run": (jfl.ServingFleet.run, pfl.ServingFleet.run, {
        "arrival_times": ([0.0, 0.01], None),
        "tenants": (["a", "b"], None)},
        lambda f, **kw: _fleet().run([(np.arange(3), 2)] * 2, **kw)),
    "ServingFleet.update_weights": (
        jfl.ServingFleet.update_weights, pfl.ServingFleet.update_weights, {},
        lambda f, **kw: (lambda fl: fl.update_weights(
            fl.model.params))(_fleet())),
    "Router": (jfl.Router, pfl.Router, {
        "max_queue": (4, None), "slo_ttft_s": (1.0, None),
        "tenant_weights": ({"a": 2.0}, None), "service_window": (8, None)},
        lambda f, **kw: f(**kw).telemetry()),
    "Router.submit": (jfl.Router.submit, pfl.Router.submit, {
        "tenant": ("a", None), "now": (1.0, None)},
        lambda f, **kw: pfl.Router().submit(
            dtt.serving.Request(np.arange(3), 2), **kw)),
    "Router.place": (jfl.Router.place, pfl.Router.place, {
        "gossip_adoptable": (True, None)},
        lambda f, **kw: pfl.Router().place(_seq(), [_decode_replica()],
                                           **kw)),
    "QueueAutoscaler": (jfl.QueueAutoscaler, pfl.QueueAutoscaler, {
        "min_replicas": (2, None), "max_replicas": (3, None),
        "queue_high": (3.0, None), "queue_low": (0.5, None),
        "slo_ttft_s": (1.0, None), "cooldown_s": (0.1, None),
        "spinup_s": (0.2, None)},
        lambda f, **kw: f(**kw).probe()),
    "QueueAutoscaler.decide": (
        jfl.QueueAutoscaler.decide, pfl.QueueAutoscaler.decide, {
            "free_slots": (4, None), "slots_per_replica": (2, None),
            "recent_p99_ttft": (2.0, None)},
        lambda f, **kw: pfl.QueueAutoscaler().decide(
            0.0, queue_depth=3, replicas=1, **kw)),
    "EnginePrograms": (jfl.EnginePrograms, pfl.EnginePrograms, {
        "temperature": (0.5, None), "top_k": (4, None), "seed": (3, None),
        "decode_kernel": ("fused", None)},
        lambda f, **kw: f(_compiled(), **kw).token_key(_seq())),
    "PrefillReplica": (jfl.PrefillReplica, pfl.PrefillReplica, {
        "prefill_chunk": (2, None)},
        lambda f, **kw: f("prefill-0", pfl.EnginePrograms(_compiled()),
                          block_size=4, max_len=8, **kw).prefill(_seq())),
    "DecodeReplica": (jfl.DecodeReplica, pfl.DecodeReplica, {
        "num_blocks": (9, None), "prefill_chunk": (2, None),
        "eos_id": (1, None), "prefix_cache": (True, None)},
        lambda f, **kw: (lambda r: (r.submit(_seq(), 0.0), r.step(0.0)))(
            _decode_replica(**kw))),
    "DecodeReplica.submit": (jfl.DecodeReplica.submit,
                             pfl.DecodeReplica.submit, {
        "payload": ("handoff", None)},
        lambda f, **kw: _decode_replica().submit(
            _seq(6), 0.0, payload=_handoff())),
    "KVHandoff": (jfl.KVHandoff, pfl.KVHandoff, {
        "prefix_hashes": (("k",), None), "skip_blocks": (1, None),
        "weights_version": (2, None)},
        lambda f, **kw: f({}, 4, 4, "float32", **kw).nbytes),
    "pack_kv": (jfl.pack_kv, pfl.pack_kv, {"tokens": ([1, 2, 3, 4, 5], None)},
                lambda f, **kw: _handoff(**kw)),
    "install_kv": (jfl.install_kv, pfl.install_kv, {},
                   lambda f, **kw: (lambda kv: (kv.reserve(0, 5), f(
                       kv, 0, _handoff())))(_pool())),
    "trim_kv": (jhandoff.trim_kv, phandoff.trim_kv, {},
                lambda f, **kw: f(_handoff(tokens=[1] * 5), set())),
    "pack_prefix": (jfl.pack_prefix, pfl.pack_prefix, {
        "weights_version": (1, None)},
        lambda f, **kw: f(_pool(prefix_cache=True), ["k"], **kw)),
    "adopt_prefix": (jfl.adopt_prefix, pfl.adopt_prefix, {
        "weights_version": (1, None)},
        lambda f, **kw: f(_pool(prefix_cache=True), pfl.KVHandoff(
            {}, 4, 4, "float32"), **kw)),
    "PrefixGossipIndex.advertise": (
        jfl.PrefixGossipIndex.advertise, pfl.PrefixGossipIndex.advertise, {
            "weights_version": (1, None)},
        lambda f, **kw: pfl.PrefixGossipIndex().advertise("r", ["k"], **kw)),
    "PrefixGossipIndex.best_peer": (
        jfl.PrefixGossipIndex.best_peer, pfl.PrefixGossipIndex.best_peer, {
            "weights_version": (1, None), "exclude": (("r",), None)},
        lambda f, **kw: pfl.PrefixGossipIndex().best_peer(["k"], **kw)),
    "PrefixGossipIndex.holders": (
        jfl.PrefixGossipIndex.holders, pfl.PrefixGossipIndex.holders, {
            "weights_version": (1, None)},
        lambda f, **kw: pfl.PrefixGossipIndex().holders("k", **kw)),
    "ServeSpec": (jsvc.ServeSpec, psvc.ServeSpec, {
        "optimizer": ("adam", None), "loss": ("sparse_categorical_"
                                              "crossentropy", None),
        "temperature": (0.5, None), "top_k": (4, None), "seed": (3, None),
        "max_slots": (1, None), "block_size": (2, None), "max_len": (8, None),
        "num_blocks": (9, None), "prefill_chunk": (2, None),
        "eos_id": (1, None), "prefix_cache": (True, None)},
        lambda f, **kw: f(**_SPEC, **kw).engine()),
    "ServeSpec.worker_blob": (jsvc.ServeSpec.worker_blob,
                              psvc.ServeSpec.worker_blob, {
        "engine_overrides": ({"block_size": 8}, None)},
        lambda f, **kw: psvc.ServeSpec(**_SPEC).worker_blob(
            "decode-0", "decode", transport="none", shm_root=None, **kw)),
    "ServeService": (jsvc.ServeService, psvc.ServeService, {
        "decode_replicas": (2, None), "prefill_replicas": (1, None),
        "router": (pfl.Router(), None), "quotas": (psvc.TenantQuotas(), None),
        "autoscaler": (pfl.QueueAutoscaler(), None),
        "transport": ("inline", None), "spawn": (False, None),
        "respawn": (False, None), "dispatch_window": (2, None),
        "engine_overrides": ({"decode": {"block_size": 8}}, None),
        "log_dir": ("tmp", None)},
        lambda f, **kw: _stopped(f(psvc.ServeSpec(**_SPEC), **{
            "spawn": False, **{k: (_tmp() if v == "tmp" else v)
                               for k, v in kw.items()}}).start(wait=False),
            lambda svc: svc.run([]))),
    "ServeService.start": (jsvc.ServeService.start, psvc.ServeService.start, {
        "wait": (True, None), "timeout_s": (5.0, None)},
        lambda f, **kw: _stopped(_service().start(**kw), lambda svc: None)),
    "ServeService.submit": (jsvc.ServeService.submit,
                            psvc.ServeService.submit, {
        "tenant": ("a", None), "now": (1.0, None)},
        lambda f, **kw: _service().submit(
            dtt.serving.Request(np.arange(3), 2), **kw)),
    "ServeService.run": (jsvc.ServeService.run, psvc.ServeService.run, {
        "arrival_times": ([], None), "tenants": ([], None),
        "deadline_s": (5.0, None), "on_pump": (lambda s: None, None)},
        lambda f, **kw: _stopped(_service().start(wait=False),
                                 lambda svc: svc.run([], **kw))),
    "ServeService.wait_ready": (jsvc.ServeService.wait_ready,
                                psvc.ServeService.wait_ready, {
        "timeout_s": (5.0, None)},
        lambda f, **kw: _stopped(_service().start(wait=False),
                                 lambda svc: svc.wait_ready(**kw))),
    "ServeService.scrape": (jsvc.ServeService.scrape,
                            psvc.ServeService.scrape, {
        "timeout_s": (1.0, None)},
        lambda f, **kw: _stopped(_service().start(wait=False),
                                 lambda svc: svc.scrape(**kw))),
    "ServeService.collect_stats": (jsvc.ServeService.collect_stats,
                                   psvc.ServeService.collect_stats, {
        "timeout_s": (1.0, None)},
        lambda f, **kw: _stopped(_service().start(wait=False),
                                 lambda svc: svc.collect_stats(**kw))),
    "TenantQuotas": (jsvc.TenantQuotas, psvc.TenantQuotas, {
        "limits": ({"a": (1.0, 2.0)}, None)},
        lambda f, **kw: f(**kw).admit("a", 1.0, 0.0)),
    "TokenBucket": (jsvc.TokenBucket, psvc.TokenBucket, {},
                    lambda f, **kw: f(1.0, 2.0).try_take(1.0, 0.0)),
    "ShmTransport": (jsvc.ShmTransport, psvc.ShmTransport, {
        "root": ("tmp", None), "owner": (True, None)},
        lambda f, **kw: f(**{k: (_tmp() if v == "tmp" else v)
                             for k, v in kw.items()}).close()),
    "shm_root": (jsvc.shm_root, psvc.shm_root, {
        "prefix": ("sig-serve-", None)},
        lambda f, **kw: os.rmdir(f(**kw))),
    "send_frame": (jsvc.send_frame, psvc.send_frame, {
        "blobs": ((b"x",), None)},
        lambda f, **kw: f(type("S", (), {"sendall": lambda s, d: None})(),
                          {"type": "hello"}, **kw)),
    "recv_frame": (jsvc.recv_frame, psvc.recv_frame, {},
                   lambda f, **kw: None),
    "encode_payload": (jsvc.encode_payload, psvc.encode_payload, {},
                       lambda f, **kw: f(psvc.handoff_to_payload(
                           _handoff()))),
    "decode_payload": (jsvc.decode_payload, psvc.decode_payload, {},
                       lambda f, **kw: f(*psvc.encode_payload(
                           psvc.handoff_to_payload(_handoff())))),
    "payload_to_handoff": (jsvc.payload_to_handoff, psvc.payload_to_handoff,
                           {}, lambda f, **kw: f(psvc.handoff_to_payload(
                               _handoff()))),
})



def _sampling_engine(model, **kw):
    return dtt.serving.Engine(model, max_slots=2, block_size=4, max_len=8,
                              temperature=1.0, **kw)


def _post_trainer(**kw):
    m = _compiled()
    return dtt.rl.PostTrainer(m, _sampling_engine(m), **kw)


_PROMPTS = [np.arange(3) % 32, np.arange(2) % 32]


def _distiller(**kw):
    target, draft = _compiled(), _compiled()
    eng = dtt.serving.Engine(target, max_slots=2, block_size=4, max_len=8,
                             draft_model=draft, spec_k=2)
    return dtt.rl.DraftDistiller(eng, draft, **kw)


def _record_source(tmp):
    dtt.data.write_records(tmp, [bytes([i]) * 6 for i in range(16)])
    return dtt.data.RecordSource(tmp, decode_fn=lambda b: np.frombuffer(
        b, np.uint8).reshape(2, 3).astype(np.float32))


def _pipeline(f, **kw):
    if "decode_workers" in kw or "decode_readahead" in kw:
        x = _record_source(_tmp())
        kw.setdefault("decode_workers", 1)
    else:
        x = np.arange(16 * 6, dtype=np.uint8).reshape(16, 2, 3)
    with f(x, **{"batch_size": 4, **kw}) as p:
        return next(p)


PAIRS.update({
    "PostTrainer": (jrl.PostTrainer, dtt.rl.PostTrainer, {
        "reward_fn": ("toy_preference", None),
        "optimizer": (dtt.optim.fused_adam(1e-3), None),
        "learning_rate": (1e-2, None),
        "kl_coef": (dtt.optim.AdaptiveKLCoef(), None),
        "ppo_clip": (0.2, None), "baseline_decay": (0.5, None),
        "train_len": (8, None), "grad_accum": (2, None),
        "measure_kl": (False, None), "seed": (3, None)},
        lambda f, **kw: _post_trainer(**(
            {**kw, "reward_fn": dtt.rl.rewards.get(
                "toy_preference", vocab_size=32)}
            if "reward_fn" in kw else kw)).iterate(
                _PROMPTS, num_samples=2, max_new_tokens=2)),
    "PostTrainer.iterate": (jrl.PostTrainer.iterate,
                            dtt.rl.PostTrainer.iterate, {
        "num_samples": (1, None), "max_new_tokens": (3, None),
        "train_epochs": (2, None)},
        lambda f, **kw: _post_trainer().iterate(
            _PROMPTS, **{"max_new_tokens": 2, **kw})),
    "PostTrainer.train": (jrl.PostTrainer.train, dtt.rl.PostTrainer.train, {
        "iterations": (2, None), "num_samples": (1, None),
        "max_new_tokens": (3, None), "train_epochs": (2, None)},
        lambda f, **kw: _post_trainer().train(
            _PROMPTS, **{"iterations": 1, "max_new_tokens": 2, **kw})),
    "DraftDistiller": (jrl.DraftDistiller, dtt.rl.DraftDistiller, {
        "optimizer": (dtt.optim.Adam(1e-3), None),
        "learning_rate": (1e-3, None), "train_len": (8, None),
        "seed": (3, None)},
        lambda f, **kw: _distiller(**kw).fit(_PROMPTS, max_new_tokens=2,
                                             epochs=1)),
    "DraftDistiller.fit": (jrl.DraftDistiller.fit, dtt.rl.DraftDistiller.fit,
                           {"max_new_tokens": (3, None),
                            "num_samples": (2, None), "epochs": (2, None),
                            "rounds": (2, None), "sync": (False, None)},
        lambda f, **kw: _distiller().fit(
            _PROMPTS, **{"max_new_tokens": 2, "epochs": 1, **kw})),
    "DraftDistiller.collect": (jrl.DraftDistiller.collect,
                               dtt.rl.DraftDistiller.collect, {
        "max_new_tokens": (3, None), "num_samples": (2, None)},
        lambda f, **kw: _distiller().collect(
            _PROMPTS, **{"max_new_tokens": 2, **kw})),
    "DraftDistiller.distill": (jrl.DraftDistiller.distill,
                               dtt.rl.DraftDistiller.distill, {
        "epochs": (2, None), "batch_size": (1, None)},
        lambda f, **kw: (lambda d: d.distill(d.collect(
            _PROMPTS, max_new_tokens=2), **kw))(_distiller())),
    "data.Pipeline": (dtpu.data.Pipeline, dtt.data.Pipeline, {
        "batch_size": (8, None), "shuffle": (False, None), "seed": (3, None),
        "scale": (0.5, None), "prefetch": (2, None),
        "num_threads": (3, None), "use_native": (True, None),
        "shard": ((1, 2), None), "decode_workers": (2, None),
        "decode_readahead": (3, None)}, _pipeline),
    "nn.RandomCrop": (dtpu.nn.RandomCrop, dtt.nn.RandomCrop, {
        "padding": (2, None), "name": ("crop", None)},
        lambda f, **kw: f(4, 4, **kw).build((4, 5, 3), None)),
    "nn.RandomFlip": (dtpu.nn.RandomFlip, dtt.nn.RandomFlip, {
        "mode": ("vertical", None), "name": ("flip", None)},
        lambda f, **kw: f(**kw).build((4, 5, 3), None)),
})

def _exits_zero(f, **kw):
    try:
        f(**kw)
    except SystemExit as e:
        assert e.code == 0


def _keywords(fn):
    return [n for n, p in inspect.signature(fn).parameters.items()
            if n != "self" and p.kind not in (p.VAR_POSITIONAL,
                                              p.VAR_KEYWORD)]


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_port_signature_has_every_jax_keyword(pair):
    jax_fn, port_fn, probes, _ = PAIRS[pair]
    port_kw = _keywords(port_fn)
    missing = [k for k in _keywords(jax_fn) if k not in port_kw]
    assert not missing, f"{pair} lacks {missing}"
    # Every JAX keyword that has a default is probed below (``y`` goes
    # with the data: arrays, or None with an iterator).
    with_default = [n for n, p in inspect.signature(jax_fn).parameters.items()
                    if p.default is not p.empty and n != "y"]
    assert set(with_default) <= set(probes), set(with_default) - set(probes)


CALLS = [(pair, kw) for pair in sorted(PAIRS) for kw in PAIRS[pair][2]]


@pytest.mark.parametrize("pair,keyword", CALLS,
                         ids=[f"{p}-{k}" for p, k in CALLS])
def test_each_jax_keyword_works_or_raises_not_yet_ported(pair, keyword):
    _, port_fn, probes, call = PAIRS[pair]
    value, item = probes[keyword]
    if item is None:
        call(port_fn, **{keyword: value})
        return
    with pytest.raises(UNPORTED, match=rf"not yet ported.*ROADMAP {item}"):
        call(port_fn, **{keyword: value})


def _cli_flags(module):
    """The ``--flags`` of a launcher CLI, from its ``--help``."""
    out = subprocess.run(
        [sys.executable, "-m", module, "--help"], capture_output=True,
        text=True, timeout=60, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
    return set(re.findall(r"(--[a-z][a-z-]+)", out))


def test_launcher_cli_takes_every_jax_flag():
    """The port's ``python -m distributed_tpu_torch.launch`` accepts every
    flag of the JAX package's; each is exercised in
    ``tests/test_torch_launch_restart.py`` (the resilience flags too, and
    with faults in ``tests/test_torch_resilience.py``,
    ``tests/test_torch_elastic.py`` and ``tests/test_torch_redundancy.py``)."""
    missing = (_cli_flags("distributed_tpu.launch")
               - _cli_flags("distributed_tpu_torch.launch"))
    assert not missing, missing


def _carry(jlayer, player, shape, seed=0):
    """Build both layers on ``shape`` and give the port the JAX weights;
    returns both layers' outputs on the same input (JAX's first)."""
    params, state, _ = jlayer.init(jax.random.PRNGKey(seed), shape)
    player.build(shape, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for path, v in dtt.interop.params_from_jax(
                jax.device_get(params)).items():
            getattr(player, path).copy_(v)
    x = np.random.default_rng(seed).standard_normal((2,) + shape).astype(
        np.float32)
    want, _ = jlayer.apply(params, state, jnp.asarray(x))
    got = player(torch.from_numpy(x))
    return np.asarray(want), got.detach().numpy()


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.nn.Dense(6, use_bias=False),
    lambda pkg: pkg.nn.Dense(6, activation="gelu", shard="row"),
    lambda pkg: pkg.nn.MultiHeadAttention(2, head_dim=8, causal=True),
    lambda pkg: pkg.nn.MultiHeadAttention(2, use_bias=False, ring_axis=None),
    lambda pkg: pkg.nn.LayerNorm(epsilon=1e-2),
], ids=["dense_no_bias", "dense_shard", "mha_head_dim", "mha_no_bias",
        "layer_norm_epsilon"])
def test_ported_keywords_compute_as_jax(make):
    want, got = _carry(make(dtpu), make(dtt), (5, 12))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bidirectional_lm_matches_jax():
    from torch_parity import lm_pair

    jm, pm = lm_pair(vocab=32, num_layers=1, d_model=16, num_heads=2,
                     max_len=16, causal=False)
    x = np.random.default_rng(1).integers(0, 32, (2, 16)).astype(np.int32)
    want = np.asarray(jm.predict(x, batch_size=2))
    got = pm.predict(x, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # A token's logits see later tokens: change the last one.
    y = x.copy()
    y[:, -1] = (y[:, -1] + 1) % 32
    assert not np.allclose(pm.predict(y, batch_size=2)[:, 0], got[:, 0])
    assert pm.module.layers[2].main.layers[1].causal is False
    assert _model(dtt, name="lm").name == "lm" == dtpu.Model(
        _lm(dtpu), name="lm").name
    assert _model(dtt).name == "model"
