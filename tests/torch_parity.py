"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Build a model in the JAX package, carry its parameters into the port
(``interop.params_from_jax``), and run both on the same seeded numpy
inputs. JAX stays on the CPU (conftest), the port runs with
``device="cpu"``.
"""

import functools

import jax
import numpy as np
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt


def jax_model(module, input_shape, seed=0):
    """A built (and compiled, as the JAX Engine expects) JAX Model."""
    model = dtpu.Model(module)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    model.build(input_shape, seed=seed)
    return model


def port_model(module, input_shape, jax_params):
    """The port's Model of ``module`` on the CPU, holding ``jax_params``."""
    model = dtt.Model(module, device="cpu").build(input_shape)
    model.load_params(dtt.interop.params_from_jax(jax.device_get(jax_params)))
    return model


def lm_pair(vocab=64, num_layers=2, d_model=32, num_heads=2, max_len=64,
            dtype=None, seed=0, **lm_kw):
    """The same transformer_lm in both packages, on the same weights.
    ``dtype``: None (f32) or "bfloat16"; ``lm_kw`` (e.g. ``flash=True``)
    go to both constructors."""
    kw = dict(num_layers=num_layers, d_model=d_model, num_heads=num_heads,
              max_len=max_len, **lm_kw)
    jm = jax_model(dtpu.models.transformer_lm(
        vocab, dtype=None if dtype is None else jax.numpy.dtype(dtype), **kw),
        (16,), seed=seed)
    pm = port_model(dtt.models.transformer_lm(vocab, dtype=dtype, **kw),
                    (16,), jm.params)
    return jm, pm


def _with_table_copy(fn, *args):
    args = list(args)
    args[4] = np.array(args[4])  # the block-table row, copied
    return fn(*args)


def jax_engine(model, **kw):
    """A JAX ``serving.Engine`` whose prefill dispatches (target and draft)
    get a copy of their block-table row. The JAX engine passes them a view
    of its host table and grows the table (``reserve``) right after the
    asynchronous dispatch, which on the CPU may read the row later: under
    load, padded prefill rows then land in newly reserved blocks, where a
    speculative draft can read them (ROADMAP Queue 3), so its acceptance
    counts vary from run to run (its tokens never do). The copy is the
    table the engine means to pass."""
    from distributed_tpu.serving import Engine

    engine = Engine(model, **kw)
    for name in ("_prefill_fn", "_draft_prefill_fn"):
        fn = getattr(engine, name, None)
        if fn is not None:
            setattr(engine, name, functools.partial(_with_table_copy, fn))
    return engine


def as_np(x):
    """A JAX array or torch tensor as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)
