"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Build a model in the JAX package, carry its parameters into the port
(``interop.params_from_jax``), and run both on the same seeded numpy
inputs. JAX stays on the CPU (conftest), the port runs with
``device="cpu"``.
"""

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
            dtype=None, seed=0):
    """The same transformer_lm in both packages, on the same weights.
    ``dtype``: None (f32) or "bfloat16"."""
    kw = dict(num_layers=num_layers, d_model=d_model, num_heads=num_heads,
              max_len=max_len)
    jm = jax_model(dtpu.models.transformer_lm(
        vocab, dtype=None if dtype is None else jax.numpy.dtype(dtype), **kw),
        (16,), seed=seed)
    pm = port_model(dtt.models.transformer_lm(vocab, dtype=dtype, **kw),
                    (16,), jm.params)
    return jm, pm


def as_np(x):
    """A JAX array or torch tensor as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)
