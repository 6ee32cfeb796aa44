"""``Model``: a layer stack, its parameters, and the device they live on.

A thin counterpart of the JAX package's ``training/model.py``: ``build``
creates the parameters from a seed, ``params`` exposes them under the JAX
tree paths, and ``decode_dtype`` names the KV-cache dtype the serving
engine uses. ``compile``/``fit`` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..device import resolve_device
from ..interop import SEP


class Model:
    """``Model(module, device=None)``: ``device=None`` is the card; it
    raises ``RuntimeError`` when there is none (pass ``device="cpu"``)."""

    def __init__(self, module, *, device=None):
        self.module = module
        self.device = resolve_device(device)
        self.built = False
        self._decode_dtype = None

    def build(self, input_shape: Sequence[int], seed: int = 0):
        """Create the f32 parameters for an unbatched input shape, drawn
        from a CPU ``torch.Generator`` seeded with ``seed`` (the same
        weights on every device), and move them to ``self.device``."""
        generator = torch.Generator().manual_seed(int(seed))
        self.input_shape = tuple(int(d) for d in input_shape)
        self.module.build(self.input_shape, generator)
        self.module.to(self.device)
        self.module.requires_grad_(False)
        self.built = True
        self._decode_dtype = None
        return self

    def _require_built(self):
        if not self.built:
            raise RuntimeError("Model not built")

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """``{tree path: parameter}``, paths as in the JAX package
        (``residual_1/main/dense_1/kernel``)."""
        self._require_built()
        return {
            name.replace(".", SEP): p
            for name, p in self.module.named_parameters()
        }

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy ``{tree path: tensor}`` (e.g. ``interop.params_from_jax``)
        into the parameters. Paths and shapes must match exactly."""
        own = self.params
        if set(own) != set(params):
            raise ValueError(
                "parameter paths differ: missing "
                f"{sorted(set(own) - set(params))}, unexpected "
                f"{sorted(set(params) - set(own))}"
            )
        with torch.no_grad():
            for path, p in own.items():
                src = torch.as_tensor(params[path])
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{path}: shape {tuple(src.shape)} != {tuple(p.shape)}"
                    )
                p.copy_(src)
        self._decode_dtype = None

    def decode_dtype(self) -> torch.dtype:
        """KV-cache / activation dtype for decode: the dtype of the logits
        (there is no precision policy yet), found by one forward pass of
        a single token. Memoized per build/load."""
        self._require_built()
        if self._decode_dtype is None:
            with torch.inference_mode():
                x = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
                self._decode_dtype = self.module(x).dtype
        return self._decode_dtype


__all__ = ["Model"]
