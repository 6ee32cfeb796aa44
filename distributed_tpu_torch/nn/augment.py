"""Device-side image augmentation layers (train-only, eval = identity).

The port of the JAX package's ``nn/augment.py``: ``RandomFlip`` and
``RandomCrop`` run inside the train step as layers, drawing their
per-sample randomness from the step key through the port's rng routing
(``nn.core.current_rng``, as ``Dropout`` does), so augmentation is
deterministic given (seed, step): a resumed run replays the same crops
and flips, and the draws equal JAX's bit for bit (``utils.threefry``).
JAX draws over the global batch; under a strategy that splits the rows,
each rank draws its own rows' coins and offsets only
(``nn.core.draw_block``). The host pipeline stays a byte mover. Inputs
are NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import threefry
from .core import Layer, Shape, current_rng, draw_block


def _check_hwc(name: str, input_shape: Shape) -> None:
    if len(input_shape) != 3:
        raise ValueError(
            f"{name} expects (H, W, C) inputs, got {tuple(input_shape)}")


def _step_rng(name: str):
    rng = current_rng()
    if rng is None:
        raise ValueError(f"{name} needs an rng when train=True")
    return rng


class RandomFlip(Layer):
    """Per-sample horizontal (and/or vertical) flip with probability 0.5.

    Train-only; eval mode is the identity. Expects NHWC inputs.
    """

    needs_rng = True
    decode_safe = False  # mixes spatial positions

    def __init__(self, mode: str = "horizontal", name: Optional[str] = None):
        super().__init__(name)
        if mode not in ("horizontal", "vertical", "horizontal_and_vertical"):
            raise ValueError(
                f"mode must be 'horizontal', 'vertical', or "
                f"'horizontal_and_vertical', got {mode!r}"
            )
        self.mode = mode

    def build(self, input_shape: Shape, generator):
        _check_hwc("RandomFlip", input_shape)
        return tuple(input_shape)

    def forward(self, x):
        if not self.training:
            return x
        keys = threefry.split(_step_rng("RandomFlip"))
        shape, index = draw_block((x.shape[0], 1, 1, 1), x.device,
                                  seq_dim=None)
        # (axis flipped, its key): horizontal flips W (dim 2) on the first
        # key, vertical flips H (dim 1) on the second, as in JAX.
        for axis, key, modes in ((2, keys[0], ("horizontal",)),
                                 (1, keys[1], ("vertical",))):
            if self.mode in modes + ("horizontal_and_vertical",):
                coin = threefry.bernoulli_block(key, 0.5, shape, index,
                                                x.device)
                x = torch.where(coin, x.flip(axis), x)
        return x


class RandomCrop(Layer):
    """Per-sample random crop to (height, width), optionally zero-padding
    first (the CIFAR pad-4-crop-32 recipe). Eval mode center-crops.

    Expects NHWC inputs; output is (height, width, C). The crop of every
    sample is one indexed gather from the padded batch.
    """

    needs_rng = True
    decode_safe = False  # mixes spatial positions

    def __init__(self, height: int, width: int, *, padding: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.height = int(height)
        self.width = int(width)
        self.padding = int(padding)
        if self.height < 1 or self.width < 1 or self.padding < 0:
            raise ValueError(
                f"Invalid crop ({height}x{width}, padding={padding})"
            )

    def build(self, input_shape: Shape, generator):
        _check_hwc("RandomCrop", input_shape)
        h, w, c = input_shape
        p = self.padding
        if self.height > h + 2 * p or self.width > w + 2 * p:
            raise ValueError(
                f"Crop {self.height}x{self.width} larger than padded input "
                f"{h + 2 * p}x{w + 2 * p}"
            )
        return (self.height, self.width, c)

    def forward(self, x):
        p = self.padding
        # NHWC: zero rows and columns around H and W, none on C.
        xp = F.pad(x, (0, 0, p, p, p, p)) if p else x
        b, h, w, _ = xp.shape
        max_y, max_x = h - self.height, w - self.width
        if not self.training:
            y0, x0 = max_y // 2, max_x // 2
            return xp[:, y0:y0 + self.height, x0:x0 + self.width, :]
        k_y, k_x = threefry.split(_step_rng("RandomCrop"))
        shape, index = draw_block((b,), x.device, seq_dim=None)
        ys = threefry.randint_block(k_y, shape, index, 0, max_y + 1,
                                    x.device)
        xs = threefry.randint_block(k_x, shape, index, 0, max_x + 1,
                                    x.device)
        rows = ys[:, None] + torch.arange(self.height, device=x.device)
        cols = xs[:, None] + torch.arange(self.width, device=x.device)
        batch = torch.arange(b, device=x.device)
        return xp[batch[:, None, None], rows[:, :, None], cols[:, None, :]]


__all__ = ["RandomCrop", "RandomFlip"]
