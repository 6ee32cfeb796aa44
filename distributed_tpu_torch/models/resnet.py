"""The ResNet family (v1.5), NHWC, as the JAX package's ``models/resnet.py``.

Every convolution is bias-free and followed by BatchNorm; ``dtype=
"bfloat16"`` computes the convolutions and the head in bf16 over f32
parameters. v1.5 puts each bottleneck's stride on its 3x3, not its first
1x1. ``small_inputs=True`` is the CIFAR stem (3x3/1, no pool);
``stem="space_to_depth"`` is the JAX package's TPU stem (space-to-depth
by 2, then a 4x4/1 convolution on 12 channels). The layer names and so the
parameter and state paths are the JAX package's.

On the card the 1x1 convolutions (36 in ResNet-50) run through kernel K12
and BatchNorm's reductions (53 layers) through K13/K14; under
``DataParallel`` BatchNorm is sync-BN. ``scan_stages=True`` (ScannedBlocks)
is not ported yet and raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

from .. import nn

# depth -> (block kind, blocks per stage)
_CONFIGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
_STAGE_WIDTHS = (64, 128, 256, 512)


def _conv_bn(filters, kernel, strides=1, activation=None, dtype=None,
             bn_shift="data"):
    layers = [
        nn.Conv2D(filters, kernel, strides=strides, padding="same",
                  use_bias=False, dtype=dtype),
        nn.BatchNorm(stats_shift=bn_shift),
    ]
    if activation is not None:
        layers.append(nn.Activation(activation))
    return layers


def _projection(filters, strides, dtype, bn_shift):
    return nn.Sequential(
        _conv_bn(filters, 1, strides=strides, dtype=dtype, bn_shift=bn_shift),
        name="shortcut",
    )


def _basic_block(filters, strides, project, dtype, bn_shift):
    main = nn.Sequential(
        _conv_bn(filters, 3, strides=strides, activation="relu", dtype=dtype,
                 bn_shift=bn_shift)
        + _conv_bn(filters, 3, dtype=dtype, bn_shift=bn_shift),
        name="main",
    )
    shortcut = (_projection(filters, strides, dtype, bn_shift)
                if project else None)
    return nn.Residual(main, shortcut, activation="relu")


def _bottleneck_block(filters, strides, project, dtype, bn_shift):
    out = filters * 4
    main = nn.Sequential(
        _conv_bn(filters, 1, activation="relu", dtype=dtype,
                 bn_shift=bn_shift)
        + _conv_bn(filters, 3, strides=strides, activation="relu",
                   dtype=dtype, bn_shift=bn_shift)  # v1.5
        + _conv_bn(out, 1, dtype=dtype, bn_shift=bn_shift),
        name="main",
    )
    shortcut = _projection(out, strides, dtype, bn_shift) if project else None
    return nn.Residual(main, shortcut, activation="relu")


def resnet(
    depth: int = 50,
    num_classes: int = 1000,
    *,
    small_inputs: bool = False,
    stage_blocks: Optional[Sequence[int]] = None,
    width: int = 64,
    stem: str = "conv7",
    scan_stages: bool = False,
    bn_shift: str = "running",
    dtype=None,
) -> nn.Sequential:
    if depth not in _CONFIGS:
        raise ValueError(f"Unsupported depth {depth}; known: {sorted(_CONFIGS)}")
    if scan_stages:
        raise NotImplementedError(
            "resnet(scan_stages=True) (ScannedBlocks): not yet ported")
    kind, default_blocks = _CONFIGS[depth]
    blocks = tuple(stage_blocks) if stage_blocks is not None else default_blocks
    base = _basic_block if kind == "basic" else _bottleneck_block
    make = functools.partial(base, bn_shift=bn_shift)
    expansion = 1 if kind == "basic" else 4

    if stem not in ("conv7", "space_to_depth"):
        raise ValueError(
            f"Unknown stem {stem!r}; choose 'conv7' or 'space_to_depth'"
        )
    if small_inputs:  # CIFAR-style stem
        if stem != "conv7":
            raise ValueError(
                "small_inputs=True uses the CIFAR 3x3 stem; it is "
                f"incompatible with stem={stem!r}"
            )
        layers = _conv_bn(width, 3, activation="relu", dtype=dtype,
                          bn_shift=bn_shift)
    elif stem == "space_to_depth":
        # Space-to-depth(2), then a 4x4/1 conv on 12 channels: the output
        # shape of conv7's 7x7/2 (an 8x8 RGB receptive field).
        layers = [nn.SpaceToDepth(2)]
        layers += _conv_bn(width, 4, activation="relu", dtype=dtype,
                           bn_shift=bn_shift)
        layers.append(nn.MaxPool2D(3, strides=2, padding="same"))
    else:  # "conv7": the ImageNet stem
        layers = _conv_bn(width, 7, strides=2, activation="relu",
                          dtype=dtype, bn_shift=bn_shift)
        layers.append(nn.MaxPool2D(3, strides=2, padding="same"))

    in_ch = width
    for stage, n_blocks in enumerate(blocks):
        filters = _STAGE_WIDTHS[stage] * width // 64
        first_strides = 2 if stage > 0 else 1
        project = first_strides != 1 or in_ch != filters * expansion
        layers.append(make(filters, first_strides, project, dtype))
        in_ch = filters * expansion
        for _ in range(n_blocks - 1):
            layers.append(make(filters, 1, False, dtype))

    layers += [nn.GlobalAvgPool2D(), nn.Dense(num_classes, dtype=dtype)]
    return nn.Sequential(layers, name=f"resnet{depth}")


def resnet18(num_classes: int = 1000, **kw) -> nn.Sequential:
    return resnet(18, num_classes, **kw)


def resnet34(num_classes: int = 1000, **kw) -> nn.Sequential:
    return resnet(34, num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> nn.Sequential:
    return resnet(50, num_classes, **kw)


def resnet101(num_classes: int = 1000, **kw) -> nn.Sequential:
    return resnet(101, num_classes, **kw)


def resnet152(num_classes: int = 1000, **kw) -> nn.Sequential:
    return resnet(152, num_classes, **kw)


__all__ = ["resnet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152"]
