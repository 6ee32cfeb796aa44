"""The reference model zoo's small CNNs, as the JAX package builds them.

``mnist_cnn`` is the reference trainers' architecture:
Conv2D(32, 3x3, relu) -> MaxPool2D -> Flatten -> Dense(64, relu) ->
Dense(10), 347,146 parameters in 6 tensors. ``cifar_cnn`` is the VGG-ish
3-block stack of the JAX package's CIFAR-10 configuration.
"""

from __future__ import annotations

from .. import nn


def mnist_cnn(num_classes: int = 10, dtype=None) -> nn.Sequential:
    return nn.Sequential(
        [
            nn.Conv2D(32, (3, 3), activation="relu", dtype=dtype),
            nn.MaxPool2D(2),
            nn.Flatten(),
            nn.Dense(64, activation="relu", dtype=dtype),
            nn.Dense(num_classes, dtype=dtype),
        ]
    )


def cifar_cnn(num_classes: int = 10, dtype=None) -> nn.Sequential:
    return nn.Sequential(
        [
            nn.Conv2D(64, (3, 3), padding="same", activation="relu", dtype=dtype),
            nn.Conv2D(64, (3, 3), padding="same", activation="relu", dtype=dtype),
            nn.MaxPool2D(2),
            nn.Conv2D(128, (3, 3), padding="same", activation="relu", dtype=dtype),
            nn.Conv2D(128, (3, 3), padding="same", activation="relu", dtype=dtype),
            nn.MaxPool2D(2),
            nn.Conv2D(256, (3, 3), padding="same", activation="relu", dtype=dtype),
            nn.GlobalAvgPool2D(),
            nn.Dense(256, activation="relu", dtype=dtype),
            nn.Dense(num_classes, dtype=dtype),
        ]
    )
