"""Offline datasets of the port (``datasets.py``)."""

from .datasets import load_cifar10, load_mnist, synthetic_images

__all__ = ["load_cifar10", "load_mnist", "synthetic_images"]
