"""Data of the port: offline datasets (``datasets.py``), the input
``Pipeline`` (``pipeline.py``) and the device prefetch ``fit`` stages its
batches through (``prefetch.py``)."""

from .datasets import load_cifar10, load_mnist, synthetic_images
from .pipeline import Pipeline
from .prefetch import DevicePrefetcher, DeviceStager

__all__ = [
    "DevicePrefetcher", "DeviceStager", "Pipeline", "load_cifar10",
    "load_mnist", "synthetic_images",
]
