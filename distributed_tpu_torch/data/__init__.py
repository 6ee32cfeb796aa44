"""Data of the port: the datasets (``datasets.py``), the file and record
shard sources (``filesource.py``, ``records.py``), the input ``Pipeline``
with its native C++ ring and decode pool (``pipeline.py``) and the device
prefetch ``fit`` stages its batches through (``prefetch.py``)."""

from .datasets import (
    fetch_mnist, load, load_cifar10, load_digits_real, load_fashion_mnist,
    load_imagenet, load_mnist, synthetic_images,
)
from .filesource import FileSource, write_shards
from .pipeline import Pipeline, native_available
from .prefetch import DevicePrefetcher, DeviceStager
from .records import RecordCorruptionError, RecordSource, write_records

__all__ = [
    "DevicePrefetcher", "DeviceStager", "FileSource", "Pipeline",
    "RecordCorruptionError", "RecordSource", "fetch_mnist", "load",
    "load_cifar10", "load_digits_real", "load_fashion_mnist",
    "load_imagenet", "load_mnist", "native_available", "synthetic_images",
    "write_records", "write_shards",
]
