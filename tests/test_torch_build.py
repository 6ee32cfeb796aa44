"""The build key of the port's CUDA sources (``ops._build.build_key``).

A source is rebuilt when the key changes and reused when it does not, so
the key must cover every header the source includes from ``csrc/``; it is
plain Python and needs no ``nvcc``. Each case works on a temporary copy of
a source and its headers.
"""

import pytest
import torch

from distributed_tpu_torch.ops import _build

torch.set_num_threads(1)


@pytest.fixture
def tree(tmp_path):
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    "inline int g() { return h(); }\n")
    (tmp_path / "b.cuh").write_text("#pragma once\ninline int h() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("int unused;\n")
    return tmp_path


def test_key_is_stable(tree):
    assert _build.build_key(tree / "k.cu") == _build.build_key(tree / "k.cu")


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_key_changes_with_the_source_or_any_header_it_includes(tree, edited):
    before = _build.build_key(tree / "k.cu")
    path = tree / edited
    path.write_bytes(path.read_bytes() + b"// edited\n")
    assert _build.build_key(tree / "k.cu") != before


def test_key_ignores_headers_the_source_does_not_include(tree):
    before = _build.build_key(tree / "k.cu")
    (tree / "other.cuh").write_text("int changed;\n")
    assert _build.build_key(tree / "k.cu") == before


def test_key_changes_with_the_flags(tree, monkeypatch):
    before = _build.build_key(tree / "k.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-DX=1"))
    assert _build.build_key(tree / "k.cu") != before


def test_every_port_source_has_a_key_over_its_headers():
    """flash_attention.cu and conv1x1.cu share hopper_wgmma.cuh."""
    for name in ("flash_attention", "conv1x1", "paged_attention"):
        assert len(_build.build_key(_build.source(name))) == 64
    assert b'#include "hopper_wgmma.cuh"' in _build.source("conv1x1").read_bytes()
