"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without an NVIDIA card (a CUDA kernel has
no CPU mode). The module imports neither JAX nor the JAX package, so on the
card it runs without them (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: 2e-5 for f32 (sums in different orders), 2e-2 for bf16
(probabilities round to bf16 at different running maxima).
"""

import pytest
import torch

from distributed_tpu_torch.ops import paged_attention as paged_ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, dtype, kw, int8, s=8, nb=8, bs=16, h=4, hd=64, seed=11):
    g = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randn((s * nb + 1, bs, h, hd), generator=g, device=dev)
    vp = torch.randn((s * nb + 1, bs, h, hd), generator=g, device=dev)
    q = torch.randn((s, kw, h, hd), generator=g, device=dev).to(dtype)
    tables = (1 + torch.arange(s * nb, device=dev).reshape(s, nb)).int()
    tables[-1] = 0  # a free slot on the trash block
    positions = torch.randint(0, nb * bs - kw + 1, (s,), generator=g,
                              device=dev).int()
    positions[0] = 0
    positions[-1] = 0
    if int8:
        def quant(pool):
            amax = pool.abs().amax(dim=-1, keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0, 1.0)
            qv = torch.clamp(torch.round(pool / scale), -127, 127)
            return {"q": qv.to(torch.int8), "scale": scale}
        return q, quant(kp), quant(vp), tables, positions
    return q, kp.to(dtype), vp.to(dtype), tables, positions


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,kw,int8",
    [(torch.float32, 1, False), (torch.bfloat16, 1, False),
     (torch.bfloat16, 4, False), (torch.bfloat16, 1, True),
     (torch.float32, 4, True)])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, kw, int8):
    args = _inputs(cuda_device, dtype, kw, int8)
    key = "paged_attention_int8" if int8 else "paged_attention"
    before = paged_ops.launches[key]
    got = paged_ops.paged_attention(*args)
    want = paged_ops.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert paged_ops.launches[key] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
