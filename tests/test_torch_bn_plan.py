"""K13/K14's launch path on the CPU: the partition plan, the merge's
arithmetic, and the wrapper's packed call.

- ``bn_reduce.plan`` covers every channel and every row of an (M, C)
  reduction exactly once, in tiles and ranges the kernel takes, and makes
  one wave of blocks on a 132-SM card at each of ResNet-50's 12
  BatchNorm shapes (batch 256, 224x224) and at ragged shapes (M prime, C
  = 3, C = 96).
- A torch emulation of the kernel's arithmetic (each block's partial sums
  over its tile and rows, then the last block's merge in partition order:
  ``groups`` threads a value, each over every ``groups``-th partition, then
  the groups in order) against ``bn_stats_ref`` / ``bn_bwd_reduce_ref``.
- The wrapper with a stand-in library: one packed struct per call with the
  plan's fields, the thread count read once a process, one launch counted
  per call, a workspace per stream whose counters stay at zero, and the
  per-element route for C = 3 and for an input off a 16-byte boundary.

Tolerances. The emulation against the plain versions: rtol 1e-5 plus
1e-5 times the sum of the terms' magnitudes (f32 sums in another order; a
sum of signed terms can cancel to near 0). On inputs on a 1/8 grid every
partial sum is exact in f32, so there the emulation equals the plain
version bit for bit, and two calls give the same bits.
"""

import ctypes

import numpy as np
import pytest
import torch

from distributed_tpu_torch.ops import _build
from distributed_tpu_torch.ops import bn_reduce as bn_ops

torch.set_num_threads(1)

SMS, THREADS = 132, 256  # an H100 SXM; the kernel's block
# ResNet-50's BatchNorm shapes at batch 256, 224x224: (M, C) -> count.
RESNET50_BNS = {
    (3211264, 64): 1, (802816, 64): 6, (802816, 256): 4, (802816, 128): 1,
    (200704, 128): 7, (200704, 512): 5, (200704, 256): 1, (50176, 256): 11,
    (50176, 1024): 7, (50176, 512): 1, (12544, 512): 5, (12544, 2048): 4,
}
RAGGED = [(100003, 3), (4099, 96), (1000, 3), (777, 2048), (7, 5), (1, 1),
          (12547, 96)]


def _per(elem, vec):
    return 16 // elem if vec else 1


# 16-byte vectors only where C is whole vectors, as the wrapper chooses.
PLAN_CASES = [(m, c, elem, vec) for m, c in sorted(RESNET50_BNS) + RAGGED
              for elem in (2, 4) for vec in (1, 0)
              if not (vec and c % _per(elem, vec))]


@pytest.mark.parametrize("m,c,elem,vec", PLAN_CASES)
def test_plan_covers_every_row_and_channel_once(m, c, elem, vec):
    tw, tiles_c, nparts, rows = bn_ops.plan(m, c, elem, vec, SMS, THREADS)
    per = _per(elem, vec)
    # What the kernel takes: tw a power of two up to 32, a tile of at most
    # 64 floats a sum, at most 65,535 row ranges.
    assert tw & (tw - 1) == 0 and 1 <= tw <= 32 and tw * per <= 64
    assert 1 <= nparts <= 65535 and rows % (THREADS // tw) == 0
    channels = np.zeros(c, np.int64)
    for t in range(tiles_c):
        channels[t * tw * per:(t + 1) * tw * per] += 1
    assert (channels == 1).all()
    starts = np.arange(nparts) * rows
    ends = np.minimum(starts + rows, m)
    assert starts[0] == 0 and ends[-1] == m and (ends > starts).all()
    assert (starts[1:] == ends[:-1]).all()


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("m,c", sorted(RESNET50_BNS))
def test_plan_fills_one_wave_at_resnet50_shapes(m, c, elem):
    tw, tiles_c, nparts, rows = bn_ops.plan(m, c, elem, 1, SMS, THREADS)
    wave = SMS * bn_ops._BLOCKS_PER_SM
    assert 0.95 * wave <= tiles_c * nparts <= wave
    assert tw * _per(elem, 1) * elem >= 64  # whole 64-byte row segments
    if 4 * _per(elem, 1) * bn_ops._MIN_TILES <= c:
        assert tiles_c >= bn_ops._MIN_TILES


@pytest.mark.parametrize("m,c", RAGGED)
def test_plan_stays_within_one_wave_and_gives_each_thread_a_batch(m, c):
    tw, tiles_c, nparts, rows = bn_ops.plan(m, c, 2, 0, SMS, THREADS)
    assert tiles_c * nparts <= SMS * bn_ops._BLOCKS_PER_SM
    assert nparts == 1 or rows >= THREADS // tw * bn_ops._UNROLL


# ------------------------------------------------------------ the merge
def _emulate(t1, t2, elem, vec, sms=SMS):
    """The kernel's sums of the (M, C) f32 terms t1 and t2 under its plan:
    a block's partial sums over its tile and rows, then, per tile, the
    merge in partition order (``groups`` threads a value, each over every
    ``groups``-th partition, then the groups in order)."""
    m, c = t1.shape
    tw, _, nparts, rows = bn_ops.plan(m, c, elem, vec, sms, THREADS)
    width = tw * _per(elem, vec)
    terms = torch.stack([t1, t2])  # (2, M, C)
    partial = torch.stack([terms[:, p * rows:(p + 1) * rows].sum(1)
                           for p in range(nparts)])  # (nparts, 2, C)
    if nparts == 1:
        return partial[0]
    lanes = 2 * width // 4 if vec else 2 * width  # float4 loads when vec
    groups = THREADS // lanes
    out = torch.zeros(2, c)
    for g in range(groups):
        acc = torch.zeros(2, c)
        for q in range(g, nparts, groups):
            acc = acc + partial[q]
        out = out + acc
    return out


def _terms(x, dy, a, b, bwd):
    xf = x.float()
    if bwd:
        dyf = dy.float()
        return dyf, dyf * ((xf - a) * b)
    t = xf - a
    return t, t * t


def _close_sums(got, want, terms):
    atol = 1e-5 * terms.abs().sum(0)
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + atol + 1e-30).all())


def _inputs(m, c, dtype, seed, grid=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, c)) * 2 + 1
    dy = rng.standard_normal((m, c))
    a = rng.standard_normal(c) * 0.5
    b = rng.uniform(0.5, 1.5, c)
    if grid:  # every product and sum exact in f32
        x, dy, a = (np.round(v * 8) / 8 for v in (x, dy, a))
        b = np.round(b * 4) / 4
    t = [torch.from_numpy(v.astype(np.float32)) for v in (x, dy, a, b)]
    return t[0].to(dtype), t[1].to(dtype), t[2], t[3]


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("dtype,vec", [(torch.float32, 1),
                                       (torch.bfloat16, 1),
                                       (torch.float16, 1),
                                       (torch.bfloat16, 0)])
@pytest.mark.parametrize("m,c", [(12544, 64), (3001, 96), (997, 3),
                                 (2048, 512)])
def test_emulated_merge_matches_the_plain_versions(m, c, dtype, vec, bwd):
    if vec and c % (16 // torch.empty(0, dtype=dtype).element_size()):
        vec = 0
    x, dy, a, b = _inputs(m, c, dtype, seed=m + c)
    t1, t2 = _terms(x, dy, a, b, bwd)
    got = _emulate(t1, t2, x.element_size(), vec)
    want = (bn_ops.bn_bwd_reduce_ref(dy, x, a, b) if bwd
            else bn_ops.bn_stats_ref(x, a))
    _close_sums(got[0], want[0], t1)
    _close_sums(got[1], want[1], t2)


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_emulated_merge_is_bit_exact_on_a_one_eighth_grid(sms, bwd):
    x, dy, a, b = _inputs(20011, 64, torch.float32, seed=3, grid=True)
    t1, t2 = _terms(x, dy, a, b, bwd)
    first = _emulate(t1, t2, 4, 1, sms)
    again = _emulate(t1, t2, 4, 1, sms)
    want = (bn_ops.bn_bwd_reduce_ref(dy, x, a, b) if bwd
            else bn_ops.bn_stats_ref(x, a))
    assert torch.equal(first, again) and torch.equal(first, want)


# ------------------------------------------------------ the launch path
class _Lib:
    """Stands in for the built library: records each packed call."""

    def __init__(self):
        self.calls = []

    def dtt_bn_reduce(self, buf):
        self.calls.append(buf)
        return 0

    def dtt_bn_reduce_args_bytes(self):
        return bn_ops._ARGS.size

    def dtt_bn_reduce_threads(self):
        self.calls.append("threads")
        return THREADS


@pytest.fixture
def stand_in(monkeypatch):
    fake = _Lib()
    lib = _build.Library("bn_reduce", bn_ops._LIB.signatures)
    lib._handle = fake
    monkeypatch.setattr(bn_ops, "_LIB", lib)
    monkeypatch.setattr(bn_ops, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(bn_ops, "_WORKSPACE", {})
    streams = iter([0xA11CE] * 4 + [0xB0B] * 2)
    monkeypatch.setattr(_build, "raw_stream", lambda index: next(streams))
    return fake


def test_wrapper_packs_its_fields_and_reads_the_thread_count_once(stand_in):
    m, c = 50176, 256
    x, dy, a, b = _inputs(m, c, torch.bfloat16, seed=1)
    before = dict(bn_ops.launches)
    outs = [bn_ops._bn_stats_cuda(x, a), bn_ops._bn_stats_cuda(x, a),
            bn_ops._bn_bwd_reduce_cuda(dy, x, a, b)]
    assert bn_ops.LAUNCHES_PER_CALL == 1
    assert bn_ops.launches["bn_stats"] == before["bn_stats"] + 2
    assert bn_ops.launches["bn_bwd_reduce"] == before["bn_bwd_reduce"] + 1
    assert stand_in.calls.count("threads") == 1
    bufs = [c for c in stand_in.calls if isinstance(c, bytes)]
    assert len(bufs) == 3
    tw, tiles_c, nparts, rows = bn_ops.plan(m, c, 2, 1, SMS, THREADS)
    counters, partials = bn_ops._WORKSPACE[(None, 0xA11CE)]
    assert counters.numel() >= tiles_c and partials.numel() >= nparts * 2 * c
    assert torch.equal(counters, torch.zeros_like(counters))
    assert bn_ops._ARGS.unpack(bufs[0]) == (
        x.data_ptr(), 0, a.data_ptr(), 0, outs[0].data_ptr(),
        partials.data_ptr(), counters.data_ptr(), 0xA11CE, 1, 0, 1, m, c,
        tw, tiles_c, nparts, rows)
    assert bn_ops._ARGS.unpack(bufs[2])[:11] == (
        x.data_ptr(), dy.data_ptr(), a.data_ptr(), b.data_ptr(),
        outs[2].data_ptr(), partials.data_ptr(), counters.data_ptr(),
        0xA11CE, 1, 1, 1)
    assert all(o.shape == (2, c) and o.dtype == torch.float32 for o in outs)


def test_wrapper_takes_the_per_element_route_and_a_workspace_per_stream(
        stand_in):
    x, dy, a, b = _inputs(997, 3, torch.float16, seed=2)
    bn_ops._bn_stats_cuda(x, a)  # C = 3: not whole 16-byte vectors
    flat = torch.zeros(1000 * 64 + 1, dtype=torch.float32)
    view = flat[1:].view(1000, 64)  # 4 bytes past a 16-byte boundary
    bn_ops._bn_stats_cuda(view, torch.zeros(64))
    bn_ops._bn_stats_cuda(view.clone(), torch.zeros(64))
    bn_ops._bn_stats_cuda(x.float(), a)
    bufs = [bn_ops._ARGS.unpack(c) for c in stand_in.calls
            if isinstance(c, bytes)]
    assert [(f[8], f[10]) for f in bufs] == [(2, 0), (0, 0), (0, 1), (0, 0)]
    assert bufs[1][13:] == bn_ops.plan(1000, 64, 4, 0, SMS, THREADS)
    # The next calls read another stream: their own counters.
    bn_ops._bn_stats_cuda(view.clone(), torch.zeros(64))
    bn_ops._bn_bwd_reduce_cuda(dy, x, a, b)
    bufs = [bn_ops._ARGS.unpack(c) for c in stand_in.calls
            if isinstance(c, bytes)]
    assert {f[7] for f in bufs[4:]} == {0xB0B}
    ws = bn_ops._WORKSPACE
    assert set(ws) == {(None, 0xA11CE), (None, 0xB0B)}
    assert ws[(None, 0xB0B)][0].data_ptr() != ws[(None, 0xA11CE)][0].data_ptr()
    assert bufs[-1][6] == ws[(None, 0xB0B)][0].data_ptr()


def test_wrapper_passes_f32_copies_of_other_channel_vectors(stand_in,
                                                           monkeypatch):
    """A channel vector that is not contiguous f32 is converted, and the
    call points at the copy, which holds its values when the launcher
    runs."""
    x, _, a, _ = _inputs(64, 8, torch.float32, seed=5)
    seen = []
    real = stand_in.dtt_bn_reduce

    def launch(buf):
        ptr = bn_ops._ARGS.unpack(buf)[2]
        seen.append((ptr, list((ctypes.c_float * 8).from_address(ptr))))
        return real(buf)

    monkeypatch.setattr(stand_in, "dtt_bn_reduce", launch)
    shift = a.double()
    bn_ops._bn_stats_cuda(x, shift)
    strided = torch.arange(16, dtype=torch.float32)[::2]
    bn_ops._bn_stats_cuda(x, strided)
    assert seen[0][0] != shift.data_ptr() and seen[0][1] == a.tolist()
    assert seen[1][0] != strided.data_ptr()
    assert seen[1][1] == strided.tolist()


def test_wrapper_checks_its_inputs(stand_in):
    x, dy, a, b = _inputs(64, 8, torch.float32, seed=4)
    with pytest.raises(ValueError, match=r"float64 not supported \(float32, "
                                         r"bfloat16, float16\)"):
        bn_ops._bn_stats_cuda(x.double(), a)
    with pytest.raises(ValueError, match="differ"):
        bn_ops._bn_bwd_reduce_cuda(dy[:32], x, a, b)
    with pytest.raises(ValueError, match="channel vector of 7"):
        bn_ops._bn_stats_cuda(x, a[:7])
    with pytest.raises(ValueError, match="contiguous"):
        bn_ops._bn_stats_cuda(x.t(), a)
    out = bn_ops._bn_stats_cuda(x[:0], a)  # no rows: zeros, no launch
    assert torch.equal(out, torch.zeros(2, 8)) and not stand_in.calls
