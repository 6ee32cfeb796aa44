"""The port's meshes against the JAX package's, without starting a process.

``parallel.mesh.device_grid`` is the arrangement ``make_mesh`` gives its
``DeviceMesh``: rank r must sit where device r sits in the JAX mesh of the
same axis sizes (``mesh.devices`` ids), for two-axis meshes, a device
subset (ranks listed out of order) and a mocked two-slice ``dcn_axis``
layout; the errors are JAX's. ``AXES`` is JAX's tuple, in its order (the
order decides which rank holds which coordinate).
"""

import jax
import numpy as np
import pytest

from distributed_tpu.parallel import mesh as jax_mesh
from distributed_tpu_torch.parallel import mesh as port_mesh

CASES = {
    "data2_model2": ({"data": 2, "model": 2}, [0, 1, 2, 3], None, None),
    "data2_seq2": ({"data": 2, "seq": 2}, [0, 1, 2, 3], None, None),
    "data4_model2": ({"data": 4, "model": 2}, list(range(8)), None, None),
    "model_first_in_dict": ({"model": 2, "data": 2}, [0, 1, 2, 3], None,
                            None),
    "subset_out_of_order": ({"data": 2, "model": 2}, [3, 1, 2, 0], None,
                            None),
    "three_axes": ({"data": 2, "fsdp": 2, "seq": 2}, list(range(8)), None,
                   None),
    "dcn_two_slices": ({"data": 4, "model": 2}, list(range(8)), "data",
                       [i // 4 for i in range(8)]),
    "dcn_interleaved_slices": ({"data": 4, "model": 2}, list(range(8)),
                               "data", [i % 2 for i in range(8)]),
    "dcn_fsdp_within_slice": ({"data": 2, "fsdp": 4}, list(range(8)),
                              "data", [i // 4 for i in range(8)]),
    "default_all_data": (None, [0, 1, 2, 3], None, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_arrangement_is_jax_device_arrangement(case):
    sizes, ranks, dcn, slices = CASES[case]
    devices = [jax.devices()[r] for r in ranks]
    want = jax_mesh.make_mesh(sizes, devices=devices, dcn_axis=dcn,
                              slice_ids=slices)
    names, grid = port_mesh.device_grid(sizes, ranks, dcn_axis=dcn,
                                        slice_ids=slices)
    assert names == tuple(want.axis_names)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(grid, ids)


ERRORS = {
    "unknown_axis": (dict(axis_sizes={"data": 2, "tensor": 2}), "Unknown"),
    "wrong_count": (dict(axis_sizes={"data": 2, "model": 3}), "need 6"),
    "slice_ids_length": (dict(axis_sizes={"data": 4}, dcn_axis="data",
                              slice_ids=[0, 1]), "slice_ids"),
    "dcn_not_among": (dict(axis_sizes={"data": 4}, dcn_axis="model",
                           slice_ids=[0, 0, 1, 1]), "not among"),
    "dcn_not_divisible": (dict(axis_sizes={"data": 1, "model": 4},
                               dcn_axis="data", slice_ids=[0, 0, 1, 1]),
                          "not divisible"),
    "uneven_slices": (dict(axis_sizes={"data": 2, "model": 2},
                           dcn_axis="data", slice_ids=[0, 0, 0, 1]),
                      "per slice"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_are_jax_errors(case):
    kw, match = ERRORS[case]
    sizes = kw.pop("axis_sizes")
    with pytest.raises(ValueError, match=match) as jax_err:
        jax_mesh.make_mesh(sizes, devices=jax.devices()[:4], **kw)
    with pytest.raises(ValueError, match=match) as port_err:
        port_mesh.device_grid(sizes, [0, 1, 2, 3], **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_axes_equal_jax_axes():
    assert port_mesh.AXES == jax_mesh.AXES
    assert port_mesh.AXES == ("data", "fsdp", "pipe", "seq", "expert",
                              "model")


def test_make_mesh_in_a_world1_group():
    import distributed_tpu_torch as dtt

    dtt.DataParallel(device="cpu")
    try:
        m = port_mesh.make_mesh({"model": 1, "data": 1}, device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert m.get_local_rank("model") == 0
        one = port_mesh.make_mesh(device_type="cpu", devices=[0])
        assert one.mesh_dim_names == ("data",)
    finally:
        dtt.cluster.shutdown()
