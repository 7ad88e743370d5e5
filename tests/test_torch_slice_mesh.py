"""The port's slice_mesh_axes (odh_kubeflow_tpu_torch/parallel/distributed.py)
against the JAX package's (odh_kubeflow_tpu/parallel/distributed.py), as
tests/test_parallel.py's test_slice_mesh_axes_defaults_tp_to_host_chips
checks it: for slices with the same chips and chips per host (a TPU slice
and an H100 slice), at want_sp 1, 2 and 4 and an explicit tp, the MeshPlan
sizes are equal; tp defaults to one host's devices; and at sp 1 each tp
group is one host's ranks (torchrun numbers a host's ranks consecutively),
the same device ids as the JAX mesh's tp rows on the virtual 8-device
mesh."""
import jax
import numpy as np
import pytest

import torch_threads
from odh_kubeflow_tpu.parallel import slice_mesh_axes as jax_slice_mesh_axes
from odh_kubeflow_tpu.tpu import plan_slice as jax_plan_slice
from odh_kubeflow_tpu_torch.gpu import plan_slice
from odh_kubeflow_tpu_torch.parallel import slice_mesh_axes
from odh_kubeflow_tpu_torch.parallel.mesh import AXES

torch_threads.cap()

# (TPU slice, H100 slice) of the same chips and chips per host
PAIRS = [(("v5e", "1x1"), "1x1"), (("v5e", "2x2"), "1x4"), (("v5e", "2x4"), "1x8"),
         (("v5p", "2x2x2"), "2x4"), (("v5p", "2x2x4"), "4x4"), (("v5e", "4x4"), "4x4"),
         (("v5e", "8x8"), "16x4")]


def _tp_rows(sizes):
    """Each tp group's ranks: the rows of the rank grid along tp."""
    shape = tuple(sizes[a] for a in AXES)
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    t = AXES.index("tp")
    return [list(map(int, row)) for row in np.moveaxis(grid, t, -1).reshape(-1, shape[t])]


@pytest.mark.parametrize("want_tp", [0, 2])
@pytest.mark.parametrize("want_sp", [1, 2, 4])
@pytest.mark.parametrize("tpu,gpu", PAIRS, ids=[g for _, g in PAIRS])
def test_slice_mesh_axes_equals_the_reference(tpu, gpu, want_sp, want_tp):
    jax_shape, shape = jax_plan_slice(tpu[0], topology=tpu[1]), plan_slice("h100", topology=gpu)
    assert (shape.chips, shape.chips_per_host, shape.hosts) == (
        jax_shape.chips, jax_shape.chips_per_host, jax_shape.hosts)
    want = jax_slice_mesh_axes(jax_shape, want_sp=want_sp, want_tp=want_tp)
    got = slice_mesh_axes(shape, want_sp=want_sp, want_tp=want_tp)
    assert got.sizes() == want.sizes() and got.n_devices == shape.chips
    if want_tp == 0 and want_sp == 1:  # tp is one host's devices, and each group one host
        assert got.tp == shape.chips_per_host
        assert _tp_rows(got.sizes()) == [list(range(h * got.tp, (h + 1) * got.tp)) for h in range(shape.hosts)]


@pytest.mark.parametrize("tpu,gpu", [p for p in PAIRS if plan_slice("h100", topology=p[1]).chips <= 8],
                         ids=[g for _, g in PAIRS if plan_slice("h100", topology=g).chips <= 8])
def test_tp_groups_are_the_jax_mesh_tp_rows(tpu, gpu):
    shape = plan_slice("h100", topology=gpu)
    plan = jax_slice_mesh_axes(jax_plan_slice(tpu[0], topology=tpu[1]))
    jmesh = plan.build(jax.devices()[:shape.chips])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    t = list(jmesh.axis_names).index("tp")
    want = [list(map(int, row)) for row in np.moveaxis(ids, t, -1).reshape(-1, ids.shape[t])]
    assert _tp_rows(slice_mesh_axes(shape).sizes()) == want
