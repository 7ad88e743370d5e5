"""The port's GPU slice planner (odh_kubeflow_tpu_torch/gpu/topology.py)
against the JAX package's TPU planner (odh_kubeflow_tpu/tpu/topology.py):
the same rules on each package's own accelerators (both of topology and
chips refused, neither planning one host, a chip count planning the
smallest shape that holds it, multi-host slices of whole hosts, unknown
accelerators refused, each with the package's own InvalidError), and the
h100 table and its "HOSTSxCARDS" topologies pinned."""
import pytest

import torch_threads
from odh_kubeflow_tpu.apimachinery import InvalidError as JaxInvalidError
from odh_kubeflow_tpu.tpu import plan_slice as jax_plan_slice
from odh_kubeflow_tpu_torch.apimachinery import InvalidError
from odh_kubeflow_tpu_torch.gpu import (GENERATIONS, GKE_GPU_ACCELERATOR_LABEL, GPU_RESOURCE, plan_slice,
                                        slice_from_env)

torch_threads.cap()

SHAPE_FIELDS = ("accelerator", "topology", "chips", "hosts", "chips_per_host", "multi_host")


def test_h100_table_pinned():
    assert list(GENERATIONS) == ["h100"]
    gen = GENERATIONS["h100"]
    assert (gen.gke_accelerator, gen.machine_shapes, gen.chips_per_host, gen.max_chips) == (
        "nvidia-h100-80gb", (1, 2, 4, 8), 8, 256)
    assert GPU_RESOURCE == "nvidia.com/gpu"


@pytest.mark.parametrize("topology,want", [
    ("1x1", (1, 1, 1, False)), ("1x2", (2, 1, 2, False)), ("1x4", (4, 1, 4, False)),
    ("1x8", (8, 1, 8, False)), ("2x2", (4, 2, 2, True)), ("2x8", (16, 2, 8, True)),
    ("4x8", (32, 4, 8, True)), ("32x8", (256, 32, 8, True)), ("3X4", (12, 3, 4, True)),
])
def test_topologies_pinned(topology, want):
    s = plan_slice("h100", topology=topology)
    assert (s.chips, s.hosts, s.chips_per_host, s.multi_host) == want
    assert s.topology == topology.lower()
    assert s.accelerator_type == f"h100-{want[0]}"
    assert s.node_selector() == {GKE_GPU_ACCELERATOR_LABEL: "nvidia-h100-80gb"}
    # the fields a reader of the reference finds on its SliceShape
    ref = jax_plan_slice("v5p", topology="2x2x4")
    assert all(hasattr(s, f) and hasattr(ref, f) for f in SHAPE_FIELDS)


@pytest.mark.parametrize("chips,want", [(1, "1x1"), (2, "1x2"), (3, "1x4"), (5, "1x8"), (8, "1x8"),
                                        (9, "2x8"), (16, "2x8"), (17, "3x8"), (256, "32x8")])
def test_chips_plan_the_smallest_slice_that_holds_them(chips, want):
    assert plan_slice("h100", chips=chips).topology == want


@pytest.mark.parametrize("kw", [dict(topology="2x3"), dict(topology="2x16"), dict(topology="0x8"),
                                dict(topology="2x2x2"), dict(topology="banana"), dict(chips=257),
                                dict(topology="33x8"), dict(chips=-1)])
def test_invalid_gpu_inputs(kw):
    with pytest.raises(InvalidError):
        plan_slice("h100", **kw)


def test_rules_equal_the_reference():
    """The same rule in both planners, each on its own accelerators."""
    # both topology and chips: refused by both, with the same message
    with pytest.raises(JaxInvalidError) as want:
        jax_plan_slice("v5p", topology="2x2x2", chips=8)
    with pytest.raises(InvalidError) as got:
        plan_slice("h100", topology="1x8", chips=8)
    assert str(got.value) == str(want.value)
    assert got.value.code == want.value.code == 422 and got.value.reason == want.value.reason
    # an unknown accelerator: refused by both, naming the valid ones
    for name in ("b200", "a100", "v7x"):
        with pytest.raises(JaxInvalidError, match="valid"):
            jax_plan_slice(name)
        with pytest.raises(InvalidError, match=r"valid: \['h100'\]"):
            plan_slice(name)
    # each package refuses the other's accelerators
    with pytest.raises(InvalidError):
        plan_slice("v5p")
    with pytest.raises(JaxInvalidError):
        jax_plan_slice("h100")
    # neither: one host in both
    for s in (jax_plan_slice("v5e"), jax_plan_slice("v5p"), plan_slice("h100")):
        assert s.hosts == 1 and not s.multi_host and s.chips == s.chips_per_host
    # a count: the smallest shape that holds it, single host while it fits
    for plan, acc, largest in ((jax_plan_slice, "v5e", 8), (plan_slice, "h100", 8)):
        for chips in range(1, largest + 1):
            s = plan(acc, chips=chips)
            assert s.hosts == 1 and s.chips >= chips
            assert s.chips < 2 * chips  # the smallest: doubling shapes
    # past one host: whole hosts, hosts = chips / chips per host
    for s in (jax_plan_slice("v5p", chips=10), jax_plan_slice("v5e", chips=16), plan_slice("h100", chips=10),
              plan_slice("h100", chips=24)):
        assert s.multi_host and s.chips == s.hosts * s.chips_per_host
    # past the generation's ceiling: refused by both
    with pytest.raises(JaxInvalidError, match="max"):
        jax_plan_slice("v5e", chips=100000)
    with pytest.raises(InvalidError, match="max"):
        plan_slice("h100", chips=100000)


def test_slice_from_env_reads_the_rendered_plan():
    s = plan_slice("h100", topology="2x8")
    assert slice_from_env({"TPU_ACCELERATOR_TYPE": s.accelerator_type, "TPU_TOPOLOGY": s.topology}) == s
    with pytest.raises(InvalidError, match="not set"):
        slice_from_env({})
