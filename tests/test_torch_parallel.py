"""The port's parallel layer (odh_kubeflow_tpu_torch/parallel) against the
JAX package's on the CPU: mesh plans, logical-axis specs, the bring-up
from the webhook's env, and each rank's mesh coordinates, groups and batch
block against the JAX NamedSharding's shard on the conftest's virtual
8-device mesh (device i there is rank i here).

The multi-process cases run on spawned ranks over gloo (tests/torch_dist.py:
several cases per spawn, a timeout on every init and on the wait).
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_dist
import torch_threads
from odh_kubeflow_tpu.parallel import MeshPlan as JaxMeshPlan
from odh_kubeflow_tpu.parallel import initialize_from_env as jax_initialize_from_env
from odh_kubeflow_tpu.parallel.mesh import batch_spec as jax_batch_spec
from odh_kubeflow_tpu.parallel.mesh import logical_to_spec as jax_logical_to_spec
from odh_kubeflow_tpu_torch.parallel import (
    AXES,
    MeshPlan,
    batch_spec,
    initialize_from_env,
    logical_to_spec,
    rank_device,
)
from odh_kubeflow_tpu_torch.parallel import distributed
from odh_kubeflow_tpu_torch.parallel.mesh import GROUP_AXES

torch_threads.cap()

WEBHOOK_ENV = ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "TPU_WORKER_ID", "JAX_COORDINATOR_ADDRESS",
               "TPU_WORKER_HOSTNAMES")
WANTS = [(sp, tp, ep, pp, fsdp) for sp in (1, 2, 4, 8) for tp in (1, 2, 3) for ep in (1, 2)
         for pp in (1, 2) for fsdp in (True, False)]
# the plans of the multi-process mesh cases, by world
MESH_CASES = {
    2: [dict(sp=2), dict(fsdp=2), dict(dp=2)],
    4: [dict(sp=4), dict(dp=2, sp=2), dict(fsdp=2, sp=2), dict(dp=2, fsdp=2)],
}
# meshes over a sub-group of the world of 4 (plan, the ranks in grid order),
# against the JAX mesh over the same devices
SUB_MESH_CASES = [(dict(sp=2), (0, 1)), (dict(dp=2), (2, 3)), (dict(fsdp=2), (3, 1)), (dict(sp=1), (2,))]
LOGICAL = [("batch", "seq"), ("batch",), ("embed", "heads", "head_dim"), ("vocab", "embed"),
           ("layers", "embed", "mlp"), ("expert", None, "embed"), ("stage", "layers"),
           ("batch", "seq", "kv_heads", "head_dim"), (None, "seq"), ("norm",)]
SPEC_PLANS = [dict(), dict(fsdp=2, tp=2, sp=2), dict(sp=8), dict(dp=2, fsdp=4), dict(dp=2, sp=4),
              dict(ep=2, pp=2, tp=2), dict(dp=2, fsdp=2, sp=2)]


@pytest.fixture
def clean_env(monkeypatch):
    for name in WEBHOOK_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_mesh_plan_auto_matches_reference(n):
    for sp, tp, ep, pp, fsdp in WANTS:
        want = JaxMeshPlan.auto(n, want_sp=sp, want_tp=tp, want_ep=ep, want_pp=pp, prefer_fsdp=fsdp)
        got = MeshPlan.auto(n, want_sp=sp, want_tp=tp, want_ep=ep, want_pp=pp, prefer_fsdp=fsdp)
        assert got.sizes() == want.sizes(), (n, sp, tp, ep, pp, fsdp)
        assert got.n_devices == want.n_devices == n


def test_mesh_axes_and_sizes_match_reference():
    from odh_kubeflow_tpu.parallel.mesh import AXES as JAX_AXES
    from odh_kubeflow_tpu.parallel.mesh import RULES as JAX_RULES
    from odh_kubeflow_tpu_torch.parallel.mesh import RULES

    assert AXES == JAX_AXES and RULES == JAX_RULES
    plan = MeshPlan(fsdp=2, tp=2, sp=2)
    assert plan.sizes() == JaxMeshPlan(fsdp=2, tp=2, sp=2).sizes()
    jmesh = JaxMeshPlan(fsdp=2, tp=2, sp=2).build(jax.devices())
    assert tuple(plan.sizes()[a] for a in AXES) == jmesh.devices.shape


def test_single_device_mesh_builds_without_a_process_group():
    mesh = MeshPlan().build("cpu")
    assert mesh.device == torch.device("cpu") and mesh.coords == {a: 0 for a in AXES}
    assert mesh.group("sp") == (None, [0]) and mesh.index(("dp", "fsdp")) == 0
    with pytest.raises(ValueError, match="needs 2 ranks, got a world of 1"):
        MeshPlan(sp=2).build("cpu")


@pytest.mark.parametrize("plan", SPEC_PLANS, ids=lambda p: "-".join(f"{k}{v}" for k, v in p.items()) or "one")
def test_logical_to_spec_matches_reference(plan):
    n = MeshPlan(**plan).n_devices
    jmesh = JaxMeshPlan(**plan).build(jax.devices()[:n])
    port_mesh = types.SimpleNamespace(sizes=MeshPlan(**plan).sizes())
    for axes in LOGICAL:
        assert logical_to_spec(axes, port_mesh) == tuple(jax_logical_to_spec(axes, jmesh)), axes
        assert logical_to_spec(axes) == tuple(jax_logical_to_spec(axes)), axes
    for with_seq in (True, False):
        assert batch_spec(port_mesh, with_seq) == tuple(jax_batch_spec(jmesh, with_seq))
    with pytest.raises(KeyError, match="unknown logical axis"):
        logical_to_spec(("tokens",), port_mesh)


def test_initialize_from_env_is_a_noop_on_one_process(clean_env):
    assert initialize_from_env(device="cpu") == jax_initialize_from_env() == (0, 1)
    clean_env.setenv("JAX_NUM_PROCESSES", "1")
    assert initialize_from_env(device="cpu") == jax_initialize_from_env() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_initialize_from_env_missing_coordinator_raises_like_reference(clean_env):
    clean_env.setenv("JAX_NUM_PROCESSES", "2")
    clean_env.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(RuntimeError) as want:
        jax_initialize_from_env()
    with pytest.raises(RuntimeError) as got:
        initialize_from_env(device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cpu", "nccl")])
def test_initialize_from_env_coordinator_from_the_host_roster(clean_env, device, backend):
    """Without JAX_COORDINATOR_ADDRESS the coordinator is the roster's first
    host on COORDINATOR_PORT, and the rank is TPU_WORKER_ID: the same
    address, rank and world the reference hands jax.distributed."""
    clean_env.setenv("JAX_NUM_PROCESSES", "2")
    clean_env.setenv("TPU_WORKER_ID", "1")
    clean_env.setenv("TPU_WORKER_HOSTNAMES", "nb-0.svc.ns.svc.cluster.local,nb-1.svc.ns.svc.cluster.local")
    seen = {}
    clean_env.setattr(jax.distributed, "initialize", lambda **kw: seen.setdefault("jax", kw))
    clean_env.setattr(jax.distributed, "is_initialized", lambda: False)
    clean_env.setattr(torch.distributed, "is_initialized", lambda: False)
    clean_env.setattr(torch.distributed, "init_process_group", lambda **kw: seen.setdefault("torch", kw))
    if backend == "nccl":
        clean_env.setattr(torch.cuda, "set_device", lambda d: seen.setdefault("device", d))
        clean_env.setattr(distributed, "rank_device", lambda device: torch.device("cuda", 1))
    assert jax_initialize_from_env() == (1, 2)
    assert initialize_from_env(timeout_s=7, backend=backend, device=device) == (1, 2)
    jax_kw, kw = seen["jax"], seen["torch"]
    assert kw["init_method"] == "tcp://" + jax_kw["coordinator_address"]
    assert jax_kw["coordinator_address"] == f"nb-0.svc.ns.svc.cluster.local:{distributed.COORDINATOR_PORT}"
    assert (kw["rank"], kw["world_size"]) == (jax_kw["process_id"], jax_kw["num_processes"])
    assert kw["backend"] == backend and kw["timeout"].total_seconds() == 7
    if backend == "nccl":  # the rank's card is made current before an NCCL group
        assert seen["device"] == torch.device("cuda", 1)


def test_backend_and_rank_device_defaults(clean_env):
    assert distributed.default_backend("cuda") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"
    assert rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rank_device("cuda")


@pytest.fixture(scope="module")
def ranks():
    """Both worlds' multi-process results: each plan's mesh case, and at
    world 2 the bring-up case last (it re-initializes the group)."""
    rng = np.random.default_rng(0)
    arrays = {"tokens": rng.integers(0, 100, (4, 8)), "mask": rng.random((4, 8)).astype(np.float32),
              "x": rng.standard_normal((4, 8, 3)).astype(np.float32)}
    out = {}
    for world, plans in MESH_CASES.items():
        cases = [(f"mesh {i}", "torch_sp_cases:mesh_case", {"plan": plan, "arrays": arrays})
                 for i, plan in enumerate(plans)]
        if world == 4:
            cases += [(f"sub mesh {i}", "torch_sp_cases:sub_mesh_case",
                       {"plan": plan, "members": members, "arrays": arrays})
                      for i, (plan, members) in enumerate(SUB_MESH_CASES)]
        if world == 2:
            cases.append(("bringup", "torch_sp_cases:bringup_case", {"repaired_port": torch_dist.free_port()}))
        out[world] = torch_dist.run_ranks(world, cases)
    return arrays, out


def test_two_rank_bringup_from_webhook_env(ranks):
    for r, got in enumerate(ranks[1][2]["bringup"]):
        assert got["first"] == (r, 2, "gloo")
        assert got["again"] == (r, 2)  # idempotent: the live group as it is
        assert got["sum"] == 3.0
        assert got["repaired"] == (r, 2) and got["sum_after"] == 3.0 and got["initialized"]


@pytest.mark.parametrize("world,i", [(w, i) for w, plans in MESH_CASES.items() for i in range(len(plans))])
def test_rank_mesh_and_batch_block_match_reference(ranks, world, i):
    arrays, out = ranks
    plan = MESH_CASES[world][i]
    jmesh = JaxMeshPlan(**plan).build(jax.devices()[:world])
    shape = tuple(MeshPlan(**plan).sizes()[a] for a in AXES)
    for r, got in enumerate(out[world][f"mesh {i}"]):
        assert got["coords"] == dict(zip(AXES, map(int, np.unravel_index(r, shape))))
        assert jmesh.devices.reshape(-1)[r].id == jax.devices()[r].id
        for name, x in arrays.items():
            spec = jax_logical_to_spec(["batch", "seq", None][: x.ndim], jmesh)
            sharded = jax.device_put(x, NamedSharding(jmesh, spec))
            want = next(s.data for s in sharded.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(got["blocks"][name], np.asarray(want), err_msg=f"{plan} {name}")
        # every rank sums the same bits; the bf16 input is summed in f32
        np.testing.assert_array_equal(got["sum"][0], np.full(3, sum(range(world)), np.float32))
        np.testing.assert_array_equal(got["sum"][1], np.full(2, world, np.float32))


@pytest.mark.parametrize("world", sorted(MESH_CASES))
def test_rank_groups_follow_the_reference_axis_order(ranks, world):
    """A group holds the ranks that differ only along its axes, in index
    order; tp/sp innermost, as the reference's device grid."""
    _, out = ranks
    for i, plan in enumerate(MESH_CASES[world]):
        sizes = MeshPlan(**plan).sizes()
        grid = np.arange(world).reshape([sizes[a] for a in AXES])
        for r, got in enumerate(out[world][f"mesh {i}"]):
            coords = got["coords"]
            for axes, ranks_ in got["groups"].items():
                axes = (axes,) if isinstance(axes, str) else axes
                live = [a for a in AXES if a in axes and sizes[a] > 1]
                index = tuple(slice(None) if a in live else coords[a] for a in AXES)
                want = grid[index].reshape(-1).tolist() if live else [r]
                assert ranks_ == want, (plan, axes)
            # process groups for GROUP_AXES only (the ring, tp, fsdp, the
            # sharded params' gradient sum, the replica), each with its ranks
            assert set(got["built"]) == set(GROUP_AXES)
            for axes, ranks_ in got["built"].items():
                live = [a for a in AXES if a in axes and sizes[a] > 1]
                index = tuple(slice(None) if a in live else coords[a] for a in AXES)
                assert ranks_ == (grid[index].reshape(-1).tolist() if live else [r]), (plan, axes)
            assert got["index_batch"] == coords["dp"] * sizes["fsdp"] + coords["fsdp"]
            ring = got["groups"]["sp"] if sizes["sp"] > 1 else got["groups"][("dp", "fsdp", "sp")]
            prev = ring[(ring.index(r) - 1) % len(ring)]
            assert got["shift"][0].tolist() == [prev]


@pytest.mark.parametrize("i", range(len(SUB_MESH_CASES)))
def test_a_mesh_over_a_sub_group_matches_the_jax_mesh_over_those_devices(ranks, i):
    """`MeshPlan.build(ranks=...)` over some ranks of a world of 4 against
    the JAX mesh built over the same devices: each member's coordinates and
    batch block are those of its device in the JAX mesh, its groups hold
    the members that differ only along their axes, its sums and its ring
    stay among the members; the other ranks get no mesh."""
    arrays, out = ranks
    plan, members = SUB_MESH_CASES[i]
    devices = [jax.devices()[r] for r in members]
    jmesh = JaxMeshPlan(**plan).build(devices)
    sizes = MeshPlan(**plan).sizes()
    grid = np.asarray(members).reshape([sizes[a] for a in AXES])
    for r, got in enumerate(out[4][f"sub mesh {i}"]):
        if r not in members:
            assert got is None, (r, got)
            continue
        position = members.index(r)
        assert jmesh.devices.reshape(-1)[position].id == jax.devices()[r].id
        assert got["coords"] == dict(zip(AXES, map(int, np.unravel_index(position, grid.shape))))
        assert got["world"] == len(members)
        for axes, ranks_ in got["built"].items():
            live = [a for a in AXES if a in axes and sizes[a] > 1]
            index = tuple(slice(None) if a in live else got["coords"][a] for a in AXES)
            assert ranks_ == (grid[index].reshape(-1).tolist() if live else [r]), (plan, axes)
        for name, x in arrays.items():
            spec = jax_logical_to_spec(["batch", "seq", None][: x.ndim], jmesh)
            sharded = jax.device_put(x, NamedSharding(jmesh, spec))
            want = next(s.data for s in sharded.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(got["blocks"][name], np.asarray(want), err_msg=f"{plan} {name}")
        replica = got["built"][("dp", "fsdp", "sp")]
        np.testing.assert_array_equal(got["sum"], np.full(3, sum(replica), np.float32))
        ring = got["built"][("sp",)] if sizes["sp"] > 1 else replica
        assert got["shift"].tolist() == [ring[(ring.index(r) - 1) % len(ring)]]
