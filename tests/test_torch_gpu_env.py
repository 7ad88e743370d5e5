"""The port's GPU pod env (odh_kubeflow_tpu_torch/gpu/env.py) against the JAX
package's TPU env (odh_kubeflow_tpu/tpu/env.py): gpu_env at 1 x 1, 1 x 8 and
2 x 8 holds every name the port's bring-up (initialize_from_env,
rank_device, torchrun's PET_* defaults) and probe agent read, with the
values the slice implies; the roster, the master address and the ordinal
env's field path are the reference's; no JAX, PJRT or JAX_PLATFORMS name
is emitted."""
import pytest

import torch_threads
from odh_kubeflow_tpu.tpu import ordinal_env as jax_ordinal_env
from odh_kubeflow_tpu.tpu import plan_slice as jax_plan_slice
from odh_kubeflow_tpu.tpu import pod_dns as jax_pod_dns
from odh_kubeflow_tpu.tpu import tpu_env
from odh_kubeflow_tpu_torch.gpu import COORDINATOR_PORT, gpu_env, ordinal_env, plan_slice, pod_dns, slice_from_env
from odh_kubeflow_tpu_torch.parallel import distributed

torch_threads.cap()

NAME, SVC, NS = "nb", "nb-hosts", "user"
SHAPES = {"1x1": (1, 1), "1x8": (1, 8), "2x8": (2, 8)}


def _env(topology):
    return {e["name"]: e["value"] for e in gpu_env(plan_slice("h100", topology=topology), NAME, SVC, NS)}


@pytest.mark.parametrize("topology", SHAPES)
def test_gpu_env_names_and_values(topology):
    hosts, cards = SHAPES[topology]
    env = _env(topology)
    # the probe agent's names (probe/agent.py): cards over hosts
    assert env["NB_TPU_HOSTS"] == str(hosts) and env["NB_TPU_CHIPS_EXPECTED"] == str(hosts * cards)
    # torchrun's defaults: one process per card, one node per host
    assert env["PET_NNODES"] == str(hosts) and env["PET_NPROC_PER_NODE"] == str(cards)
    roster = env["TPU_WORKER_HOSTNAMES"].split(",")
    assert roster == [pod_dns(NAME, i, SVC, NS, "cluster.local") for i in range(hosts)]
    assert slice_from_env(env) == plan_slice("h100", topology=topology)
    if hosts > 1:  # static rendezvous at the ordinal-0 pod, as the reference's coordinator
        assert env["PET_MASTER_ADDR"] == roster[0] and env["PET_MASTER_PORT"] == str(COORDINATOR_PORT)
        assert "PET_STANDALONE" not in env
    else:  # torchrun's own rendezvous on a free loopback port
        assert env["PET_STANDALONE"] == "1"
        assert "PET_MASTER_ADDR" not in env and "PET_MASTER_PORT" not in env
    assert not [n for n in env if n.startswith(("JAX_", "PJRT_", "XLA_"))]


def test_names_equal_the_reference():
    """The roster, the master address and port, and the names both envs
    share, against tpu_env of a TPU slice with as many hosts."""
    ref = {e["name"]: e["value"] for e in tpu_env(jax_plan_slice("v5p", topology="2x2x2"), NAME, SVC, NS)}
    env = _env("2x8")
    assert env["TPU_WORKER_HOSTNAMES"] == ref["TPU_WORKER_HOSTNAMES"]
    assert env["NB_TPU_HOSTS"] == ref["NB_TPU_HOSTS"] == "2"
    assert env["PET_MASTER_ADDR"] == jax_pod_dns(NAME, 0, SVC, NS, "cluster.local")
    assert f"{env['PET_MASTER_ADDR']}:{env['PET_MASTER_PORT']}" == ref["JAX_COORDINATOR_ADDRESS"]
    shared = set(env) & set(ref)
    assert shared == {"TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY", "TPU_WORKER_HOSTNAMES", "NB_TPU_HOSTS",
                      "NB_TPU_CHIPS_EXPECTED"}
    # one copy of the port: bring-up's fallback coordinator is this port
    assert distributed.COORDINATOR_PORT == COORDINATOR_PORT == 8476


def test_ordinal_env_has_the_reference_field_path():
    want = {e["valueFrom"]["fieldRef"]["fieldPath"] for e in jax_ordinal_env()}
    got = ordinal_env()
    assert [e["name"] for e in got] == ["PET_NODE_RANK"]
    assert {e["valueFrom"]["fieldRef"]["fieldPath"] for e in got} == want


def test_cluster_domain_reaches_every_address():
    shape = plan_slice("h100", topology="2x2")
    env = {e["name"]: e["value"] for e in gpu_env(shape, NAME, SVC, NS, "corp.internal")}
    assert env["PET_MASTER_ADDR"] == "nb-0.nb-hosts.user.svc.corp.internal"
    assert env["TPU_WORKER_HOSTNAMES"].endswith("nb-1.nb-hosts.user.svc.corp.internal")


@pytest.mark.parametrize("topology", SHAPES)
def test_torchrun_reads_its_arguments_from_the_env(topology, monkeypatch):
    """torchrun's own parser, given no flag, takes the slice's numbers from
    the rendered env (and the node rank from the ordinal env's value)."""
    from torch.distributed import run

    hosts, cards = SHAPES[topology]
    for name, value in _env(topology).items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("PET_NODE_RANK", str(hosts - 1))
    args = run.parse_args(["worker.py"])
    assert (args.nnodes, args.nproc_per_node, args.standalone) == (str(hosts), str(cards), hosts == 1)
    if hosts > 1:
        assert (args.master_addr, args.master_port, args.node_rank) == (
            pod_dns(NAME, 0, SVC, NS, "cluster.local"), COORDINATOR_PORT, hosts - 1)
        assert args.rdzv_backend == "static"
