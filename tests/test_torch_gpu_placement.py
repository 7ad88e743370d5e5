"""A GPU slice's pods select their pool's slice shape (`gpu.GPU_TOPOLOGY_LABEL`
on the nodes of `SimCluster.add_gpu_pool`, and in `SliceShape.node_selector`),
as the reference's TPU pods select the pool's topology label: a one-host pod
of 4 cards, which fits a node of a 2x4 pool by its cards, stays Pending
while only 2x4 pools exist, and binds once a 1x4 pool joins."""
import time

import torch_threads
from odh_kubeflow_tpu_torch.api.core import Container, Pod, ResourceRequirements, Toleration
from odh_kubeflow_tpu_torch.cluster import SimCluster
from odh_kubeflow_tpu_torch.gpu import GKE_NODEPOOL_LABEL, GPU_RESOURCE, plan_slice

torch_threads.cap()


def test_a_one_host_pod_never_lands_on_a_multi_host_pool():
    shape = plan_slice("h100", topology="1x4")
    cluster = SimCluster().start()
    try:
        cluster.add_gpu_pool("multi", "h100", "2x4", slices=2)
        pod = Pod()
        pod.metadata.name, pod.metadata.namespace = "nb-0", "user"
        pod.spec.node_selector = shape.node_selector()
        pod.spec.tolerations = [Toleration(key=GPU_RESOURCE, operator="Exists", effect="NoSchedule")]
        cards = {GPU_RESOURCE: str(shape.chips_per_host)}
        pod.spec.containers = [Container(name="nb", image="img:1",
                                         resources=ResourceRequirements(requests=cards, limits=dict(cards)))]
        cluster.client.create(pod)
        time.sleep(1.0)  # the scheduler's passes over the multi-host pools
        assert not cluster.client.get(Pod, "user", "nb-0").spec.node_name
        (node,) = cluster.add_gpu_pool("one", "h100", "1x4")
        deadline = time.monotonic() + 30
        while not cluster.client.get(Pod, "user", "nb-0").spec.node_name and time.monotonic() < deadline:
            time.sleep(0.02)
        bound = cluster.client.get(Pod, "user", "nb-0").spec.node_name
        assert bound == node.metadata.name and node.metadata.labels[GKE_NODEPOOL_LABEL] == "one", bound
    finally:
        cluster.stop()
