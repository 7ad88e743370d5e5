"""The port's status coalescer (runtime/coalesce.py) against the JAX
package's, on the CPU: every case of tests/test_coalesce.py but the two
that go through `build_manager` and the env contract, each run with the
same inputs through both packages' `merge_patches` and `StatusCoalescer`
(a recording client in place of the manager's fenced client), and the
results compared exactly: the merged dicts, the PATCHes each wrote (kind,
namespace, name, body) and the write and merge counts. Where threads race
(the concurrent patchers) what is compared is the bound both hold. Also a
seeded random walk of nested patches, merged on both sides."""
import copy
import random
import threading
import time
from types import SimpleNamespace

import pytest

import odh_kubeflow_tpu.api.notebook as j_notebook
import odh_kubeflow_tpu.apimachinery as j_am
import odh_kubeflow_tpu.runtime.coalesce as j_coalesce
import odh_kubeflow_tpu_torch.api.notebook as p_notebook
import odh_kubeflow_tpu_torch.apimachinery as p_am
import odh_kubeflow_tpu_torch.runtime.coalesce as p_coalesce

JAX = SimpleNamespace(name="jax", merge=j_coalesce.merge_patches, Coalescer=j_coalesce.StatusCoalescer,
                      Notebook=j_notebook.Notebook, Forbidden=j_am.ForbiddenError, NotFound=j_am.NotFoundError)
PORT = SimpleNamespace(name="port", merge=p_coalesce.merge_patches, Coalescer=p_coalesce.StatusCoalescer,
                       Notebook=p_notebook.Notebook, Forbidden=p_am.ForbiddenError, NotFound=p_am.NotFoundError)


class RecordingClient:
    """patch_status recorder standing in for the manager's fenced client;
    records the kind by name, so both sides' calls compare."""

    def __init__(self, error=None):
        self.calls = []
        self.error = error

    def patch_status(self, cls, namespace, name, patch):
        self.calls.append((cls.__name__, namespace, name, patch))
        if self.error is not None:
            raise self.error


def both(case):
    """case(side) on each package; asserts the results equal and returns
    the port's."""
    jax, port = case(JAX), case(PORT)
    assert jax == port, (jax, port)
    return port


def wait_writes(client, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while len(client.calls) < n and time.monotonic() < deadline:
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# merge semantics: zeros and nulls are values
# ---------------------------------------------------------------------------

MERGES = {
    "later wins recursively": ({"a": 1, "nest": {"x": 1, "y": 2}}, {"a": 2, "nest": {"y": 3, "z": 4}},
                               {"a": 2, "nest": {"x": 1, "y": 3, "z": 4}}),
    "owned zero and explicit null": (
        {"readyReplicas": 1, "tpu": {"hostsReady": 2}, "containerState": {"running": {}}},
        {"readyReplicas": 0, "tpu": {"hostsReady": 0}, "containerState": None},
        {"readyReplicas": 0, "tpu": {"hostsReady": 0}, "containerState": None}),
    "dict replaces scalar and back": ({"a": {"x": 1}, "b": 2}, {"a": 3, "b": {"y": 4}}, {"a": 3, "b": {"y": 4}}),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_merge_patches_match(case):
    base, overlay, want = MERGES[case]

    def run(side):
        merged = side.merge(copy.deepcopy(base), overlay)
        return merged, "containerState" in merged

    merged, has_state = both(run)
    assert merged == want and (has_state or "containerState" not in want)


def _random_patch(rng, depth=0):
    out = {}
    for _ in range(rng.randint(1, 4)):
        key = rng.choice("abcdef")
        roll = rng.random()
        if roll < 0.3 and depth < 3:
            out[key] = _random_patch(rng, depth + 1)
        elif roll < 0.45:
            out[key] = None
        elif roll < 0.6:
            out[key] = 0
        elif roll < 0.7:
            out[key] = []
        else:
            out[key] = rng.randint(-5, 5)
    return out


def test_a_seeded_walk_of_nested_patches_merges_alike():
    """200 patches from one seed, merged one by one into one base on each
    side: equal after every step."""
    rng = random.Random(0xC0A1)
    patches = [_random_patch(rng) for _ in range(200)]

    def run(side):
        base, steps = {}, []
        for patch in patches:
            side.merge(base, patch)
            steps.append(repr(base))
        return steps

    steps = both(run)
    assert len(set(steps)) > 50, "the walk barely moved"


# ---------------------------------------------------------------------------
# the write-rate regression: one PATCH per object per window
# ---------------------------------------------------------------------------


def test_burst_coalesces_to_leading_edge_plus_one_flush():
    def run(side):
        client = RecordingClient()
        co = side.Coalescer(client, window_s=0.15)
        co.start()
        try:
            co.patch_status(side.Notebook, "ns", "nb", {"readyReplicas": 1})
            for i in range(2, 10):
                co.patch_status(side.Notebook, "ns", "nb", {"readyReplicas": i % 2})
            co.patch_status(side.Notebook, "ns", "nb",
                            {"readyReplicas": 0, "containerState": None, "tpu": {"hostsReady": 0}})
            leading = list(client.calls)
            wait_writes(client, 2)
            return leading, list(client.calls), co.writes, co.coalesced
        finally:
            co.stop()

    leading, calls, writes, coalesced = both(run)
    assert leading == [("Notebook", "ns", "nb", {"readyReplicas": 1})]
    assert len(calls) == 2 and writes == 2 and coalesced == 8
    assert calls[1][3] == {"readyReplicas": 0, "containerState": None, "tpu": {"hostsReady": 0}}


def test_distinct_objects_do_not_coalesce_together():
    def run(side):
        client = RecordingClient()
        co = side.Coalescer(client, window_s=0.1)
        co.start()
        try:
            co.patch_status(side.Notebook, "ns", "a", {"readyReplicas": 1})
            co.patch_status(side.Notebook, "ns", "b", {"readyReplicas": 1})
            return list(client.calls)
        finally:
            co.stop()

    calls = both(run)
    assert [c[2] for c in calls] == ["a", "b"]


def test_zero_window_writes_straight_through():
    def run(side):
        client = RecordingClient()
        co = side.Coalescer(client, window_s=0.0)
        for i in range(5):
            co.patch_status(side.Notebook, "ns", "nb", {"readyReplicas": i})
        return list(client.calls), co.coalesced

    calls, coalesced = both(run)
    assert [c[3]["readyReplicas"] for c in calls] == [0, 1, 2, 3, 4] and coalesced == 0


def test_stop_flushes_pending():
    def run(side):
        client = RecordingClient()
        co = side.Coalescer(client, window_s=30.0)  # a window far beyond the test
        co.start()
        co.patch_status(side.Notebook, "ns", "nb", {"readyReplicas": 1})
        co.patch_status(side.Notebook, "ns", "nb", {"readyReplicas": 0})
        before = list(client.calls)
        t0 = time.monotonic()
        co.stop()  # must not wait out the window
        return before, list(client.calls), time.monotonic() - t0 < 5.0

    before, after, quick = both(run)
    assert len(before) == 1 and after[1][3] == {"readyReplicas": 0} and quick


def test_fenced_or_gone_flush_dropped_not_retried():
    """Fence closed between park and flush, or the object gone: the
    write is dropped (the new leader re-mirrors), never retried or
    raised."""
    def run(side):
        out = []
        for error in (side.Forbidden("write fenced"), side.NotFound("gone")):
            client = RecordingClient(error=error)
            co = side.Coalescer(client, window_s=0.0)
            co.patch_status(side.Notebook, "ns", "nb", {"readyReplicas": 1})
            out.append((len(client.calls), co.writes))
        return out

    assert both(run) == [(1, 1), (1, 1)]


def test_concurrent_patchers_one_flush():
    """Racing mirror threads on one object still write a bounded number of
    times: the leading edge and at most one flush per window (one more of
    slack), every patch either written or merged."""
    def run(side):
        client = RecordingClient()
        co = side.Coalescer(client, window_s=0.2)
        co.start()
        try:
            threads = [threading.Thread(target=co.patch_status,
                                        args=(side.Notebook, "ns", "nb", {"readyReplicas": i % 2}))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(5)
            deadline = time.monotonic() + 5
            while co.writes < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            return co.writes <= 3, co.writes + co.coalesced
        finally:
            co.stop()

    assert both(run) == (True, 16)
