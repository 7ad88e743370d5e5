"""The port's continuous-batching engine and HTTP front
(odh_kubeflow_tpu_torch.serving) on the CPU, mirroring the engine half of
tests/test_serving.py on the same TINY config with weights converted from
the JAX init: greedy parity with JAX generate(), slot recycling,
backpressure, EOS, stop-cancel; plus the one-host-sync-per-burst contract,
an HTTP round trip on port 0, the engine contract a reference-shaped caller
relies on (submit's traceparent, superseded hedges, stats() keys), and the
device contract.
"""
import dataclasses
import inspect
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import generate as jax_generate
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.serving.engine import RequestHandle as JaxRequestHandle
from odh_kubeflow_tpu.serving.engine import ServingEngine as JaxEngine
from odh_kubeflow_tpu_torch.models import TransformerConfig, params_from_numpy
from odh_kubeflow_tpu_torch.ops import attention
from odh_kubeflow_tpu_torch.serving import metrics as M
from odh_kubeflow_tpu_torch.serving.engine import QueueFull, RequestHandle, ServingEngine
from odh_kubeflow_tpu_torch.serving.server import ServingHTTPServer, build_engine_from_env

TINY_JAX = JaxConfig(
    vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq=64, dtype=jnp.float32, use_flash=False, remat=False,
)
TINY = TransformerConfig(
    vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq=64, dtype=torch.float32, use_flash=True, remat=False,
)


@pytest.fixture(scope="module")
def tiny_model():
    jparams = jax_init_params(jax.random.PRNGKey(0), TINY_JAX)
    params = params_from_numpy(jax.device_get(jparams), torch.float32, device="cpu")
    return jparams, params


def engine(params, **kw):
    return ServingEngine(params, TINY, device="cpu", **kw)


def test_engine_greedy_parity_with_jax_generate(tiny_model):
    """Continuous batching changes scheduling, not numerics: with more
    requests than slots (recycling + mid-flight admission), every request's
    greedy tokens equal the JAX package's static generate()."""
    jparams, params = tiny_model
    eng = engine(params, max_slots=3, max_seq=64, max_queue_depth=16)
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16],
               [17, 18, 19, 20]]
    attention.reset_launch_counts()
    handles = [eng.submit(p, max_new=6) for p in prompts]
    assert eng.run_until_idle(timeout=120)
    ref = np.asarray(jax_generate(jparams, jnp.asarray(prompts, jnp.int32), TINY_JAX,
                                  max_new=6, max_seq=64))
    for h, row in zip(handles, ref):
        assert h.result == "ok"
        assert h.tokens == [int(t) for t in row], "greedy parity broken"
        assert h.ttft_s is not None and h.ttft_s >= 0
    # CPU tensors take the plain version: nothing launched
    assert attention.launch_counts["flash_fwd"] == 0


def test_engine_mixed_lengths_recycle_slots(tiny_model):
    _, params = tiny_model
    lengths = [2, 4, 8, 16]
    eng = engine(params, max_slots=2, max_seq=64, max_queue_depth=8, decode_burst=1)
    handles = [eng.submit([1, 2, 3], max_new=n) for n in lengths]
    while not eng.idle():
        eng.step()
    for h, n in zip(handles, lengths):
        assert h.result == "ok" and len(h.tokens) == n
    # static batching at 2 slots runs [2,4] and [8,16] to their longest
    # member: 4 + 16 = 20 decode steps; continuous batching backfills
    steps = eng.stats()["decode_steps"]
    assert steps < 20, f"continuous batching took {steps} steps (static: 20)"
    assert eng.stats()["generated_tokens"] == sum(lengths)


def test_engine_backpressure_rejects_past_queue_depth(tiny_model):
    _, params = tiny_model
    rejected0 = M.inference_requests_total.value(result="rejected")
    eng = engine(params, max_slots=1, max_seq=64, max_queue_depth=2)
    eng.submit([1], max_new=2)
    eng.submit([2], max_new=2)
    with pytest.raises(QueueFull):
        eng.submit([3], max_new=2)
    assert M.inference_requests_total.value(result="rejected") - rejected0 == 1
    assert eng.run_until_idle(timeout=60)
    # oversized or out-of-vocab requests are refused up front
    with pytest.raises(ValueError):
        eng.submit([1] * 60, max_new=10)
    with pytest.raises(ValueError):
        eng.submit([TINY.vocab], max_new=1)


def test_engine_eos_recycles_slot_early(tiny_model):
    _, params = tiny_model
    probe = engine(params, max_slots=1, max_seq=64)
    first = probe.submit([1, 2, 3, 4], max_new=1)
    assert probe.run_until_idle(timeout=60)
    eos = first.tokens[0]

    eng = engine(params, max_slots=1, max_seq=64, eos_id=eos)
    h = eng.submit([1, 2, 3, 4], max_new=32)
    assert eng.run_until_idle(timeout=60)
    assert h.result == "ok"
    assert h.tokens[-1] == eos
    assert len(h.tokens) < 32, "EOS did not stop the sequence early"


def test_engine_stop_cancels_fast(tiny_model):
    _, params = tiny_model
    canceled0 = M.inference_requests_total.value(result="canceled")
    eng = engine(params, max_slots=1, max_seq=64, max_queue_depth=8)
    handles = [eng.submit([1, 2], max_new=30) for _ in range(3)]
    eng.step()  # one slot active, two queued
    eng.stop(drain_timeout_s=0.0)
    assert all(h.done.is_set() for h in handles)
    assert M.inference_requests_total.value(result="canceled") - canceled0 >= 2


def test_engine_one_host_sync_per_burst(tiny_model):
    """The burst keeps its state on the device and copies it to the host
    once, however many slots and steps it ran."""
    _, params = tiny_model
    eng = engine(params, max_slots=4, max_seq=64, decode_burst=8)
    for p in ([1, 2, 3], [4, 5], [6], [7, 8, 9, 10]):
        eng.submit(p, max_new=20)
    eng.step()  # admits all four, then one burst
    assert eng.stats()["host_syncs_last_burst"] == 1
    assert eng.run_until_idle(timeout=60)
    stats = eng.stats()
    assert stats["host_syncs_last_burst"] == 1
    assert stats["generated_tokens"] == 80
    assert stats["metrics"]["inference_ttft_seconds"]["count"] >= 4


def test_engine_burst_matches_burst_of_one(tiny_model):
    """The burst's on-device bookkeeping (remaining, EOS, finished slots
    decoding garbage) gives the same tokens as stepping one at a time."""
    _, params = tiny_model
    prompts = [[3, 1, 4], [1, 5], [9, 2, 6, 5], [3, 5]]
    results = []
    for burst in (1, 5):
        eng = engine(params, max_slots=2, max_seq=64, decode_burst=burst)
        handles = [eng.submit(p, max_new=n) for p, n in zip(prompts, (7, 3, 11, 5))]
        assert eng.run_until_idle(timeout=60)
        results.append([h.tokens for h in handles])
    assert results[0] == results[1]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip_on_port_zero():
    eng = build_engine_from_env({"SERVING_MAX_SLOTS": "2", "SERVING_DECODE_BURST": "4"},
                                device="cpu")
    server = ServingHTTPServer(eng, host="127.0.0.1", port=0)
    host, port = server.start()
    eng.start()
    base = f"http://{host}:{port}"
    try:
        replies = {}

        def post(i):
            replies[i] = _post(base + "/generate", {"prompt": [i + 1, i + 2], "max_new": 3 + i})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i in range(4):
            status, body = replies[i]
            assert status == 200 and body["result"] == "ok"
            assert len(body["tokens"]) == 3 + i
        assert _post(base + "/generate", {"max_new": 2})[0] == 400
        assert _post(base + "/generate", {"prompt": [1] * 600, "max_new": 2})[0] == 400
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            assert resp.status == 200
        with urllib.request.urlopen(base + "/stats", timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["generated_tokens"] == 3 + 4 + 5 + 6
        assert stats["host_syncs_last_burst"] == 1
    finally:
        server.stop()


TRACEPARENT = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


def test_engine_contract_is_a_superset_of_the_reference(tiny_model):
    """A caller written for the reference's engine (its router, its bench)
    finds the same contract on the port's: submit's parameters in order,
    RequestHandle's fields and stats()'s keys are supersets of a tiny
    reference engine's on the CPU. A router's positional traceparent lands
    on the handle; the recompile counts are 0 (the eager engine compiles
    nothing) and host_transfers_last_burst is host_syncs_last_burst."""
    jparams, params = tiny_model
    ref = JaxEngine(jparams, TINY_JAX, max_slots=1, max_seq=64)
    eng = engine(params, max_slots=1, max_seq=64)
    want = list(inspect.signature(JaxEngine.submit).parameters)
    assert list(inspect.signature(ServingEngine.submit).parameters)[:len(want)] == want
    assert ({f.name for f in dataclasses.fields(JaxRequestHandle)}
            <= {f.name for f in dataclasses.fields(RequestHandle)})
    assert set(ref.stats()) <= set(eng.stats())
    handle = eng.submit([1, 2, 3], 3, TRACEPARENT)
    assert handle.traceparent == TRACEPARENT and not handle.superseded
    assert eng.submit([4], 2).traceparent is None
    assert eng.run_until_idle(timeout=60) and handle.result == "ok"
    stats = eng.stats()
    assert stats["decode_burst_recompiles"] == stats["prefill_recompiles"] == 0
    assert stats["host_transfers_last_burst"] == stats["host_syncs_last_burst"] == 1


def test_superseded_hedge_cancel_is_not_counted(tiny_model):
    """A router marks the loser of a hedged pair superseded before it
    cancels it: that cancellation leaves inference_requests_total alone
    (the winner counted the request), while a plain cancel still counts."""
    _, params = tiny_model
    eng = engine(params, max_slots=1, max_seq=64, max_queue_depth=8)
    hedge, plain = eng.submit([1, 2], 4, TRACEPARENT), eng.submit([3, 4], 4)
    canceled0 = M.inference_requests_total.value(result="canceled")
    hedge.superseded = True
    assert eng.cancel(hedge) and hedge.result == "canceled" and hedge.done.is_set()
    assert M.inference_requests_total.value(result="canceled") == canceled0
    assert eng.cancel(plain) and plain.result == "canceled"
    assert M.inference_requests_total.value(result="canceled") == canceled0 + 1


class _RecordingEngine:
    """An engine stand-in for the HTTP front: records each submit's
    arguments and completes the request at once."""

    def __init__(self):
        self.calls = []

    def submit(self, prompt, max_new, traceparent=None):
        self.calls.append((prompt, max_new, traceparent))
        handle = RequestHandle(id=len(self.calls), prompt=prompt, max_new=max_new, submitted=0.0,
                               traceparent=traceparent, tokens=[7] * max_new, result="ok")
        handle.done.set()
        return handle

    def stop(self, drain_timeout_s=0.0):
        pass


def test_http_front_passes_the_traceparent_header():
    eng = _RecordingEngine()
    server = ServingHTTPServer(eng, host="127.0.0.1", port=0)
    host, port = server.start()
    try:
        req = urllib.request.Request(f"http://{host}:{port}/generate",
                                     data=json.dumps({"prompt": [1, 2], "max_new": 2}).encode(),
                                     headers={"Content-Type": "application/json",
                                              "traceparent": TRACEPARENT})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200 and json.loads(resp.read())["tokens"] == [7, 7]
        assert _post(f"http://{host}:{port}/generate", {"prompt": [3], "max_new": 1})[0] == 200
    finally:
        server.stop()
    assert eng.calls == [([1, 2], 2, TRACEPARENT), ([3], 1, None)]


def test_checkpoint_restore_not_ported_yet(tmp_path):
    """Restore is ported (tests/test_torch_checkpoint.py serves from a
    checkpoint): what stays refused is a checkpoint without the model shape,
    and a checkpoint directory that holds no step never serves random
    weights."""
    with pytest.raises(RuntimeError, match="SERVING_MODEL_CONFIG"):
        build_engine_from_env({"SERVING_CHECKPOINT": "/ckpt"}, device="cpu")
    config = json.dumps({**{f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)},
                         "dtype": "float32"})
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        build_engine_from_env({"SERVING_CHECKPOINT": str(tmp_path / "none"),
                               "SERVING_MODEL_CONFIG": config}, device="cpu")
    assert not (tmp_path / "none").exists()


def test_default_device_raises_without_cuda(tiny_model):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    _, params = tiny_model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine_from_env({})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, TINY)
