"""The port's tracing and metric registry (odh_kubeflow_tpu_torch.utils.
tracing, utils.metrics) against the JAX package's (utils/tracing.py,
runtime/metrics.py) on the same inputs:

- traceparent parsing and formatting agree, header for header, on valid and
  malformed headers;
- span nesting, attach, record_span and the long-lived root API build the
  same parent links and attributes on both sides, and the listeners see
  every completed span;
- the serving, router, profile_*, breaker, flow-control and trace-root
  families have the same names, help, labels and buckets on both sides,
  and the same observations render byte-equal text.
"""
import pytest

import torch_threads
from odh_kubeflow_tpu.runtime import metrics as jax_metrics
from odh_kubeflow_tpu.serving import metrics as jax_serving_metrics
from odh_kubeflow_tpu.utils import profiler as jax_profiler
from odh_kubeflow_tpu.utils import tracing as jax_tracing
from odh_kubeflow_tpu_torch.cluster import flowcontrol
from odh_kubeflow_tpu_torch.runtime import breaker
from odh_kubeflow_tpu_torch.serving import metrics as serving_metrics
from odh_kubeflow_tpu_torch.utils import metrics, profiler, tracing

torch_threads.cap()

T = "4bf92f3577b34da6a3ce929d0e0e4736"
S = "00f067aa0ba902b7"
HEADERS = [
    None,
    "",
    "garbage",
    f"00-{T}-{S}-01",
    f"00-{T}-{S}-00",
    f"  00-{T.upper()}-{S.upper()}-01  ",
    f"ff-{T}-{S}-01",
    "00-short-short-01",
    f"00-{T}-{S}",
    f"00-{T}-{S}-01-extra",
    "00-" + "0" * 32 + f"-{S}-01",
    f"00-{T}-" + "0" * 16 + "-01",
    "00-" + "z" * 32 + f"-{S}-01",
    f"00-{T}-{'g' * 16}-01",
    f"00-{T[:-1]}-{S}-01",
    f"00-{T}-{S}0-01",
]


@pytest.fixture(autouse=True)
def _clean_traces():
    for mod in (tracing, jax_tracing):
        mod.set_enabled(True)
        mod.clear()
    yield
    for mod in (tracing, jax_tracing):
        mod.set_enabled(True)
        mod.clear()


@pytest.mark.parametrize("header", HEADERS, ids=[repr(h)[:24] for h in HEADERS])
def test_parse_traceparent_matches_reference(header):
    assert tracing.parse_traceparent(header) == jax_tracing.parse_traceparent(header)


@pytest.mark.parametrize("sampled", [True, False])
def test_format_traceparent_matches_reference(sampled):
    assert tracing.format_traceparent(T, S, sampled) == jax_tracing.format_traceparent(T, S, sampled)
    trace_id, span_id = tracing.new_trace_id(), tracing.new_span_id()
    assert (len(trace_id), len(span_id)) == (32, 16)
    header = tracing.format_traceparent(trace_id, span_id, sampled)
    assert tracing.parse_traceparent(header) == jax_tracing.parse_traceparent(header) == (trace_id, span_id)


def _shape(mod, spans):
    """Spans with ids replaced by the names of the spans they point at."""
    names = {s.span_id: s.name for s in spans}
    traces = {}
    return [(traces.setdefault(s.trace_id, len(traces)), s.name,
             names.get(s.parent_id, "remote" if s.parent_id else None), dict(s.attributes))
            for s in spans]


def _scripted_spans(mod):
    """One script of the tracing API; returns the exported spans' shape and
    what the listener saw."""
    seen = []
    mod.add_span_listener(seen.append)
    try:
        tracer = mod.Tracer("t")
        with tracer.start_span("parent", kind="outer") as parent:
            assert mod.current_traceparent() == parent.traceparent
            with tracer.start_span("child") as child:
                child.set_attribute("n", 3)
                mod.record_span("inside", traceparent=mod.current_traceparent(), x=1)
        with mod.attach(f"00-{T}-{S}-01"):
            with tracer.start_span("adopted"):
                pass
        with mod.attach("garbage"):
            assert mod.current_span() is None
        mod.record_span("orphan", traceparent=None, y=2)
        mod.record_span("given", traceparent=f"00-{T}-{S}-01", trace_id=T, span_id="1" * 16)
        root = mod.begin_root("envelope", key="ns/a", who="w")
        mod.record_span("under-root", traceparent=root.traceparent)
        mod.finish_root(root.trace_id, done=True)
        mod.begin_root("dropped", key="ns/b")
        mod.discard_root_for("ns/b")
        mod.set_enabled(False)
        assert mod.record_span("off") is None
        with tracer.start_span("off-too"):
            pass
        mod.set_enabled(True)
        spans = mod.global_buffer.spans()
        assert [s.name for s in seen] == [s.name for s in spans]
        return _shape(mod, spans)
    finally:
        mod.remove_span_listener(seen.append)


def test_span_api_builds_the_reference_trees():
    got, want = _scripted_spans(tracing), _scripted_spans(jax_tracing)
    assert got == want
    assert [name for _, name, _, _ in got] == [
        "inside", "child", "parent", "adopted", "orphan", "given", "under-root", "envelope"]


def test_root_registry_publishes_active_and_evicted():
    before = tracing.tracing_roots_evicted_total.value(reason="reopened")
    first = tracing.begin_root("r", key="ns/x")
    second = tracing.begin_root("r", key="ns/x")
    assert tracing.open_root(first.trace_id) is None and tracing.open_root(second.trace_id)
    assert tracing.tracing_roots_active.value() == 1.0
    assert tracing.tracing_roots_evicted_total.value(reason="reopened") == before + 1
    tracing.discard_root(second.trace_id)
    assert tracing.tracing_roots_active.value() == 0.0
    assert tracing.finish_root(second.trace_id) is None


def test_recent_spans_filter_by_trace_and_name():
    tracing.record_span("a", traceparent=f"00-{T}-{S}-01")
    tracing.record_span("b", traceparent=f"00-{T}-{S}-01")
    tracing.record_span("a")
    assert [s["name"] for s in tracing.recent_spans(trace_id=T)] == ["a", "b"]
    assert len(tracing.recent_spans(name="a")) == 2
    assert tracing.recent_spans(trace_id=T, name="b")[0]["attributes"] == {}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

FAMILIES = [
    (serving_metrics, jax_serving_metrics, name) for name in (
        "inference_ttft_seconds", "inference_token_latency_seconds",
        "inference_goodput_tokens_per_s", "inference_queue_depth",
        "inference_slot_occupancy_ratio", "inference_requests_total",
        "inference_router_picks_total", "inference_router_retries_total",
        "inference_router_hedges_total", "inference_router_ejections_total",
        "inference_router_added_latency_seconds")
] + [
    (profiler, jax_profiler, name) for name in (
        "profile_phase_seconds", "profile_region_seconds", "profile_compile_seconds",
        "profile_region_hbm_peak_bytes")
] + [
    (breaker, jax_metrics, "breaker_trips_total"),
    (tracing, jax_metrics, "tracing_roots_active"),
    (tracing, jax_metrics, "tracing_roots_evicted_total"),
] + [
    (flowcontrol, jax_metrics, name) for name in (
        "flowcontrol_inflight", "flowcontrol_queue_depth", "flowcontrol_requests_total",
        "flowcontrol_wait_seconds")
]


def _definition(family):
    labels = getattr(family, "labels", None)
    if labels is None:
        labels = family.label_names
    return (family.name, family.help, tuple(labels), type(family).__name__,
            getattr(family, "buckets", None))


@pytest.mark.parametrize("port_mod,jax_mod,attr", FAMILIES, ids=[f[2] for f in FAMILIES])
def test_family_definitions_match_reference(port_mod, jax_mod, attr):
    port_family = getattr(port_mod, attr)
    assert _definition(port_family) == _definition(getattr(jax_mod, attr))
    assert metrics.global_registry.get(port_family.name) is port_family


# observations per family type, with labels drawn from the family's own
# label names; values hit bucket edges, the +Inf bucket and escapes
VALUES = [0.0, 0.0005, 0.001, 0.0031, 0.25, 1.0, 2.5, 7.0, 99.0]
LABEL_VALUES = ["ok", 'q"uote', "back\\slash", "new\nline"]


def _feed(family, kind, labels):
    for i, v in enumerate(VALUES):
        lab = {name: LABEL_VALUES[(i + j) % len(LABEL_VALUES)] for j, name in enumerate(labels)}
        if kind == "Histogram":
            family.observe(v, **lab)
        elif kind == "Counter":
            family.inc(v + 1.0, **lab)
        else:
            family.set(v, **lab)


@pytest.mark.parametrize("group", ["serving", "profile", "control"])
def test_registry_renders_the_reference_text(group):
    """Fresh registries on both sides, the same families and observations:
    render() is byte-equal (and an idle family renders the same too)."""
    port_reg, jax_reg = metrics.Registry(), jax_metrics.Registry()
    chosen = {"serving": FAMILIES[:11], "profile": FAMILIES[11:15], "control": FAMILIES[15:]}[group]
    for port_mod, _, attr in chosen:
        name, help_, labels, kind, buckets = _definition(getattr(port_mod, attr))
        make_port = getattr(port_reg, kind.lower())
        make_jax = getattr(jax_reg, kind.lower())
        extra = {"buckets": buckets} if buckets is not None else {}
        fam_port = make_port(name, help_, labels=labels, **extra)
        fam_jax = make_jax(name, help_, labels=labels, **extra)
        if attr != chosen[-1][2]:  # the last family stays idle
            _feed(fam_port, kind, labels)
            _feed(fam_jax, kind, labels)
    assert port_reg.render() == jax_reg.render()


def test_escapes_match_reference():
    for text in ['a"b', "c\\d", "e\nf", 'all\\"\n']:
        assert metrics.escape_label_value(text) == jax_metrics.escape_label_value(text)
        assert metrics.escape_help(text) == jax_metrics.escape_help(text)


def test_labels_are_checked_and_registration_is_idempotent():
    reg = metrics.Registry()
    c = reg.counter("x_total", "h", labels=("a",))
    assert reg.counter("x_total", "other") is c
    with pytest.raises(ValueError):
        c.inc(b="1")
    c.inc(a="1")
    assert c.snapshot() == {"1": 1.0}
    h = reg.histogram("h_seconds", "h", buckets=(0.1, 1.0))
    assert h.snapshot() == {"count": 0, "sum": 0.0, "buckets": {"0.1": 0, "1.0": 0, "+Inf": 0}}
    h.observe(0.5)
    assert h.snapshot()["buckets"] == {"0.1": 0, "1.0": 1, "+Inf": 1}
