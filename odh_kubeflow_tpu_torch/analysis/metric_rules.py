"""Prometheus naming rules of the port — the one source of truth shared by
the static AST checker (checkers/conventions.py) and the runtime registry
lint (`python -m odh_kubeflow_tpu_torch.analysis --registry-lint`), with the
rules, the histogram ranges and the SLO definition lint of
odh_kubeflow_tpu/analysis/metric_rules.py. The families keep the
reference's names (`tpu_*` included), so dashboards and alerts read both.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence

METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Documented observation range (lo_s, hi_s) per histogram family — the ONE
# place bucket coverage is declared. The rule: the family's
# first bucket must sit at or below lo, its last finite bucket at or above
# hi, and at least 3 boundaries must land inside the range (resolution).
# Seconds-scale defaults silently collapse ms-scale phase timings into one
# bucket (the bug this lint exists for: tpu_decode_step_duration_seconds
# once shared the train-step buckets while a decode step lands under 1 ms).
# Every registered histogram MUST appear here — an undeclared family is a
# lint violation, so a new metric can't dodge the coverage question.
HISTOGRAM_RANGES = {
    "notebook_slice_ready_seconds": (0.1, 300.0),
    "notebook_probe_sweep_seconds": (0.001, 10.0),
    "notebook_resume_seconds": (0.05, 300.0),
    "flowcontrol_wait_seconds": (0.001, 60.0),
    # sim-mode reconciles land sub-ms (a 1ms low end saturated the first
    # bucket, making queue-wait p50s unreadable)
    "workqueue_queue_duration_seconds": (0.0001, 60.0),
    "controller_reconcile_duration_seconds": (0.0001, 60.0),
    # CPPROFILE=1 control-plane profiler families (runtime/cpprofile.py):
    # queue-wait/work share the sub-ms reconcile range; takeover phases run
    # from sub-ms (no-op lease acquire in sim) to tens of seconds (relist
    # at population under a real apiserver)
    "cp_queue_wait_seconds": (0.0001, 60.0),
    "cp_reconcile_work_seconds": (0.0001, 60.0),
    "cp_takeover_phase_seconds": (0.001, 60.0),
    "canary_probe_latency_seconds": (0.1, 300.0),
    "tpu_job_queue_wait_seconds": (0.05, 1800.0),
    "tpu_job_completion_seconds": (0.5, 7200.0),
    "tpu_train_step_duration_seconds": (0.001, 30.0),
    # a decode step on the device is sub-ms per token; the CPU sim
    # stretches to seconds — the range spans both
    "tpu_decode_step_duration_seconds": (0.0005, 30.0),
    "tpu_slice_repair_duration_seconds": (0.1, 600.0),
    "inference_ttft_seconds": (0.001, 10.0),
    "inference_token_latency_seconds": (0.0005, 2.5),
    # routing overhead: sub-ms pick in steady state, stretching toward the
    # retry-budget cap (jittered backoffs) when replicas shed or fail
    "inference_router_added_latency_seconds": (0.0005, 1.0),
    "profile_phase_seconds": (0.0001, 2.5),
    "profile_region_seconds": (0.0005, 30.0),
    "profile_compile_seconds": (0.001, 60.0),
}


def check_histogram_buckets(name: str, buckets: Sequence[float]) -> List[str]:
    """Bucket-coverage lint for one histogram family: its declared buckets
    must bracket the documented observation range with usable resolution."""
    rng = HISTOGRAM_RANGES.get(name)
    if rng is None:
        return [
            f"{name}: histogram has no documented observation range — "
            f"declare (lo_s, hi_s) in HISTOGRAM_RANGES (metric_rules.py) "
            f"so bucket coverage is lintable"
        ]
    lo, hi = rng
    violations: List[str] = []
    finite = sorted(b for b in buckets if b != float("inf"))
    if not finite:
        return [f"{name}: histogram with no finite buckets"]
    if finite[0] > lo:
        violations.append(
            f"{name}: first bucket {finite[0]}s is above the documented "
            f"low end {lo}s — observations below it are indistinguishable"
        )
    if finite[-1] < hi:
        violations.append(
            f"{name}: last finite bucket {finite[-1]}s is below the "
            f"documented high end {hi}s — the top of the range collapses "
            f"into +Inf"
        )
    inside = [b for b in finite if lo <= b <= hi]
    if len(inside) < 3:
        violations.append(
            f"{name}: only {len(inside)} bucket boundary(ies) inside the "
            f"documented range [{lo}, {hi}]s — no usable resolution"
        )
    return violations


def check_metric(
    name: str,
    type_name: str,
    help_text: Optional[str],
    label_names: Sequence[str] = (),
) -> List[str]:
    """Violation strings for one metric family (empty = compliant)."""
    violations: List[str] = []
    if not METRIC_NAME_RE.match(name):
        violations.append(f"{name}: invalid metric name")
    if type_name == "counter" and not name.endswith("_total"):
        violations.append(f"{name}: counter without _total suffix")
    if help_text is not None and not help_text.strip():
        violations.append(f"{name}: empty help string")
    for label in label_names:
        if not LABEL_NAME_RE.match(label) or label == "le":
            violations.append(f"{name}: invalid label name {label!r}")
    return violations


def check_slo_definitions(slos, rules, registry) -> List[str]:
    """Lint SLO + alert-rule definitions against the LIVE registry — the
    `--slo-lint` contract (same one-source-of-truth pattern as
    check_registry): every metric an indicator references must be a
    registered family of the right type, latency thresholds must sit on a
    real bucket boundary, and every alert rule must reference a defined SLO
    and known windows."""
    from odh_kubeflow_tpu_torch.runtime.metrics import Counter, Gauge, Histogram
    from odh_kubeflow_tpu_torch.runtime.slo import (
        EventRatioIndicator,
        GaugeIndicator,
        LatencyIndicator,
        WINDOW_SECONDS,
    )

    violations: List[str] = []
    names = set()
    for slo in slos:
        names.add(slo.name)
        if not (0.0 < slo.objective < 1.0):
            violations.append(
                f"slo {slo.name}: objective {slo.objective} outside (0, 1)"
            )
        for metric_name in slo.metric_names():
            if registry.get(metric_name) is None:
                violations.append(
                    f"slo {slo.name}: references unregistered metric "
                    f"{metric_name!r}"
                )
        indicator = slo.indicator
        if isinstance(indicator, LatencyIndicator):
            metric = registry.get(indicator.histogram)
            if metric is not None and not isinstance(metric, Histogram):
                violations.append(
                    f"slo {slo.name}: {indicator.histogram} is not a histogram"
                )
            elif metric is not None and indicator.threshold_s not in metric.buckets:
                violations.append(
                    f"slo {slo.name}: threshold {indicator.threshold_s}s is not "
                    f"a bucket boundary of {indicator.histogram} "
                    f"(buckets: {metric.buckets})"
                )
        elif isinstance(indicator, EventRatioIndicator):
            metric = registry.get(indicator.counter)
            if metric is not None and not isinstance(metric, Counter):
                violations.append(
                    f"slo {slo.name}: {indicator.counter} is not a counter"
                )
            elif metric is not None:
                unknown = [
                    label for label, _ in indicator.good_labels
                    if label not in metric.labels
                ]
                if unknown:
                    violations.append(
                        f"slo {slo.name}: good_labels {unknown} not labels of "
                        f"{indicator.counter} (has {list(metric.labels)})"
                    )
        elif isinstance(indicator, GaugeIndicator):
            metric = registry.get(indicator.gauge)
            if metric is not None and not isinstance(metric, Gauge):
                violations.append(
                    f"slo {slo.name}: {indicator.gauge} is not a gauge"
                )
        else:
            violations.append(
                f"slo {slo.name}: unknown indicator type "
                f"{type(indicator).__name__}"
            )
    budgets = {slo.name: slo.error_budget for slo in slos}
    for rule in rules:
        if rule.slo not in names:
            violations.append(
                f"alert rule {rule.name}: references undefined SLO {rule.slo!r}"
            )
        for window in (rule.long_window, rule.short_window):
            if window not in WINDOW_SECONDS:
                violations.append(
                    f"alert rule {rule.name}: unknown window {window!r} "
                    f"(known: {sorted(WINDOW_SECONDS)})"
                )
        if rule.burn_threshold <= 0:
            violations.append(
                f"alert rule {rule.name}: burn threshold must be > 0"
            )
        elif rule.slo in budgets:
            # burn = (1 - compliance) / budget is capped at 1/budget: a
            # threshold above the cap can never fire — a silently dead rule
            max_burn = 1.0 / budgets[rule.slo]
            if rule.burn_threshold > max_burn:
                violations.append(
                    f"alert rule {rule.name}: threshold "
                    f"{rule.burn_threshold}x exceeds the maximum possible "
                    f"burn {max_burn:.1f}x for objective "
                    f"{1.0 - budgets[rule.slo]:g} — the rule can never fire"
                )
    return violations


def check_registry(registry) -> List[str]:
    """Runtime lint of a live Registry: naming rules over every registered
    family, plus the exposition-completeness check (every family must appear
    in render() output — a family a scraper cannot see is a dead metric)."""
    from odh_kubeflow_tpu_torch.runtime.metrics import Histogram

    violations: List[str] = []
    for metric in registry._metrics.values():
        violations.extend(
            check_metric(metric.name, metric.type_name, metric.help, metric.labels)
        )
        if isinstance(metric, Histogram):
            violations.extend(
                check_histogram_buckets(metric.name, metric.buckets)
            )
    text = registry.render()
    families = set()
    for line in text.splitlines():
        if line.startswith("# HELP "):
            families.add(line.split(" ", 3)[2])
    for metric in registry._metrics.values():
        if metric.name not in families:
            violations.append(f"{metric.name}: missing from rendered exposition")
    return violations
