"""In-process alert manager: multi-window multi-burn-rate rules over the SLO
engine's output, with firing/resolved lifecycle, dedup, and inhibition (the
port's copy of odh_kubeflow_tpu/runtime/alerts.py).

The pairing is the Google SRE workbook ch.5 shape: an alert fires only when
BOTH the long and the short window burn above the threshold — the long
window proves the budget is really being spent, the short window proves it
is STILL being spent (so an alert never fires for an outage that already
ended), and it resolves when the long window drops back under. The shipped
rules are the standard pairs per SLO: page on 14.4x over (1h, 5m), ticket
on 6x over (6h, 30m).

Firing alerts are mirrored into the cluster so humans see them where they
look: a deduplicated `SLOBurnRate` Event on each affected Notebook CR and a
`DegradedSLO` condition on the worst offenders (cleared with reason
Recovered at resolution). Inhibition is category-based: the composition
root registers "slice-repair-in-progress inhibits the readiness category"
— while the repair controller is mid-episode, readiness-latency/canary alerts are suppressed as symptoms of
the already-alerted cause, while the availability page stays live.

Every firing also snapshots the flight recorder, so the alert that pages is
born with its incident bundle.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import time

from .metrics import global_registry

log = logging.getLogger(__name__)

slo_alerts_firing = global_registry.gauge(
    "slo_alerts_firing",
    "Whether a burn-rate alert rule is currently firing (1/0), by rule",
    labels=("rule",),
)
slo_alert_transitions_total = global_registry.counter(
    "slo_alert_transitions_total",
    "Alert lifecycle transitions, by rule and event (fired | resolved)",
    labels=("rule", "event"),
)
slo_alerts_inhibited_total = global_registry.counter(
    "slo_alerts_inhibited_total",
    "Breaching evaluations suppressed by an inhibition rule, by rule",
    labels=("rule",),
)


@dataclass(frozen=True)
class AlertRule:
    name: str
    slo: str
    long_window: str  # e.g. "1h" — proves the budget is being spent
    short_window: str  # e.g. "5m" — proves it still is
    burn_threshold: float  # fires when BOTH windows burn at >= this rate
    severity: str = "page"


def default_rules(slos: Optional[Sequence[Any]] = None) -> Tuple[AlertRule, ...]:
    """The standard fast/slow pair per SLO (page 14.4x over 1h/5m, ticket 6x
    over 6h/30m). Burn rate is capped at 1/error_budget (compliance can't go
    below zero), so for low-objective SLOs the canonical thresholds are
    mathematically unreachable — e.g. a 0.50 objective caps burn at 2.0x.
    Thresholds are therefore clamped to a reachable fraction of the cap, so
    every shipped rule can fire."""
    from .slo import default_slos

    rules: List[AlertRule] = []
    for slo in slos or default_slos():
        max_burn = 1.0 / slo.error_budget
        fast = min(14.4, max_burn * 0.75)
        slow = min(6.0, max_burn * 0.5)
        rules.append(
            AlertRule(f"{slo.name}-fast-burn", slo.name, "1h", "5m", fast, "page")
        )
        rules.append(
            AlertRule(f"{slo.name}-slow-burn", slo.name, "6h", "30m", slow, "ticket")
        )
    return tuple(rules)


class AlertManager:
    """Consumes SLOEngine tick statuses (register via engine.add_listener).

    `manager` (runtime.manager.Manager) supplies the clients used to mirror
    Events/conditions onto Notebook CRs; without one the alerts still fire
    in-process (unit tests, metrics-only deployments).
    """

    MAX_MIRRORED_NOTEBOOKS = 5  # worst offenders only — not a fleet-wide spam
    HISTORY_LIMIT = 256

    def __init__(
        self,
        rules: Sequence[AlertRule] = (),
        manager: Any = None,
        recorder: Any = None,
        clock: Callable[[], float] = time.time,
    ):
        self.rules: Tuple[AlertRule, ...] = tuple(rules) or default_rules()
        self.manager = manager
        self.recorder = recorder
        self.clock = clock
        # category -> [(name, fn)]: alert suppressed while any fn() is True
        self._inhibitors: Dict[str, List[Tuple[str, Callable[[], bool]]]] = {}
        self.firing: Dict[str, dict] = {}  # rule name -> active alert
        self.history: List[dict] = []  # fired/resolved transitions, bounded
        self._listeners: List[Callable[[str, dict], None]] = []
        # transition decisions happen under this lock: evaluate() is reached
        # both from the engine's thread and from direct callers (a caller may
        # tick the engine by hand), and an unguarded check-then-fire would let a
        # rule double-fire. Side effects (mirroring, snapshots, listeners)
        # run OUTSIDE it — the claimed firing entry is the dedup.
        from ..utils import racecheck

        self._lock = racecheck.make_lock("AlertManager._lock")

    # -- wiring --

    def register_inhibitor(
        self, category: str, fn: Callable[[], bool], name: str = ""
    ) -> None:
        self._inhibitors.setdefault(category, []).append((name or "inhibitor", fn))

    def add_listener(self, fn: Callable[[str, dict], None]) -> None:
        """fn(event, alert) with event in {"fired", "resolved"}."""
        self._listeners.append(fn)

    # -- evaluation (one call per SLO engine tick) --

    def evaluate(self, statuses: Dict[str, dict]) -> None:
        # inhibitors are arbitrary callbacks: evaluate them before taking
        # the transition lock
        inhibited: Dict[str, Optional[str]] = {}
        to_fire: List[Tuple[AlertRule, dict, float, float]] = []
        to_resolve: List[Tuple[AlertRule, dict, float]] = []
        with self._lock:
            for rule in self.rules:
                status = statuses.get(rule.slo)
                if status is None:
                    continue
                windows = status.get("windows", {})
                long_w = windows.get(rule.long_window)
                short_w = windows.get(rule.short_window)
                if long_w is None or short_w is None:
                    continue
                burn_long = long_w["burn_rate"]
                burn_short = short_w["burn_rate"]
                breaching = (
                    burn_long >= rule.burn_threshold
                    and burn_short >= rule.burn_threshold
                )
                active = self.firing.get(rule.name)
                if active is not None:
                    # resolve on the LONG window alone: the short window
                    # recovers first by construction and must not flap
                    if burn_long < rule.burn_threshold:
                        self.firing.pop(rule.name, None)
                        to_resolve.append((rule, active, burn_long))
                    else:
                        active["burn_long"] = burn_long
                        active["burn_short"] = burn_short
                    continue
                if not breaching:
                    continue
                category = status.get("category", "")
                if category not in inhibited:
                    inhibited[category] = None  # claim; resolved below
                to_fire.append((rule, status, burn_long, burn_short))
        for category in inhibited:
            inhibited[category] = self._inhibited(category)
        confirmed_fires = []
        with self._lock:
            for rule, status, burn_long, burn_short in to_fire:
                if rule.name in self.firing:
                    continue  # a racing evaluate fired it first
                if inhibited.get(status.get("category", "")) is not None:
                    slo_alerts_inhibited_total.inc(rule=rule.name)
                    continue
                # claim the firing slot under the lock with the complete
                # record; _fire adds the affected notebooks + side effects
                # outside it
                alert = {
                    "rule": rule.name,
                    "slo": rule.slo,
                    "severity": rule.severity,
                    "since": self.clock(),
                    "burn_long": burn_long,
                    "burn_short": burn_short,
                    "windows": f"{rule.long_window}/{rule.short_window}",
                    "threshold": rule.burn_threshold,
                    "notebooks": [],
                }
                self.firing[rule.name] = alert
                confirmed_fires.append((rule, alert))
        for rule, active, burn_long in to_resolve:
            self._resolve(rule, active, burn_long)
        for rule, alert in confirmed_fires:
            self._fire(rule, alert)

    def _inhibited(self, category: str) -> Optional[str]:
        for name, fn in self._inhibitors.get(category, []):
            try:
                if fn():
                    return name
            except Exception:
                log.exception("inhibitor %s failed; treating as not inhibiting", name)
        return None

    # -- transitions --

    def _fire(self, rule: AlertRule, alert: dict) -> None:
        affected = self._affected_notebooks()
        alert["notebooks"] = [f"{ns}/{name}" for ns, name in affected]
        slo_alerts_firing.set(1, rule=rule.name)
        slo_alert_transitions_total.inc(rule=rule.name, event="fired")
        self._remember("fired", alert)
        log.warning(
            "ALERT firing: %s (slo %s burning %.1fx/%.1fx over %s, threshold %.1fx)",
            rule.name, rule.slo, alert["burn_long"], alert["burn_short"],
            alert["windows"], rule.burn_threshold,
        )
        self._mirror_fire(rule, alert, affected)
        if self.recorder is not None:
            try:
                self.recorder.snapshot(
                    reason=f"alert:{rule.name}",
                    subject=rule.slo,
                    client=getattr(self.manager, "client", None),
                    notebooks=affected,
                    extra={"alert": dict(alert)},
                )
            except Exception:
                log.exception("incident snapshot for %s failed", rule.name)
        for fn in list(self._listeners):
            try:
                fn("fired", alert)
            except Exception:
                log.exception("alert listener failed")

    def _resolve(self, rule: AlertRule, alert: dict, burn_long: float) -> None:
        # (evaluate() already removed the firing entry under its lock.)
        # A racing evaluate may have RE-claimed the rule between that pop
        # and this point: the old episode still resolves in the history, but
        # the gauge stays 1 and the mirrored conditions stay in place — the
        # alert is, in fact, firing.
        with self._lock:
            refired = rule.name in self.firing
        alert = dict(alert, resolved_at=self.clock(), burn_long=burn_long)
        slo_alerts_firing.set(1 if refired else 0, rule=rule.name)
        slo_alert_transitions_total.inc(rule=rule.name, event="resolved")
        self._remember("resolved", alert)
        log.info(
            "alert resolved: %s (burn back to %.2fx after %.1fs)",
            rule.name, burn_long, alert["resolved_at"] - alert["since"],
        )
        if not refired:
            self._mirror_resolve(rule, alert)
        for fn in list(self._listeners):
            try:
                fn("resolved", alert)
            except Exception:
                log.exception("alert listener failed")

    def _remember(self, event: str, alert: dict) -> None:
        with self._lock:
            self.history.append({"event": event, **alert})
            del self.history[: -self.HISTORY_LIMIT]

    # -- cluster mirroring (Events + DegradedSLO condition) --

    def _affected_notebooks(self) -> List[Tuple[str, str]]:
        """Worst offenders: GPU notebooks mid-repair or previously-ready but
        not mesh-ready right now — the CRs a responder should open first."""
        if self.manager is None:
            return []
        from ..api.notebook import Notebook
        from ..controllers import constants as C

        degraded: List[Tuple[int, str, str]] = []
        try:
            notebooks = self.manager.client.list(Notebook)
        except Exception:
            return []
        for nb in notebooks:
            if nb.metadata.deletion_timestamp or nb.spec.tpu is None:
                continue
            ann = nb.metadata.annotations
            if C.STOP_ANNOTATION in ann:
                continue
            in_repair = C.TPU_REPAIR_STATE_ANNOTATION in ann
            was_ready = nb.status.tpu is not None and bool(
                nb.status.tpu.first_ready_time
            )
            mesh_ready = nb.status.tpu is not None and nb.status.tpu.mesh_ready
            if in_repair or (was_ready and not mesh_ready):
                # mid-repair outranks merely-not-ready in the mirror cap
                degraded.append(
                    (0 if in_repair else 1, nb.metadata.namespace, nb.metadata.name)
                )
        degraded.sort()
        return [(ns, name) for _, ns, name in degraded[: self.MAX_MIRRORED_NOTEBOOKS]]

    def _mirror_fire(
        self, rule: AlertRule, alert: dict, affected: List[Tuple[str, str]]
    ) -> None:
        if self.manager is None or not affected:
            return
        message = (
            f"SLO {rule.slo} burning {alert['burn_long']:.1f}x budget over "
            f"{rule.long_window} (threshold {rule.burn_threshold}x, "
            f"severity {rule.severity})"
        )
        for namespace, name in affected:
            try:
                self._emit_event(namespace, name, rule, message)
                self._write_slo_condition(
                    namespace, name, "True", "BurnRateExceeded", message
                )
            except Exception:
                log.exception("mirroring alert %s onto %s/%s failed",
                              rule.name, namespace, name)
        alert["mirrored"] = [f"{ns}/{n}" for ns, n in affected]

    def _mirror_resolve(self, rule: AlertRule, alert: dict) -> None:
        if self.manager is None:
            return
        # a notebook mirrored by ANOTHER still-firing alert keeps its
        # DegradedSLO=True — the condition reflects "any SLO alert covers
        # this notebook", not the lifecycle of whichever rule resolved first
        with self._lock:
            still_covered = {
                key
                for active in self.firing.values()
                for key in active.get("mirrored", [])
            }
        for key in alert.get("mirrored", []):
            if key in still_covered:
                continue
            namespace, _, name = key.partition("/")
            try:
                self._write_slo_condition(
                    namespace, name, "False", "Recovered",
                    f"SLO {rule.slo} burn rate back under {rule.burn_threshold}x",
                )
            except Exception:
                log.exception("clearing DegradedSLO on %s failed", key)

    def _write_slo_condition(
        self, namespace: str, name: str, status: str, reason: str, message: str
    ) -> None:
        from ..api.notebook import Notebook
        from ..apimachinery import NotFoundError
        from ..controllers import constants as C
        from ..controllers.conditions import write_condition

        try:
            nb = self.manager.api_reader.get(Notebook, namespace, name)
        except NotFoundError:
            return
        write_condition(
            self.manager.client, self.manager.api_reader, nb,
            C.SLO_DEGRADED_CONDITION, status, reason, message,
        )

    def _emit_event(
        self, namespace: str, name: str, rule: AlertRule, message: str
    ) -> None:
        """Deduplicated Warning Event on the Notebook (shared emitter with
        the slice-repair and scheduler events — api/core.py)."""
        from ..api.core import emit_deduped_event
        from ..api.notebook import Notebook
        from ..apimachinery import NotFoundError

        client = self.manager.client
        try:
            nb = client.get(Notebook, namespace, name)
        except NotFoundError:
            return
        emit_deduped_event(
            client, nb, f"{name}.slo-{rule.name.lower()}",
            reason="SLOBurnRate", message=message, etype="Warning",
            api_version=nb.api_version or "kubeflow.org/v1beta1",
            kind="Notebook",
        )

    # -- introspection (the reference's /debug/slo) --

    def status(self) -> dict:
        with self._lock:
            firing = [dict(a) for a in self.firing.values()]
            history = [dict(h) for h in self.history[-50:]]
        return {
            "rules": [
                {
                    "name": r.name,
                    "slo": r.slo,
                    "windows": f"{r.long_window}/{r.short_window}",
                    "threshold": r.burn_threshold,
                    "severity": r.severity,
                }
                for r in self.rules
            ],
            "inhibitors": {
                category: [name for name, _ in entries]
                for category, entries in self._inhibitors.items()
            },
            "firing": firing,
            "history": history,
        }
