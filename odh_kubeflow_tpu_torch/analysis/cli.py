"""`python -m odh_kubeflow_tpu_torch.analysis` — the port's lint lane, with
every mode of the reference's (odh_kubeflow_tpu/analysis/cli.py). It
imports neither jax nor PyYAML, so it runs where the port runs.

    python -m odh_kubeflow_tpu_torch.analysis            # full pass over
                                    # the installed port package
    python -m odh_kubeflow_tpu_torch.analysis --check lock-discipline path/
    python -m odh_kubeflow_tpu_torch.analysis --include-suppressed  # audit
    python -m odh_kubeflow_tpu_torch.analysis --list-checks
    python -m odh_kubeflow_tpu_torch.analysis --registry-lint  # live-registry
                                    # naming and bucket rules
    python -m odh_kubeflow_tpu_torch.analysis --slo-lint  # SLO/alert defs
                                    # vs the live registry
    python -m odh_kubeflow_tpu_torch.analysis --pragma-gate \
        odh_kubeflow_tpu_torch/analysis/pragma_allowlist.txt
                                    # fail on unreviewed `# lint: disable`
    python -m odh_kubeflow_tpu_torch.analysis --pragma-update \
        odh_kubeflow_tpu_torch/analysis/pragma_allowlist.txt
    python -m odh_kubeflow_tpu_torch.analysis --machines-doc  # render the
                                    # machine specs as Markdown
    python -m odh_kubeflow_tpu_torch.analysis --explore  # bounded
                                    # exhaustive interleaving run
    python -m odh_kubeflow_tpu_torch.analysis --check host-transfer \
        --check psum-axis          # the torchlint data-plane pair
    python -m odh_kubeflow_tpu_torch.analysis --check rbac-coverage \
        --check crd-schema-drift --check env-contract \
        --check flow-schema-coverage [--deploy-surface surface.json]
                                    # the deploylint deployment-surface family

Exit status: 0 = no unsuppressed findings, 1 = findings, 2 = usage error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .framework import (
    all_checkers,
    collect_pragmas,
    parse_pragma_allowlist,
    pragma_budget_violations,
    render_pragma_allowlist,
    run_analysis,
)


def _registry_lint() -> int:
    """Import every metric-registration site, then lint the live global
    registry."""
    import odh_kubeflow_tpu_torch.cluster.slicepool  # noqa: F401
    import odh_kubeflow_tpu_torch.runtime.accounting  # noqa: F401  (fleet ledger)
    import odh_kubeflow_tpu_torch.runtime.controller  # noqa: F401
    import odh_kubeflow_tpu_torch.runtime.jobmetrics  # noqa: F401  (TPUJob series)
    import odh_kubeflow_tpu_torch.runtime.metrics as m
    import odh_kubeflow_tpu_torch.runtime.prober  # noqa: F401  (canary families)
    import odh_kubeflow_tpu_torch.runtime.workqueue  # noqa: F401
    import odh_kubeflow_tpu_torch.serving.metrics  # noqa: F401  (inference families)
    import odh_kubeflow_tpu_torch.telemetry  # noqa: F401  (device families)
    import odh_kubeflow_tpu_torch.utils.profiler  # noqa: F401  (PROFILE=1 families)
    from odh_kubeflow_tpu_torch.controllers.metrics import NotebookMetrics

    from .metric_rules import check_registry

    NotebookMetrics(m.global_registry)  # controller series register in __init__
    violations = check_registry(m.global_registry)
    if violations:
        print("metrics lint FAILED:")
        for v in violations:
            print(f"  - {v}")
        return 1
    text = m.global_registry.render()
    print(
        f"metrics lint OK: {len(m.global_registry._metrics)} families, "
        f"{len(text.splitlines())} exposition lines"
    )
    return 0


def _slo_lint() -> int:
    """Import every metric-registration site plus the SLO/alert/prober
    definitions, then lint the definitions against the live registry
    (metric_rules.check_slo_definitions is the one source of truth, like the
    registry lint)."""
    import odh_kubeflow_tpu_torch.cluster.slicepool  # noqa: F401  (pool + resume)
    import odh_kubeflow_tpu_torch.runtime.controller  # noqa: F401
    import odh_kubeflow_tpu_torch.runtime.flightrecorder  # noqa: F401
    import odh_kubeflow_tpu_torch.runtime.metrics as m
    import odh_kubeflow_tpu_torch.runtime.prober  # noqa: F401  (canary families)
    import odh_kubeflow_tpu_torch.telemetry  # noqa: F401  (device families)
    import odh_kubeflow_tpu_torch.utils.profiler  # noqa: F401  (PROFILE=1 families)
    from odh_kubeflow_tpu_torch.controllers.metrics import NotebookMetrics
    from odh_kubeflow_tpu_torch.runtime.alerts import default_rules
    from odh_kubeflow_tpu_torch.runtime.slo import default_slos

    from .metric_rules import check_slo_definitions

    NotebookMetrics(m.global_registry)  # controller series register in __init__
    slos = default_slos()
    rules = default_rules(slos)
    violations = check_slo_definitions(slos, rules, m.global_registry)
    if violations:
        print("slo lint FAILED:")
        for v in violations:
            print(f"  - {v}")
        return 1
    print(
        f"slo lint OK: {len(slos)} SLOs, {len(rules)} alert rules, every "
        "referenced metric registered"
    )
    return 0


def _default_paths() -> List[str]:
    # resolve from the installed package location, not the cwd — the same
    # tree is scanned no matter where the command is invoked from
    import odh_kubeflow_tpu_torch

    return [str(Path(odh_kubeflow_tpu_torch.__file__).parent)]


def _pragma_gate(paths: List[str], allowlist_path: str, update: bool) -> int:
    if update and paths:
        # an update from a subset of the tree would silently DROP every
        # reviewed entry outside it — the allowlist is whole-tree only
        print(
            "--pragma-update rebuilds the allowlist for the WHOLE tree; "
            "explicit paths would drop reviewed entries outside them — "
            "run it without path arguments",
            file=sys.stderr,
        )
        return 2
    # the committed allowlist stores repo-root-relative paths; normalize the
    # collected keys the same way so the gate is cwd-independent (the repo
    # root is derived from the installed package, never from cwd)
    import odh_kubeflow_tpu_torch

    repo_root = Path(odh_kubeflow_tpu_torch.__file__).resolve().parent.parent
    raw_budget = collect_pragmas(paths or _default_paths())
    budget = {}
    for (path, check), count in raw_budget.items():
        resolved = Path(path).resolve()
        try:
            path = str(resolved.relative_to(repo_root))
        except ValueError:
            path = str(resolved)
        budget[(path, check)] = budget.get((path, check), 0) + count
    if update:
        Path(allowlist_path).write_text(render_pragma_allowlist(budget))
        print(f"pragma allowlist updated: {len(budget)} (path, check) "
              f"entries -> {allowlist_path}")
        return 0
    try:
        allowlist = parse_pragma_allowlist(Path(allowlist_path).read_text())
    except FileNotFoundError:
        print(f"pragma gate FAILED: allowlist {allowlist_path} missing "
              "(generate it with --pragma-update)", file=sys.stderr)
        return 1
    problems = pragma_budget_violations(budget, allowlist)
    if problems:
        print("pragma gate FAILED (unreviewed suppressions):")
        for p in problems:
            print(f"  - {p}")
        return 1
    stale = sum(
        1 for key, allowed in allowlist.items() if budget.get(key, 0) < allowed
    )
    print(
        f"pragma gate OK: {sum(budget.values())} pragma(s) across "
        f"{len(budget)} (path, check) entries, all reviewed"
        + (f" ({stale} allowlist entr{'y' if stale == 1 else 'ies'} stale — "
           "refresh with --pragma-update)" if stale else "")
    )
    return 0


def _explore() -> int:
    """The bounded-exhaustive interleaving run over the shipped
    controllers (the dynamic half of the machine specs)."""
    import logging

    logging.disable(logging.CRITICAL)
    from .explore import explore_default, explore_jobs

    ok = True
    for name, run in (("default", explore_default), ("jobs", explore_jobs)):
        result = run()
        print(
            f"explorer[{name}]: {result.schedules} quiesced schedules, "
            f"{result.visited} scheduler states ({result.pruned} pruned), "
            f"truncated={result.truncated}, exhausted={result.exhausted}"
        )
        for v in result.violations:
            print(f"  VIOLATION [{v.invariant}] {v.detail}")
            print(f"    trace: {' -> '.join(v.trace)}")
        ok = ok and result.ok
    if not ok:
        print("explorer FAILED: interleaving space not clean/exhausted")
        return 1
    print("explorer OK: zero invariant violations over the explored spaces")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m odh_kubeflow_tpu_torch.analysis",
        description="Operator-lint of the port: AST invariant checks for the "
        "control plane and the data plane",
    )
    parser.add_argument("paths", nargs="*", default=[], help="files or directories")
    parser.add_argument(
        "--check", action="append", default=None,
        help="run only this checker (repeatable)",
    )
    parser.add_argument(
        "--include-suppressed", action="store_true",
        help="show findings hidden by `# lint: disable=` pragmas",
    )
    parser.add_argument(
        "--list-checks", action="store_true", help="list checker names and exit"
    )
    parser.add_argument(
        "--registry-lint", action="store_true",
        help="lint the live metrics registry instead of source files",
    )
    parser.add_argument(
        "--slo-lint", action="store_true",
        help="lint SLO/alert-rule definitions against the live registry",
    )
    parser.add_argument(
        "--pragma-gate", metavar="ALLOWLIST",
        help="fail when the tree carries `# lint: disable` pragmas beyond "
        "the committed allowlist "
        "(odh_kubeflow_tpu_torch/analysis/pragma_allowlist.txt)",
    )
    parser.add_argument(
        "--pragma-update", metavar="ALLOWLIST",
        help="rewrite the pragma allowlist from the current tree (after "
        "review)",
    )
    parser.add_argument(
        "--deploy-surface", metavar="ARTIFACT",
        help="JSON surface artifact recorded by DEPLOYGUARD "
        "(DEPLOYGUARD_SURFACE_OUT) — gives rbac-coverage runtime confidence "
        "when flagging stale rules",
    )
    parser.add_argument(
        "--machines-doc", action="store_true",
        help="render the state-machine specs (analysis/machines.py) as "
        "Markdown tables",
    )
    parser.add_argument(
        "--explore", action="store_true",
        help="run the bounded exhaustive interleaving exploration over the "
        "shipped controllers (analysis/explore.py)",
    )
    args = parser.parse_args(argv)

    if args.list_checks:
        for checker in all_checkers():
            print(checker.name)
        return 0
    if args.registry_lint:
        return _registry_lint()
    if args.slo_lint:
        return _slo_lint()
    if args.pragma_gate or args.pragma_update:
        return _pragma_gate(
            args.paths,
            args.pragma_update or args.pragma_gate,
            update=bool(args.pragma_update),
        )
    if args.machines_doc:
        from .machines import render_markdown

        print(render_markdown())
        return 0
    if args.explore:
        return _explore()

    paths = args.paths or _default_paths()
    checkers = all_checkers()
    if args.check:
        known = {c.name for c in checkers}
        unknown = set(args.check) - known
        if unknown:
            print(f"unknown checker(s): {', '.join(sorted(unknown))}", file=sys.stderr)
            print(f"available: {', '.join(sorted(known))}", file=sys.stderr)
            return 2
        selected = set(args.check)
        checkers = [c for c in checkers if c.name in selected]
        if "lock-order" in selected and "lock-discipline" not in selected:
            # lock-order normally piggybacks on lock-discipline's walk; run
            # standalone when discipline was filtered out
            from .checkers.lock_discipline import LockOrderChecker

            checkers = [
                LockOrderChecker() if c.name == "lock-order" else c
                for c in checkers
            ]

    if args.deploy_surface:
        import json

        from .deploysurface import surface_tuples_from_artifact

        surface = surface_tuples_from_artifact(
            json.loads(Path(args.deploy_surface).read_text())
        )
        for c in checkers:
            if c.name == "rbac-coverage":
                c.surface = surface  # type: ignore[attr-defined]

    findings = run_analysis(
        paths, checkers=checkers, include_suppressed=args.include_suppressed
    )
    for finding in findings:
        print(finding)
    if findings:
        print(f"\n{len(findings)} finding(s)")
        return 1
    print("analysis OK: no findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
