"""Operator-lint of the port: AST invariant checks for the control plane and
the data plane (the port's copy of odh_kubeflow_tpu/analysis).

A small framework (`framework.py`) walks the package, parses every module
once, and runs pluggable checkers (`checkers/`, registered in
`make_checkers()`):

- ``cache-mutation``   objects read from an informer cache must be
                       deep-copied before any in-place write
                       (checkers/cache_mutation.py)
- ``lock-discipline`` / ``lock-order``  no sleeps / network / callback
                       dispatch / re-entrant acquisition inside a
                       ``with lock:`` body, and no cycle in the global
                       lock-acquisition order (checkers/lock_discipline.py)
- ``swallowed-exception``  no bare/blind except in reconcile, webhook or
                       probe paths (checkers/exceptions.py)
- ``metric-convention`` / ``annotation-convention``  Prometheus naming and
                       constants.py-sourced annotation keys (+ dead
                       ``*_ANNOTATION`` constants) (checkers/conventions.py)
- ``machine-conformance``  every write of a state annotation matches a
                       transition declared in `machines.py`
                       (checkers/machine_conformance.py)
- ``host-transfer`` / ``psum-axis``  the torchlint pair: device->host copies
                       inside the hot regions of `utils/hotregions.py` (the
                       static half of the table `utils/torchguard.py`
                       enforces at run time), and mesh axis names against
                       the axes `parallel/mesh.py` declares
                       (checkers/torchlint.py)
- ``rbac-coverage`` / ``crd-schema-drift`` / ``env-contract`` /
  ``flow-schema-coverage``  the deploylint family over the deployment
                       surface contract (`deploysurface.py`), whose runtime
                       twin is `utils/deployguard.py` (checkers/deploylint.py)

Intentional exceptions are recorded inline with ``# lint: disable=<check>``
pragmas and budgeted in `pragma_allowlist.txt` beside this file;
`python -m odh_kubeflow_tpu_torch.analysis` (cli.py) runs the whole pass,
the pragma gate, the live-registry and SLO definition lints
(`metric_rules.py`), the machine specs' Markdown and the interleaving
explorer (`explore.py`), which drives the real controllers through
enumerated interleavings with faults and holds them to the invariants of
`utils/invcheck.py`.
"""
from .framework import (  # noqa: F401
    Checker,
    Finding,
    ModuleInfo,
    all_checkers,
    run_analysis,
    run_on_source,
)
from .metric_rules import check_registry  # noqa: F401
