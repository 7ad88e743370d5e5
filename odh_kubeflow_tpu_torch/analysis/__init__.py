"""Analysis of the port's operator: the state machines as data
(`analysis.machines`), and the deployment-surface lint — the contract in
`deploysurface.py`, shared by the deploylint checkers
(`checkers/deploylint.py`: rbac-coverage, crd-schema-drift, env-contract,
flow-schema-coverage) and the runtime guard `utils/deployguard.py`, over
the checker framework (`framework.py`: one `ast.parse` per module,
`# lint: disable=<check>` pragmas)."""
from .framework import (  # noqa: F401
    Checker,
    Finding,
    ModuleInfo,
    all_checkers,
    run_analysis,
    run_on_source,
)
