"""Checker registry of the port's lint: one place that knows every checker
class, in the reference's order (odh_kubeflow_tpu/analysis/checkers).

The reference's jaxlint family has two checkers here, in torchlint.py:
host-transfer and psum-axis. Its retrace-hazard and donation-discipline
have nothing to check yet: the port has no `torch.compile` and no CUDA-graph
capture, whose static inputs bring both hazards back."""
from __future__ import annotations

from typing import List

from ..framework import Checker
from .cache_mutation import CacheMutationChecker
from .conventions import AnnotationConventionChecker, MetricConventionChecker
from .deploylint import (
    CrdSchemaDriftChecker,
    EnvContractChecker,
    FlowSchemaCoverageChecker,
    RbacCoverageChecker,
    make_deploylint_checkers,
)
from .exceptions import SwallowedExceptionChecker
from .lock_discipline import LockDisciplineChecker, LockOrderChecker
from .machine_conformance import MachineConformanceChecker
from .torchlint import HostTransferChecker, PsumAxisChecker

__all__ = [
    "CacheMutationChecker",
    "AnnotationConventionChecker",
    "MetricConventionChecker",
    "CrdSchemaDriftChecker",
    "EnvContractChecker",
    "FlowSchemaCoverageChecker",
    "RbacCoverageChecker",
    "SwallowedExceptionChecker",
    "LockDisciplineChecker",
    "LockOrderChecker",
    "MachineConformanceChecker",
    "HostTransferChecker",
    "PsumAxisChecker",
    "make_checkers",
    "make_deploylint_checkers",
]


def make_checkers() -> List[Checker]:
    discipline = LockDisciplineChecker()
    return [
        CacheMutationChecker(),
        discipline,
        # shares discipline's walk: edges are harvested once, cycles
        # reported at finish()
        LockOrderChecker(shared=discipline),
        SwallowedExceptionChecker(),
        MetricConventionChecker(),
        AnnotationConventionChecker(),
        MachineConformanceChecker(),
        # the torchlint family: host syncs inside the hot regions, and
        # mesh axis names; psum-axis judges cross-module at finish()
        HostTransferChecker(),
        PsumAxisChecker(),
        # the deploylint family: deployment-surface conformance against
        # the analysis/deploysurface.py contract (runtime twin:
        # utils/deployguard.py)
        *make_deploylint_checkers(),
    ]
