"""Checker registry of the port's lint: the deploylint family
(deploylint.py), whose runtime twin is utils/deployguard.py."""
from __future__ import annotations

from typing import List

from ..framework import Checker
from .deploylint import (
    CrdSchemaDriftChecker,
    EnvContractChecker,
    FlowSchemaCoverageChecker,
    RbacCoverageChecker,
    make_deploylint_checkers,
)

__all__ = [
    "CrdSchemaDriftChecker",
    "EnvContractChecker",
    "FlowSchemaCoverageChecker",
    "RbacCoverageChecker",
    "make_checkers",
    "make_deploylint_checkers",
]


def make_checkers() -> List[Checker]:
    return make_deploylint_checkers()
