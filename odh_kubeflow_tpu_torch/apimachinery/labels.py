"""Label selector evaluation (matchLabels + matchExpressions), from scratch.

The reference's watch topology filters on labels everywhere (e.g. pods by
`notebook-name`, HTTPRoutes by `notebook-name`/`notebook-namespace` — SURVEY §2
watch topology rows); this is the matching engine behind those predicates and
behind List(label_selector=...)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .serde import KubeModel


@dataclass
class LabelSelectorRequirement(KubeModel):
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector(KubeModel):
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Optional[Dict[str, str]]) -> bool:
        labels = labels or {}
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            present = req.key in labels
            val = labels.get(req.key)
            if req.operator == "In":
                if not present or val not in req.values:
                    return False
            elif req.operator == "NotIn":
                if present and val in req.values:
                    return False
            elif req.operator == "Exists":
                if not present:
                    return False
            elif req.operator == "DoesNotExist":
                if present:
                    return False
            else:
                raise ValueError(f"unknown selector operator {req.operator!r}")
        return True


def match_labels(selector: Optional[Dict[str, str]], labels: Optional[Dict[str, str]]) -> bool:
    """Plain equality-based selector (the common case in the controllers)."""
    if not selector:
        return True
    labels = labels or {}
    return all(labels.get(k) == v for k, v in selector.items())
