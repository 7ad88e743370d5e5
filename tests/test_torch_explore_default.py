"""The port's acceptance run of the interleaving explorer
(analysis/explore.py `explore_default`): bounded-exhaustive over the
suspend x repair x reclaim space of the port's shipped controllers, it must
come back exhausted, untruncated and without a violation, as
tests/test_explore.py holds the reference's. A file of its own, so that
`--dist loadfile` gives its run of tens of seconds a worker of its own."""
import logging

from odh_kubeflow_tpu_torch.analysis import explore
import torch_threads

torch_threads.cap()


def test_the_port_interleaving_space_is_clean():
    logging.disable(logging.CRITICAL)
    try:
        result = explore.explore_default()
    finally:
        logging.disable(logging.NOTSET)
    assert result.exhausted, "scheduler budget exceeded before the frontier drained"
    assert result.truncated == 0, "depth bound cut schedules short"
    assert result.schedules > 0, "no schedule ever reached quiescence"
    assert result.violations == [], "\n".join(
        f"[{v.invariant}] {v.detail}\n  trace: {' -> '.join(v.trace)}"
        for v in result.violations
    )
