"""The port's interleaving explorer (analysis/explore.py: the World and the
JobWorld over the port's store, manager, culling, suspend/resume,
slice-repair and job reconcilers and slice pool, on an h100 1x4 slice where
the reference's plans a v5e 2x2) and the INVCHECK monitor against the JAX
package's, on the CPU.

The cases of tests/test_explore.py, each run on both packages in one test
(tests/torch_ported.py): the machine specs validate and render, the monitor
passes declared transitions and raises on an undeclared one and on a stolen
pool claim, both steady-state checks have teeth, the job space exhausts
clean, both mutants are reproduced with their minimized traces, and the
shipped controllers stay clean on those traces. On top, the two packages
are held to each other: the same minimized mutant traces, and the same
schedule, state and memo counts over the job space (the port's job
reconciler keeps one more piece of scratch than the reference's, the time
its preempted gang was seen gone, ROADMAP Queue 3 entry 19; with the
explorer's requeue backoff of 0 it changes no schedule).

Left out: `test_exhaustive_interleaving_space_is_clean` runs in
tests/test_torch_explore_default.py (a file of its own, so the run that
takes tens of seconds gets a worker of its own);
`test_architecture_embeds_the_current_contract` holds ARCHITECTURE.md, a
document of the reference (the port's render differs from it in two
descriptions, tests/test_torch_analysis_cli.py lists them);
`test_invcheck_overhead_under_ten_percent`, a wall-clock ratio that load on
the test machine breaks whatever the code does; and the two `slow` cases.
"""
import logging

import pytest

import odh_kubeflow_tpu.analysis.explore as j_explore
import odh_kubeflow_tpu_torch.analysis.explore as p_explore
import torch_ported
import torch_threads

torch_threads.cap()

RENAMES = (('Store(backend="python", invariants=', 'Store(invariants='),
           ('Store(backend="python")', 'Store()'))
JAX = torch_ported.load("test_explore", "jax")
PORT = torch_ported.load("test_explore", "port", renames=RENAMES)
LEFT_OUT = (
    "test_exhaustive_interleaving_space_is_clean",
    "test_architecture_embeds_the_current_contract",
    "test_invcheck_overhead_under_ten_percent",
    "test_exhaustive_with_one_preemption_is_clean",
    "test_exhaustive_job_space_with_churn_is_clean",
)
CASES = torch_ported.cases(JAX, skip=LEFT_OUT)
# the reference's minimized traces (tests/test_explore.py pins their shape)
MUTANT_TRACES = {
    "skip-checkpoint": ("cull-1", "suspend-1"),
    "cas-blind": ("unstop-2", "suspend-2", "rival-cas"),
}


@pytest.fixture(autouse=True)
def _quiet():
    logging.disable(logging.CRITICAL)
    yield
    logging.disable(logging.NOTSET)


def test_the_cases_are_the_reference_file_less_five():
    assert len(CASES) == len(torch_ported.cases(JAX)) - 5 == 13
    assert torch_ported.cases(PORT, skip=LEFT_OUT) == CASES


@pytest.mark.parametrize("case", CASES)
def test_explore_case_against_the_reference(case, tmp_path):
    torch_ported.both(JAX, PORT, case, tmp_path, transcript=False)


@pytest.mark.parametrize("name", sorted(MUTANT_TRACES))
def test_mutant_is_caught_on_the_port_with_the_reference_trace(name):
    j_first, j_min = j_explore.explore_mutant(name)
    p_first, p_min = p_explore.explore_mutant(name)
    assert j_min == p_min == MUTANT_TRACES[name]
    assert p_first.invariant == j_first.invariant == p_explore.MUTANT_INVARIANT[name]
    assert p_first.trace == j_first.trace


@pytest.mark.parametrize("name", sorted(MUTANT_TRACES))
def test_shipped_port_controllers_stay_clean_on_the_mutant_trace(name):
    assert p_explore.Explorer(p_explore.World).replay(MUTANT_TRACES[name]) == []


def test_job_space_counts_equal_the_reference():
    j, p = j_explore.explore_jobs(), p_explore.explore_jobs()
    assert p.ok and j.ok
    assert (p.schedules, p.visited, p.pruned, p.truncated) == (j.schedules, j.visited, j.pruned, j.truncated)
