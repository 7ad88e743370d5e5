"""The two soaks of tests/test_suspend.py through both SimClusters at once
(tests/torch_suspend_sides.py), in a file of their own so that the test
runner's workers share the long scenarios: the seeded pool churn (suspend,
a seeded warm-pool bad day, resume, twice; nobody silently stuck in
Resuming) and the oversubscription soak (demand past the physical cards,
degraded by suspending, never by failing). The faults and the reclaim
cascade land on each side's own timing, so what is compared is each soak's
guaranteed end state, as the reference test asserts it.
"""
import time

import torch_threads
from torch_sides import both, wait_for
from torch_suspend_sides import Env

torch_threads.cap()


def test_seeded_pool_churn_no_silent_stuck():
    def scenario(env, seed=0x5EED, cycles=2):
        names = [f"churn-{i}" for i in range(3)]
        for name in names:
            env.notebook(name)
        for name in names:
            wait_for(lambda n=name: env.mesh_ready(n), timeout=40, msg=f"{name} up")
            env.agents[f"{name}-0"].checkpoint_hook = lambda: {"step": 5}
        poisoned, failed = [], []
        sp = env.side.slicepool
        for cycle in range(cycles):
            for name in names:
                env.stop_nb(name)
            for name in names:
                wait_for(lambda n=name: env.suspended(n), timeout=40, msg=f"{name} suspended (cycle {cycle})",
                         retry=(env.side.am.TooManyRequestsError,))
            plan = None
            if cycle == 0:
                # the bad day lands on the warm pool: seeded poisoning of warm
                # hosts, reclaim-race conflict storms and the control-plane
                # schedule
                warm = [n.metadata.name for n in env.client.list(env.side.core.Node)
                        if n.metadata.annotations.get(sp.POOL_STATE_ANNOTATION) == sp.POOL_STATE_WARM]
                plan = env.side.faults.seeded_pool_bad_day(env.cluster, seed=seed, warm_nodes=warm)
                poisoned = list(plan["poisoned"])
            for name in names:
                env.unstop(name)
            if plan is not None:
                # maintenance ends mid-resume: the poisoned hosts come back
                time.sleep(1.0)
                for node in plan["poisoned"]:
                    env.cluster.restore_node(node)
            for name in names:
                wait_for(lambda n=name: env.active(n), timeout=60, msg=f"{name} resumed (cycle {cycle})",
                         retry=(env.side.am.TooManyRequestsError,))
                if env.has_event("ResumeFailed", name):
                    failed.append(name)
        env.cluster.faults.clear()
        return {"poisoned": bool(poisoned), "active": all(env.active(n) for n in names), "resume failed": failed,
                "healthy": env.mgr.healthz()}

    got = both(scenario, lambda side: Env(side, slices=4), lambda env: env.stop())
    assert got["jax"] == got["port"] == {"poisoned": True, "active": True, "resume failed": [], "healthy": True}, got


def test_oversubscription_soak_degrades_by_suspending_not_failing():
    cfg = dict(enable_culling=False, suspend_enabled=True, readiness_probe_period_s=0.15,
               suspend_checkpoint_window_s=1.0, resume_timeout_s=30.0, resume_max_attempts=6,
               reclaim_pending_grace_s=0.3, chip_budget=24)  # 6 slices of 4 admitted over 8 physical cards

    def scenario(env):
        def settled(name):
            state = env.state(name)
            return state == "suspended" or (not state and env.mesh_ready(name))

        names = [(f"nb-{i}", i + 1) for i in range(5)]  # ascending priority: each arrival reclaims the lowest
        created = []
        for name, priority in names:
            env.notebook(name, priority=priority)
            created.append(name)
            for n in created:
                wait_for(lambda n=n: settled(n), timeout=60,
                         msg=f"{n} neither running nor cleanly suspended after {name} arrived")
            for p in env.pods(name):
                if p.metadata.name in env.agents:
                    env.agents[p.metadata.name].checkpoint_hook = lambda: {"step": 3}
        running = [n for n, _ in names if env.active(n)]
        parked = [n for n, _ in names if env.state(n) == "suspended"]
        out = {"terminal failures": env.has_event("ResumeFailed") or env.has_event("RepairFailed"),
               "all settled": len(running) + len(parked) == len(names),
               "highest runs": "nb-4" in running, "lowest parked first": "nb-0" in parked,
               "reclaim incident": any("reclaim" in env.incidents(n) for n, _ in names)}
        # a user returns: capacity freed by deleting a runner, the suspended
        # notebook resumes instead of failing
        env.client.delete(env.side.nb.Notebook, "multiplex", running[0])
        env.unstop(parked[0])
        wait_for(lambda: env.active(parked[0]), timeout=60, msg=f"{parked[0]} resumed after capacity returned")
        out.update(failed_after=env.has_event("ResumeFailed"), healthy=env.mgr.healthz())
        return out

    got = both(scenario, lambda side: Env(side, cfg=cfg, slices=2), lambda env: env.stop())
    assert got["jax"] == got["port"] == {"terminal failures": False, "all settled": True, "highest runs": True,
                                         "lowest parked first": True, "reclaim incident": True,
                                         "failed_after": False, "healthy": True}, got
