"""The noisy-neighbor drill: one byzantine tenant at full rate.

The tenant arena's isolation pin as a seeded, replayable adversary
class (scored like every PR 6 scenario, registered in `ADVERSARIES`):
a tenant-dense arena serves T tenants; tenant 0 turns byzantine —

  * **sybil flood** — bursts of low-sigma lifecycle submits far past
    its per-tenant queue quota, every round,
  * **invariant corruption** — direct damage to its OWN table slice
    (sigma columns poisoned out of range) riding the lend/commit
    writeback into the stacked state,
  * **deadline griefing** — ragged burst sizes shaped to force the
    widest bucket padding on every shared DRR round,

while the neighbors run a light honest workload. Containment is scored
on the neighbors ONLY (`honest_*` components — the suite-wide
invariant that honest traffic survives at 1.0):

  * `honest_neighbor_goodput`   — every neighbor lifecycle served,
  * `honest_neighbor_unshed`    — ZERO cross-tenant sheds (the flood
                                  burns the byzantine tenant's quota,
                                  nobody else's),
  * `honest_neighbor_chains`    — every neighbor session's chain head
                                  BIT-IDENTICAL to a solo oracle run
                                  of that neighbor's workload alone
                                  (the structural-isolation pin: a
                                  regression that mixed tenant slices
                                  breaks this first),
  * `honest_neighbor_members`   — neighbor membership sets equal to
                                  the oracle's.

`hardened=False` is the pre-arena world — one SHARED front door and
scheduler for all tenants (tenancy as a session-id namespace): the
flood fills the shared queue and honest submits shed behind it, so the
unhardened twin scores strictly lower (the per-tenant quota + DRR
fair-share machinery is load-bearing).

Every state and arena lives on `device` (the card unless the caller
asks for the CPU). The byzantine tenant's corruption rebinds a table of
the arena's LENT tenant slice, so the arena copies it back into the
stack and lends it again; the chain heads compared stay host arrays.
"""

from __future__ import annotations

import random

import numpy as np

from hypervisor_tpu_torch.adversarial.scoring import ContainmentReport, fraction

#: Drill shape. Buckets stay a CLOSED two-size set so the drill also
#: exercises the (bucket, T) warm contract; quota is the per-tenant
#: lifecycle queue depth the flood must shed against.
QUICK = {"tenants": 3, "rounds": 4, "flood": 24, "quota": 8}
FULL = {"tenants": 5, "rounds": 8, "flood": 48, "quota": 12}


def _capacity():
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TableCapacity

    return DEFAULT_CONFIG.replace(
        capacity=TableCapacity(
            max_agents=1024,
            max_sessions=1024,
            max_vouch_edges=64,
            max_sagas=16,
            max_steps_per_saga=4,
            max_elevations=16,
            delta_log_capacity=4096,
            event_log_capacity=64,
            trace_log_capacity=64,
        )
    )


def _serving_config(quota: int):
    from hypervisor_tpu_torch.serving import ServingConfig

    return ServingConfig(
        buckets=(4, 8),
        lifecycle_queue_depth=quota,
        # Virtual-clock deadlines: rounds advance `now` by 0.1 s.
        lifecycle_deadline_s=0.05,
        join_deadline_s=0.05,
        action_deadline_s=0.05,
        terminate_deadline_s=0.2,
        saga_deadline_s=0.1,
    )


def _schedule(seed: int, shape: dict) -> list[dict]:
    """The seeded per-round submission schedule, shared verbatim by
    the arena run, the shared-door legacy twin, and the per-neighbor
    solo oracles (determinism: same seed -> same schedule -> same
    trace digest)."""
    rng = random.Random(seed)
    t_count, rounds, flood = (
        shape["tenants"], shape["rounds"], shape["flood"],
    )
    out = []
    for r in range(rounds):
        entries = []
        # Byzantine burst FIRST each round (the griefing shape: the
        # flood races honest arrivals to the queue head — a shared
        # queue fills with sybils before the neighbors' submits land;
        # per-tenant quotas make the order irrelevant). Ragged size:
        # every DRR round is forced to the widest bucket.
        burst = flood + rng.randrange(8)
        for i in range(burst):
            entries.append(
                {
                    "tenant": 0,
                    "sid": f"nn:byz:r{r}:{i}",
                    "did": f"did:nn:byz:r{r}:{i}",
                    "sigma": round(0.05 + 0.1 * rng.random(), 3),
                }
            )
        for t in range(1, t_count):  # the honest light load
            for i in range(2):
                entries.append(
                    {
                        "tenant": t,
                        "sid": f"nn:t{t}:r{r}:{i}",
                        "did": f"did:nn:t{t}:r{r}:{i}",
                        "sigma": round(0.7 + 0.2 * rng.random(), 3),
                    }
                )
        out.append({"round": r, "entries": entries})
    return out


def _oracle_chain_heads(
    schedule: list[dict], tenant: int, quota: int, device="cuda"
) -> tuple[dict, set]:
    """Solo oracle: ONE neighbor's workload alone on a plain
    HypervisorState behind its own front door — the ground truth the
    arena's per-tenant slices must match bit-for-bit."""
    from hypervisor_tpu_torch.serving import FrontDoor, WaveScheduler
    from hypervisor_tpu_torch.state import HypervisorState

    st = HypervisorState(_capacity(), device=device)
    door = FrontDoor(st, _serving_config(quota))
    sched = WaveScheduler(door)
    now = 100.0
    for step in schedule:
        for e in step["entries"]:
            if e["tenant"] != tenant:
                continue
            door.submit_lifecycle(
                e["sid"], e["did"], e["sigma"], now=now
            )
        sched.tick(now)
        now += 0.1
    sched.drain(now)
    heads = {}
    for sid_str in _session_ids(schedule, tenant):
        slot = st.session_slot_of(sid_str)
        if slot is None or slot not in st._chain_seed:
            continue
        heads[sid_str] = np.array(st._chain_seed[slot], copy=True)
    return heads, set(st._members)


def _session_ids(schedule: list[dict], tenant: int) -> list[str]:
    return [
        e["sid"]
        for step in schedule
        for e in step["entries"]
        if e["tenant"] == tenant
    ]


def _corrupt_own_rows(state, round_no: int) -> None:
    """Byzantine self-corruption: poison sigma columns in the tenant's
    OWN table slice (out-of-range values the sanitizer would flag).
    Rides the lend/commit writeback — the containment question is
    whether one byte of it ever reaches a neighbor's slice."""
    from hypervisor_tpu_torch.tables.state import AF32_SIGMA_EFF
    from hypervisor_tpu_torch.tables.struct import replace as t_replace

    agents = state.agents
    row = round_no % agents.f32.shape[0]
    f32 = agents.f32.clone()
    f32[row, AF32_SIGMA_EFF] = 99.0
    state.agents = t_replace(agents, f32=f32)


def noisy_neighbor(
    seed: int, *, hardened: bool = True, quick: bool = True, device="cuda"
) -> ContainmentReport:
    """See module docstring. hardened=True -> TenantArena + per-tenant
    quotas + DRR; hardened=False -> one shared door (the legacy
    deployment-namespace posture)."""
    shape = QUICK if quick else FULL
    report = ContainmentReport("noisy_neighbor", seed, hardened)
    schedule = _schedule(seed, shape)
    t_count, quota = shape["tenants"], shape["quota"]
    neighbors = list(range(1, t_count))

    served: dict[int, int] = {t: 0 for t in range(t_count)}
    shed: dict[int, int] = {t: 0 for t in range(t_count)}
    offered: dict[int, int] = {t: 0 for t in range(t_count)}

    if hardened:
        from hypervisor_tpu_torch.tenancy import (
            TenantArena,
            TenantFrontDoor,
            TenantWaveScheduler,
        )

        arena = TenantArena(t_count, _capacity(), device=device)
        front = TenantFrontDoor(arena, _serving_config(quota))
        sched = TenantWaveScheduler(front)
        now = 100.0
        for step in schedule:
            for e in step["entries"]:
                t = e["tenant"]
                offered[t] += 1
                r = front.submit_lifecycle(
                    t, e["sid"], e["did"], e["sigma"], now=now
                )
                if r.refused:
                    shed[t] += 1
                    report.attack(
                        "shed", t, e["sid"], r.kind
                    ) if t == 0 else report.record(
                        "neighbor_shed", t, e["sid"], r.kind
                    )
                elif t == 0:
                    report.attack("flood", e["sid"])
            # Byzantine self-corruption every other round.
            if step["round"] % 2 == 1:
                _corrupt_own_rows(arena.tenants[0], step["round"])
                report.attack("corrupt_own_slice", step["round"])
            sched.tick(now)
            now += 0.1
        sched.drain(now)
        for t in range(t_count):
            served[t] = front.doors[t].served["lifecycle"]
        chain_states = {t: arena.tenants[t] for t in neighbors}
    else:
        from hypervisor_tpu_torch.serving import FrontDoor, WaveScheduler
        from hypervisor_tpu_torch.state import HypervisorState

        st = HypervisorState(_capacity(), device=device)
        door = FrontDoor(st, _serving_config(quota))
        sched = WaveScheduler(door)
        now = 100.0
        for step in schedule:
            for e in step["entries"]:
                t = e["tenant"]
                offered[t] += 1
                r = door.submit_lifecycle(
                    e["sid"], e["did"], e["sigma"], now=now
                )
                if r.refused:
                    shed[t] += 1
                    report.attack(
                        "shed", t, e["sid"], r.kind
                    ) if t == 0 else report.record(
                        "neighbor_shed", t, e["sid"], r.kind
                    )
                elif t == 0:
                    report.attack("flood", e["sid"])
            if step["round"] % 2 == 1:
                _corrupt_own_rows(st, step["round"])
                report.attack("corrupt_own_slice", step["round"])
            sched.tick(now)
            now += 0.1
        sched.drain(now)
        # Shared door: served counts reconstructed per tenant by sid.
        for t in range(t_count):
            for sid_str in _session_ids(schedule, t):
                slot = st.session_slot_of(sid_str)
                if slot is not None and slot in st._chain_seed:
                    served[t] += 1
        chain_states = {t: st for t in neighbors}

    # ── scoring: the neighbors' world must be untouched ──────────────
    goodputs, unshed, chain_fracs, member_fracs = [], [], [], []
    for t in neighbors:
        goodputs.append(fraction(served[t], offered[t]))
        unshed.append(fraction(offered[t] - shed[t], offered[t]))
        oracle_heads, oracle_members = _oracle_chain_heads(
            schedule, t, quota, device
        )
        state_t = chain_states[t]
        matched = 0
        for sid_str, head in oracle_heads.items():
            slot = state_t.session_slot_of(sid_str)
            if (
                slot is not None
                and slot in state_t._chain_seed
                and np.array_equal(state_t._chain_seed[slot], head)
            ):
                matched += 1
        chain_fracs.append(fraction(matched, len(oracle_heads)))
        if hardened:
            member_fracs.append(
                1.0 if set(state_t._members) == oracle_members else 0.0
            )
    report.set("honest_neighbor_goodput", min(goodputs))
    report.set("honest_neighbor_unshed", min(unshed))
    report.set("honest_neighbor_chains", min(chain_fracs))
    if member_fracs:
        report.set("honest_neighbor_members", min(member_fracs))
    # The flood must have been real (the drill fired) and the byz
    # tenant must have shed against its OWN quota in the hardened
    # posture — a drill where nothing shed anywhere measured nothing.
    report.set(
        "flood_pressure_real",
        1.0 if (shed[0] > 0 or not hardened) else 0.0,
    )
    report.details.update(
        {
            "offered": offered,
            "served": served,
            "shed": shed,
            "neighbors": neighbors,
        }
    )
    return report


__all__ = ["noisy_neighbor"]
