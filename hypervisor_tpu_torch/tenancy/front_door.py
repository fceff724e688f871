"""Tenant-aware admission + fair-share scheduling over a TenantArena.

Two layers, mirroring the solo serving plane (`serving`):

  * `TenantFrontDoor` — one `serving.FrontDoor` PER TENANT, each bound
    to its `TenantState`. Per-tenant queue quotas fall out of the
    structure: a byzantine or flooding tenant fills ITS OWN bounded
    queues and sheds with ITS OWN typed Refusals — neighbors' tickets,
    SLO burn windows, drain-rate EWMAs, and Retry-After hints live in
    their own doors and are untouched (the noisy-neighbor drill pins
    this).
  * `TenantWaveScheduler` — the drain. Lifecycles (the tenant-dense
    hot class) coalesce across tenants by DEFICIT ROUND-ROBIN: each
    round every backlogged tenant earns `quantum` lane credits, spends
    up to its deficit, and the takes ride ONE batched tenant wave
    (`TenantArena.governance_wave_batch` — one donated dispatch for
    all T tenants). A flooding tenant can saturate its own lanes but
    never another tenant's share of the bucket. The remaining classes
    (joins, actions, terminations, saga settles) drain through each
    tenant's solo scheduler pass — every tenant dispatches the SAME
    module-level jit programs at the SAME closed bucket shapes, so the
    whole arena warms once and never recompiles.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from hypervisor_tpu_torch.models import SessionConfig
from hypervisor_tpu_torch.ops import admission
from hypervisor_tpu_torch.ops.merkle import BODY_WORDS
from hypervisor_tpu_torch.serving.front_door import (
    FrontDoor,
    Refusal,
    ServingConfig,
    Ticket,
)
from hypervisor_tpu_torch.serving.scheduler import WaveScheduler
from hypervisor_tpu_torch.tenancy.arena import TenantArena

#: Classes each tenant's solo scheduler pass drains (lifecycles go
#: through the batched tenant wave instead).
SOLO_CLASSES = ("join", "action", "terminate", "saga")


class TenantFrontDoor:
    """Per-tenant ingestion doors over one arena."""

    def __init__(
        self,
        arena: TenantArena,
        config: Optional[ServingConfig] = None,
    ) -> None:
        self.arena = arena
        self.config = config or ServingConfig()
        self.doors: list[FrontDoor] = [
            FrontDoor(st, self.config) for st in arena.tenants
        ]

    def door(self, tenant: int) -> FrontDoor:
        return self.doors[tenant]

    # ── submit paths (delegate to the tenant's own door, so quotas,
    # valves, SLO burn, and refusal accounting stay per tenant) ───────

    def submit_lifecycle(self, tenant: int, *a, **kw) -> Ticket | Refusal:
        return self.doors[tenant].submit_lifecycle(*a, **kw)

    def submit_join(self, tenant: int, *a, **kw) -> Ticket | Refusal:
        return self.doors[tenant].submit_join(*a, **kw)

    def submit_action(self, tenant: int, *a, **kw) -> Ticket | Refusal:
        return self.doors[tenant].submit_action(*a, **kw)

    def submit_terminate(self, tenant: int, *a, **kw) -> Ticket | Refusal:
        return self.doors[tenant].submit_terminate(*a, **kw)

    def submit_saga_step(self, tenant: int, *a, **kw) -> Ticket | Refusal:
        return self.doors[tenant].submit_saga_step(*a, **kw)

    def queue_depths(self) -> dict[int, dict[str, int]]:
        return {t: d.queue_depths() for t, d in enumerate(self.doors)}

    def summary(self, top_k: int = 8) -> dict:
        """The `/debug/tenants` payload: the arena's pressure-ranked
        panel joined with each door's serving summary glance row."""
        out = self.arena.summary(top_k=top_k)
        out["serving"] = {
            t: {
                "shed": dict(d.shed),
                "served": dict(d.served),
                "deadline_misses": d.deadline_misses,
                "retry_after_live_s": {
                    q: d.retry_after_for(q) for q in d._queues
                },
            }
            for t, d in enumerate(self.doors)
        }
        return out


class TenantWaveScheduler:
    """Deficit-round-robin drain across T tenants' doors."""

    def __init__(
        self,
        front: TenantFrontDoor,
        quantum: Optional[int] = None,
        lifecycle_config: Optional[SessionConfig] = None,
    ) -> None:
        self.front = front
        self.arena = front.arena
        self.config = front.config
        #: Lane credits a backlogged tenant earns per round. The
        #: default — one full bucket — gives every tenant an equal
        #: claim to the wave's widest shape each round; a smaller
        #: quantum tightens fairness under sustained contention.
        self.quantum = int(quantum or self.config.max_bucket)
        #: Per-tenant quantum overrides (autopilot `drr.quantum` rule:
        #: a tenant burning SLO budget earns boosted credits until it
        #: recovers). Absent tenants earn the base `quantum`.
        self.quanta: dict[int, float] = {}
        self.deficit = [0.0] * front.arena.num_tenants
        self._lifecycle_config = lifecycle_config or SessionConfig(
            min_sigma_eff=0.0, max_participants=4
        )
        # Per-tenant solo passes for the non-lifecycle classes (same
        # shared jit programs, same closed bucket shapes).
        self.solo = [WaveScheduler(d) for d in front.doors]
        self.ticks = 0
        self.lifecycle_rounds = 0

    # ── per-tenant quanta (the autopilot's DRR knob) ─────────────────

    def quantum_of(self, tenant: int) -> float:
        """The tenant's lane credits per round (base unless boosted)."""
        return float(self.quanta.get(tenant, self.quantum))

    def set_quantum(self, tenant: int, quantum: float) -> None:
        """Override one tenant's quantum (reset by passing the base
        value). Takes effect from the NEXT lifecycle round — banked
        deficit is untouched, so fairness history survives the retune."""
        tenant = int(tenant)
        if float(quantum) == float(self.quantum):
            self.quanta.pop(tenant, None)
        else:
            self.quanta[tenant] = float(quantum)

    # ── bucket arithmetic (the solo rule) ────────────────────────────

    def bucket_for(self, n: int) -> int:
        for b in self.config.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"wave of {n} exceeds the largest bucket "
            f"{self.config.max_bucket}"
        )

    def _lifecycle_due(self, now: float) -> bool:
        for d in self.front.doors:
            q = d.lifecycles
            if len(q) >= self.config.max_bucket:
                return True
            if q and (
                now + self.config.dispatch_margin_s
                >= q[0].submitted_at + self.config.lifecycle_deadline_s
            ):
                return True
        return False

    # ── the DRR lifecycle round ──────────────────────────────────────

    def lifecycle_round(self, now: float) -> int:
        """One fair-share round: DRR take per tenant, ONE batched
        session-create + ONE batched tenant wave, tickets resolved
        against their own doors. Returns lifecycles served."""
        takes: dict[int, list[Ticket]] = {}
        for t, d in enumerate(self.front.doors):
            with d._lock:
                q = d.lifecycles
                if not q:
                    # Standard DRR: an idle flow's credit resets, so a
                    # tenant cannot bank credits while idle and burst
                    # past its fair share later.
                    self.deficit[t] = 0.0
                    continue
                self.deficit[t] += self.quantum_of(t)
                n = min(
                    len(q), int(self.deficit[t]), self.config.max_bucket
                )
                if n <= 0:
                    continue
                self.deficit[t] -= n
                takes[t] = [q.popleft() for _ in range(n)]
        if not takes:
            return 0
        self.lifecycle_rounds += 1
        bucket = self.bucket_for(max(len(v) for v in takes.values()))
        turns = self.config.lifecycle_turns
        t0 = time.perf_counter()
        slots = self.arena.create_sessions_batch(
            {t: [tk.payload["session_id"] for tk in v]
             for t, v in takes.items()},
            self._lifecycle_config,
            pad_to=bucket,
        )
        lanes = {}
        for t, tickets in takes.items():
            bodies = np.zeros((turns, len(tickets), BODY_WORDS), np.uint32)
            for i, tk in enumerate(tickets):
                bodies[:, i, :] = tk.payload["bodies"]
            lanes[t] = {
                "session_slots": slots[t],
                "dids": [tk.payload["agent_did"] for tk in tickets],
                "agent_sessions": slots[t].copy(),
                "sigma_raw": np.array(
                    [tk.payload["sigma_raw"] for tk in tickets],
                    np.float32,
                ),
                "delta_bodies": bodies,
                "trustworthy": np.array(
                    [tk.payload["trustworthy"] for tk in tickets], bool
                ),
            }
        out = self.arena.governance_wave_batch(
            lanes, bucket, now=now
        )
        wall = time.perf_counter() - t0
        served = 0
        for t, tickets in takes.items():
            d = self.front.doors[t]
            res = out[t]
            newest = max(tk.submitted_at for tk in tickets)
            with d._lock:
                for i, tk in enumerate(tickets):
                    d.resolve(
                        tk,
                        ok=res.status[i] == admission.ADMIT_OK,
                        now=now,
                        wall_s=wall,
                        status=int(res.status[i]),
                        result={
                            "merkle_root": res.merkle_root[i].tolist()
                        },
                        newest_submit=newest,
                    )
                    served += 1
                d.note_wave("lifecycle", len(tickets), bucket, now=now)
        return served

    # ── the tick ─────────────────────────────────────────────────────

    def tick(self, now: Optional[float] = None) -> dict:
        """One scheduling pass: the DRR lifecycle round when due, then
        every tenant's solo pass for the remaining classes."""
        now = (
            self.arena.tenants[0].now() if now is None else float(now)
        )
        self.ticks += 1
        report = {"lifecycle_rounds": 0, "lifecycles": 0, "solo": 0}
        if self._lifecycle_due(now):
            report["lifecycles"] = self.lifecycle_round(now)
            report["lifecycle_rounds"] = 1
        for sched in self.solo:
            solo_report = sched.tick(now, classes=SOLO_CLASSES)
            report["solo"] += sum(solo_report.values())
        return report

    def drain(self, now: Optional[float] = None, max_ticks: int = 64) -> int:
        """Tick until every tenant's queues are empty."""
        now = (
            self.arena.tenants[0].now() if now is None else float(now)
        )
        waves = 0
        for _ in range(max_ticks):
            pending = any(
                len(q)
                for d in self.front.doors
                for q in d._queues.values()
            )
            if not pending:
                break
            served = self.lifecycle_round(now)
            if served:
                waves += 1
            for d, sched in zip(self.front.doors, self.solo):
                if any(len(d._queues[c]) for c in SOLO_CLASSES):
                    waves += sched.drain(now, max_ticks=1)
        return waves

    # ── warmup ───────────────────────────────────────────────────────

    def warm(self, now: Optional[float] = None) -> dict:
        """Compile the whole serving tile set: the (bucket, T) tenant
        wave pairs via `TenantArena.warm`, plus tenant 0's solo pass
        (every non-lifecycle program at every bucket — all tenants
        share those programs and shapes, so one tenant's warm covers
        the arena). A warmed arena soak holds ZERO recompiles
        (test-pinned, the closed-bucket contract with a tenant axis).
        """
        now = (
            self.arena.tenants[0].now() if now is None else float(now)
        )
        self.arena.warm(
            self.config.buckets,
            now,
            session_config=self._lifecycle_config,
            turns=self.config.lifecycle_turns,
        )
        return self.solo[0].warm(now)


__all__ = ["SOLO_CLASSES", "TenantFrontDoor", "TenantWaveScheduler"]
