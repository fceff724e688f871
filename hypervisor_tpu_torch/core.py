"""Hypervisor facade: the composition root for multi-agent Shared Sessions.

Capability parity with reference `core.py:37-298`: `create_session`,
`join_session` (IATP enrichment -> reversibility registration -> STRONG
forcing -> history verification -> sigma resolution -> ring assignment ->
sandbox for untrustworthy agents), `activate_session`, `terminate_session`
(Merkle root -> commitment -> bond release -> GC -> archive),
`verify_behavior` (CMVK drift -> slash -> Nexus report), `get_session`,
`active_sessions`.

Like the reference, each ManagedSession owns its ReversibilityRegistry,
DeltaEngine, and SagaOrchestrator while the Hypervisor holds the shared
cross-session engines. Beyond the reference, the facade is backed by the
batched device plane (`HypervisorState`): every join routes through the
jitted admission wave, every captured delta lands in the device DeltaLog
with the same leaf digest as the host chain, and termination runs the
device wave (Merkle root + bond release + archive) — host engines and
device tables share one source of truth. The facade also emits
structured events to an (optional) event bus, which the reference
exports but never wires (`api/server.py:101` instantiates its own).

The port's copy of `hypervisor_tpu.core`: the same methods, names and
semantics over the port's `HypervisorState`, whose tables live on a
torch device ("cuda" by default; `device="cpu"` or a ready `state=` for
the plain path). On CUDA a join runs kernel B4 (`flush_joins`); a
terminate runs B2 in `flush_deltas` when deltas are staged (one launch
chains every staged session), and B3 in the delta engine's root when
the session holds 64 deltas or more (`terminate_sessions` folds its
roots from the live frontier on the host); a drift slash runs B8
(`apply_slash`). Device columns are read back through
`_host`. `ManagedSession.write_wave` builds a `runtime.write_wave.
WriteWave` on the state's device. `attach_front_door` attaches the
serving front door and its wave scheduler (`serving`) to the state, on
the state's device. `consistency_runtime(mesh)` binds a
`runtime.consistency.ConsistencyRuntime` over a `parallel.Mesh` to the
state, cached per mesh. With an event bus the
facade emits its own events and bridges the health plane's onto it
(`_on_health_event`), and incident bundles carry the bus's slice
(`_incident_events_block`).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from typing import Any, Optional

from hypervisor_tpu_torch.audit import CommitmentEngine, DeltaEngine, EphemeralGC
from hypervisor_tpu_torch.audit.gc import RetentionPolicy
from hypervisor_tpu_torch.liability import SlashingEngine, VouchingEngine
from hypervisor_tpu_torch.liability.ledger import LedgerEntryType, LiabilityLedger
from hypervisor_tpu_torch.liability.quarantine import QuarantineManager, QuarantineReason
from hypervisor_tpu_torch.models import (
    ActionDescriptor,
    ConsistencyMode,
    ExecutionRing,
    SessionConfig,
)
from hypervisor_tpu_torch.observability import EventType, HypervisorEvent, HypervisorEventBus
from hypervisor_tpu_torch.observability import metrics as metrics_plane
from hypervisor_tpu_torch.ops.sha256 import digests_to_hex, hex_to_words
from hypervisor_tpu_torch.reversibility import ReversibilityRegistry
from hypervisor_tpu_torch.rings import ActionClassifier, RingEnforcer
from hypervisor_tpu_torch.saga import SagaOrchestrator
from hypervisor_tpu_torch.session import SharedSessionObject
from hypervisor_tpu_torch.state import HypervisorState
from hypervisor_tpu_torch.verification import TransactionHistoryVerifier

logger = logging.getLogger(__name__)

__all__ = ["Hypervisor", "ManagedSession"]

# Omega applied when a drift violation slashes an agent — ONE constant so
# the host SlashingEngine and the device cascade can never diverge.
DRIFT_SLASH_RISK_WEIGHT = 0.95


def _host(column) -> np.ndarray:
    """A device column (or a host array) as a numpy array."""
    if isinstance(column, torch.Tensor):
        return column.cpu().numpy()
    return np.asarray(column)


class ManagedSession:
    """One session plus its session-scoped engines.

    `slot` is the session's row in the device SessionTable; the delta
    engine's sink stages every captured delta into the device DeltaLog
    with the host hash as its leaf digest, so both planes build the same
    Merkle tree.
    """

    def __init__(
        self,
        sso: SharedSessionObject,
        slot: int = -1,
        state: Optional[HypervisorState] = None,
    ) -> None:
        self.sso = sso
        self.slot = slot
        self.reversibility = ReversibilityRegistry(sso.session_id)
        self.delta_engine = DeltaEngine(
            sso.session_id,
            sink=self._stage_delta if state is not None and slot >= 0 else None,
            tensor_device=state.device if state is not None else "cuda",
        )
        self.saga = SagaOrchestrator()
        self._state = state

    def _stage_delta(self, delta) -> None:
        row = self._state.agent_row(delta.agent_did, self.slot)
        self._state.stage_delta(
            self.slot,
            row["slot"] if row else -1,
            ts=self._state.now(),
            digest_words=hex_to_words([delta.delta_hash])[0],
        )

    def write_wave(self, **kwargs):
        """A batched write path over this session's VFS, pre-wired to the
        device plane: writers whose agent rows carry FLAG_QUARANTINED are
        refused before any rate-limit token burns (read-only isolation,
        reference `liability/quarantine.py` semantics). The wave's clocks
        and buckets live on the state's device unless `device=` is given."""
        from hypervisor_tpu_torch.runtime.write_wave import WriteWave

        state = self._state

        slot = self.slot

        def quarantined(did: str) -> bool:
            if state is None:
                return False
            row = state.agent_row(did, slot)
            return bool(row is not None and state.quarantined_mask()[row["slot"]])

        if state is not None:
            kwargs.setdefault("device", state.device)
        return WriteWave(self.sso.vfs, is_quarantined=quarantined, **kwargs)


class Hypervisor:
    """Top-level governance runtime.

    Basic usage (sigma passed directly)::

        hv = Hypervisor()
        session = await hv.create_session(config, creator_did="did:mesh:admin")
        await hv.join_session(session.sso.session_id, "did:mesh:a", sigma_raw=0.85)

    Enriched usage wires NexusAdapter / CMVKAdapter / IATPAdapter so
    join_session resolves sigma and parses manifests automatically.
    """

    def __init__(
        self,
        retention_policy: Optional[RetentionPolicy] = None,
        max_exposure: Optional[float] = None,
        nexus: Optional[Any] = None,
        cmvk: Optional[Any] = None,
        iatp: Optional[Any] = None,
        event_bus: Optional[HypervisorEventBus] = None,
        state: Optional[HypervisorState] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        # The batched device plane every lifecycle call routes through;
        # without a `state`, fresh tables on `device` (raises without CUDA
        # unless the caller asks for the CPU).
        self.state = state if state is not None else HypervisorState(device=device)

        # Shared cross-session engines. Vouches mirror into the device
        # VouchTable (the liability analog of the delta sink): bonds the
        # host engine creates/releases appear as device edges, so slash
        # cascades and sigma_eff contributions run on the same graph.
        self._edge_of_vouch: dict[str, int] = {}
        self.vouching = VouchingEngine(
            max_exposure=max_exposure,
            on_vouch=self._mirror_vouch,
            on_release=self._mirror_release,
        )
        self.slashing = SlashingEngine(self.vouching)
        # High-water mark of engine dedupes already mirrored into
        # `hv_slash_cascade_deduped_total` (the facade owns the mirror;
        # the engine stays metrics-free).
        self._cascade_dedupes_mirrored = 0
        # Vouch-collusion clique scanner over the host mirror of the
        # liability graph (`liability/collusion.py`); run on sweep
        # cadence via `detect_collusion` — findings charge the ledger
        # so the admission gate refuses flagged cliques before they
        # can re-pump.
        from hypervisor_tpu_torch.liability.collusion import CollusionDetector

        self.collusion = CollusionDetector()
        # Findings already charged/counted: quarantined members keep
        # their live edges, so sweep-cadence re-scans re-surface the
        # SAME component — it must not re-charge the ledger (a single
        # neutralized incident would ratchet members to deny within a
        # few ticks) nor re-count hv_collusion_findings_total.
        self._collusion_charged: set[tuple] = set()
        # Persistent cross-session risk accounting, facade-wired as an
        # ADMISSION GATE (the reference exports the ledger but never
        # consults it): slashes/quarantines recorded by verify_behavior
        # charge risk, clean terminations credit it, and join_session
        # applies the recommendation — deny refuses, probation sandboxes
        # (`liability/ledger.py` thresholds 0.3/0.6).
        self.ledger = LiabilityLedger()
        # Shapley-style fault attribution feeding the ledger
        # (attribute_fault).
        from hypervisor_tpu_torch.liability.attribution import CausalAttributor

        self.attributor = CausalAttributor()
        # DIDs penalized per LIVE session (rogues, cascade-clipped
        # vouchers, quarantined agents): consulted at terminate so a
        # penalized participant never also earns the clean-session
        # credit; O(session), dropped at terminate.
        self._penalized_in: dict[str, set[str]] = {}
        self.ring_enforcer = RingEnforcer(trust=self.state.config.trust)
        self.classifier = ActionClassifier()
        self.verifier = TransactionHistoryVerifier()
        self.commitment = CommitmentEngine()
        self.gc = EphemeralGC(retention_policy)
        self.quarantine = QuarantineManager()
        # Graceful termination with saga-step handoff, facade-wired
        # (the reference exports KillSwitch but never wires it).
        from hypervisor_tpu_torch.security.kill_switch import KillSwitch

        self.kill_switch = KillSwitch()
        # Host breach windows for the action gateway (`check_action`);
        # the device twin is the breach columns swept by run_sweeps.
        from hypervisor_tpu_torch.rings import RingBreachDetector

        self.breach_detector = RingBreachDetector()

        # Sudo-with-TTL elevations, facade-wired across BOTH planes
        # (the reference exports its manager but never wires it,
        # SURVEY §1 "exported but not wired"): grants land in the host
        # manager AND the device ElevationTable so `effective_rings`
        # waves and host queries agree.
        from hypervisor_tpu_torch.rings.elevation import RingElevationManager

        self.elevation = RingElevationManager()
        self._elev_row_of: dict[str, int] = {}  # elevation_id -> device row

        # Optional integration adapters.
        self.nexus = nexus
        self.cmvk = cmvk
        self.iatp = iatp

        # Optional structured event emission (facade-wired, unlike reference).
        self.event_bus = event_bus
        self._events_mirrored = 0
        # Health-plane events (stragglers, capacity warnings,
        # recompiles) bridge onto the same bus: the straggler payload
        # carries the wave's CausalTraceId, so `GET /trace/{session}`
        # joins the event onto the stalled wave's spans.
        if self.event_bus is not None:
            self.state.health.add_listener(self._on_health_event)
            # Incident bundles carry an event-bus slice; the bus lives
            # on the facade (not the state), so its context provider
            # registers here (`observability.incidents`).
            self.state.incidents.register_provider(
                "events", self._incident_events_block
            )

        self._sessions: dict[str, ManagedSession] = {}
        # Keyed by Mesh (hashable): same mesh -> same runtime instance.
        self._consistency_runtimes: dict[Any, Any] = {}
        # Serving front door (lazy, `attach_front_door`): the batched
        # API endpoints route through it; None until first use.
        self.front_door = None
        self._serving_scheduler = None

    def attach_front_door(self, config=None):
        """Attach (or return) the serving front door + wave scheduler
        (`hypervisor_tpu_torch.serving`): bounded ingestion queues with the
        degraded-mode valve, draining into shape-bucketed waves. The
        batched/streaming API endpoints call this lazily."""
        if self.front_door is None:
            from hypervisor_tpu_torch.serving import FrontDoor, WaveScheduler

            self.front_door = FrontDoor(self.state, config)
            self._serving_scheduler = WaveScheduler(self.front_door)
        return self.front_door

    @property
    def serving_scheduler(self):
        self.attach_front_door()
        return self._serving_scheduler

    # ── lifecycle ────────────────────────────────────────────────────

    async def create_session(
        self, config: SessionConfig, creator_did: str
    ) -> ManagedSession:
        """Create a Shared Session and advance it into HANDSHAKING."""
        sso = SharedSessionObject(config=config, creator_did=creator_did)
        sso.begin_handshake()
        slot = self.state.create_session(sso.session_id, config)
        managed = ManagedSession(sso, slot=slot, state=self.state)
        # Saga steps pass the live isolation gates before executing: a
        # mid-saga quarantine or breaker trip refuses the NEXT step on
        # both planes (the reference exports the gates but never
        # consults them on the saga path).
        managed.saga.gate = self._saga_gate(managed)
        self._sessions[sso.session_id] = managed
        self._emit(
            EventType.SESSION_CREATED, session_id=sso.session_id, agent_did=creator_did
        )
        return managed

    async def join_session(
        self,
        session_id: str,
        agent_did: str,
        actions: Optional[list[ActionDescriptor]] = None,
        sigma_raw: float = 0.0,
        manifest: Optional[Any] = None,
        agent_history: Optional[Any] = None,
    ) -> ExecutionRing:
        """Admit an agent via the extended IATP handshake pipeline.

        1. Parse IATP manifest (adapter + manifest provided)
        2. Register declared actions in the Reversibility Registry
        3. Force STRONG consistency if any action is non-reversible
        4. Verify DID transaction history
        5. Resolve sigma (Nexus or raw) and assign the ring
        """
        managed = self._require(session_id)

        # Byzantine-input gate: a non-finite or out-of-range sigma
        # would sail through every threshold compare (NaN compares
        # false) into the device tables, where the integrity sanitizer
        # flags it as a sigma-range violation — refuse it at the door
        # instead (the API-fuzz scenario's containment bar).
        sigma_f = float(sigma_raw)
        if not np.isfinite(sigma_f) or not 0.0 <= sigma_f <= 1.0:
            from hypervisor_tpu_torch.session import SessionParticipantError

            raise SessionParticipantError(
                f"sigma_raw must be finite in [0, 1]; got {sigma_raw!r}"
            )

        # Liability-ledger gate FIRST: a denied agent must not mutate
        # the session on its way out (manifest registration would force
        # STRONG consistency with no un-force path). Deny refuses;
        # probation joins sandboxed.
        admit_ok, recommendation = self.ledger.should_admit(agent_did)
        if not admit_ok:
            from hypervisor_tpu_torch.session import SessionParticipantError

            profile = self.ledger.compute_risk_profile(agent_did)
            raise SessionParticipantError(
                f"Agent {agent_did} denied by liability ledger "
                f"(risk {profile.risk_score:.2f} >= "
                f"{self.ledger.DENY_THRESHOLD})"
            )

        if self.iatp and manifest:
            if isinstance(manifest, dict):
                analysis = self.iatp.analyze_manifest_dict(manifest)
            else:
                analysis = self.iatp.analyze_manifest(manifest)
            if not actions:
                actions = analysis.actions
            if sigma_raw == 0.0:
                sigma_raw = analysis.sigma_hint
            logger.debug(
                "IATP manifest parsed for %s: ring_hint=%s", agent_did, analysis.ring_hint
            )

        if actions:
            managed.reversibility.register_from_manifest(actions)

        if managed.reversibility.has_non_reversible_actions():
            managed.sso.force_consistency_mode(ConsistencyMode.STRONG)
            # The device row's mode column drives STRONG/EVENTUAL tick
            # dispatch; both planes must agree.
            self.state.force_session_mode(managed.slot, ConsistencyMode.STRONG)

        verification = self.verifier.verify(agent_did)

        sigma_eff = sigma_raw
        if self.nexus and sigma_raw == 0.0:
            sigma_eff = self.nexus.resolve_sigma(agent_did, history=agent_history)
            logger.debug("Nexus resolved sigma=%.3f for %s", sigma_eff, agent_did)
        elif self.nexus and agent_history:
            # Conservative: explicit sigma is cross-checked against Nexus.
            sigma_eff = min(
                sigma_raw, self.nexus.resolve_sigma(agent_did, history=agent_history)
            )

        ring = self.ring_enforcer.compute_ring(sigma_eff)
        if not verification.is_trustworthy or recommendation == "probation":
            ring = ExecutionRing.RING_3_SANDBOX

        # The jitted admission wave is authoritative: it applies the same
        # state/duplicate/capacity/sigma-floor rules as the host SSO over
        # the device tables. On rejection, the host join reproduces the
        # exact reference exception for the single-call API. Outcome is
        # correlated by MEMBERSHIP, not flush-status position — a
        # concurrent flusher may legally drain our staged join before our
        # own flush, so status indices are not ours to trust.
        if self.state.is_member(managed.slot, agent_did):
            # Faithful duplicate rejection before staging a doomed join.
            managed.sso.join(
                agent_did=agent_did,
                sigma_raw=sigma_raw,
                sigma_eff=sigma_eff,
                ring=ring,
            )
            raise RuntimeError(
                f"device/SSO divergence: {agent_did} is a device member "
                "but joined the host session"
            )
        queued = self.state.enqueue_join(
            managed.slot,
            agent_did,
            sigma_eff,
            # Ledger probation sandboxes on the device plane through the
            # same untrustworthy path, so host and device rings agree.
            trustworthy=(
                verification.is_trustworthy and recommendation != "probation"
            ),
        )
        if queued < 0:
            raise RuntimeError("admission staging queue full; flush pending joins")
        self.state.flush_joins(now=self.state.now())
        if not self.state.is_member(managed.slot, agent_did):
            managed.sso.join(
                agent_did=agent_did,
                sigma_raw=sigma_raw,
                sigma_eff=sigma_eff,
                ring=ring,
            )
            raise RuntimeError(
                f"device admission rejected what the host session accepted "
                f"— table/SSO divergence for {agent_did}"
            )
        device_ring = self.state.agent_row(agent_did, managed.slot)
        if device_ring is not None and device_ring["ring"] != ring.value:
            raise RuntimeError(
                f"ring divergence for {agent_did}: host {ring.value}, "
                f"device {device_ring['ring']}"
            )

        managed.sso.join(
            agent_did=agent_did, sigma_raw=sigma_raw, sigma_eff=sigma_eff, ring=ring
        )
        # The membership row carries the agent's ledger risk (the
        # risk_score column admission resets to 0).
        risk = self.ledger.compute_risk_profile(agent_did).risk_score
        if risk > 0.0:
            row = self.state.agent_row(agent_did, managed.slot)
            if row is not None:
                self.state.set_agent_risk(row["slot"], risk)
        # Bonds recorded before this agent was device-resident gain their
        # VouchTable edges now that it has a row.
        self._backfill_vouch_mirror(agent_did)
        self._emit(
            EventType.SESSION_JOINED,
            session_id=session_id,
            agent_did=agent_did,
            payload={"ring": ring.value, "sigma_eff": sigma_eff},
        )
        return ring

    async def sweep_expired_sessions(self) -> list[str]:
        """Terminate every live session past its `max_duration_seconds`.

        The reference stores the limit but never enforces it; this runs
        overdue sessions through the FULL termination path (Merkle root,
        commitment, bond release, GC, archive) and returns their ids.
        Call it on the same cadence as the other sweeps
        (`docs/OPERATIONS.md` "Ticks the operator owns").
        """
        overdue = self.state.session_expiry_sweep(self.state.now())
        slot_to_id = {m.slot: sid for sid, m in self._sessions.items()}
        expired = []
        for slot in overdue:
            sid = slot_to_id.get(slot)
            if sid is None:
                continue
            await self.terminate_session(sid)
            expired.append(sid)
        return expired

    async def leave_session(self, session_id: str, agent_did: str) -> None:
        """Remove a participant from both planes.

        The reference exposes leave only on the SSO (`session/__init__.py
        leave`); here the facade keeps the device tables coherent: the
        host participant deactivates, the membership's device row frees,
        the session count drops, and the leaver's mirrored vouch edges
        scrub (bonds survive host-side and re-mirror on a later join).
        The agent's rows in other sessions are untouched — one device
        row per (agent, session).
        """
        from hypervisor_tpu_torch.session import SessionParticipantError

        managed = self._require(session_id)
        # Validate BOTH planes before mutating either: a refusal after
        # sso.leave would leave the host saying "gone" while the device
        # still counts the agent — an unrepairable divergence.
        participant = managed.sso.get_participant(agent_did)  # raises ghost
        if not participant.is_active:
            raise SessionParticipantError(
                f"Agent {agent_did} already left session"
            )
        row = self.state.agent_row(agent_did, managed.slot)
        if row is None:
            raise RuntimeError(
                f"{agent_did} has no live device row in {session_id} — "
                "plane divergence"
            )
        managed.sso.leave(agent_did)
        self.state.leave_agent(managed.slot, agent_did)
        self._detach_and_remirror(self.state.pop_scrubbed_edges())
        # A departed agent can no longer substitute for killed peers.
        self.kill_switch.unregister_substitute(session_id, agent_did)
        # A membership's elevation dies with it on BOTH planes (the
        # device row scrub happened inside leave_agent). Mapping entries
        # purge for EVERY grant of the membership — including lapsed
        # unswept ones, whose stale row handles could otherwise target a
        # recycled row the same agent's NEXT grant occupies.
        held = self.elevation.get_active_elevation(agent_did, session_id)
        if held is not None:
            self.elevation.revoke_elevation(held.elevation_id)
        self._purge_grant_mappings(
            lambda g: g.agent_did == agent_did and g.session_id == session_id
        )

    async def update_agent_ring(
        self,
        session_id: str,
        agent_did: str,
        new_ring: ExecutionRing,
        reason: str = "",
    ) -> None:
        """Reassign a participant's ring on BOTH planes.

        The reference exposes ring updates only on the SSO
        (`session/__init__.py update_ring`); the facade version also
        rewrites the device row (ring column + rate-limit bucket
        recreated at the new ring's burst) and emits RING_DEMOTED /
        RING_ELEVATED.
        """
        managed = self._require(session_id)
        before = managed.sso.get_participant(agent_did).ring
        managed.sso.update_ring(agent_did, new_ring)
        row = self.state.agent_row(agent_did, managed.slot)
        if row is not None:
            self.state.set_agent_ring(
                row["slot"], new_ring.value, now=self.state.now()
            )
        # An explicit ring update retires a live grant that no longer
        # fits: a promotion at or beyond the grant makes it moot, and a
        # DEMOTION must not leave the agent holding sudo privileges the
        # operator just revoked at the base (a Ring-3 demotion with a
        # surviving Ring-1 grant would keep resolving Ring 1 for the
        # grant's whole TTL on both planes). The reference's host
        # manager returns the grant ring blindly (`elevation.py:138-
        # 145`); the device resolves min(base, grant) — retiring the
        # superseded grant keeps the planes' answers identical without
        # changing either semantic.
        held = self.elevation.get_active_elevation(agent_did, session_id)
        if held is not None and (
            new_ring.value <= held.elevated_ring.value
            or new_ring.value > before.value
        ):
            self._retire_grant(held)
        if new_ring.value != before.value:
            self._emit(
                EventType.RING_DEMOTED
                if new_ring.value > before.value
                else EventType.RING_ELEVATED,
                session_id=session_id,
                agent_did=agent_did,
                payload={
                    "from": before.value,
                    "to": new_ring.value,
                    "reason": reason,
                },
            )

    async def activate_session(self, session_id: str) -> None:
        managed = self._require(session_id)
        managed.sso.activate()
        from hypervisor_tpu_torch.models import SessionState

        self.state.set_session_state(managed.slot, SessionState.ACTIVE)
        self._emit(EventType.SESSION_ACTIVATED, session_id=session_id)

    async def terminate_session(self, session_id: str) -> Optional[str]:
        """Terminate, commit the audit trail, release bonds, GC, archive.

        The device wave is authoritative: staged deltas flush to the
        DeltaLog and `terminate_sessions` folds the Merkle root from the
        session's incremental frontier (O(log n) hashes over leaves
        bit-identical to the host chain — `audit/frontier.py`), releases
        session-scoped bonds in the VouchTable, deactivates participants,
        and archives the session row. Returns the Merkle-root summary
        hash (None when audit is disabled).
        """
        managed = self._require(session_id)
        managed.sso.terminate()

        self.state.flush_deltas()
        roots = self.state.terminate_sessions(
            [managed.slot], now=self.state.now()
        )

        merkle_root = None
        if managed.sso.config.enable_audit and managed.delta_engine.turn_count:
            merkle_root = digests_to_hex(roots[:1])[0]
            host_root = managed.delta_engine.compute_merkle_root()
            if host_root != merkle_root:
                raise RuntimeError(
                    f"audit divergence for {session_id}: device root "
                    f"{merkle_root} != host root {host_root}"
                )
            self.commitment.commit_device_root(
                session_id=session_id,
                root_words=roots[0],
                participant_dids=[p.agent_did for p in managed.sso.participants],
                delta_count=managed.delta_engine.turn_count,
            )
            self._emit(
                EventType.AUDIT_COMMITTED,
                session_id=session_id,
                payload={"merkle_root": merkle_root},
            )

        # The device wave above already released the session's edges in
        # one masked update; recycle their rows host-side and detach the
        # mirror so the host engine's per-bond releases below don't issue
        # one redundant device write each.
        session_rows = [
            self._edge_of_vouch.pop(rec.vouch_id)
            for rec in self.vouching.session_records(session_id)
            if rec.vouch_id in self._edge_of_vouch
        ]
        self.state.free_edge_rows(session_rows)
        self.vouching.release_session_bonds(session_id)

        # Cross-session edges referencing this session's reclaimed agent
        # rows were scrubbed by the device GC (their bonds survive
        # host-side); detach those mirror entries and re-attach wherever
        # the endpoints are still resident.
        self._detach_and_remirror(self.state.pop_scrubbed_edges())

        # Clean terminations credit the ledger: active participants who
        # were not penalized in THIS session (slashed as rogue, clipped
        # as a cascade voucher, or quarantined) earn the clean-session
        # credit (risk decays toward admission).
        penalized = self._penalized_in.pop(session_id, set())
        for p in managed.sso.participants:
            if (
                p.is_active
                and p.agent_did not in penalized
                and self.quarantine.get_active_quarantine(
                    p.agent_did, session_id
                )
                is None
            ):
                self.ledger.record(
                    p.agent_did,
                    LedgerEntryType.CLEAN_SESSION,
                    session_id=session_id,
                )

        # The session's elevations die with it on both planes (device
        # rows were scrubbed with the participant reclaim); mapping
        # entries purge for lapsed unswept grants too (stale handles).
        for grant in self.elevation.active_elevations:
            if grant.session_id == session_id:
                self.elevation.revoke_elevation(grant.elevation_id)
        self._purge_grant_mappings(lambda g: g.session_id == session_id)
        self.kill_switch.drop_session(session_id)

        self.gc.collect(
            session_id=session_id,
            vfs=managed.sso.vfs,
            delta_engine=managed.delta_engine,
            delta_count=managed.delta_engine.turn_count,
        )

        managed.sso.archive()
        self._emit(
            EventType.SESSION_TERMINATED,
            session_id=session_id,
            payload={"merkle_root": merkle_root},
        )
        return merkle_root

    # ── the action gateway: every per-action gate, composed ──────────

    async def check_action(
        self,
        session_id: str,
        agent_did: str,
        action: ActionDescriptor,
        has_consensus: bool = False,
        has_sre_witness: bool = False,
    ):
        """Run one action through EVERY per-action gate, in order:

          1. circuit breaker — an agent whose breach window already
             tripped the breaker is refused for the cooldown
             (`rings/breach_detector.py:149-186`),
          2. quarantine — a quarantined membership is read-only
             (`liability/quarantine.py` isolation semantics): non-read-
             only actions refuse before any token burns,
          3. ring enforcement at the EFFECTIVE ring — the membership's
             base ring with live sudo grants applied
             (`RingEnforcer.check`, reference precedence
             `rings/enforcer.py:61-120`),
          4. rate limit — one token from the membership row's device
             bucket, rated at the effective ring's budget (per-ring
             rates, `security/rate_limiter.py:52-57`),
          5. breach recording — the call lands in BOTH planes' breach
             windows regardless of outcome (refused probes count), and
             an anomalous pattern may trip the circuit breaker.

        The reference ships every gate but leaves composing them to the
        caller; this is the wired pipeline — the N=1 case of the
        batched `check_actions` wave (`ops.gateway.check_actions`).
        Returns an ActionCheckResult.
        """
        results = await self.check_actions(
            session_id,
            [(agent_did, action, has_consensus, has_sre_witness)],
        )
        return results[0]

    async def check_actions(
        self,
        session_id: str,
        requests: list,
    ):
        """Run a WAVE of actions through every per-action gate as ONE
        fused device program (`ops.gateway.check_actions`).

        `requests` is a list of `(agent_did, action)` or
        `(agent_did, action, has_consensus, has_sre_witness)` tuples,
        settled in wave order: an early action's recording can trip the
        circuit breaker that refuses a later action, and two actions on
        one membership's bucket consume sequentially — bit-compatible
        with running `check_action` per element (pinned by
        `tests/parity/test_gateway_wave.py`). One deliberate divergence
        under ERROR: membership is validated for the whole wave before
        anything records, so a request naming an unknown agent raises
        with NO state change on either plane (the sequential loop would
        have committed the actions before the bad one).

        Host-plane mirror: the sliding-window breach detector records
        every call in order BEFORE the wave (its trips feed gate 1 via
        the `host_tripped` column — EITHER plane's breaker refuses), so
        forensic events and device verdicts stay coherent. Returns a
        list of ActionCheckResult in request order.
        """
        from hypervisor_tpu_torch.ops import gateway as gateway_ops
        from hypervisor_tpu_torch.ops import rings as ring_ops_mod
        from hypervisor_tpu_torch.rings import RingCheckResult, _render_reason
        from hypervisor_tpu_torch.security.action_gateway import ActionCheckResult

        managed = self._require(session_id)
        if not requests:
            return []
        norm = []
        for req in requests:
            agent_did, action = req[0], req[1]
            has_consensus = bool(req[2]) if len(req) > 2 else False
            has_sre_witness = bool(req[3]) if len(req) > 3 else False
            norm.append((agent_did, action, has_consensus, has_sre_witness))

        slots, req_rings, read_only, consensus, witness = [], [], [], [], []
        participants = []
        for agent_did, action, has_consensus, has_sre_witness in norm:
            participant = managed.sso.get_participant(agent_did)
            row = self.state.agent_row(agent_did, managed.slot)
            if row is None:
                raise RuntimeError(
                    f"{agent_did} has no live device row in {session_id} — "
                    "plane divergence"
                )
            participants.append(participant)
            slots.append(row["slot"])
            req_rings.append(action.required_ring.value)
            read_only.append(bool(action.is_read_only))
            consensus.append(has_consensus)
            witness.append(has_sre_witness)

        # Host-plane mirror, in wave order: the sliding window sees every
        # call — including ones the wave will refuse (probing a
        # privileged ring repeatedly IS the anomaly signal). Sudo grants
        # apply to the window's view: a legitimately-elevated call is not
        # privileged probing. Each action's host breaker state is read
        # AFTER the mirror recorded everything before it, so a host-plane
        # trip mid-wave refuses later actions exactly like the sequential
        # pipeline would.
        breach_events, host_tripped = [], []
        for (agent_did, action, _, _), participant in zip(norm, participants):
            host_tripped.append(
                self.breach_detector.is_breaker_tripped(agent_did, session_id)
            )
            eff_host = self.elevation.get_effective_ring(
                agent_did, session_id, participant.ring
            )
            breach_events.append(
                self.breach_detector.record_call(
                    agent_did, session_id, eff_host, action.required_ring
                )
            )

        wave = self.state.check_actions_wave(
            slots, req_rings, read_only, consensus, witness, host_tripped,
            now=self.state.now(),
        )
        verdict = _host(wave.verdict)
        ring_status = _host(wave.ring_status)
        eff_rings = _host(wave.eff_ring)
        # The sigma the device ring gate actually decided on — reported
        # verbatim so a plane desync can't yield a reason that
        # contradicts the verdict.
        sigmas = _host(wave.sigma_eff)

        results = []
        for i, (agent_did, action, _, _) in enumerate(norm):
            # Events publish here — per action, AFTER the wave committed,
            # in the sequential pipeline's order (an action's breach
            # event precedes its rate refusal event).
            if breach_events[i] is not None:
                self._emit(
                    EventType.RING_BREACH_DETECTED,
                    session_id=session_id,
                    agent_did=agent_did,
                    payload={
                        "severity": breach_events[i].severity.value,
                        "anomaly_rate": round(breach_events[i].actual_rate, 4),
                    },
                )
            eff_ring = ExecutionRing(int(eff_rings[i]))
            code = int(ring_status[i])
            v = int(verdict[i])
            ring_check = None
            if v not in (gateway_ops.GATE_BREAKER, gateway_ops.GATE_QUARANTINED):
                # Gates 1–2 refuse before the ring gate evaluates.
                ring_check = RingCheckResult(
                    allowed=code == ring_ops_mod.CHECK_OK,
                    required_ring=action.required_ring,
                    agent_ring=eff_ring,
                    sigma_eff=float(sigmas[i]),
                    reason=_render_reason(
                        code,
                        float(sigmas[i]),
                        int(eff_rings[i]),
                        action.required_ring.value,
                        trust=self.state.config.trust,
                    ),
                    requires_consensus=code == ring_ops_mod.CHECK_NEEDS_CONSENSUS,
                    requires_sre_witness=code
                    == ring_ops_mod.CHECK_NEEDS_SRE_WITNESS,
                )
            if v == gateway_ops.GATE_BREAKER:
                result = ActionCheckResult(
                    allowed=False,
                    reason="circuit breaker tripped (breach cooldown)",
                    effective_ring=eff_ring,
                    required_ring=action.required_ring,
                    breaker_tripped=True,
                    breach_event=breach_events[i],
                )
            elif v == gateway_ops.GATE_QUARANTINED:
                result = ActionCheckResult(
                    allowed=False,
                    reason="agent is quarantined (read-only isolation)",
                    effective_ring=eff_ring,
                    required_ring=action.required_ring,
                    quarantined=True,
                    breach_event=breach_events[i],
                )
            elif v == gateway_ops.GATE_RING:
                result = ActionCheckResult(
                    allowed=False,
                    reason=ring_check.reason,
                    effective_ring=eff_ring,
                    required_ring=action.required_ring,
                    ring_check=ring_check,
                    breach_event=breach_events[i],
                )
            elif v == gateway_ops.GATE_RATE:
                self._emit(
                    EventType.RATE_LIMITED,
                    session_id=session_id,
                    agent_did=agent_did,
                    payload={"action_id": action.action_id},
                )
                result = ActionCheckResult(
                    allowed=False,
                    reason=f"rate limit exceeded for ring {eff_ring.value}",
                    effective_ring=eff_ring,
                    required_ring=action.required_ring,
                    rate_limited=True,
                    ring_check=ring_check,
                    breach_event=breach_events[i],
                )
            else:
                result = ActionCheckResult(
                    allowed=True,
                    reason="allowed",
                    effective_ring=eff_ring,
                    required_ring=action.required_ring,
                    ring_check=ring_check,
                    breach_event=breach_events[i],
                )
            results.append(result)
        return results

    def _saga_gate(self, managed):
        """Build the per-step isolation gate for a session's saga
        orchestrator: quarantine (read-only isolation) and the circuit
        breaker, consulted on BOTH planes before each step executes.

        Scope is deliberately gates 1–2 of `check_action`: the saga's
        steps were ring-authorized when the saga was defined; quarantine
        and breaker trips are the LIVE state changes that must interrupt
        an in-flight saga. Action-classified steps can still route
        through the full gateway via `check_action` explicitly.
        """
        session_id = managed.sso.session_id

        async def gate(step):
            if self.breach_detector.is_breaker_tripped(
                step.agent_did, session_id
            ):
                return "circuit breaker tripped (breach cooldown)"
            row = self.state.agent_row(step.agent_did, managed.slot)
            if row is None:
                # No device row (e.g. a step assigned to an external
                # agent): nothing to gate, matching reference behavior.
                return None
            return self.state.isolation_refusal(row["slot"])

        return gate

    # ── causal fault attribution -> ledger ───────────────────────────

    def attribute_fault(
        self,
        saga_id: str,
        session_id: str,
        agent_actions: dict,
        failure_step_id: str,
        failure_agent_did: str,
        risk_weights: Optional[dict] = None,
    ):
        """Run Shapley-style fault attribution for a failed saga and
        charge every involved agent's ledger share.

        The reference exports CausalAttributor but never wires it
        (`liability/attribution.py:66-207`); here each agent's
        liability share lands as a FAULT_ATTRIBUTED ledger charge
        (severity = its normalized share), feeding the same persistent
        risk the admission gate consults — and, for a LIVE session,
        attributed agents are marked penalized so the session's
        clean-credit skips them (post-mortem attribution of an already
        archived session charges the ledger only — its clean credits
        were settled at terminate). Returns the AttributionResult.
        """
        managed = self._require(session_id)  # unknown sessions refuse
        result = self.attributor.attribute(
            saga_id=saga_id,
            session_id=session_id,
            agent_actions=agent_actions,
            failure_step_id=failure_step_id,
            failure_agent_did=failure_agent_did,
            risk_weights=risk_weights,
        )
        session_live = managed.sso.state.value not in (
            "archived", "terminating"
        )
        for fault in result.attributions:
            if fault.liability_score <= 0.0:
                continue
            if session_live:
                # Never re-create a penalty set for a dead session key
                # (terminate already popped it — the entry would leak).
                self._penalized_in.setdefault(session_id, set()).add(
                    fault.agent_did
                )
            self.ledger.record(
                fault.agent_did,
                LedgerEntryType.FAULT_ATTRIBUTED,
                session_id=session_id,
                severity=fault.liability_score,
                details=f"saga {saga_id} step {failure_step_id}",
            )
        self._emit(
            EventType.FAULT_ATTRIBUTED,
            session_id=session_id,
            agent_did=failure_agent_did,
            payload={
                "saga_id": saga_id,
                "shares": {
                    f.agent_did: round(f.liability_score, 4)
                    for f in result.attributions
                },
            },
        )
        return result

    # ── collusion detection -> ledger ────────────────────────────────

    def detect_collusion(
        self,
        session_id: Optional[str] = None,
        charge: bool = True,
        quarantine: bool = True,
    ):
        """Scan the live vouch graph for sigma-pump cliques
        (`liability.collusion.CollusionDetector`) and make the findings
        BITE. With `quarantine` every flagged member's membership in
        the finding's session goes read-only on BOTH planes (host
        QuarantineManager + FLAG_QUARANTINED on the device row — the
        same isolation verify_behavior applies to a slashed rogue), so
        a pumped clique is neutralized BEFORE its defection step. With
        `charge` every member also takes a FAULT_ATTRIBUTED ledger
        charge at the finding's score (persistent risk the admission
        gate consults — repeat findings ratchet toward probation/deny)
        and is marked penalized so terminate's clean-session credit
        skips it. Run on the sweep cadence (`docs/OPERATIONS.md`
        "Ticks the operator owns"); returns the findings.
        """
        findings = self.collusion.scan(self.vouching, session_id)
        fresh_keys = {
            (f.session_id, f.members)
            for f in findings
            if (f.session_id, f.members) not in self._collusion_charged
        }
        if fresh_keys:
            self.state.metrics.inc(
                metrics_plane.COLLUSION_FINDINGS, len(fresh_keys)
            )
        for finding in findings:
            key = (finding.session_id, finding.members)
            is_fresh = key in fresh_keys
            self._collusion_charged.add(key)
            managed = self._sessions.get(finding.session_id)
            session_live = managed is not None and (
                managed.sso.state.value not in ("archived", "terminating")
            )
            detail = (
                f"collusion clique of {len(finding.members)} "
                f"(density {finding.density:.2f}, dual-role "
                f"{finding.dual_role_fraction:.2f}, internal bonds "
                f"{finding.internal_bond_fraction:.2f})"
            )
            for member in finding.members:
                # Ledger charges only once per distinct finding —
                # sweep-cadence re-scans of a persisting (already
                # neutralized) component must not ratchet risk.
                if charge and is_fresh:
                    if session_live:
                        self._penalized_in.setdefault(
                            finding.session_id, set()
                        ).add(member)
                    self.ledger.record(
                        member,
                        LedgerEntryType.FAULT_ATTRIBUTED,
                        session_id=finding.session_id,
                        severity=finding.score,
                        details=detail,
                    )
                if quarantine and session_live:
                    row = self.state.agent_row(member, managed.slot)
                    if row is not None:
                        self.state.quarantine_rows(
                            [row["slot"]], now=self.state.now()
                        )
                    if (
                        self.quarantine.get_active_quarantine(
                            member, finding.session_id
                        )
                        is None
                    ):
                        self.quarantine.quarantine(
                            member,
                            finding.session_id,
                            QuarantineReason.LIABILITY_VIOLATION,
                            details=detail,
                            duration_seconds=int(
                                self.state.config.quarantine
                                .default_duration_seconds
                            ),
                            forensic_data=finding.to_dict(),
                        )
                        if charge:
                            self.ledger.record(
                                member,
                                LedgerEntryType.QUARANTINE_ENTERED,
                                session_id=finding.session_id,
                                severity=finding.score,
                            )
                        self._emit(
                            EventType.QUARANTINE_ENTERED,
                            session_id=finding.session_id,
                            agent_did=member,
                            payload={
                                "reason": (
                                    QuarantineReason
                                    .LIABILITY_VIOLATION.value
                                )
                            },
                        )
            if is_fresh:
                self._emit(
                    EventType.COLLUSION_DETECTED,
                    session_id=finding.session_id,
                    payload=finding.to_dict(),
                )
        return findings

    # ── kill switch (graceful termination, both planes) ──────────────

    async def kill_agent(
        self,
        session_id: str,
        agent_did: str,
        reason=None,
        in_flight_steps: Optional[list] = None,
        details: str = "",
        scheduler=None,
        step_index: Optional[dict] = None,
        substitute_executors: Optional[dict] = None,
    ):
        """Gracefully terminate one agent: hand its in-flight saga steps
        to substitutes (or route them to compensation), then remove the
        membership from BOTH planes.

        The reference exports KillSwitch but never wires it into the
        Hypervisor (`security/kill_switch.py:64-180`); here the victim
        is validated as an ACTIVE participant before any side effect
        (a failed kill must not log a phantom KillResult or rotate the
        substitute pool), then the handoff runs (the victim leaves the
        pool before rehoming, so it can never rescue itself), then the
        full leave_session path retires the device row, scrubs its
        vouch edges, and kills the membership's elevations.

        Substitute routing in the KillResult is BOOKKEEPING until the
        steps are rewired onto the device saga table: pass `scheduler`
        (a `runtime.saga_scheduler.SagaScheduler`) plus its
        `step_index` and `substitute_executors` to run
        `scheduler.apply_handoffs` here — executors are host callables,
        so callers that only know DIDs (e.g. the REST endpoint) get the
        routing decision recorded but must rewire separately. Returns
        the KillResult.
        """
        from hypervisor_tpu_torch.security.kill_switch import KillReason
        from hypervisor_tpu_torch.session import SessionParticipantError

        if reason is None:
            reason = KillReason.MANUAL
        managed = self._require(session_id)
        participant = managed.sso.get_participant(agent_did)  # raises ghost
        if not participant.is_active:
            raise SessionParticipantError(
                f"Agent {agent_did} already left session"
            )
        # Mirror leave_session's device-plane guard too: a missing row
        # would make the leave below raise AFTER the kill was logged.
        if self.state.agent_row(agent_did, managed.slot) is None:
            raise RuntimeError(
                f"{agent_did} has no live device row in {session_id} — "
                "plane divergence"
            )
        result = self.kill_switch.kill(
            agent_did,
            session_id,
            reason=reason,
            in_flight_steps=in_flight_steps,
            details=details,
        )
        if scheduler is not None:
            # Re-arm the isolation gate on each SUBSTITUTE's own row —
            # a handed-off step must stay gated on its new owner, not
            # run ungated (nor gated on the dead victim).
            sub_slots = {}
            for handoff in result.handoffs:
                if handoff.to_agent is None:
                    continue
                sub_row = self.state.agent_row(
                    handoff.to_agent, managed.slot
                )
                if sub_row is not None:
                    sub_slots[handoff.to_agent] = sub_row["slot"]
            scheduler.apply_handoffs(
                result,
                step_index or {},
                substitute_executors or {},
                substitute_slots=sub_slots,
            )
        await self.leave_session(session_id, agent_did)
        self._emit(
            EventType.AGENT_KILLED,
            session_id=session_id,
            agent_did=agent_did,
            payload={
                "reason": result.reason.value,
                "handoffs": len(result.handoffs),
                "handed_off": result.handoff_success_count,
                "compensation_triggered": result.compensation_triggered,
            },
        )
        return result

    # ── ring elevation (both planes) ─────────────────────────────────

    async def grant_elevation(
        self,
        session_id: str,
        agent_did: str,
        target_ring: ExecutionRing,
        ttl_seconds: int = 0,
        attestation: Optional[str] = None,
        reason: str = "",
    ):
        """Grant a TTL-bounded ring elevation on BOTH planes.

        Host refusal rules apply first (`rings/elevation.py:87-108`:
        strictly more privileged, Ring 0 unreachable, one live grant per
        (agent, session)); on success the device ElevationTable gets the
        matching row so `HypervisorState.effective_rings` resolves the
        elevated ring for write/lock waves. Returns the RingElevation.
        """
        managed = self._require(session_id)
        participant = managed.sso.get_participant(agent_did)
        grant = self.elevation.request_elevation(
            agent_did=agent_did,
            session_id=session_id,
            current_ring=participant.ring,
            target_ring=target_ring,
            ttl_seconds=ttl_seconds,
            attestation=attestation,
            reason=reason,
        )
        row = self.state.agent_row(agent_did, managed.slot)
        if row is not None:
            try:
                dev_row = self.state.grant_elevation(
                    row["slot"],
                    target_ring.value,
                    now=self.state.now(),
                    ttl_seconds=grant.remaining_seconds,
                )
            except (ValueError, RuntimeError):
                # Device refusal after host grant would strand the grant
                # host-only; roll the host grant back and re-raise.
                self.elevation.revoke_elevation(grant.elevation_id)
                raise
            self._elev_row_of[grant.elevation_id] = dev_row
        self._emit(
            EventType.RING_ELEVATED,
            session_id=session_id,
            agent_did=agent_did,
            payload={
                "to": target_ring.value,
                "ttl": grant.remaining_seconds,
                "reason": reason,
            },
        )
        return grant

    def _purge_grant_mappings(self, predicate) -> None:
        """Drop _elev_row_of entries whose grant matches `predicate` —
        regardless of grant liveness (a lapsed-but-unswept grant's stale
        handle is exactly the recycled-row hazard)."""
        for eid in [
            eid
            for eid in self._elev_row_of
            if (g := self.elevation.get(eid)) is not None and predicate(g)
        ]:
            del self._elev_row_of[eid]

    def _revoke_device_grant(self, grant, dev_row: int) -> None:
        """Deactivate a grant's device row, guarded against recycling.

        The row may have been freed (leave/terminate scrub, device-side
        expiry) and recycled to ANOTHER grant since the mapping was
        recorded; `expected_agent` makes a stale handle a no-op instead
        of deactivating the new tenant's elevation.
        """
        managed = self._sessions.get(grant.session_id)
        row = (
            self.state.agent_row(grant.agent_did, managed.slot)
            if managed is not None
            else None
        )
        if row is None:
            # Membership gone: its device grant was scrubbed with the row.
            return
        try:
            self.state.revoke_elevation(dev_row, expected_agent=row["slot"])
        except ValueError:
            pass  # recycled to another agent's grant — leave it alone

    def _retire_grant(self, grant) -> None:
        """THE both-plane grant-retirement sequence, in one place: host
        revoke + mapping pop + guarded device-row revoke. Used by the
        explicit revoke path, ring-update supersession, and the drift
        ladder's floor-ring case."""
        self.elevation.revoke_elevation(grant.elevation_id)
        dev_row = self._elev_row_of.pop(grant.elevation_id, None)
        if dev_row is not None:
            self._revoke_device_grant(grant, dev_row)

    async def revoke_elevation(self, elevation_id: str) -> None:
        """Revoke a grant before expiry on BOTH planes."""
        grant = self.elevation.get(elevation_id)
        if grant is None:
            # Preserve the manager's not-found error.
            self.elevation.revoke_elevation(elevation_id)
            return
        self._retire_grant(grant)

    def sweep_elevations(self) -> int:
        """Expire lapsed grants on BOTH planes; returns how many GRANTS
        retired this sweep (facade grants count once, ever).

        Host-expired grants revoke their device rows EXPLICITLY (guarded
        by expected_agent): the device's f32 TTL compare may lapse a
        sweep earlier or later than the host's datetime, and relying on
        coincident expiry would leave one plane serving a grant the
        other retired (`docs/OPERATIONS.md` "Ticks the operator owns").
        Device-only grants (placed via `state.grant_elevation` directly)
        count from the device tick, EXCLUDING rows still mapped to
        facade grants — a facade row that device-expires a sweep before
        its host datetime must not count now and again at host expiry.
        """
        expired = self.elevation.tick()
        for grant in expired:
            dev_row = self._elev_row_of.pop(grant.elevation_id, None)
            if dev_row is not None:
                self._revoke_device_grant(grant, dev_row)
            self._emit(
                EventType.RING_ELEVATION_EXPIRED,
                session_id=grant.session_id,
                agent_did=grant.agent_did,
                payload={"was": grant.elevated_ring.value},
            )
        mapped_rows = set(self._elev_row_of.values())
        before_active = _host(self.state.elevations.active).copy()
        self.state.elevation_tick(self.state.now())
        after_active = _host(self.state.elevations.active)
        device_only = sum(
            1
            for r in np.nonzero(before_active & ~after_active)[0]
            if int(r) not in mapped_rows
        )
        return len(expired) + device_only

    # ── behavior verification ────────────────────────────────────────

    async def verify_behavior(
        self,
        session_id: str,
        agent_did: str,
        claimed_embedding: Any,
        observed_embedding: Any,
        action_id: Optional[str] = None,
    ) -> Optional[Any]:
        """CMVK drift check; drift above threshold slashes + reports to Nexus."""
        if not self.cmvk:
            return None

        result = self.cmvk.check_behavioral_drift(
            agent_did=agent_did,
            session_id=session_id,
            claimed_embedding=claimed_embedding,
            observed_embedding=observed_embedding,
            action_id=action_id,
        )

        if result.should_demote and not result.should_slash:
            # MEDIUM drift: demote one ring on both planes (the drift
            # ladder the reference's adapter defines, `cmvk_adapter.py:
            # 67-73`, which its core never wires — its scenario tests
            # demote by hand). Demotion also retires any live elevation
            # (update_agent_ring's supersede rule).
            managed = self._require(session_id)
            participant = managed.sso.get_participant(agent_did)
            demoted = ExecutionRing(min(participant.ring.value + 1, 3))
            if demoted.value != participant.ring.value:
                await self.update_agent_ring(
                    session_id,
                    agent_did,
                    demoted,
                    reason=f"CMVK drift {result.drift_score:.3f} (medium)",
                )
            else:
                # Already at the floor ring: there is no ring left to
                # take, but a drifting agent must not keep sudo — retire
                # any live grant directly (update_agent_ring's supersede
                # rule would have done it on a real demotion).
                held = self.elevation.get_active_elevation(
                    agent_did, session_id
                )
                if held is not None:
                    self._retire_grant(held)

        if result.should_slash:
            managed = self._require(session_id)
            participant = managed.sso.get_participant(agent_did)
            # Snapshot BEFORE the device cascade: _sync_rows_to_host
            # zeroes the live participant, and the slash history must
            # record the pre-slash sigma (`SlashResult.vouchee_sigma_
            # before`, reference `liability/slashing.py`).
            vouchee_sigma_before = participant.sigma_eff
            agent_scores = {
                p.agent_did: p.sigma_eff for p in managed.sso.participants
            }
            # Device plane FIRST: the cascade over the mirrored VouchTable
            # blacklists the row, clips vouchers, and releases consumed
            # edges. It must see the pre-slash graph — the host slash
            # below releases bonds through the mirror as it clips.
            # Scoping matches the reference: the slash is AGENT-GLOBAL
            # (`liability/slashing.py:88-89` zeroes the vouchee's sigma
            # everywhere — its other session rows blacklist too), while
            # quarantine is SESSION-scoped (`liability/quarantine.py:
            # 73-118` isolates one (agent, session) membership) — only
            # THIS session's row gets FLAG_QUARANTINED.
            rogue = self.state.agent_row(agent_did, managed.slot)
            if rogue is not None:
                cascade = self.state.apply_slash(
                    managed.slot,
                    rogue["slot"],
                    risk_weight=DRIFT_SLASH_RISK_WEIGHT,
                    now=self.state.now(),
                )
                other_rows = [
                    r["slot"]
                    for r in self.state.agent_rows(agent_did)
                    if r["slot"] != rogue["slot"]
                ]
                self.state.blacklist_rows(other_rows)
                # Host plane follows the cascade: every participant whose
                # device row the slash touched (the rogue everywhere, and
                # clipped vouchers) takes the recomputed sigma/ring, so
                # the planes cannot diverge on post-slash standing.
                self._sync_rows_to_host(
                    cascade["slashed"] + cascade["clipped"] + other_rows
                )
                # Read-only isolation before termination (SURVEY §5
                # recovery): the device row carries FLAG_QUARANTINED;
                # `state.quarantined_mask()` is the predicate write
                # waves consult to refuse the row while forensics run.
                self.state.quarantine_rows(
                    [rogue["slot"]], now=self.state.now()
                )
            self.quarantine.quarantine(
                agent_did,
                session_id,
                QuarantineReason.BEHAVIORAL_DRIFT,
                details=f"drift {result.drift_score:.3f}",
                # One duration source for both planes: the device config.
                duration_seconds=int(
                    self.state.config.quarantine.default_duration_seconds
                ),
                forensic_data={
                    "drift_score": result.drift_score,
                    "severity": result.severity.value,
                },
            )
            slash_result = self.slashing.slash(
                vouchee_did=agent_did,
                session_id=session_id,
                vouchee_sigma=vouchee_sigma_before,
                risk_weight=DRIFT_SLASH_RISK_WEIGHT,
                reason=f"CMVK drift: {result.drift_score:.3f} ({result.severity.value})",
                agent_scores=agent_scores,
            )
            # Mirror cascade dedupes (duplicate per-agent settlements
            # the visited-set guard suppressed) into the metrics plane.
            new_dedupes = (
                self.slashing.cascade_dedupes
                - self._cascade_dedupes_mirrored
            )
            if new_dedupes > 0:
                self.state.metrics.inc(
                    metrics_plane.CASCADE_DEDUPED, new_dedupes
                )
                self._cascade_dedupes_mirrored = (
                    self.slashing.cascade_dedupes
                )
            # Persistent risk accounting (facade-wired ledger): the
            # rogue is charged for the slash AND the quarantine; every
            # clipped voucher is charged the cascade. All of them are
            # marked penalized so terminate's clean-session credit
            # skips them.
            # Penalty index entries only for LIVE sessions (same rule as
            # attribute_fault and the cross-session loop below): a
            # post-mortem slash of an archived session must not
            # re-create its popped key — terminate never pops it again.
            session_live = managed.sso.state.value not in (
                "archived", "terminating"
            )
            if session_live:
                penalized = self._penalized_in.setdefault(session_id, set())
                penalized.add(agent_did)
            # The slash is AGENT-GLOBAL (every row blacklists), so the
            # penalty is too: the rogue forfeits the clean credit in
            # EVERY session it is currently live in — otherwise its
            # other sessions' credits would offset the slash charge and
            # defeat the admission gate.
            for other_sid, other in self._sessions.items():
                if other_sid == session_id:
                    continue
                # LIVE sessions only: archived ones settled their clean
                # credits at terminate, and re-creating their popped
                # penalty keys would leak forever (archive() never
                # clears participants' is_active).
                if other.sso.state.value in ("archived", "terminating"):
                    continue
                p = other.sso._participants.get(agent_did)
                if p is not None and p.is_active:
                    self._penalized_in.setdefault(other_sid, set()).add(
                        agent_did
                    )
            self.ledger.record(
                agent_did,
                LedgerEntryType.SLASH_RECEIVED,
                session_id=session_id,
                severity=result.drift_score,
            )
            self.ledger.record(
                agent_did,
                LedgerEntryType.QUARANTINE_ENTERED,
                session_id=session_id,
                severity=result.drift_score,
            )
            for clip in slash_result.voucher_clips:
                if session_live:
                    penalized.add(clip.voucher_did)
                self.ledger.record(
                    clip.voucher_did,
                    LedgerEntryType.SLASH_CASCADED,
                    session_id=session_id,
                    severity=0.5,
                )
            self._emit(
                EventType.SLASH_EXECUTED,
                session_id=session_id,
                agent_did=agent_did,
                payload={"drift_score": result.drift_score},
            )
            self._emit(
                EventType.QUARANTINE_ENTERED,
                session_id=session_id,
                agent_did=agent_did,
                payload={"reason": QuarantineReason.BEHAVIORAL_DRIFT.value},
            )
            if self.nexus:
                severity = "critical" if result.drift_score >= 0.75 else "high"
                self.nexus.report_slash(
                    agent_did=agent_did,
                    reason=f"Behavioral drift: {result.drift_score:.3f}",
                    severity=severity,
                )
            logger.warning(
                "Agent %s slashed: drift=%.3f", agent_did, result.drift_score
            )

        return result

    def _sync_rows_to_host(self, slots) -> None:
        """Copy device rows' sigma_eff/ring onto their host participants.

        Used after a device-side cascade (slash/blacklist) rewrites rows:
        the SSO participant mirrors of exactly those (agent, session)
        memberships take the device values. Rows without a managed host
        session (e.g. phantom vouchers) are skipped.
        """
        if not slots:
            return
        did_col = _host(self.state.agents.did)
        sess_col = _host(self.state.agents.session)
        sigma_col = _host(self.state.agents.sigma_eff)
        ring_col = _host(self.state.agents.ring)
        by_slot = {m.slot: m for m in self._sessions.values()}
        for slot in slots:
            slot = int(slot)
            managed = by_slot.get(int(sess_col[slot]))
            if managed is None or int(did_col[slot]) < 0:
                continue
            did_str = self.state.agent_ids.string(int(did_col[slot]))
            participant = managed.sso._participants.get(did_str)
            if participant is None or not participant.is_active:
                continue
            participant.sigma_eff = float(sigma_col[slot])
            participant.ring = ExecutionRing(int(ring_col[slot]))

    def _detach_and_remirror(self, scrubbed_edges) -> None:
        """Detach mirror entries whose device edges were scrubbed, then
        re-mirror the surviving host bonds immediately.

        With one row per (agent, session), an endpoint losing ONE row
        (leave, terminate-reclaim) may still be resident through another
        membership — the bond's edge re-attaches to that row now rather
        than waiting for a future join's backfill (which would leave the
        device graph under-counting live host bonds in the meantime).
        Bonds whose endpoints are fully gone re-mirror on a later join.
        """
        scrubbed = set(scrubbed_edges)
        if not scrubbed:
            return
        detached = {
            vouch_id
            for vouch_id, edge in self._edge_of_vouch.items()
            if edge in scrubbed
        }
        for vouch_id in detached:
            del self._edge_of_vouch[vouch_id]
            record = self.vouching.record(vouch_id)
            if record is not None and record.is_active:
                self._mirror_vouch(record)

    def _resolve_endpoints(self, record):
        """THE edge-resolution rule, in one place: each endpoint resolves
        to its row IN the bond's session when resident there, else its
        most recent live row (a voucher bonding into a session it never
        joined is legal in the reference engine). Returns (voucher_row,
        vouchee_row) — either may be None. `_mirror_vouch`, the backfill
        re-point check, and the stateful edge invariant all share this
        contract.
        """
        managed = self._sessions.get(record.session_id)
        if managed is None:
            return None, None
        voucher = self.state.agent_row(
            record.voucher_did, managed.slot
        ) or self.state.agent_row(record.voucher_did)
        vouchee = self.state.agent_row(
            record.vouchee_did, managed.slot
        ) or self.state.agent_row(record.vouchee_did)
        return voucher, vouchee

    def _mirror_vouch(self, record) -> None:
        """Host bond -> device VouchTable edge (when both agents and the
        session are resident in the device tables), endpoints resolved
        by `_resolve_endpoints`."""
        managed = self._sessions.get(record.session_id)
        if managed is None:
            return
        voucher, vouchee = self._resolve_endpoints(record)
        if voucher is None or vouchee is None:
            return
        try:
            edge = self.state.add_vouch(
                voucher["slot"],
                vouchee["slot"],
                managed.slot,
                bond=record.bonded_amount,
                bond_pct=record.bonded_sigma_pct,
                expiry=(
                    # Device columns hold epoch-RELATIVE f32 time.
                    self.state.to_device_time(record.expiry.timestamp())
                    if record.expiry
                    else float("inf")
                ),
            )
        except RuntimeError as exc:
            # Mirror degradation must not corrupt the committed host bond.
            logger.warning("vouch mirror skipped for %s: %s", record.vouch_id, exc)
            return
        self._edge_of_vouch[record.vouch_id] = edge

    def _mirror_release(self, vouch_id: str) -> None:
        edge = self._edge_of_vouch.pop(vouch_id, None)
        if edge is not None:
            self.state.release_vouch(edge)

    def _backfill_vouch_mirror(self, agent_did: str) -> None:
        """Mirror host bonds that predate an endpoint's device residency,
        and RE-POINT existing edges the join just made stale.

        A vouch recorded before its voucher (or vouchee) joined has no
        device edge — `_mirror_vouch` skips when an endpoint has no agent
        row. Once the missing endpoint joins, those bonds must appear in
        the VouchTable or device sigma_eff contributions and slash
        cascades silently under-count them (coherence gap surfaced by the
        stateful property suite).

        Re-pointing: an edge may be hanging on an endpoint's FALLBACK
        row in another session (attached by `_detach_and_remirror` after
        a leave/terminate scrubbed the original). When this join creates
        the endpoint's row IN the bond's session, the edge must move
        there — otherwise a later slash cascade in that session matches
        the bond against the wrong row forever (the rejoin would skip
        already-mirrored records).
        """
        voucher_col = vouchee_col = None
        for record in self.vouching.agent_records(agent_did):
            if not record.is_active:
                continue
            existing = self._edge_of_vouch.get(record.vouch_id)
            if existing is None:
                self._mirror_vouch(record)
                continue
            voucher, vouchee = self._resolve_endpoints(record)
            if voucher is None or vouchee is None:
                continue
            if voucher_col is None:
                voucher_col = _host(self.state.vouches.voucher)
                vouchee_col = _host(self.state.vouches.vouchee)
            if (voucher["slot"], vouchee["slot"]) != (
                int(voucher_col[existing]),
                int(vouchee_col[existing]),
            ):
                self.state.release_vouch(existing)
                del self._edge_of_vouch[record.vouch_id]
                self._mirror_vouch(record)
                voucher_col = vouchee_col = None  # columns changed

    def consistency_runtime(self, mesh):
        """The mixed-mode distributed tick driver bound to this facade's
        device state (`runtime.consistency.ConsistencyRuntime`).

        The session `mode` column — set from `SessionConfig.
        consistency_mode` at create and force-flipped to STRONG when
        non-reversible actions register (`force_session_mode`) — decides
        each lane's path: STRONG rides the in-tick psum barrier,
        EVENTUAL accumulates partials until `reconcile()`. This makes
        the reference's stored-but-never-executed ConsistencyMode
        (`models.py:12-16`) an actual execution property.

        Cached per mesh: pending EVENTUAL partials live on the runtime,
        so repeated calls MUST return the same instance (a fresh one
        would strand deltas already ticked).
        """
        from hypervisor_tpu_torch.runtime.consistency import ConsistencyRuntime

        cached = self._consistency_runtimes.get(mesh)
        if cached is None:
            cached = ConsistencyRuntime(self.state, mesh)
            self._consistency_runtimes[mesh] = cached
        return cached

    def sync_events_to_device(self) -> int:
        """Mirror new bus events into the device EventLog ring buffer.

        The columnar host bus and the device EventLog share a row shape
        (`event_bus.device_rows` -> `EventLog.append_batch`); this drains
        everything emitted since the last sync. Returns rows appended.
        """
        if self.event_bus is None:
            return 0
        codes, sess, agents, traces, stamps, spans = (
            self.event_bus.device_rows(self._events_mirrored)
        )
        if not len(codes):
            return 0
        # Device-ring mutation outside the journal gate: staleness-mark
        # the fused-epilogue gauges so the next drain refreshes.
        self.state._gauges_fresh = False
        self.state.event_log.append_batch(codes, sess, agents, traces, stamps, spans)
        # The metrics-plane twin of the EventLog cursor: every mirrored
        # row counts once, so the two planes can be cross-checked
        # (tests/unit/test_metrics.py event-parity guard). Host-plane
        # inc — this path already synced to host, and a device dispatch
        # here would buy nothing the snapshot merge doesn't provide.
        from hypervisor_tpu_torch.observability import metrics as metrics_plane

        self.state.metrics.inc(metrics_plane.EVENTS_MIRRORED, len(codes))
        self._events_mirrored += len(codes)
        return len(codes)

    # ── queries ──────────────────────────────────────────────────────

    def get_session(self, session_id: str) -> Optional[ManagedSession]:
        return self._sessions.get(session_id)

    @property
    def active_sessions(self) -> list[ManagedSession]:
        return [
            m
            for m in self._sessions.values()
            if m.sso.state.value not in ("archived", "terminating")
        ]

    # ── internals ────────────────────────────────────────────────────

    def _require(self, session_id: str) -> ManagedSession:
        managed = self._sessions.get(session_id)
        if managed is None:
            raise ValueError(f"Session {session_id} not found")
        return managed

    def _on_health_event(self, kind: str, payload: dict) -> None:
        """Health-monitor listener -> structured bus events. Runs on
        the dispatch path (watchdog fires inside `Tracer.end_wave`), so
        it only appends one bus row — no device work, no raises."""
        event_type = {
            "straggler": EventType.WAVE_STRAGGLER,
            "capacity": EventType.CAPACITY_WARNING,
            "recompile": EventType.RECOMPILE,
            # Resilience supervisor transitions ride the same fan-out
            # (`HealthMonitor.emit_event`), so degraded enter/exit and
            # retry events land on the bus without a second bridge.
            "degraded_enter": EventType.DEGRADED_ENTERED,
            "degraded_exit": EventType.DEGRADED_EXITED,
            "dispatch_retry": EventType.DISPATCH_RETRY,
            "wal_replayed": EventType.WAL_REPLAYED,
            # Integrity-plane detections and escalations ride the same
            # fan-out (`integrity.plane.IntegrityPlane`).
            "integrity_violation": EventType.INTEGRITY_VIOLATION,
            "scrub_mismatch": EventType.SCRUB_MISMATCH,
            "row_quarantined": EventType.ROW_QUARANTINED,
            "state_restored": EventType.STATE_RESTORED,
            # Adversarial-plane detections (sybil damper trips) ride
            # the same fan-out; collusion findings emit directly from
            # `detect_collusion` (they carry session context).
            "sybil_damped": EventType.SYBIL_DAMPED,
            # SLO burn-rate alerts (the latency observatory,
            # `observability.slo`) ride the same fan-out — the engine's
            # emit hook is `HealthMonitor.emit_event`.
            "slo_burn_warning": EventType.SLO_BURN_RATE_WARNING,
            "slo_burn_critical": EventType.SLO_BURN_RATE_CRITICAL,
            "slo_recovered": EventType.SLO_RECOVERED,
            # Roofline observatory: a same-signature recapture whose
            # modeled bytes drifted past tolerance rides the same
            # fan-out (`observability.roofline`, drained at the
            # metrics drain).
            "roofline_shift": EventType.ROOFLINE_BYTES_SHIFT,
            # Autopilot decisions + post-hoc outcome attributions ride
            # the same fan-out (`autopilot.plane.Autopilot`); the
            # payload's trace_id is the decision's deterministic
            # CausalTraceId, so the bus row joins the trace plane.
            "autopilot_decision": EventType.AUTOPILOT_DECISION,
            "autopilot_outcome": EventType.AUTOPILOT_OUTCOME,
            # Fleet lease-plane liveness transitions ride the same
            # fan-out (`fleet.registry.FleetRegistry`); payloads carry
            # the replayable lease seq + caller-clock timestamp.
            "fleet_worker_joined": EventType.FLEET_WORKER_JOINED,
            "fleet_worker_suspected": EventType.FLEET_WORKER_SUSPECTED,
            "fleet_worker_dead": EventType.FLEET_WORKER_DEAD,
            "fleet_worker_recovered": EventType.FLEET_WORKER_RECOVERED,
            # Failover plane: ownership assigns, zombie fencings, and
            # completed reassignments ride the same fan-out
            # (`fleet.failover.OwnershipMap` / `FailoverController`);
            # payloads carry the replayable ownership seq + fencing
            # epoch so the reassignment journal replays bit-identically.
            "fleet_ownership_changed": EventType.FLEET_OWNERSHIP_CHANGED,
            "fleet_worker_fenced": EventType.FLEET_WORKER_FENCED,
            "fleet_tenants_reassigned": EventType.FLEET_TENANTS_REASSIGNED,
            # Rebalance plane: planned-migration intent / atomic
            # commit / abort ride the same fan-out
            # (`fleet.rebalance.RebalanceController` journaling into
            # the OwnershipMap).
            "fleet_rebalance_planned": EventType.FLEET_REBALANCE_PLANNED,
            "fleet_tenant_migrated": EventType.FLEET_TENANT_MIGRATED,
            "fleet_migration_aborted": EventType.FLEET_MIGRATION_ABORTED,
            # Hindsight-plane lifecycle (`observability.incidents.
            # IncidentRecorder`) rides the same fan-out; the taxonomy
            # itself is the recursion guard (incident_* kinds never
            # trigger a capture).
            "incident_captured": EventType.INCIDENT_CAPTURED,
            "incident_evicted": EventType.INCIDENT_EVICTED,
        }.get(kind)
        if event_type is None or self.event_bus is None:
            return
        self.event_bus.emit(
            HypervisorEvent(
                event_type=event_type,
                causal_trace_id=payload.get("trace_id"),
                payload=payload,
            )
        )

    def _incident_events_block(self, trigger: dict) -> dict:
        """The incident bundle's event-bus slice: the newest bus rows
        at capture time (bounded — the bundle stays small)."""
        if self.event_bus is None:
            return {"enabled": False}
        events = self.event_bus.query(limit=64)
        return {
            "enabled": True,
            "count": len(events),
            "events": [e.to_dict() for e in events],
        }

    def _emit(
        self,
        event_type: EventType,
        session_id: Optional[str] = None,
        agent_did: Optional[str] = None,
        payload: Optional[dict] = None,
    ) -> None:
        if self.event_bus is not None:
            self.event_bus.emit(
                HypervisorEvent(
                    event_type=event_type,
                    session_id=session_id,
                    agent_did=agent_did,
                    payload=payload or {},
                )
            )
