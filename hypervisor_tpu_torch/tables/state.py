"""The governance state tables: agents, sessions, sagas, vouch edges and
ring elevations.

Same fixed-capacity structure-of-arrays layout as
`hypervisor_tpu.tables.state`, column for column and dtype for dtype,
so `tables.from_state_arrays` / `to_state_arrays` move a reference state
across byte for byte. `create()` gives the reference's initial values.
"""

from __future__ import annotations

import torch

from hypervisor_tpu_torch.tables.struct import footprint, table

# Agent-table flag bits (int32 bitmask column).
FLAG_ACTIVE = 1 << 0
FLAG_QUARANTINED = 1 << 1
FLAG_BREAKER_TRIPPED = 1 << 2
FLAG_BLACKLISTED = 1 << 3
FLAG_PROBATIONARY = 1 << 4
KNOWN_FLAGS_MASK = (
    FLAG_ACTIVE
    | FLAG_QUARANTINED
    | FLAG_BREAKER_TRIPPED
    | FLAG_BLACKLISTED
    | FLAG_PROBATIONARY
)

# AgentTable packed-block column indices.
AF32_SIGMA_RAW = 0
AF32_SIGMA_EFF = 1
AF32_JOINED_AT = 2
AF32_RISK = 3
AF32_RL_TOKENS = 4
AF32_RL_STAMP = 5
AF32_BD_BREAKER_UNTIL = 6
AF32_QUARANTINE_UNTIL = 7
AF32_WIDTH = 8
AI32_DID = 0
AI32_SESSION = 1
AI32_FLAGS = 2
# The breach sliding window rides the i32 block: BD_BUCKETS call counts,
# privileged counts and epoch stamps, columns [3, 21).
BD_BUCKETS = 6
AI32_BD_WIN_START = 3
AI32_BD_WIN_STOP = AI32_BD_WIN_START + 3 * BD_BUCKETS
AI32_WIDTH = AI32_BD_WIN_STOP

# SessionTable packed-block column indices.
SI32_SID = 0
SI32_MAX_PARTICIPANTS = 1
SI32_NPART = 2
SI32_STATE = 3
SI32_MODE = 4
SI32_WIDTH = 5
SF32_MIN_SIGMA = 0
SF32_CREATED_AT = 1
SF32_TERMINATED_AT = 2
SF32_MAX_DURATION = 3
SF32_WIDTH = 4
# The session i8 block of checkpoints written before the state and mode
# codes joined the i32 block; read only by `runtime.checkpoint`'s
# migration.
LEGACY_SI8_STATE = 0
LEGACY_SI8_MODE = 1


@table(
    packed={
        "sigma_raw": ("f32", AF32_SIGMA_RAW),
        "sigma_eff": ("f32", AF32_SIGMA_EFF),
        "joined_at": ("f32", AF32_JOINED_AT),
        "risk_score": ("f32", AF32_RISK),
        "rl_tokens": ("f32", AF32_RL_TOKENS),
        "rl_stamp": ("f32", AF32_RL_STAMP),
        "bd_breaker_until": ("f32", AF32_BD_BREAKER_UNTIL),
        "quarantine_until": ("f32", AF32_QUARANTINE_UNTIL),
        "did": ("i32", AI32_DID),
        "session": ("i32", AI32_SESSION),
        "flags": ("i32", AI32_FLAGS),
    },
    slices={"bd_window": ("i32", AI32_BD_WIN_START, AI32_BD_WIN_STOP)},
)
class AgentTable:
    """[N] agent rows: f32[N, 8], i32[N, 21] (did, session, flags, breach
    window), i8[N] ring. Row index == agent slot."""

    f32: torch.Tensor
    i32: torch.Tensor
    ring: torch.Tensor

    @staticmethod
    def create(capacity: int, device: str | torch.device) -> "AgentTable":
        i32 = torch.zeros((capacity, AI32_WIDTH), dtype=torch.int32, device=device)
        i32[:, AI32_DID] = -1
        i32[:, AI32_SESSION] = -1
        return AgentTable(
            f32=torch.zeros((capacity, AF32_WIDTH), dtype=torch.float32, device=device),
            i32=i32,
            ring=torch.full((capacity,), 3, dtype=torch.int8, device=device),
        )

    def footprint(self) -> dict:
        """Health-plane bytes and row capacity (`tables.struct.footprint`)."""
        return footprint(self, self.ring.shape[0])


@table(
    packed={
        "sid": ("i32", SI32_SID),
        "max_participants": ("i32", SI32_MAX_PARTICIPANTS),
        "n_participants": ("i32", SI32_NPART),
        "state": ("i32", SI32_STATE),
        "mode": ("i32", SI32_MODE),
        "min_sigma_eff": ("f32", SF32_MIN_SIGMA),
        "created_at": ("f32", SF32_CREATED_AT),
        "terminated_at": ("f32", SF32_TERMINATED_AT),
        "max_duration": ("f32", SF32_MAX_DURATION),
    }
)
class SessionTable:
    """[S] session rows: i32[S, 5] (sid, max_participants, n_participants,
    state, mode), f32[S, 4] (min_sigma_eff, created_at, terminated_at,
    max_duration), and two bool columns."""

    i32: torch.Tensor
    f32: torch.Tensor
    enable_audit: torch.Tensor
    has_nonreversible: torch.Tensor

    @staticmethod
    def create(capacity: int, device: str | torch.device) -> "SessionTable":
        i32 = torch.zeros((capacity, SI32_WIDTH), dtype=torch.int32, device=device)
        i32[:, SI32_SID] = -1
        i32[:, SI32_MAX_PARTICIPANTS] = 10
        i32[:, SI32_MODE] = 1  # EVENTUAL
        f32 = torch.zeros((capacity, SF32_WIDTH), dtype=torch.float32, device=device)
        f32[:, SF32_MIN_SIGMA] = 0.60
        return SessionTable(
            i32=i32,
            f32=f32,
            enable_audit=torch.ones((capacity,), dtype=torch.bool, device=device),
            has_nonreversible=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def footprint(self) -> dict:
        """Health-plane bytes and row capacity (`tables.struct.footprint`)."""
        return footprint(self, self.enable_audit.shape[0])


@table
class ElevationTable:
    """[M] sudo-with-TTL ring elevations: an active, unexpired grant lifts
    its agent to `granted_ring` (`ops.security_ops.effective_rings`)."""

    agent: torch.Tensor         # i32[M] agent slot (-1 = free)
    granted_ring: torch.Tensor  # i8[M] temporary (more privileged) ring
    expires_at: torch.Tensor    # f32[M]
    active: torch.Tensor        # bool[M]

    @staticmethod
    def create(capacity: int, device: str | torch.device) -> "ElevationTable":
        return ElevationTable(
            agent=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            granted_ring=torch.full((capacity,), 3, dtype=torch.int8, device=device),
            expires_at=torch.zeros((capacity,), dtype=torch.float32, device=device),
            active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def footprint(self) -> dict:
        """Health-plane bytes and row capacity (`tables.struct.footprint`)."""
        return footprint(self, self.agent.shape[0])


@table
class SagaTable:
    """[G, M] saga step states plus per-saga control columns: every saga
    advances in one `ops.saga_ops.saga_table_tick` (kernel B7 on CUDA)."""

    step_state: torch.Tensor    # i8[G, M] StepState codes (PENDING beyond n_steps)
    retries_left: torch.Tensor  # i8[G, M]
    has_undo: torch.Tensor      # bool[G, M]
    timeout: torch.Tensor       # f32[G, M] seconds (the host scheduler enforces them)
    saga_state: torch.Tensor    # i8[G] SagaState codes
    session: torch.Tensor       # i32[G] session slot (-1 = free saga row)
    n_steps: torch.Tensor       # i32[G]
    cursor: torch.Tensor        # i32[G] next step to execute (forward order)

    @staticmethod
    def create(capacity: int, max_steps: int, device: str | torch.device) -> "SagaTable":
        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        gm = (capacity, max_steps)
        return SagaTable(
            step_state=full(gm, 0, torch.int8),
            retries_left=full(gm, 0, torch.int8),
            has_undo=full(gm, False, torch.bool),
            timeout=full(gm, 300.0, torch.float32),
            saga_state=full((capacity,), 0, torch.int8),
            session=full((capacity,), -1, torch.int32),
            n_steps=full((capacity,), 0, torch.int32),
            cursor=full((capacity,), 0, torch.int32),
        )

    def footprint(self) -> dict:
        """Health-plane bytes and row capacity (`tables.struct.footprint`)."""
        return footprint(self, self.saga_state.shape[0])


@table
class VouchTable:
    """[E] vouch edges: the liability graph as an edge list."""

    voucher: torch.Tensor   # i32[E] agent slot (-1 = free edge)
    vouchee: torch.Tensor   # i32[E] agent slot
    session: torch.Tensor   # i32[E] session slot
    bond_pct: torch.Tensor  # f32[E]
    bond: torch.Tensor      # f32[E] absolute sigma locked
    active: torch.Tensor    # bool[E]
    expiry: torch.Tensor    # f32[E] unix seconds; +inf = never

    @staticmethod
    def create(capacity: int, device: str | torch.device) -> "VouchTable":
        def full(value, dtype):
            return torch.full((capacity,), value, dtype=dtype, device=device)

        return VouchTable(
            voucher=full(-1, torch.int32),
            vouchee=full(-1, torch.int32),
            session=full(-1, torch.int32),
            bond_pct=full(0.0, torch.float32),
            bond=full(0.0, torch.float32),
            active=full(False, torch.bool),
            expiry=full(float("inf"), torch.float32),
        )

    def footprint(self) -> dict:
        """Health-plane bytes and row capacity (`tables.struct.footprint`)."""
        return footprint(self, self.voucher.shape[0])
