#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's governance wave, its facade wave (all
eight phases: the action gateway and the gauge epilogue too), the
sanitizer, the join queue and security surface, the saga plane, the
slash cascade, the lock and write waves, the native host runtime, the
`Hypervisor` facade's public API, durability (the write-ahead log,
checkpoints and crash recovery), observability (the metrics drain, the
health and hindsight planes, the integrity plane and the supervisor),
serving, tenancy (T tenants' waves in one launch of each kernel's tenant
form), the autopilot, the adversarial scenario set, the fleet's workers,
the reference's headline `governance_pipeline`, and the fleet's failover
and rebalancing on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA GPU
    python3 chip_smoke.py --blocks   # build, then only profile and time B4, B5, B7, B8

`--blocks` profiles one saga round, one `apply_slash` and one slash
cascade call (phase `path_profile`), probes the grid barrier where the
tree has B8's cooperative form, times admission (B4) on its three
layouts, the fsm/saga block (B5) in both forms, the saga round (B7) and
the slash cascade (B8), and stops: run it in two trees in one call to
compare them. Only under `--blocks` does the script accept a tree that
lacks B5's mask form, the clip-factor table or the in-kernel tallies.

Phases, one JSON line each:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA kernel built from `hypervisor_tpu_torch/csrc/` (one
   nvcc per source, all started together), with ptxas' report; the
   redesigned kernels (B1, B2, B3's packed tree, the contribution's
   five, B4's, B5's, B7's and B8's) must show no spill;
3. sha_latency: B1 on one warp of messages (B = 32) at 1, 2, 4 and 8
   blocks a message, by CUDA events; the slope of time against blocks
   is one compression's latency on a lone warp, the intercept the
   launch and the loads, beside one launch of a one-element add timed
   the same way. Where `cuobjdump` exists, the SASS of each SHA kernel:
   its instructions, its reads of the constant bank (`c[0x3][...]`
   operands, where `__constant__` data lies) and its SHF, LOP3, IADD3
   and IMAD; then barrier_probe: one cooperative launch at B8's grid
   crossing 0, 1, 5 and 25 grid barriers, by CUDA events (the slope is
   one barrier), and how many edges that grid holds in registers;
4. parity: each kernel against its plain PyTorch version on the same
   inputs on the card, bit-exact (tolerance 0), at the paths' shapes —
   the vouched contribution, each case called twice, against the plain
   version on the CPU (which sums in edge order, as the reference does)
   and, where no vouchee has two scoped edges, on the card: the wave's
   edges, 65,536 edges with many vouchers per vouchee, the same with no
   edge scoped, one vouchee holding 4,096 live scoped edges, one holding
   all 65,536, and 65,535 edges; B2 chains, each call twice, at every
   shape the paths launch (3 x 10,000 and 10,240, 5 x 13, N x 1) and at
   ragged tiles (7 x 10,001, 70 x 200), with hashlib on samples and on
   every turn of a 1,100-turn lane; B3
   roots, each call twice, at 10,000 sessions x 4 leaves, at 10,001 and
   1 sessions (a ragged last warp), every count 0..P at P = 1, 2, 4, 8,
   16, 32, 64 and 128 (both sides of the packed kernel's switch) and
   nine counts at 4096 leaves; B4 admission on three layouts, each
   call twice: the unique-sessions wave, a crowded wave with duplicates
   and full sessions, and four joins a session; B5 at the wave's
   sessions, lanes, edges and agents in the range form and the
   membership-mask form, on the wave's arange (where the two forms must
   agree) and on 10,000 sessions scattered over the table; B2's ring
   form (B6's DeltaLog append in B2's launch) at the facade's shape
   (30,000 rows into 65,536, wrapping), at 10,000 and 10,240 sessions
   (the padded bucket's live prefix) and with no live row, against the
   plain pair, B2 without the ring and itself; B1, the batched hash, on
   30,000 messages of 2 and 3 blocks, a scrubber strip, and 1, 31, 32,
   33, 4,096 and 30,000 messages of 1-4 blocks (5 and 9 at two counts),
   each call twice and against hashlib on samples, and a 8,192-leaf
   Merkle forest through it; B7, the
   saga round, on random tables of 8,192 sagas x 16 and x 4 steps and
   of 8,191 and 33 sagas x 16 (a ragged last warp) in every code, its
   tally rows seeded at 0xFFFFFFF0 so that they wrap, against its plain
   version on the card and on the CPU, counters included; B8, the slash
   cascade, each call twice and once without counters, its tally rows
   seeded the same way, on bench_suite's north-star graph (10,240
   agents, 8,192 edges, 128 seeds, omega 0.95), on the default tables
   (16,384 agents, 65,536 edges, omega 0.6, cascading to depth 2) on
   the current stream and on a second one, with no edges, on a graph of
   65,536 edges more than its grid holds in registers, and at omega
   0.014 and 0.003 with one voucher of 4 and of 31 first-wave agents
   (where a float64 clip factor parts from the reference's), against its
   plain version on the card and on the CPU, counters included;
5. wave: bench.py's configuration (10,000 sessions, 1,000 vouched
   lanes at sigma 0.5 with bond 0.30, 3 deltas, tables of 16,384 agents,
   16,384 sessions and 65,536 edges, random data from one seed) through
   `HypervisorState.governance_wave`, with the launch counts set to 0
   just before and read just after; bench.py's gates; a hashlib check of
   lanes 0 and K-1; then the same wave through the plain versions on the
   card, which must give identical tables, outputs and counters;
6. facade: the lifecycle wave through `HypervisorState.
   run_governance_wave` at bench.py's widths on a fresh state (65,536
   DeltaLog rows, 32,768 sessions, 34,576 agents, 10,000 of them
   standing actors with eight sudo grants): three waves, each with the
   actors' 10,000 actions through the gateway (bench_suite's
   `action_gateway_10k` mix) and the gauge epilogue over every table,
   the second padded to a 10,240 bucket, the third wrapping the ring over
   the first's archived sessions and recycling agent rows; then
   `flush_deltas` on standing sessions, a full `MerkleScrubber` sweep,
   chain verification, `terminate_sessions` and a 8,192-leaf tree. Each
   path's kernels are counted in its own window (launch counts set to 0
   just before, read just after). bench.py's gates and hashlib on two
   lanes per wave, the host cursor mirrors against the device; then the
   same sequence on the CPU, which must give identical verdict lanes,
   tables (elevations and event log too), DeltaLog, metrics (the gauges
   too), trace words, audit index, frontier roots, scrubber reports and
   roots;
   then one lifecycle wave on a scattered layout (12,000 sessions, 1,000
   terminated and 1,000 left standing with a member and a bond between
   the wave's 10,000, which come shuffled and padded to the bucket):
   every kernel once, the standing sessions untouched, and the same
   wave on the CPU identical; then one `ops.pipeline.governance_wave`
   with all eight phases and the sanitizer on, on a fresh facade state
   with four rows corrupted (phase `sanitized_wave`): the sanitizer flags
   exactly those four, the escrow is the contribution kernel's second
   launch, and the CPU run is identical (masks, verdicts, tables);
   then the join queue and the security surface (phase
   `joins_security`, at the reference's default tables, equal to its
   CPU run);
7. saga: the reference's default SagaTable (8,192 sagas x 16 steps) on
   a fresh state, filled with 5-step sagas whose seeded executors commit
   cleanly, retry then commit, or exhaust into compensation with and
   without an undo (escalating), plus DSL sagas with fan-out groups,
   driven to settlement by `SagaScheduler.run_until_settled`; B7 must
   launch once per round and nothing else at all; each saga's end state
   is checked against its kind; then the same sequence on the CPU must
   give identical SagaTable columns, metrics, trace words, scheduler
   results, errors and attempts, and round count;
8. slash: the default tables (16,384 agents, 65,536 edges) on a fresh
   state, a liability graph written in bulk plus `add_vouch` /
   `release_vouch` calls, then `apply_slash` on a vouchee whose cascade
   reaches depth 2 (checked against the plain version on the CPU); B8
   must launch once and nothing else; then the same
   sequence on the CPU must give identical agents and vouches tables,
   returned lists, metrics and trace words;
9. timing: the wave's p50/p95 (host clock, synchronised) and device
   time; one wave under torch's sync debug mode "error" (no host
   synchronisation inside the wave); one profiled wave (device time by
   kernel, the device's idle share; admission must be one launch of its
   unique form); the facade wave's p50/p95 with its 10,000 actions, each
   on a fresh state, with the host split into staging, dispatch, the
   gateway's and the epilogue's enqueue and audit booking, and its
   device time and device ops; one scrubber sweep's time; the saga
   round's p50/p95 at 8,192 sagas (the table restored between samples)
   with its host split and device time; `apply_slash`'s p50/p95 and
   device time; every device op of one saga round, one `apply_slash`
   and one slash cascade call, by torch.profiler (phase path_profile);
   each kernel's time, its plain version's time, its bound
   and, where one PyTorch call computes the same function, that call's
   time; B4 on each layout, B5 in each form,
   the clip-factor table's build at a tiny omega; beside them B1 at each of its paths' shapes (the scrubber's strip,
   verify's links, the big tree's 13 levels) with each path's
   launches x (ms - bound), the contribution on the two hot-vouchee
   tables and B3 on full trees at P = 64 and P = 4096;
10. locks_writes: the lock waves on `LockWave(device="cuda")` with
   4,096 agents of seeded sigma and 6,144 paths: 8,192 requests (70%
   READ, 25% WRITE, 5% EXCLUSIVE; repeats give several occurrence
   batches), 64 declared wait cycles of 2-8 lock holders, 2,048
   requests of which half close a cycle (refused DEADLOCK), then
   `deadlock_report()` (12 squarings at N = 4,096) and
   `contention_counts()`; the write waves through
   `Hypervisor(device="cuda")`: 256 sessions of 8 members, each one
   `write_wave()` of 64 writes over 32 paths (rings 1-3, ring 3's burst
   running out, read barriers before some writes, two writers
   quarantined in every 16th session, 16 sessions under SNAPSHOT and 16
   under SERIALIZABLE with half the writers holding write locks, `now`
   in dyadic steps). Only B4 may launch (once a join). Both replayed on
   the CPU and held bit for bit (statuses, granted locks, blockers, the
   lock manager, the deadlock report, contention counts, VFS contents,
   clock matrices, token columns, tables); the report also against
   strongly connected components from scipy. p50/p95 of
   `LockWave.flush` (8,192 requests), `deadlock_report` and
   `WriteWave.flush` (64 writes), host clock, synchronised, and the
   closure's device time by CUDA events beside its bound;
11. native: the port's C++ host runtime, which must have built (no
   fallback): `sha256_batch_host` on 65,536 96-byte link messages
   against hashlib and B1, `chain_digests_host` / `verify_chain_host` on
   64 chains of 1,024 bodies with one tampered digest against hashlib and
   B2 (and `verify_chain_digests_host` on the card and through the C++
   route), `merkle_root_hex_host` on 8,192 leaves against
   `merkle_root_device` (B1 level by level), hashlib and
   `tree_roots_host`'s two routes; `tree_roots_host` on 8 lanes of 4,096
   leaves at mixed counts on the card (B3, one launch) against its C++
   route and hashlib; a scrubber sweep on a card state, which must take
   B1 for every strip with the library built; 8 threads staging 16,384
   joins into a card state's native queue (every entry unique), whose
   flush (B4) equals the same joins pushed into a fallback-form queue;
   each host route's time beside its kernel's; the enqueue loop of the
   16,384 joins (one thread and 8) and the bare queue's push loop, the
   native queue and the fallback form taking turns;
12. facade_api, after the other profiles: the `Hypervisor` facade's
   public async API on `Hypervisor(device="cuda")` at the default tables:
   1,024 sessions of 8 members (8,192 `join_session` calls, 1,000
   vouches made before the vouchee joins), each session activated with
   3 captures (64 in every 64th, whose host root takes B3) and one
   8-action `check_actions`, 64 grants, 16 `verify_behavior` slashes
   through an injected CMVK verifier, 16 kills, 64 leaves, the event bus
   mirrored into the EventLog, and every session terminated, the
   facade's own cross-plane checks (device against host root, rings,
   membership) holding throughout; ids and times from counters and a
   manual clock. B4 must launch once a join, B2 once a block (its first
   terminate flushes every staged delta), B3 once a long session, B8
   once a slash, and nothing else; the first 128 sessions run under
   torch.profiler (device activity only), whose census must name the
   four kernels, and are replayed on the CPU, which must give identical
   returns, tables, metrics, host counters, event-bus rows and ledger;
   the other 896 give the p50/p95 of `join_session`, `check_actions`,
   `verify_behavior` and `terminate_session` (host clock, synchronised);
13. durability: a fresh state at the facade's tables journals into a
   `WriteAheadLog` with fsync on every record, in a temporary directory:
   two facade waves of 10,000 sessions and actions (the second padded to
   the bucket, the vouch edges through `add_vouch`), a background
   checkpoint after the first (`checkpoint_with_watermark`, awaited
   through `wait_durable`), 8,192 joins into 256 sessions and their
   flush, 512 vouches, 256 staged deltas and a flush, 1,024 five-step
   sagas over three rounds, one `apply_slash`, 2,048 rate consumes, 16
   grants, 64 quarantines and a terminate, with a fingerprint (every
   checkpointed column by its SHA-256, chain seeds, membership, turns,
   the cursor mirror) at each step boundary. `recover(device="cuda")`
   must reproduce the tip (timed whole, then by piece: restore,
   `verify_audit_heads`, the scan and the replay by op), each step
   boundary past the watermark and three torn cuts (inside the second
   wave's intent line, inside the join flush's commit line, 3 bytes
   before the end), each on a truncated copy of the log; one more tip
   recovery, with `verify_session_chain` on 24 sessions and an
   8,192-leaf tree over the recovered DeltaLog, is the counted window:
   every kernel of the main path must launch in it and be named by
   torch.profiler, and no device op may be neither the port's nor
   torch's. The same checkpoint and log recovered on the CPU must equal
   the card; five seeded corruptions (`testing.chaos.InjectedCorruption`)
   at one dispatch must land alike on the card and the CPU; a second card
   state runs the sequence under `WaveChaosInjector(seed=11,
   fail_rate=0.4)`, each faulted dispatch retried by hand, and must end
   equal to the clean run. Then facade waves on fresh states, journaled
   and not in turns: the journal's cost per wave and its bytes;
14. observability: `Hypervisor` over a fresh state at the facade's
   tables (its event bus bridged to the health plane), journaled with
   fsync in a temporary directory, with an `IntegrityPlane` (the
   sanitizer every 2nd dispatch, a scrub strip of 4,096 links every
   dispatch) and a `Supervisor` (a checkpoint first, then one every 2nd
   clean dispatch): three facade waves of 10,000 sessions and actions
   (the 2nd and 3rd fused-sanitized; 32,768 session rows hold three),
   1,024 staged deltas and their flush, 256 five-step sagas and a round,
   64 vouches and one `apply_slash` with one injected `InjectedWaveFault`
   that the ladder retries, every dispatch through `Supervisor.dispatch`
   and a drain after each (the dispatches under torch.profiler); then
   `metrics_prometheus`, `health_summary`, `memory_summary`,
   `flight_summary`, `session_trace` of three sessions, `history_query`,
   a seeded σ corruption the repair rung clears and a seeded FSM-code
   corruption the restore rung clears through `recover` on the card
   (each of its stages timed, the journal's reopen among them), to the
   uninterrupted history, with chain checks and an 8,192-leaf tree over
   the recovered DeltaLog. Every kernel must launch in the window and be
   named by the profiler; the same sequence on the CPU must give the
   same drains (wall-clock stage series and compile counts set apart),
   the mode (normal or degraded) at each drain and dispatch, exposition,
   summaries, span trees, history, incidents, integrity and supervisor
   accounting and tables.
   Then, by the host clock: the drain fresh and refreshing (each
   profiled once: one wait on the device, and only its copies when
   fresh), `to_prometheus`, `health_summary`, the compile watch's key,
   the watchdog and the plane's cadence hook per dispatch, a scrub tick,
   the repair rung, and the facade wave under four variants of the plane
   (none, the fused sanitizer, a scrub tick, both), rotated over sixteen
   fresh states of three waves.
15. serving: the serving front door (`serving.run_soak`) on a fresh
   state of the default tables (16,384 agents, 4,096 sessions, 65,536
   edges, 8,192 sagas), buckets (4, 8, 16, 32), an `IntegrityPlane`
   every 8th dispatch: the reference's soak (seed 11, 150 Hz, 0.8 s) on
   the card and on the CPU, whose decisions and chain-heads digests,
   offered, served, shed and orphaned counts, waves and padded lanes must
   be equal; the same soak again under torch.profiler, which must name
   every kernel of the serving path (B1, B2's ring form, B3, B4, B5, B7
   and the contribution); the overload soak (seed 18, 2,200 Hz, 0.6 s,
   95% lifecycles) on the card. Each soak: offered = served + shed +
   orphaned, no novel signature after warm-up, no invariant violation,
   every dispatch's wave wall at or above its CUDA-event device time,
   every roofline share at most 1.05; per-class latency p50/p95/p99,
   goodput, shed rate, deadline misses, waves, walls beside device times
   and the roofline's models and floor are printed. Then one
   `profiling.capture_window` around lifecycle waves, whose trace must
   name B2-B5, and one API sequence through the stdlib transport on a
   localhost port on the card and on the CPU, equal but for the wall
   clock and the backend's name.
16. tenancy: a `TenantArena` of 8 tenants, each on the default tables:
   a bucket-32 batched wave of three audit deltas (ragged lanes, vouched
   joiners), a sanitized one, a third with one tenant idle (its tables
   must not move). Each tenant equals its own solo waves
   (`run_governance_wave(..., pad_to=(32, 32))` on a solo state: tables,
   DeltaLog, metrics, chain heads, roots, members) and the same sequence
   on the CPU; each kernel's tenant form (the contribution, B4, B5, B2's
   ring form with B6's append) launches as often in a batched wave as
   its solo form in one solo wave, and is held against its plain loop
   on the card and on the CPU at the first wave's inputs, tolerance 0;
   the batched wave's device ops (torch.profiler) at most twice one solo
   wave's; its host p50 beside that of 8 solo waves. Then the
   reference's `tenant_dense` row (seed 17, T = 100, 6 rounds of 2
   lifecycles, buckets (4, 8)) through `TenantWaveScheduler` on the card
   and on the CPU (offered, served, waves and chain heads equal; no
   novel signature after warm-up; one launch of each form a round; the
   worst per-tenant p99 against its 100 ms), the flooding-tenant drill
   (the flood sheds alone, every neighbour served, their chain heads
   equal a solo oracle's) and one `recover_tenant` + `splice_tenant`.
17. autopilot: the reference's `autopilot_soak` row (`_PHASES_QUICK`,
   seed 17, 20 ms ticks, two replays, the 100 ms p99 SLO) on the card:
   one decisions digest across the replays, no invariant violation, the
   goodput against the static config, p99, the decisions and their
   outcomes, the unplanned novel signatures; then `GET /debug/autopilot`
   from a service whose state carries an autopilot that decided.
18. adversarial: `testing.scenarios` at seed 11, every scenario hardened
   and bare, on the card and on the CPU in this process under one set of
   manual ids and clock: each `ScenarioResult.to_dict()` equal (score,
   components, attack events, trace digest, details; tolerance 0), each
   hardened score at or above the containment floor (0.8), each
   scenario's kernels in its own launch window (`ADV_KERNELS`;
   slash_cascade runs host engines and launches none), and named by
   torch.profiler in a fresh process (`adversarial_census`); each
   scenario's score, attack events, digest and host wall.
19. fleet: two `WorkerSpec`s on the card (a solo worker and a 2-tenant
   arena; each a `python -m hypervisor_tpu_torch.fleet.worker`
   subprocess), a `FleetObservatory` and `FleetRegistry` behind a
   service: `GET /debug/fleet` and `/fleet/{workers,metrics,slo,trace,
   incidents}` over the stdlib transport, every merged sample labelled
   `worker=` (coverage 1.0) and the arena's rows `tenant=` too, each
   worker's kernel launches (SIGUSR1), the lease log's digest equal to
   its replay and to a fresh run of the same seeded schedule, a SIGKILL
   drill to DEAD with its fleet incident, and every process exited.
20. pipeline: `ops.pipeline.governance_pipeline`, the reference's
   headline unit, at its row's shape (S = 10,000 lanes, T = 3, sigma 0.8,
   all trustworthy, floor 0.60) and on a mixed input of the same width
   (untrustworthy, below-floor and inactive lanes, a contribution): one
   launch each of B2 and B3 a call and nothing else, every field equal to
   the CPU port's (tolerance 0), every lane's root equal to hashlib's;
   p50/p95 over 50 calls on the host clock, the device time by CUDA
   events, and torch.profiler's device ops and idle share;
21. failover: (a) the reference's `failover` row (seed 20, quick) on
   the card, its digest and counts equal to `BENCH_r20.json` and
   `BENCH_r21.json`'s; (b) its `fleet_soak` row (seed 21, quick: 135
   rounds, rebalances, two kills) equal to `BENCH_r21.json`'s; (c) the
   same protocol on arenas of the default tables: each absorbed tenant
   equal to the donor at the kill, the zombie refused with zero bytes,
   the survivors serving with no novel signature, one planned migration
   replaying nothing; (d) durable worker processes: a SIGTERM drain
   whose adopter replays nothing, a SIGKILLed worker failed over into a
   survivor on the card, `/fleet/{ownership,failover,rebalance}` and
   `POST /fleet/rebalance` served, a stale restart refused at adopt.
   Each part's launches in its own window (workers' by SIGUSR1).

22. mesh: the multi-device plane on virtual meshes of the card (its
   walkthroughs held to an 8-shard CPU mesh and the single-device wave);
23. lint: hvlint over the port (`hypervisor_tpu_torch.analysis`): Tier A
   over the tree, then Tier B's seven programs on the card under
   `torch.cuda.set_sync_debug_mode("error")`, the version-counter check
   over every in-place wrapper and the one-program check; any
   unsuppressed finding fails; the counts, the programs and both walls;
24. examples: `examples.demo`, `examples.multichip` (8 shards of the
   card), `examples.hv_top` in-process once, one refresh of
   `examples.metrics_watch` and one run of `examples.trace_watch` on the
   card and on the CPU, each output equal line for line once timings,
   clock stamps, device names and the timing and compile panels are
   masked (`testing.compare.masked_output`); the card runs' launches.

Then the kernels summary (each tenant form with its times at T = 8 and
at T = 100), the nvidia-smi line, and a last line
`{"ok": true, "device": {...}}`. Any failed check exits non-zero before
that line. Exits 2 without printing a result when CUDA is absent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import itertools
import json
import os
import re
import secrets
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_SESSIONS = 10_000
N_VOUCHED = 1_000
N_DELTAS = 3
N_SHARED_SESSIONS = 2_500  # B4's shared-session layout: four joins a session
OMEGA = 0.5
SEED = 42
WARMUP = 3
ITERS = 30
KERNEL_REPS = 20
PLAIN_REPS = 5

# The published H100 SXM peaks and the model of each kernel's work (bytes
# moved, 32-bit integer instructions issued) live in the package, shared
# with the wrappers' accounting for the roofline observatory's gauges.
from hypervisor_tpu_torch.kernels.work import (  # noqa: E402
    F32_FLOP_PER_S,
    HBM_BYTES_PER_S,
    INSTR_PER_PAIR,
    INT32_INSTRUCTIONS_PER_S,
    instr_per_message,
    kernel_work,
    tree_pairs,
)

#: The facade's standing agents, the actors of its 10,000 actions a wave
#: (bench_suite's `action_gateway_10k`: ring 2, 40 tokens, uniform slots,
#: 10% ring-0 probes), and their sudo grants: four to ring 1 that lapse
#: after the first wave, four to ring 0 that hold.
N_ACTORS = N_ACTIONS = 10_000
ACTOR_GRANTS = ((1, 1.5),) * 4 + ((0, 1e6),) * 4
#: The facade's fresh state: the reference's DeltaLog, TraceLog, EventLog
#: and ElevationTable sizes, room for three waves of sessions plus a
#: padded bucket, and agent rows for the actors plus rows that run out
#: during the third wave (its tail recycles the free list).
FACADE_CAPACITY = dict(max_agents=24_576 + N_ACTORS, max_sessions=32_768,
                       max_vouch_edges=65_536, delta_log_capacity=65_536,
                       trace_log_capacity=8_192)
FACADE_BUCKET = 10_240
N_STANDING, DELTAS_PER_STANDING = 13, 5
SCRUB_BUDGET = 4_096
BIG_TREE_LEAVES = 8_192
FACADE_WARMUP, FACADE_ITERS = 2, 10
#: The scattered facade wave: sessions terminated, and sessions left
#: standing outside the wave, between the wave's sessions.
SCATTER_GAPS = 1_000

#: The saga plane: the reference's default SagaTable, filled with
#: BASELINE's "5-step saga with retry+compensation" over standing
#: sessions, plus DSL sagas with fan-out groups.
SAGA_STEPS = 5
N_SAGA_SESSIONS = 64
N_DSL_SAGAS = 8
SAGA_WARMUP, SAGA_ITERS = 3, 30
#: The slash cascade: bench_suite's north-star row (`vouch_bond_slash_10k`)
#: and the default tables at omega 0.6.
NORTH_STAR = dict(agents=10_240, edges=8_192, seeds=128, omega=0.95, sigma=(0.4, 0.9))
DEFAULT_SLASH = dict(seeds=160, omega=0.6, sigma=(0.05, 0.6))
SLASH_WARMUP, SLASH_ITERS = 2, 20
#: (omega, k) where the float64 square-and-multiply clip factor parted
#: from the reference's powf.
PARTED_CLIPS = ((0.014, 4), (0.003, 31))
#: A tiny omega whose clip-factor table runs to the edge count: its
#: build time is the table's worst case.
TABLE_OMEGA = 1e-6
#: What B7's and B8's parity seeds their counter rows with: the round's
#: and the cascade's tallies wrap it past 2^32.
COUNTER_SEED = 0xFFFFFFF0
#: The join queue and the security surface at the reference's default
#: tables: flush 1 is tests/parity/test_admission.py's 8,192-join wave
#: (32 joins into each of 256 sessions of 64 seats), flush 2 a crowded
#: 7,000-join wave into 128 of them, padded to an 8,192 bucket; then the
#: breach window (four waves of 16,384 calls), elevation grants and
#: revokes, quarantines, 10,000 gateway actions and the row writes.
N_JOINS, N_JOIN_SESSIONS, JOIN_SEATS = 8_192, 256, 64
JOINS_PER_SESSION = N_JOINS // N_JOIN_SESSIONS
N_CROWDED, N_CROWDED_SESSIONS, JOIN_BUCKET = 7_000, 128, 8_192
BREACH_WAVES, BREACH_CALLS = 4, 16_384
N_GRANTS, N_REVOKES, N_QUARANTINED = 1_024, 16, 2_048
N_ROW_WRITES, N_TERMINATED, N_BONDS = 256, 64, 512
JOIN_WARMUP, JOIN_ITERS = 1, 20
SECURITY_WARMUP, SECURITY_ITERS = 2, 20
#: The facade's public API at the reference's default tables: 1,024
#: sessions of 8 members (8,192 `join_session` calls), 1,000 vouches made
#: before the vouchee joins, every session activated with 3 captures (64
#: in every 64th session, whose host root then takes B3) and one
#: 8-action `check_actions`, 64 grants, 16 drift slashes, 16 kills, 64
#: leaves, and every session terminated. Two blocks: the first 128
#: sessions (profiled, and replayed on the CPU), then the other 896
#: (timed).
API_SESSIONS, API_MEMBERS, API_REPLAY, API_VOUCHES = 1_024, 8, 128, 1_000
API_CAPTURES, API_LONG_CAPTURES = 3, 64
#: The manual clock's start (2026-01-01T00:00:00Z) for the facade's ids
#: and times; it moves in dyadic steps only.
API_T0 = 1_767_225_600.0
#: The lock waves: 4,096 agents of seeded sigma 0.3-0.99 over 6,144
#: paths, wave 1 of 8,192 requests (70% READ, 25% WRITE, 5% EXCLUSIVE),
#: 64 declared wait cycles of 2-8 lock holders, and wave 2 of 2,048
#: requests, half of them by cycle members against paths their cycle
#: holds (refused DEADLOCK) and half drawn as in wave 1.
LOCK_AGENTS, LOCK_PATHS, LOCK_WAVE1, LOCK_WAVE2, LOCK_CYCLES = 4_096, 6_144, 8_192, 2_048, 64
LOCK_MAX_PATHS = 16_384
LOCK_INTENT_MIX = (0.70, 0.25, 0.05)
LOCK_WARMUP, LOCK_ITERS = 1, 5
SWEEP_WARMUP, SWEEP_ITERS = 2, 10
#: The write waves: `Hypervisor(device="cuda")` at the default tables,
#: 256 sessions of 8 members, each session one `write_wave()` of 64
#: writes over 32 paths at rings 1-3 (its ring-3 writer's third of them
#: runs past the burst of 10); two writers quarantined in every 16th session;
#: 16 sessions under SNAPSHOT and 16 under SERIALIZABLE, where half the
#: writers hold write locks; `now` in dyadic steps.
WRITE_SESSIONS, WRITE_MEMBERS, WRITE_WRITES, WRITE_PATHS = 256, 8, 64, 32
#: The native host runtime against the kernels: 65,536 link messages of
#: 96 bytes (B1), 64 chains of 1,024 bodies (B2), a tree of 8,192 leaves
#: (the big-tree form through B1), 8 lanes of 4,096 leaves at mixed counts
#: (B3's widest tile), and 16,384 joins from 8 threads.
NATIVE_LINKS, NATIVE_LANES, NATIVE_TURNS, NATIVE_LEAVES = 65_536, 64, 1_024, 8_192
NATIVE_TREE_P, NATIVE_TREE_COUNTS = 4_096, (4_096, 4_095, 3_001, 2_049, 2_048, 1_000, 1, 0)
NATIVE_JOINS, NATIVE_THREADS, NATIVE_SESSIONS = 16_384, 8, 2_048
NATIVE_REPS = 5
#: The keys of the kernels summary line.
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")

#: The kernels redesigned for Hopper after their first port (csrc entry
#: functions); ptxas must report no spill for any of them.
REDESIGNED_KERNELS = ("sha256_kernel", "chain_kernel", "tree_packed_kernel", "contrib_scope_kernel",
                      "contrib_scan_kernel", "contrib_fill_kernel", "contrib_fold_kernel",
                      "contrib_large_kernel", "admission_unique", "admission_lanes",
                      "admission_ranked", "fsm_saga_kernel", "saga_tick_kernel",
                      "slash_cascade_kernel")
#: The grid-barrier probe: barriers crossed by one launch at B8's grid.
BARRIER_REPS = (0, 1, 5, 25)
#: The lone-warp probe of B1: one warp of messages at these block counts.
LATENCY_MESSAGES, LATENCY_BLOCKS = 32, (1, 2, 4, 8)
#: B1's parity counts: around one warp, the scrubber's strip, the wave's
#: 30,000 rows.
B1_MESSAGES = (1, 31, 32, 33, 4_096, 30_000)
#: Dependent integer operations from one round's e to the next e, with
#: h + K + W formed a round ahead: Sigma1's shifts, its xor, t1's add and
#: d + t1.
CRITICAL_OPS_PER_ROUND = 4
#: B3 timed beside the wave's shape on full trees of about 640,000 leaves
#: in all, on each side of the packed kernel's switch: (P, sessions).
TREE_TIMING_SHAPES = ((64, 10_000), (4096, 156))
#: Each path's kernels, for its launch-count window: the facade's waves
#: carry the DeltaLog, so B2 runs in its ring form there.
OP_WAVE_KERNELS = ("contribution_toward", "chain_digests", "tree_roots", "admission_block",
                   "fsm_saga_block")
FACADE_WAVE_KERNELS = ("contribution_toward", "chain_digests_ring", "tree_roots",
                       "admission_block", "fsm_saga_block")

TPU_KERNELS = {
    "contribution_toward": "hypervisor_tpu/ops/liability.py:93",  # an XLA scatter, not Pallas
    "chain_digests": "hypervisor_tpu/kernels/mtu_pallas.py:319",
    "tree_roots": "hypervisor_tpu/kernels/mtu_pallas.py:237",
    "admission_block": "hypervisor_tpu/kernels/wave_pallas.py:1318",
    "fsm_saga_block": "hypervisor_tpu/kernels/wave_pallas.py:1441",
    "chain_digests_ring": "hypervisor_tpu/kernels/wave_pallas.py:1528",  # B6, in B2's launch
    "sha256_words": "hypervisor_tpu/kernels/sha256_pallas.py:118",
    "saga_tick_block": "hypervisor_tpu/kernels/wave_pallas.py:1657",
    "slash_cascade": "hypervisor_tpu/kernels/liability_pallas.py:113,130",
}
SOURCES = {
    "contribution_toward": "hypervisor_tpu_torch/csrc/wave.cu",
    "chain_digests": "hypervisor_tpu_torch/csrc/mtu.cu",
    "tree_roots": "hypervisor_tpu_torch/csrc/mtu.cu",
    "admission_block": "hypervisor_tpu_torch/csrc/wave.cu",
    "fsm_saga_block": "hypervisor_tpu_torch/csrc/wave.cu",
    "chain_digests_ring": "hypervisor_tpu_torch/csrc/mtu.cu",
    "sha256_words": "hypervisor_tpu_torch/csrc/sha256.cu",
    "saga_tick_block": "hypervisor_tpu_torch/csrc/saga.cu",
    "slash_cascade": "hypervisor_tpu_torch/csrc/liability.cu",
}
#: The path whose launch window a kernel row reports (the facade waves
#: otherwise): B2 without the ring runs on bench.py's op wave, which
#: carries no DeltaLog.
ROW_PATH = {"chain_digests": "op_wave", "sha256_words": "scrubber",
            "saga_tick_block": "saga_path", "slash_cascade": "slash_path"}


#: SASS opcodes of a compression: the integer pipe's shifts, 3-input
#: logic and 3-input adds, and the multiply-adds that run on the FMA pipe.
SASS_OPCODES = ("SHF", "LOP3", "IADD3", "IMAD")


def sass_census(libraries: dict) -> dict | None:
    """Per kernel of each built library (name -> .so path): its SASS
    instructions, how many of them read the constant bank c[0x3], where
    `__constant__` data lies, and how many are each of `SASS_OPCODES`;
    None without `cuobjdump`."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    census = {}
    for lib, path in libraries.items():
        run = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                             timeout=120)
        if run.returncode != 0:
            census[lib] = {"cuobjdump_error": run.stderr.strip()[-300:]}
            continue
        fn = None
        for line in run.stdout.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                fn = f"{lib}:{found.group(1)}"
                census[fn] = {"instructions": 0, "constant_bank_reads": 0,
                              **{op: 0 for op in SASS_OPCODES}}
                continue
            instr = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
            if fn and instr:
                census[fn]["instructions"] += 1
                census[fn]["constant_bank_reads"] += "c[0x3]" in line
                if instr.group(1) in SASS_OPCODES:
                    census[fn][instr.group(1)] += 1
    return census


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


@contextlib.contextmanager
def counted_trace_ids():
    """Trace ids from a counter instead of `secrets.token_hex`, so two runs
    of one sequence draw the same ids (and the same trace words)."""
    counter = itertools.count()
    saved = secrets.token_hex
    secrets.token_hex = lambda nbytes=None: f"{next(counter):0{2 * nbytes}x}"
    try:
        yield
    finally:
        secrets.token_hex = saved


def check_bench_gates(result, bodies, tag: str) -> None:
    """bench.py's gates on one 10,000-session wave result, and hashlib on
    the chain and Merkle root of lanes 0 and K-1."""
    from hypervisor_tpu_torch import u32
    from hypervisor_tpu_torch.ops import merkle
    from hypervisor_tpu_torch.ops.sha256 import digests_to_hex

    status = result.status.cpu().numpy()
    require((status == 0).all(), f"{tag}: lanes failed: {np.unique(status)}")
    require(not bool(result.fsm_error.any()), f"{tag}: illegal session FSM walk")
    require((result.ring.cpu().numpy() == 2).all(), f"{tag}: vouched lanes not lifted / plain lanes not ring 2")
    require(np.allclose(result.sigma_eff.cpu().numpy()[:N_VOUCHED], 0.65, atol=1e-6),
            f"{tag}: vouched sigma_eff != 0.65")
    require(int(result.released) == N_VOUCHED, f"{tag}: bonds not released")
    chain_np = u32.to_numpy_u32(result.chain)
    roots_np = u32.to_numpy_u32(result.merkle_root)
    for lane in (0, N_SESSIONS - 1):
        parent, hexes = b"\x00" * 32, []
        for body in bodies[:, lane]:
            parent = hashlib.sha256(body.astype(">u4").tobytes() + parent).digest()
            hexes.append(parent.hex())
        require(digests_to_hex(chain_np[:, lane]) == hexes, f"{tag}: chain mismatch on lane {lane}")
        require(digests_to_hex(roots_np[lane][None])[0] == merkle.merkle_root_host(hexes),
                f"{tag}: root mismatch on lane {lane}")


def facade_state(device):
    """A fresh facade state of `FACADE_CAPACITY` on `device`, with its
    standing actors and their grants (`place_actors`)."""
    from hypervisor_tpu_torch.config import HypervisorConfig, TableCapacity
    from hypervisor_tpu_torch.state import HypervisorState

    state = HypervisorState(HypervisorConfig(capacity=TableCapacity(**FACADE_CAPACITY)),
                            device=device)
    place_actors(state)
    return state


def place_actors(state) -> None:
    """`N_ACTORS` standing members of one session, on rows claimed through
    the state's row allocator (no wave takes them): ring 2, sigma 0.8, 40
    tokens; and `ACTOR_GRANTS` on the first of them."""
    import torch

    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.tables.state import (
        AF32_RL_TOKENS, AF32_SIGMA_EFF, AF32_SIGMA_RAW, AI32_DID, AI32_FLAGS, AI32_SESSION,
        FLAG_ACTIVE, SI32_NPART)

    dev = state.device
    session = state.create_session("facade:actors", SessionConfig(max_participants=N_ACTORS),
                                   now=0.0)
    rows = torch.from_numpy(state._claim_wave_rows(N_ACTORS).astype(np.int64)).to(dev)
    handles = np.array([state.agent_ids.intern(f"did:actor:{i}") for i in range(N_ACTORS)],
                       np.int32)
    a = state.agents
    a.i32[rows, AI32_DID] = torch.from_numpy(handles).to(dev)
    a.i32[rows, AI32_SESSION] = session
    a.i32[rows, AI32_FLAGS] = FLAG_ACTIVE
    a.ring[rows] = 2
    for col in (AF32_SIGMA_RAW, AF32_SIGMA_EFF):
        a.f32[rows, col] = 0.8
    a.f32[rows, AF32_RL_TOKENS] = 40.0
    state.sessions.i32[session, SI32_NPART] = N_ACTORS
    state.actor_rows = rows.cpu().numpy()
    e, g = state.elevations, len(ACTOR_GRANTS)
    e.agent[:g] = rows[:g].to(torch.int32)
    e.granted_ring[:g] = torch.tensor([r for r, _ in ACTOR_GRANTS], dtype=torch.int8).to(dev)
    e.expires_at[:g] = torch.tensor([t for _, t in ACTOR_GRANTS], dtype=torch.float32).to(dev)
    e.active[:g] = True


def facade_actions(state, rng) -> dict:
    """One wave's `N_ACTIONS` actions by the standing actors: uniform
    slots (about 2x duplicates), 10% ring-0 probes, the rest ring 2."""
    return {"slots": state.actor_rows[rng.randint(0, N_ACTORS, N_ACTIONS)],
            "required_rings": np.where(rng.uniform(size=N_ACTIONS) < 0.1, 0, 2)}


def prepare_facade_wave(state, rng, w: int):
    """Wave w's 10,000 sessions, created on the state, and its inputs at
    bench.py's widths: 1,000 vouch edges (bond 0.30, through `add_vouch`,
    so a journal records them) toward the agent rows the wave's first
    lanes will claim (the bump allocator's next rows), sigma 0.5 on those
    lanes and 0.8 on the rest, random delta bodies, and the actors'
    10,000 actions."""
    from hypervisor_tpu_torch.models import SessionConfig

    slots = state.create_sessions_batch(
        [f"facade:w{w}:s{i}" for i in range(N_SESSIONS)], SessionConfig(min_sigma_eff=0.0))
    base, cap = state._next_agent_slot, state.agents.i32.shape[0]
    require(base + N_VOUCHED <= cap, "the vouched lanes must claim fresh agent rows")
    for i in range(N_VOUCHED):
        state.add_vouch(cap - N_VOUCHED + i, base + i, int(slots[i]), 0.30, bond_pct=0.0)
    sigma = np.full(N_SESSIONS, 0.8, np.float32)
    sigma[:N_VOUCHED] = 0.50
    bodies = rng.randint(0, 2**32, (N_DELTAS, N_SESSIONS, 16), dtype=np.uint64).astype(np.uint32)
    return (slots, [f"did:facade:w{w}:{i}" for i in range(N_SESSIONS)], sigma, bodies,
            facade_actions(state, rng))


GATEWAY_LANES = ("verdict", "ring_status", "eff_ring", "sigma_eff", "severity", "anomaly_rate",
                 "window_calls", "tripped")
SANITIZER_MASKS = ("agent_mask", "session_mask", "vouch_mask", "saga_mask", "elev_mask",
                   "log_mask")


def all_tables(state) -> dict:
    """Every device table of a state as the reference's state arrays,
    metrics and trace words included."""
    from hypervisor_tpu_torch.tables import StateTables, to_state_arrays

    out = to_state_arrays(StateTables(
        state.agents, state.sessions, state.vouches, state.metrics.table, state.delta_log,
        state.sagas, state.elevations, state.event_log))
    # A copy: on the CPU, .cpu() returns the live table itself.
    out["trace.words"] = state.tracer.table.words.cpu().numpy().copy()
    return out


def run_facade_sequence(device):
    """The facade sequence on `device`. Returns (records, windows, state):
    what a second device must reproduce exactly, and each path's launch
    counts, read in its own window."""
    import torch

    from hypervisor_tpu_torch import kernels, u32
    from hypervisor_tpu_torch.integrity.scrubber import MerkleScrubber
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.ops import merkle
    from hypervisor_tpu_torch.ops.sha256 import digests_to_hex

    rec, windows = {}, {}

    def window(name, fn):
        kernels.reset_launch_counts()
        out = fn()
        windows[name] = kernels.launch_counts()
        return out

    with counted_trace_ids():
        state = facade_state(device)
        rng = np.random.RandomState(SEED + 1)

        def waves():
            out = []
            for w in range(3):
                slots, dids, sigma, bodies, actions = prepare_facade_wave(state, rng, w)
                res, gw = state.run_governance_wave(
                    slots, dids, slots, sigma, bodies, now=float(w), actions=actions,
                    pad_to=(FACADE_BUCKET, FACADE_BUCKET) if w == 1 else None)
                check_bench_gates(res, bodies, f"facade wave {w}")
                out.append((slots, res, gw, all_tables(state)))
            return out

        wave_out = window("facade_waves", waves)
        for w, (_, res, gw, tables_w) in enumerate(wave_out):
            rec[f"wave{w}"] = {
                f: getattr(res, f).cpu().numpy()
                for f in ("status", "ring", "sigma_eff", "saga_step_state", "fsm_error")
            }
            rec[f"wave{w}"].update(chain=u32.to_numpy_u32(res.chain),
                                   merkle_root=u32.to_numpy_u32(res.merkle_root),
                                   released=int(res.released),
                                   gateway={f: getattr(gw, f).cpu().numpy().copy()
                                            for f in GATEWAY_LANES},
                                   tables=tables_w)
            verdicts = rec[f"wave{w}"]["gateway"]["verdict"]
            require(verdicts.shape == (N_ACTIONS,) and (verdicts == 0).any()
                    and (verdicts == 3).any(),
                    f"facade wave {w}: the gateway must allow and refuse actions")
        standing = [state.create_session(f"facade:standing:{i}", SessionConfig(), now=5.0)
                    for i in range(N_STANDING)]
        for j in range(DELTAS_PER_STANDING):
            for s in standing:
                state.stage_delta(s, 0, ts=float(j), change_words=rng.randint(0, 2**31, 8))
        rec["flush"] = window("flush", state.flush_deltas)
        truncated = [int(s) for s in wave_out[0][0]
                     if 0 < len(state._audit_rows.get(int(s), [])) < state._turns.get(int(s), 0)]
        require(truncated, "the ring wraps must leave a first-wave session with part of its history")
        scrubber = MerkleScrubber(state, budget=SCRUB_BUDGET)

        def sweep():
            reports = [scrubber.tick()]
            while not reports[-1]["sweep_completed"]:
                reports.append(scrubber.tick())
            return reports

        rec["scrub"] = window("scrubber", sweep)
        rec["scrub_summary"] = scrubber.summary()
        require(scrubber.mismatches == 0, f"the scrubber flagged a clean chain: {scrubber.last_mismatch}")
        rec["verify"] = window("verify", lambda: [
            state.verify_session_chain(s) for s in (int(wave_out[1][0][0]), truncated[0], standing[0])])
        rec["verify_links"] = len(state._audit_rows[truncated[0]])  # B1's messages there
        require(all(rec["verify"]), f"verify_session_chain failed: {rec['verify']}")
        rec["roots"] = window("terminate", lambda: state.terminate_sessions(
            standing + truncated[:1], now=6.0))
        leaves = u32.to_numpy_u32(state.delta_log.digest[:BIG_TREE_LEAVES])
        forest = np.stack([leaves, leaves[::-1], np.roll(leaves, 7, axis=0), leaves])
        counts = np.array([0, 1, BIG_TREE_LEAVES // 2 + 1, BIG_TREE_LEAVES], np.int32)
        rec["big_tree"] = window("big_tree", lambda: merkle.tree_roots_host(forest, counts, device))
        require(digests_to_hex(rec["big_tree"][3:4])[0]
                == merkle.merkle_root_host(digests_to_hex(leaves)), "big tree root != hashlib")
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        require(state._delta_cursor == int(state.delta_log.cursor)
                and state.tracer.cursor == int(state.tracer.table.cursor),
                "the host cursor mirrors disagree with the device")
        rec["tables"] = all_tables(state)
        rec["host"] = {
            "audit_rows": state._audit_rows, "turns": state._turns,
            "chain_seed": {s: v.tolist() for s, v in state._chain_seed.items()},
            "frontier_roots": {s: f.root_hex() for s, f in state._frontier.items()},
            "row_session": state._row_session.tolist(),
            "free_agent_slots": state._free_agent_slots, "members": sorted(state._members),
            "cursors": (state._delta_cursor, state.tracer.cursor),
        }
    return rec, windows, state


def run_scattered_facade(device):
    """One lifecycle wave on a session layout with gaps and in no order:
    12,000 sessions created, 1,000 of them terminated and 1,000 left
    standing, each with a live member and a live edge, and the wave's
    10,000 on the other sessions, shuffled, padded to the bucket. Returns
    (record, launches): what a second device must reproduce, and the
    wave's launch counts."""
    import torch

    from hypervisor_tpu_torch import kernels, u32
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.tables.state import AI32_FLAGS, AI32_SESSION, FLAG_ACTIVE

    with counted_trace_ids():
        state = facade_state(device)
        rng = np.random.RandomState(SEED + 9)
        n_gap = SCATTER_GAPS
        slots = state.create_sessions_batch(
            [f"scatter:s{i}" for i in range(N_SESSIONS + 2 * n_gap)], SessionConfig(min_sigma_eff=0.0))
        gaps = rng.choice(slots, 2 * n_gap, replace=False)
        ended, standing = np.sort(gaps[:n_gap]), gaps[n_gap:]
        state.terminate_sessions(ended.tolist(), now=0.5)
        wave_slots = rng.permutation(np.setdiff1d(slots, gaps)).astype(np.int32)
        dev, v, a = state.device, state.vouches, state.agents
        cap, base = a.i32.shape[0], state._next_agent_slot
        members = torch.arange(cap - N_VOUCHED - n_gap, cap - N_VOUCHED, device=dev)
        a.i32[members, AI32_SESSION] = torch.from_numpy(standing).to(dev)
        a.i32[members, AI32_FLAGS] = FLAG_ACTIVE
        e = slice(0, N_VOUCHED)
        v.voucher[e] = torch.arange(cap - N_VOUCHED, cap, dtype=torch.int32, device=dev)
        v.vouchee[e] = torch.arange(base, base + N_VOUCHED, dtype=torch.int32, device=dev)
        v.session[e] = torch.from_numpy(wave_slots[:N_VOUCHED]).to(dev)
        g = slice(N_VOUCHED, N_VOUCHED + n_gap)
        v.voucher[g] = members.to(torch.int32)
        v.vouchee[g] = members.flip(0).to(torch.int32)
        v.session[g] = torch.from_numpy(standing).to(dev)
        for sl in (e, g):
            v.bond[sl] = 0.30
            v.active[sl] = True
        sigma = np.full(N_SESSIONS, 0.8, np.float32)
        sigma[:N_VOUCHED] = 0.50
        bodies = rng.randint(0, 2**32, (N_DELTAS, N_SESSIONS, 16), dtype=np.uint64).astype(np.uint32)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res = state.run_governance_wave(
            wave_slots, [f"did:scatter:{i}" for i in range(N_SESSIONS)], wave_slots, sigma, bodies,
            now=1.0, pad_to=(FACADE_BUCKET, FACADE_BUCKET))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_bench_gates(res, bodies, "scattered facade wave")
        require(bool((a.i32[members, AI32_FLAGS] == FLAG_ACTIVE).all())
                and bool(v.active[g].all()),
                "scattered facade wave: a standing session outside the wave lost a member or a bond")
        rec = {f: getattr(res, f).cpu().numpy()
               for f in ("status", "ring", "sigma_eff", "saga_step_state", "fsm_error")}
        rec.update(chain=u32.to_numpy_u32(res.chain), merkle_root=u32.to_numpy_u32(res.merkle_root),
                   released=int(res.released))
        rec["tables"] = all_tables(state)
        rec["host"] = {"audit_rows": state._audit_rows, "members": sorted(state._members),
                       "frontier_roots": {s: f.root_hex() for s, f in state._frontier.items()},
                       "free_agent_slots": state._free_agent_slots}
    return rec, launches


def run_sanitized_wave(device):
    """One governance wave through `ops.pipeline.governance_wave` with all
    eight phases and the sanitizer on, on a fresh facade state: 10,000
    sessions, the actors' 10,000 actions, the DeltaLog, the epilogue
    over every table. Four rows are corrupted first (a flags word, a
    session's seat count, a bond, a grant's holder), so the sanitizer's
    masks have something to find. Returns (record, launches)."""
    import torch

    from hypervisor_tpu_torch import kernels, u32
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.ops import pipeline
    from hypervisor_tpu_torch.tables.state import AI32_FLAGS, SI32_NPART

    with counted_trace_ids():
        state = facade_state(device)
        rng = np.random.RandomState(SEED + 12)
        crowded = state.create_session("facade:crowded", SessionConfig(), now=0.0)
        slots, dids, sigma, bodies, actions = prepare_facade_wave(state, rng, 0)
        actor0 = int(state.actor_rows[0])
        state.agents.i32[actor0, AI32_FLAGS] |= 1 << 9
        state.sessions.i32[crowded, SI32_NPART] = 99
        state.vouches.bond[N_VOUCHED + 3] = -1.0
        state.vouches.active[N_VOUCHED + 3] = True
        state.elevations.agent[len(ACTOR_GRANTS) - 1] = 10**6
        lanes = state.stage_wave(state._claim_wave_rows(N_SESSIONS), dids, slots, sigma, bodies)
        act = state._normalize_actions(actions)
        gateway_args = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(state.device)
                             for c in state._pad_gateway_lanes(act))
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res = pipeline.governance_wave(
            **lanes, trace=None, delta_log=state.delta_log, delta_cursor=state._delta_cursor,
            elevations=state.elevations, gateway_args=gateway_args,
            breach=state.config.breach, rate_limit=state.config.rate_limit,
            epilogue_tables=(state.sagas, state.event_log), sanitize=True, config=state.config)
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_bench_gates(res, bodies, "sanitized wave")
        san = res.sanitizer
        rec = {f: getattr(san, f).cpu().numpy() for f in SANITIZER_MASKS}
        rec.update(total=int(san.total), unrepairable=int(san.unrepairable),
                   gateway={f: getattr(res.gateway, f)[:N_ACTIONS].cpu().numpy()
                            for f in GATEWAY_LANES},
                   chain=u32.to_numpy_u32(res.chain), tables=all_tables(state))
        require(rec["agent_mask"][actor0] and rec["session_mask"][crowded]
                and rec["vouch_mask"][N_VOUCHED + 3] and rec["elev_mask"][len(ACTOR_GRANTS) - 1]
                and rec["total"] == 4 and rec["unrepairable"] == 0,
                f"sanitized wave: the sanitizer must flag the four corrupted rows "
                f"(total {rec['total']}, unrepairable {rec['unrepairable']})")
    return rec, launches


def gateway_actions(rng, rows, n: int) -> dict:
    """`n` actions in bench_suite's `action_gateway_10k` mix by the given
    agent rows: uniform slots, 10% ring-0 probes, the rest ring 2."""
    z = np.zeros(n, bool)
    return {"slots": rows[rng.randint(0, len(rows), n)],
            "required_rings": np.where(rng.uniform(size=n) < 0.1, 0, 2),
            "is_read_only": z, "has_consensus": z, "has_sre_witness": z, "host_tripped": z}


def joins_host(state) -> dict:
    """The host indices the join queue and the security surface keep."""
    return {"members": sorted(state._members),
            "slot_of_member": sorted(state._slot_of_member.items()),
            "free_agent_slots": list(state._free_agent_slots),
            "free_edge_slots": list(state._free_edge_slots),
            "free_elev_slots": list(state._free_elev_slots),
            "scrubbed_edges": list(state._scrubbed_edges),
            "staged": (sorted(state._staged_members), sorted(state._pending_rows.items())),
            "last_join_results": sorted(state.last_join_results.items()),
            "cursors": [state._next_agent_slot, state._next_session_slot, state._next_elev_slot,
                        state.tracer.cursor]}


def enqueue_bulk(state, sessions):
    """Flush 1's staging: `N_JOINS` joins, `JOINS_PER_SESSION` into each of
    `N_JOIN_SESSIONS` sessions, sigma 0.8; returns the dids."""
    dids = [f"did:join:{i}" for i in range(N_JOINS)]
    for i, did in enumerate(dids):
        state.enqueue_join(int(sessions[i % N_JOIN_SESSIONS]), did, 0.8)
    return dids


def crowded_joins(state, sessions, dids, rng) -> list:
    """Flush 2's lanes: `N_CROWDED` joins into the first
    `N_CROWDED_SESSIONS` of flush 1's sessions (their last two terminated
    first, which archives them and frees their members' rows), shuffled:
    5% duplicates of flush 1's members, 5% below the sessions' sigma
    floor, 2% on the terminated sessions, 10% untrustworthy, eight lanes
    each at sigma -0.0 and 1.5, and the rest fresh joins that overrun
    the free seats."""
    state.terminate_sessions(sessions[N_CROWDED_SESSIONS - 2:N_CROWDED_SESSIONS].tolist(),
                             now=1.5)
    n = N_CROWDED
    kind = np.zeros(n, np.int8)  # 0 fresh, 1 duplicate, 2 below the floor, 3 terminated
    kind[: n // 20] = 1
    kind[n // 20: n // 10] = 2
    kind[n // 10: n // 10 + n // 50] = 3
    lanes = []
    for i, k in enumerate(kind.tolist()):
        if k == 1:
            j = int(rng.randint(0, N_CROWDED_SESSIONS - 2)) + N_JOIN_SESSIONS * int(
                rng.randint(0, JOINS_PER_SESSION))
            lanes.append((int(sessions[j % N_JOIN_SESSIONS]), dids[j], 0.8, True))
            continue
        sess = int(sessions[N_CROWDED_SESSIONS - 2 + int(rng.randint(0, 2))] if k == 3
                   else sessions[int(rng.randint(0, N_CROWDED_SESSIONS - 2))])
        sigma = 0.65 if k == 2 else float(rng.uniform(0.76, 1.0))
        lanes.append((sess, f"did:crowd:{i}", sigma, k == 2 or rng.uniform() >= 0.1))
    for i in range(16):
        sess, did, _, trust = lanes[n - 1 - i]
        lanes[n - 1 - i] = (sess, did, -0.0 if i < 8 else 1.5, trust)
    return [lanes[i] for i in rng.permutation(n)]


def run_joins_security(device):
    """The join queue and the security surface at the reference's default
    tables (16,384 agents, 4,096 sessions, 65,536 edges, 4,096
    elevations) on a fresh state: two join flushes (the second crowded
    and padded to a bucket), the breach window and two sweeps, 1,024
    elevation grants with a tick and revokes, 2,048 quarantines with
    re-entries and a tick, rate consumes on unique and repeated slots,
    the gateway as a wave of its own, ring, risk and session writes, 256
    leaves, and a terminate wave that reclaims granted rows. Returns
    (records, launches, state): what a second device must reproduce,
    and the launch counts of the whole sequence."""
    import torch

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.models import ConsistencyMode, SessionConfig
    from hypervisor_tpu_torch.observability import metrics as schema
    from hypervisor_tpu_torch.state import HypervisorState
    from hypervisor_tpu_torch.tables.state import FLAG_ACTIVE

    rec = {}
    with counted_trace_ids():
        state = HypervisorState(device=device)
        rng = np.random.RandomState(SEED + 13)

        def record(label, value=None):
            rec[label] = {"value": value, "tables": all_tables(state), "host": joins_host(state)}

        def live_rows():
            return np.nonzero((state.agents.flags.cpu().numpy() & FLAG_ACTIVE) != 0)[0]

        def admission_tally():
            c = state.metrics.table.counters.cpu().numpy().view(np.uint32)
            return [int(c[schema.ADMITTED.index]), int(c[schema.REFUSED.index]),
                    float(state.metrics.table.hist_sum.cpu().numpy()[schema.WAVE_LANES.index])]

        kernels.reset_launch_counts()
        sessions = state.create_sessions_batch(
            [f"join:s{i}" for i in range(N_JOIN_SESSIONS)],
            SessionConfig(max_participants=JOIN_SEATS, min_sigma_eff=0.75))
        timed = [state.create_session(f"join:timed{i}", SessionConfig(max_duration_seconds=100),
                                      now=0.0) for i in range(4)]
        dids = enqueue_bulk(state, sessions)
        status1 = state.flush_joins(now=1.0)
        require((status1 == 0).all(), "join flush 1: every join must be admitted")
        # Bonds between flush 1's members, some of them later leavers.
        members = np.array([state.agent_row(d, int(sessions[i % N_JOIN_SESSIONS]))["slot"]
                            for i, d in enumerate(dids)])
        for i in rng.choice(N_JOINS, N_BONDS, replace=False):
            state.add_vouch(int(members[i]), int(members[(i + N_JOIN_SESSIONS) % N_JOINS]),
                            int(sessions[i % N_JOIN_SESSIONS]), bond=0.1)
        record("flush1", status1)
        lanes = crowded_joins(state, sessions, dids, rng)
        for sess, did, sigma, trust in lanes:
            state.enqueue_join(sess, did, sigma, trustworthy=trust)
        before = admission_tally()
        status2 = state.flush_joins(now=2.0, pad_to=JOIN_BUCKET)
        after = admission_tally()
        codes = np.bincount(status2, minlength=5).tolist()
        require(len(status2) == N_CROWDED and all(codes),
                f"join flush 2: every status must occur on the crowded wave, got {codes}")
        require([a - b for a, b in zip(after, before)] == [codes[0], N_CROWDED - codes[0],
                                                           float(N_CROWDED)],
                "join flush 2: the pad lanes must stay out of the counters and the histogram")
        record("flush2", {"status": status2, "codes": codes})

        live = live_rows()
        bad = rng.choice(live, len(live) // 20, replace=False)
        for w in range(BREACH_WAVES):
            slots = np.where(rng.uniform(size=BREACH_CALLS) < 0.25,
                             rng.choice(bad, BREACH_CALLS), rng.choice(live, BREACH_CALLS))
            privileged = np.isin(slots, bad) & (rng.uniform(size=BREACH_CALLS) < 0.8)
            state.record_calls(slots, np.where(privileged, 0, 3), now=10.0 + w)
        severity, tripped = state.breach_sweep_tick(now=14.0)
        require(int(tripped.sum()) > 0 and not tripped[np.setdiff1d(live, bad)].any(),
                "breach sweep: only the privileged callers may trip, and some must")
        record("breach_sweep", {"severity": severity, "tripped": tripped})
        cooldown = state.config.breach.circuit_breaker_cooldown_seconds
        severity, tripped = state.breach_sweep_tick(now=14.0 + cooldown + 1.0)
        record("breach_release", {"severity": severity, "tripped": tripped})

        grant_rows = rng.choice(live, N_GRANTS, replace=False)
        ttls = rng.choice([5.0, 8.5, 150.0, 1e9], N_GRANTS)
        rings = state.agents.ring.cpu().numpy()
        grants = [state.grant_elevation(int(r), int(rings[r]) - 1, now=50.0, ttl_seconds=float(t))
                  for r, t in zip(grant_rows, ttls)]
        record("grants", grants)
        expired = state.elevation_tick(now=60.0)
        require(0 < expired < N_GRANTS, "elevation tick: about half the grants must lapse")
        record("elevation_tick", {"expired": expired, "rings": state.effective_rings(now=60.0)})
        held = [g for g, t in zip(grants, ttls) if t > 10.0][:N_REVOKES]
        for g in held:
            state.revoke_elevation(g, expected_agent=int(state.elevations.agent[g]))
        record("revokes", held)

        quarantined = rng.choice(live, N_QUARANTINED, replace=False)
        half = N_QUARANTINED // 2
        state.quarantine_rows(quarantined[:half], now=70.0, duration=30.0)
        state.quarantine_rows(quarantined[half:], now=70.0, duration=200.0)
        state.quarantine_rows(quarantined[: half // 2], now=80.0, duration=500.0)  # re-entries
        released = state.quarantine_tick(now=105.0)
        require(sorted(released) == sorted(quarantined[:half].tolist()),
                "quarantine tick: the first half's deadlines must pass, re-entries included")
        record("quarantine", {"released": released, "mask": state.quarantined_mask()})

        n_rows = state.agents.ring.shape[0]
        record("consume_unique", state.consume_rate(rng.permutation(n_rows), now=110.0))
        # A quarter of the calls on 64 hot rows, which run out of tokens.
        dup_slots = np.where(rng.uniform(size=n_rows) < 0.25, rng.choice(live[:64], n_rows),
                             rng.choice(live, n_rows))
        allowed = state.consume_rate(dup_slots, now=110.5)
        require(0 < int(allowed.sum()) < n_rows, "consume_rate: the hot rows must run dry")
        record("consume_duplicates", allowed)

        act = gateway_actions(rng, live, N_ACTIONS)
        gw = state.check_actions_wave(**act, now=120.0)
        record("gateway", {f: getattr(gw, f).cpu().numpy().copy() for f in GATEWAY_LANES})

        moved = rng.choice(live, N_ROW_WRITES, replace=False)
        for r in moved:
            state.set_agent_ring(int(r), int(rng.randint(1, 4)), now=125.0)
            state.set_agent_risk(int(r), float(rng.uniform(0, 1)))
        stayed = np.nonzero(np.arange(N_JOINS) % N_JOIN_SESSIONS
                            < N_CROWDED_SESSIONS - 2)[0]  # not of a terminated session
        leavers = rng.choice(stayed, N_ROW_WRITES, replace=False)
        for j in leavers:
            state.leave_agent(int(sessions[j % N_JOIN_SESSIONS]), dids[j])
        for s in sessions[:16]:
            state.force_session_mode(int(s), ConsistencyMode.STRONG)
        expiry = [state.session_expiry_sweep(now=t) for t in (50.0, 130.0)]
        require(expiry == [[], timed], f"session expiry sweep: {expiry}")
        scrubbed = state.pop_scrubbed_edges()
        require(len(scrubbed) > 0, "leave_agent: the leavers' bonds must be scrubbed")
        record("writes", {"expiry": expiry, "scrubbed": scrubbed})

        holder = state.elevations.agent.cpu().numpy()
        granted = set(holder[state.elevations.active.cpu().numpy()].tolist())
        sess_col = state.agents.session.cpu().numpy()
        ending = sorted({int(sess_col[r]) for r in granted if int(sess_col[r]) >= 0}
                        - {int(s) for s in sessions[N_CROWDED_SESSIONS - 2:N_CROWDED_SESSIONS]}
                        )[:N_TERMINATED]
        require(len(ending) == N_TERMINATED, "terminate: too few sessions hold grants")
        reclaimed = np.nonzero(np.isin(sess_col, ending) & np.isin(np.arange(n_rows), live_rows()))[0]
        roots = state.terminate_sessions(ending, now=140.0)
        e_agent = state.elevations.agent.cpu().numpy()
        e_active = state.elevations.active.cpu().numpy()
        require(not (e_active & np.isin(e_agent, reclaimed)).any(),
                "terminate: a reclaimed row still holds an active grant")
        record("terminate", {"roots": roots, "sessions": ending})
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        require(state.tracer.cursor == int(state.tracer.table.cursor),
                "the trace cursor mirror disagrees with the device")
    return rec, launches, state


@contextlib.contextmanager
def manual_ids_and_time(clock: list):
    """Ids and times the same on every run, for the port's callers only
    (torch.profiler draws a uuid of its own): `uuid.uuid4` and
    `secrets.token_hex` count up from 1, and `time.time` and the port's
    `datetime.now` read `clock[0]`, which only the caller moves."""
    import datetime as dt
    import uuid

    class ManualDatetime(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls.fromtimestamp(clock[0], tz)

    def for_the_port(manual, real):
        def pick(*args):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            return (manual if caller.startswith("hypervisor_tpu_torch") else real)(*args)
        return pick

    ids, words = itertools.count(1), itertools.count(1)
    saved = (uuid.uuid4, secrets.token_hex, time.time)
    # The count sits in the top and the bottom bits, so ids cut from a
    # uuid's first 8 hex digits (locks, elevations) stay distinct too.
    uuid.uuid4 = for_the_port(lambda: uuid.UUID(int=(lambda n: n << 96 | n)(next(ids))),
                              saved[0])
    secrets.token_hex = for_the_port(
        lambda nbytes=None: f"{next(words):0{2 * (nbytes or 32)}x}", saved[1])
    time.time = for_the_port(lambda: clock[0], saved[2])
    patched = [m for name, m in list(sys.modules.items())
               if name.startswith("hypervisor_tpu_torch") and getattr(m, "datetime", None)
               is dt.datetime]
    for m in patched:
        m.datetime = ManualDatetime
    try:
        yield
    finally:
        uuid.uuid4, secrets.token_hex, time.time = saved
        for m in patched:
            m.datetime = dt.datetime


def plain(value):
    """A facade return value as plain data (dataclasses as dicts, enums as
    values, datetimes as ISO strings), for comparing two runs."""
    import dataclasses
    import datetime as dt
    import enum

    import torch

    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, dt.datetime):
        return value.isoformat()
    if isinstance(value, BaseException):
        return f"raised {type(value).__name__}: {value}"
    if isinstance(value, dict):
        return {str(k): plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy().copy()
    if isinstance(value, np.generic):
        return value.item()
    return value


class Drift:
    """The CMVK verifier the facade phase injects: the drift score is
    |claimed - observed|."""

    def verify_embeddings(self, embedding_a, embedding_b, **_):
        import types

        return types.SimpleNamespace(drift_score=abs(float(embedding_a) - float(embedding_b)),
                                     explanation=None)


def api_snapshot(hv) -> dict:
    """Every table's bytes, the metrics table, the host counters, the
    event bus rows and events, the ledger and the facade's host indices."""
    st = hv.state
    return {
        "tables": all_tables(st),
        "host_counters": st.metrics._h_counters.copy(),
        "bus_rows": list(hv.event_bus.device_rows(0)),
        "bus_events": [e.to_dict() for e in hv.event_bus.all_events],
        "ledger": plain([hv.ledger.get_agent_history(a) for a in sorted(hv.ledger.tracked_agents)]),
        "edge_of_vouch": sorted(hv._edge_of_vouch.items()),
        "penalized_in": {k: sorted(v) for k, v in sorted(hv._penalized_in.items())},
        "elev_row_of": sorted(hv._elev_row_of.items()),
        "members": sorted(st._members),
        "free_agent_slots": list(st._free_agent_slots),
        "free_edge_slots": list(st._free_edge_slots),
    }


def run_facade_api(device, blocks, census_block=None):
    """The facade's public async API on `device` at the reference's
    default tables (`API_*`): each block of session indices [lo, hi)
    creates its sessions, joins their members (vouches before the vouchee
    joins), activates, captures and checks actions, runs the security
    calls, and terminates them all. Ids and times come from
    `manual_ids_and_time`. Returns (records, launches, times, census):
    per block the returned values and the snapshot at its end, the
    kernel launch counts of the whole run, the host-clock milliseconds of
    each timed call (CUDA only, synchronised; none in `census_block`),
    and `census_block`'s device ops by name from torch.profiler, with the
    block's wall and device-busy milliseconds."""
    import asyncio

    import torch

    import hypervisor_tpu_torch as hvt
    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.integrations.cmvk_adapter import CMVKAdapter
    from hypervisor_tpu_torch.security.kill_switch import KillReason
    from hypervisor_tpu_torch.testing import same_health_on_every_run

    on_card = torch.device(device).type == "cuda"
    clock = [API_T0]
    rec, times, census = {}, {k: [] for k in ("join_session", "check_actions",
                                              "verify_behavior", "terminate_session")}, {}

    async def timed(name, awaitable, measure):
        if not measure:
            return await awaitable
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        out = await awaitable
        torch.cuda.synchronize()
        times[name].append((time.perf_counter_ns() - t) / 1e6)
        return out

    def member(s, j):
        return f"did:api:{s}:{j}"

    async def block(hv, lo, hi, measure):
        rng = np.random.RandomState(SEED + 20 + lo)
        sigma = rng.uniform(0.3, 0.99, (hi - lo, API_MEMBERS))
        sigma[:, :2] = rng.uniform(0.7, 0.9, (hi - lo, 2))  # the voucher and the grantee
        out = {"sessions": [], "rings": [], "vouches": [], "checks": [], "security": [],
               "roots": []}
        managed = []
        for s in range(lo, hi):
            ms = await hv.create_session(hvt.SessionConfig(), creator_did="did:api:lead")
            managed.append(ms)
            out["sessions"].append((ms.sso.session_id, ms.slot))
        for i, ms in enumerate(managed):
            s, sid = lo + i, ms.sso.session_id
            for j in range(API_MEMBERS):
                if j == API_MEMBERS // 2 and s < API_VOUCHES:
                    out["vouches"].append(plain(hv.vouching.vouch(
                        member(s, 0), member(s, 5), sid, voucher_sigma=float(sigma[i, 0]))))
                out["rings"].append(int(await timed("join_session", hv.join_session(
                    sid, member(s, j), sigma_raw=float(sigma[i, j])), measure)))
        for i, ms in enumerate(managed):
            s, sid = lo + i, ms.sso.session_id
            await hv.activate_session(sid)
            turns = API_LONG_CAPTURES if s % 64 == 63 else API_CAPTURES
            for t in range(turns):
                ms.delta_engine.capture(member(s, t % API_MEMBERS), [hvt.VFSChange(
                    path=f"/s{s}/t{t}.md", operation="add", content_hash=f"{s * 4096 + t:064x}")])
            requests = [(member(s, j), hvt.ActionDescriptor(
                action_id=f"act{j}", name="write", execute_api="/x", undo_api="/undo",
                reversibility=hvt.ReversibilityLevel.FULL, is_read_only=j % 2 == 0,
                is_admin=j == API_MEMBERS - 1)) for j in range(API_MEMBERS)]
            out["checks"].append(plain(await timed("check_actions",
                                                   hv.check_actions(sid, requests), measure)))
        clock[0] += 1.0
        for i, ms in enumerate(managed):
            s, sid = lo + i, ms.sso.session_id
            if s % 16 == 0:
                out["security"].append(("grant", s, plain(await hv.grant_elevation(
                    sid, member(s, 1), hvt.ExecutionRing.RING_1_PRIVILEGED, ttl_seconds=600))))
            if s % 64 == 5:
                out["security"].append(("slash", s, plain(await timed(
                    "verify_behavior", hv.verify_behavior(
                        sid, member(s, 5), claimed_embedding=0.9, observed_embedding=0.0),
                    measure))))
            if s % 64 == 37:
                hv.kill_switch.register_substitute(sid, member(s, 3))
                out["security"].append(("kill", s, plain(await hv.kill_agent(
                    sid, member(s, 2), reason=KillReason.RING_BREACH,
                    in_flight_steps=[{"step_id": f"step{s}", "saga_id": f"saga{s}"}]))))
            if s % 16 == 9:
                await hv.leave_session(sid, member(s, 6))
                out["security"].append(("leave", s))
        clock[0] += 1.0
        out["mirrored"] = [hv.sync_events_to_device()]
        for ms in managed:
            out["roots"].append(await timed("terminate_session",
                                            hv.terminate_session(ms.sso.session_id), measure))
        out["mirrored"].append(hv.sync_events_to_device())
        out["ledger_profiles"] = plain([hv.ledger.compute_risk_profile(member(s, j))
                                        for s in range(lo, min(hi, lo + 8))
                                        for j in range(API_MEMBERS)])
        out["snapshot"] = api_snapshot(hv)
        return out

    async def drive():
        hv = hvt.Hypervisor(device=device, event_bus=hvt.HypervisorEventBus(),
                            cmvk=CMVKAdapter(verifier=Drift()))
        same_health_on_every_run(hv)
        for lo, hi in blocks:
            profiled = on_card and (lo, hi) == census_block
            if profiled:
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CUDA])
                with prof:
                    t0 = time.perf_counter_ns()
                    rec[f"block{lo}"] = await block(hv, lo, hi, False)
                    torch.cuda.synchronize()
                    census["wall_ms"] = (time.perf_counter_ns() - t0) / 1e6
                ops = census["ops"] = {}
                for e in prof.key_averages():
                    if e.device_type == DeviceType.CUDA:
                        ops[e.key[:100]] = ops.get(e.key[:100], 0) + e.count
                        census["busy_ms"] = census.get("busy_ms", 0.0) + e.self_device_time_total / 1e3
            else:
                rec[f"block{lo}"] = await block(hv, lo, hi, on_card)
        if on_card:
            torch.cuda.synchronize()
        return hv

    with manual_ids_and_time(clock):
        kernels.reset_launch_counts()
        hv = asyncio.run(drive())
        launches = kernels.launch_counts()
    require(hv.state.tracer.cursor == int(hv.state.tracer.table.cursor),
            "facade_api: the trace cursor mirror disagrees with the device")
    return rec, launches, times, census


#: The durability phase: the facade cell's tables, journaled with fsync
#: into a write-ahead log in a temporary directory, through every kind of
#: journaled dispatch the main path has. Two facade waves (10,000
#: sessions and actions each, the second padded to the bucket; their
#: 1,000 vouch edges through `add_vouch`), `DUR_JOINS` joins over
#: `DUR_JOIN_SESSIONS` sessions and their flush, `DUR_VOUCHES` vouches
#: among the members, `DUR_DELTA_SESSIONS` x `DUR_DELTAS` staged deltas
#: and a flush, `DUR_SAGAS` five-step sagas over `DUR_ROUNDS` rounds, one
#: `apply_slash`, `DUR_CONSUMES` rate consumes, `DUR_GRANTS` grants,
#: `DUR_QUARANTINED` quarantines and a terminate of the delta sessions;
#: a checkpoint after the first wave. `DUR_TIMING_ITERS` pairs of facade
#: waves, with and without the journal, give its cost per wave.
DUR_JOINS, DUR_JOIN_SESSIONS, DUR_JOIN_SEATS = 8_192, 256, 64
DUR_VOUCHES, DUR_DELTA_SESSIONS, DUR_DELTAS = 512, 64, 4
DUR_SAGAS, DUR_ROUNDS = 1_024, 3
DUR_CONSUMES, DUR_GRANTS, DUR_QUARANTINED = 2_048, 16, 64
DUR_VERIFY_SAMPLE = 8
DUR_TIMING_ITERS = 4
#: The chaos run's plan: the reference's end-to-end drill seed.
DUR_CHAOS = dict(seed=11, fail_rate=0.4)
#: Kernel name fragments in a torch.profiler census: the port's own
#: kernels, and torch's (ATen, its cub, the copies and fills).
OUR_KERNELS = {"sha256_words": "sha256_kernel", "chain_digests": "chain_kernel<false",
               "chain_digests_ring": "chain_kernel<true, false>", "tree_roots": "tree_",
               "admission_block": "admission_", "fsm_saga_block": "fsm_saga_kernel",
               "contribution_toward": "contrib_", "saga_tick_block": "saga_tick_kernel",
               "slash_cascade": "slash_cascade_kernel"}
TORCH_KERNELS = ("at::", "at_cuda_detail", "Memcpy", "Memset")


def durable_fingerprint(state) -> dict:
    """What recovery must reproduce bit for bit: every checkpointed column
    (by the SHA-256 of its bytes, with its dtype and shape), the chain
    seeds, the membership keys, the turn counters and the host mirror of
    the DeltaLog cursor."""
    from hypervisor_tpu_torch.runtime.checkpoint import state_arrays

    arrays = {k: (str(v.dtype), v.shape, hashlib.sha256(v.tobytes()).hexdigest())
              for k, v in state_arrays(state).items()}
    members = hashlib.sha256(np.array(sorted(state._members), np.int64).tobytes()).hexdigest()
    return {"arrays": arrays, "chain": {s: tuple(int(w) for w in v)
                                        for s, v in state._chain_seed.items()},
            "members": members, "turns": dict(state._turns),
            "delta_cursor": state._delta_cursor}


def journaled_facade_wave(state, rng, w: int, dispatch, mark):
    """Facade wave w (`prepare_facade_wave`), `mark` between its staging
    and the wave, the wave through `dispatch`, and bench.py's gates.
    Returns the wave's session slots."""
    slots, dids, sigma, bodies, actions = prepare_facade_wave(state, rng, w)
    mark(f"wave {w} staged")
    res, _ = dispatch(state.run_governance_wave, slots, dids, slots, sigma, bodies,
                      now=float(w), actions=actions,
                      pad_to=(FACADE_BUCKET, FACADE_BUCKET) if w == 1 else None)
    check_bench_gates(res, bodies, f"durability wave {w}")
    return slots


def durability_sequence(state, dispatch, mark, checkpoint) -> dict:
    """The durability phase's sequence on a fresh facade state: every
    gated dispatch (waves, flushes, saga rounds, the slash, the
    terminate) goes through `dispatch`, `mark(label)` runs at each step
    boundary and `checkpoint()` once, after the first wave. Returns the
    waves' and the delta sessions' slots, which the checks sample."""
    from hypervisor_tpu_torch.models import SessionConfig

    rng = np.random.RandomState(SEED + 30)
    out = {"waves": [journaled_facade_wave(state, rng, 0, dispatch, mark)]}
    checkpoint()
    out["waves"].append(journaled_facade_wave(state, rng, 1, dispatch, mark))
    mark("wave 1")
    sessions = state.create_sessions_batch(
        [f"dur:s{i}" for i in range(DUR_JOIN_SESSIONS)],
        SessionConfig(min_sigma_eff=0.0, max_participants=DUR_JOIN_SEATS))
    dids = [f"did:dur:{i}" for i in range(DUR_JOINS)]
    # Below ring 1's threshold (0.95), so every member can take a grant.
    sigma = rng.uniform(0.3, 0.94, DUR_JOINS).astype(np.float32)
    for i, did in enumerate(dids):
        state.enqueue_join(int(sessions[i % DUR_JOIN_SESSIONS]), did, float(sigma[i]))
    mark("enqueued")
    status = dispatch(state.flush_joins, now=2.0)
    require((status == 0).all(), f"durability: a join was refused: {np.unique(status)}")
    mark("joins flushed")

    def member(i):  # the row of join i (session i % DUR_JOIN_SESSIONS)
        return state.agent_row(dids[i], int(sessions[i % DUR_JOIN_SESSIONS]))["slot"]

    n_s = DUR_JOIN_SESSIONS
    for k in range(DUR_VOUCHES):
        s, voucher = k % n_s, (k // n_s) * 2 * n_s  # members 0 and 2 vouch for member 1
        state.add_vouch(member(s + voucher), member(s + n_s), int(sessions[s]), 0.125,
                        bond_pct=0.25)
    mark("vouched")
    for j in range(DUR_DELTAS):
        for s in range(DUR_DELTA_SESSIONS):
            state.stage_delta(int(sessions[s]), member(s + (j % 4) * n_s), ts=2.0 + j / 8,
                              change_words=rng.randint(0, 2**31, 8))
    dispatch(state.flush_deltas)
    mark("deltas flushed")
    sagas = [state.create_saga(f"dur:saga:{g}", int(sessions[g % n_s]),
                               [{"retries": 1, "has_undo": True}] * SAGA_STEPS)
             for g in range(DUR_SAGAS)]
    for r in range(DUR_ROUNDS):
        ok = rng.uniform(size=DUR_SAGAS) > 0.2
        dispatch(state.saga_round, {g: bool(o) for g, o in zip(sagas, ok)})
        mark(f"saga round {r}")
    slash = dispatch(state.apply_slash, int(sessions[0]), member(n_s), 0.95, now=3.0)
    require(slash["clipped"], "durability: the slash must clip the vouchers")
    mark("slashed")
    pool = np.array([member(i) for i in range(n_s, 2 * n_s)], np.int32)
    state.consume_rate(pool[rng.randint(0, len(pool), DUR_CONSUMES)], now=3.25)
    for s in range(1, DUR_GRANTS + 1):
        state.grant_elevation(member(s + 3 * n_s), 1, now=3.5, ttl_seconds=60.0)
    state.quarantine_rows([member(s + 4 * n_s) for s in range(100, 100 + DUR_QUARANTINED)],
                          now=3.75)
    mark("security")
    out["delta_sessions"] = [int(s) for s in sessions[:DUR_DELTA_SESSIONS]]
    dispatch(state.terminate_sessions, out["delta_sessions"], now=4.0)
    mark("terminated")
    return out


def retry_by_hand(counter: list):
    """A dispatch that retries an injected wave fault until the call goes
    through, by hand (phase `observability` drives the supervisor's
    ladder)."""
    from hypervisor_tpu_torch.testing import InjectedWaveFault

    def dispatch(fn, *args, **kw):
        while True:
            try:
                return fn(*args, **kw)
            except InjectedWaveFault:
                counter.append(fn.__name__)

    return dispatch


def mount_of(path) -> str:
    """The mount point and filesystem type holding `path` (/proc/mounts)."""
    best = ("?", "?")
    with contextlib.suppress(OSError), open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) > 2 and str(path).startswith(parts[1]) and len(parts[1]) >= len(best[0]):
                best = (parts[1], parts[2])
    return f"{best[0]} ({best[1]})"


def run_durability(device, workdir) -> dict:
    """The durability phase on `device` (a CUDA device; the CPU recovery
    is part of it): the journaled sequence with its checkpoint, recovery
    at the tip (timed whole and by piece, then once more under the
    launch window and torch.profiler), at every step boundary past the
    watermark and at three torn cuts, each on a truncated copy of the
    log, and the CPU recovery; the hand-retried chaos run; one seeded
    corruption on the card and the CPU; the journal's cost per facade
    wave. Returns the records `main` checks and prints."""
    import pathlib

    import torch

    from hypervisor_tpu_torch import kernels, u32
    from hypervisor_tpu_torch.ops import merkle
    from hypervisor_tpu_torch.ops.sha256 import digests_to_hex
    from hypervisor_tpu_torch.resilience import WriteAheadLog, scan
    from hypervisor_tpu_torch.resilience.recovery import (
        checkpoint_with_watermark, recover, replay, verify_audit_heads)
    from hypervisor_tpu_torch.runtime.checkpoint import restore_state, wait_durable
    from hypervisor_tpu_torch.testing import InjectedCorruption, WaveChaosInjector, WaveChaosPlan

    on_card = torch.device(device).type == "cuda"
    workdir = pathlib.Path(workdir)
    wal_path, ckdir = workdir / "wal.log", workdir / "ckpt"
    rec: dict = {"tmp": f"{workdir} on {mount_of(workdir)}"}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def ms_since(t0) -> float:
        sync()
        return (time.perf_counter_ns() - t0) / 1e6

    # ── the journaled run ────────────────────────────────────────────
    state = facade_state(device)
    state.journal = WriteAheadLog(wal_path, fsync=True)
    config = state.config
    marks: list = []  # (label, WAL bytes, committed seq, fingerprint)
    step_ms: dict = {}
    clock = [time.perf_counter_ns()]

    def mark(label):
        step_ms[label] = ms_since(clock[0])
        marks.append((label, wal_path.stat().st_size, state.journal.last_seq,
                      durable_fingerprint(state)))
        clock[0] = time.perf_counter_ns()

    def checkpoint():
        t0 = time.perf_counter_ns()
        target = checkpoint_with_watermark(state, ckdir, step=1, background=True)
        rec["save_sync_ms"] = (time.perf_counter_ns() - t0) / 1e6
        require(wait_durable(target, timeout=120.0), "durability: the background save never "
                                                     "became durable")
        rec["save_durable_ms"] = (time.perf_counter_ns() - t0) / 1e6
        rec["tables_npz_mb"] = (target / "tables.npz").stat().st_size / 1e6
        rec["host_json_mb"] = (target / "host.json").stat().st_size / 1e6
        mark("checkpoint")

    t0 = time.perf_counter_ns()
    seq_out = durability_sequence(state, lambda fn, *a, **kw: fn(*a, **kw), mark, checkpoint)
    rec["sequence_s"] = ms_since(t0) / 1e3
    rec["step_ms"] = step_ms
    raw = wal_path.read_bytes()
    lines = raw.splitlines(keepends=True)
    ops = [json.loads(line[9:])["op"] for line in lines if b'"k":"I"' in line]
    rec["wal"] = {"bytes": len(raw), "records": len(ops), "fsync": True,
                  "by_op": {op: ops.count(op) for op in sorted(set(ops))},
                  "wave_bytes": [len(a) + len(b) for a, b in zip(lines, lines[1:])
                                 if b'"op":"governance_wave"' in a]}
    live = durable_fingerprint(state)
    watermark_i = next(i for i, m in enumerate(marks) if m[0] == "checkpoint")

    # ── recovery at the tip: once whole, once by piece, once counted ─
    t0 = time.perf_counter_ns()
    back, report = recover(ckdir, wal_path, config=config, device=device)
    rec["recover_tip_ms"] = ms_since(t0)
    rec["recover_report"] = report
    require(durable_fingerprint(back) == live, "durability: recovery at the tip differs from "
                                                 f"the live run at {first_difference('tip', durable_fingerprint(back), live)}")
    del back
    pieces: dict = {}
    t0 = time.perf_counter_ns()
    back = restore_state(ckdir / "step_1", config, device=device)
    pieces["restore_ms"] = ms_since(t0)
    t0 = time.perf_counter_ns()
    rec["audit_sessions_verified"] = verify_audit_heads(back)
    pieces["verify_audit_heads_ms"] = ms_since(t0)
    t0 = time.perf_counter_ns()
    committed = scan(wal_path, after_seq=back._restored_wal_seq).committed
    pieces["scan_ms"] = ms_since(t0)
    by_op: dict = {}
    run: list = []
    for r in list(committed) + [None]:
        if run and (r is None or r.op != run[0].op):
            t0 = time.perf_counter_ns()
            replay(back, run)
            ms = ms_since(t0)
            n, total = by_op.get(run[0].op, (0, 0.0))
            by_op[run[0].op] = (n + len(run), total + ms)
            run = []
        if r is not None:
            run.append(r)
    pieces["replay_ms_by_op"] = {op: {"records": n, "ms": ms} for op, (n, ms) in by_op.items()}
    pieces["replay_ms"] = sum(ms for _, ms in by_op.values())
    rec["recover_pieces"] = pieces
    require(durable_fingerprint(back) == live, "durability: the piecewise replay differs")
    del back

    # The counted window: the tip recovery, then verify_session_chain on
    # a sample of the recovered sessions and a big tree over the
    # recovered DeltaLog.
    def recovery_window():
        got, _ = recover(ckdir, wal_path, config=config, device=device)
        sample = ([int(s) for w in seq_out["waves"] for s in w[:DUR_VERIFY_SAMPLE]]
                  + seq_out["delta_sessions"][:DUR_VERIFY_SAMPLE])
        verified = [got.verify_session_chain(s) for s in sample]
        leaves = u32.to_numpy_u32(got.delta_log.digest[:BIG_TREE_LEAVES])
        root = merkle.tree_roots_host(leaves[None], np.array([BIG_TREE_LEAVES], np.int32),
                                      device)
        return got, verified, leaves, root

    kernels.reset_launch_counts()
    census: dict = {}  # device op name -> launches
    if on_card:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter_ns()
            got, verified, leaves, root = recovery_window()
            rec["census_wall_ms"] = ms_since(t0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                census[e.key[:100]] = census.get(e.key[:100], 0) + e.count
    else:
        got, verified, leaves, root = recovery_window()
    rec["window"] = kernels.launch_counts()
    rec["census"] = census
    require(all(verified), f"durability: verify_session_chain failed after recovery: {verified}")
    require(digests_to_hex(root)[0] == merkle.merkle_root_host(digests_to_hex(leaves)),
            "durability: the recovered DeltaLog's big tree != hashlib")
    require(durable_fingerprint(got) == live, "durability: the counted recovery differs")
    require(got._delta_cursor == int(got.delta_log.cursor) == state._delta_cursor,
            "durability: the recovered cursor mirror disagrees with the device")
    rec["verified_sessions"] = len(verified)

    # ── every step boundary past the watermark, and three torn cuts ──
    starts = np.cumsum([0] + [len(x) for x in lines]).tolist()
    intent = next(i for i, line in enumerate(lines)
                  if b'"op":"governance_wave"' in line and starts[i] >= marks[watermark_i][1])
    flush = next(i for i, line in enumerate(lines) if b'"op":"flush_joins"' in line)

    def end_of(i):
        return starts[i + 1]

    def mark_of(label):
        return next(m for m in marks if m[0] == label)

    cuts = [(m[0], m[1], m) for m in marks[watermark_i:]]
    cuts += [("torn inside the wave's intent line", end_of(intent) - len(lines[intent]) // 2,
              mark_of("wave 1 staged")),
             ("torn inside the flush's commit line", end_of(flush + 1) - 4, mark_of("enqueued")),
             ("torn 3 bytes before the end", len(raw) - 3, marks[-2])]
    rec["cuts"] = []
    for label, nbytes, (mlabel, _, mseq, fp) in cuts:
        cut = workdir / "cut.log"
        cut.write_bytes(raw[:nbytes])
        t0 = time.perf_counter_ns()
        got, report = recover(ckdir, cut, config=config, device=device)
        ms = ms_since(t0)
        diff = first_difference(label, durable_fingerprint(got), fp)
        require(diff is None, f"durability: recovery at {label} ({nbytes} bytes) differs from "
                              f"the live run at '{mlabel}': {diff}")
        rec["cuts"].append({"cut": label, "bytes": nbytes, "equals": mlabel, "seq": mseq,
                            "replayed": report["wal_records_replayed"],
                            "torn_bytes": report["wal_torn_tail_bytes"],
                            "open_intents": report["wal_open_intents_skipped"], "ms": ms})
        del got
    cut.unlink()

    # ── the same checkpoint and log on the CPU ───────────────────────
    t0 = time.perf_counter_ns()
    on_cpu, _ = recover(ckdir, wal_path, config=config, device="cpu")
    rec["cpu_recover_s"] = (time.perf_counter_ns() - t0) / 1e9
    diff = first_difference("cpu", durable_fingerprint(on_cpu), live)
    require(diff is None, f"durability: the CPU recovery differs from the card at {diff}")

    # ── one seeded corruption on the card and on the CPU ─────────────
    plan = WaveChaosPlan(seed=5, corruptions=tuple(
        InjectedCorruption(kind, at_dispatch=1, table=table)
        for kind, table in (("bit_flip", "agents"), ("bit_flip", "delta_log"),
                            ("row_rewrite", "sessions"), ("row_rewrite", "vouches"),
                            ("chain_tamper", "agents"))))
    applied = []
    for st in (state, on_cpu):
        st.journal = None
        st.fault_injector = WaveChaosInjector(plan)
        st.saga_round({})
        applied.append(st.fault_injector.report()["corruptions_applied"])
    require(applied[0] == applied[1] and len(applied[0]) == 5,
            f"durability: the corruptions landed apart: {applied}")
    diff = first_difference("corrupted", durable_fingerprint(on_cpu), durable_fingerprint(state))
    require(diff is None, f"durability: a corruption on the card differs from the CPU at {diff}")
    rec["corruptions"] = applied[0]
    del on_cpu

    # ── the chaos run ────────────────────────────────────────────────
    retries: list = []
    chaotic = facade_state(device)
    chaotic.fault_injector = WaveChaosInjector(WaveChaosPlan(**DUR_CHAOS))
    t0 = time.perf_counter_ns()
    durability_sequence(chaotic, retry_by_hand(retries), lambda label: None, lambda: None)
    rec["chaos_s"] = ms_since(t0) / 1e3
    diff = first_difference("chaos", durable_fingerprint(chaotic), live)
    require(diff is None, f"durability: the hand-retried chaos run differs from the clean run "
                          f"at {diff}")
    require(retries, "durability: the chaos plan injected nothing")
    rec["chaos"] = {"retries": len(retries), "by_call": {c: retries.count(c)
                                                        for c in sorted(set(retries))},
                    "report": {k: v for k, v in chaotic.fault_injector.report().items()
                               if k in ("dispatches", "faults", "by_stage")}}
    del chaotic, state

    # ── the journal's cost per facade wave ───────────────────────────
    times = {"journaled": [], "unjournaled": []}
    wave_bytes = []
    for i in range(DUR_TIMING_ITERS):
        for journaled in ((False, True) if i % 2 == 0 else (True, False)):
            st = facade_state(device)
            path = workdir / f"timing{i}{int(journaled)}.log"
            if journaled:
                st.journal = WriteAheadLog(path, fsync=True)
            slots, dids, sigma, bodies, actions = prepare_facade_wave(
                st, np.random.RandomState(SEED + 40 + i), 0)
            size0 = path.stat().st_size if journaled else 0
            sync()
            t0 = time.perf_counter_ns()
            st.run_governance_wave(slots, dids, slots, sigma, bodies, now=0.0, actions=actions)
            times["journaled" if journaled else "unjournaled"].append(ms_since(t0))
            if journaled:
                wave_bytes.append(path.stat().st_size - size0)
                st.journal.close()
                path.unlink()
            del st
    rec["wave_ms"] = {k: {"p50": float(np.percentile(v, 50)), "p95": float(np.percentile(v, 95)),
                          "samples": v} for k, v in times.items()}
    rec["wal_bytes_per_wave"] = wave_bytes
    return rec


# ── phase observability: the metrics drain, health, hindsight, the
# integrity plane and the supervisor ──────────────────────────────────

#: The sequence's three facade waves (32,768 session rows hold three waves
#: of 10,000, and rows are never reused), the standing sessions that take
#: staged deltas and sagas, the actors' vouch edges the slash clips.
OBS_WAVES = 3
OBS_DELTA_SESSIONS, OBS_DELTAS = 256, 4
OBS_SAGAS = 256
OBS_VOUCHERS = 64
OBS_TRACED = 3
#: The plane's cadence: the sanitizer every 2nd dispatch (it folds into
#: the 2nd and 4th dispatch, both facade waves), a scrub strip every
#: dispatch; periodic checkpoints every 2nd clean supervised dispatch.
OBS_EVERY, OBS_SCRUB_EVERY, OBS_CHECKPOINT_EVERY = 2, 1, 2
#: One injected fault at the slash, which the ladder retries: seed 1's
#: first draw (0.134) faults and its second (0.847) does not.
OBS_SLASH_CHAOS = dict(seed=1, fail_rate=0.5, stages=("slash_cascade",))
#: The seeded corruptions: an agent σ exponent flip (the repair rung) and
#: a session row rewrite, whose FSM code is restore-class.
OBS_SIGMA = dict(kind="bit_flip", table="agents")
OBS_FSM = dict(kind="row_rewrite", table="sessions")
OBS_REPS, OBS_RUNG_REPS = 20, 3
#: The plane's cost on the facade wave: its variants ((sanitizer every,
#: scrub every) on each dispatch, None for no plane attached), timed over
#: sixteen fresh states of three waves each (twelve samples a variant).
OBS_WAVE_VARIANTS = {"bare": None, "sanitizer": (1, 0), "scrub": (0, 1), "plane": (1, 1)}
OBS_WAVE_STATES = 16
OBS_STAGE_NAMES = ("hv_stage_latency_us_bucket", "hv_stage_latency_us_sum")
OBS_COMPILE_NAMES = ("hv_compiles_total", "hv_recompiles_total", "hv_donation_failures_total",
                     "hv_compile_wall_ms_total")


def obs_masked(snap) -> dict:
    """A drain's arrays with the host plane's wall-clock stage histograms
    cut to their observation counts and the compile counters set apart
    (the compile watch is process-global: the CPU rerun meets no novel
    signature)."""
    from hypervisor_tpu_torch.observability import metrics as mp

    stage_rows = sorted(h.index for h in mp.STAGE_LATENCY.values())
    compile_rows = [mp.COMPILES.index, mp.RECOMPILES.index, mp.DONATION_FAILURES.index,
                    mp.COMPILE_WALL_MS.index]
    counters, hist, hist_sum = snap.counters.copy(), snap.hist.copy(), snap.hist_sum.copy()
    counters[compile_rows] = 0
    stage_counts = hist[stage_rows].sum(axis=1)
    hist[stage_rows] = 0
    hist_sum[stage_rows] = 0.0
    return {"counters": counters, "gauges": snap.gauges.copy(), "hist": hist,
            "hist_sum": hist_sum, "stage_counts": stage_counts}


def obs_prom(text: str) -> list:
    """Exposition lines, the stage buckets and sums cut to their names and
    labels, the compile counters to their names."""
    out = []
    for line in text.splitlines():
        if line.startswith(OBS_STAGE_NAMES):
            line = line.rsplit(" ", 1)[0]
        elif line.startswith(OBS_COMPILE_NAMES):
            line = line.split(" ", 1)[0].split("{", 1)[0]
        out.append(line)
    return out


def span_tree(span) -> tuple:
    """A reconstructed span tree without its wall times."""
    return (span.name, span.stage, span.trace_id, span.span_word, span.parent_span_word,
            span.wave_seq, [dict(e) for e in span.events], [span_tree(c) for c in span.children])


def obs_health(h: dict) -> dict:
    """`health_summary` without wall times and compile counts."""
    h = dict(h)
    for key in ("uptime_s", "compiles", "backend"):
        h.pop(key)
    h["stages"] = {k: v["n"] for k, v in h["stages"].items()}
    h["watchdog"] = {k: v for k, v in h["watchdog"].items() if k != "deadlines_us"}
    # A bundle's size counts the wall times in its trace block.
    h["incidents"] = {**h["incidents"], "last": [{k: v for k, v in row.items() if k != "bytes"}
                                                 for row in h["incidents"]["last"]]}
    return h


def obs_flight(f: dict) -> dict:
    f = dict(f)
    f["recent_waves"] = [{k: v for k, v in w.items() if k != "duration_us"}
                         for w in f["recent_waves"]]
    return f


def obs_corrupt(state, seed: int, corruption: dict) -> list:
    """Apply one seeded corruption to the state now (no dispatch, so no
    journal record): the injector's first gate, as the reference's tests
    apply it."""
    from hypervisor_tpu_torch.testing import InjectedCorruption, WaveChaosInjector, WaveChaosPlan

    inj = WaveChaosInjector(WaveChaosPlan(seed=seed, corruptions=(
        InjectedCorruption(at_dispatch=1, **corruption),)))
    inj.dispatches = 1
    return inj.apply_due_corruptions(state)


@contextlib.contextmanager
def timed_recovery_stages(sync):
    """Time `recover`'s stages where it calls them, each ended by `sync`:
    find the newest durable checkpoint, restore it, verify the audit
    heads, scan the WAL past the watermark, replay, and reopen the journal
    (`WriteAheadLog` scans the whole file for its tail and next seq);
    yields {stage: ms}, filled as they run."""
    from hypervisor_tpu_torch.resilience import recovery

    stages: dict = {}
    saved = {name: getattr(recovery, name)
             for name in ("latest_durable_checkpoint", "restore_state", "verify_audit_heads",
                          "scan", "replay", "WriteAheadLog")}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            result = fn(*args, **kwargs)
            sync()
            stages[name] = stages.get(name, 0.0) + (time.perf_counter_ns() - t0) / 1e6
            return result
        return call

    for name, fn in saved.items():
        setattr(recovery, name, timed(name, fn))
    try:
        yield stages
    finally:
        for name, fn in saved.items():
            setattr(recovery, name, fn)


def observability_sequence(device, workdir, profile_census: bool) -> dict:
    """The observability phase's sequence on `device`: a facade state at
    the facade cell's tables behind `Hypervisor` (its event bus bridged),
    journaled (fsync on) into `workdir/run`, with an `IntegrityPlane`
    (sanitizer every 2nd dispatch, scrub every dispatch) and a
    `Supervisor` (periodic checkpoints) over it; three facade waves (the
    2nd and 3rd fused-sanitized), 1,024 staged deltas and their flush, 256
    five-step sagas and one round, 64 vouches and one slash (one injected
    fault the ladder retries), every dispatch through `Supervisor.dispatch`
    and a drain after each; then the readers, a σ corruption the repair
    rung clears and an FSM-code corruption the restore rung clears
    through `recover` on `device`, and the restore's checks (chain checks
    and a big tree over the recovered DeltaLog). `profile_census` runs the
    dispatches under torch.profiler (device activity). Returns the
    deterministic record (equal on the card and the CPU; it holds the
    mode each dispatch ran in and the drain at which degraded mode began),
    and, apart, the launch window, the census, the rungs' times and the
    restore's stages."""
    import pathlib

    import torch

    from hypervisor_tpu_torch import Hypervisor, HypervisorEventBus, kernels, u32
    from hypervisor_tpu_torch.integrity import IntegrityPlane
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.observability import metrics as mp
    from hypervisor_tpu_torch.ops import merkle
    from hypervisor_tpu_torch.ops.sha256 import digests_to_hex
    from hypervisor_tpu_torch.resilience import Supervisor, WriteAheadLog
    from hypervisor_tpu_torch.testing import (
        WaveChaosInjector, WaveChaosPlan, same_health_on_every_run, supervisor_accounting)

    on_card = torch.device(device).type == "cuda"
    run_dir = pathlib.Path(workdir) / "run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    det: dict = {"drains": [], "mode_at_drain": [], "dispatch_modes": [], "degraded_from": None}
    out: dict = {"det": det}
    step = [0]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    hv = Hypervisor(state=facade_state(device), event_bus=HypervisorEventBus())
    same_health_on_every_run(hv)
    state = hv.state
    state.hindsight_clock = lambda: float(step[0])
    state.journal = WriteAheadLog(run_dir / "wal.log", fsync=True)
    sup = Supervisor(state, checkpoint_dir=str(run_dir / "ckpt"),
                     checkpoint_every=OBS_CHECKPOINT_EVERY, sleep=lambda s: None)
    plane = IntegrityPlane(state, every=OBS_EVERY, scrub_every=OBS_SCRUB_EVERY,
                           scrub_budget=SCRUB_BUDGET)
    sup.checkpoint()  # the watermark's base: the actors, before any record
    rng = np.random.RandomState(SEED + 50)

    def mode() -> str:
        return "normal" if sup.state.degraded_policy is None else "degraded"

    def drain(label):
        step[0] += 1
        det["drains"].append((label, obs_masked(sup.state.metrics_snapshot())))
        det["mode_at_drain"].append((label, mode()))
        if det["degraded_from"] is None and mode() == "degraded":
            det["degraded_from"] = label

    def dispatch(stage, fn, *args, **kwargs):
        """`Supervisor.dispatch`, with the mode it ran in (degraded mode
        sheds joins and pauses the saga fan-out) and the mode after."""
        before = mode()
        out = sup.dispatch(stage, fn, *args, **kwargs)
        det["dispatch_modes"].append((stage, before, mode()))
        return out

    kernels.reset_launch_counts()
    census: dict = {}
    prof = None
    if on_card and profile_census:
        from torch.profiler import ProfilerActivity, profile

        sync()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter_ns()
    sessions = None
    sagas: list = []
    for w in range(OBS_WAVES):
        slots, dids, sigma, bodies, actions = prepare_facade_wave(state, rng, w)
        res, _ = dispatch("governance_wave", state.run_governance_wave, slots, dids, slots,
                          sigma, bodies, now=float(w), actions=actions)
        check_bench_gates(res, bodies, f"observability wave {w}")
        drain(f"wave {w}")
        if w == 1:
            sessions = state.create_sessions_batch(
                [f"obs:s{i}" for i in range(OBS_DELTA_SESSIONS)], SessionConfig(min_sigma_eff=0.0))
            for j in range(OBS_DELTAS):
                for s in sessions:
                    state.stage_delta(int(s), int(state.actor_rows[j]), ts=4.0 + j / 8,
                                      change_words=rng.randint(0, 2**31, 8))
            dispatch("delta_chain", state.flush_deltas)
            drain("deltas flushed")
            sagas = [state.create_saga(f"obs:saga:{g}", int(sessions[g % len(sessions)]),
                                       [{"retries": 1, "has_undo": True}] * SAGA_STEPS)
                     for g in range(OBS_SAGAS)]
            ok = rng.uniform(size=OBS_SAGAS) > 0.2
            dispatch("saga_round", state.saga_round, {g: bool(o) for g, o in zip(sagas, ok)})
            drain("saga round")
    actors = state.actor_rows
    actors_session = int(state.agents.session[int(actors[0])])
    for k in range(OBS_VOUCHERS):
        state.add_vouch(int(actors[2 + k]), int(actors[1]), actors_session, 0.125, bond_pct=0.25)
    state.fault_injector = WaveChaosInjector(WaveChaosPlan(**OBS_SLASH_CHAOS))
    slash = dispatch("slash_cascade", state.apply_slash, actors_session, int(actors[1]),
                     0.95, now=5.0)
    require(len(slash["clipped"]) == OBS_VOUCHERS, f"observability: the slash clipped "
                                                   f"{len(slash['clipped'])} vouchers")
    det["slash"] = slash
    det["slash_chaos"] = {k: v for k, v in state.fault_injector.report().items()
                          if k in ("dispatches", "faults", "by_stage")}
    state.fault_injector = None
    drain("slash")
    sync()
    out["dispatch_ms"] = (time.perf_counter_ns() - t0) / 1e6
    if prof is not None:
        from torch.autograd import DeviceType

        prof.__exit__(None, None, None)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                census[e.key[:100]] = census.get(e.key[:100], 0) + e.count
    out["census"] = census

    # ── the readers ──────────────────────────────────────────────────
    det["prometheus"] = obs_prom(state.metrics_prometheus())
    det["health"] = obs_health(state.health_summary())
    det["memory"] = state.memory_summary()
    det["flight"] = obs_flight(state.flight_summary())
    traced = [int(s) for s in sessions[:OBS_TRACED]]
    det["session_trace"] = {s: [span_tree(sp) for sp in state.session_trace(s)] for s in traced}
    det["history"] = state.history_query()
    det["history_points"] = {s: state.history_query(series=s)["points"]
                             for s in state.history.series
                             if s not in ("hv_compiles_total", "hv_recompiles_total")}
    det["history"].pop("digest")  # it covers the compile series too
    before = durable_fingerprint(state)
    det["fingerprint"] = before

    # ── the repair rung: a σ out of range ────────────────────────────
    det["sigma_corruption"] = obs_corrupt(state, 21, OBS_SIGMA)
    sync()
    t0 = time.perf_counter_ns()
    det["repair_report"] = plane.sanitize()
    sync()
    out["repair_ms"] = (time.perf_counter_ns() - t0) / 1e6
    require(det["repair_report"]["repaired_rows"] >= 1 and not det["repair_report"]["restored"],
            f"observability: the σ corruption was not repaired: {det['repair_report']}")
    drain("repaired")
    require(det["drains"][-1][1]["gauges"][mp.INTEGRITY_VIOLATION_ROWS.index] == 0,
            "observability: the repair's recheck still sees violating rows")
    det["integrity_after_repair"] = state.integrity_summary()

    # ── the restore rung: an FSM code ────────────────────────────────
    det["fsm_corruption"] = obs_corrupt(state, 13, OBS_FSM)
    sync()
    t0 = time.perf_counter_ns()
    with timed_recovery_stages(sync) as stages:
        det["restore_report"] = plane.sanitize()
    sync()
    out["restore_ms"] = (time.perf_counter_ns() - t0) / 1e6
    out["recover_stages_ms"] = stages
    require(det["restore_report"]["restored"], f"observability: the FSM corruption did not "
                                               f"restore: {det['restore_report']}")
    restored = sup.state
    require(restored is not state and restored.device == state.device,
            "observability: the restore must rebuild the state on its own device")
    out["recover_wall_ms"] = sup.last_restore["wall_ms"]
    diff = first_difference("restored", durable_fingerprint(restored), before)
    require(diff is None, f"observability: the restored state differs from the uninterrupted "
                          f"history at {diff}")
    sample = ([int(s) for s in sessions[:DUR_VERIFY_SAMPLE]]
              + [int(s) for s in restored._audit_rows if s < N_SESSIONS][:DUR_VERIFY_SAMPLE])
    verified = [restored.verify_session_chain(s) for s in sample]
    require(all(verified), f"observability: chain checks failed after the restore: {verified}")
    leaves = u32.to_numpy_u32(restored.delta_log.digest[:BIG_TREE_LEAVES])
    root = merkle.tree_roots_host(leaves[None], np.array([BIG_TREE_LEAVES], np.int32), device)
    require(digests_to_hex(root)[0] == merkle.merkle_root_host(digests_to_hex(leaves)),
            "observability: the restored DeltaLog's big tree != hashlib")
    drain("restored")
    out["window"] = kernels.launch_counts()
    det["integrity_after_restore"] = restored.integrity_summary()
    det["supervisor"] = supervisor_accounting(sup)
    det["incidents"] = {tag: st.incidents_summary() for tag, st in (("live", state),
                                                                     ("restored", restored))}
    for summary in det["incidents"].values():
        for row in summary["last"]:
            row.pop("bytes")  # bundle sizes count wall times in their trace blocks
    det["incident_rules"] = [
        {k: st.incident_bundle(row["id"])[k] for k in ("id", "class", "kind", "seq", "rule")}
        for st, summary in ((state, det["incidents"]["live"]),
                            (restored, det["incidents"]["restored"])) for row in summary["last"]]
    det["bus"] = [e.event_type.value for e in hv.event_bus.all_events]
    det["conservation"] = [st.history.verify_conservation()["ok"] for st in (state, restored)]
    require(all(det["conservation"]), "observability: a history plane broke conservation")
    det["chain_checks"] = verified
    return out


def obs_timings(device, workdir) -> dict:
    """The observability planes' costs on the card (no limit set for any):
    the drain, fresh and refreshing, each profiled once for its device
    waits and ops; `to_prometheus`; `health_summary`; the compile watch's
    key, the watchdog and the plane's cadence hook per dispatch; a scrub
    tick; the repair rung; the facade wave under each of
    `OBS_WAVE_VARIANTS`, rotated over fresh states."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hypervisor_tpu_torch import state as state_mod
    from hypervisor_tpu_torch.integrity import IntegrityPlane

    rec: dict = {}

    def timed(fn, reps=OBS_REPS, reset=None) -> list:
        samples = []
        for _ in range(reps):
            if reset is not None:
                reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter_ns() - t0) / 1e6)
        return samples

    def pcts(samples) -> dict:
        return {"p50": float(np.percentile(samples, 50)), "p95": float(np.percentile(samples, 95)),
                "n": len(samples)}

    st = facade_state(device)
    plane = IntegrityPlane(st, every=0, scrub_every=0, scrub_budget=SCRUB_BUDGET)
    rng = np.random.RandomState(SEED + 60)
    slots, dids, sigma, bodies, actions = prepare_facade_wave(st, rng, 0)
    captured: dict = {}
    real_fn = state_mod._WAVE._fn

    def capture(*a, **k):
        captured.update(args=a, kwargs=k)
        return real_fn(*a, **k)

    state_mod._WAVE._fn = capture
    try:
        st.run_governance_wave(slots, dids, slots, sigma, bodies, now=0.0, actions=actions)
    finally:
        state_mod._WAVE._fn = real_fn
    require(st._gauges_fresh, "observability: the facade wave must leave its gauges fresh")

    def stale():
        st._gauges_fresh = False

    table = st.metrics.table
    rec["drain_bytes"] = sum(t.numel() * t.element_size()
                             for t in (table.counters, table.gauges, table.hist, table.hist_sum))
    rec["drain_fresh_ms"] = pcts(timed(st.metrics_snapshot))
    rec["drain_refreshing_ms"] = pcts(timed(st.metrics_snapshot, reset=stale))
    def profiled(fn, reps: int) -> tuple[dict, dict]:
        """(waits on the device, device ops) the profiler records over
        `reps` calls of fn (one short call alone can lose its device
        records)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
        waits, device_ops = {}, {}
        for e in p.key_averages():
            if e.device_type == DeviceType.CUDA:
                device_ops[e.key[:80]] = device_ops.get(e.key[:80], 0) + e.count
            elif "Synchronize" in e.key or e.key in ("cudaMemcpy", "cudaStreamWaitEvent"):
                waits[e.key] = waits.get(e.key, 0) + e.count
        return waits, device_ops

    # The profiler's own waits (its stop synchronises the device), from an
    # empty window, come off the drains' count.
    base_waits, _ = profiled(lambda: None, 1)
    rec["drain_profile"] = {"profiler_own_waits": base_waits, "drains": OBS_REPS}
    for tag, reset in (("fresh", lambda: setattr(st, "_gauges_fresh", True)), ("refreshing", stale)):
        def drain():
            reset()
            st.metrics_snapshot()

        waits, device_ops = profiled(drain, OBS_REPS)
        own = {k: n - base_waits.get(k, 0) for k, n in waits.items() if n - base_waits.get(k, 0)}
        rec["drain_profile"][tag] = {"waits": own, "device_ops": device_ops}
        require(sum(own.values()) == OBS_REPS,
                f"observability: each {tag} drain must wait on the device once: {waits} over "
                f"{OBS_REPS} drains (the profiler's own: {base_waits})")
    fresh = rec["drain_profile"]["fresh"]
    require(fresh["device_ops"] and all("Memcpy DtoH" in k for k in fresh["device_ops"]),
            f"observability: a fresh drain runs device ops besides its copies: "
            f"{fresh['device_ops']}")
    snap = st.metrics_snapshot()
    rec["to_prometheus_ms"] = pcts(timed(snap.to_prometheus))
    rec["exposition_bytes"] = len(snap.to_prometheus())
    rec["health_summary_ms"] = pcts(timed(st.health_summary))

    # The compile watch keys every dispatch's abstract signature (the
    # port has no jit cache); the watchdog reads its stage's histogram.
    watch = state_mod._WAVE
    t0 = time.perf_counter_ns()
    for _ in range(200):
        watch._sig_key(captured["args"], captured["kwargs"])
    rec["compile_watch_key_us"] = (time.perf_counter_ns() - t0) / 200 / 1e3
    record = st.tracer.last_closed
    t0 = time.perf_counter_ns()
    for _ in range(2000):
        st.health.observe_wave(record)
    rec["watchdog_us"] = (time.perf_counter_ns() - t0) / 2000 / 1e3

    rec["scrub_tick_ms"] = pcts(timed(plane.scrub_tick))
    # The sanitizer's pass on its own (the plane's non-fused cadence:
    # the same checks the fused wave folds in, queued with no read-back).
    rec["sanitizer_pass_ms"] = pcts(timed(plane._run_check))
    rec["scrub_budget"] = SCRUB_BUDGET
    repairs = []
    for i in range(OBS_RUNG_REPS):
        obs_corrupt(st, 100 + i, OBS_SIGMA)
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        report = plane.sanitize()
        torch.cuda.synchronize()
        repairs.append((time.perf_counter_ns() - t0) / 1e6)
        require(report["repaired_rows"] >= 1, f"observability: repair rung {i}: {report}")
    rec["repair_rung_ms"] = {"samples": repairs, **pcts(repairs)}

    # The plane's cadence hook alone, when nothing is due.
    t0 = time.perf_counter_ns()
    for _ in range(2000):
        plane.on_dispatch("governance_wave", fused=True)
    rec["cadence_hook_us"] = (time.perf_counter_ns() - t0) / 2000 / 1e3
    del st, plane

    # The facade wave under each of the plane's variants, split: none
    # attached, the fused sanitizer alone, a scrub tick alone, both. A
    # fresh state holds three waves; wave w of state i takes variant
    # (i + w) mod 4, so each variant meets each wave position equally.
    # Each sample starts after a full garbage collection.
    times: dict = {k: [] for k in OBS_WAVE_VARIANTS}
    positions: dict = {k: [] for k in OBS_WAVE_VARIANTS}
    names = list(OBS_WAVE_VARIANTS)
    build_ms = []
    for i in range(OBS_WAVE_STATES):
        t0 = time.perf_counter_ns()
        st = facade_state(device)
        plane = IntegrityPlane(st, every=0, scrub_every=0, scrub_budget=SCRUB_BUDGET)
        build_ms.append((time.perf_counter_ns() - t0) / 1e6)
        wave_rng = np.random.RandomState(SEED + 70 + i)
        for w in range(OBS_WAVES):
            name = names[(i + w) % len(names)]
            cadence = OBS_WAVE_VARIANTS[name]
            st.integrity = None if cadence is None else plane
            if cadence is not None:
                plane.every, plane.scrub_every = cadence
            args = prepare_facade_wave(st, wave_rng, w)
            gc.collect()  # the states before leave their garbage out of the sample
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            st.run_governance_wave(args[0], args[1], args[0], args[2], args[3], now=float(w),
                                   actions=args[4])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter_ns() - t0) / 1e6)
            positions[name].append(w)
        fused = sum((OBS_WAVE_VARIANTS[names[(i + w) % len(names)]] or (0, 0))[0]
                    for w in range(OBS_WAVES))
        require(plane.checks == fused, f"observability: state {i}'s sanitizer ran "
                                       f"{plane.checks} times, not {fused}")
        del st, plane
    rec["state_build_ms"] = pcts(build_ms)
    rec["wave_ms"] = {k: {"samples": v, "positions": positions[k], **pcts(v)}
                      for k, v in times.items()}
    rec["wave_p50_over_bare_ms"] = {k: rec["wave_ms"][k]["p50"] - rec["wave_ms"]["bare"]["p50"]
                                    for k in names if k != "bare"}
    return rec


def run_observability(device, workdir) -> dict:
    """The observability phase: the sequence on `device` under the launch
    window (its dispatches under torch.profiler), the same sequence on the
    CPU, which must give the same deterministic record, and the costs on
    the card. Returns the records `main` checks and prints."""
    # The roofline observatory models each device's own work (ROADMAP
    # C.2), so its gauges part between the card and the CPU: off for the
    # compared runs, as in every parity run.
    saved = os.environ.get("HV_ROOFLINE")
    os.environ["HV_ROOFLINE"] = "0"
    try:
        return observability_records(device, workdir)
    finally:
        if saved is None:
            os.environ.pop("HV_ROOFLINE", None)
        else:
            os.environ["HV_ROOFLINE"] = saved


def observability_records(device, workdir) -> dict:
    """`run_observability`'s runs, with the roofline observatory off."""
    clock = [1_767_225_600.0]
    with manual_ids_and_time(clock):
        card = observability_sequence(device, workdir, profile_census=True)
    rec = dict(card)
    t0 = time.perf_counter()
    clock[0] = 1_767_225_600.0
    with manual_ids_and_time(clock):
        cpu = observability_sequence("cpu", workdir, profile_census=False)
    rec["cpu_s"] = time.perf_counter() - t0
    diff = first_difference("observability", cpu["det"], card["det"])
    require(diff is None, f"observability: the CPU run differs from the card at {diff}")
    del cpu, card
    rec["timing"] = obs_timings(device, workdir)
    return rec


SAGA_COLS = ("step_state", "retries_left", "has_undo", "saga_state", "n_steps", "cursor")
SAGA_OUTS = ("step_state", "retries_left", "saga_state", "cursor", "committed", "exhausted")


def lock_plain(lock):
    """An IntentLock (or None) as plain data."""
    if lock is None:
        return None
    return [lock.lock_id, lock.agent_did, lock.session_id, lock.resource_path, lock.intent.value,
            lock.acquired_at.isoformat(), lock.is_active, lock.saga_step_id]


def lock_manager_plain(manager) -> dict:
    return {"locks": {k: lock_plain(v) for k, v in manager._locks.items()},
            "by_resource": {k: list(v) for k, v in manager._by_resource.items()},
            "wait_for": {k: sorted(v) for k, v in manager._wait_for.items()}}


def lock_requests(rng, agents, n: int) -> list:
    """n seeded requests: (agent, session, path, intent code, step id)."""
    who = rng.randint(0, len(agents), n)
    paths = rng.randint(0, LOCK_PATHS, n)
    intents = rng.choice(3, n, p=LOCK_INTENT_MIX)
    return [(agents[a], f"lk:s{a % 64}", f"/r/{p}", int(i), None if a % 3 else f"step{a}")
            for a, p, i in zip(who, paths, intents)]


def run_lock_waves(device, clock):
    """The lock waves on `device` (`LOCK_*`): wave 1, the declared wait
    cycles, wave 2 with its DEADLOCK refusals, the deadlock report and the
    contention counts. Returns (records, wave, sigma)."""
    from hypervisor_tpu_torch.runtime.lock_wave import LockWave
    from hypervisor_tpu_torch.session.intent_locks import LockIntent

    intents = (LockIntent.READ, LockIntent.WRITE, LockIntent.EXCLUSIVE)
    rec = {}
    rng = np.random.RandomState(SEED + 31)
    agents = [f"did:l{i}" for i in range(LOCK_AGENTS)]
    sigma = rng.uniform(0.3, 0.99, LOCK_AGENTS).astype(np.float32)
    with manual_ids_and_time(clock):
        wave = LockWave(device=device, max_agents=LOCK_AGENTS, max_paths=LOCK_MAX_PATHS)
        for did, sg in zip(agents, sigma):
            wave.observe_sigma(did, float(sg))

        def flush(label, requests):
            for agent, session, path, intent, step in requests:
                wave.submit(agent, session, path, intents[intent], saga_step_id=step)
            report = wave.flush()
            rec[label] = {"status": report.status, "locks": [lock_plain(x) for x in report.locks],
                          "blockers": [sorted(b) for b in report.blockers],
                          "manager": lock_manager_plain(wave.manager)}
            return report

        report1 = flush("wave1", lock_requests(rng, agents, LOCK_WAVE1))
        held: dict[str, list[str]] = {}
        for lock in report1.locks:
            if lock is not None:
                held.setdefault(lock.agent_did, []).append(lock.resource_path)
        holders = sorted(held)
        cycles = []
        for _ in range(LOCK_CYCLES):
            members = [holders[i] for i in rng.choice(len(holders), rng.randint(2, 9),
                                                      replace=False)]
            for a, b in zip(members, members[1:] + members[:1]):
                wave.manager.declare_wait(a, {b})
            cycles.append(members)
        closing = []
        for k in range(LOCK_WAVE2 // 2):
            members = cycles[k % LOCK_CYCLES]
            a, b = members[0], members[1 + k % (len(members) - 1)]
            closing.append((a, f"lk:s{agents.index(a) % 64}", held[b][k % len(held[b])], 1, None))
        requests = closing + lock_requests(rng, agents, LOCK_WAVE2 - len(closing))
        order = rng.permutation(len(requests))
        flush("wave2", [requests[i] for i in order])
        report = wave.deadlock_report()
        rec["deadlock_report"] = {"on_cycle": report.on_cycle, "victim": report.victim}
        rec["contention"] = wave.contention_counts()
    return rec, wave, sigma


def scc_oracle(wave, sigma) -> dict:
    """The standing cycles by strongly connected components
    (scipy.sparse.csgraph), independent of the closure: a node is on a
    cycle iff its component has more than one node or it waits on
    itself; the victim is the first lowest-sigma member."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    rows = {did: wave._agents.lookup(did) for did in wave.manager._wait_for}
    src, dst = [], []
    for waiter, blockers in wave.manager._wait_for.items():
        for b in blockers:
            src.append(rows[waiter])
            dst.append(wave._agents.lookup(b))
    n = LOCK_AGENTS
    graph = csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    _, label = connected_components(graph, directed=True, connection="strong")
    size = np.bincount(label, minlength=n)
    on = (size[label] > 1)
    on[[s for s, d in zip(src, dst) if s == d]] = True
    members = [wave._agents.string(int(r)) for r in np.nonzero(on)[0] if r < len(wave._agents)]
    masked = np.where(on, sigma, np.inf)
    victim = wave._agents.string(int(np.argmin(masked))) if on.any() else None
    return {"on_cycle": members, "victim": victim}


def write_plan(rng, s: int) -> dict:
    """Session s's write wave: its isolation, quarantined members, lock
    grants and 64 writes (writer, path, ring, observe first)."""
    iso = "SNAPSHOT" if s % 16 == 3 else "SERIALIZABLE" if s % 16 == 7 else None
    weights = np.full(WRITE_MEMBERS, 1.0)
    weights[2] = 3.5  # the ring-3 writer: a third of the 64 writes
    weights /= weights.sum()
    writers = rng.choice(WRITE_MEMBERS, WRITE_WRITES, p=weights)
    return {
        "isolation": iso,
        "quarantined": [0, 5] if s % 16 == 0 else [],
        "writes": [(int(w), int(rng.randint(WRITE_PATHS)), 3 if w == 2 else 1 + int(w) % 2,
                    bool(rng.uniform() < 0.3)) for w in writers],
    }


def run_write_waves(device, clock, times=None):
    """The write waves through `Hypervisor(device=...)` (`WRITE_*`): each
    session's `ManagedSession.write_wave()` with its plan. Returns the
    records (statuses, counts, VFS contents, clock matrices, token
    columns, the state's tables); appends each flush's host ms (its
    device work synchronised) to `times`."""
    import asyncio

    import torch

    from hypervisor_tpu_torch import Hypervisor
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.session.intent_locks import IntentLockManager, LockIntent
    from hypervisor_tpu_torch.session.isolation import IsolationLevel

    rng = np.random.RandomState(SEED + 32)
    rec = {}

    async def drive():
        hv = Hypervisor(device=device)
        for s in range(WRITE_SESSIONS):
            plan = write_plan(rng, s)
            ms = await hv.create_session(SessionConfig(max_participants=WRITE_MEMBERS,
                                                       min_sigma_eff=0.0), "did:lead")
            sid = ms.sso.session_id
            members = [f"did:w{s}.{k}" for k in range(WRITE_MEMBERS)]
            for k, did in enumerate(members):
                await hv.join_session(sid, did, sigma_raw=0.6 + 0.04 * k)
            await hv.activate_session(sid)
            if plan["quarantined"]:
                rows = [hv.state.agent_row(members[k], ms.slot)["slot"] for k in plan["quarantined"]]
                hv.state.quarantine_rows(rows, now=hv.state.now())
            kw = {}
            if plan["isolation"]:
                kw["isolation"] = getattr(IsolationLevel, plan["isolation"])
            if plan["isolation"] == "SERIALIZABLE":
                locks = IntentLockManager()
                for k in range(WRITE_MEMBERS // 2):
                    for p in range(k, WRITE_PATHS, WRITE_MEMBERS // 2):
                        locks.acquire(members[k], sid, f"/d{p}", LockIntent.WRITE)
                kw["lock_manager"] = locks
            wave = ms.write_wave(**kw)
            for i, (w, p, ring, observe) in enumerate(plan["writes"]):
                if observe:
                    wave.observe(members[w], f"/d{p}")
                wave.submit(members[w], f"/d{p}", f"{s}.{i}", ring=ring)
            on_card = torch.device(device).type == "cuda"
            if on_card:
                torch.cuda.synchronize()
            t = time.perf_counter_ns()
            report = wave.flush(now=16.0 + 0.125 * s)
            if on_card:
                torch.cuda.synchronize()
            if times is not None:
                times.append((time.perf_counter_ns() - t) / 1e6)
            rec[f"s{s}"] = {
                "report": plain(report),
                "vfs": {p: ms.sso.vfs.read(p) for p in ms.sso.vfs.list_files()},
                "edits": [(e.path, e.agent_did) for e in ms.sso.vfs.edit_log],
                "path_clocks": wave._path_clocks.cpu().numpy(),
                "agent_clocks": wave._agent_clocks.cpu().numpy(),
                "tokens": wave._rl_tokens.cpu().numpy(),
                "stamps": wave._rl_stamp.cpu().numpy(),
            }
        rec["tables"] = all_tables(hv.state)

    with manual_ids_and_time(clock):
        asyncio.run(drive())
    return rec


def write_codes(rec) -> list:
    """The write waves' status counts, WRITE_OK..WRITE_LOCK_REQUIRED."""
    codes = np.zeros(5, np.int64)
    for key, r in rec.items():
        if key.startswith("s"):
            codes += np.bincount(r["report"]["status"], minlength=5)
    return codes.tolist()


def stage_from_threads(state, sessions, dids, sigmas, n_threads: int) -> list:
    """`enqueue_join` from n_threads threads at once, each a strided share
    of the joins; returns every claimed queue entry."""
    import threading

    claimed: list[int] = []
    lock = threading.Lock()
    barrier = threading.Barrier(n_threads)

    def producer(t):
        barrier.wait()
        mine = [state.enqueue_join(int(sessions[i]), dids[i], float(sigmas[i]))
                for i in range(t, len(dids), n_threads)]
        with lock:
            claimed.extend(mine)

    threads = [threading.Thread(target=producer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return claimed


def native_joins():
    """The native phase's NATIVE_JOINS seeded joins: (dids, session
    indices, sigmas). 512 agents join twice: a duplicate where both land
    in one session."""
    rng = np.random.RandomState(SEED + 33)
    dids = [f"did:n{i % (NATIVE_JOINS - 512)}" for i in range(NATIVE_JOINS)]
    sess_idx = rng.randint(0, NATIVE_SESSIONS, NATIVE_JOINS)
    sigmas = rng.uniform(0.2, 1.0, NATIVE_JOINS).astype(np.float32)
    return dids, sess_idx, sigmas


def native_state(device):
    """A fresh state at the default tables with NATIVE_SESSIONS sessions;
    returns (state, session slots)."""
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.state import HypervisorState

    st = HypervisorState(device=device)
    slots = st.create_sessions_batch([f"n:s{i}" for i in range(NATIVE_SESSIONS)],
                                     SessionConfig(max_participants=8, min_sigma_eff=0.5))
    return st, slots


def run_native_staging(device):
    """NATIVE_JOINS seeded joins into a fresh state on `device` from
    NATIVE_THREADS threads through the native queue, and flushed; then
    the same joins, in the order the queue harvested them, pushed one by
    one into a fallback-form queue of a second fresh state, and flushed.
    Returns (claimed entries, push ms, the two records)."""
    from hypervisor_tpu_torch.runtime import StagingQueue, native

    dids, sess_idx, sigmas = native_joins()

    def fresh():
        return native_state(device)

    def outcome(st, status):
        return {"status": status, "results": dict(st.last_join_results),
                "members": sorted(st._members), "tables": all_tables(st)}

    with counted_trace_ids():
        st, slots = fresh()
        t = time.perf_counter_ns()
        claimed = stage_from_threads(st, slots[sess_idx], dids, sigmas, NATIVE_THREADS)
        push_ms = (time.perf_counter_ns() - t) / 1e6
        q = st._queue
        order = [(int(q.session[i]), int(q.agent[i]), float(q.sigma[i]), bool(q.trustworthy[i]))
                 for i in range(len(claimed))]
        pending = {slot: st.agent_ids.string(did)
                   for slot, (did, _s, _d) in st._pending_rows.items()}
        threaded = outcome(st, st.flush_joins(now=1.0))

    saved = native.HAVE_NATIVE
    with counted_trace_ids():
        st2, _ = fresh()
        native.HAVE_NATIVE = False
        try:
            st2._queue = StagingQueue(capacity=st2._queue.capacity)
            for i, (sess, agent, sigma, trust) in enumerate(order):
                st2._next_agent_slot = agent  # the row the threaded run claimed
                require(st2.enqueue_join(sess, pending[agent], sigma, trust) == i,
                        "native: the fallback queue must claim entries in harvest order")
            fallback = outcome(st2, st2.flush_joins(now=1.0))
        finally:
            native.HAVE_NATIVE = saved
    return claimed, push_ms, threaded, fallback


def run_native_scrub(device) -> tuple[int, int]:
    """One scrubber sweep, 64 links a tick, over a fresh state's chains
    (64 sessions of 1-8 deltas) with HV_SCRUB_NATIVE=1 set, the reference's switch to its C++
    strip. Returns (ticks that verified links, B1 launches in the sweep):
    on the card every such tick must launch B1."""
    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.integrity.scrubber import MerkleScrubber
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.state import HypervisorState

    st = HypervisorState(device=device)
    for s in range(64):
        slot = st.create_session(f"n:scrub{s}", SessionConfig(), now=0.0)
        for t in range(1 + s % 8):
            st.stage_delta(slot, -1, ts=float(t), change_words=[s, t])
    st.flush_deltas()
    scrubber = MerkleScrubber(st, budget=64)
    saved = os.environ.get("HV_SCRUB_NATIVE")
    os.environ["HV_SCRUB_NATIVE"] = "1"
    try:
        before = kernels.launch_counts()["sha256_words"]
        reports = [scrubber.tick()]
        while not reports[-1]["sweep_completed"]:
            reports.append(scrubber.tick())
        launched = kernels.launch_counts()["sha256_words"] - before
    finally:
        if saved is None:
            os.environ.pop("HV_SCRUB_NATIVE")
        else:
            os.environ["HV_SCRUB_NATIVE"] = saved
    require(scrubber.mismatches == 0, "native: the scrubber flagged a clean chain")
    return sum(1 for r in reports if r["links"]), launched


def time_staging_queues(device) -> dict:
    """The two forms of `StagingQueue` on the same joins, taking turns
    NATIVE_REPS times: the native queue and the fallback form (the
    reference's Python queue, `HAVE_NATIVE` off while it is built and
    fed). Each turn times, on a fresh state, the `enqueue_join` loop of
    the native phase's joins on one thread and from NATIVE_THREADS
    threads, and the bare queue's `push` loop. Returns {form: {measure:
    [host ms, ...]}}."""
    from hypervisor_tpu_torch.runtime import StagingQueue, native

    dids, sess_idx, sigmas = native_joins()
    sig = [float(x) for x in sigmas]
    saved = native.HAVE_NATIVE
    out = {form: {"enqueue_1_thread": [], f"enqueue_{NATIVE_THREADS}_threads": [], "push": []}
           for form in ("native", "fallback")}
    for _ in range(NATIVE_REPS):
        for form in ("native", "fallback"):
            native.HAVE_NATIVE = saved and form == "native"
            try:
                st, slots = native_state(device)
                sessions = [int(x) for x in slots[sess_idx]]
                t = time.perf_counter_ns()
                for i in range(NATIVE_JOINS):
                    st.enqueue_join(sessions[i], dids[i], sig[i])
                out[form]["enqueue_1_thread"].append((time.perf_counter_ns() - t) / 1e6)
                st._queue.harvest()
                st, slots = native_state(device)
                t = time.perf_counter_ns()
                stage_from_threads(st, slots[sess_idx], dids, sigmas, NATIVE_THREADS)
                out[form][f"enqueue_{NATIVE_THREADS}_threads"].append(
                    (time.perf_counter_ns() - t) / 1e6)
                st._queue.harvest()
                q = StagingQueue(capacity=NATIVE_JOINS)
                t = time.perf_counter_ns()
                for i in range(NATIVE_JOINS):
                    q.push(sig[i], i, sessions[i], True)
                out[form]["push"].append((time.perf_counter_ns() - t) / 1e6)
                require(q.harvest()[0] == NATIVE_JOINS, f"native: the {form} queue lost pushes")
            finally:
                native.HAVE_NATIVE = saved
    return out


def random_saga_table(rng, g: int, m: int) -> dict:
    """A saga table in every step and saga code with cursors at, below and
    past n_steps (a few negative) and random outcome and dispatch masks,
    biased so that many sagas book, retry, exhaust, compensate and settle
    in one round."""
    n_steps = rng.randint(0, m + 1, g).astype(np.int32)
    step = rng.choice([0, 0, 0, 1, 2, 2, 2, 3, 4, 5, 6], (g, m)).astype(np.int8)
    cursor = (n_steps + rng.randint(-3, 3, g)).astype(np.int32)
    pending = rng.uniform(size=g) < 0.7
    step[np.arange(g)[pending], np.clip(cursor, 0, m - 1)[pending]] = 0
    return {
        "step_state": step,
        "retries_left": rng.randint(-1, 3, (g, m)).astype(np.int8),
        "has_undo": rng.uniform(size=(g, m)) < 0.6,
        "saga_state": rng.choice([0, 0, 0, 1, 1, 2, 3, 4], g).astype(np.int8),
        "n_steps": n_steps,
        "cursor": cursor,
        "masks": [rng.uniform(size=g) < p for p in (0.6, 0.6, 0.8, 0.8)],
    }


def slash_graph(rng, n: int, e: int, seeds: int, sigma_range, sessions: int, device):
    """A liability graph of `e` random edges over `n` agents (bond 0.05-0.2,
    every edge active, 5% expired when there are several sessions), sigma
    uniform in `sigma_range`, `seeds` distinct first-wave agents."""
    import torch

    from hypervisor_tpu_torch.tables.state import VouchTable

    v = VouchTable.create(e, device)
    v.voucher.copy_(torch.from_numpy(rng.randint(0, n, e).astype(np.int32)))
    v.vouchee.copy_(torch.from_numpy(rng.randint(0, n, e).astype(np.int32)))
    v.session.copy_(torch.from_numpy(rng.randint(0, sessions, e).astype(np.int32)))
    v.bond.copy_(torch.from_numpy(rng.uniform(0.05, 0.2, e).astype(np.float32)))
    v.active.fill_(True)
    if sessions > 1:
        v.expiry.copy_(torch.from_numpy(
            np.where(rng.uniform(size=e) < 0.05, -1.0, np.inf).astype(np.float32)))
    sigma = torch.from_numpy(rng.uniform(*sigma_range, n).astype(np.float32)).to(device)
    first = np.zeros(n, bool)
    first[rng.choice(n, seeds, replace=False)] = True
    return v, sigma, torch.from_numpy(first).to(device)


def saga_kinds(g_cap: int):
    """The seeded outcome pattern of the saga path: per 5-step saga its kind
    (0 commits cleanly, 1 fails one step once and commits on the retry,
    2 exhausts its last step and compensates cleanly, 3 does the same with
    step 2 lacking an undo, so it escalates) and kind 1's failing step."""
    rng = np.random.RandomState(SEED + 3)
    kinds = rng.choice(4, g_cap - N_DSL_SAGAS, p=[0.55, 0.25, 0.12, 0.08])
    retry_step = rng.choice([0, 1, 3, 4], g_cap - N_DSL_SAGAS)
    branch_ok = rng.uniform(size=(N_DSL_SAGAS, 3)) < 0.6
    return kinds, retry_step, branch_ok


def run_saga_sequence(device):
    """The saga path on `device`: a fresh state at the default SagaTable,
    8,192 sagas created (untimed set-up), then `SagaScheduler.
    run_until_settled` with stub executors. Returns (record, launches,
    state, seconds, initial): what a second device must reproduce, the
    run's launch counts, the run's wall time and the table as created."""
    import asyncio

    import torch

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.runtime.saga_scheduler import SagaScheduler
    from hypervisor_tpu_torch.saga.dsl import SagaDSLParser
    from hypervisor_tpu_torch.state import HypervisorState
    from hypervisor_tpu_torch.tables import StateTables, to_state_arrays
    from hypervisor_tpu_torch.tables.struct import clone

    with counted_trace_ids():
        state = HypervisorState(DEFAULT_CONFIG, device=device)
        g_cap = state.sagas.saga_state.shape[0]
        sessions = state.create_sessions_batch(
            [f"saga:s{i}" for i in range(N_SAGA_SESSIONS)], SessionConfig())
        sched = SagaScheduler(state, retry_backoff_seconds=0.0)
        kinds, retry_step, branch_ok = saga_kinds(g_cap)
        attempts: dict = {}

        def executor(key, failures: int):
            async def run():
                n = attempts.get(key, 0) + 1
                attempts[key] = n
                if n <= failures:
                    raise RuntimeError(f"{key} attempt {n} failed")
                return n
            return run

        async def undo():
            return "undone"

        for i, kind in enumerate(kinds.tolist()):
            steps = [{"retries": 1, "has_undo": True}, {"retries": 1, "has_undo": True},
                     {"has_undo": kind != 3}, {"retries": 1, "has_undo": True},
                     {"retries": 2, "has_undo": True}]
            slot = state.create_saga(f"saga:{i}", int(sessions[i % N_SAGA_SESSIONS]), steps)
            for j, step in enumerate(steps):
                failures = 0
                if kind == 1 and j == retry_step[i]:
                    failures = 1
                elif kind >= 2 and j == SAGA_STEPS - 1:
                    failures = 3  # 1 + 2 retries: exhausted
                sched.register(slot, j, executor((slot, j), failures),
                               undo=undo if step["has_undo"] else None)
        policies = ("all_must_succeed", "any_must_succeed", "majority_must_succeed")
        for d in range(N_DSL_SAGAS):
            definition = SagaDSLParser().parse({
                "name": "fan", "session_id": f"saga:s{d}", "saga_id": f"saga:dsl{d}",
                "steps": [{"id": f"b{b}", "action_id": f"m.b{b}", "agent": "did:f",
                           "undo_api": f"/ub{b}"} for b in range(3)]
                + [{"id": "finish", "action_id": "m.finish", "agent": "did:f"}],
                "fan_out": [{"policy": policies[d % 3], "branches": ["b0", "b1", "b2"]}],
            })
            slot = state.create_saga_from_dsl(definition, int(sessions[d]))
            execs = {f"b{b}": executor((slot, b), 0 if branch_ok[d, b] else 1) for b in range(3)}
            execs["finish"] = executor((slot, 3), 0)
            sched.register_definition(slot, definition, execs,
                                      undos={f"b{b}": undo for b in range(3)})
        initial = clone(state.sagas)
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rounds = asyncio.run(sched.run_until_settled())
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        require(state.tracer.cursor == int(state.tracer.table.cursor),
                "saga path: the tracer's cursor mirror disagrees with the device")
        rec = {"tables": to_state_arrays(StateTables(
            state.agents, state.sessions, state.vouches, state.metrics.table, sagas=state.sagas))}
        rec["tables"]["trace.words"] = state.tracer.table.words.cpu().numpy()
        rec["results"] = {f"{k}": v for k, v in sched.results.items()}
        rec["errors"] = {f"{k}": v for k, v in sched.errors.items()}
        rec["attempts"] = {f"{k}": v for k, v in attempts.items()}
        rec["rounds"] = rounds
    return rec, launches, state, seconds, initial


def check_saga_outcomes(rec, g_cap: int) -> dict:
    """Each 5-step saga's end state against its kind; returns the counts."""
    from hypervisor_tpu_torch.ops import saga_ops as ops

    kinds, _, _ = saga_kinds(g_cap)
    t = rec["tables"]
    states, steps = t["sagas.saga_state"], t["sagas.step_state"]
    k = len(kinds)
    five = steps[:k, :SAGA_STEPS]
    committed = (five == ops.STEP_COMMITTED).all(1)
    clean_undo = (five[:, :4] == ops.STEP_COMPENSATED).all(1) & (five[:, 4] == ops.STEP_FAILED)
    require(((states[:k] == ops.SAGA_COMPLETED) & committed)[kinds <= 1].all(),
            "saga path: a committing saga did not complete with every step committed")
    require(((states[:k] == ops.SAGA_COMPLETED) & clean_undo)[kinds == 2].all(),
            "saga path: a compensating saga did not unwind cleanly")
    require((states[:k] == ops.SAGA_ESCALATED)[kinds == 3].all(),
            "saga path: a saga with a missing undo did not escalate")
    require(bool(np.isin(states[:g_cap], (ops.SAGA_COMPLETED, ops.SAGA_ESCALATED)).all()),
            "saga path: a saga did not settle")
    return {f"kind{c}": int((kinds == c).sum()) for c in range(4)} | {
        "escalated": int((states == ops.SAGA_ESCALATED).sum()),
        "completed": int((states == ops.SAGA_COMPLETED).sum())}


def run_slash_sequence(device):
    """The slash path on `device`: a fresh state at the default tables,
    sigma and flags written in bulk, a liability graph in one session
    written in bulk above the first rows plus `add_vouch` / `release_vouch`
    calls, then one `apply_slash`. Returns (record, launches, state,
    pre): what a second device must reproduce, the slash's launch counts,
    and the cascade's inputs as they stood before it."""
    import torch

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.state import HypervisorState
    from hypervisor_tpu_torch.tables import StateTables, to_state_arrays
    from hypervisor_tpu_torch.tables.state import AF32_SIGMA_EFF, AI32_FLAGS, FLAG_ACTIVE
    from hypervisor_tpu_torch.tables.struct import clone

    with counted_trace_ids():
        state = HypervisorState(DEFAULT_CONFIG, device=device)
        n, e = state.agents.ring.shape[0], state.vouches.voucher.shape[0]
        sess = state.create_sessions_batch(["slash:s0", "slash:s1"], SessionConfig())
        rng = np.random.RandomState(SEED + 4)
        dev = state.device
        state.agents.f32[:, AF32_SIGMA_EFF] = torch.from_numpy(
            rng.uniform(0.3, 1.0, n).astype(np.float32)).to(dev)
        state.agents.i32[:, AI32_FLAGS] = FLAG_ACTIVE
        state.agents.ring.fill_(2)
        bulk = slice(16, e)
        v = state.vouches
        m = e - 16
        v.voucher[bulk] = torch.from_numpy(rng.randint(0, n, m).astype(np.int32)).to(dev)
        v.vouchee[bulk] = torch.from_numpy(rng.randint(0, n, m).astype(np.int32)).to(dev)
        v.session[bulk] = torch.from_numpy(
            np.where(rng.uniform(size=m) < 0.9, sess[0], sess[1]).astype(np.int32)).to(dev)
        v.bond[bulk] = torch.from_numpy(rng.uniform(0.05, 0.3, m).astype(np.float32)).to(dev)
        v.bond_pct[bulk] = 0.2
        v.active[bulk] = True
        rows = [state.add_vouch(int(a), int(b), int(sess[0]), 0.25)
                for a, b in rng.randint(0, n, (8, 2))]
        state.release_vouch(rows[3])
        state.release_vouch(rows[5])
        rows.append(state.add_vouch(int(rng.randint(0, n)), int(rng.randint(0, n)),
                                    int(sess[1]), 0.1, expiry=0.5))
        vouchee = int(rng.randint(0, n))
        pre = (clone(state.vouches), clone(state.agents), vouchee, int(sess[0]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = state.apply_slash(int(sess[0]), vouchee, NORTH_STAR["omega"], now=1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        require(state.tracer.cursor == int(state.tracer.table.cursor),
                "slash path: the tracer's cursor mirror disagrees with the device")
        rec = {"returned": out, "rows": rows, "tables": to_state_arrays(StateTables(
            state.agents, state.sessions, state.vouches, state.metrics.table))}
        rec["tables"]["trace.words"] = state.tracer.table.words.cpu().numpy()
    return rec, launches, state, pre


def tally_kw(fn, counters) -> dict:
    """The metrics counters for a kernel wrapper that books its own
    tallies; nothing for a wrapper that predates them (an older tree
    under --blocks)."""
    import inspect

    return {"counters": counters} if "counters" in inspect.signature(fn).parameters else {}


def path_calls(saga_state, saga_initial, slash_state, slash_pre) -> dict:
    """name -> (call, reset): one saga round at the saga path's table with
    every saga's cursor step booked a success (the table restored first),
    one `apply_slash` at the slash path's inputs (agents and vouches
    restored first), and one B8 wrapper call on those inputs with the
    metrics counters riding in, as `apply_slash` makes it."""
    import torch

    from hypervisor_tpu_torch.kernels import liability as liab_kernels
    from hypervisor_tpu_torch.tables.struct import copy_into

    pre_v, pre_agents, vouchee, sess = slash_pre
    all_commit = {slot: True for slot in range(saga_state.sagas.saga_state.shape[0])}
    sigma = pre_agents.sigma_eff.contiguous()
    first = torch.zeros(sigma.shape, dtype=torch.bool, device=sigma.device)
    first[vouchee] = True
    kw = tally_kw(liab_kernels.slash_cascade, slash_state.metrics.table.counters)

    def restore_sagas():
        copy_into(saga_state.sagas, saga_initial)

    def restore_slash():
        copy_into(slash_state.agents, pre_agents)
        copy_into(slash_state.vouches, pre_v)

    return {
        "saga_round": (lambda: saga_state.saga_round(all_commit), restore_sagas),
        "apply_slash": (lambda: slash_state.apply_slash(sess, vouchee, NORTH_STAR["omega"], now=1.0),
                        restore_slash),
        "slash_cascade": (lambda: liab_kernels.slash_cascade(
            pre_v, sigma, first, sess, NORTH_STAR["omega"], 1.0, **kw), None),
    }


def profile_device_ops(calls: dict) -> dict:
    """Each call of `calls` (name -> (call, reset)) once more after a
    warm-up call, under torch.profiler: its device ops (kernels, copies,
    fills) by name with their count and device microseconds, and the
    totals. `reset` runs before each call, outside the profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (fn, reset) in calls.items():
        for profiled in (False, True):
            if reset is not None:
                reset()
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            with prof if profiled else contextlib.nullcontext():
                fn()
                torch.cuda.synchronize()
        ops = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
        out[name] = {"n_device_ops": sum(n for _, _, n in ops),
                     "device_us": sum(us for us, _, _ in ops),
                     "ops": [{"name": k[:100], "count": n, "device_us": us} for us, k, n in ops]}
    return out


# ── phase serving: the front door, its SLO plane, the roofline, the API ──

#: The reference's `soak` row (BENCH_r11.json-BENCH_r21.json `soak.spec`):
#: the other fields at `WorkloadSpec`'s defaults.
SERVE_REPLAY = dict(seed=11, rate_hz=150.0, duration_s=0.8)
#: The reference's overload phase (BENCH_r17.json `autopilot_soak.phases[1]`),
#: run without the autopilot.
SERVE_OVERLOAD = dict(seed=18, rate_hz=2200.0, duration_s=0.6, lifecycle_fraction=0.95,
                      max_lifetime_s=2.0)
#: The kernels the serving path reaches: B4's join form in the join
#: flush; the contribution, B4, B5, B2's ring form and B3 in the lifecycle
#: wave; B7 in the saga round; B1 in the integrity plane's scrub strips
#: and the contribution's escrow in its fused sanitizer.
SERVE_KERNELS = ("contribution_toward", "admission_block", "fsm_saga_block",
                 "chain_digests_ring", "tree_roots", "saga_tick_block", "sha256_words")
#: The lifecycle wave's kernels a capture window must name (B2-B5).
SERVE_WINDOW_KERNELS = ("chain_digests_ring", "tree_roots", "admission_block", "fsm_saga_block")
#: The replay keys the card's soak must share with the CPU's.
SERVE_REPLAY_KEYS = ("decisions_digest", "chain_heads_digest", "offered", "served", "shed",
                     "orphaned", "waves", "padded_lanes")
#: The integrity plane's scrub strip cadence for the soaks (HV_SCRUB_EVERY,
#: off by default): a strip of the DeltaLog every 8th dispatch, beside
#: the sanitizer's every 8th (`run_soak`'s `integrity_every`).
SERVE_SCRUB_EVERY = 8
#: A roofline share above this means the model or the wall is wrong.
SERVE_SHARE_MAX = 1.05
SERVE_CAPTURE_S = 2.0
#: Lifecycle waves of a full bucket run inside the capture window.
SERVE_WINDOW_WAVES = 8
#: The API sequence held equal between the card and the CPU (the
#: transport is the stdlib server on a localhost port).
SERVE_API = (
    ("health", "GET", "/health", None),
    ("create", "POST", "/api/v1/sessions", {"creator_did": "did:admin", "min_sigma_eff": 0.0}),
    ("join_a", "POST", "/api/v1/sessions/{sid}/join", {"agent_did": "did:a", "sigma_raw": 0.8}),
    ("join_b", "POST", "/api/v1/sessions/{sid}/join", {"agent_did": "did:b", "sigma_raw": 0.95}),
    ("join_dup", "POST", "/api/v1/sessions/{sid}/join", {"agent_did": "did:a", "sigma_raw": 0.8}),
    ("activate", "POST", "/api/v1/sessions/{sid}/activate", None),
    ("rings", "GET", "/api/v1/sessions/{sid}/rings", None),
    ("action", "POST", "/api/v1/sessions/{sid}/actions/check",
     {"agent_did": "did:a", "action": {"action_id": "w1", "name": "write", "execute_api": "/x",
                                       "undo_api": "/u", "reversibility": "full"}}),
    ("vouch", "POST", "/api/v1/sessions/{sid}/vouch",
     {"voucher_did": "did:b", "vouchee_did": "did:a", "voucher_sigma": 0.9}),
    ("join_wave", "POST", "/api/v1/sessions/{sid}/join-wave",
     {"joins": [{"agent_did": f"did:w{i}", "sigma_raw": 0.8} for i in range(5)]}),
    ("serving", "GET", "/debug/serving", None),
    ("slo", "GET", "/debug/slo", None),
    ("device", "GET", "/api/v1/device/stats", None),
    ("events", "GET", "/api/v1/events/stats", None),
    ("stats", "GET", "/api/v1/stats", None),
    ("terminate", "POST", "/api/v1/sessions/{sid}/terminate", None),
    ("get", "GET", "/api/v1/sessions/{sid}", None),
)
#: Fields of the API's bodies that are the host's wall clock or the device.
SERVE_API_WALL = ("latency_ms", "retry_after_live_s", "latency_p99_ms", "backend", "classes",
                  "attribution", "alerts", "alert_digest", "recent_alerts", "deadline_misses",
                  "slo_states", "alert_counts", "recent_paths", "exemplar_rows", "phase_shares")


def pct(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None


class DispatchWalls:
    """Each serving dispatch's wave wall (the scheduler's own bracket,
    `FrontDoor.resolve`'s `wall_s`) beside the device time of the state
    call it made, by CUDA events, and every ticket's latency per class.
    Installed on one state and the `FrontDoor` class for one soak."""

    CALLS = ("flush_joins", "run_governance_wave", "check_actions_wave", "terminate_sessions",
             "saga_round")

    def __init__(self, state, front_door_cls, on_card: bool) -> None:
        import torch

        self.rows: list = []            # (queue, wall_ms, start, end)
        self.latency: dict = {}         # queue -> [ms]
        self.last = None
        self._wall = None
        self._restore = []
        cls = front_door_cls
        resolve, note_wave = cls.resolve, cls.note_wave

        def wrap(name):
            fn = getattr(state, name)

            def call(*args, **kwargs):
                if not on_card:
                    return fn(*args, **kwargs)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                self.last = (start, end)
                return out
            return call

        for name in self.CALLS:
            setattr(state, name, wrap(name))
        self._restore.append(lambda: [state.__dict__.pop(n, None) for n in self.CALLS])

        def resolve_(fd, ticket, **kw):
            resolve(fd, ticket, **kw)
            self._wall = kw["wall_s"]
            self.latency.setdefault(ticket.kind, []).append(ticket.latency_s * 1e3)

        def note_wave_(fd, queue, lanes, bucket, now=None):
            note_wave(fd, queue, lanes, bucket, now=now)
            if self._wall is not None:
                self.rows.append((queue, self._wall * 1e3, *(self.last or (None, None))))
            self._wall, self.last = None, None

        cls.resolve, cls.note_wave = resolve_, note_wave_
        self._restore.append(lambda: (setattr(cls, "resolve", resolve),
                                      setattr(cls, "note_wave", note_wave)))

    def close(self) -> dict:
        """Unhook; returns per-class walls and device times (ms) and the
        dispatches whose wall fell short of their device time."""
        import torch

        for undo in self._restore:
            undo()
        if any(r[2] is not None for r in self.rows):
            torch.cuda.synchronize()
        by_class: dict = {}
        short = []
        for queue, wall_ms, start, end in self.rows:
            dev_ms = start.elapsed_time(end) if start is not None else None
            row = by_class.setdefault(queue, {"wall_ms": [], "device_ms": []})
            row["wall_ms"].append(wall_ms)
            if dev_ms is not None:
                row["device_ms"].append(dev_ms)
                if wall_ms < dev_ms:
                    short.append((queue, wall_ms, dev_ms))
        summary = {q: {"dispatches": len(r["wall_ms"]),
                       "wall_ms": {"p50": pct(r["wall_ms"], 50), "p95": pct(r["wall_ms"], 95),
                                   "max": max(r["wall_ms"])},
                       "device_ms": ({"p50": pct(r["device_ms"], 50),
                                      "p95": pct(r["device_ms"], 95), "max": max(r["device_ms"])}
                                     if r["device_ms"] else None)}
                   for q, r in sorted(by_class.items())}
        latency = {q: {"n": len(v), "p50": pct(v, 50), "p95": pct(v, 95), "p99": pct(v, 99)}
                   for q, v in sorted(self.latency.items())}
        return {"walls": summary, "short": short, "latency_ms": latency}


def serving_soak(device, spec_kw: dict, measure: bool, profile: bool = False) -> dict:
    """One open-workload soak through `serving.run_soak` on a fresh state
    of the default tables on `device`: the report, and with `measure` the
    per-dispatch walls, the launch window and the roofline summary; with
    `profile` the torch.profiler census of the whole soak (the card)."""
    import torch

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.serving import FrontDoor, WorkloadSpec, run_soak
    from hypervisor_tpu_torch.state import HypervisorState

    on_card = torch.device(device).type == "cuda"
    state = HypervisorState(device=device)
    walls = DispatchWalls(state, FrontDoor, on_card) if measure else None
    kernels.reset_launch_counts()
    prof = None
    if profile and on_card:
        from torch.profiler import ProfilerActivity, profile as profile_

        prof = profile_(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        report = run_soak(WorkloadSpec(**spec_kw), state=state)
    finally:
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        timed = walls.close() if walls is not None else None
    out = {"report": report, "seconds": time.perf_counter() - t0,
           "window": kernels.launch_counts(), "state": state}
    if timed is not None:
        out.update(timed)
    if prof is not None:
        from torch.autograd import DeviceType

        census: dict = {}
        busy_us = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                census[e.key[:100]] = census.get(e.key[:100], 0) + e.count
                busy_us += e.self_device_time_total
        out["census"] = census
        out["busy_ms"] = busy_us / 1e3
    if measure:
        out["roofline"] = state.roofline_summary()
        out["serving"] = state.serving_summary()
    return out


def capture_lifecycle_window(device, workdir: str) -> dict:
    """One `profiling.capture_window` around lifecycle waves on a fresh
    state of the default tables behind a front door: the window runs on
    its own thread while this one submits full buckets of lifecycles and
    drains them (`SERVE_WINDOW_WAVES` waves, then it waits for the window
    to close). Returns the window's result and the kernel names its trace
    holds."""
    import threading

    from hypervisor_tpu_torch.observability import profiling
    from hypervisor_tpu_torch.serving import FrontDoor, WaveScheduler
    from hypervisor_tpu_torch.state import HypervisorState

    fd = FrontDoor(HypervisorState(device=device))
    sched = WaveScheduler(fd)
    result: dict = {}
    th = threading.Thread(target=lambda: result.update(
        profiling.capture_window(workdir, SERVE_CAPTURE_S)), daemon=True)
    th.start()
    deadline = time.perf_counter() + 60.0
    while not profiling.is_active() and th.is_alive() and time.perf_counter() < deadline:
        time.sleep(0.005)
    waves, now, i = 0, 0.0, 0
    while profiling.is_active():
        if waves >= SERVE_WINDOW_WAVES:
            time.sleep(0.01)
            continue
        for _ in range(fd.config.max_bucket):
            fd.submit_lifecycle(f"window:{i}", f"did:window:{i}", 0.8, now=now)
            i += 1
        waves += sched.drain(now=now)
        now += 1.0
    th.join(SERVE_CAPTURE_S + 60.0)
    names: dict = {}
    if result.get("status") == "captured":
        with open(result["trace"]) as f:
            for e in json.load(f)["traceEvents"]:
                if e.get("cat") == "kernel":
                    names[e["name"][:100]] = names.get(e["name"][:100], 0) + 1
    return {"result": {k: v for k, v in result.items() if k != "detail"} | (
        {"detail": result["detail"]} if "detail" in result else {}),
            "waves": waves, "kernels": names}


def serving_api(device) -> list:
    """`SERVE_API` through the stdlib transport over a `Hypervisor` of the
    default tables on `device`: [(label, status, body)] with the wall-clock
    and device fields taken out."""
    import http.client

    from hypervisor_tpu_torch import Hypervisor
    from hypervisor_tpu_torch.api import HypervisorHTTPServer, HypervisorService
    from hypervisor_tpu_torch.observability import HypervisorEventBus
    from hypervisor_tpu_torch.testing import same_health_on_every_run

    bus = HypervisorEventBus()
    hv = Hypervisor(event_bus=bus, device=device)
    same_health_on_every_run(hv)
    svc = HypervisorService(hypervisor=hv, event_bus=bus)
    server = HypervisorHTTPServer(service=svc, port=0).start()

    def scrub(value):
        if isinstance(value, dict):
            return {k: scrub(v) for k, v in value.items() if k not in SERVE_API_WALL}
        if isinstance(value, list):
            return [scrub(v) for v in value]
        return value

    ids: dict = {}
    out = []
    try:
        for label, method, path, body in SERVE_API:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
            conn.request(method, path.format(**ids),
                         body=None if body is None else json.dumps(body))
            resp = conn.getresponse()
            got = json.loads(resp.read())
            conn.close()
            if label == "create":
                ids["sid"] = got["session_id"]
            out.append((label, resp.status, scrub(got)))
    finally:
        server.stop()
    return out


def run_serving(device, workdir: str) -> dict:
    """The serving phase: the reference's soak replayed on `device` and on
    the CPU (equal replay keys), the overload soak on `device`, a profiled
    replay's census, a capture window around lifecycle waves, and the API
    sequence on `device` and on the CPU. Returns the records `main`
    checks and prints."""
    rec: dict = {}
    clock = [1_767_225_600.0]
    saved = os.environ.get("HV_SCRUB_EVERY")
    os.environ["HV_SCRUB_EVERY"] = str(SERVE_SCRUB_EVERY)
    try:
        return serving_records(device, workdir, rec, clock)
    finally:
        if saved is None:
            os.environ.pop("HV_SCRUB_EVERY", None)
        else:
            os.environ["HV_SCRUB_EVERY"] = saved


def serving_records(device, workdir: str, rec: dict, clock: list) -> dict:
    """`run_serving`'s runs, with the scrub cadence set."""
    with manual_ids_and_time(clock):
        replay = serving_soak(device, SERVE_REPLAY, measure=True)
    rec["replay"] = replay
    t0 = time.perf_counter()
    with manual_ids_and_time(clock):
        cpu = serving_soak("cpu", SERVE_REPLAY, measure=False)
    rec["cpu_s"] = time.perf_counter() - t0
    rec["cpu_report"] = cpu["report"]
    with manual_ids_and_time(clock):
        rec["profiled"] = serving_soak(device, SERVE_REPLAY, measure=False, profile=True)
        rec["overload"] = serving_soak(device, SERVE_OVERLOAD, measure=True)
    rec["window"] = capture_lifecycle_window(device, workdir)
    with manual_ids_and_time(clock):
        rec["api"] = serving_api(device)
    clock[0] = 1_767_225_600.0
    with manual_ids_and_time(clock):
        rec["api_cpu"] = serving_api("cpu")
    for key in ("replay", "profiled", "overload"):
        rec[key].pop("state", None)
    return rec


def check_serving(rec: dict, on_card: bool) -> dict:
    """Every requirement of the serving phase; returns the summary `main`
    prints."""
    card, cpu = rec["replay"]["report"], rec["cpu_report"]
    for key in SERVE_REPLAY_KEYS:
        require(card[key] == cpu[key], f"serving: the replay's {key} differs from the CPU's: "
                                       f"{card[key]} != {cpu[key]}")
        require(rec["profiled"]["report"][key] == card[key],
                f"serving: the profiled replay's {key} differs")
    summary = {}
    for name in ("replay", "overload"):
        r = rec[name]
        rep = r["report"]
        offered = rep["offered"]["total"]
        require(offered == rep["served"] + sum(rep["shed"].values()) + rep["orphaned"],
                f"serving: {name}: offered != served + shed + orphaned")
        require(rep["compiles_after_warmup"] == 0 and rep["recompiles_after_warmup"] == 0,
                f"serving: {name}: novel signatures after warm-up: "
                f"{rep['compiles_after_warmup']}, {rep['recompiles_after_warmup']}")
        require(rep["invariant_violations"] == 0,
                f"serving: {name}: {rep['invariant_violations']} invariant violations")
        require(not r["short"], f"serving: {name}: a wave wall below its device time: "
                                f"{r['short'][:4]}")
        launched = {k for k, n in r["window"].items() if n}
        if on_card:
            require(launched == set(SERVE_KERNELS),
                    f"serving: {name}: the soak must launch the serving path's kernels and "
                    f"no other: {r['window']}")
        roof = r["roofline"]
        require(roof.get("enabled"), f"serving: {name}: the roofline observatory is off")
        shares = {p: row["achieved_bw_frac"] for p, row in roof["programs"].items()
                  if row["achieved_bw_frac"] is not None}
        require(all(s <= SERVE_SHARE_MAX for s in shares.values()),
                f"serving: {name}: a roofline share above {SERVE_SHARE_MAX}: {shares}")
        summary[name] = {
            "spec": rep["spec"], "offered": rep["offered"], "served": rep["served"],
            "shed": rep["shed"], "orphaned": rep["orphaned"], "shed_rate": rep["shed_rate"],
            "goodput_ops_s": rep["goodput_ops_s"], "goodput_ratio": rep["goodput_ratio"],
            "deadline_misses": rep["deadline_misses"], "waves": rep["waves"],
            "padded_lanes": rep["padded_lanes"], "latency_ms": r["latency_ms"],
            "report_latency_ms": rep["latency_ms"], "walls_vs_device": r["walls"],
            "warm_s": rep["warm_s"], "wall_s": rep["wall_s"], "soak_s": r["seconds"],
            "launches": r["window"], "slo": rep["slo"],
            "roofline": {
                "shares": shares,
                "modeled_bytes": {p: row["model"]["bytes_accessed"]
                                  for p, row in roof["programs"].items()},
                "kernels": {p: row["model"]["kernels"] for p, row in roof["programs"].items()},
                "floor": roof["floor"], "peaks": roof["peaks"],
                "worst_program": roof["worst_program"]},
        }
    census = rec["profiled"].get("census", {})
    named = {k: sum(n for name, n in census.items() if OUR_KERNELS[k] in name)
             for k in SERVE_KERNELS}
    window_named = {k: sum(n for name, n in rec["window"]["kernels"].items()
                           if OUR_KERNELS[k] in name) for k in SERVE_WINDOW_KERNELS}
    require(rec["window"]["result"].get("status") == "captured",
            f"serving: the capture window was refused: {rec['window']['result']}")
    if on_card:
        require(all(named.values()), f"serving: the profiler must name every kernel of the "
                                     f"serving path: {named}")
        require(all(window_named.values()),
                f"serving: the capture window's trace must name B2-B5: {window_named}")
    diff = first_difference("serving_api", rec["api_cpu"], rec["api"])
    require(diff is None, f"serving: the API sequence on the card differs from the CPU at {diff}")
    summary["census_ours"] = named
    prof_rep = rec["profiled"]["report"]
    if "busy_ms" in rec["profiled"]:
        # The soak's loop after warm-up, under the profiler: device busy
        # time over its host wall.
        summary["profiled_replay"] = {
            "device_busy_ms": rec["profiled"]["busy_ms"], "wall_s": prof_rep["wall_s"],
            "warm_s": prof_rep["warm_s"],
            "device_idle_share": 1.0 - rec["profiled"]["busy_ms"] / 1e3 / (
                prof_rep["wall_s"] + prof_rep["warm_s"])}
    summary["capture_window"] = {"result": rec["window"]["result"], "waves": rec["window"]["waves"],
                                 "kernels_named": window_named}
    summary["api"] = [(label, status) for label, status, _ in rec["api"]]
    summary["cpu_replay_s"] = rec["cpu_s"]
    return summary


# ── tenancy: the arena's batched wave, its tenant forms, tenant_dense ─

#: The full-width cell: T tenants, each on the default tables (the
#: serving phase's), bucket-32 batched waves of TEN_TURNS audit deltas.
TEN_T = 8
TEN_BUCKET = 32
TEN_TURNS = 3
#: Lanes of each tenant's wave that carry a vouched contribution (one
#: edge a vouchee, bond 0.3), and the timed waves.
TEN_VOUCHED = 8
TEN_TIMED_WAVES = 10
#: The reference's `tenant_dense` row (`benchmarks/bench_suite.py`
#: `tenant_dense_benchmark`, quick): seed 17, T = 100, 6 rounds of 2
#: lifecycles a tenant, buckets (4, 8), its per-tenant capacity, and the
#: 100 ms device SLO it states for the worst per-tenant p99.
TEN_DENSE = dict(seed=17, tenants=100, rounds=6, lanes=2, buckets=(4, 8), slo_p99_ms=100.0)
#: The flooding-tenant drill (`tests/unit/test_tenancy.py`): 4 tenants,
#: tenant 3 offers 40 lifecycles a round, its neighbours 2.
TEN_FLOOD = dict(tenants=4, rounds=5, flood=40, lanes=2)
#: Each tenant form of `kernels.work.TENANT_FORMS` (form -> the solo
#: kernel it stands for): the block of `pipeline.TenantWaveBlocks` that
#: calls it, the TPU kernel it replaces and its source.
TENANT_FORM_ROWS = {
    "contribution_toward_tenants": ("contribution", "hypervisor_tpu/ops/liability.py:93",
                                    "hypervisor_tpu_torch/csrc/wave.cu"),  # an XLA scatter
    "admission_block_tenants": ("admission", "hypervisor_tpu/kernels/wave_pallas.py:1318",
                                "hypervisor_tpu_torch/csrc/wave.cu"),
    "fsm_saga_block_tenants": ("fsm_saga", "hypervisor_tpu/kernels/wave_pallas.py:1441",
                               "hypervisor_tpu_torch/csrc/wave.cu"),
    "chain_digests_ring_tenants": ("chain_ring", "hypervisor_tpu/kernels/mtu_pallas.py:319",
                                   "hypervisor_tpu_torch/csrc/mtu.cu"),
}
#: The tenant wave's kernels held against their plain versions on its
#: inputs, by block: the four tenant forms and B3, which takes the T x K
#: lanes flat in its solo form.
TENANT_PARITY = {**{form: row[0] for form, row in TENANT_FORM_ROWS.items()}, "tree_roots": "tree"}


def tenant_forms() -> dict:
    """`kernels.work.TENANT_FORMS` (form -> solo kernel), which must name
    the forms of TENANT_FORM_ROWS."""
    from hypervisor_tpu_torch.kernels.work import TENANT_FORMS

    require(set(TENANT_FORMS) == set(TENANT_FORM_ROWS),
            f"tenancy: the tenant forms {sorted(TENANT_FORMS)} are not the smoke's rows")
    return TENANT_FORMS


def dense_config():
    """`tenant_dense`'s per-tenant tables (bench_suite's capacity)."""
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TableCapacity

    rounds, lanes = TEN_DENSE["rounds"], TEN_DENSE["lanes"]
    return dataclasses.replace(DEFAULT_CONFIG, capacity=TableCapacity(
        max_agents=64, max_sessions=max(64, (rounds + 8) * lanes + 16), max_vouch_edges=64,
        max_sagas=16, max_steps_per_saga=4, max_elevations=16, delta_log_capacity=1024,
        event_log_capacity=64, trace_log_capacity=64))


def small_config():
    """The small per-tenant tables of the reference's tenancy tests."""
    from hypervisor_tpu_torch.config import HypervisorConfig, TableCapacity

    return HypervisorConfig(capacity=TableCapacity(
        max_agents=64, max_sessions=64, max_vouch_edges=64, max_sagas=16, max_steps_per_saga=4,
        max_elevations=16, delta_log_capacity=256, event_log_capacity=64, trace_log_capacity=64))


def _clone_arg(a):
    import torch

    from hypervisor_tpu_torch.tables.struct import clone

    if isinstance(a, torch.Tensor):
        return a.clone()
    if is_table(a):
        return clone(a)
    return a


def is_table(a) -> bool:
    """A table or ring: a dataclass of tensors (not a config)."""
    import torch

    return (dataclasses.is_dataclass(a) and not isinstance(a, type)
            and all(isinstance(getattr(a, f.name), torch.Tensor) for f in dataclasses.fields(a)))


@contextlib.contextmanager
def recorded_tenant_blocks():
    """Inside, each tenant-wave block records the inputs of its first call
    (tables cloned before the call writes them) by block name."""
    from hypervisor_tpu_torch.ops import pipeline

    calls: dict = {}
    orig = pipeline.TENANT_KERNEL_BLOCKS

    def recording(name, fn):
        def call(*args, **kw):
            if name not in calls:
                calls[name] = ([_clone_arg(a) for a in args], dict(kw))
            return fn(*args, **kw)
        return call

    pipeline.TENANT_KERNEL_BLOCKS = pipeline.TenantWaveBlocks(
        *(recording(f, getattr(orig, f)) for f in orig._fields))
    try:
        yield calls
    finally:
        pipeline.TENANT_KERNEL_BLOCKS = orig


def ten_workload(rng, t: int, w: int, k: int) -> dict:
    """Tenant t's wave w: k lifecycles (sessions, joiners, sigma, bodies)."""
    return {
        "ids": [f"ten:{t}:{w}:{i}" for i in range(k)],
        "dids": [f"did:ten:{t}:{w}:{i}" for i in range(k)],
        "sigma": rng.uniform(0.35, 0.95, k).astype(np.float32),
        "bodies": rng.randint(0, 2**32, (TEN_TURNS, k, 16), dtype=np.uint64).astype(np.uint32),
    }


def ten_k(t: int, w: int) -> int:
    """Tenant t's lifecycles in wave w: ragged, every tenant present."""
    return TEN_BUCKET - (t + w) % 4 * 5


def vouch_wave(st, slots, k: int) -> None:
    """One live edge toward each of the wave's first TEN_VOUCHED joiners
    (the rows the wave will claim: the bump cursor's next), each from a
    voucher row at the table's end, scoped to the joiner's session."""
    cap = st.agents.i32.shape[0]
    for i in range(min(TEN_VOUCHED, k)):
        st.add_vouch(cap - 1 - i, st._next_agent_slot + i, int(slots[i]), 0.3)


def solo_state(config, device):
    """A solo state whose tracer is off: the tenant wave stamps no trace
    ring, so the solo oracle's epilogue must see none either."""
    from hypervisor_tpu_torch.state import HypervisorState

    saved = os.environ.get("HV_TRACE")
    os.environ["HV_TRACE"] = "0"
    try:
        return HypervisorState(config, device=device)
    finally:
        if saved is None:
            os.environ.pop("HV_TRACE", None)
        else:
            os.environ["HV_TRACE"] = saved


def tenant_tables(st) -> dict:
    """A tenant's (or solo state's) device tables and metrics, host numpy."""
    from hypervisor_tpu_torch.tables.struct import tensors

    out = {}
    for name in ("agents", "sessions", "vouches", "sagas", "elevations", "delta_log", "event_log"):
        for k, v in tensors(getattr(st, name)).items():
            out[f"{name}.{k}"] = v.cpu().numpy().copy()
    for k, v in tensors(st.metrics.table).items():
        out[f"metrics.{k}"] = v.cpu().numpy().copy()
    return out


def tenant_host(st) -> dict:
    return {"chain_seed": {int(s): np.asarray(v).tobytes().hex()
                           for s, v in sorted(st._chain_seed.items())},
            "members": sorted(st._members), "turns": dict(sorted(st._turns.items())),
            "delta_cursor": st._delta_cursor, "next_agent": st._next_agent_slot,
            "next_session": st._next_session_slot}


#: A name fragment of each kernel a governance wave launches (solo or
#: tenant form): a census that misses one missed part of the wave.
WAVE_KERNEL_NAMES = ("contrib_scope_kernel", "admission_", "fsm_saga_kernel", "chain_kernel",
                     "tree_")


def count_device_ops(fn) -> tuple[int, dict]:
    """The device events (kernels, copies, fills) of one call, by
    torch.profiler on the card: their number and their census by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as profile_

    torch.cuda.synchronize()
    with profile_(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    census: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            census[e.key[:80]] = census.get(e.key[:80], 0) + e.count
    return sum(census.values()), census


def tenant_census_child() -> None:
    """In a fresh process: the device ops of one batched wave of TEN_T
    tenants of the default tables and of one solo wave, after two warm
    waves each; prints them as the last line (JSON)."""
    import torch

    from hypervisor_tpu_torch.config import DEFAULT_CONFIG
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.tenancy import TenantArena

    dev = torch.device("cuda", 0)
    scfg = SessionConfig(min_sigma_eff=0.0, max_participants=4)
    arena = TenantArena(TEN_T, DEFAULT_CONFIG, device=dev)
    st = solo_state(DEFAULT_CONFIG, dev)
    rng = np.random.RandomState(SEED + 2)
    out = {}
    for i in range(3):
        lanes, loads = ten_wave_lanes(arena, rng, 50 + i, range(TEN_T))
        slots = st.create_sessions_batch(loads[0]["ids"], scfg)

        def batched(lanes=lanes, now=float(50 + i)):
            arena.governance_wave_batch(lanes, TEN_BUCKET, now=now)

        def solo(slots=slots, load=loads[0], now=float(50 + i)):
            st.run_governance_wave(slots, load["dids"], slots.copy(), load["sigma"],
                                   load["bodies"], now=now, pad_to=(TEN_BUCKET, TEN_BUCKET))

        if i < 2:
            batched()
            solo()
        else:
            out["batched"] = count_device_ops(batched)
            out["solo"] = count_device_ops(solo)
    print(json.dumps(out), flush=True)


def tenant_census() -> dict:
    """`tenant_census_child` in a fresh Python process on the card. In
    the whole script, a profiler session entered after earlier phases'
    sessions missed a wave's first events (its staging copies and first
    kernels: 22 to 28 of 181); a fresh process sees every one."""
    here = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.tenant_census_child()"],
        cwd=here, capture_output=True, text=True, timeout=600)
    require(run.returncode == 0,
            f"tenancy: the census process failed ({run.returncode}): {run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def full_width_arena(device, record=False) -> dict:
    """TEN_T tenants on the default tables: a bucket-32 batched wave, a
    sanitized one, and a third with the last tenant idle. Returns the
    arena, each wave's workloads and results, the kernel launches of the
    first wave and (with `record`) its tenant forms' inputs."""
    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG
    from hypervisor_tpu_torch.integrity import IntegrityPlane
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.tenancy import TenantArena

    rng = np.random.RandomState(SEED)
    arena = TenantArena(TEN_T, DEFAULT_CONFIG, device=device)
    plane = IntegrityPlane(arena.tenants[0], every=0)
    scfg = SessionConfig(min_sigma_eff=0.0, max_participants=4)
    rec = {"arena": arena, "waves": [], "plane": plane}
    for w in range(3):
        present = range(TEN_T) if w < 2 else range(TEN_T - 1)
        loads = {t: ten_workload(rng, t, w, ten_k(t, w)) for t in present}
        slots = arena.create_sessions_batch({t: loads[t]["ids"] for t in loads}, scfg,
                                            pad_to=TEN_BUCKET)
        for t in loads:
            vouch_wave(arena.tenants[t], slots[t], len(loads[t]["ids"]))
        lanes = {t: {"session_slots": slots[t], "dids": loads[t]["dids"],
                     "agent_sessions": slots[t].copy(), "sigma_raw": loads[t]["sigma"],
                     "delta_bodies": loads[t]["bodies"]} for t in loads}
        if w == 1:
            plane._fused_due = True
        if w == 2:
            idle_before = tenant_tables(arena.tenants[TEN_T - 1])
        kernels.reset_launch_counts()
        if record and w == 0:
            with recorded_tenant_blocks() as calls:
                out = arena.governance_wave_batch(lanes, TEN_BUCKET, now=float(w + 1))
            rec["calls"] = calls
        else:
            out = arena.governance_wave_batch(lanes, TEN_BUCKET, now=float(w + 1))
        rec["waves"].append({"loads": loads, "slots": slots, "out": out,
                             "launches": kernels.launch_counts(),
                             "sanitized": arena.last_wave["sanitized"]})
        if w == 1:
            rec["after_two"] = [(tenant_tables(st), tenant_host(st)) for st in arena.tenants]
        if w == 2:
            rec["idle_before"] = idle_before
    rec["lend_log"] = lend_commit_log(arena, rng, scfg)
    return rec


def dirty_sets(arena) -> dict:
    return {k: sorted(v) for k, v in arena._dirty.items()}


def lend_commit_log(arena, rng, scfg) -> list:
    """The arena's `_dirty` sets and `sync()` counts around one solo wave
    on tenant 2's lent tables (its kernels write them through raw
    pointers; the wrappers move the tables' version counters, as the
    plain version's torch writes do)."""
    log = [("after wave", dirty_sets(arena), arena.sync())]
    st = arena.tenants[2]
    load = ten_workload(rng, 2, 9, ten_k(2, 9))
    slots = st.create_sessions_batch(load["ids"], scfg)
    st.run_governance_wave(slots, load["dids"], slots.copy(), load["sigma"], load["bodies"],
                           now=9.0, pad_to=(TEN_BUCKET, TEN_BUCKET))
    log.append(("after solo wave", dirty_sets(arena)))
    log.append(("sync", arena.sync(), dirty_sets(arena)))
    return log


def solo_oracles(device, rec) -> list:
    """Each tenant's first two waves as its own solo waves
    (`run_governance_wave(..., pad_to=(bucket, bucket))`, the second
    sanitized) on a fresh solo state of the default tables; with the
    kernel launches of tenant 0's two waves."""
    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG
    from hypervisor_tpu_torch.integrity import IntegrityPlane
    from hypervisor_tpu_torch.models import SessionConfig

    scfg = SessionConfig(min_sigma_eff=0.0, max_participants=4)
    solos = []
    for t in range(TEN_T):
        st = solo_state(DEFAULT_CONFIG, device)
        plane = IntegrityPlane(st, every=0)
        roots, launches = [], []
        for w in range(2):
            load = rec["waves"][w]["loads"][t]
            slots = st.create_sessions_batch(load["ids"], scfg)
            vouch_wave(st, slots, len(load["ids"]))
            plane._fused_due = w == 1
            kernels.reset_launch_counts()
            res = st.run_governance_wave(slots, load["dids"], slots.copy(), load["sigma"],
                                         load["bodies"], now=float(w + 1),
                                         pad_to=(TEN_BUCKET, TEN_BUCKET))
            launches.append(kernels.launch_counts())
            roots.append(u32_roots(res.merkle_root))
        solos.append({"state": st, "roots": roots, "launches": launches})
    return solos


def u32_roots(t) -> list:
    return [r.tobytes().hex() for r in t.cpu().numpy().astype(np.int32).view(np.uint32)]


def check_full_width(rec, solos, cpu_rec) -> dict:
    """Each tenant equal to its solo oracle after two waves (tables, DeltaLog,
    metrics, chain heads, roots, members), the idle tenant untouched by the
    third, each cursor mirror equal to its device cursor, every table equal
    to the CPU's run after the three, and each tenant form launched as
    often as the solo wave launches its kernel."""
    arena = rec["arena"]
    for t in range(TEN_T):
        got, want = rec["after_two"][t][0], tenant_tables(solos[t]["state"])
        diff = first_difference(f"tenant {t}", got, want)
        require(diff is None, f"tenancy: tenant {t}'s slice differs from its solo wave at {diff}")
        for w in range(2):
            res = rec["waves"][w]["out"][t]
            require([r.tobytes().hex() for r in res.merkle_root] == solos[t]["roots"][w][
                :len(res.merkle_root)], f"tenancy: tenant {t} wave {w}: roots differ from solo")
        h_t, h_s = rec["after_two"][t][1], tenant_host(solos[t]["state"])
        for key in ("chain_seed", "members", "turns", "delta_cursor"):
            require(h_t[key] == h_s[key], f"tenancy: tenant {t}'s {key} differs from its solo")
    idle_now = tenant_tables(arena.tenants[TEN_T - 1])
    for name in ("agents", "sessions", "vouches", "delta_log"):
        for k, v in rec["idle_before"].items():
            if k.startswith(name + "."):
                require(np.array_equal(idle_now[k], v), f"tenancy: the idle tenant's {k} moved")
    for t, st in enumerate(arena.tenants):
        require(int(st.delta_log.cursor) == st._delta_cursor,
                f"tenancy: tenant {t}'s DeltaLog cursor mirror {st._delta_cursor} differs from "
                f"the device's {int(st.delta_log.cursor)}")
    cpu_arena = cpu_rec["arena"]
    for w, (got, want) in enumerate(zip(rec["waves"], cpu_rec["waves"])):
        for t, res in got["out"].items():
            require(np.array_equal(np.asarray(res.merkle_root),
                                   np.asarray(want["out"][t].merkle_root)),
                    f"tenancy: tenant {t} wave {w}: roots differ from the CPU run")
    require(rec["lend_log"] == cpu_rec["lend_log"],
            f"tenancy: the card's dirty sets and sync() counts {rec['lend_log']} differ from "
            f"the CPU's {cpu_rec['lend_log']}")
    require(2 in rec["lend_log"][1][1]["delta_log"],
            "tenancy: the solo wave's DeltaLog append left tenant 2 clean")
    for t in range(TEN_T):
        diff = first_difference(f"tenant {t}", tenant_tables(arena.tenants[t]),
                                tenant_tables(cpu_arena.tenants[t]))
        require(diff is None, f"tenancy: the card's arena differs from the CPU's at {diff}")
        require(tenant_host(arena.tenants[t]) == tenant_host(cpu_arena.tenants[t]),
                f"tenancy: tenant {t}'s host indices differ from the CPU run")
    launches = {}
    forms = tenant_forms()
    for w in range(2):
        tenant_l, solo_l = rec["waves"][w]["launches"], solos[0]["launches"][w]
        for form, solo_name in forms.items():
            require(tenant_l[form] == solo_l[solo_name] >= 1,
                    f"tenancy: wave {w}: {form} launched {tenant_l[form]} times, the solo "
                    f"wave's {solo_name} {solo_l[solo_name]}")
        require(tenant_l["tree_roots"] == solo_l["tree_roots"] == 1,
                f"tenancy: wave {w}: B3 launches {tenant_l['tree_roots']} vs "
                f"{solo_l['tree_roots']}")
        solo_kernels = {k for k, n in solo_l.items() if n}
        tenant_kernels = {k for k, n in tenant_l.items() if n}
        require(tenant_kernels == {"tree_roots", *forms},
                f"tenancy: wave {w} launched {tenant_kernels}")
        launches[f"wave{w}"] = {"tenant": {k: tenant_l[k] for k in sorted(tenant_kernels)},
                                "solo": {k: solo_l[k] for k in sorted(solo_kernels)}}
    require(rec["waves"][1]["sanitized"] and not rec["waves"][0]["sanitized"],
            "tenancy: the second wave must carry the sanitizer")
    return launches


def tenant_form_parity(calls, device) -> dict:
    """Each tenant form, and B3 at the tenant wave's T x K lanes, against
    its plain version (a form's: the loop of the solo plain versions) on
    the recorded inputs: on the card, and on the CPU (where the
    contribution's plain version sums in edge order). Bitwise: outputs
    and every table the call writes. Returns {kernel: max_abs_err}."""
    import torch

    from hypervisor_tpu_torch.ops import pipeline
    from hypervisor_tpu_torch.tables.struct import tensors

    errs = {}
    for form, block in TENANT_PARITY.items():
        args, kw = calls[block]
        fk = getattr(pipeline.TENANT_KERNEL_BLOCKS, block)
        fp = getattr(pipeline.TENANT_PLAIN_BLOCKS, block)
        worst = 0.0
        for dev_plain in (device, "cpu"):
            a_k = [_clone_arg(a) for a in args]
            a_p = [_to(a, dev_plain) for a in args]
            out_k, out_p = fk(*a_k, **kw), fp(*a_p, **kw)
            pairs = list(zip(_flat(out_k), _flat(out_p)))
            for x, y in zip(a_k, a_p):
                if is_table(x):
                    pairs += list(zip(tensors(x).values(), tensors(y).values()))
            for x, y in pairs:
                y = y.to(x.device)
                require(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y),
                        f"tenancy: {form} differs from its plain loop ({dev_plain})")
                if x.dtype.is_floating_point:
                    worst = max(worst, float((x - y).abs().max()) if x.numel() else 0.0)
        errs[form] = worst
    return errs


def _to(a, device):
    import torch

    if isinstance(a, torch.Tensor):
        return a.clone().to(device)
    if is_table(a):
        return dataclasses.replace(a, **{f.name: getattr(a, f.name).clone().to(device)
                                         for f in dataclasses.fields(a)})
    return a


def _flat(out):
    import torch

    return [out] if isinstance(out, torch.Tensor) else list(out)


def tenant_form_rows(calls, device, launches: dict, errs: dict, time_device) -> dict:
    """Each tenant form's kernel and plain times (CUDA events, the recorded
    inputs restored before each call), its bound from `kernel_work` at
    these inputs' totals, and the library call where one computes the
    same function (the contribution: one `index_add_` over the flattened
    tenants)."""
    import torch

    from hypervisor_tpu_torch.kernels.work import HBM_BYTES_PER_S, INT32_INSTRUCTIONS_PER_S
    from hypervisor_tpu_torch.kernels.work import kernel_work
    from hypervisor_tpu_torch.ops import liability, pipeline
    from hypervisor_tpu_torch.ops.admission import ADMIT_OK
    from hypervisor_tpu_torch.tables.struct import copy_into, tenant_view

    rows = {}
    for form, (block, _, _) in TENANT_FORM_ROWS.items():
        args, kw = calls[block]
        live = [_clone_arg(a) for a in args]

        def reset(live=live, args=args):
            for x, a in zip(live, args):
                if is_table(x):
                    copy_into(x, a)

        fk = getattr(pipeline.TENANT_KERNEL_BLOCKS, block)
        fp = getattr(pipeline.TENANT_PLAIN_BLOCKS, block)
        k_ms = time_device(lambda: fk(*live, **kw), reset)
        # Two calls: the ring form's plain loop takes seconds a call.
        p_ms = time_device(lambda: fp(*live, **kw), reset, reps=2, warmup=0)
        lib_ms = None
        if block == "contribution":
            vouches, target, now = args
            t_count, n = target.shape
            vee, scoped = zip(*(liability.scoped_edges(tenant_view(vouches, t), target[t], now)
                                for t in range(t_count)))
            offs = torch.arange(t_count, device=target.device)[:, None] * n
            flat_vee = (torch.stack(vee) + offs).reshape(-1)
            vals = torch.where(torch.stack(scoped), vouches.bond, torch.zeros_like(vouches.bond))
            vals = vals.reshape(-1)
            lib_out = torch.zeros((t_count * n,), dtype=torch.float32, device=target.device)
            lib_ms = time_device(lambda: lib_out.index_add_(0, flat_vee, vals),
                                 reps=PLAIN_REPS, warmup=1)
            work = kernel_work(form, edges=int(vouches.bond.numel()), agents=t_count * n)
        elif block == "admission":
            reset()
            status, _, _ = fk(*live, **kw)
            lanes = int(status.numel())
            work = kernel_work(form, lanes=lanes, admitted=int((status == ADMIT_OK).sum()))
        elif block == "fsm_saga":
            agents, sessions, vouches, ks, ok, now, lo, hi = args
            lo_t = torch.tensor(list(lo), device=ks.device)[:, None]
            hi_t = torch.tensor(list(hi), device=ks.device)[:, None]
            hits = int(((agents.session >= lo_t) & (agents.session < hi_t)).sum())
            vouched = int((vouches.active & (vouches.session >= lo_t)
                           & (vouches.session < hi_t)).sum())
            work = kernel_work(form, sessions=int(ks.numel()), lanes=int(ok.numel()),
                               edges=int(vouches.session.numel()), vouched=vouched,
                               agents=int(agents.session.numel()), agent_hits=hits)
        else:
            bodies, seeds, delta_log, wave_sessions, cursors, n_live = args
            work = kernel_work(form, turns=bodies.shape[0], lanes=bodies.shape[1] * bodies.shape[2],
                               rows=int(sum(n_live)))
        nbytes, nops = work
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_INSTRUCTIONS_PER_S * 1e3
        rows[form] = {"launches": launches[form], "max_abs_err": errs[form], "ms": k_ms,
                      "plain_ms": p_ms, "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                      "library_ms": lib_ms, "bytes": nbytes, "int_instructions": nops}
    return rows


def ten_wave_lanes(arena, rng, w: int, present) -> tuple:
    from hypervisor_tpu_torch.models import SessionConfig

    scfg = SessionConfig(min_sigma_eff=0.0, max_participants=4)
    loads = {t: ten_workload(rng, t, w, ten_k(t, w)) for t in present}
    slots = arena.create_sessions_batch({t: loads[t]["ids"] for t in loads}, scfg,
                                        pad_to=TEN_BUCKET)
    return {t: {"session_slots": slots[t], "dids": loads[t]["dids"],
                "agent_sessions": slots[t].copy(), "sigma_raw": loads[t]["sigma"],
                "delta_bodies": loads[t]["bodies"]} for t in loads}, loads


def time_tenant_waves(device, rec, solos) -> dict:
    """Host p50 / p95 of one batched wave of all TEN_T tenants against
    TEN_T solo waves one after another (each sample synchronised, fresh
    sessions every wave), and each side's device events by torch.profiler
    in a fresh process (`tenant_census`)."""
    import torch

    from hypervisor_tpu_torch.models import SessionConfig

    scfg = SessionConfig(min_sigma_eff=0.0, max_participants=4)
    arena = rec["arena"]
    rng = np.random.RandomState(SEED + 1)
    batched, solo = [], []
    for i in range(TEN_TIMED_WAVES + 1):
        lanes, loads = ten_wave_lanes(arena, rng, 10 + i, range(TEN_T))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arena.governance_wave_batch(lanes, TEN_BUCKET, now=float(20 + i))
        torch.cuda.synchronize()
        if i:
            batched.append((time.perf_counter() - t0) * 1e3)
        prepared = []
        for t in range(TEN_T):
            st = solos[t]["state"]
            slots = st.create_sessions_batch(loads[t]["ids"], scfg)
            prepared.append((st, slots, loads[t]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for st, slots, load in prepared:
            st.run_governance_wave(slots, load["dids"], slots.copy(), load["sigma"],
                                   load["bodies"], now=float(20 + i),
                                   pad_to=(TEN_BUCKET, TEN_BUCKET))
        torch.cuda.synchronize()
        if i:
            solo.append((time.perf_counter() - t0) * 1e3)
    counted = tenant_census()
    (tenant_ops, batched_census), (solo_ops, solo_census) = counted["batched"], counted["solo"]
    for side, names in (("batched", batched_census), ("solo", solo_census)):
        missed = [k for k in WAVE_KERNEL_NAMES if not any(k in name for name in names)]
        require(not missed, f"tenancy: the {side} wave's census misses {missed}")
    require(tenant_ops <= 2 * solo_ops,
            f"tenancy: the batched wave's {tenant_ops} device ops exceed 2x one solo wave's "
            f"{solo_ops}")
    return {"batched_wave_ms": {"p50": pct(batched, 50), "p95": pct(batched, 95)},
            f"{TEN_T}_solo_waves_ms": {"p50": pct(solo, 50), "p95": pct(solo, 95)},
            "samples": len(batched), "device_ops": {"batched": tenant_ops, "solo": solo_ops},
            "device_op_census": {"batched": batched_census, "solo": solo_census}}


def tenant_dense_run(device, record=False) -> dict:
    """The reference's `tenant_dense` row through `TenantWaveScheduler` on
    `device`: T = 100 tenants of its small tables, 6 rounds of 2
    lifecycles each, buckets (4, 8), warmed first. Returns offered and
    served, the worst per-tenant p99, novel signatures after warm-up, each
    tenant's chain heads digest, the kernel launches of the first driven
    round and (with `record`) that round's tenant-form inputs."""
    import hashlib

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.observability import health as health_plane
    from hypervisor_tpu_torch.serving import ServingConfig
    from hypervisor_tpu_torch.tenancy import TenantArena, TenantFrontDoor, TenantWaveScheduler

    spec = TEN_DENSE
    tenants = spec["tenants"]
    serving = ServingConfig(buckets=spec["buckets"], lifecycle_deadline_s=0.05,
                            lifecycle_queue_depth=32)
    t0 = time.perf_counter()
    arena = TenantArena(tenants, dense_config(), device=device)
    front = TenantFrontDoor(arena, serving)
    sched = TenantWaveScheduler(front)
    sched.warm(now=0.0)
    warm_s = time.perf_counter() - t0
    base = health_plane.compile_summary(last=0)
    rng = np.random.RandomState(spec["seed"])
    now = 10.0
    held = []
    calls, launches = None, None
    t1 = time.perf_counter()
    for r in range(spec["rounds"]):
        for t in range(tenants):
            for i in range(spec["lanes"]):
                tk = front.submit_lifecycle(t, f"td:{t}:{r}:{i}", f"did:td:{t}:{r}:{i}",
                                            float(0.6 + 0.3 * rng.random()), now=now)
                if not tk.refused:
                    held.append((t, tk))
        if r == 0:
            kernels.reset_launch_counts()
            if record:
                with recorded_tenant_blocks() as calls:
                    sched.lifecycle_round(now)
            else:
                sched.lifecycle_round(now)
            launches = kernels.launch_counts()
        else:
            sched.lifecycle_round(now)
        now += 0.1
    sched.drain(now)
    drive_s = time.perf_counter() - t1
    after = health_plane.compile_summary(last=0)
    lat: dict = {t: [] for t in range(tenants)}
    for t, tk in held:
        if tk.done:
            lat[t].append(tk.latency_s * 1e3)
    p99s = {t: pct(v, 99) for t, v in lat.items() if v}
    mirrors = [st._delta_cursor for st in arena.tenants]
    require(arena._stacked["delta_log"].cursor.tolist() == mirrors,
            "tenancy: tenant_dense's DeltaLog cursor mirrors differ from the device's")
    heads = hashlib.sha256()
    for st in arena.tenants:
        for s in sorted(st._chain_seed):
            heads.update(np.asarray(st._chain_seed[s], np.uint32).tobytes())
    return {
        "tenants": tenants, "rounds": spec["rounds"],
        "offered": tenants * spec["rounds"] * spec["lanes"],
        "served": sum(d.served["lifecycle"] for d in front.doors),
        "shed": sum(sum(d.shed.values()) for d in front.doors),
        "waves": arena.waves, "lifecycle_rounds": sched.lifecycle_rounds,
        "worst_tenant_p99_ms": max(p99s.values()) if p99s else None,
        "median_tenant_p99_ms": pct(list(p99s.values()), 50),
        "slo_p99_ms": spec["slo_p99_ms"],
        "compiles_after_warmup": after["compiles"] - base["compiles"],
        "recompiles_after_warmup": after["recompiles"] - base["recompiles"],
        "chain_heads_digest": heads.hexdigest(), "warm_s": warm_s, "drive_s": drive_s,
        "launches_first_round": launches, "calls": calls,
    }


def flood_drill(device) -> dict:
    """The flooding-tenant drill: tenant 3 offers 40 lifecycles a round to
    its neighbours' 2; the flood sheds against its own queue alone, every
    neighbour lifecycle is served, no novel signature after warm-up, and
    each neighbour's chain heads equal a solo oracle's (a solo state
    replaying that tenant's batched waves as solo waves at their bucket)."""
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.observability import health as health_plane
    from hypervisor_tpu_torch.serving import ServingConfig
    from hypervisor_tpu_torch.state import HypervisorState
    from hypervisor_tpu_torch.tenancy import TenantArena, TenantFrontDoor, TenantWaveScheduler

    spec = TEN_FLOOD
    n_t = spec["tenants"]
    arena = TenantArena(n_t, small_config(), device=device)
    cfg = ServingConfig(buckets=(4, 8), lifecycle_deadline_s=0.05, lifecycle_queue_depth=16)
    front = TenantFrontDoor(arena, cfg)
    sched = TenantWaveScheduler(front)
    sched.warm(now=0.0)
    base = health_plane.compile_summary(last=0)
    log, created = [], []
    batch, create = arena.governance_wave_batch, arena.create_sessions_batch

    def logged_create(ids_per_tenant, config, pad_to=None):
        created.append({t: list(v) for t, v in ids_per_tenant.items()})
        return create(ids_per_tenant, config, pad_to)

    def logged(lanes, bucket, now, omega=0.5):
        log.append((created[-1], {t: dict(v) for t, v in lanes.items()}, bucket, now))
        return batch(lanes, bucket, now, omega)

    arena.governance_wave_batch, arena.create_sessions_batch = logged, logged_create
    now = 10.0
    shed = {t: 0 for t in range(n_t)}
    ids = {}
    for r in range(spec["rounds"]):
        for t in range(n_t):
            for i in range(spec["flood"] if t == n_t - 1 else spec["lanes"]):
                sid = f"s:{t}:{r}:{i}"
                res = front.submit_lifecycle(t, sid, f"did:{t}:{r}:{i}", 0.8, now=now)
                if res.refused:
                    shed[t] += 1
        sched.tick(now)
        now += 0.1
    for _ in range(20):
        if not any(len(d.lifecycles) for d in front.doors):
            break
        sched.lifecycle_round(now)
        now += 0.05
    arena.governance_wave_batch, arena.create_sessions_batch = batch, create
    after = health_plane.compile_summary(last=0)
    served = {t: front.doors[t].served["lifecycle"] for t in range(n_t)}
    neighbours = range(n_t - 1)
    require(all(served[t] == spec["rounds"] * spec["lanes"] and shed[t] == 0
                for t in neighbours),
            f"tenancy: flood drill: a neighbour lost goodput: served {served}, shed {shed}")
    require(shed[n_t - 1] > 0, "tenancy: flood drill: the flooding tenant never shed")
    require(after["compiles"] == base["compiles"] and after["recompiles"] == base["recompiles"],
            "tenancy: flood drill: a novel signature after warm-up")
    scfg = SessionConfig(min_sigma_eff=0.0, max_participants=4)
    for t in neighbours:
        solo = HypervisorState(small_config(), device=device)
        st = arena.tenants[t]
        checked = 0
        for names, lanes, bucket, now_w in log:
            spec_t = lanes.get(t)
            if spec_t is None:
                continue
            slots = solo.create_sessions_batch(names[t], scfg)
            solo.run_governance_wave(
                slots, spec_t["dids"], slots.copy(), spec_t["sigma_raw"],
                spec_t["delta_bodies"], now=now_w, trustworthy=spec_t.get("trustworthy"),
                pad_to=(bucket, bucket))
            for a_slot, s_slot in zip(spec_t["session_slots"], slots):
                require(np.array_equal(st._chain_seed[int(a_slot)],
                                       solo._chain_seed[int(s_slot)]),
                        f"tenancy: flood drill: tenant {t}'s chain head of slot {a_slot} "
                        "differs from the solo oracle")
                checked += 1
        require(checked >= spec["rounds"] * spec["lanes"],
                f"tenancy: flood drill: tenant {t}: {checked} heads checked")
    return {"served": served, "shed": shed, "waves": arena.waves,
            "lifecycle_rounds": sched.lifecycle_rounds}


def splice_drill(device, workdir: str) -> dict:
    """One `recover_tenant` + `splice_tenant`: tenant 1 of a 3-tenant arena
    journaled through two rounds, recovered from its checkpoint and WAL
    onto a solo state on `device`, spliced into slot 1 of a fresh arena;
    that slot then equals the tenant that was never lost, before and after
    one more round on both."""
    from pathlib import Path

    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.resilience import WriteAheadLog
    from hypervisor_tpu_torch.resilience.recovery import recover_tenant
    from hypervisor_tpu_torch.runtime.checkpoint import save_state, wait_durable
    from hypervisor_tpu_torch.tenancy import TenantArena

    bundle = Path(workdir) / "bundle"
    tdir = bundle / "tenant_1"
    tdir.mkdir(parents=True)
    scfg = SessionConfig(min_sigma_eff=0.0, max_participants=4)
    arena = TenantArena(3, small_config(), device=device)
    tenant = arena.tenants[1]
    wait_durable(save_state(tenant, tdir, step=0))
    tenant.journal = WriteAheadLog(tdir / "wal.log", fsync=True)
    rng = np.random.RandomState(5)

    def round_(arena_, r, only=None):
        loads = {t: {"ids": [f"sp:{t}:{r}:{i}" for i in range(2 + t)],
                     "sigma": rng.uniform(0.4, 0.9, 2 + t).astype(np.float32),
                     "bodies": rng.randint(0, 2**32, (2, 2 + t, 16), dtype=np.uint64)
                     .astype(np.uint32)} for t in (only or range(3))}
        slots = arena_.create_sessions_batch({t: v["ids"] for t, v in loads.items()}, scfg,
                                             pad_to=4)
        arena_.governance_wave_batch({t: {
            "session_slots": slots[t], "dids": [f"did:{x}" for x in loads[t]["ids"]],
            "agent_sessions": slots[t].copy(), "sigma_raw": loads[t]["sigma"],
            "delta_bodies": loads[t]["bodies"]} for t in loads}, 4, now=float(r + 1))
        return loads

    for r in range(2):
        round_(arena, r)
    tenant.journal.flush()
    t0 = time.perf_counter()
    back, report = recover_tenant(bundle, 1, config=small_config(), device=device)
    recover_ms = (time.perf_counter() - t0) * 1e3
    fresh = TenantArena(3, small_config(), device=device)
    fresh.splice_tenant(1, back)
    keys = ("agents", "sessions", "vouches", "delta_log")

    def same_slot(label):
        a, b = tenant_tables(fresh.tenants[1]), tenant_tables(arena.tenants[1])
        for k in a:
            if k.split(".")[0] in keys:
                require(np.array_equal(a[k], b[k]), f"tenancy: splice: {label}: {k} differs")
        ha, hb = tenant_host(fresh.tenants[1]), tenant_host(arena.tenants[1])
        require(ha == hb, f"tenancy: splice: {label}: host indices differ")

    same_slot("after the splice")
    tenant.journal = None
    state = rng.get_state()
    round_(arena, 2, only=[1])
    rng.set_state(state)
    round_(fresh, 2, only=[1])
    same_slot("after one more round")
    return {"wal_records_replayed": report["wal_records_replayed"], "recover_ms": recover_ms,
            "sessions": len(fresh.tenants[1]._chain_seed)}


def run_tenancy(device, workdir: str) -> dict:
    """The tenancy phase on the card: the full-width batched waves against
    their solo oracles and the CPU, the tenant forms against their plain
    loops, launches and device ops, the timings, `tenant_dense` on the
    card and the CPU, the flood drill and the splice."""
    out = {}
    rec = full_width_arena(device, record=True)
    solos = solo_oracles(device, rec)
    t0 = time.perf_counter()
    cpu_rec = full_width_arena("cpu")
    out["cpu_full_width_s"] = time.perf_counter() - t0
    out["launches"] = check_full_width(rec, solos, cpu_rec)
    out["lend_log"] = rec["lend_log"]
    out["errs_t8"] = tenant_form_parity(rec["calls"], device)
    out["calls_t8"] = rec["calls"]
    out["timing"] = time_tenant_waves(device, rec, solos)
    dense = tenant_dense_run(device, record=True)
    t0 = time.perf_counter()
    dense_cpu = tenant_dense_run("cpu")
    out["cpu_dense_s"] = time.perf_counter() - t0
    for key in ("offered", "served", "shed", "waves", "lifecycle_rounds", "chain_heads_digest"):
        require(dense[key] == dense_cpu[key],
                f"tenancy: tenant_dense's {key} differs from the CPU replay: "
                f"{dense[key]} != {dense_cpu[key]}")
    require(dense["compiles_after_warmup"] == 0 and dense["recompiles_after_warmup"] == 0,
            f"tenancy: tenant_dense: novel signatures after warm-up: "
            f"{dense['compiles_after_warmup']}, {dense['recompiles_after_warmup']}")
    first = dense["launches_first_round"]
    for form, solo_name in tenant_forms().items():
        require(first[form] == 1, f"tenancy: tenant_dense's round launched {form} "
                                  f"{first[form]} times, one solo wave's {solo_name} once")
    require(first["tree_roots"] == 1, "tenancy: tenant_dense's round must launch B3 once")
    out["errs_t100"] = tenant_form_parity(dense["calls"], device)
    out["calls_t100"] = dense.pop("calls")
    dense_cpu.pop("calls")
    out["dense"] = dense
    out["dense_cpu"] = {k: dense_cpu[k] for k in ("offered", "served", "worst_tenant_p99_ms")}
    out["flood"] = flood_drill(device)
    out["splice"] = splice_drill(device, workdir)
    return out


# ── autopilot: the shifting-mix soak, static against the autopilot ────

#: The reference's `autopilot_soak` row: `_PHASES_QUICK`, seed 17, a
#: 20 ms tick, two replays, and the 100 ms p99 SLO it states for a device.
AUTOPILOT_SOAK = dict(seed=17, quick=True, tick_s=0.02, replays=2, slo_p99_ms=100.0)


def run_autopilot(device) -> dict:
    """The autopilot soak on `device` (two autopilot replays and the static
    baseline) and `GET /debug/autopilot` from a service whose state has an
    autopilot attached and stepped."""
    import asyncio

    from hypervisor_tpu_torch import Hypervisor
    from hypervisor_tpu_torch.api import HypervisorService
    from hypervisor_tpu_torch.autopilot import Autopilot
    from hypervisor_tpu_torch.autopilot.soak import run_autopilot_soak
    from hypervisor_tpu_torch.serving import FrontDoor, ServingConfig, WaveScheduler

    t0 = time.perf_counter()
    row = run_autopilot_soak(device=device, **AUTOPILOT_SOAK)
    soak_s = time.perf_counter() - t0
    require(row["digest_match"], "autopilot: the two replays' decision digests differ")
    require(row["invariant_violations"] == 0,
            f"autopilot: {row['invariant_violations']} invariant violations")
    require(row["decisions"] >= 1, "autopilot: the soak made no decision")
    svc = HypervisorService(hypervisor=Hypervisor(device=device))
    state = svc.hv.state
    require(asyncio.run(svc.debug_autopilot()) == {"enabled": False},
            "autopilot: a bare service must answer the bare plane state")
    front = FrontDoor(state, ServingConfig(buckets=(4,), lifecycle_queue_depth=8))
    sched = WaveScheduler(front)
    sched.warm(now=0.0)
    pilot = Autopilot(state, sched)
    pilot.step(1.0)
    for i in range(front.config.lifecycle_queue_depth + 3):
        front.submit_lifecycle(f"ap:{i}", f"did:ap:{i}", 0.8, now=1.05)
    pilot.step(1.2)
    debug = asyncio.run(svc.debug_autopilot())
    json.dumps(debug)
    require(debug["enabled"] and debug["decisions"] >= 1,
            f"autopilot: /debug/autopilot after a shed window: {debug}")
    return {"row": row, "soak_s": soak_s, "debug_autopilot": debug}


# ── adversarial: the six scenarios on the card against their CPU run ──

#: The scenario harness's seed (the reference's tests and bench row use 11).
ADV_SEED = 11
#: The kernels each scenario must launch on the card, by mode (hardened,
#: bare): B4's join form through `flush_joins` (sybil_flood); B4, B8
#: through `verify_behavior` -> `apply_slash` and the contribution
#: through the sanitizer's escrow (collusion_ring); B7 (compensation_storm);
#: B4 through the API (byzantine_fuzz); the tenant forms and B3 in the
#: arena (noisy_neighbor hardened), the solo wave's B2-B5 and the
#: contribution (noisy_neighbor bare). slash_cascade runs host engines
#: only and launches nothing.
_SOLO_WAVE = ("contribution_toward", "admission_block", "fsm_saga_block", "chain_digests_ring",
              "tree_roots")
ADV_KERNELS = {
    "sybil_flood": (("admission_block",),) * 2,
    "collusion_ring": (("admission_block", "slash_cascade", "contribution_toward"),) * 2,
    "slash_cascade": ((), ()),
    "compensation_storm": (("saga_tick_block",),) * 2,
    "byzantine_fuzz": (("admission_block",),) * 2,
    "noisy_neighbor": (("contribution_toward_tenants", "admission_block_tenants",
                        "fsm_saga_block_tenants", "chain_digests_ring_tenants", "tree_roots"),
                       _SOLO_WAVE),
}
#: Kernel name fragments in a profiler census, the tenant forms too.
ADV_NAMES = {**OUR_KERNELS, "contribution_toward_tenants": "contrib_",
             "admission_block_tenants": "admission_", "fsm_saga_block_tenants": "fsm_saga_kernel",
             "chain_digests_ring_tenants": "chain_kernel<true, true>"}


def adversarial_runs(device, clock: list) -> dict:
    """`scenarios.run_all(ADV_SEED)` hardened and bare on `device`, each
    scenario under the same manual ids and clock, with its kernel launches
    and host wall. Returns {(name, hardened): record}."""
    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.testing import scenarios

    out = {}
    for hardened in (True, False):
        for name in scenarios.SCENARIO_NAMES:
            clock[0] = 1_767_225_600.0
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with manual_ids_and_time(clock):
                result = scenarios.run_scenario(name, ADV_SEED, hardened=hardened, device=device)
            wall = time.perf_counter() - t0
            out[name, hardened] = {"result": result.to_dict(), "wall_s": wall,
                                   "launches": kernels.launch_counts()}
    return out


def adversarial_census_child() -> None:
    """In a fresh process on the card: every scenario, hardened and bare,
    inside ONE torch.profiler session, each inside a `record_function`
    range; prints each run's kernel names by count (a kernel belongs to
    the range its start falls in) as the last line (JSON)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as profile_, record_function

    from hypervisor_tpu_torch.testing import scenarios

    dev = torch.device("cuda", 0)
    clock = [1_767_225_600.0]
    ranges = [f"adv.{name}.{int(h)}" for h in (True, False) for name in scenarios.SCENARIO_NAMES]
    with profile_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for label in ranges:
            _, name, hardened = label.split(".")
            with record_function(label), manual_ids_and_time(clock):
                scenarios.run_scenario(name, ADV_SEED, hardened=bool(int(hardened)), device=dev)
                torch.cuda.synchronize()
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name in ranges}
    census = {label: {} for label in ranges}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for label, (lo, hi) in spans.items():
            if lo <= e.time_range.start <= hi:
                census[label][e.name[:80]] = census[label].get(e.name[:80], 0) + 1
                break
    print(json.dumps(census), flush=True)


def adversarial_census() -> dict:
    """`adversarial_census_child` in a fresh Python process (a profiler
    session late in the whole script can miss a call's first events)."""
    here = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.adversarial_census_child()"],
        cwd=here, capture_output=True, text=True, timeout=900)
    require(run.returncode == 0,
            f"adversarial: the census process failed ({run.returncode}): {run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def leftover_parity(device) -> dict:
    """The ported ops-layer leftovers (`ops.liability`'s queries, the rings,
    the session FSM, the metrics table, the event log) on `device` against the
    CPU at tolerance 0, on seeded inputs at the default tables (65,536
    edges toward 64 vouchees: about a thousand live edges a query, where
    the summation order decides the last bits). Returns what was held and
    the contribution kernel's launches (`contribution_by_agent`)."""
    import torch

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG
    from hypervisor_tpu_torch.observability import metrics as mp
    from hypervisor_tpu_torch.ops import liability, rings, session_fsm
    from hypervisor_tpu_torch.tables import logs, metrics as mt
    from hypervisor_tpu_torch.tables.state import VouchTable

    cap = DEFAULT_CONFIG.capacity
    e, n = cap.max_vouch_edges, cap.max_agents
    rng = np.random.RandomState(SEED + 16)
    cols = {"voucher": rng.randint(-1, n, e).astype(np.int32),
            "vouchee": rng.randint(0, 64, e).astype(np.int32),
            "session": rng.randint(0, 2, e).astype(np.int32),
            "bond_pct": rng.uniform(size=e).astype(np.float32),
            "bond": (rng.uniform(size=e) * rng.uniform(size=e)).astype(np.float32),
            "active": rng.uniform(size=e) < 0.8,
            "expiry": np.where(rng.uniform(size=e) < 0.9, np.inf,
                               rng.uniform(size=e) * 10).astype(np.float32)}
    q_agent = rng.randint(0, 64, 64).astype(np.int32)
    q_sess = rng.randint(0, 2, 64).astype(np.int32)
    session_of = rng.randint(-1, 2, n).astype(np.int32)
    sigma = rng.uniform(size=n).astype(np.float32)
    ring = rng.randint(0, 4, n).astype(np.int8)
    codes = np.repeat(np.arange(-1, 6), 7).astype(np.int8)
    events = rng.randint(-1, 40, cap.event_log_capacity).astype(np.int32)

    def run(dev):
        t = {k: torch.from_numpy(np.array(c)).to(dev) for k, c in cols.items()}
        v = VouchTable(**t)
        qa, qs = torch.from_numpy(q_agent).to(dev), torch.from_numpy(q_sess).to(dev)
        contrib = liability.contribution_by_agent(v, torch.from_numpy(session_of).to(dev), 5.0)
        table = mt.MetricsTable.create(dev)
        mt.counter_inc(table, mp.ADMITTED.index, 2**32 - 3)
        mt.counter_inc(table, mp.ADMITTED.index, 7)
        mt.gauge_set(table, 0, 0.1)
        log = logs.EventLog.create(cap.event_log_capacity, dev)
        log.event_type.copy_(torch.from_numpy(events))
        frm = torch.from_numpy(codes).to(dev)
        return {
            "voucher_contribution": liability.voucher_contribution(v, qa, qs, 5.0),
            "exposure_by_voucher": liability.exposure_by_voucher(v, qa, qs, 5.0),
            "contribution_by_agent": contrib,
            "sigma_eff": liability.sigma_eff(torch.from_numpy(sigma).to(dev), 0.35, contrib),
            "should_demote": rings.should_demote(torch.from_numpy(ring).to(dev),
                                                 torch.from_numpy(sigma).to(dev)),
            "required_rings": rings.required_rings(frm == 1, frm, frm == 3),
            "session_transition_valid": session_fsm.session_transition_valid(
                frm, torch.roll(frm, 3)),
            "bucket_of": mt.bucket_of(table.bounds, torch.from_numpy(sigma * 1e7).to(dev)),
            "count_by_type": log.count_by_type(40),
            "counter_inc": table.counters, "gauge_set": table.gauges,
        }

    kernels.reset_launch_counts()
    card = run(device)
    launches = kernels.launch_counts()["contribution_toward"]
    cpu = run("cpu")
    for name, got in card.items():
        want = cpu[name]
        same = got.shape == want.shape and got.dtype == want.dtype and torch.equal(
            got.cpu().view(torch.int32) if got.dtype == torch.float32 else got.cpu(),
            want.view(torch.int32) if want.dtype == torch.float32 else want)
        require(same, f"adversarial: the ported {name} differs between the card and the CPU")
    return {"functions": sorted(card), "max_abs_err": 0.0, "edges": e, "queries": 64,
            "contribution_launches": launches}


def run_adversarial(device) -> dict:
    """The adversarial phase: the scenario set on `device` and on the CPU
    (each `to_dict()` equal, tolerance 0), every hardened score at the
    floor, and on the card each scenario's kernels in its launch window
    and in the profiler's census; returns the records `main` prints."""
    from hypervisor_tpu_torch.testing import scenarios

    clock = [1_767_225_600.0]
    card = adversarial_runs(device, clock)
    t0 = time.perf_counter()
    cpu = adversarial_runs("cpu", clock)
    cpu_s = time.perf_counter() - t0
    on_card = str(device) != "cpu"
    rows, window = {}, {}
    for (name, hardened), rec in card.items():
        res = rec["result"]
        diff = first_difference(f"{name}.{hardened}", res, cpu[name, hardened]["result"])
        require(diff is None, f"adversarial: the card's result differs from the CPU's at {diff}")
        require(not any(cpu[name, hardened]["launches"].values()),
                f"adversarial: the CPU run of {name} launched a kernel")
        if hardened:
            require(res["score"] >= scenarios.DEFAULT_CONTAINMENT_FLOOR,
                    f"adversarial: {name} scored {res['score']} below the floor "
                    f"{scenarios.DEFAULT_CONTAINMENT_FLOOR}: {res['components']}")
        launched = {k: n for k, n in rec["launches"].items() if n}
        need = ADV_KERNELS[name][0 if hardened else 1]
        if on_card:
            require(all(launched.get(k) for k in need),
                    f"adversarial: {name} (hardened={hardened}) must launch {need}: {launched}")
            if not need:
                require(not launched, f"adversarial: {name} runs host engines only, yet "
                                      f"launched {launched}")
        for k, n in rec["launches"].items():
            window[k] = window.get(k, 0) + n
        rows[f"{name}.{'hardened' if hardened else 'bare'}"] = {
            "score": res["score"], "attack_events": res["attack_events"],
            "trace_digest": res["trace_digest"], "wall_s": rec["wall_s"],
            "cpu_wall_s": cpu[name, hardened]["wall_s"], "launches": launched,
            "components": res["components"]}
    out = {"rows": rows, "window": window, "cpu_s": cpu_s, "leftovers": leftover_parity(device)}
    if on_card:
        require(out["leftovers"]["contribution_launches"] == 1,
                "adversarial: contribution_by_agent must launch the contribution's kernel once")
        named = {}
        for label, ops in adversarial_census().items():
            _, name, hardened = label.split(".")
            need = ADV_KERNELS[name][0 if int(hardened) else 1]
            got = {k: sum(n for op, n in ops.items() if ADV_NAMES[k] in op) for k in need}
            ours = sum(n for op, n in ops.items() if any(f in op for f in ADV_NAMES.values()))
            require(all(got.values()), f"adversarial: the profiler must name {name}'s kernels "
                                       f"(hardened={bool(int(hardened))}): {got}")
            if not need:
                require(ours == 0, f"adversarial: slash_cascade's window names a kernel: {ops}")
            named[f"{name}.{'hardened' if int(hardened) else 'bare'}"] = {
                "named": got, "our_kernels": ours, "device_ops": sum(ops.values())}
        out["census"] = named
    return out


# ── fleet: two workers on the card behind one observatory ─────────────

#: The lease plane's seed and window; the seeded observation schedule runs
#: in `fleet_schedule`.
FLEET_SEED = 9
FLEET_LEASE = dict(heartbeat_interval_s=1.0, suspect_windows=1.0, dead_windows=2.0,
                   recover_beats=2)
#: Worker w0: one tenant, no arena (the solo service); w1: a 2-tenant arena.
FLEET_WORKERS = (("w0", (0,)), ("w1", (0, 1)))
#: The kernels each worker must have launched: w0 through its API (joins
#: flush through B4), w1 through its arena's warm rounds (the tenant forms
#: and B3).
FLEET_KERNELS = {"w0": ("admission_block",),
                 "w1": ("contribution_toward_tenants", "admission_block_tenants",
                        "fsm_saga_block_tenants", "chain_digests_ring_tenants", "tree_roots")}


def fleet_http(port: int, method: str, path: str, body=None):
    """(status, body, ms) of one request over the stdlib transport."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    t0 = time.perf_counter()
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read().decode()
        ms = (time.perf_counter() - t0) * 1e3
        ctype = resp.getheader("Content-Type", "")
        return resp.status, json.loads(raw) if ctype.startswith("application/json") else raw, ms
    finally:
        conn.close()


def fleet_schedule(registry, observe=None) -> None:
    """The seeded lease schedule: both workers beat each window for three
    windows (`observe(now)` after each evaluation: a drain), then w0 falls
    silent (killed) while w1 beats on, until w0 is dead."""
    for k in (1, 2, 3):
        for worker, _ in FLEET_WORKERS:
            registry.heartbeat(worker, float(k))
        registry.evaluate(float(k))
        if observe is not None:
            observe(float(k), live=True)
    if observe is not None:
        observe(None, live=False)
    for k in (4, 5):
        registry.heartbeat("w1", float(k))
        registry.evaluate(float(k))


def run_fleet(device, workdir: str) -> dict:
    """The fleet phase: two `WorkerSpec`s on `device` (a solo worker and a
    2-tenant arena), a `FleetObservatory` and `FleetRegistry` behind a
    service, `GET /debug/fleet` and `/fleet/{workers,metrics,slo,trace,
    incidents}` over the stdlib transport, the workers' kernel launches,
    the lease log's digest against its replay, a SIGKILL drill, and every
    process stopped. Returns the records `main` checks and prints."""
    from hypervisor_tpu_torch import Hypervisor
    from hypervisor_tpu_torch.api import HypervisorHTTPServer, HypervisorService
    from hypervisor_tpu_torch.fleet import (
        DEAD,
        FleetObservatory,
        FleetRegistry,
        FleetSupervisor,
        LeaseConfig,
        WorkerSpec,
        worker_label_coverage,
    )

    dev = "cuda" if str(device).startswith("cuda") else "cpu"
    specs = [WorkerSpec(worker_id=w, tenants=t, device=dev) for w, t in FLEET_WORKERS]
    sup = FleetSupervisor(specs, ready_timeout_s=300, log_dir=workdir)
    rec: dict = {"drain_ms": [], "routes": {}}
    server = None
    try:
        t0 = time.perf_counter()
        sup.start()
        rec["start_s"] = time.perf_counter() - t0
        ports = {w: sup.workers[w]["port"] for w, _ in FLEET_WORKERS}
        # Traffic on the solo worker through its API: a session, joins
        # (each flushed through B4), activation, then its trace.
        _, created, _ = fleet_http(ports["w0"], "POST", "/api/v1/sessions",
                                   {"creator_did": "did:fleet", "min_sigma_eff": 0.0})
        sid = created["session_id"]
        joins = [fleet_http(ports["w0"], "POST", f"/api/v1/sessions/{sid}/join",
                            {"agent_did": f"did:fleet:{i}", "sigma_raw": 0.8})[0]
                 for i in range(3)]
        require(joins == [200] * 3, f"fleet: joins on w0 answered {joins}")
        require(fleet_http(ports["w0"], "POST", f"/api/v1/sessions/{sid}/activate")[0] == 200,
                "fleet: activate on w0 failed")
        rec["launches"] = {w: sup.launch_counts(w) for w, _ in FLEET_WORKERS}

        cfg = LeaseConfig(**FLEET_LEASE)
        reg = FleetRegistry(cfg, seed=FLEET_SEED)
        for w, _ in FLEET_WORKERS:
            reg.register(w, 0.0)
        obs = FleetObservatory(sup.urls(), registry=reg)
        svc = HypervisorService(hypervisor=Hypervisor(device=device))
        svc.fleet = obs
        server = HypervisorHTTPServer(svc, port=0).start()

        def observe(now, live):
            if live:
                t = time.perf_counter()
                merged, snap = obs.drain(now=now)
                rec["drain_ms"].append((time.perf_counter() - t) * 1e3)
                require(snap.errors == (), f"fleet: a live worker failed a scrape: {snap.errors}")
                rec["merged"], rec["snapshot"] = merged, snap
                return
            # Every route, then the SIGKILL drill.
            for label, path in (("debug_fleet", "/debug/fleet"), ("workers", "/fleet/workers"),
                                ("metrics", "/fleet/metrics"), ("slo", "/fleet/slo"),
                                ("trace", f"/fleet/trace/{sid}"),
                                ("incidents", "/fleet/incidents")):
                status, body, ms = fleet_http(server.port, "GET", path)
                rec["routes"][label] = {"status": status, "ms": ms, "body": body}
            sup.kill("w0")
            rec["killed_alive"] = sup.alive("w0")

        fleet_schedule(reg, observe)
        # `/debug/fleet` drains (and captures the dead worker's incident),
        # then `/fleet/incidents` reads it.
        rec["debug_after_kill"] = fleet_http(server.port, "GET", "/debug/fleet")[1]
        rec["after_kill"] = fleet_http(server.port, "GET", "/fleet/incidents")[1]
        replay = FleetRegistry.replay(reg.observations, cfg, seed=FLEET_SEED)
        again = FleetRegistry(cfg, seed=FLEET_SEED)
        for w, _ in FLEET_WORKERS:
            again.register(w, 0.0)
        fleet_schedule(again)
        rec["lease"] = {"digest": reg.transition_digest(), "replay": replay.transition_digest(),
                        "fresh_schedule": again.transition_digest(),
                        "transitions": [t.to_dict() for t in reg.transitions],
                        "state_w0": reg.state_of("w0"), "dead": DEAD}
        rec["coverage"] = worker_label_coverage(rec["merged"])
        obs.close()
    finally:
        if server is not None:
            server.stop()
        sup.stop()
    rec["alive_after_stop"] = {w: sup.alive(w) for w, _ in FLEET_WORKERS}
    rec["exit_codes"] = {w: sup.workers[w]["proc"].returncode for w, _ in FLEET_WORKERS}
    return rec


def check_fleet(rec: dict, on_card: bool) -> dict:
    """Every requirement of the fleet phase; returns the summary `main`
    prints."""
    merged = rec["merged"]
    routes = rec["routes"]
    require(rec["coverage"] == 1.0, f"fleet: worker label coverage {rec['coverage']}, not 1.0")
    arena_rows = [ln for ln in merged.splitlines() if ln.startswith("hv_")
                  and 'worker="w1"' in ln and 'tenant="' in ln]
    require(arena_rows and any('tenant="1"' in ln for ln in arena_rows),
            "fleet: the arena worker's rows carry no tenant label")
    require(all(v["status"] == 200 for v in routes.values()),
            f"fleet: a route failed: {({k: v['status'] for k, v in routes.items()})}")
    dbg = routes["debug_fleet"]["body"]
    require(dbg["enabled"] and sorted(dbg["workers"]) == ["w0", "w1"]
            and all(w["state"] == "alive" for w in dbg["workers"].values()),
            f"fleet: /debug/fleet: {dbg.get('workers')}")
    require(routes["workers"]["body"]["counts"] == {"alive": 2, "suspected": 0, "dead": 0},
            f"fleet: /fleet/workers counts {routes['workers']['body']['counts']}")
    from hypervisor_tpu_torch.fleet import worker_label_coverage

    require(worker_label_coverage(routes["metrics"]["body"]) == 1.0,
            "fleet: /fleet/metrics has a row without a worker label")
    trace = routes["trace"]["body"]["fleet"]
    require(trace["workers"] == ["w0"] and trace["missing"] == ["w1"],
            f"fleet: /fleet/trace stitched {trace}")
    require(sorted(routes["slo"]["body"]["workers"]) == ["w0", "w1"], "fleet: /fleet/slo")
    require(sorted(routes["incidents"]["body"]["workers"]) == ["w0", "w1"], "fleet: /fleet/incidents")
    lease = rec["lease"]
    require(lease["digest"] == lease["replay"] == lease["fresh_schedule"],
            f"fleet: the lease log's digest differs from its replay: {lease}")
    require(lease["state_w0"] == lease["dead"] and not rec["killed_alive"],
            f"fleet: the killed worker is {lease['state_w0']}")
    require(rec["after_kill"]["fleet"]["captured"] >= 1,
            "fleet: the dead worker left no fleet incident")
    require(not any(rec["alive_after_stop"].values()),
            f"fleet: a worker still runs after stop: {rec['alive_after_stop']}")
    launched = {w: {k: n for k, n in c.items() if n} for w, c in rec["launches"].items()}
    if on_card:
        for w, need in FLEET_KERNELS.items():
            require(all(launched[w].get(k) for k in need),
                    f"fleet: worker {w} must have launched {need}: {launched[w]}")
    window: dict = {}
    for counts in rec["launches"].values():
        for k, n in counts.items():
            window[k] = window.get(k, 0) + n
    return {
        "start_s": rec["start_s"], "drain_ms": rec["drain_ms"],
        "route_ms": {k: v["ms"] for k, v in routes.items()},
        "merged_series": rec["snapshot"].merged_series, "series": dict(rec["snapshot"].series),
        "coverage": rec["coverage"], "arena_rows": len(arena_rows),
        "launches_by_worker": launched, "window": window,
        "lease_digest": lease["digest"], "transitions": len(lease["transitions"]),
        "incidents_after_kill": rec["after_kill"]["fleet"]["captured"],
        "exit_codes": rec["exit_codes"],
    }


# ── phase pipeline: the reference's headline unit ────────────────────

#: `full_governance_pipeline` (`benchmarks/bench_suite.py:378-391`): S =
#: 10,000 lanes, T = 3 deltas, sigma 0.8, all trustworthy, floor 0.60, all
#: active; a second input of the same width mixes untrustworthy,
#: below-floor and inactive lanes and carries `contribution` and `omega`.
PIPE_S, PIPE_T = 10_000, 3
PIPE_SEED = 20
PIPE_ITERS = 50
PIPE_PROFILED = 3
#: One window of the pipeline launches B2 once and B3 once, nothing else.
PIPE_KERNELS = {"chain_digests": 1, "tree_roots": 1}


def pipeline_inputs(kind: str) -> dict:
    """Seeded numpy inputs of `governance_pipeline`: "bench" (the
    reference's row) or "mixed"."""
    rng = np.random.RandomState(PIPE_SEED + (kind == "mixed"))
    bodies = rng.randint(0, 2**32, (PIPE_T, PIPE_S, 16), dtype=np.uint64).astype(np.uint32)
    if kind == "bench":
        return {"sigma_raw": np.full(PIPE_S, 0.8, np.float32),
                "trustworthy": np.ones(PIPE_S, bool),
                "min_sigma_eff": np.full(PIPE_S, 0.6, np.float32),
                "delta_bodies": bodies, "active": np.ones(PIPE_S, bool)}
    return {"sigma_raw": rng.uniform(0, 1, PIPE_S).astype(np.float32),
            "trustworthy": rng.uniform(size=PIPE_S) > 0.2,
            "min_sigma_eff": rng.choice(np.float32([0.0, 0.6, 0.75]), PIPE_S),
            "delta_bodies": bodies, "active": rng.uniform(size=PIPE_S) > 0.1,
            "contribution": rng.uniform(0, 0.6, PIPE_S).astype(np.float32),
            "omega": np.float32(0.35)}


def pipeline_args(inputs: dict, device) -> dict:
    import torch

    from hypervisor_tpu_torch import u32

    out = {}
    for k, v in inputs.items():
        if k == "omega":
            out[k] = float(v)
        elif k == "delta_bodies":
            out[k] = u32.from_numpy_u32(v, device)
        else:
            out[k] = torch.from_numpy(v).to(device)
    return out


def hashlib_roots(bodies: np.ndarray) -> np.ndarray:
    """u32[S, 8]: each lane's chain of its T bodies by hashlib, then its
    Merkle root over the T digests (hex-pair combine, odd tail
    duplicated, one leaf is its own root)."""
    t, s, _ = bodies.shape
    be = bodies.astype(">u4")
    out = np.zeros((s, 8), np.uint32)
    for lane in range(s):
        parent = b"\x00" * 32
        level = []
        for turn in range(t):
            parent = hashlib.sha256(be[turn, lane].tobytes() + parent).digest()
            level.append(parent.hex())
        while len(level) > 1:
            if len(level) % 2:
                level.append(level[-1])
            level = [hashlib.sha256((level[i] + level[i + 1]).encode()).hexdigest()
                     for i in range(0, len(level), 2)]
        out[lane] = np.frombuffer(bytes.fromhex(level[0]), ">u4")
    return out


def run_pipeline_phase(device, time_device) -> dict:
    """`ops.pipeline.governance_pipeline` on the card at the reference's
    headline shape and on the mixed input: each call's launch window, every
    field against the CPU port's at tolerance 0, every lane's root against
    hashlib; then (bench input) 50 host-clock calls, the device time by
    CUDA events, and a profiled window of three calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.ops import pipeline

    rec: dict = {"cases": {}}
    for kind in ("bench", "mixed"):
        inputs = pipeline_inputs(kind)
        args = pipeline_args(inputs, device)
        pipeline.governance_pipeline(**args)  # first call: allocator and module loads
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        card = pipeline.governance_pipeline(**args)
        torch.cuda.synchronize()
        window = {k: n for k, n in kernels.launch_counts().items() if n}
        require(window == PIPE_KERNELS,
                f"pipeline ({kind}): the window must launch B2 and B3 once each: {window}")
        cpu = pipeline.governance_pipeline(**pipeline_args(inputs, "cpu"))
        for field in card._fields:
            a, b = getattr(card, field).cpu(), getattr(cpu, field)
            require(a.dtype == b.dtype and a.shape == b.shape
                    and a.numpy().tobytes() == b.numpy().tobytes(),
                    f"pipeline ({kind}): the card's {field} differs from the CPU's")
        roots = card.merkle_root.cpu().numpy().view(np.uint32)
        require(np.array_equal(roots, hashlib_roots(inputs["delta_bodies"])),
                f"pipeline ({kind}): a lane's root differs from hashlib's")
        status = card.status.cpu().numpy()
        rec["cases"][kind] = {
            "window": window, "consensus": card.consensus.cpu().tolist(),
            "status_counts": {int(c): int((status == c).sum()) for c in np.unique(status)},
            "cpu_run": "identical", "roots": "equal to hashlib on every lane"}
        if kind == "bench":
            require(rec["cases"][kind]["status_counts"] == {0: PIPE_S},
                    f"pipeline (bench): every lane must complete: {rec['cases'][kind]}")

    args = pipeline_args(pipeline_inputs("bench"), device)
    samples = []
    for i in range(WARMUP + PIPE_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        pipeline.governance_pipeline(**args)
        torch.cuda.synchronize()
        if i >= WARMUP:
            samples.append((time.perf_counter_ns() - t0) / 1e6)
    rec["host_ms"] = samples
    rec["p50_ms"] = float(np.percentile(samples, 50))
    rec["p95_ms"] = float(np.percentile(samples, 95))
    rec["us_per_session_p50"] = rec["p50_ms"] * 1e3 / PIPE_S
    rec["device_ms"] = time_device(lambda: pipeline.governance_pipeline(**args), reps=20,
                                   sleep_cycles=20_000_000)
    pipeline.governance_pipeline(**args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        for _ in range(PIPE_PROFILED):
            pipeline.governance_pipeline(**args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter_ns() - t0) / 1e6
    ops = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(us for us, _, _ in ops) / 1e3
    rec["profile"] = {
        "calls": PIPE_PROFILED, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if wall_ms else None,
        "n_device_ops": sum(n for _, _, n in ops),
        "ours": {k: sum(n for _, name, n in ops if sub in name)
                 for k, sub in OUR_KERNELS.items() if k in PIPE_KERNELS},
        "top": [{"name": k[:80], "device_us": us, "count": n} for us, k, n in ops[:12]]}
    return rec


# ── phase failover: the fleet's second half ──────────────────────────

#: The reference's rows (`BENCH_r20.json`, `BENCH_r21.json`): the keys the
#: port's drills must reproduce, and the digests they must give.
FAILOVER_ROW_KEYS = ("seed", "quick", "workers", "killed", "detection_windows",
                     "budget_windows", "replayed_ops", "tenants_reassigned", "survivors",
                     "zombie_fenced", "double_applied_ops", "post_splice_rounds",
                     "recompiles_after_splice", "replays", "digest_match", "ownership_digest")
SOAK_ROW_KEYS = ("seed", "quick", "workers", "tenants", "rounds", "sessions", "kills",
                 "failovers", "rebalance_runs", "migrations", "migration_replayed_ops",
                 "failover_replayed_ops", "zombies_fenced", "double_applied_ops",
                 "ownership_violations", "recompiles_after_splice", "replays", "digest_match",
                 "ownership_digest")
FAILOVER_DIGEST = "3cef592df82ea124c3a41d7aed44a64db98be774e08606dfe4e8f7e647fce196"
SOAK_DIGEST = "11196ab50fa4d7623ca531a7bf1708ec3f9472d3b57d43bab93689fb32de7749"
#: Part (c): three workers of the default tables (nothing cut); w0 owns
#: two tenants, w1 and w2 one each with two spare slots; waves before the
#: checkpoint, waves of WAL suffix, survivor rounds after the splice.
FO_FULL = dict(seed=SEED + 17, before=2, suffix=3, serve=4)
FO_FULL_WORKERS = (("w0", (0, 1), 2), ("w1", (2,), 3), ("w2", (3,), 3))
#: The tenant forms and B3: what a batched tenant wave launches.
TENANT_WAVE_KERNELS = ("contribution_toward_tenants", "admission_block_tenants",
                       "fsm_saga_block_tenants", "chain_digests_ring_tenants", "tree_roots")
#: What replaying a journaled wave launches: the solo wave's kernels.
REPLAY_KERNELS = ("contribution_toward", "admission_block", "fsm_saga_block",
                  "chain_digests_ring", "tree_roots")
#: Part (d): a durable worker drained by SIGTERM, one SIGKILLed and failed
#: over into in-process survivors on the card, and their restart at a
#: stale epoch.
FO_PROC_LEASE = dict(heartbeat_interval_s=1.0, suspect_windows=1.0, dead_windows=2.0,
                     recover_beats=2)


def fo_fingerprint(st) -> dict:
    """Everything a recovered tenant must carry: every checkpointed column
    (`state_arrays`), the host metadata a checkpoint writes (chain heads,
    frontiers, interns, members, audit rows, cursors, free lists) but its
    WAL watermark, and the DeltaLog cursor mirror. The metrics table is
    not checkpointed (a recovered tenant's starts fresh)."""
    from hypervisor_tpu_torch.runtime.checkpoint import host_metadata, state_arrays

    meta = host_metadata(st)
    meta.pop("wal_seq")
    return {"arrays": state_arrays(st), "host": json.loads(json.dumps(meta, sort_keys=True)),
            "delta_cursor": int(st._delta_cursor)}


def same_fingerprint(a: dict, b: dict) -> str | None:
    """The first part where two fingerprints differ, or None."""
    if sorted(a["arrays"]) != sorted(b["arrays"]):
        return "the column set"
    for k, v in a["arrays"].items():
        w = b["arrays"][k]
        if v.dtype != w.dtype or v.shape != w.shape or v.tobytes() != w.tobytes():
            return f"column {k}"
    for k in sorted(set(a["host"]) | set(b["host"])):
        if a["host"].get(k) != b["host"].get(k):
            return f"host {k}"
    return None if a["delta_cursor"] == b["delta_cursor"] else "delta cursor"


def fo_full_wave(mw, rng, w: int, now: float) -> None:
    """One bucket-32 batched wave of 3 deltas over every tenant `mw` owns,
    with vouched joiners (phase tenancy's full-width workload)."""
    from hypervisor_tpu_torch.models import SessionConfig

    scfg = SessionConfig(min_sigma_eff=0.0, max_participants=4)
    loads = {slot: ten_workload(rng, t, w, ten_k(t, w)) for t, slot in sorted(mw.slot_of.items())}
    for slot, load in loads.items():
        load["ids"] = [f"{mw.worker_id}:{x}" for x in load["ids"]]
    slots = mw.arena.create_sessions_batch({s: v["ids"] for s, v in loads.items()}, scfg,
                                           pad_to=TEN_BUCKET)
    for s, v in loads.items():
        vouch_wave(mw.arena.tenants[s], slots[s], len(v["ids"]))
    mw.arena.governance_wave_batch(
        {s: {"session_slots": slots[s], "dids": [f"{mw.worker_id}:{d}" for d in v["dids"]],
             "agent_sessions": slots[s].copy(), "sigma_raw": v["sigma"],
             "delta_bodies": v["bodies"]} for s, v in loads.items()}, TEN_BUCKET, now=now)


def failover_full_width(device, workdir: str) -> dict:
    """Part (c): the failover protocol once on arenas of the default
    tables. Each absorbed tenant must equal w0's tenant at the kill, the
    zombie's append must refuse with its log unchanged, the survivors
    must serve with no novel signature, and one planned migration must
    replay nothing and keep its tenant."""
    from pathlib import Path

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG
    from hypervisor_tpu_torch.fleet import DEAD, FleetRegistry, LeaseConfig
    from hypervisor_tpu_torch.fleet.failover import (
        FailoverController,
        ManagedWorker,
        OwnershipMap,
        WorkerDurability,
    )
    from hypervisor_tpu_torch.fleet.rebalance import RebalanceController
    from hypervisor_tpu_torch.observability import health
    from hypervisor_tpu_torch.tenancy import TenantArena
    from hypervisor_tpu_torch.testing.fleet_drills import zombie_resume

    root = Path(workdir) / "full"
    rng = np.random.RandomState(FO_FULL["seed"])
    workers = {}
    for wid, tenants, n_slots in FO_FULL_WORKERS:
        arena = TenantArena(n_slots, DEFAULT_CONFIG, device=device)
        dur = WorkerDurability(root, wid, epoch=0, tenants=tenants).adopt()
        for slot, t in enumerate(tenants):
            arena.tenants[slot].journal = dur.wal(t)
        workers[wid] = ManagedWorker(wid, arena, dur, {t: s for s, t in enumerate(tenants)},
                                     list(range(len(tenants), n_slots)))
    om = OwnershipMap(seed=FO_FULL["seed"])
    ctl = FailoverController(om, config=DEFAULT_CONFIG)
    reg = FleetRegistry(LeaseConfig(**FO_PROC_LEASE), seed=FO_FULL["seed"])
    for wid in sorted(workers):
        ctl.register(workers[wid], now=0.0)
        reg.register(wid, 0.0)
    rec: dict = {"widths": {k: getattr(DEFAULT_CONFIG.capacity, k) for k in (
        "max_agents", "max_sessions", "max_vouch_edges", "max_sagas", "delta_log_capacity")}}
    kernels.reset_launch_counts()
    wave = 0
    now = 1.0
    for phase in ("before", "suffix"):
        for _ in range(FO_FULL[phase]):
            for wid in sorted(workers):
                fo_full_wave(workers[wid], rng, wave, now)
                reg.heartbeat(wid, now)
            reg.evaluate(now)
            wave += 1
            now += 1.0
        if phase == "before":
            ckpt_mb = {}
            for wid, mw in sorted(workers.items()):
                mw.arena.sync()
                for t, slot in sorted(mw.slot_of.items()):
                    path = mw.durability.checkpoint(mw.arena.tenants[slot], t, step=1)
                    ckpt_mb[t] = sum(p.stat().st_size for p in Path(path).rglob("*")
                                     if p.is_file()) / 2**20
            rec["checkpoint_mb"] = ckpt_mb
    rec["waves_window"] = kernels.launch_counts()
    w0 = workers["w0"]
    w0.arena.sync()
    donors = {t: fo_fingerprint(w0.arena.tenants[slot]) for t, slot in sorted(w0.slot_of.items())}
    for slot in w0.slot_of.values():
        w0.arena.tenants[slot].journal.flush()
    # w0 falls silent; the survivors beat on until the lease plane says DEAD.
    while reg.state_of("w0") != DEAD:
        for wid in ("w1", "w2"):
            reg.heartbeat(wid, now)
        reg.evaluate(now)
        now += 1.0
        require(now < 100, "failover (c): the lease plane never convicted w0")

    # The reassignment, each tenant's absorb timed with recover's stages.
    per_tenant: dict = {}
    real_absorb = ctl._absorb

    def timed_absorb(tenant, source, target):
        with timed_recovery_stages(torch_sync(device)) as stages:
            t0 = time.perf_counter_ns()
            slot, report = real_absorb(tenant, source, target)
            torch_sync(device)()
            total = (time.perf_counter_ns() - t0) / 1e6
        per_tenant[int(tenant)] = {
            "absorb_ms": total, "restore_ms": stages.get("restore_state", 0.0),
            "verify_ms": stages.get("verify_audit_heads", 0.0),
            "scan_ms": stages.get("scan", 0.0), "replay_ms": stages.get("replay", 0.0),
            "records_replayed": report["wal_records_replayed"], "survivor": target.worker_id}
        return slot, report

    ctl._absorb = timed_absorb
    kernels.reset_launch_counts()
    rc0 = health.compile_summary()["recompiles"]
    t0 = time.perf_counter_ns()
    report = ctl.failover("w0", now=now)
    rec["failover_ms"] = (time.perf_counter_ns() - t0) / 1e6
    rec["absorb_window"] = kernels.launch_counts()
    rec["absorb_novel_signatures"] = health.compile_summary()["recompiles"] - rc0
    ctl._absorb = real_absorb
    rec["per_tenant"] = per_tenant
    rec["survivors"] = report["survivors"]
    rec["replayed_ops"] = report["replayed_ops"]
    for t, donor in donors.items():
        mw = workers[report["tenants"][t]["survivor"]]
        mw.arena.sync()
        diff = same_fingerprint(fo_fingerprint(mw.arena.tenants[mw.slot_of[t]]), donor)
        require(diff is None, f"failover (c): absorbed tenant {t} differs from the donor "
                              f"at the kill in {diff}")
    fenced, doubled, added = zombie_resume(w0.durability, 0)
    require(fenced == 1 and doubled == 0 and added == 0,
            f"failover (c): the zombie's append was not refused with zero bytes "
            f"({fenced}, {doubled}, {added})")
    rec["zombie"] = {"fenced": bool(fenced), "double_applied_ops": doubled, "bytes": added}

    # The survivors serve on, spliced tenants included: no novel signature.
    kernels.reset_launch_counts()
    rc0 = health.compile_summary()["recompiles"]
    serve_ms = []
    for _ in range(FO_FULL["serve"]):
        for wid in ("w1", "w2"):
            t0 = time.perf_counter_ns()
            fo_full_wave(workers[wid], rng, wave, now)
            torch_sync(device)()
            serve_ms.append((time.perf_counter_ns() - t0) / 1e6)
        wave += 1
        now += 1.0
    rec["serve_window"] = kernels.launch_counts()
    rec["serve_novel_signatures"] = health.compile_summary()["recompiles"] - rc0
    rec["serve_wave_ms"] = serve_ms
    require(rec["serve_novel_signatures"] == 0,
            f"failover (c): the survivors met {rec['serve_novel_signatures']} novel "
            f"signatures after the splice")

    # One planned migration of a survivor's own tenant: zero replay, the
    # tenant unchanged.
    reb = RebalanceController(om, ctl)
    w1, w2 = workers["w1"], workers["w2"]
    w1.arena.sync()
    before = fo_fingerprint(w1.arena.tenants[w1.slot_of[2]])
    kernels.reset_launch_counts()
    t0 = time.perf_counter_ns()
    mig = reb.migrate(2, "w2", now=now)
    rec["migrate_ms"] = (time.perf_counter_ns() - t0) / 1e6
    rec["migrate_window"] = kernels.launch_counts()
    w2.arena.sync()
    diff = same_fingerprint(fo_fingerprint(w2.arena.tenants[w2.slot_of[2]]), before)
    require(mig["status"] == "committed" and mig["replayed_ops"] == 0 and diff is None,
            f"failover (c): the planned migration: {mig['status']}, replayed "
            f"{mig.get('replayed_ops')}, differs in {diff}")
    rec["migration"] = {"status": mig["status"], "replayed_ops": mig["replayed_ops"],
                        "steps": mig["steps"], "epoch": mig["epoch"]}
    rec["ownership_digest"] = om.transition_digest()
    rec["owners"] = om.summary()["owners"]
    for mw in workers.values():
        mw.durability.close()
    return rec


def torch_sync(device):
    """A callable that waits for `device`'s queued work (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def failover_processes(device, workdir: str) -> dict:
    """Part (d): durable worker processes. d0 (2 tenants) is drained by
    SIGTERM: its DRAINED marker's `wal_seq` is each tenant's recovered
    watermark and an in-process adopter replays nothing. d1 (2 tenants,
    provisioned with an empty checkpoint per tenant before it starts) is
    SIGKILLed; the lease plane walks it to DEAD; a `FailoverController`
    recovers its tenants into an in-process survivor on `device`; a
    service whose observatory carries the controllers answers
    `/fleet/{ownership,failover,rebalance}` and `POST /fleet/rebalance`
    (a dry run, then an execution onto a second survivor); a restart of
    d1 at its stale epoch refuses at `adopt`. Every process exits."""
    from pathlib import Path

    from hypervisor_tpu_torch import Hypervisor, kernels
    from hypervisor_tpu_torch.api import HypervisorHTTPServer, HypervisorService
    from hypervisor_tpu_torch.fleet import (
        DEAD,
        FailoverController,
        FleetObservatory,
        FleetRegistry,
        FleetSupervisor,
        LeaseConfig,
        ManagedWorker,
        OwnershipMap,
        RebalanceController,
        WorkerDurability,
        WorkerSpec,
    )
    from hypervisor_tpu_torch.fleet.worker import _small_capacity_config
    from hypervisor_tpu_torch.resilience.recovery import recover_tenant
    from hypervisor_tpu_torch.resilience.wal import scan
    from hypervisor_tpu_torch.state import HypervisorState
    from hypervisor_tpu_torch.tenancy import TenantArena

    dev = "cuda" if str(device).startswith("cuda") else "cpu"
    root = Path(workdir) / "procs"
    cfg = _small_capacity_config()
    # d1's tenants are provisioned durable from the start: an empty
    # checkpoint each (the worker's fresh arena), so its WAL is the suffix.
    prov = WorkerDurability(root, "d1", epoch=0, tenants=(2, 3)).adopt()
    for t in (2, 3):
        prov.checkpoint(HypervisorState(cfg, device=dev), t, step=0)
    prov.close()
    specs = [WorkerSpec(worker_id="d0", tenants=(0, 1), durability_root=str(root), device=dev),
             WorkerSpec(worker_id="d1", tenants=(2, 3), durability_root=str(root), device=dev)]
    sup = FleetSupervisor(specs, ready_timeout_s=300, log_dir=str(root / "logs"))
    rec: dict = {"routes": {}}
    server = None
    try:
        t0 = time.perf_counter()
        sup.start()
        rec["start_s"] = time.perf_counter() - t0
        rec["worker_launches"] = {w: {k: n for k, n in sup.launch_counts(w).items() if n}
                                  for w in ("d0", "d1")}
        # d0: the graceful drain.
        t0 = time.perf_counter()
        marker = sup.drain("d0")
        rec["drain_s"] = time.perf_counter() - t0
        require(marker is not None and set(marker["tenants"]) == {"0", "1"},
                f"failover (d): d0's DRAINED marker: {marker}")
        kernels.reset_launch_counts()
        adopted = {}
        for t in (0, 1):
            _, report = recover_tenant(root / "d0" / "epoch_0", t, config=cfg, device=device)
            adopted[t] = {"wal_seq": marker["tenants"][str(t)]["wal_seq"],
                          "watermark": report["wal_watermark_seq"],
                          "replayed": report["wal_records_replayed"]}
            require(report["wal_records_replayed"] == 0
                    and report["wal_watermark_seq"] == adopted[t]["wal_seq"] > 0,
                    f"failover (d): d0's tenant {t} adopter: {adopted[t]}")
        rec["drain_adopters"] = adopted
        rec["adopt_window"] = kernels.launch_counts()

        # d1: SIGKILL, conviction, failover into survivors on the card.
        lease = LeaseConfig(**FO_PROC_LEASE)
        reg = FleetRegistry(lease, seed=FLEET_SEED)
        reg.register("d1", 0.0)
        reg.register("s0", 0.0)
        for k in (1.0, 2.0):
            reg.heartbeat("d1", k)
            reg.heartbeat("s0", k)
            reg.evaluate(k)
        committed = {t: len(scan(root / "d1" / "epoch_0" / f"tenant_{t}" / "wal.log").committed)
                     for t in (2, 3)}
        sup.kill("d1")
        rec["killed_alive"] = sup.alive("d1")
        now = 3.0
        while reg.state_of("d1") != DEAD:
            reg.heartbeat("s0", now)
            reg.evaluate(now)
            now += 1.0
            require(now < 20, "failover (d): the lease plane never convicted d1")
        om = OwnershipMap(seed=FLEET_SEED)
        dead = ManagedWorker("d1", None, WorkerDurability(root, "d1", epoch=0, tenants=(2, 3)),
                             {2: 0, 3: 1}, [])
        survivors = {}
        # s1 joins after the failover, so it adopts at the fleet's new epoch.
        for wid, n_slots, epoch in (("s0", 2, 0), ("s1", 2, 1)):
            dur = WorkerDurability(root, wid, epoch=epoch, tenants=()).adopt()
            survivors[wid] = ManagedWorker(wid, TenantArena(n_slots, cfg, device=device), dur,
                                           {}, list(range(n_slots)))
        obs = FleetObservatory({}, registry=reg)
        ctl = FailoverController(om, config=cfg, observatory=obs)
        reb = RebalanceController(om, ctl)
        obs.ownership, obs.failover, obs.rebalance = om, ctl, reb
        ctl.register(dead, now=0.0)
        # s1 joins later: the failover lands on s0 alone, and the plan
        # then levels s0 against s1.
        ctl.register(survivors["s0"], now=0.0)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fo_report = ctl.failover("d1", now=now)
        rec["failover_ms"] = (time.perf_counter() - t0) * 1e3
        rec["failover_window"] = kernels.launch_counts()
        require(fo_report["replayed_ops"] == committed[2] + committed[3] > 0,
                f"failover (d): replayed {fo_report['replayed_ops']} of {committed} records")
        rec["failover"] = {"replayed_ops": fo_report["replayed_ops"], "committed": committed,
                           "survivors": fo_report["survivors"], "epoch": fo_report["epoch"]}
        ctl.register(survivors["s1"], now=now)
        digest = om.transition_digest()
        svc = HypervisorService(hypervisor=Hypervisor(device=device))
        svc.fleet = obs
        server = HypervisorHTTPServer(svc, port=0).start()
        for label, method, path, body in (
                ("ownership", "GET", "/fleet/ownership", None),
                ("failover", "GET", "/fleet/failover", None),
                ("rebalance", "GET", "/fleet/rebalance", None),
                ("dry_run", "POST", "/fleet/rebalance", {"now": now}),
                ("execute", "POST", "/fleet/rebalance", {"now": now + 1.0, "execute": True})):
            if label == "execute":
                kernels.reset_launch_counts()
            status, doc, ms = fleet_http(server.port, method, path, body)
            rec["routes"][label] = {"status": status, "ms": ms, "body": doc}
        rec["execute_window"] = kernels.launch_counts()
        routes = rec["routes"]
        require(all(r["status"] == 200 for r in routes.values()),
                f"failover (d): a route failed: {({k: r['status'] for k, r in routes.items()})}")
        require(routes["ownership"]["body"]["transition_digest"] == digest
                and routes["failover"]["body"]["reassignment_count"] == 1
                and routes["dry_run"]["body"]["executed"] is False
                and len(routes["dry_run"]["body"]["plan"]["proposals"]) == 1
                and routes["execute"]["body"]["executed"] is True
                and [r["status"] for r in routes["execute"]["body"]["results"]] == ["committed"]
                and routes["execute"]["body"]["results"][0]["replayed_ops"] == 0,
                f"failover (d): the fleet routes: {json.dumps(routes)[:600]}")
        rec["owners"] = om.summary()["owners"]
        # A restart of d1 at its stale epoch refuses at adopt.
        stale = FleetSupervisor([specs[1]], ready_timeout_s=300, log_dir=str(root / "stale"))
        t0 = time.perf_counter()
        try:
            stale.start()
            refused = None
        except RuntimeError as exc:
            refused = str(exc)
        rec["stale_restart_s"] = time.perf_counter() - t0
        err = (root / "stale" / "d1.err").read_text()
        require(refused is not None and "FencingError" in err and not stale.alive("d1"),
                f"failover (d): the stale restart of d1 was not refused at adopt: {refused}")
        rec["stale_restart"] = err.strip().splitlines()[-1][:200]
        for mw in survivors.values():
            mw.durability.close()
    finally:
        if server is not None:
            server.stop()
        sup.stop()
    rec["alive_after_stop"] = {w: sup.alive(w) for w in ("d0", "d1")}
    rec["exit_codes"] = {w: sup.workers[w]["proc"].returncode for w in ("d0", "d1")}
    require(not any(rec["alive_after_stop"].values()),
            f"failover (d): a worker still runs: {rec['alive_after_stop']}")
    return rec


def run_failover(device, workdir: str) -> dict:
    """Phase failover, parts (a)-(d), each in its own launch window."""
    from pathlib import Path

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.testing.fleet_drills import failover_drill, fleet_soak

    repo = Path(__file__).resolve().parent
    rows = {name: json.loads((repo / name).read_text()) for name in
            ("BENCH_r20.json", "BENCH_r21.json")}
    rec: dict = {"windows": {}}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    drill = failover_drill(20, quick=True, device=device)
    rec["drill_s"] = time.perf_counter() - t0
    rec["windows"]["drill"] = kernels.launch_counts()
    for name, doc in rows.items():
        want = doc["failover"]
        diff = [k for k in FAILOVER_ROW_KEYS if drill[k] != want[k]]
        require(not diff, f"failover (a): the drill differs from {name} in {diff}: "
                          f"{ {k: (drill[k], want[k]) for k in diff} }")
    require(drill["ownership_digest"] == FAILOVER_DIGEST and drill["zombie_bytes_written"] == 0,
            f"failover (a): digest {drill['ownership_digest']}")
    rec["drill"] = drill
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    soak = fleet_soak(21, quick=True, device=device)
    rec["soak_s"] = time.perf_counter() - t0
    rec["windows"]["soak"] = kernels.launch_counts()
    want = rows["BENCH_r21.json"]["fleet_soak"]
    diff = [k for k in SOAK_ROW_KEYS if soak[k] != want[k]]
    require(not diff, f"failover (b): the soak differs from BENCH_r21.json in {diff}: "
                      f"{ {k: (soak[k], want[k]) for k in diff} }")
    require(soak["ownership_digest"] == SOAK_DIGEST and soak["zombie_bytes_written"] == 0,
            f"failover (b): digest {soak['ownership_digest']}")
    rec["soak"] = soak
    t0 = time.perf_counter()
    rec["full"] = failover_full_width(device, workdir)
    rec["full_s"] = time.perf_counter() - t0
    for part in ("waves", "absorb", "serve", "migrate"):
        rec["windows"][f"full_{part}"] = rec["full"].pop(f"{part}_window")
    t0 = time.perf_counter()
    rec["procs"] = failover_processes(device, workdir)
    rec["procs_s"] = time.perf_counter() - t0
    for part in ("adopt", "failover", "execute"):
        rec["windows"][f"procs_{part}"] = rec["procs"].pop(f"{part}_window")
    return rec


def check_failover(rec: dict, on_card: bool) -> dict:
    """The launch requirements of phase failover (on the card: the CPU
    launches nothing), and the window `main` merges into the kernel
    summary."""
    windows = {k: {n: c for n, c in w.items() if c} for k, w in rec["windows"].items()}
    workers = rec["procs"]["worker_launches"]
    if on_card:
        for part in ("drill", "soak", "full_waves", "full_serve"):
            require(all(windows[part].get(k) for k in TENANT_WAVE_KERNELS),
                    f"failover: window {part} must launch the tenant forms and B3: "
                    f"{windows[part]}")
        # A replay runs the journaled waves through the solo kernels.
        for part in ("drill", "soak", "full_absorb", "procs_failover"):
            require(all(windows[part].get(k) for k in REPLAY_KERNELS),
                    f"failover: window {part} must launch the replay's kernels: {windows[part]}")
        for w, counts in workers.items():
            require(all(counts.get(k) for k in TENANT_WAVE_KERNELS),
                    f"failover: worker {w} must launch the tenant forms and B3: {counts}")
    total: dict = {}
    for counts in list(rec["windows"].values()) + list(workers.values()):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return {"windows": windows, "worker_launches": workers, "window": total}


# ── phase mesh: the multi-device plane on a virtual mesh of the card ──

#: The virtual meshes: 8 shards of one device, and a (2, 4) grid of them.
MESH_SHARDS = 8
MESH_GRID = (2, 4)
#: The vouched joiners' edges sit on three edge shards (one edge each), so
#: the contribution's psum adds partials from several shards.
MESH_EDGE_SHARDS = (0, 3, 6)
MESH_BOND = 0.10
#: The 1-D wave's last `MESH_DOUBLED` lanes join the first sessions a
#: second time (the ranked capacity path, with its all_gathers); the
#: grid's wave is one join a session (the multislice contract).
MESH_DOUBLED = 1_000
MESH_TIMED, MESH_WARMUP, MESH_PROFILED = 20, 2, 3
#: Consistency ticks: lanes over sessions of both modes.
MESH_TICK_LANES, MESH_TICK_SESSIONS, MESH_TICKS = 10_240, 64, 2
#: sharded_chain: 3 lanes of one long chain of 10,240 turns.
MESH_CHAIN = dict(turns=10_240, lanes=3)
#: Kernel launches one sharded wave makes: each shard's contribution, B2
#: and B3.
MESH_WAVE_KERNELS = ("contribution_toward", "chain_digests", "tree_roots")
MESH_STATE_ATTRS = ("_slot_of_member", "_packed_bodies", "_pending_partials")


def mesh_devices(device, grid=None):
    """A virtual mesh of `device`: 8 shards, or the (2, 4) grid."""
    import torch

    from hypervisor_tpu_torch import parallel

    if grid is None:
        return parallel.make_mesh(devices=[torch.device(device)] * MESH_SHARDS)
    return parallel.make_multislice_mesh(*grid, devices=[torch.device(device)] * MESH_SHARDS)


def mesh_stage(device, on_mesh: bool, doubled: bool):
    """A fresh state of `FACADE_CAPACITY` (no standing actors: the mesh
    wave takes the top rows of each shard's region) with the wave's
    10,000 sessions, every other one STRONG, and `N_VOUCHED` vouched
    joiners, each with one edge (bond 0.10) on each of `MESH_EDGE_SHARDS`,
    toward the row its lane takes on this path. Returns (state, args)."""
    import torch

    from hypervisor_tpu_torch.config import HypervisorConfig, TableCapacity
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.state import HypervisorState
    from hypervisor_tpu_torch.tables.state import SI32_MODE

    state = HypervisorState(HypervisorConfig(capacity=TableCapacity(**FACADE_CAPACITY)),
                            device=device)
    dev = state.device
    rng = np.random.RandomState(SEED + 18)
    slots = state.create_sessions_batch(
        [f"mesh:s{i}" for i in range(N_SESSIONS)], SessionConfig(min_sigma_eff=0.0))
    state.sessions.i32[torch.from_numpy(slots[::2].astype(np.int64)).to(dev), SI32_MODE] = 0
    agent_sessions = np.asarray(slots, np.int32).copy()
    if doubled:
        agent_sessions[-MESH_DOUBLED:] = slots[:MESH_DOUBLED]
    rows = (state._mesh_wave_slots(N_SESSIONS, MESH_SHARDS) if on_mesh
            else np.arange(N_SESSIONS, dtype=np.int32))[:N_VOUCHED]
    e_cap = state.vouches.voucher.shape[0]
    v = state.vouches
    for s in MESH_EDGE_SHARDS:
        at = slice(s * e_cap // MESH_SHARDS, s * e_cap // MESH_SHARDS + N_VOUCHED)
        v.voucher[at] = torch.arange(100, 100 + N_VOUCHED, dtype=torch.int32, device=dev)
        v.vouchee[at] = torch.from_numpy(rows).to(dev)
        v.session[at] = torch.from_numpy(agent_sessions[:N_VOUCHED]).to(dev)
        v.bond[at] = MESH_BOND
        v.active[at] = True
    sigma = np.full(N_SESSIONS, 0.8, np.float32)
    sigma[:N_VOUCHED] = 0.50
    bodies = rng.randint(0, 2**32, (N_DELTAS, N_SESSIONS, 16), dtype=np.uint64).astype(np.uint32)
    dids = [f"did:mesh:{i}" for i in range(N_SESSIONS)]
    return state, (slots, dids, agent_sessions, sigma, bodies)


def mesh_record(state, res) -> dict:
    """One mesh wave's outputs, every table, the host indices it books and
    the metrics mirror (stage wall times and compile counters apart)."""
    out = {f: getattr(res, f).cpu().numpy().copy() for f in (
        "status", "ring", "sigma_eff", "saga_step_state", "chain", "merkle_root", "fsm_error",
        "released")}
    tables = all_tables(state)
    snap = obs_masked(state.metrics_snapshot())
    return {"wave": out, "tables": tables, "metrics": snap,
            "members": sorted(state._members),
            "audit_rows": {k: list(v) for k, v in state._audit_rows.items()},
            "seeds": {k: np.asarray(v).tolist() for k, v in state._chain_seed.items()}}


@contextlib.contextmanager
def roofline_off():
    """`HV_ROOFLINE=0` for runs compared against each other: the roofline
    observatory models each program's first dispatch in the process, so
    only a process's first run would carry its gauges."""
    saved = os.environ.get("HV_ROOFLINE")
    os.environ["HV_ROOFLINE"] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("HV_ROOFLINE")
        else:
            os.environ["HV_ROOFLINE"] = saved


def run_mesh_wave(device, grid=None) -> tuple:
    """The 1-D or the grid's mesh wave at full width on `device` (ids and
    time made the same for every run). Returns (record, state)."""
    clock = [1_000.0]
    with manual_ids_and_time(clock), roofline_off():
        state, args = mesh_stage(device, True, grid is None)
        res = state.run_governance_wave(*args, now=2.0, mesh=mesh_devices(device, grid))
        return mesh_record(state, res), state


def mesh_vs_single(mesh_rec: dict, single_rec: dict, tag: str) -> None:
    """The mesh wave against the single-device wave on the fields the
    reference's mesh tests hold equal (agent rows differ by design)."""
    for f in ("status", "ring", "sigma_eff", "saga_step_state", "chain", "merkle_root",
              "fsm_error", "released"):
        a, b = mesh_rec["wave"][f], single_rec["wave"][f]
        require(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                f"mesh ({tag}): {f} differs from the single-device wave's")
    for col in ("sessions.i32", "sessions.f32", "vouches.active", "delta_log.body",
                "delta_log.digest", "delta_log.session", "delta_log.turn", "delta_log.cursor"):
        require(mesh_rec["tables"][col].tobytes() == single_rec["tables"][col].tobytes(),
                f"mesh ({tag}): {col} differs from the single-device wave's")
    for key in ("members", "audit_rows", "seeds"):
        require(mesh_rec[key] == single_rec[key],
                f"mesh ({tag}): the host's {key} differ from the single-device wave's")
    from hypervisor_tpu_torch.observability import metrics as mp

    for h in (mp.WAVE_TICKS, mp.ADMITTED, mp.REFUSED, mp.SESSIONS_ARCHIVED, mp.BONDS_RELEASED,
              mp.SAGA_STEPS_COMMITTED, mp.SAGA_STEPS_FAILED):
        require(mesh_rec["metrics"]["counters"][h.index]
                == single_rec["metrics"]["counters"][h.index],
                f"mesh ({tag}): counter {h.name} differs from the single-device wave's")


def mesh_snapshot(state) -> tuple:
    """The state's device tables and host bookkeeping, to replay one
    staged wave again (a wave terminates its sessions)."""
    import copy

    from hypervisor_tpu_torch import state as state_mod
    from hypervisor_tpu_torch.tables.struct import clone

    names = ("agents", "sessions", "vouches", "delta_log")
    attrs = state_mod._HOST_ADOPT_ATTRS + MESH_STATE_ATTRS
    return ({k: clone(getattr(state, k)) for k in names},
            {a: copy.deepcopy(getattr(state, a)) for a in attrs})


def mesh_restore(state, snap) -> None:
    import copy

    from hypervisor_tpu_torch.tables.struct import copy_into

    tables, host = snap
    for k, t in tables.items():
        copy_into(getattr(state, k), t)
    for a, v in host.items():
        setattr(state, a, copy.deepcopy(v))


def time_mesh_waves(device) -> dict:
    """The 1-D mesh wave and the single-device facade wave, the same
    staging (one state each, replayed from a snapshot between waves):
    host p50/p95 of `MESH_TIMED` calls each, in turns, each ending in a
    synchronize; the collectives' share of each mesh wave (CUDA events
    and host time around every psum / all_gather); the device's idle
    share under torch.profiler over `MESH_PROFILED` mesh waves."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hypervisor_tpu_torch.parallel import collectives as coll

    mesh = mesh_devices(device)
    staged = {}
    for name, on_mesh in (("mesh", True), ("single", False)):
        state, args = mesh_stage(device, on_mesh, True)
        staged[name] = (state, args, mesh_snapshot(state))

    def call(name):
        state, args, _ = staged[name]
        state.run_governance_wave(*args, now=2.0, mesh=mesh if name == "mesh" else None)

    spans: list = []
    real = {fn: getattr(coll, fn) for fn in ("psum", "all_gather")}

    def timed(fn):
        def wrapper(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            start.record()
            out = real[fn](*a, **kw)
            end.record()
            spans.append((start, end, (time.perf_counter_ns() - t0) / 1e6))
            return out
        return wrapper

    host = {"mesh": [], "single": []}
    coll_ms = {"device": [], "host": [], "calls": []}
    for i in range(MESH_WARMUP + MESH_TIMED):
        for name in ("mesh", "single"):
            state, _, snap = staged[name]
            mesh_restore(state, snap)
            torch.cuda.synchronize()
            if name == "mesh":
                spans.clear()
                for fn in real:
                    setattr(coll, fn, timed(fn))
            try:
                t0 = time.perf_counter_ns()
                call(name)
                torch.cuda.synchronize()
                ms = (time.perf_counter_ns() - t0) / 1e6
            finally:
                for fn, f in real.items():
                    setattr(coll, fn, f)
            if i >= MESH_WARMUP:
                host[name].append(ms)
                if name == "mesh":
                    coll_ms["device"].append(sum(s.elapsed_time(e) for s, e, _ in spans))
                    coll_ms["host"].append(sum(h for _, _, h in spans))
                    coll_ms["calls"].append(len(spans))
    # Each profiled wave in its own window, the restore before it outside.
    state, _, snap = staged["mesh"]
    walls, ops = [], []
    for _ in range(MESH_PROFILED):
        mesh_restore(state, snap)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter_ns()
            call("mesh")
            torch.cuda.synchronize()
            walls.append((time.perf_counter_ns() - t0) / 1e6)
        ops += [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    busy_ms = sum(us for us, _, _ in ops) / 1e3
    wall_ms = sum(walls)
    out = {name: {"p50_ms": float(np.percentile(v, 50)), "p95_ms": float(np.percentile(v, 95)),
                  "host_ms": v} for name, v in host.items()}
    out["collectives"] = {
        "device_ms_p50": float(np.percentile(coll_ms["device"], 50)),
        "host_ms_p50": float(np.percentile(coll_ms["host"], 50)),
        "calls_per_wave": coll_ms["calls"][0]}
    out["profile"] = {
        "waves": MESH_PROFILED, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if wall_ms else None,
        "n_device_ops": sum(n for _, _, n in ops),
        "ours": {k: sum(n for _, name, n in ops if sub in name)
                 for k, sub in OUR_KERNELS.items() if k in MESH_WAVE_KERNELS}}
    return out


def run_mesh_phase(device) -> dict:
    """Phase mesh: the multi-device plane on virtual meshes of `device`.

    (b) `run_governance_wave(mesh=)` at full width on the 8-shard mesh and
    on the (2, 4) grid: each equal to the same run on an 8-shard CPU mesh
    (every table, the host indices, the metrics mirror), to the
    single-device wave on the card where the reference's mesh tests hold
    them equal, and every root to hashlib's; (c) `check_actions_wave(mesh=)`
    at `N_ACTIONS` against the single-device gateway; (d) a
    `ConsistencyRuntime` through mixed ticks and a reconcile against the
    all-STRONG run; (e) `sharded_slash` at `NORTH_STAR` against the
    single-device cascade (B8); (f) `sharded_chain` against B2's single
    chain and hashlib. The kernel window is (b)-(f); the timing follows."""
    import torch

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.ops import liability
    from hypervisor_tpu_torch.ops import merkle as merkle_ops
    from hypervisor_tpu_torch.parallel import collectives as coll
    from hypervisor_tpu_torch.runtime.consistency import ConsistencyRuntime

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rec: dict = {"windows": {}}

    def window(tag, fn, expected):
        sync()
        kernels.reset_launch_counts()
        out = fn()
        sync()
        got = {k: n for k, n in kernels.launch_counts().items() if n}
        if on_card:
            require(got == expected, f"mesh ({tag}): launches {got}, expected {expected}")
        rec["windows"][tag] = got
        return out

    # (b) the mesh waves, each against the CPU mesh and the single device.
    per_wave = {k: MESH_SHARDS for k in MESH_WAVE_KERNELS}
    for tag, grid in (("1d", None), ("grid", MESH_GRID)):
        card_rec, _ = window(f"wave_{tag}", lambda grid=grid: run_mesh_wave(device, grid),
                             per_wave)
        cpu_rec, _ = run_mesh_wave("cpu", grid)
        diff = first_difference(f"mesh_{tag}", card_rec, cpu_rec)
        require(diff is None, f"mesh ({tag}): the card's run differs from the CPU mesh's at "
                              f"{diff}")
        clock = [1_000.0]
        with manual_ids_and_time(clock), roofline_off():
            state, args = mesh_stage(device, False, grid is None)
            single = mesh_record(state, state.run_governance_wave(*args, now=2.0))
        mesh_vs_single(card_rec, single, tag)
        roots = card_rec["wave"]["merkle_root"].view(np.uint32)
        require(np.array_equal(roots, hashlib_roots(args[4])),
                f"mesh ({tag}): a session's root differs from hashlib's")
        status = card_rec["wave"]["status"]
        rec[f"wave_{tag}"] = {
            "status_counts": {int(c): int((status == c).sum()) for c in np.unique(status)},
            "released": int(card_rec["wave"]["released"]),
            "cpu_mesh": "identical", "single_device": "equal", "roots": "equal to hashlib"}
        require(rec[f"wave_{tag}"]["released"] == N_VOUCHED * len(MESH_EDGE_SHARDS),
                f"mesh ({tag}): every vouched edge must be released")

    # (c) the sharded gateway at N_ACTIONS.
    def gateway(mesh):
        clock = [1_000.0]
        with manual_ids_and_time(clock):
            state = facade_state(device)
            acts = facade_actions(state, np.random.RandomState(SEED + 19))
            n = N_ACTIONS
            gw = state.check_actions_wave(acts["slots"], acts["required_rings"],
                                          np.zeros(n, bool), np.zeros(n, bool),
                                          np.zeros(n, bool), np.zeros(n, bool), now=3.0,
                                          mesh=mesh)
            return ({f: np.asarray(getattr(gw, f).cpu() if torch.is_tensor(getattr(gw, f))
                                   else getattr(gw, f)) for f in GATEWAY_LANES},
                    all_tables(state)["agents.i32"], all_tables(state)["agents.f32"])

    gw_mesh = window("gateway", lambda: gateway(mesh_devices(device)), {})
    gw_single = gateway(None)
    for f in GATEWAY_LANES:
        require(gw_mesh[0][f].tobytes() == gw_single[0][f].tobytes(),
                f"mesh (gateway): {f} differs from the single-device gateway's")
    require(gw_mesh[1].tobytes() == gw_single[1].tobytes()
            and gw_mesh[2].tobytes() == gw_single[2].tobytes(),
            "mesh (gateway): the agent table differs from the single-device gateway's")
    rec["gateway"] = {"actions": N_ACTIONS, "allowed": int((gw_mesh[0]["verdict"] == 0).sum()),
                      "single_device": "equal"}

    # (d) the consistency runtime: mixed ticks and a reconcile = all STRONG.
    def consistency(mixed: bool):
        from hypervisor_tpu_torch.config import HypervisorConfig, TableCapacity
        from hypervisor_tpu_torch.models import ConsistencyMode, SessionConfig
        from hypervisor_tpu_torch.state import HypervisorState

        state = HypervisorState(HypervisorConfig(capacity=TableCapacity(
            max_agents=1024, max_sessions=1024)), device=device)
        rng = np.random.RandomState(SEED + 20)
        modes = rng.randint(0, 2, MESH_TICK_SESSIONS)
        if not mixed:
            modes[:] = 1
        slots = [state.create_session(f"cr:s{i}", SessionConfig(
            consistency_mode=ConsistencyMode.STRONG if m else ConsistencyMode.EVENTUAL,
            min_sigma_eff=0.0, max_participants=1 << 20)) for i, m in enumerate(modes)]
        rt = ConsistencyRuntime(state, mesh_devices(device))
        for t in range(MESH_TICKS):
            lanes = np.asarray(slots, np.int32)[rng.randint(0, MESH_TICK_SESSIONS,
                                                            MESH_TICK_LANES)]
            bodies = rng.randint(0, 2**32, (N_DELTAS, MESH_TICK_LANES, 16),
                                 dtype=np.uint64).astype(np.uint32)
            rt.tick(lanes, rng.uniform(0.3, 1.0, MESH_TICK_LANES).astype(np.float32),
                    rng.uniform(size=MESH_TICK_LANES) > 0.1, bodies)
        pending = rt.has_pending
        counts, sigma = rt.reconcile()
        return state.sessions.i32.cpu().numpy().copy(), pending, counts

    per_tick = {"chain_digests": MESH_SHARDS * MESH_TICKS, "tree_roots": MESH_SHARDS * MESH_TICKS}
    mixed_tab, mixed_pending, mixed_counts = window("consistency", lambda: consistency(True),
                                                    per_tick)
    strong_tab, strong_pending, _ = consistency(False)
    require(mixed_pending and not strong_pending,
            "mesh (consistency): only the mixed run defers EVENTUAL partials")
    require(np.array_equal(mixed_tab[:, 2], strong_tab[:, 2]),
            "mesh (consistency): mixed ticks and a reconcile differ from all-STRONG")
    rec["consistency"] = {"lanes": MESH_TICK_LANES, "sessions": MESH_TICK_SESSIONS,
                          "ticks": MESH_TICKS, "eventual_reconciled": int(mixed_counts.sum()),
                          "all_strong": "equal"}

    # (e) the sharded cascade at NORTH_STAR's shape against B8.
    rng = np.random.RandomState(SEED + 21)
    v, sigma, first = slash_graph(rng, NORTH_STAR["agents"], NORTH_STAR["edges"],
                                  NORTH_STAR["seeds"], NORTH_STAR["sigma"], 1, device)
    sharded = window("slash", lambda: coll.sharded_slash(mesh_devices(device))(
        v, sigma, first, 0, NORTH_STAR["omega"], 1.0), {})
    single = liability.slash_cascade(v, sigma, first, 0, NORTH_STAR["omega"], 1.0)
    for f in ("sigma", "slashed", "clipped", "wave_of"):
        require(torch.equal(getattr(sharded, f), getattr(single, f)),
                f"mesh (slash): {f} differs from the single-device cascade's")
    require(torch.equal(sharded.vouch.active, single.vouch.active),
            "mesh (slash): the released bonds differ from the single-device cascade's")
    rec["slash"] = {"slashed": int(sharded.slashed.sum()), "clipped": int(sharded.clipped.sum()),
                    "single_device": "equal"}

    # (f) the turn-sharded chain against B2's one chain and hashlib.
    rng = np.random.RandomState(SEED + 22)
    t, lanes = MESH_CHAIN["turns"], MESH_CHAIN["lanes"]
    bodies = rng.randint(0, 2**32, (t, lanes, 16), dtype=np.uint64).astype(np.uint32)
    seed = rng.randint(0, 2**32, (lanes, 8), dtype=np.uint64).astype(np.uint32)
    from hypervisor_tpu_torch import u32

    bt, st = u32.from_numpy_u32(bodies, device), u32.from_numpy_u32(seed, device)
    chained = window("chain", lambda: coll.sharded_chain(mesh_devices(device))(bt, st),
                     {"chain_digests": MESH_SHARDS})
    one = merkle_ops.chain_digests(bt, st)
    require(torch.equal(chained, one), "mesh (chain): the sharded chain differs from B2's")
    heads = u32.to_numpy_u32(chained[-1])
    for lane in range(lanes):
        parent = seed[lane].astype(">u4").tobytes()
        for turn in range(t):
            parent = hashlib.sha256(bodies[turn, lane].astype(">u4").tobytes() + parent).digest()
        require(heads[lane].astype(">u4").tobytes() == parent,
                f"mesh (chain): lane {lane}'s head differs from hashlib's")
    rec["chain"] = {**MESH_CHAIN, "single_chain": "equal", "heads": "equal to hashlib"}

    total: dict = {}
    for counts in rec["windows"].values():
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    rec["window"] = total
    if on_card:
        rec["timing"] = time_mesh_waves(device)
    return rec


# ── phases lint and examples ─────────────────────────────────────────

#: Kernels Tier B's programs launch on the card: the wave's five, the
#: tenant wave's four forms, the saga round and the slash cascade.
LINT_KERNELS = ("contribution_toward", "admission_block", "fsm_saga_block",
                "chain_digests_ring", "tree_roots", "contribution_toward_tenants",
                "admission_block_tenants", "fsm_saga_block_tenants",
                "chain_digests_ring_tenants", "saga_tick_block", "slash_cascade")


def run_lint_phase(device) -> dict:
    """Phase lint: hvlint over the port. Tier A over the port tree, then
    Tier B on `device` (on the card: every program under
    `torch.cuda.set_sync_debug_mode("error")`, the version-counter check
    over every in-place wrapper, the one-program check). Any unsuppressed
    finding fails the phase. Tier B's kernel launches are its window."""
    import torch

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.analysis import cli as hv_cli
    from hypervisor_tpu_torch.analysis.dispatch_lint import PROGRAMS
    from hypervisor_tpu_torch.analysis.rules_ast import PortProject, derive_inplace_wrappers

    reports = {}
    walls = {}
    t0 = time.perf_counter()
    reports["a"] = hv_cli.run(tier="a")
    walls["tier_a_s"] = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reports["b"] = hv_cli.run(tier="b", device=str(device))
    walls["tier_b_s"] = time.perf_counter() - t0
    window = kernels.launch_counts()
    for tier, rep in reports.items():
        open_findings = [f for f in rep["findings"] if not f["suppressed"]]
        require(not open_findings,
                f"lint: tier {tier.upper()} has unsuppressed findings: {open_findings}")
    b = reports["b"]
    require(b["tier_b_programs"] == [name for name, _, _ in PROGRAMS],
            f"lint: tier B ran {b['tier_b_programs']}")
    require(b["tier_b_device"] == str(torch.device(device)),
            f"lint: tier B ran on {b['tier_b_device']}, not {device}")
    package = hv_cli.default_package_dir()
    inplace = sorted(n for _, n, _ in derive_inplace_wrappers(PortProject.load(package)))
    require(all(b["tier_b_inplace_writes"].get(n) for n in inplace),
            f"lint: an in-place wrapper wrote nothing: {b['tier_b_inplace_writes']}")
    if torch.device(device).type == "cuda":
        require(all(window[k] for k in LINT_KERNELS),
                f"lint: tier B's programs must launch {LINT_KERNELS}: {window}")
    return {
        "counts": {tier: rep["counts"] for tier, rep in reports.items()},
        "suppressed": [f"{f['rule']} {f['file']} ({f['anchor']})"
                       for rep in reports.values() for f in rep["findings"] if f["suppressed"]],
        "files_analyzed": reports["a"]["files_analyzed"],
        "programs": b["tier_b_programs"], "device": b["tier_b_device"],
        "inplace_wrappers": {n: b["tier_b_inplace_writes"][n] for n in inplace},
        "ms": {"tier_a": reports["a"]["tier_a_ms"], "tier_b": b["tier_b_ms"]},
        **walls, "window": window,
    }


#: (name, module, argv): each example once, as a user runs it.
EXAMPLE_RUNS = (
    ("demo", "hypervisor_tpu_torch.examples.demo", []),
    ("multichip", "hypervisor_tpu_torch.examples.multichip", []),
    ("hv_top", "hypervisor_tpu_torch.examples.hv_top", ["--sessions", "64"]),
    ("metrics_watch", "hypervisor_tpu_torch.examples.metrics_watch", ["--sessions", "64"]),
    ("trace_watch", "hypervisor_tpu_torch.examples.trace_watch", ["--sessions", "16"]),
)
#: Panels masked in an example's card-against-CPU comparison: the timing
#: panels and the compile panel, whose counts of novel signatures depend
#: on what this process dispatched before (ROADMAP C.2).
EXAMPLE_PANELS = ("stage latency", "watchdog", "slo ", "roofline", "compiles ")
#: Kernels the examples launch on the card: the pipeline's B2 and B3, the
#: device plane's wave, the saga rounds, the facade's slash cascade.
EXAMPLE_KERNELS = ("chain_digests", "tree_roots", "contribution_toward", "admission_block",
                   "fsm_saga_block", "chain_digests_ring", "saga_tick_block", "slash_cascade")


def run_examples(device, workdir: str) -> dict:
    """Every `EXAMPLE_RUNS` entry on `device`, each under one set of
    manual ids and clock, its standard output captured; returns
    {name: (text, wall_s)}."""
    import importlib
    import io

    from hypervisor_tpu_torch.core import Hypervisor
    from hypervisor_tpu_torch.testing.compare import recompile_events_off

    out = {}
    for name, module, argv in EXAMPLE_RUNS:
        extra = ["--out", os.path.join(workdir, "trace.json")] if name == "trace_watch" else []
        buf = io.StringIO()
        # A recompile event on a facade's bus counts what this process
        # dispatched before (ROADMAP C.2): kept off, as in every rerun.
        with manual_ids_and_time([1_700_000_000.0]), recompile_events_off(Hypervisor):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = importlib.import_module(module).main([*argv, *extra, "--device", str(device)])
            wall = time.perf_counter() - t0
        require(rc in (0, None), f"examples: {name} exited {rc}")
        out[name] = (buf.getvalue(), wall)
    return out


def run_examples_phase(device, workdir: str) -> dict:
    """Phase examples: `demo`, `multichip` (its virtual mesh of 8 shards
    of the card), `hv_top` in-process once, one refresh of
    `metrics_watch` and one run of `trace_watch` on `device`, then the
    same on the CPU; each example's output equal to its CPU run's line
    for line (tolerance 0) once `testing.compare.masked_output` masks
    timings, clock stamps, the device's names and the timing and compile
    panels. The watchdog stays unarmed (its deadlines are each run's own
    stage times). The card runs' kernel launches are the window."""
    import torch

    from hypervisor_tpu_torch import kernels
    from hypervisor_tpu_torch.testing.compare import masked_output

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    names = (torch.cuda.get_device_name(dev), str(dev), "cuda") if on_card else ("cpu",)
    saved = os.environ.get("HV_WATCHDOG_MIN_SAMPLES")
    os.environ["HV_WATCHDOG_MIN_SAMPLES"] = str(1 << 62)
    try:
        kernels.reset_launch_counts()
        runs = run_examples(dev, workdir)
        if on_card:
            torch.cuda.synchronize(dev)
        window = kernels.launch_counts()
        cpu_runs = run_examples("cpu", workdir) if on_card else runs
    finally:
        if saved is None:
            os.environ.pop("HV_WATCHDOG_MIN_SAMPLES", None)
        else:
            os.environ["HV_WATCHDOG_MIN_SAMPLES"] = saved
    lines = {}
    for name, (text, _) in runs.items():
        got = masked_output(text, names, panels=EXAMPLE_PANELS)
        want = masked_output(cpu_runs[name][0], ("cpu",), panels=EXAMPLE_PANELS)
        at = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
                  min(len(got), len(want)))
        require(got == want, f"examples: {name} on {dev} differs from its CPU run at line "
                             f"{at}: {got[at:at + 1]} against {want[at:at + 1]}")
        lines[name] = len(got)
    demo = runs["demo"][0]
    require("4096/4096 sessions completed the full pipeline" in demo
            and demo.rstrip().endswith("All demos complete."), "examples: the demo did not finish")
    require(runs["multichip"][0].rstrip().endswith("multichip walkthrough complete."),
            "examples: the multichip walkthrough did not finish")
    if on_card:
        require(all(window[k] for k in EXAMPLE_KERNELS),
                f"examples: the card runs must launch {EXAMPLE_KERNELS}: {window}")
    return {
        "walls_s": {name: wall for name, (_, wall) in runs.items()},
        "cpu_walls_s": {name: wall for name, (_, wall) in cpu_runs.items()} if on_card else None,
        "lines_compared": lines, "window": window,
        "demo_pipeline_line": next(l for l in demo.splitlines() if "4096/4096" in l),
    }


def first_difference(label, got, want):
    """The first path where two records differ, or None."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            return f"{label}: keys differ"
        for key in want:
            found = first_difference(f"{label}.{key}", got[key], want[key])
            if found:
                return found
        return None
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        same = got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
        return None if same else label
    if isinstance(want, (list, tuple)):
        if type(got) is not type(want) or len(got) != len(want):
            return label
        for i, (g, w) in enumerate(zip(got, want)):
            found = first_difference(f"{label}[{i}]", g, w)
            if found:
                return found
        return None
    return None if got == want else label


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    require(set(args) <= {"--blocks"}, f"unknown arguments {args}")
    blocks_only = "--blocks" in args

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from hypervisor_tpu_torch import kernels, u32
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig, TableCapacity
    from hypervisor_tpu_torch.integrity.scrubber import MerkleScrubber
    from hypervisor_tpu_torch.kernels import _build, mtu, wave
    from hypervisor_tpu_torch.kernels import liability as liab_kernels
    from hypervisor_tpu_torch.kernels import saga as saga_kernels
    from hypervisor_tpu_torch.kernels import sha256 as sha_kernels
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.ops import liability, merkle, pipeline, saga_ops
    from hypervisor_tpu_torch.ops.admission import ADMIT_OK, f32_scalar
    from hypervisor_tpu_torch.ops.sha256 import digests_to_hex, pad_messages_np
    from hypervisor_tpu_torch import state as state_mod
    from hypervisor_tpu_torch.state import HypervisorState
    from hypervisor_tpu_torch.tables.logs import DeltaLog
    from hypervisor_tpu_torch.tables.state import FLAG_ACTIVE, VouchTable
    from hypervisor_tpu_torch.tables.struct import clone, copy_into, tensors

    dev = torch.device("cuda", 0)

    # ── 1. device ────────────────────────────────────────────────────
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # ── 2. build ─────────────────────────────────────────────────────
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: re.findall(r"(?:Compiling entry function '(\w+)'|(Used \d+ registers[^\n]*))", log)
        for name, log in reports.items()
    }
    spills = {
        fn: (int(stores), int(loads))
        for log in reports.values()
        for fn, stores, loads in re.findall(
            r"Function properties for (\w+)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads", log)
    }
    redesigned = {fn: st for fn, st in spills.items() if any(k in fn for k in REDESIGNED_KERNELS)}
    if not blocks_only:  # --blocks also times trees that predate some of these kernels
        require(len(redesigned) >= len(REDESIGNED_KERNELS),
                f"ptxas reported no spill line for some redesigned kernel: {sorted(redesigned)}")
        require(all(st == (0, 0) for st in redesigned.values()),
                f"a redesigned kernel spills: {redesigned}")
    emit("build", seconds=round(build_s, 3),
         ptxas={k: [a or b for a, b in v] for k, v in ptxas.items()},
         spills_stores_loads=spills, redesigned_without_spills=sorted(redesigned))

    # ── helpers ──────────────────────────────────────────────────────
    def bits(t):
        if t.dtype == torch.float32:
            return t.view(torch.int32)
        if t.dtype == torch.bool:
            return t.to(torch.uint8)
        return t

    def same(a, b) -> bool:
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))

    def max_abs_err(pairs, words=()) -> float:
        """Largest |kernel - plain| over named tensor pairs; u32 words
        (the names in `words`) compare as unsigned values."""
        err = 0.0
        for name, (a, b) in pairs.items():
            if name in words:
                d = (u32.widen(a) - u32.widen(b)).abs()
            elif a.dtype == torch.float32:
                d = (a.double() - b.double()).abs()
            else:
                d = (a.long() - b.long()).abs()
            if d.numel():
                err = max(err, float(d.max()))
        return err

    def check_pairs(name: str, pairs: dict, words=()) -> float:
        for col, (a, b) in pairs.items():
            require(same(a, b), f"{name}: kernel and plain version differ in {col}")
        return max_abs_err(pairs, words)

    def table_pairs(prefix: str, a, b) -> dict:
        ta, tb = tensors(a), tensors(b)
        return {f"{prefix}.{k}": (ta[k], tb[k]) for k in ta}

    def time_device(fn, reset=None, reps=KERNEL_REPS, warmup=2, sleep_cycles=2_000_000):
        """Median device milliseconds of one call, from CUDA events. A
        busy-wait kernel queued first keeps the card busy while the host
        enqueues the call, so the events bracket device work, not host
        launch overhead; `reset` restores in-place inputs, untimed."""
        pairs = []
        for i in range(warmup + reps):
            if reset is not None:
                reset()
            torch.cuda._sleep(sleep_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            if i >= warmup:
                pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    # ── bench.py's state ─────────────────────────────────────────────
    config = HypervisorConfig(capacity=TableCapacity(
        max_agents=max(DEFAULT_CONFIG.capacity.max_agents, N_SESSIONS + N_VOUCHED + 64),
        max_sessions=max(16_384, N_SESSIONS + 64),
        max_vouch_edges=DEFAULT_CONFIG.capacity.max_vouch_edges,
    ))
    state = HypervisorState(config, device=dev)
    session_slots = state.create_sessions_batch(
        [f"bench:s{i}" for i in range(N_SESSIONS)], SessionConfig(min_sigma_eff=0.0)
    )
    dids = [f"did:bench:{i}" for i in range(N_SESSIONS)]
    agent_slots = np.arange(N_SESSIONS, dtype=np.int32)
    v = state.vouches
    v.voucher[:N_VOUCHED] = torch.arange(N_SESSIONS, N_SESSIONS + N_VOUCHED, device=dev)
    v.vouchee[:N_VOUCHED] = torch.from_numpy(agent_slots[:N_VOUCHED]).to(dev)
    v.session[:N_VOUCHED] = torch.from_numpy(session_slots[:N_VOUCHED]).to(dev)
    v.bond[:N_VOUCHED] = 0.30
    v.active[:N_VOUCHED] = True
    rng = np.random.RandomState(SEED)
    sigma = np.full(N_SESSIONS, 0.8, np.float32)
    sigma[:N_VOUCHED] = 0.50
    bodies = rng.randint(0, 2**32, (N_DELTAS, N_SESSIONS, 16), dtype=np.uint64).astype(np.uint32)
    lanes = state.stage_wave(agent_slots, dids, session_slots, sigma, bodies)
    require(lanes["unique_sessions"] and lanes["wave_range"] == (0, N_SESSIONS),
            "bench staging must take the unique-sessions, wave-range layout")
    live = {"agents": state.agents, "sessions": state.sessions, "vouches": state.vouches,
            "metrics": state.metrics.table}
    pristine = {k: clone(t) for k, t in live.items()}

    def restore(dst: dict, src: dict) -> None:
        for k, t in src.items():
            copy_into(dst[k], t)

    n_cap = state.agents.i32.shape[0]
    slot_t, sess_t = lanes["slot"], lanes["session_slot"]
    target = torch.full((n_cap,), -2, dtype=torch.int32, device=dev)
    target[slot_t.long()] = sess_t
    contribution = liability.contribution_toward(
        state.vouches, target, f32_scalar(0.0, dev))[slot_t.long()]
    # ── B4's three layouts and B5's two forms at the op wave's inputs ─
    # (a) unique: bench.py's lanes, one a session; (b) crowded: half the
    # lanes over 2,000 sessions and half over 10, with a sigma floor on
    # some sessions, some not open, untrusted and duplicate lanes; (c)
    # shared: lane i joins session i mod 2,500, four a session, every lane
    # otherwise admissible.
    lay_rng = np.random.RandomState(SEED + 8)
    bursts, trust_cfg = DEFAULT_CONFIG.rate_limit.ring_bursts, DEFAULT_CONFIG.trust
    adm_args = (slot_t, lanes["did"], sess_t, lanes["sigma_raw"], contribution, OMEGA,
                lanes["trustworthy"], lanes["duplicate"], 0.0, bursts, trust_cfg)
    crowded = clone(pristine["sessions"])
    crowded.f32[:2000:7, 0] = 0.7          # a sigma floor on some sessions
    crowded.i32[1990:2000, 3] = 0          # some sessions not open yet
    c_sess = np.where(lay_rng.uniform(size=N_SESSIONS) < 0.5,
                      lay_rng.randint(0, 2000, N_SESSIONS), lay_rng.randint(0, 10, N_SESSIONS))
    c_args = (slot_t, lanes["did"], torch.from_numpy(c_sess.astype(np.int32)).to(dev),
              torch.from_numpy(lay_rng.uniform(0.2, 1.0, N_SESSIONS).astype(np.float32)).to(dev),
              contribution, OMEGA,
              torch.from_numpy(lay_rng.uniform(size=N_SESSIONS) > 0.1).to(dev),
              torch.from_numpy(lay_rng.uniform(size=N_SESSIONS) > 0.9).to(dev), 3.0,
              bursts, trust_cfg)
    s_args = (slot_t, lanes["did"],
              torch.arange(N_SESSIONS, dtype=torch.int32, device=dev) % N_SHARED_SESSIONS,
              lanes["sigma_raw"], contribution, OMEGA,
              torch.ones(N_SESSIONS, dtype=torch.bool, device=dev),
              torch.zeros(N_SESSIONS, dtype=torch.bool, device=dev), 0.0, bursts, trust_cfg)
    # (d) the join queue's form, no contribution (sigma_eff is sigma_raw),
    # on the crowded wave with sigma's edge values; (e) a join flush padded
    # from 7,000 lanes to an 8,192 bucket: pad lanes at slot 0, session 0,
    # duplicate and untrusted, several on one slot.
    edge_sigma = c_args[3].clone()
    edge_sigma[:40] = torch.tensor([-0.0, 0.0, 1.5, float("nan"), 1e-42] * 8)
    nc_args = c_args[:3] + (edge_sigma, None, 0.0) + c_args[6:]
    n_pad = JOIN_BUCKET - N_CROWDED

    def padded(t, fill):
        return torch.cat([t[:N_CROWDED], torch.full((n_pad,), fill, dtype=t.dtype, device=dev)])

    pad_args = (padded(c_args[0], 0), padded(c_args[1], -1), padded(c_args[2], 0),
                padded(edge_sigma, 0.0), None, 0.0, padded(c_args[6], False),
                padded(c_args[7], True)) + c_args[8:]
    layouts = {"unique": (adm_args, True, pristine["sessions"]),
               "crowded": (c_args, False, crowded),
               "shared": (s_args, False, pristine["sessions"]),
               "crowded, no contribution": (nc_args, False, crowded),
               "padded join flush": (pad_args, False, crowded)}
    # B5 runs on the tables the unique admission leaves: its range form on
    # the wave's arange(0, 10,000), its mask form on the same sessions and
    # on 10,000 sessions drawn without replacement from the table's 16,384
    # rows, unsorted.
    post = {"agents": clone(pristine["agents"]), "sessions": clone(pristine["sessions"]),
            "vouches": clone(pristine["vouches"])}
    status_m, _, _ = wave.admission_block(post["agents"], post["sessions"], *adm_args, True)
    ok_m = status_m == ADMIT_OK
    ks_t = lanes["wave_sessions"]
    s_cap = state.sessions.i32.shape[0]
    scattered_t = torch.from_numpy(
        lay_rng.choice(s_cap, N_SESSIONS, replace=False).astype(np.int32)).to(dev)
    fsm_forms = {"range": (ks_t, (0, N_SESSIONS)), "mask, arange": (ks_t, None),
                 "mask, scattered": (scattered_t, None)}

    # B7's timing table: the default 8,192 x 16 in every code, in place
    # (restored before each call), with the metrics counters riding in.
    saga_cap = DEFAULT_CONFIG.capacity.max_sagas
    b7_table = random_saga_table(np.random.RandomState(SEED + 11), saga_cap,
                                 DEFAULT_CONFIG.capacity.max_steps_per_saga)
    b7_pristine = {k: torch.from_numpy(np.array(b7_table[k], copy=True)).to(dev) for k in SAGA_COLS}
    b7_cols = {k: t.clone() for k, t in b7_pristine.items()}
    b7_outcomes = torch.from_numpy(saga_ops.pack_outcomes(*b7_table["masks"])).to(dev)
    b7_counters = torch.zeros(state.metrics.table.counters.shape, dtype=torch.int32, device=dev)

    def restore_b7():
        for k, t in b7_pristine.items():
            b7_cols[k].copy_(t)

    def b7_call(fn=saga_kernels.saga_tick_block):
        return fn(*(b7_cols[k] for k in SAGA_COLS), b7_outcomes, **tally_kw(fn, b7_counters))

    def barrier_probe() -> dict:
        """One grid barrier at the grid B8 takes on the slash path's
        tables: a cooperative launch that only crosses r barriers, timed
        at each r of `BARRIER_REPS` by CUDA events; the slope is one
        barrier, the intercept one cooperative launch of that grid."""
        cap = DEFAULT_CONFIG.capacity
        ms = {r: time_device(lambda r=r: liab_kernels.grid_barrier_probe(
            r, cap.max_vouch_edges, cap.max_agents, dev), reps=50) for r in BARRIER_REPS}
        slope, intercept = np.polyfit(BARRIER_REPS, [ms[r] for r in BARRIER_REPS], 1)
        return {"ms_by_barriers": ms, "barrier_us": float(slope) * 1e3,
                "intercept_us": float(intercept) * 1e3, "held_edges": liab_kernels.held_edges(dev)}

    def time_blocks(slash_inputs) -> dict:
        """B4 on each layout, B5 in each form, B7 at the default table, B8
        at the slash path's inputs (with the metrics counters) and one
        launch of a one-element add, each the median by CUDA events, the
        tables restored before every call; and the host's build of one
        clip-factor table at a tiny omega."""
        tb = {k: clone(t) for k, t in post.items()}

        def restore_into(src):
            copy_into(tb["agents"], pristine["agents"])
            copy_into(tb["sessions"], src)

        out = {"admission_block": {}, "fsm_saga_block": {}}
        for tag, (args, unique, src) in layouts.items():
            try:
                out["admission_block"][tag] = time_device(
                    lambda a=args, u=unique: wave.admission_block(tb["agents"], tb["sessions"],
                                                                  *a, u),
                    reset=lambda src=src: restore_into(src))
            except (TypeError, AttributeError) as exc:
                if not blocks_only:
                    raise
                # --blocks run in an older tree, whose B4 has no
                # no-contribution form
                out["admission_block"][tag] = f"refused: {exc}"

        def restore_post():
            for k, t in post.items():
                copy_into(tb[k], t)

        for tag, (ks, wrange) in fsm_forms.items():
            call = lambda ks=ks, wrange=wrange: wave.fsm_saga_block(  # noqa: E731
                tb["agents"], tb["sessions"], tb["vouches"], ks, ok_m, 0.0, wrange)
            try:
                out["fsm_saga_block"][tag] = time_device(call, reset=restore_post)
            except ValueError as exc:
                if not blocks_only:
                    raise
                # --blocks run in an older tree, whose B5 has no mask form
                out["fsm_saga_block"][tag] = f"refused: {exc}"
        out["saga_tick_block"] = time_device(b7_call, reset=restore_b7)
        v_, sigma_, first_, sess_ = slash_inputs
        kw = tally_kw(liab_kernels.slash_cascade, b7_counters)
        out["slash_cascade"] = time_device(lambda: liab_kernels.slash_cascade(
            v_, sigma_, first_, sess_, NORTH_STAR["omega"], 1.0, **kw))
        # The host's libm table at a tiny omega, to the card (not in an
        # older tree, under --blocks).
        if not blocks_only or hasattr(liab_kernels, "factor_table"):
            t0_ = time.perf_counter()
            liab_kernels.factor_table(np.float32(1) - np.float32(TABLE_OMEGA),
                                      DEFAULT_CONFIG.capacity.max_vouch_edges, dev)
            torch.cuda.synchronize()
            out["clip_table_build_ms"] = (time.perf_counter() - t0_) * 1e3
        one_ = torch.zeros(1, device=dev)
        out["launch_floor"] = time_device(lambda: one_.add_(1), reps=50)
        return out

    if blocks_only:
        _, _, slash_b, pre = run_slash_sequence(dev)
        _, _, saga_b, _, saga_b_initial = run_saga_sequence(dev)
        emit("path_profile", **profile_device_ops(path_calls(saga_b, saga_b_initial, slash_b, pre)),
             nvidia_smi=smi)
        first_b = torch.zeros(pre[1].sigma_eff.shape, dtype=torch.bool, device=dev)
        first_b[pre[2]] = True
        if hasattr(liab_kernels, "grid_barrier_probe"):
            emit("barrier_probe", **barrier_probe())
        emit("block_timing", ms=time_blocks((pre[0], pre[1].sigma_eff.contiguous(), first_b,
                                             pre[3])), nvidia_smi=smi)
        return 0

    # ── 3. sha_latency ───────────────────────────────────────────────
    # One warp of messages, alone on its SMSP: the time grows by one
    # compression's latency per block; the SM clock turns it into cycles
    # to hold against the round's critical path.
    lat_rng = np.random.RandomState(SEED + 5)
    lat_ms = {}
    for nb in LATENCY_BLOCKS:
        words_l = u32.from_numpy_u32(lat_rng.randint(
            0, 2**32, (LATENCY_MESSAGES, 16 * nb), dtype=np.uint64).astype(np.uint32), dev)
        require(same(sha_kernels.sha256_words(words_l, nb),
                     sha_kernels.sha256_words_plain(words_l, nb)), f"sha_latency: nb={nb} differs")
        lat_ms[nb] = time_device(lambda w=words_l, nb=nb: sha_kernels.sha256_words(w, nb), reps=50)
    slope_ms, intercept_ms = np.polyfit(LATENCY_BLOCKS, [lat_ms[nb] for nb in LATENCY_BLOCKS], 1)
    one = torch.zeros(1, device=dev)
    launch_floor_ms = time_device(lambda: one.add_(1), reps=50)  # one launch of a tiny kernel
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    emit("sha_latency", messages=LATENCY_MESSAGES, ms_by_blocks=lat_ms,
         slope_us_per_compression=float(slope_ms) * 1e3, intercept_us=float(intercept_ms) * 1e3,
         launch_floor_us=launch_floor_ms * 1e3,
         sm_clock_max_mhz=max_mhz, slope_cycles_at_max_clock=float(slope_ms) * 1e3 * max_mhz,
         critical_ops_per_compression=64 * CRITICAL_OPS_PER_ROUND,
         sass=sass_census({name: _build._target(name) for name in ("sha256", "mtu")}))
    emit("barrier_probe", **barrier_probe(), launch_floor_us=launch_floor_ms * 1e3)


    # ── 4. parity, kernel against plain, on the card ─────────────────
    def random_words(*shape, gen=None):
        return u32.from_numpy_u32((rng if gen is None else gen).randint(
            0, 2**32, shape, dtype=np.uint64).astype(np.uint32), dev)

    # The vouched contribution, every case called twice (equal to itself)
    # and held against the plain version on the CPU, which sums in edge
    # order as the reference does; where no vouchee has more than one
    # scoped edge, also against the plain version on the card (CUDA's
    # index_add_ adds in no fixed order, so there only one add can land).
    now0 = f32_scalar(0.0, dev)
    n_edges = state.vouches.session.shape[0]

    def random_vouches(n_e: int, vouchees: int):
        vt = VouchTable.create(n_e, dev)
        vt.voucher.copy_(torch.from_numpy(rng.randint(0, n_cap, n_e).astype(np.int32)))
        vt.vouchee.copy_(torch.from_numpy(rng.randint(-1, vouchees, n_e).astype(np.int32)))
        vt.session.copy_(torch.from_numpy(rng.randint(0, 8, n_e).astype(np.int32)))
        vt.bond.copy_(torch.from_numpy(rng.uniform(0, 0.4, n_e).astype(np.float32)))
        vt.active.copy_(torch.from_numpy(rng.uniform(size=n_e) > 0.1))
        vt.expiry.copy_(torch.from_numpy(rng.choice([-1.0, 5.0, np.inf], n_e).astype(np.float32)))
        return vt

    def hot_vouchee(vt, edges, slot: int, tgt):
        """`edges` of vt made live and scoped on `slot`, in a session no
        other edge names."""
        idx = torch.from_numpy(np.asarray(edges, np.int64)).to(dev)
        vt.vouchee[idx] = slot
        vt.session[idx] = 100
        vt.active[idx] = True
        vt.expiry[idx] = float("inf")
        tgt = tgt.clone()
        tgt[slot] = 100
        return vt, tgt

    multi = random_vouches(n_edges, 2000)
    m_target = torch.from_numpy(rng.randint(-2, 8, n_cap).astype(np.int32)).to(dev)
    hot4k, hot4k_t = hot_vouchee(random_vouches(n_edges, 2000),
                                 rng.choice(n_edges, 4096, replace=False), 1234, m_target)
    hot_all, hot_all_t = hot_vouchee(random_vouches(n_edges, 2000), np.arange(n_edges), 77,
                                     m_target)
    contribution_cases = {
        "wave": (state.vouches, target),
        "several vouchers": (multi, m_target),
        "none scoped": (multi, torch.full_like(m_target, -2)),
        "one vouchee holds 4,096": (hot4k, hot4k_t),
        "one vouchee holds all": (hot_all, hot_all_t),
        "65,535 edges": (random_vouches(n_edges - 1, 2000), m_target),
    }
    err_contrib, c_cases = 0.0, {}
    for tag, (vt, tgt) in contribution_cases.items():
        got_c = wave.contribution_toward(vt, tgt, now0)
        again_c = wave.contribution_toward(vt, tgt, now0)
        cpu_v = VouchTable(**{k: t.cpu() for k, t in tensors(vt).items()})
        want_c = liability.contribution_toward(cpu_v, tgt.cpu(), f32_scalar(0.0, "cpu"))
        vee_c, scoped_c = liability.scoped_edges(vt, tgt, now0)
        per_vouchee = torch.bincount(vee_c[scoped_c], minlength=1)
        pairs = {"against the CPU": (got_c.cpu(), want_c), "repeat": (again_c, got_c)}
        plain_card = liability.contribution_toward(vt, tgt, now0)
        if int(per_vouchee.max()) <= 1:
            pairs["against the card"] = (got_c, plain_card)
        err_contrib = max(err_contrib, check_pairs(f"contribution_toward, {tag}", pairs))
        c_cases[tag] = {"edges": int(vt.bond.shape[0]), "scoped_edges": int(per_vouchee.sum()),
                        "max_edges_per_vouchee": int(per_vouchee.max()),
                        "index_add_on_card_equal_to_cpu": same(plain_card.cpu(), want_c)}
    require(c_cases["several vouchers"]["max_edges_per_vouchee"] >= 3,
            "the multi-edge case needs several edges per vouchee")
    require(c_cases["none scoped"]["scoped_edges"] == 0, "the none-scoped case scopes an edge")
    require(c_cases["one vouchee holds 4,096"]["max_edges_per_vouchee"] == 4096
            and c_cases["one vouchee holds all"]["max_edges_per_vouchee"] == n_edges,
            "the hot-vouchee cases must hold 4,096 and every edge on one vouchee")
    emit("parity", kernel="contribution_toward", cases=c_cases, bit_exact=True,
         max_abs_err=err_contrib)

    # B2: chains at every shape the paths launch (the op and facade
    # waves' 3 x 10,000 and the padded 10,240 bucket, the flush's 5 x
    # 13, the full-history verify's N x 1), lanes that leave the last
    # block ragged, turns that end mid-tile, and several tiles a lane;
    # each call twice, against the plain version on the card and hashlib
    # on samples. The plain version walks T in order on the card, so the
    # longest lane (1,100 turns, three tiles of 512) is held to hashlib
    # on every turn instead.
    seeds0 = torch.zeros((N_SESSIONS, 8), dtype=torch.int32, device=dev)
    seeds_r = u32.from_numpy_u32(
        rng.randint(0, 2**32, (N_SESSIONS, 8), dtype=np.uint64).astype(np.uint32), dev)
    body_t = lanes["delta_bodies"]
    err_b2, b2_cases = 0.0, []
    chain_cases = [(body_t, seeds0, True), (body_t, seeds_r, True)]
    chain_rng = np.random.RandomState(SEED + 6)
    for t_, l_, plain_ok in ((3, FACADE_BUCKET, True), (5, N_STANDING, True), (1, 1, True),
                             (3, 1, True), (5, 1, True), (40, 1, True), (1100, 1, False),
                             (7, N_SESSIONS + 1, True), (70, 200, True)):
        chain_cases.append((random_words(t_, l_, 16, gen=chain_rng),
                            random_words(l_, 8, gen=chain_rng), plain_ok))
    for bodies_c, seeds_c, plain_ok in chain_cases:
        t_, l_ = bodies_c.shape[:2]
        got = mtu.chain_digests(bodies_c, seeds_c)
        pairs = {"repeat": (mtu.chain_digests(bodies_c, seeds_c), got)}
        if plain_ok:
            pairs["chain"] = (got, mtu.chain_digests_plain(bodies_c, seeds_c))
        err_b2 = max(err_b2, check_pairs(f"chain_digests T={t_} L={l_}", pairs, tuple(pairs)))
        got_np, b_np, s_np = (u32.to_numpy_u32(x) for x in (got, bodies_c, seeds_c))
        for lane in sorted({0, l_ - 1}):
            parent = s_np[lane].astype(">u4").tobytes()
            for turn in range(t_):
                parent = hashlib.sha256(b_np[turn, lane].astype(">u4").tobytes() + parent).digest()
                if not plain_ok or turn == t_ - 1:
                    require(digests_to_hex(got_np[turn, lane][None])[0] == parent.hex(),
                            f"chain_digests T={t_} L={l_}: lane {lane} turn {turn} != hashlib")
        b2_cases.append([t_, l_])
    emit("parity", kernel="chain_digests", shapes=b2_cases, calls_each=2,
         against=["plain on the card (but T=1100)", "hashlib"], bit_exact=True, max_abs_err=err_b2)

    # B3: roots at the wave's shape, with the last warp ragged (S =
    # 10,001 and 1), then every count 0..P on both sides of the packed
    # kernel's P = 64 switch and at 4096; each call twice.
    chain0 = mtu.chain_digests_plain(body_t, seeds0)
    leaves = torch.zeros((N_SESSIONS, 4, 8), dtype=torch.int32, device=dev)
    leaves[:, :N_DELTAS] = chain0.transpose(0, 1)
    counts3 = torch.full((N_SESSIONS,), N_DELTAS, dtype=torch.int32, device=dev)

    b3_cases = {"wave": (leaves, counts3)}
    for s_ in (N_SESSIONS + 1, 1):
        b3_cases[f"S={s_}"] = (random_words(s_, 4, 8),
                               torch.full((s_,), N_DELTAS, dtype=torch.int32, device=dev))
    sweeps = {p: list(range(p + 1)) for p in (1, 2, 4, 8, 16, 32, 64, 128)}
    sweeps[4096] = [0, 1, 2, 3, 5, 1000, 2049, 4095, 4096]
    for p, cnts in sweeps.items():
        b3_cases[f"P={p}"] = (random_words(len(cnts), p, 8),
                              torch.tensor(cnts, dtype=torch.int32, device=dev))
    err_b3 = 0.0
    for tag, (lv, ct) in b3_cases.items():
        got = mtu.tree_roots(lv, ct)
        err_b3 = max(err_b3, check_pairs(f"tree_roots {tag}", {
            "roots": (got, mtu.tree_roots_plain(lv, ct)),
            "repeat": (mtu.tree_roots(lv, ct), got)}, ("roots", "repeat")))
    emit("parity", kernel="tree_roots", shape=[N_SESSIONS, 4, 8], cases=sorted(b3_cases),
         packed_up_to=mtu.TREE_PACKED_MAX_LEAVES, bit_exact=True, max_abs_err=err_b3)

    # B4: admission on each layout, each call twice.
    def admission_parity(tag, args, unique, sessions_src):
        ka, ks = clone(pristine["agents"]), clone(sessions_src)
        pa, ps = clone(pristine["agents"]), clone(sessions_src)
        ra, rs = clone(pristine["agents"]), clone(sessions_src)
        got = wave.admission_block(ka, ks, *args, unique)
        want = wave.admission_block_plain(pa, ps, *args, unique)
        again = wave.admission_block(ra, rs, *args, unique)
        pairs = {"status": (got[0], want[0]), "ring": (got[1], want[1]),
                 "sigma_eff": (got[2], want[2]), "repeat": (again[0], got[0])}
        pairs.update(table_pairs("agents", ka, pa))
        pairs.update(table_pairs("sessions", ks, ps))
        pairs.update(table_pairs("agents repeat", ra, ka))
        if args[4] is None:  # no contribution: sigma_eff is sigma_raw, bit for bit
            pairs["sigma_eff = sigma_raw"] = (got[2], args[3])
        return check_pairs(f"admission_block {tag}", pairs), got[0]

    err_b4, b4_codes = 0.0, {}
    for tag, (args, unique, src) in layouts.items():
        err, status_l = admission_parity(tag, args, unique, src)
        err_b4 = max(err_b4, err)
        b4_codes[tag] = sorted(set(status_l.tolist()))
        if tag == "padded join flush":
            require(bool((status_l[N_CROWDED:] == 2).all()),
                    "B4 padded join flush: every pad lane must be refused as a duplicate")
    require(b4_codes["unique"] == [ADMIT_OK] and b4_codes["shared"] == [ADMIT_OK],
            f"the unique and shared lanes must all be admitted: {b4_codes}")
    require({0, 1, 2, 3, 4} <= set(b4_codes["crowded"]),
            f"the crowded wave must hit every status, got {b4_codes['crowded']}")
    require({0, 1, 2, 3, 4} <= set(b4_codes["crowded, no contribution"]),
            f"the no-contribution crowded wave must hit every status: {b4_codes}")
    emit("parity", kernel="admission_block", lanes=N_SESSIONS, layouts=sorted(layouts),
         codes=b4_codes, no_contribution_sigma_edges=[-0.0, 0.0, 1.5, "nan", 1e-42],
         bit_exact=True, max_abs_err=err_b4)

    # B5: fsm/saga/terminate on the post-admission tables, in the range
    # form and the mask form (which on the arange layout must also equal
    # the range form), each against the plain version on the card.
    err_b5, b5_out = 0.0, {}
    for tag, (ks, wrange) in fsm_forms.items():
        kt = {k: clone(t) for k, t in post.items()}
        pt = {k: clone(t) for k, t in post.items()}
        got = wave.fsm_saga_block(kt["agents"], kt["sessions"], kt["vouches"], ks, ok_m, 0.0,
                                  wrange)
        want = wave.fsm_saga_block_plain(pt["agents"], pt["sessions"], pt["vouches"], ks, ok_m,
                                         0.0, wrange)
        pairs = {"step": (got[0], want[0]), "wave_state": (got[1], want[1]),
                 "fsm_error": (got[2], want[2]), "released": (got[3], want[3])}
        for k in kt:
            pairs.update(table_pairs(k, kt[k], pt[k]))
        err_b5 = max(err_b5, check_pairs(f"fsm_saga_block {tag}", pairs))
        b5_out[tag] = (got, kt)
    (r_out, r_tables), (m_out, m_tables) = b5_out["range"], b5_out["mask, arange"]
    same_form = {f"out{i}": (m_out[i], r_out[i]) for i in range(4)}
    for k in r_tables:
        same_form.update(table_pairs(k, m_tables[k], r_tables[k]))
    check_pairs("fsm_saga_block mask form against the range form", same_form)
    released_by_form = {tag: int(out[3]) for tag, (out, _) in b5_out.items()}
    require(released_by_form["range"] == N_VOUCHED, "B5 parity: the wave's bonds must be released")
    emit("parity", kernel="fsm_saga_block", sessions=N_SESSIONS, lanes=N_SESSIONS,
         edges=int(state.vouches.active.shape[0]), agents=n_cap, forms=sorted(fsm_forms),
         released=released_by_form, mask_equals_range_on_arange=True, bit_exact=True,
         max_abs_err=err_b5)
    # B2's ring form (B6's work): the chain and the DeltaLog append at the
    # facade's shape, 30,000 rows into 65,536 from a cursor that makes the
    # append wrap; unpadded, then a padded 10,240-session bucket whose
    # live prefix is the 30,000 rows, then no live row at all. Held against
    # the plain pair (B2's and B6's plain versions) and, for the chain,
    # against B2's plain form (the kernel without the ring), each ring form
    # called twice from the same ring.
    c_ring = FACADE_CAPACITY["delta_log_capacity"]
    ring_cursor = 50_000
    n_rows = N_DELTAS * N_SESSIONS

    def random_ring():
        log = DeltaLog.create(c_ring, dev)
        log.body.copy_(random_words(c_ring, 16))
        log.digest.copy_(random_words(c_ring, 8))
        log.session.copy_(torch.from_numpy(rng.randint(-1, 30_000, c_ring).astype(np.int32)))
        log.turn.copy_(torch.from_numpy(rng.randint(0, 3, c_ring).astype(np.int32)))
        log.cursor.fill_(ring_cursor)
        return log

    err_ring, ring_inputs = 0.0, {}
    for k_lanes, n_live in ((N_SESSIONS, n_rows), (FACADE_BUCKET, n_rows), (N_SESSIONS, 0)):
        args = (random_words(N_DELTAS, k_lanes, 16),
                torch.zeros((k_lanes, 8), dtype=torch.int32, device=dev), None,
                torch.arange(20_000, 20_000 + k_lanes, dtype=torch.int32, device=dev),
                ring_cursor, n_live)
        base_ring = random_ring()
        got_ring, again_ring, want_ring = clone(base_ring), clone(base_ring), clone(base_ring)
        with_ring = lambda log: (args[0], args[1], log, *args[3:])  # noqa: E731
        got = mtu.chain_digests_ring(*with_ring(got_ring))
        again = mtu.chain_digests_ring(*with_ring(again_ring))
        want = mtu.chain_digests_ring_plain(*with_ring(want_ring))
        pairs = {"chain": (got, want), "chain, B2 without the ring": (
            mtu.chain_digests(args[0], args[1]), want), "chain, repeat": (again, got)}
        pairs.update(table_pairs("delta_log", got_ring, want_ring))
        pairs.update(table_pairs("delta_log repeat", again_ring, got_ring))
        err_ring = max(err_ring, check_pairs(
            f"chain_digests_ring K={k_lanes} n_live={n_live}", pairs,
            ("chain", "chain, B2 without the ring", "chain, repeat", "delta_log.body",
             "delta_log.digest")))
        require(int(got_ring.cursor) == ring_cursor + n_live, "chain_digests_ring: device cursor")
        ring_inputs[(k_lanes, n_live)] = (base_ring, args)
    emit("parity", kernel="chain_digests_ring", rows=n_rows, lanes=[N_SESSIONS, FACADE_BUCKET],
         n_live=[n_rows, 0], capacity=c_ring, cursor=ring_cursor,
         wraps=ring_cursor + n_rows > c_ring,
         against=["plain pair on the card", "B2 without the ring", "itself"],
         bit_exact=True, max_abs_err=err_ring)

    # B1: chain links (96 bytes, 2 blocks) and hex pairs (128 bytes, 3
    # blocks) at 30,000 messages, and a scrubber strip; hashlib on samples;
    # then an 8,192-leaf forest through the hex-pair levels.
    err_b1, b1_inputs = 0.0, {}
    for n_blocks, count, msg_len in ((2, n_rows, 96), (3, n_rows, 128), (2, SCRUB_BUDGET, 96)):
        msgs = rng.randint(0, 256, (count, msg_len)).astype(np.uint8)
        words_np, nb = pad_messages_np(msgs, msg_len)
        require(nb == n_blocks, "B1 parity: padding")
        words_t = u32.from_numpy_u32(words_np, dev)
        got = sha_kernels.sha256_words(words_t, n_blocks)
        err_b1 = max(err_b1, check_pairs(f"sha256_words {count}x{n_blocks}", {"digest": (
            got, sha_kernels.sha256_words_plain(words_t, n_blocks))}, ("digest",)))
        for i in (0, count // 2, count - 1):
            require(digests_to_hex(got[i:i + 1])[0] == hashlib.sha256(msgs[i].tobytes()).hexdigest(),
                    f"sha256_words: message {i} differs from hashlib")
        b1_inputs[(count, n_blocks)] = words_t
    # Then every message count around one warp and the paths' counts at
    # 1-4 blocks, two counts at 5 and 9; each call twice.
    grid_rng = np.random.RandomState(SEED + 7)
    b1_grid = [(b, nb) for b in B1_MESSAGES for nb in (1, 2, 3, 4)]
    b1_grid += [(b, nb) for b in (33, SCRUB_BUDGET) for nb in (5, 9)]
    for count, n_blocks in b1_grid:
        msg_len = 64 * n_blocks - 9
        msgs = grid_rng.randint(0, 256, (count, msg_len)).astype(np.uint8)
        words_np, nb = pad_messages_np(msgs, msg_len)
        require(nb == n_blocks, "B1 parity: padding")
        words_t = u32.from_numpy_u32(words_np, dev)
        got = sha_kernels.sha256_words(words_t, n_blocks)
        err_b1 = max(err_b1, check_pairs(f"sha256_words {count}x{n_blocks}", {
            "digest": (got, sha_kernels.sha256_words_plain(words_t, n_blocks)),
            "repeat": (sha_kernels.sha256_words(words_t, n_blocks), got)}, ("digest", "repeat")))
        for i in sorted({0, count // 2, count - 1}):
            require(digests_to_hex(got[i:i + 1])[0] == hashlib.sha256(msgs[i].tobytes()).hexdigest(),
                    f"sha256_words {count}x{n_blocks}: message {i} differs from hashlib")
    forest_t = random_words(4, BIG_TREE_LEAVES, 8)
    forest_counts = torch.tensor([0, 1, BIG_TREE_LEAVES // 2 + 1, BIG_TREE_LEAVES],
                                 dtype=torch.int32, device=dev)
    err_b1 = max(err_b1, check_pairs("merkle_root_lanes P=8192", {"roots": (
        merkle.merkle_root_lanes(forest_t, forest_counts),
        mtu.tree_roots_plain(forest_t, forest_counts))}, ("roots",)))
    emit("parity", kernel="sha256_words",
         messages=[[n_rows, 2], [n_rows, 3], [SCRUB_BUDGET, 2]] + [list(c) for c in b1_grid],
         hashlib_samples="first, middle and last of each case", tree_leaves=BIG_TREE_LEAVES,
         bit_exact=True, max_abs_err=err_b1)

    # B7: the saga round on random tables at the default 8,192 x 16, at
    # M = 4 (the byte-by-byte row path), and at a ragged G (8,191 and 33:
    # the last warp part-filled), against the plain version on the card
    # and on the CPU; all six outputs, and the metrics counters riding in
    # with the tally rows seeded at 0xFFFFFFF0, so the round's counts wrap
    # them past 2^32.
    n_counters = state.metrics.table.counters.shape[0]

    def seeded_counters(rows, d):
        c = np.zeros(n_counters, np.uint32)
        c[list(rows)] = COUNTER_SEED
        return u32.from_numpy_u32(c, d)

    err_b7, b7_inputs, wrapped = 0.0, {}, {}
    b7_cases = ((saga_cap, DEFAULT_CONFIG.capacity.max_steps_per_saga),
                (saga_cap, 4), (saga_cap - 1, 16), (33, 16))
    for g_, m in b7_cases:
        table = random_saga_table(rng, g_, m)
        outcomes = saga_ops.pack_outcomes(*table["masks"])
        runs = {}
        for where, fn, d in (("kernel", saga_kernels.saga_tick_block, dev),
                             ("plain on the card", saga_kernels.saga_tick_block_plain, dev),
                             ("plain on the CPU", saga_kernels.saga_tick_block_plain, "cpu")):
            cols = {k: torch.from_numpy(np.array(table[k], copy=True)).to(d) for k in SAGA_COLS}
            ctr = seeded_counters(saga_kernels.TALLY_ROWS, d)
            committed, exhausted = fn(*(cols[k] for k in SAGA_COLS),
                                      torch.from_numpy(outcomes).to(d), ctr)
            runs[where] = dict(zip(SAGA_OUTS, (cols["step_state"], cols["retries_left"],
                                               cols["saga_state"], cols["cursor"],
                                               committed, exhausted)), counters=ctr)
        pairs = {f"{col} against the {where}": (runs["kernel"][col].cpu(), runs[where][col].cpu())
                 for where in ("plain on the card", "plain on the CPU")
                 for col in SAGA_OUTS + ("counters",)}
        words = tuple(k for k in pairs if k.startswith("counters"))
        err_b7 = max(err_b7, check_pairs(f"saga_tick_block G={g_} M={m}", pairs, words))
        n_c, n_x = int(runs["kernel"]["committed"].sum()), int(runs["kernel"]["exhausted"].sum())
        require(n_c > 0 and n_x > 0, "B7 parity: the round must book and exhaust steps")
        got_ctr = u32.to_numpy_u32(runs["kernel"]["counters"])[list(saga_kernels.TALLY_ROWS)]
        require(got_ctr.tolist() == [(COUNTER_SEED + n_c) % 2**32, (COUNTER_SEED + n_x) % 2**32],
                f"B7 G={g_} M={m}: the tallies are not the masks' counts: {got_ctr}")
        wrapped[f"G={g_} M={m}"] = got_ctr.tolist()
        b7_inputs[(g_, m)] = (table, outcomes)
    emit("parity", kernel="saga_tick_block", shapes=[list(c) for c in b7_cases],
         counters_seeded=COUNTER_SEED, counters_after=wrapped,
         against=["plain on the card", "plain on the CPU"], bit_exact=True, max_abs_err=err_b7)

    # B8: the slash cascade, each kernel call twice (the second must give
    # the same bits: the workspace it found zero, it left zero), with the
    # metrics counters riding in (tally rows seeded at 0xFFFFFFF0) and
    # once without them, against the plain version on the card and the
    # CPU. Cases: bench_suite's north-star graph; the default tables at
    # omega 0.6, cascading to depth 2, on the current stream and on a
    # second one (its own workspace); no edges at all; a graph with more
    # edges than the grid holds in registers, so that a thread holds its
    # first edges and reloads the rest every depth; and at omega 0.014 and
    # 0.003, where the parent's float64 clip factor parted from the
    # reference's.
    err_b8, b8_cases = 0.0, {}
    cap = DEFAULT_CONFIG.capacity
    names = ("sigma", "active", "slashed", "clipped", "wave_of")
    held = liab_kernels.held_edges(dev)

    def b8_parity(tag, v_s, sigma_s, seeds_s, omega, stream=None):
        nonlocal err_b8
        rows = liab_kernels.TALLY_ROWS
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        torch.cuda.synchronize()  # the inputs are ready on every stream
        with ctx:
            runs = []
            for _ in range(2):
                ctr = seeded_counters(rows, dev)
                runs.append((liab_kernels.slash_cascade(v_s, sigma_s, seeds_s, 0, omega, 0.0,
                                                        counters=ctr), ctr))
            bare = liab_kernels.slash_cascade(v_s, sigma_s, seeds_s, 0, omega, 0.0)
        torch.cuda.synchronize()
        ctr_card = seeded_counters(rows, dev)
        card = liab_kernels.slash_cascade_plain(v_s, sigma_s, seeds_s, 0, omega, 0.0,
                                                counters=ctr_card)
        ctr_cpu = seeded_counters(rows, "cpu")
        cpu = liab_kernels.slash_cascade_plain(
            VouchTable(**{k: t.cpu() for k, t in tensors(v_s).items()}), sigma_s.cpu(),
            seeds_s.cpu(), 0, omega, 0.0, counters=ctr_cpu)
        got = runs[0][0]
        pairs = {f"{name} against the {where}": (got[i].cpu(), other[i].cpu())
                 for where, other in (("plain on the card", card), ("plain on the CPU", cpu),
                                      ("second call", runs[1][0]), ("call without counters", bare))
                 for i, name in enumerate(names)}
        for where, ctr in (("plain on the card", ctr_card), ("plain on the CPU", ctr_cpu),
                           ("second call", runs[1][1])):
            pairs[f"counters against the {where}"] = (runs[0][1].cpu(), ctr.cpu())
        words = tuple(k for k in pairs if k.startswith("counters"))
        err_b8 = max(err_b8, check_pairs(f"slash_cascade {tag}", pairs, words))
        n_s, n_c = int(got[2].sum()), int(got[3].sum())
        tallies = u32.to_numpy_u32(runs[0][1])[list(rows)].tolist()
        require(tallies == [(COUNTER_SEED + n_s) % 2**32, (COUNTER_SEED + n_c) % 2**32],
                f"B8 {tag}: the tallies are not the slashed and clipped counts: {tallies}")
        b8_cases[tag] = {"agents": int(sigma_s.shape[0]), "edges": int(v_s.voucher.shape[0]),
                         "slashed": n_s, "clipped": n_c, "depth_reached": int(got[4].max()),
                         "counters_after": tallies}
        return got

    for tag, n_a, n_e, cfg, sessions in (
            ("north_star", NORTH_STAR["agents"], NORTH_STAR["edges"], NORTH_STAR, 1),
            ("default", cap.max_agents, cap.max_vouch_edges, DEFAULT_SLASH, 2),
            ("past the held edges", cap.max_agents, held + cap.max_vouch_edges, DEFAULT_SLASH, 2)):
        v_s, sigma_s, seeds_s = slash_graph(np.random.RandomState(SEED), n_a, n_e, cfg["seeds"],
                                            cfg["sigma"], sessions, dev)
        got = b8_parity(tag, v_s, sigma_s, seeds_s, cfg["omega"])
        require(int(got[4].max()) == 2, f"B8 parity {tag}: the cascade must reach depth 2")
        if tag == "default":
            side = torch.cuda.Stream()
            got_side = b8_parity("default, second stream", v_s, sigma_s, seeds_s, cfg["omega"],
                                 stream=side)
            require(all(same(a, b) for a, b in zip(got, got_side)),
                    "B8: the second stream's cascade differs from the first's")
    v_0, sigma_0, seeds_0 = slash_graph(np.random.RandomState(SEED), cap.max_agents, 0,
                                        DEFAULT_SLASH["seeds"], DEFAULT_SLASH["sigma"], 1, dev)
    got = b8_parity("no edges", v_0, sigma_0, seeds_0, DEFAULT_SLASH["omega"])
    require(same(got[2], seeds_0) and not bool(got[3].any()),
            "B8 with no edges must slash the seeds and clip nobody")
    # One voucher, at sigma 0.9, vouching for k first-wave agents in the
    # slashed session.
    parted = {}
    for omega_p, k_p in PARTED_CLIPS:
        v_p, sigma_p, seeds_p = slash_graph(np.random.RandomState(SEED + 10), cap.max_agents,
                                            cap.max_vouch_edges, DEFAULT_SLASH["seeds"],
                                            DEFAULT_SLASH["sigma"], 2, dev)
        voucher_p = int(torch.nonzero(~seeds_p).flatten()[0])
        v_p.active[v_p.voucher == voucher_p] = False
        rows_p = torch.arange(k_p, device=dev)
        v_p.voucher[rows_p] = voucher_p
        v_p.vouchee[rows_p] = torch.nonzero(seeds_p).flatten()[:k_p].to(torch.int32)
        v_p.session[rows_p] = 0
        v_p.active[rows_p] = True
        v_p.expiry[rows_p] = float("inf")
        sigma_p[voucher_p] = 0.9
        got = b8_parity(f"omega={omega_p} k={k_p}", v_p, sigma_p, seeds_p, omega_p)
        factor = float(liab_kernels.clip_factor(torch.tensor(np.float32(1) - np.float32(omega_p)),
                                                torch.tensor(k_p)))
        require(float(got[0][voucher_p]) == float(np.float32(np.float32(0.9) * np.float32(factor))),
                f"B8 omega={omega_p}: the voucher of {k_p} seeds was not clipped by the factor")
        parted[f"omega={omega_p}, k={k_p}"] = {"factor": factor, "voucher_sigma": float(got[0][voucher_p])}
    emit("parity", kernel="slash_cascade", cases=b8_cases, parted_clips=parted,
         held_edges=held, calls_each=3, counters_seeded=COUNTER_SEED,
         against=["plain on the card", "plain on the CPU", "itself"], bit_exact=True,
         max_abs_err=err_b8)
    errs = {"contribution_toward": err_contrib, "chain_digests": err_b2, "tree_roots": err_b3,
            "admission_block": err_b4, "fsm_saga_block": err_b5,
            "chain_digests_ring": err_ring, "sha256_words": err_b1, "saga_tick_block": err_b7,
            "slash_cascade": err_b8}

    # ── 5. the full-width wave through the entry point ───────────────
    restore(live, pristine)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    result = state.governance_wave(agent_slots, dids, session_slots, sigma, bodies)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(all(launches[k] == 1 for k in OP_WAVE_KERNELS),
            f"the op wave must launch each of its kernels once: {launches}")
    check_bench_gates(result, bodies, "op wave")
    counters = u32.to_numpy_u32(result.metrics.counters)

    plain_tables = {k: clone(t) for k, t in pristine.items()}
    plain = pipeline.run_wave(pipeline.PLAIN_BLOCKS, **{**lanes, **plain_tables})
    torch.cuda.synchronize()
    pairs = {f: (getattr(result, f), getattr(plain, f)) for f in (
        "status", "ring", "sigma_eff", "saga_step_state", "merkle_root", "chain",
        "fsm_error", "released")}
    for k in plain_tables:
        pairs.update(table_pairs(k, live[k], plain_tables[k]))
    check_pairs("governance_wave", pairs)
    emit("wave", sessions=N_SESSIONS, vouched=N_VOUCHED, deltas=N_DELTAS,
         launches={k: launches[k] for k in OP_WAVE_KERNELS},
         gates="passed", hashlib_lanes=[0, N_SESSIONS - 1], plain_on_card="identical",
         counters={"wave_ticks": int(counters[0]), "admitted": int(counters[1]),
                   "refused": int(counters[2]), "archived": int(counters[3]),
                   "bonds_released": int(counters[4]), "saga_committed": int(counters[5]),
                   "saga_failed": int(counters[6])})

    # ── 6. the facade's lifecycle wave and audit plane ───────────────
    t0 = time.perf_counter()
    facade_rec, windows, facade = run_facade_sequence(dev)
    facade_s = time.perf_counter() - t0
    ticks_with_links = sum(1 for r in facade_rec["scrub"] if r["links"])
    expected = {
        "facade_waves": {**{k: 3 for k in FACADE_WAVE_KERNELS}, "sha256_words": 0},
        "flush": {"chain_digests": 1},
        "scrubber": {"sha256_words": ticks_with_links},
        "verify": {"chain_digests": 2, "sha256_words": 1},
        "terminate": {"tree_roots": 1},
        "big_tree": {"sha256_words": BIG_TREE_LEAVES.bit_length() - 1},
    }
    for name, want in expected.items():
        got = {k: n for k, n in windows[name].items() if n}
        require(got == {k: n for k, n in want.items() if n},
                f"{name}: launches {got}, expected {want}")
    t0 = time.perf_counter()
    cpu_rec, cpu_windows, _ = run_facade_sequence("cpu")
    cpu_s = time.perf_counter() - t0
    require(not any(any(c.values()) for c in cpu_windows.values()), "the CPU run launched a kernel")
    diff = first_difference("facade", cpu_rec, facade_rec)
    require(diff is None, f"the facade on the CPU differs from the card at {diff}")
    gauges = facade_rec["tables"]["metrics.gauges"]
    emit("facade", sessions_per_wave=N_SESSIONS, waves=3, padded_bucket=FACADE_BUCKET,
         actions_per_wave=N_ACTIONS, actors=N_ACTORS,
         verdicts_by_wave=[np.bincount(facade_rec[f"wave{w}"]["gateway"]["verdict"],
                                       minlength=6).tolist() for w in range(3)],
         breakers_tripped=[int(facade_rec[f"wave{w}"]["gateway"]["tripped"].sum())
                           for w in range(3)],
         gauges_after={"ring_agents": gauges[:4].tolist(), "agents_active": float(gauges[4]),
                       "breaker_tripped": float(gauges[6]), "sessions_live": float(gauges[7]),
                       "table_live_rows": gauges[22:30].tolist()},
         deltalog_cursor=facade._delta_cursor, deltalog_capacity=FACADE_CAPACITY["delta_log_capacity"],
         trace_cursor=facade.tracer.cursor, standing_sessions=N_STANDING,
         flushed=int(facade_rec["flush"]), scrub=facade_rec["scrub_summary"],
         scrub_ticks=len(facade_rec["scrub"]), launches_by_path=windows, gates="passed",
         hashlib_lanes_per_wave=[0, N_SESSIONS - 1], cursor_mirrors="equal",
         cpu_run="identical", card_seconds=facade_s, cpu_seconds=cpu_s)

    # ── 6b. a facade wave on a scattered session layout ──────────────
    scat_rec, scat_launches = run_scattered_facade(dev)
    require({k: n for k, n in scat_launches.items() if n} == {k: 1 for k in FACADE_WAVE_KERNELS},
            f"the scattered facade wave must launch each of its kernels once: {scat_launches}")
    cpu_scat, cpu_scat_launches = run_scattered_facade("cpu")
    require(not any(cpu_scat_launches.values()), "the scattered wave's CPU run launched a kernel")
    diff = first_difference("scattered facade", cpu_scat, scat_rec)
    require(diff is None, f"the scattered facade wave on the CPU differs from the card at {diff}")
    emit("scattered_facade", sessions=N_SESSIONS, terminated=SCATTER_GAPS, standing=SCATTER_GAPS,
         padded_bucket=FACADE_BUCKET, fsm_form="mask", launches=scat_launches, gates="passed",
         cpu_run="identical")
    windows["scattered_facade"] = scat_launches
    windows["op_wave"] = launches

    # ── 6c. one pipeline wave with all eight phases, the sanitizer on ─
    san_rec, san_launches = run_sanitized_wave(dev)
    want_san = {**{k: 1 for k in FACADE_WAVE_KERNELS}, "contribution_toward": 2}
    require({k: n for k, n in san_launches.items() if n} == want_san,
            f"the sanitized wave must launch {want_san} (the escrow is the contribution's "
            f"second launch): {san_launches}")
    cpu_san, cpu_san_launches = run_sanitized_wave("cpu")
    require(not any(cpu_san_launches.values()), "the sanitized wave's CPU run launched a kernel")
    diff = first_difference("sanitized wave", cpu_san, san_rec)
    require(diff is None, f"the sanitized wave on the CPU differs from the card at {diff}")
    emit("sanitized_wave", sessions=N_SESSIONS, actions=N_ACTIONS, launches=san_launches,
         violations=san_rec["total"], unrepairable=san_rec["unrepairable"],
         flagged={f: int((san_rec[f] != 0).sum()) for f in SANITIZER_MASKS},
         verdicts=np.bincount(san_rec["gateway"]["verdict"], minlength=6).tolist(),
         gates="passed", cpu_run="identical")
    windows["sanitized_wave"] = san_launches

    # ── 6d. the join queue and the security surface ──────────────────
    t0 = time.perf_counter()
    join_rec, join_launches, join_state = run_joins_security(dev)
    join_card_s = time.perf_counter() - t0
    require({k: n for k, n in join_launches.items() if n} == {"admission_block": 2},
            f"joins_security: B4 must launch once a flush and nothing else run: {join_launches}")
    t0 = time.perf_counter()
    cpu_join, cpu_join_launches, _ = run_joins_security("cpu")
    join_cpu_s = time.perf_counter() - t0
    require(not any(cpu_join_launches.values()), "the joins_security CPU run launched a kernel")
    diff = first_difference("joins_security", cpu_join, join_rec)
    require(diff is None, f"joins_security on the CPU differs from the card at {diff}")
    windows["joins_security"] = join_launches

    def host_times(fn, warmup=SECURITY_WARMUP, iters=SECURITY_ITERS) -> dict:
        """p50/p95 ms of `fn` on the host clock, each sample synchronised."""
        samples = []
        for i in range(warmup + iters):
            torch.cuda.synchronize()
            t = time.perf_counter_ns()
            fn()
            torch.cuda.synchronize()
            if i >= warmup:
                samples.append((time.perf_counter_ns() - t) / 1e6)
        return {"p50": float(np.percentile(samples, 50)), "p95": float(np.percentile(samples, 95)),
                "iters": iters}

    def flush_sample():
        st = HypervisorState(device=dev)
        sess = st.create_sessions_batch([f"join:s{i}" for i in range(N_JOIN_SESSIONS)],
                                        SessionConfig(max_participants=JOIN_SEATS,
                                                      min_sigma_eff=0.75))
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        enqueue_bulk(st, sess)
        t_enq = time.perf_counter_ns()
        st.flush_joins(now=1.0)
        torch.cuda.synchronize()
        return (t_enq - t) / 1e6, (time.perf_counter_ns() - t_enq) / 1e6

    flush_samples = [flush_sample() for _ in range(JOIN_WARMUP + JOIN_ITERS)][JOIN_WARMUP:]
    sec_rng = np.random.RandomState(SEED + 14)
    j_live = np.nonzero((join_state.agents.flags.cpu().numpy() & FLAG_ACTIVE) != 0)[0]
    n_agents = join_state.agents.ring.shape[0]
    perm, dup_slots = sec_rng.permutation(n_agents), sec_rng.choice(j_live, n_agents)
    gw_act = gateway_actions(sec_rng, j_live, N_ACTIONS)
    timings = {
        "enqueue_join_loop_ms": {"p50": float(np.percentile([e for e, _ in flush_samples], 50)),
                                 "p95": float(np.percentile([e for e, _ in flush_samples], 95)),
                                 "iters": JOIN_ITERS, "joins": N_JOINS},
        "flush_joins_ms": {"p50": float(np.percentile([f for _, f in flush_samples], 50)),
                           "p95": float(np.percentile([f for _, f in flush_samples], 95)),
                           "iters": JOIN_ITERS, "lanes": N_JOINS},
        "breach_sweep_tick_ms": host_times(lambda: join_state.breach_sweep_tick(now=200.0)),
        "consume_rate_unique_ms": host_times(lambda: join_state.consume_rate(perm, now=210.0)),
        "consume_rate_duplicates_ms": host_times(
            lambda: join_state.consume_rate(dup_slots, now=210.0)),
        "check_actions_wave_ms": host_times(
            lambda: join_state.check_actions_wave(**gw_act, now=220.0)),
        "elevation_tick_ms": host_times(lambda: join_state.elevation_tick(now=230.0)),
    }
    # B4 by CUDA events in the join queue's form (no contribution, two
    # launches) at flush 1's 8,192 lanes, the tables restored each call.
    b4_state = HypervisorState(device=dev)
    b4_sessions = b4_state.create_sessions_batch(
        [f"b4:s{i}" for i in range(N_JOIN_SESSIONS)],
        SessionConfig(max_participants=JOIN_SEATS, min_sigma_eff=0.75))
    b4_pristine = {k: clone(getattr(b4_state, k)) for k in ("agents", "sessions")}
    b4_lanes = (torch.arange(N_JOINS, dtype=torch.int32, device=dev),
                torch.arange(N_JOINS, dtype=torch.int32, device=dev),
                torch.from_numpy(b4_sessions[np.arange(N_JOINS) % N_JOIN_SESSIONS]).to(dev),
                torch.full((N_JOINS,), 0.8, dtype=torch.float32, device=dev), None, 0.0,
                torch.ones(N_JOINS, dtype=torch.bool, device=dev),
                torch.zeros(N_JOINS, dtype=torch.bool, device=dev), 1.0, bursts)

    def b4_reset():
        copy_into(b4_state.agents, b4_pristine["agents"])
        copy_into(b4_state.sessions, b4_pristine["sessions"])

    b4_ms = time_device(lambda: wave.admission_block(b4_state.agents, b4_state.sessions,
                                                     *b4_lanes), reset=b4_reset)
    b4_plain_ms = time_device(lambda: wave.admission_block_plain(
        b4_state.agents, b4_state.sessions, *b4_lanes), reset=b4_reset, reps=PLAIN_REPS,
        warmup=1)
    # B4's no-contribution form reads 18 B a lane (slot, did, session,
    # sigma, trustworthy, duplicate) and writes 6 (status, ring, sigma_eff);
    # each distinct session's 16 B row is read and its 4 B count written
    # once; each admitted lane writes its 117 B agent row.
    b4_reset()
    b4_ok = int((wave.admission_block_plain(b4_state.agents, b4_state.sessions, *b4_lanes)[0]
                 == ADMIT_OK).sum())
    b4_sess = int(torch.unique(b4_lanes[2]).numel())
    b4_bytes = kernel_work("admission_block", lanes=N_JOINS, admitted=b4_ok,
                           contribution=False, sessions=b4_sess)[0]
    flush2 = join_rec["flush2"]["value"]
    emit("joins_security", agents=n_agents, sessions=join_state.sessions.i32.shape[0],
         edges=join_state.vouches.active.shape[0],
         elevations=join_state.elevations.agent.shape[0],
         flush1_joins=N_JOINS, flush2_joins=N_CROWDED, flush2_bucket=JOIN_BUCKET,
         flush2_codes=flush2["codes"],
         breakers_tripped=int(join_rec["breach_sweep"]["value"]["tripped"].sum()),
         grants=N_GRANTS, grants_expired=join_rec["elevation_tick"]["value"]["expired"],
         quarantine_released=len(join_rec["quarantine"]["value"]["released"]),
         consume_allowed=[int(join_rec["consume_unique"]["value"].sum()),
                          int(join_rec["consume_duplicates"]["value"].sum())],
         gateway_verdicts=np.bincount(join_rec["gateway"]["value"]["verdict"],
                                      minlength=6).tolist(),
         terminated=N_TERMINATED, b4_launches=join_launches["admission_block"],
         launches=join_launches, timings_ms=timings,
         b4_no_contribution_two_launch={"lanes": N_JOINS, "ms": b4_ms, "plain_ms": b4_plain_ms,
                                        "bound_ms": b4_bytes / HBM_BYTES_PER_S * 1e3,
                                        "bound_by": "bytes"},
         card_seconds=join_card_s, cpu_seconds=join_cpu_s, cpu_run="identical", nvidia_smi=smi,
         clock="host, synchronised; flush_joins on a fresh state each sample")

    # ── 7. the saga plane ────────────────────────────────────────────
    saga_rec, saga_launches, saga_state, saga_s, saga_initial = run_saga_sequence(dev)
    rounds = saga_rec["rounds"]
    require({k: n for k, n in saga_launches.items() if n} == {"saga_tick_block": rounds},
            f"saga path: B7 must launch once per round ({rounds}) and nothing else: {saga_launches}")
    kinds = check_saga_outcomes(saga_rec, saga_cap)
    t0 = time.perf_counter()
    cpu_saga, cpu_saga_launches, _, cpu_saga_s, _ = run_saga_sequence("cpu")
    require(not any(cpu_saga_launches.values()), "the saga path's CPU run launched a kernel")
    diff = first_difference("saga", cpu_saga, saga_rec)
    require(diff is None, f"the saga path on the CPU differs from the card at {diff}")
    emit("saga", sagas=saga_cap, steps_per_saga=DEFAULT_CONFIG.capacity.max_steps_per_saga,
         dsl_sagas=N_DSL_SAGAS, kinds=kinds, rounds=rounds, launches=saga_launches,
         run_until_settled_s=saga_s, cpu_run_until_settled_s=cpu_saga_s,
         cpu_total_s=time.perf_counter() - t0, cursor_mirror="equal", cpu_run="identical")
    windows["saga_path"] = saga_launches

    # ── 8. the slash cascade ─────────────────────────────────────────
    slash_rec, slash_launches, slash_state, slash_pre = run_slash_sequence(dev)
    depths = DEFAULT_CONFIG.trust.max_cascade_depth + 1
    require({k: n for k, n in slash_launches.items() if n} == {"slash_cascade": 1},
            f"slash path: B8 must launch once and nothing else: {slash_launches}")
    pre_v, pre_agents, pre_vouchee, pre_sess = slash_pre
    pre_sigma = pre_agents.sigma_eff.contiguous()
    first = torch.zeros(pre_sigma.shape, dtype=torch.bool)
    first[pre_vouchee] = True
    ref = liab_kernels.slash_cascade_plain(
        VouchTable(**{k: t.cpu() for k, t in tensors(pre_v).items()}), pre_sigma.cpu(), first,
        pre_sess, NORTH_STAR["omega"], 1.0)
    require(int(ref[4].max()) == 2, "slash path: the cascade must reach depth 2")
    require(slash_rec["returned"]["slashed"] == torch.nonzero(ref[2]).flatten().tolist()
            and slash_rec["returned"]["clipped"] == torch.nonzero(ref[3]).flatten().tolist(),
            "slash path: apply_slash's lists differ from the plain cascade on the CPU")
    cpu_slash, cpu_slash_launches, _, _ = run_slash_sequence("cpu")
    require(not any(cpu_slash_launches.values()), "the slash path's CPU run launched a kernel")
    diff = first_difference("slash", cpu_slash, slash_rec)
    require(diff is None, f"the slash path on the CPU differs from the card at {diff}")
    emit("slash", agents=cap.max_agents, edges=cap.max_vouch_edges, omega=NORTH_STAR["omega"],
         slashed=len(slash_rec["returned"]["slashed"]),
         clipped=len(slash_rec["returned"]["clipped"]),
         per_depth=[int((ref[4] == d).sum()) for d in range(depths)], launches=slash_launches,
         cursor_mirror="equal", cpu_run="identical")
    windows["slash_path"] = slash_launches

    # ── 9. timing ────────────────────────────────────────────────────
    samples = []
    for i in range(WARMUP + ITERS):
        restore(live, pristine)
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        pipeline.governance_wave(**lanes)
        torch.cuda.synchronize()
        if i >= WARMUP:
            samples.append((time.perf_counter_ns() - t0) / 1e6)
    wave_device_ms = time_device(lambda: pipeline.governance_wave(**lanes),
                                 reset=lambda: restore(live, pristine), reps=10,
                                 sleep_cycles=40_000_000)
    p50, p95 = float(np.percentile(samples, 50)), float(np.percentile(samples, 95))
    emit("timing", wave_ms_p50=p50, wave_ms_p95=p95,
         per_session_us_p50=p50 * 1e3 / N_SESSIONS, per_session_us_p95=p95 * 1e3 / N_SESSIONS,
         wave_device_ms=wave_device_ms, iters=ITERS, clock="host, synchronised")

    # No host synchronisation inside the wave: torch raises on any
    # synchronising CUDA call while this mode is on.
    restore(live, pristine)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    pipeline.governance_wave(**lanes)
    torch.cuda.set_sync_debug_mode("default")

    # Where one wave's device time goes (torch.profiler, CUPTI).
    from torch.profiler import ProfilerActivity, profile

    restore(live, pristine)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        pipeline.governance_wave(**lanes)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter_ns() - t0) / 1e6
    from torch.autograd import DeviceType

    by_name = []  # device-side events only (kernels, copies, fills)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name.append((e.self_device_time_total, e.key, e.count))
    by_name.sort(reverse=True)
    admission_kernels = {stem: sum(n for _, k, n in by_name if stem in k)
                         for stem in ("admission_unique", "admission_lanes", "admission_ranked")}
    require(admission_kernels == {"admission_unique": 1, "admission_lanes": 0, "admission_ranked": 0},
            f"the op wave's admission must be one launch of the unique form: {admission_kernels}")
    busy_ms = sum(us for us, _, _ in by_name) / 1e3
    emit("profile", wall_ms=prof_wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / prof_wall_ms) if prof_wall_ms else None,
         top=[{"name": k[:80], "device_us": us, "count": n} for us, k, n in by_name[:15]],
         n_device_ops=sum(n for _, _, n in by_name), admission_launches=admission_kernels)

    # The facade wave: p50/p95 on the host clock, synchronised, each
    # sample on a fresh state built (sessions created, edges placed)
    # outside the timed window; the host share split into staging
    # (`_stage_wave_lanes`), dispatch (the fused wave's enqueue: the
    # state's `_WAVE`, the instrumented `pipeline.governance_wave` bound at
    # import, which is what runs) and audit booking (`_book_wave_audit`),
    # timed around those calls; the rest is row claims, copies to the
    # card, the wait for the device and the membership bookkeeping. Every
    # part must come out at or above zero.
    def facade_sample(profiler=None):
        with counted_trace_ids():
            st = facade_state(dev)
            wave_in = prepare_facade_wave(st, np.random.RandomState(SEED + 2), 0)
            split = {"staging": 0.0, "dispatch": 0.0, "gateway": 0.0, "epilogue": 0.0,
                     "audit_booking": 0.0}

            def timed(key, fn):
                def call(*args, **kwargs):
                    t = time.perf_counter_ns()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        split[key] += (time.perf_counter_ns() - t) / 1e6
                return call

            st._stage_wave_lanes = timed("staging", st._stage_wave_lanes)
            st._book_wave_audit = timed("audit_booking", st._book_wave_audit)
            # The gateway and the epilogue run inside the dispatch: their
            # enqueue is split out of it.
            wave_fn, gate_fn, gauge_fn = (state_mod._WAVE,
                                          pipeline.gateway_ops.check_actions,
                                          pipeline.schema.update_gauges)
            state_mod._WAVE = timed("dispatch", wave_fn)
            pipeline.gateway_ops.check_actions = timed("gateway", gate_fn)
            pipeline.schema.update_gauges = timed("epilogue", gauge_fn)
            try:
                torch.cuda.synchronize()
                with profiler if profiler is not None else contextlib.nullcontext():
                    t = time.perf_counter_ns()
                    st.run_governance_wave(wave_in[0], wave_in[1], wave_in[0], wave_in[2],
                                           wave_in[3], actions=wave_in[4])
                    torch.cuda.synchronize()
                    total = (time.perf_counter_ns() - t) / 1e6
            finally:
                state_mod._WAVE = wave_fn
                pipeline.gateway_ops.check_actions = gate_fn
                pipeline.schema.update_gauges = gauge_fn
            split["dispatch"] -= split["gateway"] + split["epilogue"]
        return total, split

    f_samples = [facade_sample() for _ in range(FACADE_WARMUP + FACADE_ITERS)][FACADE_WARMUP:]
    f_total = [t for t, _ in f_samples]
    f_rest = [t - sum(sp.values()) for t, sp in f_samples]
    f_parts = {**{k: [sp[k] for _, sp in f_samples] for k in f_samples[0][1]}, "rest": f_rest}
    negative = {k: min(v) for k, v in f_parts.items() if min(v) < 0}
    require(not negative, f"facade_timing: a part of the host split is negative: {negative}")
    f_split = {k: float(np.median(v)) for k, v in f_parts.items()}
    f_split_p95 = {k: float(np.percentile(v, 95)) for k, v in f_parts.items()}
    f_p50 = float(np.percentile(f_total, 50))
    fprof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    f_prof_wall, _ = facade_sample(fprof)  # profiles the wave alone, not the fresh state
    f_device = [e for e in fprof.key_averages() if e.device_type == DeviceType.CUDA]
    f_busy_ms = sum(e.self_device_time_total for e in f_device) / 1e3
    emit("facade_timing", wave_ms_p50=f_p50, wave_ms_p95=float(np.percentile(f_total, 95)),
         per_session_us_p50=f_p50 * 1e3 / N_SESSIONS, iters=FACADE_ITERS,
         actions=N_ACTIONS, n_device_ops=sum(e.count for e in f_device),
         top_device_ops=[{"name": e.key[:80], "device_us": e.self_device_time_total,
                          "count": e.count} for e in sorted(
                              f_device, key=lambda e: -e.self_device_time_total)[:12]],
         host_split_ms_median=f_split, host_split_ms_p95=f_split_p95, device_busy_ms=f_busy_ms,
         profiled_wall_ms=f_prof_wall, device_idle_share=1 - f_busy_ms / f_prof_wall,
         clock="host, synchronised; each sample on a fresh state")

    # One full scrubber sweep over the facade state's audit index.
    sweeper = MerkleScrubber(facade, budget=SCRUB_BUDGET)
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    n_ticks = 1
    while not sweeper.tick()["sweep_completed"]:
        n_ticks += 1
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter_ns() - t0) / 1e6
    emit("scrub_timing", sweep_ms=sweep_ms, ticks=n_ticks, budget=SCRUB_BUDGET,
         links=sweeper.links_verified, heads=sweeper.heads_verified,
         links_per_s=sweeper.links_verified / (sweep_ms / 1e3), mismatches=sweeper.mismatches)

    # The saga round at 8,192 sagas: p50/p95 on the host clock,
    # synchronised, the table restored to its created state between
    # samples and every saga's cursor step booked as a success. The host
    # split: the tick (`saga_table_tick` less its tail: B7's enqueue, its
    # tallies in the same launch), the trace stamps (`_saga_tick_tail`),
    # and the rest, which is
    # building the packed outcome bytes from the dicts, their copy to the
    # card, the trace bracket and the wait for the device.
    def restore_sagas():
        copy_into(saga_state.sagas, saga_initial)

    all_commit = {slot: True for slot in range(saga_cap)}
    round_split = {"tick_and_tail": 0.0, "trace": 0.0}

    def split_timer(key, fn):
        def call(*args, **kwargs):
            t = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                round_split[key] += (time.perf_counter_ns() - t) / 1e6
        return call

    tick_fn, tail_fn = saga_ops.saga_table_tick, saga_ops._saga_tick_tail
    samples, parts = [], []
    saga_ops.saga_table_tick = split_timer("tick_and_tail", tick_fn)
    saga_ops._saga_tick_tail = split_timer("trace", tail_fn)
    try:
        for i in range(SAGA_WARMUP + SAGA_ITERS):
            restore_sagas()
            torch.cuda.synchronize()
            round_split.update(tick_and_tail=0.0, trace=0.0)
            t0 = time.perf_counter_ns()
            saga_state.saga_round(all_commit)
            torch.cuda.synchronize()
            if i >= SAGA_WARMUP:
                total = (time.perf_counter_ns() - t0) / 1e6
                tick = round_split["tick_and_tail"] - round_split["trace"]
                parts.append({"masks_copy_and_rest": total - round_split["tick_and_tail"],
                              "tick": tick, "trace": round_split["trace"]})
                samples.append(total)
    finally:
        saga_ops.saga_table_tick, saga_ops._saga_tick_tail = tick_fn, tail_fn
    saga_device_ms = time_device(lambda: saga_state.saga_round(all_commit), reset=restore_sagas,
                                 reps=10, sleep_cycles=40_000_000)
    emit("saga_timing", sagas=saga_cap, round_ms_p50=float(np.percentile(samples, 50)),
         round_ms_p95=float(np.percentile(samples, 95)),
         host_split_ms_median={k: float(np.median([p[k] for p in parts])) for k in parts[0]},
         round_device_ms=saga_device_ms, iters=SAGA_ITERS,
         run_until_settled_s=saga_s, rounds=rounds,
         clock="host, synchronised; the table restored between samples")

    # apply_slash at the default tables: p50/p95 on the host clock,
    # synchronised, the agents and vouches restored between samples.
    def restore_slash():
        copy_into(slash_state.agents, pre_agents)
        copy_into(slash_state.vouches, pre_v)

    s_samples = []
    for i in range(SLASH_WARMUP + SLASH_ITERS):
        restore_slash()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        slash_state.apply_slash(pre_sess, pre_vouchee, NORTH_STAR["omega"], now=1.0)
        torch.cuda.synchronize()
        if i >= SLASH_WARMUP:
            s_samples.append((time.perf_counter_ns() - t0) / 1e6)
    slash_device_ms = time_device(
        lambda: slash_state.apply_slash(pre_sess, pre_vouchee, NORTH_STAR["omega"], now=1.0),
        reset=restore_slash, reps=10, sleep_cycles=40_000_000)
    emit("slash_timing", agents=cap.max_agents, edges=cap.max_vouch_edges,
         apply_slash_ms_p50=float(np.percentile(s_samples, 50)),
         apply_slash_ms_p95=float(np.percentile(s_samples, 95)),
         apply_slash_device_ms=slash_device_ms, iters=SLASH_ITERS,
         clock="host, synchronised; agents and vouches restored between samples")
    # Every device op of one saga round, one apply_slash and one B8 call.
    emit("path_profile", **profile_device_ops(path_calls(saga_state, saga_initial, slash_state,
                                                         slash_pre)))

    # ── 10. the lock and write waves ─────────────────────────────────
    from hypervisor_tpu_torch.ops import locks as lock_ops
    from hypervisor_tpu_torch.runtime.lock_wave import (
        LOCK_CONTENTION, LOCK_DEADLOCK, LOCK_GRANTED, LockWave)
    from hypervisor_tpu_torch.runtime.write_wave import WRITE_OK
    from hypervisor_tpu_torch.session.intent_locks import LockIntent

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    lock_rec, lock_card, lock_sigma = run_lock_waves(dev, [API_T0])
    write_ms: list = []
    write_rec = run_write_waves(dev, [API_T0], write_ms)
    torch.cuda.synchronize()
    lw_launches = kernels.launch_counts()
    lw_card_s = time.perf_counter() - t0
    # The lock and write waves launch none of the port's kernels; the
    # write waves' facade admits its members through B4, once a join.
    require({k: n for k, n in lw_launches.items() if n}
            == {"admission_block": WRITE_SESSIONS * WRITE_MEMBERS},
            f"locks_writes: B4 once a join and no other kernel: {lw_launches}")
    windows["locks_writes"] = lw_launches
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    cpu_lock_rec, _, _ = run_lock_waves("cpu", [API_T0])
    cpu_write_rec = run_write_waves("cpu", [API_T0])
    lw_cpu_s = time.perf_counter() - t0
    require(not any(kernels.launch_counts().values()), "the locks_writes CPU run launched a kernel")
    for label, got, want in (("lock_waves", cpu_lock_rec, lock_rec),
                             ("write_waves", cpu_write_rec, write_rec)):
        diff = first_difference(label, got, want)
        require(diff is None, f"locks_writes: the CPU replay differs from the card at {diff}")
    oracle = scc_oracle(lock_card, lock_sigma)
    require(oracle == lock_rec["deadlock_report"],
            f"locks_writes: the deadlock report {lock_rec['deadlock_report']['victim']} "
            f"disagrees with the SCC oracle {oracle['victim']}")
    lock_codes = {w: np.bincount(lock_rec[w]["status"], minlength=3).tolist()
                  for w in ("wave1", "wave2")}
    require(lock_codes["wave1"][LOCK_GRANTED] and lock_codes["wave1"][LOCK_CONTENTION],
            f"locks_writes: wave 1 must grant and contend: {lock_codes}")
    require(lock_codes["wave2"][LOCK_DEADLOCK] >= LOCK_WAVE2 // 2,
            f"locks_writes: every cycle-closing request of wave 2 must be refused: {lock_codes}")
    w_codes = write_codes(write_rec)
    require(all(w_codes), f"locks_writes: every write status must occur: {w_codes}")
    on_cycle = len(lock_rec["deadlock_report"]["on_cycle"])

    lock_rng = np.random.RandomState(SEED + 35)
    lock_agents = [f"did:l{i}" for i in range(LOCK_AGENTS)]
    intents = (LockIntent.READ, LockIntent.WRITE, LockIntent.EXCLUSIVE)
    flush_ms = []
    for i in range(LOCK_WARMUP + LOCK_ITERS):
        lw = LockWave(device=dev, max_agents=LOCK_AGENTS, max_paths=LOCK_MAX_PATHS)
        for agent, session, path, intent, step in lock_requests(lock_rng, lock_agents,
                                                                 LOCK_WAVE1):
            lw.submit(agent, session, path, intents[intent], saga_step_id=step)
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        lw.flush()
        torch.cuda.synchronize()
        if i >= LOCK_WARMUP:
            flush_ms.append((time.perf_counter_ns() - t) / 1e6)
    report_ms = []
    for i in range(SWEEP_WARMUP + SWEEP_ITERS):
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        lock_card.deadlock_report()
        torch.cuda.synchronize()
        if i >= SWEEP_WARMUP:
            report_ms.append((time.perf_counter_ns() - t) / 1e6)
    wait_t = torch.from_numpy(lock_card._wait_matrix()).to(dev)
    closure_ms = time_device(lambda: lock_ops.transitive_closure(wait_t), reps=10,
                             sleep_cycles=40_000_000)
    squarings = lock_ops.closure_squarings(LOCK_AGENTS)
    # The closure's least time: its squarings' multiply-adds (2 N^3 each)
    # at the f32 rate outside the tensor cores, against its one read of
    # the N x N 0/1 matrix (as 1-byte bools) and one write of the result.
    closure_flop_ms = squarings * 2 * LOCK_AGENTS ** 3 / F32_FLOP_PER_S * 1e3
    closure_byte_ms = 2 * LOCK_AGENTS ** 2 / HBM_BYTES_PER_S * 1e3

    def pct(v, q):
        return float(np.percentile(v, q))

    emit("locks_writes", lock_agents=LOCK_AGENTS, lock_paths=LOCK_PATHS,
         wave1_requests=LOCK_WAVE1, wave2_requests=LOCK_WAVE2, wait_cycles=LOCK_CYCLES,
         lock_codes=lock_codes, on_cycle=on_cycle,
         victim=lock_rec["deadlock_report"]["victim"], scc_oracle="equal",
         contention_points=sum(1 for c in lock_rec["contention"].values() if c > 1),
         write_sessions=WRITE_SESSIONS, writes_per_wave=WRITE_WRITES, write_codes=w_codes,
         launches={k: n for k, n in lw_launches.items() if n}, cpu_replay="identical",
         card_s=lw_card_s, cpu_replay_s=lw_cpu_s,
         lock_flush_ms={"p50": pct(flush_ms, 50), "p95": pct(flush_ms, 95),
                        "iters": LOCK_ITERS, "requests": LOCK_WAVE1},
         deadlock_report_ms={"p50": pct(report_ms, 50), "p95": pct(report_ms, 95),
                             "iters": SWEEP_ITERS, "agents": LOCK_AGENTS},
         write_flush_ms={"p50": pct(write_ms, 50), "p95": pct(write_ms, 95),
                         "samples": len(write_ms), "writes": WRITE_WRITES},
         closure_device_ms=closure_ms, closure_squarings=squarings,
         closure_bound_ms=max(closure_flop_ms, closure_byte_ms),
         closure_bound_by="operations" if closure_flop_ms >= closure_byte_ms else "bytes",
         tf32=torch.backends.cuda.matmul.allow_tf32, nvidia_smi=smi,
         clock="host, synchronised; the closure by CUDA events")

    # ── 11. the native host runtime against the kernels ──────────────
    from hypervisor_tpu_torch.audit import delta as audit_delta
    from hypervisor_tpu_torch.runtime import native

    require(native.HAVE_NATIVE, "native: the host library did not build (g++ is required)")
    kernels.reset_launch_counts()
    nat_rng = np.random.RandomState(SEED + 34)

    def nat_host_ms(fn, reps=NATIVE_REPS):
        """Median host ms of fn(), each call synchronised."""
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter_ns()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter_ns() - t) / 1e6)
        return float(np.median(samples))

    def to_bytes(words):
        return np.ascontiguousarray(np.asarray(words, np.uint32).astype(">u4")).view(
            np.uint8).reshape(words.shape[:-1] + (4 * words.shape[-1],))

    # B1: 96-byte link messages (a 64-byte body and its 32-byte parent).
    nat_links = nat_rng.randint(0, 256, (NATIVE_LINKS, 96)).astype(np.uint8)
    link_host = native.sha256_batch_host(nat_links)
    require(all(link_host[i].tobytes() == hashlib.sha256(nat_links[i].tobytes()).digest()
                for i in range(NATIVE_LINKS)), "native: sha256_batch_host differs from hashlib")
    link_words, link_blocks = pad_messages_np(nat_links, 96)
    link_t = u32.from_numpy_u32(link_words, dev)
    require(np.array_equal(to_bytes(u32.to_numpy_u32(sha_kernels.sha256_words(link_t, link_blocks))),
                           link_host), "native: sha256_batch_host differs from B1")
    # B2: 64 chains of 1,024 bodies, one digest bit tampered.
    nat_bodies = nat_rng.randint(0, 2**32, (NATIVE_TURNS, NATIVE_LANES, 16),
                             dtype=np.uint64).astype(np.uint32)
    chain_card = u32.to_numpy_u32(merkle.chain_digests(u32.from_numpy_u32(nat_bodies, dev)))
    chain_host = np.stack([native.chain_digests_host(np.ascontiguousarray(nat_bodies[:, lane]))
                           for lane in range(NATIVE_LANES)], axis=1)
    require(np.array_equal(to_bytes(chain_card), chain_host),
            "native: chain_digests_host differs from B2")
    for lane in range(NATIVE_LANES):
        parent = b"\x00" * 32
        for turn in range(NATIVE_TURNS):
            parent = hashlib.sha256(to_bytes(nat_bodies[turn, lane]).tobytes() + parent).digest()
            require(parent == chain_host[turn, lane].tobytes(),
                    f"native: chain_digests_host differs from hashlib at {turn}, {lane}")
    tamper_turn, tamper_lane = NATIVE_TURNS * 11 // 16, NATIVE_LANES * 17 // 64
    recorded = chain_card.copy()
    recorded[tamper_turn, tamper_lane, 3] ^= 1 << 9
    rec_bytes = to_bytes(recorded)
    first_bad = [native.verify_chain_host(np.ascontiguousarray(nat_bodies[:, lane]),
                                          np.ascontiguousarray(rec_bytes[:, lane]))
                 for lane in range(NATIVE_LANES)]
    want_bad = [tamper_turn if lane == tamper_lane else -1 for lane in range(NATIVE_LANES)]
    require(first_bad == want_bad, f"native: verify_chain_host misses the tampered row: {first_bad}")
    counts_v = np.full(NATIVE_LANES, NATIVE_TURNS, np.int32)
    verdict_card = merkle.verify_chain_digests_host(nat_bodies, recorded, counts_v, dev)
    verdict_cpu = merkle.verify_chain_digests_host(nat_bodies, recorded, counts_v, "cpu")
    require(verdict_card.tolist() == verdict_cpu.tolist() == [b < 0 for b in want_bad],
            "native: the chain check's C++ route and B2 disagree")
    # The big tree: B1 level by level on the card, the C++ unit, hashlib.
    nat_leaves = nat_rng.randint(0, 256, (NATIVE_LEAVES, 32)).astype(np.uint8)
    leaf_hex = [leaf.tobytes().hex() for leaf in nat_leaves]
    root_native = native.merkle_root_hex_host(nat_leaves)
    root_device = audit_delta.merkle_root_device(leaf_hex, dev)
    root_hashlib = audit_delta.merkle_root_host(leaf_hex)
    require(root_native == root_device == root_hashlib == audit_delta.merkle_root_native(leaf_hex),
            "native: merkle_root_hex_host, merkle_root_device and hashlib disagree")
    leaf_words = nat_leaves.view(">u4").astype(np.uint32)[None]
    require(np.array_equal(merkle.tree_roots_host(leaf_words, NATIVE_LEAVES, dev),
                           merkle.tree_roots_host(leaf_words, NATIVE_LEAVES, "cpu")),
            "native: tree_roots_host's C++ route and the card disagree")
    # B3: 8 lanes of 4,096 leaves (its widest tile) at mixed counts, one
    # launch, against the C++ route lane by lane and hashlib.
    tree_cnt = np.array(NATIVE_TREE_COUNTS, np.int32)
    tree_leaves = nat_rng.randint(0, 2**32, (len(tree_cnt), NATIVE_TREE_P, 8),
                                  dtype=np.uint64).astype(np.uint32)
    b3_before = kernels.launch_counts()["tree_roots"]
    tree_card = merkle.tree_roots_host(tree_leaves, tree_cnt, dev)
    require(kernels.launch_counts()["tree_roots"] == b3_before + 1,
            "native: tree_roots_host at 4,096 leaves must launch B3 once")
    require(np.array_equal(tree_card, merkle.tree_roots_host(tree_leaves, tree_cnt, "cpu")),
            "native: tree_roots_host's C++ route and B3 disagree")
    for lane, c in enumerate(NATIVE_TREE_COUNTS):
        want = (audit_delta.merkle_root_host([to_bytes(w).tobytes().hex() for w in tree_leaves[lane, :c]])
                if c > 1 else to_bytes(tree_leaves[lane, 0]).tobytes().hex())
        require(to_bytes(tree_card[lane]).tobytes().hex() == want,
                f"native: B3's root differs from hashlib in lane {lane} ({c} leaves)")
    # The scrubber on a card state takes B1 for every strip with the
    # library built; the reference's HV_SCRUB_NATIVE=1 changes nothing.
    scrub_ticks, scrub_b1 = run_native_scrub(dev)
    require(scrub_b1 == scrub_ticks > 0,
            f"native: the scrubber on the card launched B1 {scrub_b1} times in {scrub_ticks} ticks")
    # The staging queue under 8 threads, then B4's flush.
    claimed, push_ms, threaded, fallback = run_native_staging(dev)
    require(sorted(claimed) == list(range(NATIVE_JOINS)),
            "native: every staged join must claim its own queue entry")
    diff = first_difference("native_staging", threaded, fallback)
    require(diff is None, f"native: the threaded flush differs from the fallback queue's at {diff}")
    torch.cuda.synchronize()
    native_launches = kernels.launch_counts()
    windows["native"] = native_launches
    staging_codes = np.bincount(threaded["status"], minlength=5).tolist()
    require(staging_codes[0] and sum(staging_codes[1:]),
            f"native: the staged wave must admit and refuse: {staging_codes}")
    route_ms = {
        "sha256_batch_host_ms": nat_host_ms(lambda: native.sha256_batch_host(nat_links)),
        "sha256_words_ms": time_device(lambda: sha_kernels.sha256_words(link_t, link_blocks)),
        "chain_digests_host_ms": nat_host_ms(lambda: [native.chain_digests_host(
            np.ascontiguousarray(nat_bodies[:, lane])) for lane in range(NATIVE_LANES)]),
        "chain_digests_ms": time_device(lambda b=u32.from_numpy_u32(nat_bodies, dev):
                                        merkle.chain_digests(b)),
        "verify_chain_host_ms": nat_host_ms(lambda: [native.verify_chain_host(
            np.ascontiguousarray(nat_bodies[:, lane]), np.ascontiguousarray(rec_bytes[:, lane]))
            for lane in range(NATIVE_LANES)]),
        "verify_chain_digests_host_card_ms": nat_host_ms(
            lambda: merkle.verify_chain_digests_host(nat_bodies, recorded, counts_v, dev)),
        "merkle_root_hex_host_ms": nat_host_ms(lambda: native.merkle_root_hex_host(nat_leaves)),
        "merkle_root_device_ms": nat_host_ms(lambda: audit_delta.merkle_root_device(leaf_hex, dev)),
        "merkle_root_hashlib_ms": nat_host_ms(lambda: audit_delta.merkle_root_host(leaf_hex)),
        "tree_roots_host_card_ms": nat_host_ms(
            lambda: merkle.tree_roots_host(tree_leaves, tree_cnt, dev)),
        "tree_roots_host_cpp_ms": nat_host_ms(
            lambda: merkle.tree_roots_host(tree_leaves, tree_cnt, "cpu")),
        "staging_push_8_threads_ms": push_ms,
    }
    queue_ms = time_staging_queues(dev)
    emit("native", have_native=True, library=native.library_path().name,
         links=NATIVE_LINKS, chains=[NATIVE_LANES, NATIVE_TURNS], leaves=NATIVE_LEAVES,
         tampered=[tamper_turn, tamper_lane], joins=NATIVE_JOINS, threads=NATIVE_THREADS,
         staging_codes=staging_codes, fallback_queue="identical",
         tree_lanes=list(NATIVE_TREE_COUNTS), scrub_ticks=scrub_ticks,
         launches={k: n for k, n in native_launches.items() if n}, ms=route_ms,
         staging_queues_ms={form: {k: {"median": float(np.median(v)), "samples": v}
                                   for k, v in m.items()} for form, m in queue_ms.items()},
         nvidia_smi=smi,
         clock="host ms: median of %d, synchronised; kernel ms: CUDA events" % NATIVE_REPS)

    # ── 12. the facade's public API ──────────────────────────────────
    # After the other profiles: this one records ~100,000 device events.
    t0 = time.perf_counter()
    api_rec, api_launches, api_times, api_census = run_facade_api(
        dev, [(0, API_REPLAY), (API_REPLAY, API_SESSIONS)], census_block=(0, API_REPLAY))
    api_card_s = time.perf_counter() - t0
    # A block's first terminate flushes every delta its sessions staged:
    # one chain launch a block, a lane per session.
    api_want = {"admission_block": API_SESSIONS * API_MEMBERS,
                "chain_digests": 2,
                "tree_roots": sum(1 for s in range(API_SESSIONS) if s % 64 == 63),
                "slash_cascade": sum(1 for s in range(API_SESSIONS) if s % 64 == 5)}
    require({k: n for k, n in api_launches.items() if n} == api_want,
            f"facade_api: B4 once a join, B2 once a block, B3 once a long session's "
            f"host root, B8 once a slash, and nothing else: {api_launches}")
    api_kernels = {"admission_block": "admission_", "chain_digests": "chain_kernel",
                   "tree_roots": "tree_", "slash_cascade": "slash_cascade_kernel"}
    api_named = {k: sum(n for name, n in api_census["ops"].items() if sub in name)
                 for k, sub in api_kernels.items()}
    require(all(api_named.values()),
            f"facade_api: the profiler's census must name B2, B3, B4 and B8: {api_named}")
    t0 = time.perf_counter()
    cpu_api, cpu_api_launches, _, _ = run_facade_api("cpu", [(0, API_REPLAY)])
    api_cpu_s = time.perf_counter() - t0
    require(not any(cpu_api_launches.values()), "the facade_api CPU run launched a kernel")
    diff = first_difference("facade_api", cpu_api["block0"], api_rec["block0"])
    require(diff is None, f"facade_api: the {API_REPLAY}-session CPU replay differs from the "
                          f"card at {diff}")
    windows["facade_api"] = api_launches
    emit("facade_api", sessions=API_SESSIONS, members=API_MEMBERS,
         joins=API_SESSIONS * API_MEMBERS, vouches_before_join=API_VOUCHES,
         agents=DEFAULT_CONFIG.capacity.max_agents, table_sessions=DEFAULT_CONFIG.capacity.max_sessions,
         edges=DEFAULT_CONFIG.capacity.max_vouch_edges,
         elevations=DEFAULT_CONFIG.capacity.max_elevations,
         launches={k: n for k, n in api_launches.items() if n},
         census_block_sessions=API_REPLAY,
         census=dict(sorted(api_census["ops"].items(), key=lambda kv: -kv[1])[:25]),
         census_device_ops=sum(api_census["ops"].values()), census_ours=api_named,
         census_wall_ms=api_census["wall_ms"], census_device_busy_ms=api_census["busy_ms"],
         census_device_idle_share=1 - api_census["busy_ms"] / api_census["wall_ms"],
         host_ms={k: {"p50": float(np.percentile(v, 50)), "p95": float(np.percentile(v, 95)),
                      "samples": len(v)} for k, v in api_times.items()},
         sequence_wall_s=api_card_s, cpu_replay_s=api_cpu_s,
         replay_sessions=API_REPLAY, cpu_run="identical",
         roots=sum(r is not None for b in api_rec.values() for r in b["roots"]),
         events_mirrored=[b["mirrored"] for b in api_rec.values()], nvidia_smi=smi,
         clock="host, synchronised; timed on the second block (sessions 128-1,023); "
               "the first block runs under torch.profiler for the census")

    # ── 13. durability: the WAL, the checkpoint, crash recovery ───────
    dur_dir = tempfile.mkdtemp(prefix="hv_durability_")
    try:
        t0 = time.perf_counter()
        dur = run_durability(dev, dur_dir)
        dur_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(dur_dir, ignore_errors=True)
    window = {k: n for k, n in dur["window"].items() if n}
    require(set(window) == set(OUR_KERNELS),
            f"durability: the recovery window must launch every kernel of the main path "
            f"and no other: {window}")
    dur_named = {k: sum(n for name, n in dur["census"].items() if sub in name)
                 for k, sub in OUR_KERNELS.items()}
    require(all(dur_named.values()),
            f"durability: the profiler's census must name every kernel: {dur_named}")
    unnamed = {name: n for name, n in dur["census"].items()
               if not any(sub in name for sub in OUR_KERNELS.values())
               and not any(t in name for t in TORCH_KERNELS)}
    require(not unnamed, f"durability: device ops neither the port's nor torch's: {unnamed}")
    windows["durability"] = dur["window"]
    census_ops = sum(dur["census"].values())
    emit("durability", seconds=dur_s, tmp=dur["tmp"], capacity=FACADE_CAPACITY,
         sequence_s=dur["sequence_s"], step_ms=dur["step_ms"], wal=dur["wal"],
         save_sync_ms=dur["save_sync_ms"], save_durable_ms=dur["save_durable_ms"],
         tables_npz_mb=dur["tables_npz_mb"], host_json_mb=dur["host_json_mb"],
         recover_tip_ms=dur["recover_tip_ms"], recover_report=dur["recover_report"],
         recover_pieces=dur["recover_pieces"],
         audit_sessions_verified=dur["audit_sessions_verified"],
         launches=window, census_ours=dur_named, census_device_ops=census_ops,
         census_wall_ms=dur["census_wall_ms"], verified_sessions=dur["verified_sessions"],
         cuts=dur["cuts"], cpu_recover_s=dur["cpu_recover_s"], cpu_run="identical",
         corruptions=dur["corruptions"], chaos=dur["chaos"], chaos_s=dur["chaos_s"],
         chaos_run="identical to the clean run",
         wave_ms=dur["wave_ms"], wal_bytes_per_wave=dur["wal_bytes_per_wave"], nvidia_smi=smi,
         clock="host, synchronised; waves each on a fresh state, journaled and unjournaled "
               "in turns; the WAL fsyncs every record")

    # ── 14. observability: the drain, health, hindsight, integrity, ──
    # the supervisor
    obs_dir = tempfile.mkdtemp(prefix="hv_observability_")
    try:
        t0 = time.perf_counter()
        obs = run_observability(dev, obs_dir)
        obs_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(obs_dir, ignore_errors=True)
    window = {k: n for k, n in obs["window"].items() if n}
    require(set(window) == set(OUR_KERNELS),
            f"observability: the window must launch every kernel of the main path and no "
            f"other: {window}")
    obs_named = {k: sum(n for name, n in obs["census"].items() if sub in name)
                 for k, sub in OUR_KERNELS.items()}
    require(all(obs_named.values()),
            f"observability: the profiler's census must name every kernel: {obs_named}")
    unnamed = {name: n for name, n in obs["census"].items()
               if not any(sub in name for sub in OUR_KERNELS.values())
               and not any(t in name for t in TORCH_KERNELS)}
    require(not unnamed, f"observability: device ops neither the port's nor torch's: {unnamed}")
    windows["observability"] = obs["window"]
    det = obs["det"]
    emit("observability", seconds=obs_s, capacity=FACADE_CAPACITY, waves=OBS_WAVES,
         sessions_per_wave=N_SESSIONS, actions_per_wave=N_ACTIONS,
         cadence={"sanitize_every": OBS_EVERY, "scrub_every": OBS_SCRUB_EVERY,
                  "checkpoint_every": OBS_CHECKPOINT_EVERY, "scrub_budget": SCRUB_BUDGET},
         launches=window, census_ours=obs_named, census_device_ops=sum(obs["census"].values()),
         dispatch_ms=obs["dispatch_ms"], drains=len(det["drains"]),
         checks=det["integrity_after_restore"]["sampling"]["checks"],
         slash_chaos=det["slash_chaos"], repair=det["repair_report"],
         restore={k: v for k, v in det["restore_report"].items() if k != "violations"},
         repair_rung_ms=obs["repair_ms"], restore_rung_ms=obs["restore_ms"],
         restore_rung_recover_ms=obs["recover_wall_ms"],
         restore_rung_recover_stages_ms=obs["recover_stages_ms"],
         degraded_from_drain=det["degraded_from"], mode_at_drain=det["mode_at_drain"],
         dispatch_modes=det["dispatch_modes"],
         supervisor=det["supervisor"]["dispatch"], degraded=det["supervisor"]["degraded"],
         restores=det["supervisor"]["restores"], checkpoint=det["supervisor"]["checkpoint"],
         incidents={k: v["captured"] for k, v in det["incidents"].items()},
         bus=sorted(set(det["bus"])), cpu_s=obs["cpu_s"], cpu_run="identical",
         restored="equal to the uninterrupted history", timing=obs["timing"], nvidia_smi=smi,
         clock="host; rungs, drains, summaries and waves synchronised; the drain and the "
               "wave timings on fresh states; the compile watch and watchdog per call")

    # ── 15. serving: the front door, its SLO and critical-path planes, ─
    # the roofline and profiling observatories, the API
    serve_dir = tempfile.mkdtemp(prefix="hv_serving_")
    try:
        t0 = time.perf_counter()
        serve = run_serving(dev, serve_dir)
        serve_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    serve_summary = check_serving(serve, on_card=True)
    windows["serving"] = serve["replay"]["window"]
    emit("serving", seconds=serve_s,
         tables={k: getattr(DEFAULT_CONFIG.capacity, k) for k in (
             "max_agents", "max_sessions", "max_vouch_edges", "max_sagas")},
         buckets=list(serve["replay"]["serving"]["buckets"]), integrity_every=8,
         **serve_summary, cpu_run="identical replay keys", nvidia_smi=smi,
         clock="latency = virtual queue wait + the wave wall (host perf_counter around each "
               "dispatch, after its results are on the host); device_ms by CUDA events "
               "around the same dispatch's state call; the replay's census comes from a "
               "second, profiled replay")

    # ── 16. tenancy: T tenants' waves in one launch of each tenant form ─
    ten_dir = tempfile.mkdtemp(prefix="hv_tenancy_")
    try:
        t0 = time.perf_counter()
        ten = run_tenancy(dev, ten_dir)
        ten_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ten_dir, ignore_errors=True)
    wave0 = ten["launches"]["wave0"]["tenant"]
    dense = ten["dense"]
    tenant_rows = tenant_form_rows(ten.pop("calls_t8"), dev, wave0, ten["errs_t8"], time_device)
    tenant_rows_100 = tenant_form_rows(ten.pop("calls_t100"), dev, dense["launches_first_round"],
                                       ten["errs_t100"], time_device)
    emit("tenancy", seconds=ten_s, tenants=TEN_T, bucket=TEN_BUCKET, turns=TEN_TURNS,
         tables={k: getattr(DEFAULT_CONFIG.capacity, k) for k in (
             "max_agents", "max_sessions", "max_vouch_edges", "max_sagas")},
         launches=ten["launches"], lend_commit=ten["lend_log"], timing=ten["timing"],
         max_abs_err_t8=ten["errs_t8"],
         max_abs_err_t100=ten["errs_t100"], cpu_full_width_s=ten["cpu_full_width_s"],
         solo_oracles="equal (tables, DeltaLog, metrics, chain heads, roots, members)",
         cpu_run="identical", idle_tenant="untouched",
         tenant_dense={k: v for k, v in dense.items() if k != "launches_first_round"},
         tenant_dense_launches={k: v for k, v in dense["launches_first_round"].items() if v},
         tenant_dense_cpu=ten["dense_cpu"], cpu_dense_s=ten["cpu_dense_s"],
         tenant_dense_within_slo=(dense["worst_tenant_p99_ms"] is not None
                                  and dense["worst_tenant_p99_ms"] <= dense["slo_p99_ms"]),
         flood=ten["flood"], splice=ten["splice"], nvidia_smi=smi,
         clock="waves: host perf_counter, synchronised, fresh sessions each; p99: virtual queue "
               "wait + the measured wave wall; device ops by torch.profiler")

    # ── 17. autopilot: the shifting-mix soak, static against autopilot ──
    t0 = time.perf_counter()
    ap = run_autopilot(dev)
    ap_s = time.perf_counter() - t0
    ap_row = ap["row"]
    emit("autopilot", seconds=ap_s, spec=AUTOPILOT_SOAK, events=ap_row["events"],
         decisions_digest=ap_row["decisions_digest"], digest_match=ap_row["digest_match"],
         replays=ap_row["replays"], goodput_ratio=ap_row["goodput_ratio"],
         static=ap_row.get("static"), goodput_improvement=ap_row.get("goodput_improvement"),
         p99_ms=ap_row["p99_ms"], slo_p99_ms=ap_row["slo_p99_ms"], slo_ok=ap_row["slo_ok"],
         shed=ap_row["shed"], buckets_final=ap_row["buckets_final"],
         decisions=ap_row["decisions"], decision_outcomes=ap_row["decision_outcomes"],
         unplanned_compiles_after_warmup=ap_row["compiles_after_warmup"],
         unplanned_recompiles_after_warmup=ap_row["recompiles_after_warmup"],
         recompiles_after_warmup_raw=ap_row["recompiles_after_warmup_raw"],
         prewarm=ap_row["prewarm"], invariant_violations=ap_row["invariant_violations"],
         last_decisions=ap_row["last_decisions"], debug_autopilot=ap["debug_autopilot"],
         soak_s=ap["soak_s"], nvidia_smi=smi,
         clock="latency = virtual queue wait + the measured wave wall (host perf_counter)")

    # ── 18. adversarial: the six scenarios on the card against the CPU ──
    t0 = time.perf_counter()
    adv = run_adversarial(dev)
    adv_s = time.perf_counter() - t0
    windows["adversarial"] = adv["window"]
    emit("adversarial", seconds=adv_s, seed=ADV_SEED, scenarios=adv["rows"],
         census=adv["census"], cpu_s=adv["cpu_s"], cpu_run="identical to_dict()",
         leftovers=adv["leftovers"],
         launches={k: n for k, n in adv["window"].items() if n}, nvidia_smi=smi,
         clock="wall_s: host perf_counter around each run_scenario on the card")

    # ── 19. fleet: two workers on the card behind one observatory ──────
    fleet_dir = tempfile.mkdtemp(prefix="hv_fleet_")
    try:
        t0 = time.perf_counter()
        fleet = run_fleet(dev, fleet_dir)
        fleet_s = time.perf_counter() - t0
        fleet_summary = check_fleet(fleet, on_card=True)
    finally:
        shutil.rmtree(fleet_dir, ignore_errors=True)
    windows["fleet"] = fleet_summary.pop("window")
    emit("fleet", seconds=fleet_s, workers=[list(w) for w in FLEET_WORKERS], **fleet_summary,
         nvidia_smi=smi,
         clock="host perf_counter: start = both workers READY and answering /health; "
               "drain = one FleetObservatory.drain of both workers; route = one request over "
               "the stdlib transport")

    def full_window(counts: dict) -> dict:
        return {k: counts.get(k, 0) for k in kernels.launch_counts()}

    # ── 20. pipeline: the reference's headline unit on the card ─────────
    t0 = time.perf_counter()
    pipe_rec = run_pipeline_phase(dev, time_device)
    pipe_s = time.perf_counter() - t0
    windows["pipeline"] = full_window(pipe_rec["cases"]["bench"]["window"])
    emit("pipeline", seconds=pipe_s, sessions=PIPE_S, deltas=PIPE_T, cases=pipe_rec["cases"],
         p50_ms=pipe_rec["p50_ms"], p95_ms=pipe_rec["p95_ms"],
         us_per_session_p50=pipe_rec["us_per_session_p50"], device_ms=pipe_rec["device_ms"],
         iters=PIPE_ITERS, profile=pipe_rec["profile"], nvidia_smi=smi,
         clock="p50/p95: host perf_counter around one call ending in torch.cuda.synchronize(); "
               "device_ms: CUDA events behind a queued busy-wait; idle share: torch.profiler "
               "over three calls")

    # ── 21. failover: the fleet's second half on the card ───────────────
    fo_dir = tempfile.mkdtemp(prefix="hv_failover_")
    try:
        t0 = time.perf_counter()
        fo = run_failover(dev, fo_dir)
        fo_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(fo_dir, ignore_errors=True)
    fo_summary = check_failover(fo, on_card=True)
    windows["failover"] = full_window(fo_summary["window"])
    drill, soak, full, procs = fo["drill"], fo["soak"], fo["full"], fo["procs"]
    drill_walls, soak_walls = drill["post_splice_walls_ms"], soak["round_walls_ms"]
    emit("failover", seconds=fo_s, part_seconds={k: fo[f"{k}_s"] for k in (
             "drill", "soak", "full", "procs")},
         drill={k: v for k, v in drill.items() if k != "post_splice_walls_ms"},
         drill_post_splice_ms={"p50": float(np.percentile(drill_walls, 50)),
                               "p99": float(np.percentile(drill_walls, 99))},
         soak={k: v for k, v in soak.items() if k != "round_walls_ms"},
         soak_round_ms={"p50": float(np.percentile(soak_walls, 50)),
                        "p99": float(np.percentile(soak_walls, 99))},
         full=full, procs={k: v for k, v in procs.items() if k != "routes"},
         routes={k: {"status": r["status"], "ms": r["ms"]} for k, r in procs["routes"].items()},
         windows=fo_summary["windows"], worker_launches=fo_summary["worker_launches"],
         nvidia_smi=smi,
         clock="host perf_counter; the drills' walls around calls whose lanes are read back to "
               "the host; absorb split by recover's stages, each ended by a synchronize")

    # ── 22. mesh: the multi-device plane on virtual meshes of the card ──
    t0 = time.perf_counter()
    mesh_rec = run_mesh_phase(dev)
    mesh_s = time.perf_counter() - t0
    windows["mesh"] = full_window(mesh_rec["window"])
    emit("mesh", seconds=mesh_s, shards=MESH_SHARDS, grid=list(MESH_GRID), sessions=N_SESSIONS,
         vouched=N_VOUCHED, edge_shards=list(MESH_EDGE_SHARDS), doubled=MESH_DOUBLED,
         **{k: v for k, v in mesh_rec.items() if k != "window"}, window=mesh_rec["window"],
         nvidia_smi=smi,
         clock="p50/p95: host perf_counter around one run_governance_wave ending in "
               "torch.cuda.synchronize(), mesh and single-device in turns, each replayed from "
               "a snapshot; collectives: CUDA events and host time around every psum and "
               "all_gather of a timed mesh wave; idle share: torch.profiler over three waves")

    # ── 23. lint: hvlint's Tier A over the port, Tier B on the card ─────
    t0 = time.perf_counter()
    lint_rec = run_lint_phase(dev)
    lint_s = time.perf_counter() - t0
    windows["lint"] = full_window(lint_rec.pop("window"))
    emit("lint", seconds=lint_s, **lint_rec, window=windows["lint"], nvidia_smi=smi,
         clock="host perf_counter around each tier's whole run (Tier B: seven programs at "
               "tiny shapes under the sync-debug mode, the dispatch recorder and the "
               "version-counter check)")

    # ── 24. examples: the demo, the mesh walkthrough and the watchers ───
    ex_dir = tempfile.mkdtemp(prefix="hv_examples_")
    try:
        t0 = time.perf_counter()
        ex_rec = run_examples_phase(dev, ex_dir)
        ex_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ex_dir, ignore_errors=True)
    windows["examples"] = full_window(ex_rec.pop("window"))
    emit("examples", seconds=ex_s, **ex_rec, window=windows["examples"], nvidia_smi=smi,
         clock="host perf_counter around each example's main(), on the card then on the CPU "
               "(the card's first kernel builds happened in phase build)")

    # Each kernel at the wave's inputs; in-place kernels restore first.
    def restore_post(dst):
        for k, t in post.items():
            copy_into(dst[k], t)

    def restore_pre(dst):
        copy_into(dst["agents"], pristine["agents"])
        copy_into(dst["sessions"], pristine["sessions"])

    scratch = {k: clone(t) for k, t in post.items()}
    calls = {
        "contribution_toward": (
            lambda: wave.contribution_toward(pristine["vouches"], target, now0),
            lambda: liability.contribution_toward(pristine["vouches"], target, now0), None),
        "chain_digests": (lambda: mtu.chain_digests(body_t, seeds0),
                          lambda: mtu.chain_digests_plain(body_t, seeds0), None),
        "tree_roots": (lambda: mtu.tree_roots(leaves, counts3),
                       lambda: mtu.tree_roots_plain(leaves, counts3), None),
        "admission_block": (
            lambda: wave.admission_block(scratch["agents"], scratch["sessions"], *adm_args, True),
            lambda: wave.admission_block_plain(scratch["agents"], scratch["sessions"],
                                               *adm_args, True),
            lambda: restore_pre(scratch)),
        "fsm_saga_block": (
            lambda: wave.fsm_saga_block(scratch["agents"], scratch["sessions"],
                                        scratch["vouches"], ks_t, ok_m, 0.0, (0, N_SESSIONS)),
            lambda: wave.fsm_saga_block_plain(scratch["agents"], scratch["sessions"],
                                              scratch["vouches"], ks_t, ok_m, 0.0,
                                              (0, N_SESSIONS)),
            lambda: restore_post(scratch)),
    }
    # B7 at the default table (in place: restored before each call); B8
    # at the slash path's inputs (it writes new tensors only).
    table16, outcomes16 = b7_inputs[(saga_cap, DEFAULT_CONFIG.capacity.max_steps_per_saga)]
    saga_pristine = {k: torch.from_numpy(np.array(table16[k], copy=True)).to(dev) for k in SAGA_COLS}
    saga_cols = {k: t.clone() for k, t in saga_pristine.items()}
    outcomes16_t = torch.from_numpy(outcomes16).to(dev)

    def restore_saga_cols():
        for k, t in saga_pristine.items():
            saga_cols[k].copy_(t)

    # Both book their tallies into a counter column, as on their paths.
    ctr_k, ctr_p = (torch.zeros(n_counters, dtype=torch.int32, device=dev) for _ in range(2))
    calls["saga_tick_block"] = (
        lambda: saga_kernels.saga_tick_block(*(saga_cols[k] for k in SAGA_COLS), outcomes16_t,
                                             ctr_k),
        lambda: saga_kernels.saga_tick_block_plain(*(saga_cols[k] for k in SAGA_COLS),
                                                   outcomes16_t, ctr_p),
        restore_saga_cols)
    first_t = first.to(dev)
    calls["slash_cascade"] = (
        lambda: liab_kernels.slash_cascade(pre_v, pre_sigma, first_t, pre_sess,
                                           NORTH_STAR["omega"], 1.0, counters=ctr_k),
        lambda: liab_kernels.slash_cascade_plain(pre_v, pre_sigma, first_t, pre_sess,
                                                 NORTH_STAR["omega"], 1.0, counters=ctr_p), None)
    # B2's ring form at the facade's shape (30,000 rows, wrapping); the
    # reset puts the plain pair's ring cursor back (the kernel writes its
    # cursor from the argument, so its calls repeat exactly).
    ring_base, ring_args = ring_inputs[(N_SESSIONS, n_rows)]
    ring_k, ring_p = clone(ring_base), clone(ring_base)
    r_bodies, r_seeds, _, r_sess = ring_args[:4]
    strip_words = b1_inputs[(SCRUB_BUDGET, 2)]
    calls["chain_digests_ring"] = (
        lambda: mtu.chain_digests_ring(r_bodies, r_seeds, ring_k, r_sess, ring_cursor, n_rows),
        lambda: mtu.chain_digests_ring_plain(r_bodies, r_seeds, ring_p, r_sess, ring_cursor,
                                             n_rows),
        lambda: ring_p.cursor.fill_(ring_cursor))
    calls["sha256_words"] = (lambda: sha_kernels.sha256_words(strip_words, 2),
                             lambda: sha_kernels.sha256_words_plain(strip_words, 2), None)

    # The one PyTorch call that computes the same function, where there
    # is one: the contribution's scatter-add, on the masked bonds.
    vee_l, scoped_l = liability.scoped_edges(pristine["vouches"], target, now0)
    bond_l = pristine["vouches"].bond
    vals_l = torch.where(scoped_l, bond_l, torch.zeros_like(bond_l))
    lib_out = torch.zeros((n_cap,), dtype=torch.float32, device=dev)
    library = {"contribution_toward": lambda: lib_out.index_add_(0, vee_l, vals_l)}
    # No PyTorch call computes the chain, so the ring form has no library
    # time. Its append half alone has one: the four `index_copy_` calls a
    # user would write, on rows already flattened lane-major (the
    # flattening not timed), reported beside the row.
    ring_l = clone(ring_base)
    r_chain = mtu.chain_digests(r_bodies, r_seeds)
    flat = (r_bodies.transpose(0, 1).reshape(-1, 16).contiguous(),
            r_chain.transpose(0, 1).reshape(-1, 8).contiguous(),
            r_sess.repeat_interleave(N_DELTAS),
            torch.arange(N_DELTAS, dtype=torch.int32, device=dev).repeat(N_SESSIONS))
    ring_idx = (ring_cursor + torch.arange(n_rows, device=dev)) % c_ring

    def append_library():
        for col, rows_ in zip((ring_l.body, ring_l.digest, ring_l.session, ring_l.turn), flat):
            col.index_copy_(0, ring_idx, rows_)

    # Bounds: the bytes each function must move (inputs read once, outputs
    # written once, counting what this run's data needs) over HBM
    # bandwidth, against its 32-bit integer instructions (counted as the
    # work needs them) over the integer rate: `kernels.work.kernel_work`.
    l_, t_ = N_SESSIONS, N_DELTAS
    pairs, dup_pairs = tree_pairs(counts3.tolist(), leaves.shape[1])
    n_ok = int(ok_m.sum())
    agent_hits = int(((post["agents"].i32[:, 1] >= 0)
                      & (post["agents"].i32[:, 1] < N_SESSIONS)).sum())
    edges = int(state.vouches.session.shape[0])
    work = {
        "contribution_toward": kernel_work("contribution_toward", edges=edges, agents=n_cap),
        "chain_digests": kernel_work("chain_digests", turns=t_, lanes=l_),
        "tree_roots": kernel_work("tree_roots", lanes=l_, leaves=l_ * min(N_DELTAS, 4),
                                  pairs=pairs, dup_pairs=dup_pairs),
        "admission_block": kernel_work("admission_block", lanes=l_, admitted=n_ok),
        "fsm_saga_block": kernel_work("fsm_saga_block", sessions=N_SESSIONS, lanes=l_,
                                      edges=edges, vouched=N_VOUCHED, agents=n_cap,
                                      agent_hits=agent_hits),
        "chain_digests_ring": kernel_work("chain_digests_ring", turns=t_, lanes=l_, rows=n_rows),
        "sha256_words": kernel_work("sha256_words", messages=SCRUB_BUDGET, blocks=2),
        "saga_tick_block": kernel_work("saga_tick_block", sagas=saga_cap, steps=16),
        "slash_cascade": kernel_work("slash_cascade", edges=cap.max_vouch_edges,
                                     agents=cap.max_agents, depths=depths),
    }
    blocks_ms = time_blocks((pre_v, pre_sigma, first_t, pre_sess))
    rows = []
    for name, (kfn, pfn, reset) in calls.items():
        k_ms = time_device(kfn, reset)
        p_ms = time_device(pfn, reset, reps=PLAIN_REPS, warmup=1)
        lib = library.get(name)
        lib_ms = time_device(lib, reps=PLAIN_REPS, warmup=1) if lib else None
        nbytes, nops = work[name]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_INSTRUCTIONS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": windows[ROW_PATH.get(name, "facade_waves")][name],
            "launches_by_path": {path: c[name] for path, c in windows.items()},
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "bytes": nbytes, "int_instructions": nops,
        })
        if name == "admission_block":
            rows[-1]["ms_by_layout"] = blocks_ms["admission_block"]
        if name == "fsm_saga_block":
            rows[-1]["ms_by_form"] = blocks_ms["fsm_saga_block"]
        if name == "slash_cascade":
            rows[-1]["clip_table_build_ms"] = blocks_ms["clip_table_build_ms"]
        if name == "chain_digests_ring":
            # The same call's B2 without the ring, and the append's own
            # bound (B6's bytes), library time and share of the ring form.
            chain_ms = time_device(lambda: mtu.chain_digests(r_bodies, r_seeds))
            append_bytes = n_rows * (64 + 32) + l_ * 4 + n_rows * (64 + 32 + 4 + 4) + 4
            rows[-1].update(
                chain_ms_same_call=chain_ms, ms_over_chain=k_ms - chain_ms,
                append_bound_ms=append_bytes / HBM_BYTES_PER_S * 1e3,
                append_library_ms=time_device(append_library, reps=PLAIN_REPS, warmup=1))
        if name == "contribution_toward":
            rows[-1]["ms_hot_vouchee"] = {
                tag: time_device(lambda vt=vt, tgt=tgt: wave.contribution_toward(vt, tgt, now0))
                for tag, (vt, tgt) in contribution_cases.items() if tag.startswith("one vouchee")}
        if name == "tree_roots":
            rows[-1]["ms_full_trees"] = {}
            for p, s_ in TREE_TIMING_SHAPES:
                lv = random_words(s_, p, 8)
                ct = torch.full((s_,), p, dtype=torch.int32, device=dev)
                ms = time_device(lambda lv=lv, ct=ct: mtu.tree_roots(lv, ct))
                b_ms = s_ * (p * 32 + 4 + 32) / HBM_BYTES_PER_S * 1e3
                o_ms = s_ * (p - 1) * INSTR_PER_PAIR / INT32_INSTRUCTIONS_PER_S * 1e3
                rows[-1]["ms_full_trees"][f"P={p}"] = {
                    "sessions": s_, "ms": ms, "bound_ms": max(b_ms, o_ms),
                    "bound_by": "bytes" if b_ms >= o_ms else "operations",
                    "design": "packed" if mtu.tree_lanes_per_session(p) else "block per session"}
        if name == "sha256_words":
            rows[-1]["ms_at_30000_messages"] = {
                f"{nb}_blocks": time_device(lambda nb=nb: sha_kernels.sha256_words(
                    b1_inputs[(n_rows, nb)], nb)) for nb in (2, 3)}
            # Each path's launches at their own shapes: the scrubber's 16
            # strips, verify's links of one wrapped session, and the big
            # tree's 13 hex-pair levels (4 lanes x 4,096 pairs down to 1).
            path_shapes = {
                "scrubber": [(SCRUB_BUDGET, 2)], "verify": [(facade_rec["verify_links"], 2)],
                "big_tree": [(4 * (BIG_TREE_LEAVES >> (k + 1)), 3)
                             for k in range(BIG_TREE_LEAVES.bit_length() - 1)]}
            rows[-1]["by_path"] = {}
            for path, shapes in path_shapes.items():
                entries = []
                for b, nb in shapes:
                    words_p = random_words(b, 16 * nb)
                    bound = max(b * (nb * 64 + 32) / HBM_BYTES_PER_S,
                                b * instr_per_message(nb) / INT32_INSTRUCTIONS_PER_S) * 1e3
                    entries.append({"messages": b, "blocks": nb, "bound_ms": bound, "ms": time_device(
                        lambda w=words_p, nb=nb: sha_kernels.sha256_words(w, nb))})
                n_launch = windows[path]["sha256_words"]
                rows[-1]["by_path"][path] = {
                    "launches": n_launch, "shapes": entries,
                    "loss_ms": n_launch / len(entries) * sum(e["ms"] - e["bound_ms"] for e in entries)}
        emit("kernel_timing", **rows[-1])
    # The tenant forms: at the full-width wave's inputs (T = 8 tenants of
    # the default tables, bucket 32) and at tenant_dense's (T = 100, bucket
    # 8); their launches from each cell's batched wave.
    for form, row in tenant_rows.items():
        at_100 = tenant_rows_100[form]
        _, replaces, source = TENANT_FORM_ROWS[form]
        rows.append({
            "name": form, "route": "cuda", "source": source, "replaces": replaces, **row,
            "solo_form": tenant_forms()[form], "tenants": TEN_T,
            "at_t100": {k: at_100[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")},
        })
        emit("kernel_timing", **rows[-1])
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    emit("card_after_timing", clocks_power_limit_temp=clocks,
         note="library_ms: index_add_ for the contribution; no PyTorch call computes "
              "SHA-256 (B1, B2 and its ring form, B3), the admission and fsm/saga blocks, "
              "the saga round or the slash cascade, so theirs is null; the ring form's "
              "append half alone: four index_copy_ calls on pre-flattened rows "
              "(append_library_ms)")

    print(json.dumps({"kernels": [{k: row[k] for k in KERNEL_KEYS} for row in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
