"""Fleet workers: N subprocesses, each the EXISTING API server.

A `WorkerSpec` pins a worker's identity, tenant set, port, and env; the
worker process itself is nothing new — it builds the same
`HypervisorService` the single-process deployments use, attaches a
`TenantArena` + `TenantFrontDoor` behind it when the spec pins more
than one tenant (so `/debug/tenants` is live and the merged fleet
drain carries BOTH the `tenant` and `worker` labels), and serves the
existing routes unchanged over the stdlib transport (dependency-free,
so the fleet drill runs anywhere the tier-1 suite runs).

Readiness is a printed line — the worker binds its port (0 = ephemeral)
and prints exactly one `HV_WORKER_READY={json}` line on stdout; the
`FleetSupervisor` reads it to learn the bound port, then confirms over
HTTP. The supervisor also owns the kill switch for the liveness drill:
`kill(worker_id)` delivers SIGKILL, the one failure mode the registry's
lease plane must detect within its windowed budget.

Each worker builds its service and arena on `spec.device`: the card
unless the spec asks for the CPU. Several workers on one card share it;
each loads the kernels `kernels._build` has built (a first build writes
then renames, so concurrent first builds are safe). A worker that cannot
start CUDA never prints its READY line, and the supervisor's ready
timeout fails loudly. On SIGUSR1 a worker prints one
`HV_WORKER_LAUNCHES={json}` line, its process's kernel launch counts
(`kernels.launch_counts()`); `FleetSupervisor.launch_counts` reads it, so
a caller can show which kernels the workers ran. A spec with a
`durability_root` adopts its `fleet.failover.WorkerDurability` namespace
before serving anything, journals each tenant into its fenced WAL there,
and drains gracefully on SIGTERM: the arena synced, each WAL flushed, a
final watermarked checkpoint per tenant, then the DRAINED line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import signal
import subprocess
import sys
import time
import urllib.request
from typing import Mapping, Optional

READY_MARKER = "HV_WORKER_READY="
DRAINED_MARKER = "HV_WORKER_DRAINED="
LAUNCHES_MARKER = "HV_WORKER_LAUNCHES="


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One worker's pinned identity: tenant set, port, env."""

    worker_id: str
    tenants: tuple = (0,)
    port: int = 0  # 0 = ephemeral; the READY line reports the bound port
    host: str = "127.0.0.1"
    #: Extra environment for the subprocess (merged over os.environ).
    env: tuple = ()  # tuple of (key, value) pairs — keeps the spec frozen
    #: Attach a TenantArena behind the server. None = auto: attach when
    #: the spec pins more than one tenant.
    arena: Optional[bool] = None
    #: Seeded lifecycle rounds driven through the arena BEFORE the
    #: READY line — warmup compiles land pre-readiness, so post-ready
    #: recompile accounting is clean.
    warm_rounds: int = 2
    #: Durable ownership root (fleet.failover layout). Empty = no
    #: durability: the detection-only drill runs unchanged.
    #: When set, the worker adopts
    #: `<root>/<worker_id>/epoch_<epoch>/tenant_<t>/` at startup —
    #: refusing loudly if the directory already carries a newer epoch —
    #: journals every tenant's waves into its fenced WAL there, and on
    #: SIGTERM drains gracefully (flush + final checkpoint + DRAINED
    #: marker + exit 0).
    durability_root: str = ""
    #: Fencing epoch this incarnation writes at (fleet.failover's).
    epoch: int = 0
    #: The torch device the worker's state and arena live on. A spec
    #: written without it reads as the card.
    device: str = "cuda"

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def wants_arena(self) -> bool:
        return len(self.tenants) > 1 if self.arena is None else bool(self.arena)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["tenants"] = list(self.tenants)
        d["env"] = [list(kv) for kv in self.env]
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "WorkerSpec":
        d = json.loads(raw)
        d["tenants"] = tuple(d.get("tenants", (0,)))
        d["env"] = tuple(tuple(kv) for kv in d.get("env", ()))
        return cls(**d)


def _small_capacity_config():
    """The gate-6i small-table config: big enough for the drill's
    traffic, small enough that a worker warms in seconds on CPU."""
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TableCapacity

    return DEFAULT_CONFIG.replace(capacity=TableCapacity(
        max_agents=64, max_sessions=64, max_vouch_edges=64, max_sagas=16,
        max_steps_per_saga=4, max_elevations=16, delta_log_capacity=256,
        event_log_capacity=64, trace_log_capacity=64,
    ))


def _make_service(device):
    """A `HypervisorService` on `device` whose `/metrics` appends the
    attached arena's tenant-labeled exposition (headers once, from the
    state's own part) — so the fleet's merged drain carries BOTH labels
    on the arena rows: `tenant="<t>"` from the tenant merge,
    `worker="<id>"` stamped one level up by `fleet.drain`."""
    from hypervisor_tpu_torch.api.service import HypervisorService, PrometheusText
    from hypervisor_tpu_torch.core import Hypervisor
    from hypervisor_tpu_torch.observability import HypervisorEventBus

    class FleetWorkerService(HypervisorService):
        async def metrics(self) -> PrometheusText:
            base = self.hv.state.metrics_prometheus()
            front = getattr(self, "tenancy", None)
            if front is None:
                return PrometheusText(base)
            parts = [base]
            snaps = front.arena.metrics_snapshot()
            for t in sorted(snaps):
                parts.append(snaps[t].to_prometheus(
                    extra_labels={"tenant": str(t)}, emit_headers=False
                ))
            return PrometheusText("".join(parts))

    bus = HypervisorEventBus()
    return FleetWorkerService(
        hypervisor=Hypervisor(event_bus=bus, device=device), event_bus=bus
    )


def run_worker(spec: WorkerSpec) -> None:
    """Worker entry: the existing service + server, tenant arena behind
    it when the spec pins one, READY line once the port is bound.

    Blocks until SIGTERM/SIGINT; never returns normally.
    """
    from hypervisor_tpu_torch.api.server import HypervisorHTTPServer

    service = _make_service(spec.device)
    durability = None
    arena = None
    if spec.wants_arena:
        from hypervisor_tpu_torch.serving import ServingConfig
        from hypervisor_tpu_torch.tenancy import (
            TenantArena,
            TenantFrontDoor,
            TenantWaveScheduler,
        )

        arena = TenantArena(
            len(spec.tenants), _small_capacity_config(), device=spec.device
        )
        if spec.durability_root:
            from hypervisor_tpu_torch.fleet.failover import WorkerDurability

            # Adopt BEFORE serving anything: a zombie restarting with a
            # stale spec must die here, not at its first overwrite.
            durability = WorkerDurability(
                spec.durability_root, spec.worker_id,
                epoch=spec.epoch, tenants=spec.tenants,
            ).adopt()
            for slot, tenant in enumerate(spec.tenants):
                arena.tenants[slot].journal = durability.wal(tenant)
        front = TenantFrontDoor(arena, ServingConfig(buckets=(4, 8)))
        sched = TenantWaveScheduler(front)
        sched.warm(now=0.0)
        # Pre-READY traffic: the warm contract's steady shape, driven
        # here so warmup compiles never pollute post-ready accounting.
        now = 1.0
        for r in range(max(0, int(spec.warm_rounds))):
            for t in range(len(spec.tenants)):
                front.submit_lifecycle(
                    t,
                    f"{spec.worker_id}:w{r}:{t}",
                    f"did:fleet:{spec.worker_id}:{r}:{t}",
                    0.8,
                    now=now,
                )
            sched.lifecycle_round(now)
            now += 0.1
        # /debug/tenants goes live exactly as the single-process
        # deployments wire it (service.tenancy degrade precedent).
        service.tenancy = front

    def _launches(signum, frame):  # pragma: no cover — signal path
        from hypervisor_tpu_torch import kernels

        print(LAUNCHES_MARKER + json.dumps(kernels.launch_counts(), sort_keys=True),
              flush=True)

    signal.signal(signal.SIGUSR1, _launches)
    server = HypervisorHTTPServer(service, port=spec.port).start()
    ready = {
        "worker_id": spec.worker_id,
        "port": server.port,
        "tenants": list(spec.tenants),
        "arena": spec.wants_arena,
        "pid": os.getpid(),
    }
    print(READY_MARKER + json.dumps(ready, sort_keys=True), flush=True)

    stop = {"flag": False, "drain": False}

    def _term(signum, frame):  # pragma: no cover — signal path
        # SIGTERM is the GRACEFUL path: flush + final checkpoint +
        # DRAINED marker + exit 0. SIGINT remains a plain stop.
        stop["drain"] = stop["drain"] or signum == signal.SIGTERM
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop["flag"]:
        time.sleep(0.05)
    server.stop()
    if stop["drain"] and durability is not None:
        # Graceful handoff: the arena synced before any host copy, every
        # tenant's WAL flushed, a final watermarked checkpoint published
        # at the WAL head, so the adopter's recovery replays ZERO records.
        arena.sync()
        drained = {}
        for slot, tenant in enumerate(spec.tenants):
            st = arena.tenants[slot]
            if st.journal is not None:
                st.journal.flush()
            durability.checkpoint(st, tenant)
            drained[str(tenant)] = {
                "wal_seq": st.journal.last_seq if st.journal else 0,
            }
        durability.close()
        print(DRAINED_MARKER + json.dumps({
            "worker_id": spec.worker_id,
            "epoch": spec.epoch,
            "tenants": drained,
        }, sort_keys=True), flush=True)


class FleetSupervisor:
    """Spawn, watch, and kill N workers.

    The supervisor is the fleet's process owner: it Popens one
    subprocess per `WorkerSpec` (`python -m hypervisor_tpu_torch.fleet.worker
    <spec-json>`, on the spec's device), waits for each READY line to
    learn bound ports,
    confirms over HTTP, and exposes the SIGKILL switch the liveness
    drill uses. It deliberately does NOT restart workers — reassignment
    is the shard-out's job (ROADMAP item 1); round 18 only has to
    DETECT, deterministically, within the lease budget.
    """

    def __init__(
        self,
        specs,
        python: Optional[str] = None,
        ready_timeout_s: float = 180.0,
        log_dir: Optional[str] = None,
    ) -> None:
        self.specs = list(specs)
        ids = [s.worker_id for s in self.specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids: {ids}")
        self.python = python or sys.executable
        self.ready_timeout_s = float(ready_timeout_s)
        #: When set, each worker's stderr goes to `<log_dir>/<id>.err`
        #: (a worker that dies before READY leaves its reason there).
        self.log_dir = log_dir
        self.workers: dict[str, dict] = {}

    # ── lifecycle ────────────────────────────────────────────────────

    def start(self) -> "FleetSupervisor":
        for spec in self.specs:
            env = dict(os.environ)
            env.update(dict(spec.env))
            err = subprocess.DEVNULL
            if self.log_dir is not None:
                os.makedirs(self.log_dir, exist_ok=True)
                err = open(
                    os.path.join(self.log_dir, f"{spec.worker_id}.err"), "w"
                )
            proc = subprocess.Popen(
                [self.python, "-m", "hypervisor_tpu_torch.fleet.worker",
                 spec.to_json()],
                stdout=subprocess.PIPE,
                stderr=err,
                env=env,
                text=True,
            )
            if err is not subprocess.DEVNULL:
                err.close()
            self.workers[spec.worker_id] = {
                "spec": spec, "proc": proc, "port": None, "ready": None,
            }
        deadline = time.monotonic() + self.ready_timeout_s
        for worker_id, rec in self.workers.items():
            ready = self._read_ready(rec["proc"], deadline)
            if ready is None:
                self.stop()
                raise RuntimeError(
                    f"worker {worker_id!r} never printed its READY line"
                )
            rec["ready"] = ready
            rec["port"] = int(ready["port"])
        # HTTP confirmation: the READY line proves the bind; /health
        # proves the dispatch loop answers.
        for worker_id in self.workers:
            if not self._confirm_http(worker_id, deadline):
                self.stop()
                raise RuntimeError(f"worker {worker_id!r} bound but not serving")
        return self

    def _read_ready(self, proc, deadline: float) -> Optional[dict]:
        """Read stdout until the READY marker (or deadline/exit)."""
        fd = proc.stdout
        buf = ""
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                return None
            readable, _, _ = select.select([fd], [], [], 0.25)
            if not readable:
                continue
            chunk = fd.readline()
            if not chunk:
                continue
            buf = chunk.strip()
            if buf.startswith(READY_MARKER):
                return json.loads(buf[len(READY_MARKER):])
        return None

    def _confirm_http(self, worker_id: str, deadline: float) -> bool:
        url = self.base_url(worker_id) + "/health"
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(url, timeout=2.0) as resp:
                    if resp.status == 200:
                        return True
            except Exception:
                time.sleep(0.1)
        return False

    def stop(self) -> None:
        for rec in self.workers.values():
            proc = rec["proc"]
            if proc.poll() is None:
                proc.terminate()
        for rec in self.workers.values():
            proc = rec["proc"]
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:  # pragma: no cover
                proc.kill()
                proc.wait(timeout=10.0)
            if proc.stdout is not None:
                proc.stdout.close()

    def __enter__(self) -> "FleetSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ── views + the kill switch ──────────────────────────────────────

    def base_url(self, worker_id: str) -> str:
        rec = self.workers[worker_id]
        return f"http://{rec['spec'].host}:{rec['port']}"

    def urls(self) -> dict[str, str]:
        """worker_id -> base_url — the FleetObservatory's worker map."""
        return {w: self.base_url(w) for w in sorted(self.workers)}

    def alive(self, worker_id: str) -> bool:
        return self.workers[worker_id]["proc"].poll() is None

    def launch_counts(self, worker_id: str, timeout_s: float = 30.0) -> dict:
        """The worker process's kernel launch counts: SIGUSR1, then its
        `HV_WORKER_LAUNCHES` line on stdout. Raises if none comes."""
        proc = self.workers[worker_id]["proc"]
        proc.send_signal(signal.SIGUSR1)
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            readable, _, _ = select.select([proc.stdout], [], [], 0.25)
            if not readable:
                continue
            line = proc.stdout.readline()
            if line.startswith(LAUNCHES_MARKER):
                return json.loads(line[len(LAUNCHES_MARKER):])
            if not line and proc.poll() is not None:
                break
        raise RuntimeError(f"worker {worker_id!r} printed no launch counts")

    def kill(self, worker_id: str, sig: int = signal.SIGKILL) -> None:
        """The drill's failure injection: SIGKILL — no shutdown hooks,
        no goodbye heartbeat, exactly the silence the lease plane must
        notice. Non-terminal signals (SIGSTOP — the zombie drill's
        freeze) are delivered without waiting: the process is paused,
        not gone, and may resume into the fence later."""
        proc = self.workers[worker_id]["proc"]
        proc.send_signal(sig)
        if sig != signal.SIGSTOP:
            proc.wait(timeout=10.0)

    def drain(
        self, worker_id: str, timeout_s: float = 60.0
    ) -> Optional[dict]:
        """Graceful handoff: SIGTERM, then read stdout for the DRAINED
        marker the worker prints after flushing its WALs and publishing
        final per-tenant checkpoints. Returns the parsed marker (None
        when the worker had no durability attached), after the process
        has exited 0.
        """
        rec = self.workers[worker_id]
        proc = rec["proc"]
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + float(timeout_s)
        marker: Optional[dict] = None
        fd = proc.stdout
        while time.monotonic() < deadline:
            readable, _, _ = select.select([fd], [], [], 0.25)
            if readable:
                line = fd.readline()
                if line and line.strip().startswith(DRAINED_MARKER):
                    marker = json.loads(
                        line.strip()[len(DRAINED_MARKER):]
                    )
                    break
                if not line and proc.poll() is not None:
                    break  # EOF after exit: no marker is coming
            elif proc.poll() is not None and marker is None:
                # Exited without a marker in the buffer — one final
                # non-blocking sweep picks up anything already flushed.
                tail = fd.read() or ""
                for ln in tail.splitlines():
                    if ln.strip().startswith(DRAINED_MARKER):
                        marker = json.loads(
                            ln.strip()[len(DRAINED_MARKER):]
                        )
                break
        rc = proc.wait(timeout=10.0)
        if rc != 0:
            raise RuntimeError(
                f"worker {worker_id!r} drain exited {rc}, not 0"
            )
        return marker


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    raw = argv[0] if argv else os.environ.get("HV_WORKER_SPEC")
    if not raw:
        print("usage: python -m hypervisor_tpu_torch.fleet.worker '<spec-json>'",
              file=sys.stderr)
        return 2
    run_worker(WorkerSpec.from_json(raw))
    return 0


if __name__ == "__main__":  # pragma: no cover — subprocess entry
    sys.exit(main())


__all__ = [
    "DRAINED_MARKER",
    "FleetSupervisor",
    "LAUNCHES_MARKER",
    "READY_MARKER",
    "WorkerSpec",
    "run_worker",
]
