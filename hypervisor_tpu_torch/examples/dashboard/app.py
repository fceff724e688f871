"""Hypervisor dashboard: live governance state across five panels.

Five panels (overview, rings, sagas, liability, events) fed by a live
hypervisor driven by a simulated session, rendered through whichever
frontend the environment has:

  * streamlit  — `streamlit run hypervisor_tpu_torch/examples/dashboard/app.py`
    (five tabs, auto-refresh), when streamlit is installed.
  * browser    — `python -m hypervisor_tpu_torch.examples.dashboard.app
    --serve 8400` serves a self-contained live HTML dashboard over stdlib
    http (`web.py`) — no extra dependencies.
  * terminal   — `python -m hypervisor_tpu_torch.examples.dashboard.app`
    renders the panels with rich (falls back to plain text without rich).
  * png report — `... app --png out.png` writes a matplotlib snapshot
    (2x2 charts + event feed).

Data comes from a LIVE `Hypervisor` on `--device` (the card by default)
driven by a built-in activity simulator (sessions, joins, vouches, drift
slashes, sagas, events): the simulation drives the real engines rather
than faking chart data.
"""

from __future__ import annotations

import argparse
import asyncio
import random
import sys
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

from hypervisor_tpu_torch import (
    EventType,
    Hypervisor,
    HypervisorEvent,
    HypervisorEventBus,
    SagaOrchestrator,
    SessionConfig,
)


# ──────────────────────────────────────────────────────────────────────
# Data layer: drive the real engines with simulated multi-agent traffic.
# ──────────────────────────────────────────────────────────────────────

@dataclass
class DashboardState:
    """Snapshot consumed by every renderer."""

    session_rows: list = field(default_factory=list)   # (id, state, n, mode)
    ring_counts: Counter = field(default_factory=Counter)
    sigma_by_agent: dict = field(default_factory=dict)
    vouch_edges: list = field(default_factory=list)    # (voucher, vouchee, bond)
    slash_events: list = field(default_factory=list)
    saga_rows: list = field(default_factory=list)      # (name, state, steps)
    events: list = field(default_factory=list)         # (ts, type, agent)
    stats: dict = field(default_factory=dict)
    risk_rows: list = field(default_factory=list)      # (did, risk, recommendation)
    quarantine_rows: list = field(default_factory=list)  # (did, reason, active)
    security_rows: list = field(default_factory=list)  # (did, severity, tripped)
    elevation_rows: list = field(default_factory=list)  # (did, ring, remaining_s)
    lock_rows: list = field(default_factory=list)      # (resource, holders)
    deadlock_info: dict = field(default_factory=dict)  # {cycle: [...], victim: str}
    device_stats: dict = field(default_factory=dict)   # device-plane occupancy


async def simulate(n_sessions: int = 4, agents_per: int = 5, seed: int = 7,
                   device="cuda") -> DashboardState:
    """Run a governance scenario through the real engines (the facade on
    `device`) and snapshot it."""
    rng = random.Random(seed)
    bus = HypervisorEventBus()
    hv = Hypervisor(event_bus=bus, device=device)
    vouching = hv.vouching
    slashing = hv.slashing
    state = DashboardState()

    def publish(etype, sid=None, did=None):
        bus.emit(HypervisorEvent(event_type=etype, session_id=sid, agent_did=did))

    for s in range(n_sessions):
        ms = await hv.create_session(
            SessionConfig(max_participants=agents_per + 2), creator_did=f"did:sim:lead{s}"
        )
        sid = ms.sso.session_id  # facade emitted SESSION_CREATED
        members = []
        for a in range(agents_per):
            did = f"did:sim:s{s}a{a}"
            sigma = round(rng.uniform(0.45, 0.99), 2)
            try:
                await hv.join_session(sid, did, sigma_raw=sigma)
                members.append((did, sigma))
                state.sigma_by_agent[did] = sigma  # facade emitted JOINED
            except Exception:
                continue
        await hv.activate_session(sid)  # facade emits ACTIVATED

        # vouching: the strongest member vouches for the weakest two
        members.sort(key=lambda kv: -kv[1])
        if len(members) >= 3:
            strong, ssig = members[0]
            for weak, wsig in members[-2:]:
                try:
                    v = vouching.vouch(strong, weak, sid, voucher_sigma=ssig)
                    state.vouch_edges.append(
                        (strong, weak, round(v.bonded_amount, 3)))
                    publish(EventType.VOUCH_CREATED, sid, strong)
                except Exception:
                    pass

        # a saga with a couple of steps; one session's saga fails a step
        orch: SagaOrchestrator = ms.saga
        saga = orch.create_saga(sid)
        for i in range(3):
            orch.add_step(
                saga.saga_id, f"action{i}", members[0][0] if members else "did:sim",
                f"api/do{i}",
                undo_api=f"api/undo{i}" if i != 1 or s % 2 == 0 else None,
            )
        for i, step in enumerate(list(saga.steps)):
            async def executor(fail=(s == 1 and i == 2)):
                if fail:
                    raise RuntimeError("simulated step failure")
                return "ok"
            try:
                await orch.execute_step(saga.saga_id, step.step_id, executor)
                publish(EventType.SAGA_STEP_COMMITTED, sid)
            except Exception:
                publish(EventType.SAGA_STEP_FAILED, sid)
                async def undo(step):
                    return "undone"
                try:
                    await orch.compensate(saga.saga_id, undo)
                except Exception:
                    pass
                break
        state.saga_rows.append(
            (f"workflow-{s}",
             saga.state.name if hasattr(saga.state, "name") else str(saga.state),
             len(saga.steps))
        )

        # one rogue agent drifts and gets slashed in session 2
        if s == 2 and members:
            rogue, rsig = members[-1]
            result = slashing.slash(
                rogue, sid, vouchee_sigma=rsig, risk_weight=0.95,
                reason="behavioral drift (simulated)",
                agent_scores=state.sigma_by_agent,
            )
            state.slash_events.append(
                (rogue, [c.voucher_did for c in result.voucher_clips])
            )
            publish(EventType.SLASH_EXECUTED, sid, rogue)

    # governance aftermath: ledger entries, quarantine, breach sweep,
    # elevation grants — driving the same engines the reference charts.
    # The ledger is the FACADE's own (the facade wires it as the admission
    # gate); charging it here means the risk panel shows exactly what a
    # future join of these DIDs would be gated on.
    from hypervisor_tpu_torch import LedgerEntryType, QuarantineManager, QuarantineReason

    ledger = hv.ledger
    quarantine = QuarantineManager()
    for rogue, clipped in state.slash_events:
        ledger.record(rogue, LedgerEntryType.SLASH_RECEIVED, severity=0.95)
        ledger.record(rogue, LedgerEntryType.QUARANTINE_ENTERED, severity=0.95)
        quarantine.quarantine(
            rogue, "session:sim", QuarantineReason.BEHAVIORAL_DRIFT,
            details="post-slash isolation", forensic_data={"drift": 0.95},
        )
        for v in clipped:
            ledger.record(v, LedgerEntryType.SLASH_CASCADED, severity=0.5)
    for did in list(state.sigma_by_agent)[:6]:
        ledger.record(did, LedgerEntryType.CLEAN_SESSION)
    for did in sorted(state.sigma_by_agent):
        prof = ledger.compute_risk_profile(did)
        if prof.total_entries:
            state.risk_rows.append(
                (did, prof.risk_score, prof.recommendation))
    state.quarantine_rows = [
        (r.agent_did, r.reason.value, r.is_active)
        for r in quarantine.get_history()
    ]

    # breach sweep + an elevation grant on the device tables
    dev = hv.state
    active_slots = [
        dev.agent_row(d)["slot"]
        for d in list(state.sigma_by_agent)[:4]
        if dev.agent_row(d)
    ]
    if active_slots:
        # six privileged calls per agent clears the min-call analysis bar
        dev.record_calls(active_slots * 6, [0] * (len(active_slots) * 6))
        severity, tripped = dev.breach_sweep_tick(now=dev.now())
        for did in list(state.sigma_by_agent)[:4]:
            row = dev.agent_row(did)
            if row:
                state.security_rows.append(
                    (did, int(severity[row["slot"]]), bool(tripped[row["slot"]]))
                )
        for did in list(state.sigma_by_agent)[:2]:
            row = dev.agent_row(did)
            if row and row["ring"] > 1:
                slot_row = dev.grant_elevation(
                    row["slot"], granted_ring=row["ring"] - 1,
                    now=dev.now(), ttl_seconds=120.0,
                )
                state.elevation_rows.append(
                    (did, row["ring"] - 1, 120.0))

    # lock waves: contention points + a standing deadlock with its victim
    from hypervisor_tpu_torch.runtime.lock_wave import LockWave
    from hypervisor_tpu_torch.session.intent_locks import LockIntent

    locks = LockWave(device=device)
    contenders = sorted(state.sigma_by_agent)[:3]
    if len(contenders) >= 2:
        for did in contenders:
            locks.observe_sigma(did, state.sigma_by_agent[did])
            locks.submit(did, "session:sim", "/shared/plan.md", LockIntent.READ)
        locks.submit(
            contenders[0], "session:sim", "/shared/state.db", LockIntent.EXCLUSIVE
        )
        locks.flush()
        locks.manager.declare_wait(contenders[0], {contenders[1]})
        locks.manager.declare_wait(contenders[1], {contenders[0]})
        state.lock_rows = sorted(locks.contention_counts().items())
        report = locks.deadlock_report()
        state.deadlock_info = {
            "cycle": report.on_cycle,
            "victim": report.victim,
        }

    # device-plane occupancy (the HBM tables behind the facade)
    import numpy as np
    hv.sync_events_to_device()
    state.device_stats = {
        "agent rows": int((np.asarray(dev.agents.did.cpu()) >= 0).sum()),
        "session rows": dev._next_session_slot,
        "vouch edges": int(np.asarray(dev.vouches.active.cpu()).sum()),
        "delta log records": int(np.asarray(dev.delta_log.cursor.cpu())),
        "device events": int(np.asarray(dev.event_log.cursor.cpu())),
        "elevations": int(np.asarray(dev.elevations.active.cpu()).sum()),
    }

    # snapshot rings/sessions
    for ms in hv.active_sessions:
        sso = ms.sso
        state.session_rows.append(
            (
                sso.session_id.split(":")[-1][:8],
                sso.state.name if hasattr(sso.state, "name") else str(sso.state),
                len(sso.participants),
                sso.config.consistency_mode.name
                if hasattr(sso.config.consistency_mode, "name")
                else str(sso.config.consistency_mode),
            )
        )
        for p in sso.participants:
            ring = p.ring.value if hasattr(p.ring, "value") else int(p.ring)
            state.ring_counts[ring] += 1

    for ev in bus.query(limit=200):
        state.events.append(
            (getattr(ev, "timestamp", ""), str(getattr(ev, "event_type", "")),
             getattr(ev, "agent_did", None) or "")
        )
    state.stats = {
        "sessions": len(state.session_rows),
        "participants": sum(r[2] for r in state.session_rows),
        "vouches": len(state.vouch_edges),
        "slashes": len(state.slash_events),
        "sagas": len(state.saga_rows),
        "events": len(state.events),
    }
    return state


# ──────────────────────────────────────────────────────────────────────
# Renderers
# ──────────────────────────────────────────────────────────────────────

PANELS = ("overview", "rings", "sagas", "liability", "events")


def vouch_graph_lines(edges, slashed=()):
    """ASCII rendering of the liability graph: vouchers with their
    bonded vouchees as a tree, slashed agents flagged."""
    by_voucher = {}
    for a, b, bond in edges:
        by_voucher.setdefault(a, []).append((b, bond))
    slashed_set = {r for r, _ in slashed}
    lines = []
    for voucher in sorted(by_voucher):
        mark = " [SLASHED]" if voucher in slashed_set else ""
        lines.append(f"{voucher.split(':')[-1]}{mark}")
        fan = by_voucher[voucher]
        for i, (vouchee, bond) in enumerate(fan):
            elbow = "\u2514\u2500" if i == len(fan) - 1 else "\u251c\u2500"
            vm = " [SLASHED]" if vouchee in slashed_set else ""
            lines.append(
                f"  {elbow} {vouchee.split(':')[-1]}  (bond \u03c3 {bond:.3f}){vm}"
            )
    return lines or ["(no vouch edges)"]


def render_terminal(st: DashboardState) -> None:
    try:
        from rich.console import Console
        from rich.table import Table
        from rich.panel import Panel
    except ImportError:  # plain-text fallback
        print("== overview ==", st.stats)
        print("== rings ==", dict(st.ring_counts))
        print("== sagas ==", st.saga_rows)
        print("== liability ==", st.vouch_edges, st.slash_events)
        print("== events ==", len(st.events), "recorded")
        return

    con = Console()
    con.print(Panel(" · ".join(f"{k}: {v}" for k, v in st.stats.items()),
                    title="hypervisor_tpu_torch dashboard — overview"))

    t = Table(title="sessions")
    for col in ("id", "state", "participants", "mode"):
        t.add_column(col)
    for row in st.session_rows:
        t.add_row(*[str(x) for x in row])
    con.print(t)

    t = Table(title="execution rings")
    t.add_column("ring"); t.add_column("agents"); t.add_column("")
    for ring in sorted(st.ring_counts):
        n = st.ring_counts[ring]
        t.add_row(f"Ring {ring}", str(n), "█" * n)
    con.print(t)

    t = Table(title="sagas")
    for col in ("name", "state", "steps"):
        t.add_column(col)
    for row in st.saga_rows:
        t.add_row(*[str(x) for x in row])
    con.print(t)

    con.print(Panel("\n".join(vouch_graph_lines(st.vouch_edges, st.slash_events)),
                    title="liability graph (voucher \u2192 bonded vouchees)"))
    for rogue, clipped in st.slash_events:
        con.print(f"[red]slashed[/red] {rogue}; clipped vouchers: {clipped}")

    if st.risk_rows:
        t = Table(title="ledger risk profiles")
        for col in ("agent", "risk", "recommendation"):
            t.add_column(col)
        for did, risk, rec in st.risk_rows:
            style = {"deny": "red", "probation": "yellow"}.get(rec, "green")
            t.add_row(did, f"{risk:.2f}", f"[{style}]{rec}[/{style}]")
        con.print(t)

    if st.quarantine_rows or st.security_rows or st.elevation_rows:
        t = Table(title="security: quarantine / breach / elevation")
        for col in ("agent", "kind", "detail"):
            t.add_column(col)
        for did, reason, active in st.quarantine_rows:
            t.add_row(did, "quarantine", f"{reason} ({'active' if active else 'released'})")
        for did, severity, tripped in st.security_rows:
            t.add_row(did, "breach sweep",
                      f"severity {severity}" + (" BREAKER TRIPPED" if tripped else ""))
        for did, ring, ttl in st.elevation_rows:
            t.add_row(did, "elevation", f"\u2192 Ring {ring} (ttl {ttl:.0f}s)")
        for resource, holders in st.lock_rows:
            t.add_row(resource, "lock contention", f"{holders} distinct holders")
        if st.deadlock_info.get("cycle"):
            t.add_row(
                " \u2194 ".join(st.deadlock_info["cycle"]),
                "[red]deadlock[/red]",
                f"victim \u2192 {st.deadlock_info['victim']} (lowest \u03c3)",
            )
        con.print(t)

    if st.device_stats:
        con.print(Panel(" \u00b7 ".join(f"{k}: {v}" for k, v in st.device_stats.items()),
                        title="device plane (HBM tables)"))

    t = Table(title=f"events (last {min(len(st.events), 15)})")
    t.add_column("type"); t.add_column("agent")
    for _, etype, agent in st.events[-15:]:
        t.add_row(etype.replace("EventType.", ""), agent)
    con.print(t)


def render_png(st: DashboardState, path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    fig, axes = plt.subplots(2, 3, figsize=(16, 9))
    fig.suptitle("hypervisor_tpu_torch governance dashboard", fontsize=14)

    ax = axes[0][0]
    rings = sorted(st.ring_counts)
    ax.bar([f"Ring {r}" for r in rings], [st.ring_counts[r] for r in rings])
    ax.set_title("agents per execution ring")

    ax = axes[0][1]
    sigmas = sorted(st.sigma_by_agent.values())
    ax.hist(sigmas, bins=10, range=(0, 1))
    ax.set_title("σ distribution")

    ax = axes[1][0]
    g = nx.DiGraph()
    slashed = {r.split(":")[-1] for r, _ in st.slash_events}
    for a, b, bond in st.vouch_edges:
        g.add_edge(a.split(":")[-1], b.split(":")[-1], weight=bond)
    if g.number_of_nodes():
        pos = nx.spring_layout(g, seed=3)
        colors = ["#d62728" if n in slashed else "#1f77b4" for n in g.nodes]
        nx.draw_networkx(g, pos=pos, ax=ax, node_size=450, font_size=7,
                         node_color=colors)
        labels = {(u, v): f"{d['weight']:.2f}" for u, v, d in g.edges(data=True)}
        nx.draw_networkx_edge_labels(g, pos=pos, ax=ax, edge_labels=labels,
                                     font_size=6)
    ax.set_title("liability graph (red = slashed)")
    ax.axis("off")

    ax = axes[1][1]
    counts = Counter(e[1].replace("EventType.", "").split(".")[-1] for e in st.events)
    names = list(counts)[:8]
    ax.barh(names, [counts[n] for n in names])
    ax.set_title("event counts")

    ax = axes[0][2]
    if st.risk_rows:
        dids = [d.split(":")[-1] for d, _, _ in st.risk_rows]
        risks = [r for _, r, _ in st.risk_rows]
        recs = [rec for _, _, rec in st.risk_rows]
        bar_colors = ["#d62728" if rec == "deny" else
                      "#ff7f0e" if rec == "probation" else "#2ca02c"
                      for rec in recs]
        ax.barh(dids, risks, color=bar_colors)
        ax.set_xlim(0, 1)
    ax.set_title("ledger risk scores")

    ax = axes[1][2]
    if st.device_stats:
        ks = list(st.device_stats)
        ax.barh(ks, [st.device_stats[k] for k in ks])
    ax.set_title("device plane occupancy")

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    print(f"wrote {path}")


def render_streamlit(st: DashboardState) -> None:  # pragma: no cover
    import pandas as pd
    import streamlit as stl

    stl.set_page_config(page_title="hypervisor_tpu_torch", layout="wide")
    stl.title("hypervisor_tpu_torch governance dashboard")
    tabs = stl.tabs([p.title() for p in PANELS])

    with tabs[0]:
        cols = stl.columns(len(st.stats))
        for col, (k, v) in zip(cols, st.stats.items()):
            col.metric(k, v)
        stl.dataframe(pd.DataFrame(
            st.session_rows, columns=["id", "state", "participants", "mode"]))
    with tabs[1]:
        stl.bar_chart(pd.Series(
            {f"Ring {r}": n for r, n in sorted(st.ring_counts.items())}))
        stl.bar_chart(pd.Series(st.sigma_by_agent, name="sigma"))
    with tabs[2]:
        stl.dataframe(pd.DataFrame(st.saga_rows, columns=["name", "state", "steps"]))
    with tabs[3]:
        stl.dataframe(pd.DataFrame(
            st.vouch_edges, columns=["voucher", "vouchee", "bond"]))
        stl.code("\n".join(vouch_graph_lines(st.vouch_edges, st.slash_events)))
        for rogue, clipped in st.slash_events:
            stl.error(f"slashed {rogue}; clipped: {clipped}")
        if st.risk_rows:
            stl.dataframe(pd.DataFrame(
                st.risk_rows, columns=["agent", "risk", "recommendation"]))
        if st.quarantine_rows:
            stl.dataframe(pd.DataFrame(
                st.quarantine_rows, columns=["agent", "reason", "active"]))
        if st.security_rows:
            stl.dataframe(pd.DataFrame(
                st.security_rows, columns=["agent", "severity", "breaker"]))
        if st.lock_rows:
            stl.dataframe(pd.DataFrame(
                st.lock_rows, columns=["resource", "distinct holders"]))
        if st.deadlock_info.get("cycle"):
            stl.error(
                f"deadlock: {' ↔ '.join(st.deadlock_info['cycle'])} — "
                f"kill-switch victim {st.deadlock_info['victim']}"
            )
        with stl.expander("device plane (HBM tables)"):
            stl.json(st.device_stats)
    with tabs[4]:
        stl.dataframe(pd.DataFrame(st.events, columns=["ts", "type", "agent"]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--png", metavar="PATH", help="write a matplotlib snapshot")
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument(
        "--serve", metavar="PORT", type=int,
        help="serve the browser dashboard on this port (stdlib http)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state (cpu on a machine without a card)")
    args, rest = ap.parse_known_args()

    if args.serve is not None:
        from hypervisor_tpu_torch.examples.dashboard.web import main as web_main

        # Forward unrecognized flags instead of dropping them.
        sys.argv = [sys.argv[0], "--port", str(args.serve),
                    "--sessions", str(args.sessions), "--device", args.device, *rest]
        web_main()
        return

    st = asyncio.run(simulate(n_sessions=args.sessions, device=args.device))
    try:
        import streamlit  # noqa: F401
        in_streamlit = streamlit.runtime.exists()
    except Exception:
        in_streamlit = False

    if in_streamlit:  # pragma: no cover
        render_streamlit(st)
        return
    if args.png:
        render_png(st, args.png)
    render_terminal(st)


if __name__ == "__main__":
    main()
