"""The plain reference of the saga plane: a call's sagas run to their end
under the upstream's semantics, in the port's round form.

The upstream (`imran-siddique/agent-hypervisor`) runs each saga on its
own: `saga/orchestrator.py:77-143` gives every step 1 + max_retries
attempts under `asyncio.wait_for`, `saga/orchestrator.py:145-198` undoes
the committed steps in reverse order when a step runs out of attempts
(a step with no undo API escalates the saga), and `saga/fan_out.py`
settles a group of branches run together by ALL, MAJORITY or ANY. Here
every saga advances one round at a time, as the program's scheduler
drives its table, and each saga is computed alone, in plain Python:

  * a RUNNING saga makes one forward attempt a round, at its cursor;
  * a fan-out group at the cursor runs all its pending branches in one
    round, once each (no retries), and is settled by its policy: the
    cursor jumps past the group, or the saga starts compensating;
  * a step that fails with no retries left FAILs and the saga starts
    compensating; a step whose attempts remain stays pending;
  * a compensating saga undoes one committed step a round, the highest
    first; a step with no undo fails its compensation and the walk goes
    on to the next;
  * with nothing left committed, a compensating saga ends ESCALATED if
    any compensation failed, else COMPLETED; a running saga whose cursor
    passed its last step COMPLETEs.

Departures from the upstream's per-saga async form: the rounds are in
lock step across sagas (a retry waits for the next round, and the
upstream's backoff `delay * (attempt + 1)` is 0); compensation starts in
the round after the failure and takes one round a step; a step with no
undo does not stop the reverse walk (the remaining steps are still
undone, and the saga ends ESCALATED); a saga whose fan-out group failed
with nothing committed ends COMPLETED in the same round; a timeout is a
failed attempt like a raise. Step and saga codes are the port's
(`ops/saga_ops.py`), which are the upstream's StepState and SagaState in
order.

Nothing here imports the program.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

STEP_PENDING, STEP_COMMITTED, STEP_COMPENSATED = 0, 2, 4
STEP_COMPENSATION_FAILED, STEP_FAILED = 5, 6
SAGA_RUNNING, SAGA_COMPENSATING, SAGA_COMPLETED, SAGA_ESCALATED = 0, 1, 2, 4
TERMINAL = (SAGA_COMPLETED, 3, SAGA_ESCALATED)
#: Policy codes (`saga/fan_out.py` FanOutPolicy.code).
POLICY_ALL, POLICY_MAJORITY, POLICY_ANY = 0, 1, 2

#: What a forward executor does on its attempts (`mode[i, j]`).
OK, FAIL_FIRST, TIMEOUT_FIRST, FAIL_ALWAYS = 0, 1, 2, 3

COUNTERS = ("saga.created", "saga.rounds", "saga.attempts", "saga.retries", "saga.timeouts",
            "saga.undo_attempts", "saga.gate_refusals")


def _policy_ok(policy: int, wins: int, total: int) -> bool:
    if policy == POLICY_ALL:
        return wins == total
    if policy == POLICY_MAJORITY:
        return wins * 2 > total
    return wins >= 1


def run_saga(retries, has_undo, n: int, mode, undo: np.ndarray, groups) -> dict:
    """One saga to its end. `retries` i8[M] and `has_undo` bool[M] its
    row, `n` its steps, `mode` its forward executors' behaviour, `undo`
    bool[M] whether an undo executor is wired, `groups` [(policy, [step
    indices])] its fan-out groups. Returns its final row, the attempts
    and undos of each step, the round in which it ended and its tallies."""
    m = len(retries)
    step = np.zeros(m, np.int8)
    retries = np.array(retries, np.int8)
    cursor, saga = 0, SAGA_RUNNING
    fwd = np.zeros(m, np.int32)
    undos = np.zeros(m, np.int32)
    tally = Counter()
    rounds = 0
    while saga not in TERMINAL:
        rounds += 1
        front = next((g for g in groups if g[1][0] == cursor), None) \
            if saga == SAGA_RUNNING else None
        exec_ok = None      # the cursor step's outcome, when attempted
        undo_target = None  # (step, outcome), when dispatched
        branch_ok = {}
        if saga == SAGA_RUNNING and front is not None:
            for j in front[1]:
                if step[j] == STEP_PENDING:
                    branch_ok[j] = _forward(mode[j], fwd, j, tally)
        elif saga == SAGA_RUNNING and cursor < n and step[cursor] == STEP_PENDING:
            exec_ok = _forward(mode[cursor], fwd, cursor, tally)
        elif saga == SAGA_COMPENSATING:
            committed = np.nonzero(step == STEP_COMMITTED)[0]
            if len(committed):
                t = int(committed[-1])
                if undo[t]:
                    undos[t] += 1
                    tally["saga.undo_attempts"] += 1
                undo_target = (t, bool(undo[t]))
        # The fan-out group settles first, then the round of every other
        # outcome, on the table the group left.
        if branch_ok:
            policy, idxs = front
            for j, ok in branch_ok.items():
                step[j] = STEP_COMMITTED if ok else STEP_FAILED
            wins = sum(1 for j in idxs if branch_ok.get(j, False))
            if _policy_ok(policy, wins, len(idxs)):
                cursor = max(idxs) + 1
            else:
                saga = SAGA_COMPENSATING
        compensating = saga == SAGA_COMPENSATING
        if saga == SAGA_RUNNING:
            if exec_ok is not None:
                if exec_ok:
                    step[cursor] = STEP_COMMITTED
                    cursor += 1
                elif retries[cursor] <= 0:
                    step[cursor] = STEP_FAILED
                    saga = SAGA_COMPENSATING
                else:
                    retries[cursor] -= 1
            if saga == SAGA_RUNNING and cursor >= n > 0:
                saga = SAGA_COMPLETED
        if compensating:
            if undo_target is not None:
                t, ok = undo_target
                step[t] = STEP_COMPENSATED if (has_undo[t] and ok) else STEP_COMPENSATION_FAILED
            if not (step == STEP_COMMITTED).any():
                saga = (SAGA_ESCALATED if (step == STEP_COMPENSATION_FAILED).any()
                        else SAGA_COMPLETED)
    return {"step_state": step, "retries_left": retries, "saga_state": saga, "cursor": cursor,
            "attempts": fwd, "undos": undos, "rounds": rounds, "tally": tally}


def _forward(mode: int, fwd: np.ndarray, j: int, tally: Counter) -> bool:
    """One forward attempt of step j: its outcome."""
    fwd[j] += 1
    tally["saga.attempts"] += 1
    if fwd[j] > 1:
        tally["saga.retries"] += 1
    first = fwd[j] == 1
    if mode == TIMEOUT_FIRST and first:
        tally["saga.timeouts"] += 1
        return False
    return not (mode == FAIL_ALWAYS or (mode == FAIL_FIRST and first))


def run_call(plan: dict) -> dict:
    """Every saga of one call (`plan`: `retries` i8[N, M], `has_undo`
    bool[N, M], `n_steps` i32[N], `mode` i8[N, M], `undo` bool[N, M],
    `groups` {saga index: [(policy, [step indices])]}) to its end: the
    final columns, the attempts and undos of every step, the rounds the
    call takes and the counters' sums."""
    n = len(plan["n_steps"])
    m = plan["retries"].shape[1]
    out = {"step_state": np.zeros((n, m), np.int8), "retries_left": np.zeros((n, m), np.int8),
           "saga_state": np.zeros(n, np.int8), "cursor": np.zeros(n, np.int32),
           "attempts": np.zeros((n, m), np.int32), "undos": np.zeros((n, m), np.int32)}
    tally = Counter({"saga.created": n})
    rounds = 0
    for i in range(n):
        r = run_saga(plan["retries"][i], plan["has_undo"][i], int(plan["n_steps"][i]),
                     plan["mode"][i], plan["undo"][i], plan["groups"].get(i, ()))
        for k in ("step_state", "retries_left", "saga_state", "cursor", "attempts", "undos"):
            out[k][i] = r[k]
        rounds = max(rounds, r["rounds"])
        tally.update(r["tally"])
    tally["saga.rounds"] = rounds
    out["rounds"] = rounds
    out["counters"] = {k: int(tally[k]) for k in COUNTERS}
    return out
