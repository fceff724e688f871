"""Finding/suppression model for hvlint (`hypervisor_tpu_torch.analysis`).

A `Finding` is one contract violation: a rule id, a `file:line` anchor
the editor can jump to, a stable symbolic `anchor` the suppressions
file keys on (line numbers drift; qualnames and registry entries
don't), a one-line message, and a fix hint.

Suppressions are the ONLY sanctioned way to ship a finding: each entry
must carry a justification string (minimum length enforced — "legacy"
is not a justification), and a suppression that no longer matches any
finding is itself a finding (`HVS001`), so the file can never
accumulate dead waivers that silently re-arm later.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable, Optional

#: Meta-rules about the suppression mechanism itself. Never
#: suppressible — a waiver of the waiver policy is not a thing.
RULE_STALE_SUPPRESSION = "HVS001"
RULE_BAD_SUPPRESSION = "HVS002"

#: Shortest acceptable justification. Long enough that a bare rule id,
#: "ok", or "legacy" cannot pass review by accident.
MIN_JUSTIFICATION = 20


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          #: rule id, e.g. "HVA003"
    file: str          #: repo-relative posix path
    line: int          #: 1-based line of the violating node
    anchor: str        #: stable symbol key (qualname / registry entry)
    message: str       #: one-line statement of the violation
    hint: str = ""     #: how to fix it
    tier: str = "A"    #: "A" (AST) or "B" (lowering-aware)
    suppressed: bool = False
    justification: str = ""

    def location(self) -> str:
        return f"{self.file}:{self.line}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        out = f"{self.rule} {self.location()} ({self.anchor}){tag}: {self.message}"
        if self.hint and not self.suppressed:
            out += f"\n    hint: {self.hint}"
        return out


@dataclasses.dataclass(frozen=True)
class Suppression:
    rule: str
    file: str
    anchor: str
    justification: str

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.file, self.anchor)


def load_suppressions(path: Optional[Path]) -> tuple[list[Suppression], list[Finding]]:
    """Parse the suppressions file; malformed entries become findings.

    Returns (suppressions, findings). A missing file is an empty,
    valid suppression set — zero exceptions is the happy default.
    """
    if path is None or not path.exists():
        return [], []
    rel = path.name
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        return [], [Finding(
            rule=RULE_BAD_SUPPRESSION, file=rel, line=1, anchor="<file>",
            message=f"suppressions file unreadable: {exc}",
            hint="fix the JSON; see docs/OPERATIONS.md 'Static analysis'",
        )]
    entries = doc.get("suppressions", [])
    sups: list[Suppression] = []
    findings: list[Finding] = []
    seen: set[tuple[str, str, str]] = set()
    for i, raw in enumerate(entries):
        where = f"suppressions[{i}]"
        missing = [k for k in ("rule", "file", "anchor", "justification")
                   if not isinstance(raw.get(k), str) or not raw.get(k)]
        if missing:
            findings.append(Finding(
                rule=RULE_BAD_SUPPRESSION, file=rel, line=1, anchor=where,
                message=f"suppression missing required field(s): {missing}",
                hint="every entry needs rule, file, anchor, justification",
            ))
            continue
        if len(raw["justification"].strip()) < MIN_JUSTIFICATION:
            findings.append(Finding(
                rule=RULE_BAD_SUPPRESSION, file=rel, line=1,
                anchor=f"{raw['rule']}:{raw['anchor']}",
                message=(
                    "justification too short "
                    f"({len(raw['justification'].strip())} chars, "
                    f"minimum {MIN_JUSTIFICATION}) — say WHY the contract "
                    "does not apply, not that it doesn't"
                ),
                hint="docs/OPERATIONS.md 'Static analysis' has the policy",
            ))
            continue
        sup = Suppression(
            rule=raw["rule"], file=raw["file"], anchor=raw["anchor"],
            justification=raw["justification"],
        )
        if sup.key() in seen:
            findings.append(Finding(
                rule=RULE_BAD_SUPPRESSION, file=rel, line=1,
                anchor=f"{sup.rule}:{sup.anchor}",
                message="duplicate suppression entry",
                hint="delete one of the duplicates",
            ))
            continue
        seen.add(sup.key())
        sups.append(sup)
    return sups, findings


def apply_suppressions(
    findings: Iterable[Finding], suppressions: list[Suppression],
    suppressions_file: str = "suppressions.json",
    active_rules: Optional[set] = None,
) -> list[Finding]:
    """Mark matching findings suppressed; flag stale suppressions.

    A suppression matches on exact (rule, file, anchor). The returned
    list carries every finding (suppressed ones marked, never dropped —
    `--json` consumers see the full picture) plus one `HVS001` finding
    per suppression that matched nothing. Staleness is only judged for
    rules in `active_rules` (a Tier B-only run must not call every
    Tier A suppression stale).
    """
    by_key = {s.key(): s for s in suppressions}
    used: set[tuple[str, str, str]] = set()
    out: list[Finding] = []
    for f in findings:
        sup = by_key.get((f.rule, f.file, f.anchor))
        if sup is not None:
            used.add(sup.key())
            out.append(dataclasses.replace(
                f, suppressed=True, justification=sup.justification,
            ))
        else:
            out.append(f)
    for s in suppressions:
        if active_rules is not None and s.rule not in active_rules:
            continue
        if s.key() not in used:
            out.append(Finding(
                rule=RULE_STALE_SUPPRESSION, file=suppressions_file, line=1,
                anchor=f"{s.rule}:{s.file}:{s.anchor}",
                message=(
                    "stale suppression: no current finding matches "
                    f"rule={s.rule} file={s.file} anchor={s.anchor}"
                ),
                hint=(
                    "the violation was fixed (or the anchor moved) — "
                    "delete the entry so it cannot silently re-arm later"
                ),
            ))
    return out


def unsuppressed(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if not f.suppressed]
