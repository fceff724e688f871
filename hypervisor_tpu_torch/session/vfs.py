"""Session-scoped VFS: the shared state substrate.

Capability parity with reference `session/sso.py:29-216` (write/read/delete
with attribution, path permissions, snapshot/restore, query APIs), with a
TPU-friendly re-design: file contents live in a **content-addressed blob
store** (hash -> bytes) and the mutable state is only the path -> hash map.
Snapshots are therefore O(paths) dict copies that share blobs (the
reference deep-copies every file body, `sso.py:146-149`), and the device
plane can mirror just the fixed-width hash columns (u32[paths, 8]) for
delta capture without ever moving file bodies to HBM.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Iterable, Optional


def content_hash(content: str) -> str:
    """SHA-256 hex of file content (reference `sso.py:214-216`)."""
    return hashlib.sha256(content.encode()).hexdigest()


@dataclass
class VFSEdit:
    """One attributed edit (reference `sso.py:13-22`)."""

    path: str
    operation: str  # "create" | "update" | "delete" | "permission" | "restore"
    agent_did: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    content_hash: Optional[str] = None
    previous_hash: Optional[str] = None


class VFSPermissionError(Exception):
    """Agent lacks permission for a VFS path (reference `sso.py:25-26`)."""


_EMPTY_HASH = content_hash("")


class SessionVFS:
    """Content-addressed session filesystem with attribution + snapshots."""

    def __init__(self, session_id: str, namespace: Optional[str] = None) -> None:
        self.session_id = session_id
        self.namespace = namespace or f"/sessions/{session_id}"
        self._blobs: dict[str, str] = {}        # content hash -> content
        self._tree: dict[str, str] = {}         # full path -> content hash
        self._acl: dict[str, frozenset[str]] = {}  # full path -> allowed DIDs
        self._edits: list[VFSEdit] = []
        self._snapshots: dict[str, tuple[dict[str, str], dict[str, frozenset[str]]]] = {}

    # ── core file ops ────────────────────────────────────────────────

    def write(self, path: str, content: str, agent_did: str) -> VFSEdit:
        """Write a file with agent attribution; permission-checked."""
        full = self._resolve(path)
        self._require_access(full, agent_did)
        exists = full in self._tree
        prev = self._tree.get(full)
        h = content_hash(content)
        self._blobs.setdefault(h, content)
        self._tree[full] = h
        edit = VFSEdit(
            path=full,
            operation="update" if exists else "create",
            agent_did=agent_did,
            content_hash=h,
            previous_hash=prev if exists else None,
        )
        self._edits.append(edit)
        return edit

    def read(self, path: str, agent_did: Optional[str] = None) -> Optional[str]:
        """Read a file; permission-checked when agent_did is given."""
        full = self._resolve(path)
        if agent_did is not None:
            self._require_access(full, agent_did)
        h = self._tree.get(full)
        return None if h is None else self._blobs[h]

    def delete(self, path: str, agent_did: str) -> VFSEdit:
        """Delete a file with attribution; raises FileNotFoundError if absent."""
        full = self._resolve(path)
        if full not in self._tree:
            raise FileNotFoundError(f"{full} not found in session VFS")
        self._require_access(full, agent_did)
        prev = self._tree.pop(full)
        self._acl.pop(full, None)
        edit = VFSEdit(
            path=full, operation="delete", agent_did=agent_did, previous_hash=prev
        )
        self._edits.append(edit)
        return edit

    def list_files(self) -> list[str]:
        """Relative paths of all files in this session's namespace."""
        ns = self.namespace
        return [p[len(ns):] for p in self._tree if p.startswith(ns)]

    # ── permissions ──────────────────────────────────────────────────

    def set_permissions(
        self, path: str, allowed_agents: Iterable[str], agent_did: str
    ) -> VFSEdit:
        """Restrict a path to a set of agent DIDs (open by default)."""
        full = self._resolve(path)
        self._acl[full] = frozenset(allowed_agents)
        edit = VFSEdit(path=full, operation="permission", agent_did=agent_did)
        self._edits.append(edit)
        return edit

    def clear_permissions(self, path: str) -> None:
        self._acl.pop(self._resolve(path), None)

    def get_permissions(self, path: str) -> Optional[set[str]]:
        acl = self._acl.get(self._resolve(path))
        return None if acl is None else set(acl)

    # ── snapshots (O(paths); blobs shared, never copied) ─────────────

    def create_snapshot(self, snapshot_id: Optional[str] = None) -> str:
        import uuid

        sid = snapshot_id or f"snap:{uuid.uuid4()}"
        self._snapshots[sid] = (dict(self._tree), dict(self._acl))
        return sid

    def restore_snapshot(self, snapshot_id: str, agent_did: str) -> None:
        if snapshot_id not in self._snapshots:
            raise KeyError(f"Snapshot {snapshot_id} not found")
        tree, acl = self._snapshots[snapshot_id]
        self._tree = dict(tree)
        self._acl = dict(acl)
        self._edits.append(
            VFSEdit(path=self.namespace, operation="restore", agent_did=agent_did)
        )

    def list_snapshots(self) -> list[str]:
        return list(self._snapshots)

    def delete_snapshot(self, snapshot_id: str) -> None:
        if snapshot_id not in self._snapshots:
            raise KeyError(f"Snapshot {snapshot_id} not found")
        del self._snapshots[snapshot_id]

    # ── queries ──────────────────────────────────────────────────────

    @property
    def edit_log(self) -> list[VFSEdit]:
        return list(self._edits)

    def edits_by_agent(self, agent_did: str) -> list[VFSEdit]:
        return [e for e in self._edits if e.agent_did == agent_did]

    @property
    def file_count(self) -> int:
        return len(self._tree)

    @property
    def snapshot_count(self) -> int:
        return len(self._snapshots)

    def file_hash(self, path: str) -> Optional[str]:
        """Content hash of a path without touching the blob (device-mirror column)."""
        return self._tree.get(self._resolve(path))

    # ── internals ────────────────────────────────────────────────────

    def _resolve(self, path: str) -> str:
        if path.startswith(self.namespace):
            return path
        return f"{self.namespace}/{path.lstrip('/')}"

    def _require_access(self, full_path: str, agent_did: str) -> None:
        acl = self._acl.get(full_path)
        if acl is not None and agent_did not in acl:
            raise VFSPermissionError(
                f"Agent {agent_did} not permitted to access {full_path}"
            )
