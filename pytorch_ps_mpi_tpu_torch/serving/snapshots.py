"""Immutable, refcounted, versioned parameter snapshots: a ring of the
last K (``pytorch_ps_mpi_tpu/serving/snapshots.py``).

Every publish of an armed read tier lands one :class:`Snapshot`, the
flat float32 parameter vector frozen (``writeable=False``), in a bounded
ring of the last ``ring`` versions. Readers ``acquire`` a version
(refcount + 1), fan out zero-copy ``memoryview``\\ s of its bytes and
``release`` it; an evicted snapshot that still has readers stays alive
until its last release. One lock guards the ring's bookkeeping.

The store adopts the array it is given when that array is already
contiguous float32, so a caller that keeps writing into its buffer must
hand over a copy: the port's serve loop publishes each version from a
fresh host array when the tier is armed (``parallel/async_train.serve``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np


class Snapshot:
    """One published version: an immutable flat f32 vector + metadata."""

    __slots__ = ("version", "flat", "created_wall", "refs")

    def __init__(self, version: int, flat: np.ndarray):
        flat = np.ascontiguousarray(flat, np.float32)
        # freeze: every reader shares this ONE buffer; a writable array
        # would let an in-process reader corrupt every other reader's view
        flat.flags.writeable = False
        self.version = int(version)
        self.flat = flat
        self.created_wall = time.time()
        self.refs = 0

    @property
    def nbytes(self) -> int:
        return self.flat.nbytes

    def view(self) -> memoryview:
        """Zero-copy read-only bytes of the snapshot (valid while the
        snapshot is held — acquire before fanning views out)."""
        return memoryview(self.flat.view(np.uint8))


class SnapshotStore:
    """Ring of the last ``ring`` published versions, refcounted.

    ``put`` is called from the serve/publish thread; ``acquire`` /
    ``release`` / ``latest`` from reader threads — one lock covers the
    ring bookkeeping (the array payloads themselves are immutable, so
    readers never hold the lock while using a snapshot).
    """

    def __init__(self, ring: int = 8):
        if ring < 1:
            raise ValueError(f"snapshot ring must hold >= 1, got {ring}")
        self.ring = int(ring)
        self._lock = threading.Lock()
        self._by_version: Dict[int, Snapshot] = {}
        self._order: List[int] = []  # insertion order (versions ascend)
        # evicted-but-still-referenced snapshots: alive until release
        self._zombies: Dict[int, Snapshot] = {}
        self.puts = 0
        self.evictions = 0

    def put(self, version: int, flat: np.ndarray) -> Snapshot:
        """Land one immutable snapshot; evicts past the ring bound.
        ``flat`` is adopted (callers pass a freshly flattened vector —
        the store freezes it; pass a copy if you must keep writing)."""
        snap = Snapshot(version, flat)
        with self._lock:
            prev = self._by_version.get(snap.version)
            if prev is not None:
                # re-publish of a pinned version (serve_readonly can pin
                # versions from checkpoint contents): replace, never leave
                # a duplicate _order entry whose eviction would drop the
                # live snapshot
                self._order.remove(snap.version)
                if prev.refs > 0:
                    self._zombies[snap.version] = prev
            self._by_version[snap.version] = snap
            self._order.append(snap.version)
            self.puts += 1
            while len(self._order) > self.ring:
                old = self._order.pop(0)
                dropped = self._by_version.pop(old, None)
                self.evictions += 1
                if dropped is not None and dropped.refs > 0:
                    # readers still hold it: parked until the last release
                    self._zombies[old] = dropped
        return snap

    def resize(self, ring: int) -> None:
        """Live ring-depth change (``snapshots.py:104``, the controller's
        read-tier tuning): growing admits more versions; shrinking evicts
        the oldest at once, a held snapshot parked until its last
        release, as :meth:`put` does."""
        if ring < 1:
            raise ValueError(f"snapshot ring must hold >= 1, got {ring}")
        with self._lock:
            self.ring = int(ring)
            while len(self._order) > self.ring:
                old = self._order.pop(0)
                dropped = self._by_version.pop(old, None)
                self.evictions += 1
                if dropped is not None and dropped.refs > 0:
                    self._zombies[old] = dropped

    def latest(self) -> Optional[Snapshot]:
        with self._lock:
            if not self._order:
                return None
            return self._by_version[self._order[-1]]

    def get(self, version: int) -> Optional[Snapshot]:
        """Ring lookup (NOT acquired — use :meth:`acquire` to hold it)."""
        with self._lock:
            return self._by_version.get(int(version))

    def acquire(self, version: Optional[int] = None) -> Optional[Snapshot]:
        """Pin a version (``None`` = latest) against eviction-death;
        returns None when it is not in the ring (aged out — the caller
        falls back to a full read of latest)."""
        with self._lock:
            if version is None:
                if not self._order:
                    return None
                snap = self._by_version[self._order[-1]]
            else:
                snap = self._by_version.get(int(version))
                if snap is None:
                    return None
            snap.refs += 1
            return snap

    def release(self, snap: Snapshot) -> None:
        with self._lock:
            snap.refs -= 1
            if snap.refs <= 0:
                self._zombies.pop(snap.version, None)

    # -- accounting -------------------------------------------------------
    def versions(self) -> List[int]:
        with self._lock:
            return list(self._order)

    def occupancy(self) -> int:
        with self._lock:
            return len(self._order)

    def refs_out(self) -> int:
        """Snapshots handed out and not yet released (ring + zombies)."""
        with self._lock:
            live = sum(s.refs for s in self._by_version.values())
            return live + sum(s.refs for s in self._zombies.values())

    def snapshot(self) -> Dict[str, object]:
        """Occupancy document for ``/health``'s ``serving`` section."""
        with self._lock:
            versions = list(self._order)
            latest = versions[-1] if versions else 0
            refs = (sum(s.refs for s in self._by_version.values())
                    + sum(s.refs for s in self._zombies.values()))
            return {
                "ring": self.ring,
                "occupancy": len(versions),
                "versions": versions,
                "latest": latest,
                "refs_out": refs,
                "zombies": len(self._zombies),
                "puts": self.puts,
                "evictions": self.evictions,
            }
