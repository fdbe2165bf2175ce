"""The follower tier: a read-only replica that subscribes to an upstream
read tier and re-serves it (``pytorch_ps_mpi_tpu/serving/follower.py``).

:class:`FollowerLoop` runs a :class:`~.net.ServingReader` against the
upstream read port (the root's or another replica's) and republishes
every new version, pinned to the upstream's version number, into a
local :class:`~.core.ServingCore`, whose own read server then serves
readers or further replicas; follower -> follower builds the tree.
Each ``not_modified`` poll doubles the sleep up to ``max_poll_s``
(:data:`MAX_POLL_S` by default); a new version resets it to ``poll_s``.
:meth:`FollowerLoop.repoint` re-parents the subscription (the elastic
read tier's structural control). A lost upstream (root restart,
partition) tears the reader down and re-dials with the same backoff,
while the replica keeps serving its last version.

Accounting goes through the local core: ``replica_lag_versions`` (how
far the replica trailed the upstream version it pulled, decayed by an
EWMA on idle polls) and ``follower_bytes_relayed``. Every republish
relays the upstream's FRS1 trailer with this hop's record appended, so
a version's trailer carries the whole chain from the root. With
``anatomy`` (a :class:`~pytorch_ps_mpi_tpu_torch.telemetry.anatomy.
RoundAnatomy`), each version pulled is a ``reader_round`` row there.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

#: seconds an idle or lost upstream's poll backs off to at most
MAX_POLL_S = 8.0


class FollowerLoop:
    """Subscribe to an upstream read tier; republish into ``core``.

    Parameters
    ----------
    core:
        The local :class:`~.core.ServingCore` to republish into (armed
        with its own ``read_port`` so downstream readers can connect).
    host, port:
        Upstream read-tier endpoint (the root's — or another replica's
        — ``read_port``).
    template:
        Parameter pytree template (defaults to ``core.template``);
        required to decode the upstream payloads.
    poll_s / max_poll_s:
        Pull cadence bounds: every ``not_modified`` doubles the sleep
        from ``poll_s`` up to ``max_poll_s``; a new version resets it.
    anatomy:
        Optional :class:`~pytorch_ps_mpi_tpu_torch.telemetry.anatomy.
        RoundAnatomy`; each version pulled feeds it one reader round
        (pull wall, age at pull, lag), the replica's own critical-path
        record.
    """

    def __init__(self, core, host: str, port: int, *,
                 template=None, tenant: str = "",
                 poll_s: float = 0.25, max_poll_s: float = MAX_POLL_S,
                 timeout: float = 10.0,
                 serving_kw: Optional[dict] = None, anatomy=None):
        self.core = core
        self.anatomy = anatomy
        self.host = str(host)
        self.port = int(port)
        self.template = template if template is not None else core.template
        if self.template is None:
            raise ValueError("FollowerLoop needs a parameter template "
                             "(pass template= or arm the core with one)")
        self.tenant = str(tenant)
        self.poll_s = float(poll_s)
        self.max_poll_s = max(float(max_poll_s), self.poll_s)
        self.timeout = float(timeout)
        self.serving_kw = dict(serving_kw or {})
        from pytorch_ps_mpi_tpu_torch.telemetry.diagnosis import Ewma

        # replica lag decays through an EWMA (the diagnosis.py
        # discipline) instead of snapping to zero on idle polls: a lag
        # spike observed at pull time stays visible to the controller
        # for a few windows instead of vanishing one poll later
        self._lag_ewma = Ewma(alpha=0.25)
        self._reader = None
        self._sleep_s = self.poll_s
        self._relayed_mark = 0  # reader.bytes_received already credited
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # accounting (smokes/tests read these)
        self.polls = 0
        self.republished = 0
        self.not_modified = 0
        self.reconnects = 0
        self.upstream_version = 0
        self.last_error: Optional[str] = None

    # -- one pull ---------------------------------------------------------
    def _connect(self):
        from pytorch_ps_mpi_tpu_torch.serving.net import ServingReader

        reader = ServingReader(
            self.host, self.port, self.template, tenant=self.tenant,
            timeout=self.timeout, serving_kw=self.serving_kw,
            device=self.core.device)
        self._relayed_mark = 0
        return reader

    def _extend_trailer(self, reader, version: int) -> bytes:
        """The upstream trailer for ``version`` with THIS hop's record
        appended (arrival wall on this clock, skew vs upstream from the
        reader's lower-envelope fit). ``b""`` — republish with no
        trailer — when upstream sent none or it describes a different
        version (a publish raced the pull): the birth record is
        relayed exactly or not at all, never re-stamped downstream."""
        doc = reader.fresh
        if doc is None or doc["version"] != version:
            return b""
        from pytorch_ps_mpi_tpu_torch.telemetry.freshness import append_hop

        try:
            return append_hop(reader.fresh_raw, doc["hop_count"] + 1,
                              reader.fresh_recv_wall,
                              skew_ms=reader.reader_skew_s() * 1e3)
        except ValueError:
            return b""

    def _teardown(self) -> None:
        if self._reader is not None:
            try:
                self._reader.close()
            except Exception:
                pass
            self._reader = None

    def repoint(self, host: str, port: int) -> bool:
        """Re-parent the subscription (``follower.py:146``): tear the
        reader down and aim the next poll at ``host:port``. Idempotent;
        the local core keeps serving its last version across the switch,
        and versions are the root's, so a re-parented replica never goes
        backwards. True when the endpoint changed."""
        host, port = str(host), int(port)
        if (host, port) == (self.host, self.port) \
                and self._reader is not None:
            return False
        self.host, self.port = host, port
        self._teardown()
        self._sleep_s = self.poll_s  # re-dial the new parent promptly
        return True

    def step(self) -> Dict[str, Any]:
        """One poll against upstream.  Returns a status row
        (``outcome`` is one of ``republished`` / ``not_modified`` /
        ``retry``); never raises — upstream failures become
        ``outcome="retry"`` with the reconnect backoff armed."""
        self.polls += 1
        t0 = time.perf_counter()
        try:
            if self._reader is None:
                self._reader = self._connect()
                self.reconnects += 1
            reader = self._reader
            before = self.core.latest_version(None)
            _, version = reader.read_params()
            self.upstream_version = max(self.upstream_version, int(version))
            # credit only the NEW bytes this poll pulled off the wire
            fresh = reader.bytes_received - self._relayed_mark
            self._relayed_mark = reader.bytes_received
            if fresh > 0:
                self.core.note_relayed(fresh)
            lag = max(0, int(version) - before)
            if int(version) > before:
                # lag as observed at pull time: how far downstream was
                # behind the instant the new version arrived — folded
                # into the EWMA, so it decays over later polls instead
                # of being clobbered back to zero
                self._lag_ewma.update(float(lag))
                self.core.set_replica_lag(self._lag_ewma.value)
                # the store adopts + freezes its input; the reader keeps
                # applying deltas to _flat, so hand the ring a copy
                self.core.publish(
                    flat=np.array(reader._flat, dtype=np.float32),
                    version=int(version), template=self.template,
                    fresh=self._extend_trailer(reader, int(version)))
                self.republished += 1
                self._sleep_s = self.poll_s
                outcome = "republished"
                row = {"outcome": outcome, "version": int(version),
                       "lag": lag,
                       # wall age (this clock, skew-corrected) of the
                       # version at the moment it was pulled
                       "age_ms": round(reader.fresh_age_ms(), 3),
                       "relayed_bytes": int(max(fresh, 0)),
                       "pull_s": round(time.perf_counter() - t0, 6),
                       "upstream": f"{self.host}:{self.port}"}
                if self.anatomy is not None:
                    self.anatomy.observe_reader_round(dict(row))
                return row
            self.not_modified += 1
            # idle: the observed lag DECAYS (EWMA toward zero) — the
            # replica is provably current, but the spike that preceded
            # catch-up stays visible for a few windows
            self._lag_ewma.update(0.0)
            self.core.set_replica_lag(self._lag_ewma.value)
            # idle: exponential backoff so a quiet upstream costs ~0
            self._sleep_s = min(self._sleep_s * 2.0, self.max_poll_s)
            outcome = "not_modified"
        except (ConnectionError, TimeoutError, OSError, RuntimeError) as e:
            # resilient reconnect: drop the broken reader, back off, and
            # re-dial next poll — the local core keeps serving its last
            # published version throughout (root-restart survival)
            self.last_error = f"{type(e).__name__}: {e}"
            self._teardown()
            self._sleep_s = min(max(self._sleep_s, self.poll_s) * 2.0,
                                self.max_poll_s)
            outcome = "retry"
        return {"outcome": outcome, "version": self.upstream_version,
                "lag": max(0, self.upstream_version
                           - self.core.latest_version(None)),
                "sleep_s": round(self._sleep_s, 3)}

    # -- lifecycle --------------------------------------------------------
    def run(self, stop: Optional[threading.Event] = None) -> None:
        """Poll until ``stop`` (or :meth:`close`) is set."""
        stop = stop or self._stop
        while not (stop.is_set() or self._stop.is_set()):
            self.step()
            stop.wait(self._sleep_s)
        self._teardown()

    def start(self) -> "FollowerLoop":
        """Run :meth:`run` on a daemon thread (the serve_readonly
        ``--follow-endpoint`` path)."""
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"follower:{self.host}:{self.port}")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 5)
            self._thread = None
        self._teardown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
