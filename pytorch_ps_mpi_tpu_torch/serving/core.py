"""ServingCore: the read tier a PS server, a shard server or a read-only
replica sits on (``pytorch_ps_mpi_tpu/serving/core.py``).

:class:`ServingCore` owns:

- the **snapshot stores** (:class:`~.snapshots.SnapshotStore`), one
  refcounted ring of immutable versions per *tenant*, so one core (and
  one sharded fleet) serves many jobs;
- the **read path**: version-conditional reads answered not-modified,
  delta (:class:`~.delta.DeltaCodec`) or full, with an **encode cache**
  that coalesces identical asks into one encode per (base, latest) pair;
- the **admission knobs** the network loop enforces (backlog depth,
  retry-after) and every read-tier counter, surfaced in the server's
  canonical ``metrics()`` and on its scrape registry
  (``ps_read_seconds`` and the ``ps_*`` read gauges and counters);
- the read server itself: the native C++ tier
  (:class:`~.native_read.NativeReadServer`) with ``cfg["read_native"]``
  ``"auto"`` (the default) and the Python loop
  (:class:`~.net.ReadTierServer`) when that is off, ``PS_NO_NATIVE`` is
  set, or the library will not build or bind.

The tier arms on ``cfg["serving"]`` (in-process store only) or
``cfg["read_port"]`` (store plus a network read server; 0 picks a free
port, read back as :attr:`read_port`). Unarmed with a server,
:meth:`publish` is exactly the transport's publish.

The core also builds a server's monitors from the cfg (``core.py:264``):
``health``/``health_dir``/``health_port`` a :class:`~pytorch_ps_mpi_tpu_torch.
telemetry.diagnosis.HealthMonitor`, ``numerics``/``numerics_dir``/
``numerics_kw`` a :class:`~pytorch_ps_mpi_tpu_torch.telemetry.numerics.
NumericsMonitor`, ``lineage``/``lineage_dir`` (on a framed wire) a
:class:`~pytorch_ps_mpi_tpu_torch.telemetry.lineage.LineageTracker` with
its :class:`~pytorch_ps_mpi_tpu_torch.telemetry.anatomy.RoundAnatomy`
(``cfg["anatomy"]``, ``"auto"`` by default), ``metrics_port``/
``health_port`` the server's ``/metrics`` and ``/health`` endpoint, and
``freshness``/``hop_anatomy`` through ``server.arm_observability``. A
core without a server serves ``/metrics`` and ``/health`` from an
endpoint of its own, and with ``fleet``/``fleet_dir`` registers it for
the fleet pane (``telemetry/fleet.py``: name ``cfg["fleet_name"]`` or
``read-tier``, role ``cfg["fleet_role"]`` or ``read``) and serves
``/fleet`` there. The controller's actuators are
:meth:`ServingCore.set_admission_depth` and :meth:`ServingCore.set_ring`.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pytorch_ps_mpi_tpu_torch.serving.delta import DELTA_KNOBS, DeltaCodec
from pytorch_ps_mpi_tpu_torch.serving.net import (KIND_DELTA, KIND_ERROR,
                                                  KIND_FULL,
                                                  KIND_NOT_MODIFIED,
                                                  KIND_RETRY)
from pytorch_ps_mpi_tpu_torch.serving.snapshots import SnapshotStore
from pytorch_ps_mpi_tpu_torch.telemetry import freshness as _freshness

Tree = Any

DEFAULT_TENANT = "default"

#: serving knobs and their defaults (overridable via ``cfg["serving_kw"]``)
SERVING_KNOBS: Dict[str, Any] = {
    "ring": 8,              # snapshot ring depth (versions kept)
    "admission_depth": 64,  # read backlog bound; past it requests shed
    "retry_after_s": 0.05,  # suggested client backoff on a shed reply
    "rate_window_s": 5.0,   # reads/s window of serving_snapshot
    **DELTA_KNOBS,
}

# read-latency buckets: 10 us in-process hits through multi-second stalls
_READ_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5)

#: the address the read server binds
READ_HOST = "0.0.0.0"

#: the read counters the native tier keeps in C++ and folds into the core's
_NATIVE_COUNTERS = ("reads_total", "reads_full", "reads_delta",
                    "reads_not_modified", "reads_shed", "coalesce_hits",
                    "delta_bytes_saved")


def _seq_quantile(sorted_xs, q: float) -> float:
    """Nearest-rank quantile of an already-sorted sequence; 0.0 empty."""
    if not sorted_xs:
        return 0.0
    return float(sorted_xs[min(len(sorted_xs) - 1,
                               int(round(q * (len(sorted_xs) - 1))))])


class ServingCore:
    """Snapshots and the read path, independent of any trainer loop.

    ``server`` is a PS transport server (shm or TCP) or ``None`` for a
    standalone (read-only, replica or test) core; ``cfg`` is the fleet's
    config dict. ``device`` is where a lossy delta codec encodes (the
    server's device, else ``cfg["device"]``, else the card).
    ``monitors=False`` skips the monitor construction for a caller that
    builds its own (the shard server). A standalone core scrapes into
    ``registry`` (a fresh one by default); the read server binds
    ``read_host``.
    """

    def __init__(self, server=None, cfg: Optional[Dict[str, Any]] = None,
                 *, template: Tree = None, tenant: str = DEFAULT_TENANT,
                 device=None, monitors: bool = True, registry=None,
                 read_host: str = READ_HOST):
        cfg = cfg or {}
        self.cfg = cfg
        self.server = server
        self.default_tenant = str(tenant)
        self.template = (template if template is not None
                         else getattr(server, "template", None))
        if device is None:
            device = getattr(server, "device", None) or cfg.get("device",
                                                                "cuda")
        self.device = device
        self.knobs = dict(SERVING_KNOBS)
        self.knobs.update(cfg.get("serving_kw") or {})
        self.armed = bool(cfg.get("serving")
                          or cfg.get("read_port") is not None)
        self.admission_depth = int(self.knobs["admission_depth"])
        self.retry_after_s = float(self.knobs["retry_after_s"])
        # -- monitor plumbing (``core.py:112-120``) -----------------------
        self.health = None
        self.numerics = None
        self.lineage = None
        self.anatomy = None
        self.metrics_http_port: Optional[int] = None
        #: a standalone core's freshness tracker; a server's lives on the
        #: server (``arm_observability``)
        self.freshness_tracker = None
        self._own_http = None
        if server is not None:
            self._reg = server.scrape_registry()
        else:
            from pytorch_ps_mpi_tpu_torch.telemetry import MetricsRegistry

            self._reg = registry if registry is not None \
                else MetricsRegistry()

        # -- read-path state ----------------------------------------------
        self._lock = threading.Lock()
        self._stores: Dict[str, SnapshotStore] = {}
        self._templates: Dict[str, Tree] = {}
        self._deltas: Dict[str, DeltaCodec] = {}
        self._versions: Dict[str, int] = {}
        self._tenant_reads: Dict[str, int] = {}
        self._encode_cache: Dict[Tuple[str, int, int], np.ndarray] = {}
        self._rate: Dict[int, int] = {}  # monotonic second -> reads
        self.reads_total = 0
        self.reads_full = 0
        self.reads_delta = 0
        self.reads_not_modified = 0
        self.reads_shed = 0
        self.coalesce_hits = 0
        self.delta_bytes_saved = 0
        self.ring_ageouts = 0
        self.delta_full_fallbacks = 0
        #: seconds an armed publish spent allocating its host array and
        #: copying the device's flat into it (:meth:`publish_device`), in
        #: the transport's publish, the ring put, and the native tier's
        #: pre-encode of the ring's deltas
        self.publish_times = {"alloc_s": 0.0, "d2h_s": 0.0,
                              "transport_s": 0.0, "ring_put_s": 0.0,
                              "pre_encode_s": 0.0}
        self.publishes = 0
        self._pinned = None  # the unarmed publish's one host buffer
        # -- freshness (telemetry/freshness.py) ---------------------------
        # tenant -> {"version", "blob", "doc", "birth_local"}: the FRS1
        # birth record of the version served, stamped at publish (root)
        # or relayed and extended (follower)
        self._fresh: Dict[str, Dict[str, Any]] = {}
        # publish -> visible-here latencies (ms); empty at the root
        self._fresh_lat: collections.deque = collections.deque(maxlen=512)
        # smallest nonzero have_version answered, per tenant
        self._fresh_min_have: Dict[str, int] = {}
        self.fresh_replies = 0
        # a restarted root's versions restart too: readers must not join
        # ages across generations
        self.fresh_root_gen = int(time.time()) & 0xFFFFFFFF
        self._read_hist = self._reg.histogram(
            "ps_read_seconds", _READ_BUCKETS,
            "read-tier request service time (parse -> reply queued)")
        self._t0 = time.monotonic()

        if self.armed and self.template is not None:
            # the default tenant's store exists from construction so the
            # first publish and the first read cannot race its creation
            self._ensure_tenant(self.default_tenant, self.template)

        self.read_server = None
        self.read_port: Optional[int] = None
        self.read_native = False
        # follower-tier accounting (serving.follower.FollowerLoop)
        self.replica_lag_versions = 0
        self.follower_bytes_relayed = 0
        if self.armed and cfg.get("read_port") is not None:
            rn = cfg.get("read_native", "auto")
            if rn not in (False, "off", 0):
                from pytorch_ps_mpi_tpu_torch.utils.native import \
                    fast_path_disabled

                if not fast_path_disabled():
                    from pytorch_ps_mpi_tpu_torch.serving.native_read import (
                        NativeReadServer, get_read_lib)

                    if get_read_lib() is not None:
                        try:
                            self.read_server = NativeReadServer(
                                self, port=int(cfg["read_port"]),
                                host=read_host)
                            self.read_native = True
                        except RuntimeError:
                            self.read_server = None  # port taken etc.
            if self.read_server is None:
                from pytorch_ps_mpi_tpu_torch.serving.net import \
                    ReadTierServer

                self.read_server = ReadTierServer(
                    self, port=int(cfg["read_port"]), host=read_host)
            self.read_port = self.read_server.port
        self._fleet = None
        self._fleet_registration = None
        self._register_scrape()
        if server is not None:
            # attached last: a thread that finds the core finds its port
            server.serving_core = self
            if monitors:
                self._build_monitors(cfg)
        else:
            self._start_own_http(cfg)

    # -- monitor plumbing ---------------------------------------------------
    def _build_monitors(self, cfg: Dict[str, Any]) -> None:
        """Health, numerics and lineage monitors, the round anatomy, the
        metrics endpoint and the per-process observability plane of a
        server (``core.py:264-337``), so every core-based server wires
        them alike."""
        server = self.server
        if (cfg.get("health") or cfg.get("health_dir")
                or cfg.get("health_port") is not None):
            from pytorch_ps_mpi_tpu_torch.telemetry.diagnosis import \
                HealthMonitor

            # attaches itself to server.health_monitor (the /health
            # route) and registers its instruments on the scrape registry
            self.health = HealthMonitor(server, cfg)
        if (cfg.get("numerics") or cfg.get("numerics_dir")
                or cfg.get("numerics_kw")):
            from pytorch_ps_mpi_tpu_torch.telemetry.numerics import \
                NumericsMonitor

            # attaches itself to server.numerics_monitor: the canonical
            # metrics grow the numerics keys, /health gains "numerics",
            # and the serve loop validates every consumed push
            self.numerics = NumericsMonitor(server, cfg)
        if cfg.get("lineage") or cfg.get("lineage_dir"):
            if getattr(server, "frame", False):
                from pytorch_ps_mpi_tpu_torch.telemetry.lineage import \
                    LineageTracker

                # attaches itself to server.lineage_tracker: the framed
                # consume feeds it every consumed push's trace ID
                self.lineage = LineageTracker(server, cfg)
                anat = cfg.get("anatomy", "auto")
                if anat not in (False, "off", 0):
                    from pytorch_ps_mpi_tpu_torch.telemetry.anatomy import \
                        RoundAnatomy

                    # rides armed lineage by default ("auto"), fed one
                    # publish row a version by the tracker
                    self.anatomy = RoundAnatomy(server, cfg)
                    self.lineage.anatomy = self.anatomy
            else:
                # the trace ID rides the frame header: without frames
                # there is nothing on the wire to trace
                print("lineage tracing requires frame_check=True; "
                      "not armed", flush=True)
        http_port = cfg.get("metrics_port")
        if http_port is None:
            http_port = cfg.get("health_port")  # one endpoint serves both
        if http_port is not None and hasattr(server, "start_metrics_http"):
            self.metrics_http_port = server.start_metrics_http(
                int(http_port))
            print(f"prometheus /metrics + /health on port "
                  f"{self.metrics_http_port}", flush=True)
        if hasattr(server, "arm_observability"):
            server.arm_observability(cfg)

    def _start_own_http(self, cfg: Dict[str, Any]) -> None:
        """A standalone core (no transport server) serves ``/metrics`` and
        ``/health`` from an endpoint of its own (``core.py:216-238``)."""
        http_port = cfg.get("metrics_port")
        if http_port is None:
            http_port = cfg.get("health_port")
        if http_port is None:
            return
        import json

        from pytorch_ps_mpi_tpu_torch.telemetry.http_server import \
            MetricsHTTPServer

        self._own_http = MetricsHTTPServer(
            self._reg.prometheus_text, port=int(http_port),
            routes={"/health": lambda: (json.dumps(
                {"armed": False, "workers": [], "ts": time.time(),
                 "uptime_s": round(time.monotonic() - self._t0, 3),
                 "serving": self.serving_snapshot()}),
                "application/json")})
        self.metrics_http_port = self._own_http.port
        # the read tier joins the fleet pane like any server
        # (``core.py:239-262``): it registers its endpoint and serves the
        # merged /fleet snapshot itself
        if cfg.get("fleet") or cfg.get("fleet_dir"):
            from pytorch_ps_mpi_tpu_torch.telemetry import fleet as _fleet

            self._fleet = _fleet.FleetMonitor(
                endpoints=cfg.get("fleet_endpoints"),
                fleet_dir=cfg.get("fleet_dir"),
                **(cfg.get("fleet_kw") or {}))
            self._own_http.add_route("/fleet", self._fleet.render_http)
            if cfg.get("fleet_dir"):
                fname = str(cfg.get("fleet_name") or "read-tier")
                _fleet.register_endpoint(
                    cfg["fleet_dir"], fname, self._own_http.port,
                    role=cfg.get("fleet_role", "read"),
                    **(cfg.get("fleet_meta") or {}))
                self._fleet_registration = (cfg["fleet_dir"], fname)

    def tick(self) -> None:
        """Monitor upkeep at the owning loop's tick cadence (same thread
        as the transport pumps, as the monitors require): the beacon and
        probe tails, then the history sample and the SLO sweep (both
        self-throttled, one attribute check when unarmed)."""
        if self.health is not None:
            self.health.tick()
        if self.numerics is not None:
            self.numerics.tick()
        srv = self.server
        if srv is not None and srv.timeseries_db is not None:
            srv.observability_tick()

    # -- publish ----------------------------------------------------------
    def _ensure_tenant(self, tenant: str, template: Tree) -> SnapshotStore:
        with self._lock:
            store = self._stores.get(tenant)
            if store is None:
                store = SnapshotStore(int(self.knobs["ring"]))
                self._stores[tenant] = store
                if template is not None:
                    self._templates[tenant] = template
                self._tenant_reads.setdefault(tenant, 0)
            return store

    def publish(self, params: Tree = None, *, flat: np.ndarray = None,
                tenant: Optional[str] = None,
                version: Optional[int] = None,
                template: Tree = None,
                fresh: Optional[bytes] = None) -> int:
        """Publish one version: through the transport server (primary
        tenant) and, armed, into the snapshot ring. Returns the version.

        Unarmed with a server this is exactly the transport's publish
        (``publish_flat(flat)``, or ``publish(params)``). Armed, the ring
        adopts ``flat`` (frozen, zero-copy): pass an array nobody writes
        into again. Side tenants and serverless cores version locally
        (``version=`` pins one, e.g. a restored checkpoint's).

        ``fresh`` is a relayed FRS1 trailer (a follower passes the
        upstream's with its own hop appended); ``None`` stamps a new birth
        here, where this core is the version's root.
        """
        tenant = tenant or self.default_tenant
        primary = (self.server is not None
                   and tenant == self.default_tenant)
        if not self.armed:
            if not primary:
                raise ValueError(
                    "read tier is unarmed: side-tenant/serverless publish "
                    "has nowhere to go (set cfg['serving'] or "
                    "cfg['read_port'])")
            if flat is not None:
                self.server.publish_flat(flat)
            else:
                self.server.publish(params)
            return self.server.version
        if flat is None:
            from pytorch_ps_mpi_tpu_torch.parallel.dcn import flatten_params

            flat = flatten_params(params)
        t0 = time.perf_counter()
        if primary:
            self.server.publish_flat(flat)
            version = self.server.version
        elif version is None:
            version = self._versions.get(tenant, 0) + 1
        version = int(version)
        self._versions[tenant] = version
        t1 = time.perf_counter()
        store = self._stores.get(tenant)
        if store is None:
            store = self._ensure_tenant(
                tenant, template if template is not None
                else (params if params is not None else self.template))
        store.put(version, flat)
        with self._lock:
            # a new latest ends the coalescing window: cached encodes
            # against the previous latest can never be served again
            for k in [k for k in self._encode_cache if k[0] == tenant]:
                del self._encode_cache[k]
        blob, doc = self._stamp_fresh(tenant, version, fresh)
        t2 = time.perf_counter()
        if self.read_native:
            # the version's boundary: the frozen snapshot, the ring's
            # deltas and the trailer go to the native tier, the only
            # Python its read path runs
            self.read_server.on_publish(
                tenant, version, store, fresh=blob,
                publish_wall=(doc["publish_wall"] if doc is not None
                              else 0.0))
        t3 = time.perf_counter()
        with self._lock:
            self.publishes += 1
            self.publish_times["transport_s"] += t1 - t0
            self.publish_times["ring_put_s"] += t2 - t1
            self.publish_times["pre_encode_s"] += t3 - t2
        return version

    def publish_device(self, flat) -> int:
        """Publish the server's flat float32 tensor, on its device, as
        the primary tenant's next version: the one D2H a publish. Armed,
        the copy goes into a new host array (pinned when ``flat`` is on
        the card) that the ring keeps, its allocation and copy timed
        apart; unarmed, into one host buffer reused every publish and
        handed straight to the transport, so an unarmed loop pays nothing
        for the tier."""
        pin = flat.device.type == "cuda"
        if not self.armed:
            if self._pinned is None:
                self._pinned = torch.empty(flat.numel(), dtype=torch.float32,
                                           pin_memory=pin)
            self._pinned.copy_(flat)
            return self.publish(flat=self._pinned.numpy())
        if pin:
            # the copy would wait for the update: keep that out of its time
            torch.cuda.current_stream(flat.device).synchronize()
        t0 = time.perf_counter()
        host = torch.empty(flat.numel(), dtype=torch.float32, pin_memory=pin)
        t1 = time.perf_counter()
        host.copy_(flat)
        t2 = time.perf_counter()
        with self._lock:
            self.publish_times["alloc_s"] += t1 - t0
            self.publish_times["d2h_s"] += t2 - t1
        return self.publish(flat=host.numpy())

    def _stamp_fresh(self, tenant: str, version: int,
                     fresh: Optional[bytes]
                     ) -> Tuple[bytes, Optional[Dict[str, Any]]]:
        """Install the version's FRS1 birth record: a new one (root) or a
        relayed trailer, validated (follower). A malformed relay is
        dropped: the version serves with no trailer."""
        if fresh is None:
            blob = _freshness.pack_birth(version, time.time(),
                                         self.fresh_root_gen)
        elif not fresh:
            # upstream sent no trailer: a birth record travels end to end
            # or not at all, never re-stamped mid-chain
            return b"", None
        else:
            blob = bytes(fresh)
        try:
            doc = _freshness.unpack_trailer(blob)
        except ValueError:
            ft = self._fresh_tracker()
            if ft is not None:
                ft.note_reject()
            return b"", None
        with self._lock:
            self._fresh[tenant] = {
                "version": version, "blob": blob, "doc": doc,
                "birth_local": _freshness.birth_wall_local(doc)}
            vis = _freshness.visible_latency_ms(doc)
            if vis is not None:
                self._fresh_lat.append(vis)
        ft = self._fresh_tracker()
        if ft is not None:
            ft.note_publish(tenant, doc)
        return blob, doc

    def _fresh_tracker(self):
        ft = self.freshness_tracker
        if ft is None and self.server is not None:
            ft = getattr(self.server, "freshness_tracker", None)
        return ft

    def fresh_trailer(self, tenant: Optional[str] = None,
                      version: Optional[int] = None) -> bytes:
        """The FRS1 trailer of a reply delivering ``version`` (b"" when
        none is installed or a publish raced the reply to another
        version). Counts the reply."""
        rec = self._fresh.get(tenant or self.default_tenant)
        if rec is None:
            return b""
        if version is not None and rec["version"] != int(version):
            return b""
        with self._lock:
            self.fresh_replies += 1
        return rec["blob"]

    def fresh_ages_ms(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per tenant, the wall age (local clock) of the version served."""
        t = time.time() if now is None else float(now)
        with self._lock:
            return {tn: max(0.0, (t - rec["birth_local"]) * 1e3)
                    for tn, rec in self._fresh.items()}

    def serving_age_ms(self, now: Optional[float] = None) -> float:
        """The oldest tenant's age: the canonical ``serving_age_ms``."""
        ages = self.fresh_ages_ms(now)
        return max(ages.values()) if ages else 0.0

    # -- read path --------------------------------------------------------
    def _delta(self, tenant: str) -> DeltaCodec:
        dc = self._deltas.get(tenant)
        if dc is None:
            tmpl = self._templates.get(tenant)
            if tmpl is None:
                raise ValueError(f"no template recorded for tenant "
                                 f"{tenant!r}")
            dc = DeltaCodec.from_knobs(tmpl, self.knobs, device=self.device)
            with self._lock:  # scrape threads iterate _deltas under it
                dc = self._deltas.setdefault(tenant, dc)
        return dc

    def latest_version(self, tenant: Optional[str] = None) -> int:
        store = self._stores.get(tenant or self.default_tenant)
        if store is None:
            return 0
        snap = store.latest()
        return snap.version if snap is not None else 0

    def note_shed(self) -> None:
        with self._lock:
            self.reads_shed += 1

    # -- the controller's actuators (``core.py:522``, ``:548``) ----------
    def set_admission_depth(self, depth: int) -> None:
        """Live admission-depth change: the Python read loop reads
        ``admission_depth`` at every enqueue, the native one is told."""
        if depth < 1:
            raise ValueError(f"admission depth must be >= 1, got {depth}")
        self.admission_depth = int(depth)
        if self.read_native:
            self.read_server.set_admission(self.admission_depth,
                                           self.retry_after_s)

    def set_ring(self, ring: int) -> None:
        """Live snapshot-ring resize of every tenant's store (and of the
        stores made later)."""
        self.knobs["ring"] = int(ring)
        with self._lock:
            stores = list(self._stores.values())
        for store in stores:
            store.resize(int(ring))

    def set_replica_lag(self, lag: float) -> None:
        """Versions this replica trails its upstream (the follower feeds
        its EWMA, so a spike fades over a few polls)."""
        with self._lock:
            self.replica_lag_versions = max(0.0, float(lag))

    def note_relayed(self, nbytes: int) -> None:
        """Bytes this follower pulled from upstream and re-serves."""
        with self._lock:
            self.follower_bytes_relayed += max(0, int(nbytes))

    def observe_read(self, dur_s: float) -> None:
        self._read_hist.observe(float(dur_s))

    def handle_read(self, have_version: int = 0, want_delta: bool = True,
                    tenant: Optional[str] = None):
        """Answer one read: ``(kind, version, base, payload, done)``.

        ``payload`` is ``None`` (not-modified, retry), the frozen flat
        snapshot (full: send it zero-copy and call ``done()`` once the
        bytes are out, which releases the ring pin) or a cached delta
        buffer shared by every coalesced reader. Safe from any thread.
        """
        tenant = tenant or self.default_tenant
        store = self._stores.get(tenant)
        if store is None:
            return (KIND_ERROR, 0, 0,
                    f"unknown tenant {tenant!r}".encode(), None)
        latest = store.acquire(None)
        if latest is None:
            return KIND_RETRY, 0, 0, None, None  # nothing published yet
        try:
            return self._answer_read(store, latest, int(have_version),
                                     want_delta, tenant)
        except BaseException:
            # never leak the ring pin on an encode error
            store.release(latest)
            raise

    def _answer_read(self, store, latest, have: int, want_delta: bool,
                     tenant: str):
        version = latest.version
        now_s = int(time.monotonic())
        with self._lock:
            self.reads_total += 1
            self._tenant_reads[tenant] = self._tenant_reads.get(tenant, 0) + 1
            self._rate[now_s] = self._rate.get(now_s, 0) + 1
            if len(self._rate) > int(self.knobs["rate_window_s"]) + 2:
                cutoff = now_s - int(self.knobs["rate_window_s"])
                for sec in [s for s in self._rate if s < cutoff]:
                    del self._rate[sec]
            if have > 0:
                mh = self._fresh_min_have.get(tenant)
                if mh is None or have < mh:
                    self._fresh_min_have[tenant] = have
        if have == version:
            store.release(latest)
            with self._lock:
                self.reads_not_modified += 1
            return KIND_NOT_MODIFIED, version, have, None, None
        full_bytes = latest.nbytes
        if want_delta and have > 0:
            key = (tenant, have, version)
            with self._lock:
                payload = self._encode_cache.get(key)
            if payload is not None:
                # coalesced: the same ask within this version's window
                # rides the one existing encode
                store.release(latest)
                with self._lock:
                    self.reads_delta += 1
                    self.coalesce_hits += 1
                    self.delta_bytes_saved += max(
                        0, full_bytes - payload.nbytes)
                return KIND_DELTA, version, have, payload, None
            base = store.acquire(have)
            if base is None:
                with self._lock:
                    self.ring_ageouts += 1  # aged out: full fallback
            else:
                try:
                    payload = self._delta(tenant).encode(base.flat,
                                                         latest.flat)
                finally:
                    store.release(base)
                if payload is None:
                    with self._lock:
                        self.delta_full_fallbacks += 1
                else:
                    with self._lock:
                        self._encode_cache[key] = payload
                        self.reads_delta += 1
                        self.delta_bytes_saved += max(
                            0, full_bytes - payload.nbytes)
                    store.release(latest)
                    return KIND_DELTA, version, have, payload, None
        with self._lock:
            self.reads_full += 1
        done = (lambda s=latest, st=store: st.release(s))
        return KIND_FULL, version, 0, latest.flat, done

    def acquire_latest(self, tenant: Optional[str] = None):
        """In-process zero-copy read: pin and return the latest
        :class:`~.snapshots.Snapshot`; :meth:`release` it when done. None
        before the first publish."""
        store = self._stores.get(tenant or self.default_tenant)
        return store.acquire(None) if store is not None else None

    def release(self, snap, tenant: Optional[str] = None) -> None:
        store = self._stores.get(tenant or self.default_tenant)
        if store is not None:
            store.release(snap)

    # -- accounting -------------------------------------------------------
    def reads_per_s(self) -> float:
        window = max(1.0, float(self.knobs["rate_window_s"]))
        now = time.monotonic()
        cutoff = int(now - window)
        with self._lock:
            for sec in [s for s in self._rate if s < cutoff]:
                del self._rate[sec]
            n = sum(self._rate.values())
        span = min(window, max(now - self._t0, 1e-6))
        return n / span

    def _quantile_ms(self, q: float) -> float:
        v = self._read_hist.approx_quantile(q)
        return 0.0 if math.isnan(v) else v * 1e3

    def _native_stats(self) -> Optional[Dict[str, int]]:
        """The native tier's counter block, or None on the Python loop."""
        if not self.read_native or self.read_server is None:
            return None
        try:
            return self.read_server.stats()
        except Exception:
            return None  # torn down mid-scrape

    def lossy_fallbacks(self) -> int:
        with self._lock:
            return sum(d.lossy_fallbacks for d in self._deltas.values())

    def read_metrics(self) -> Dict[str, float]:
        """The canonical serving keys (all float; zeros before traffic),
        the native tier's C++ counters merged in."""
        with self._lock:
            out = {
                "reads_total": float(self.reads_total),
                "delta_bytes_saved": float(self.delta_bytes_saved),
                "reads_shed": float(self.reads_shed),
                "coalesce_hits": float(self.coalesce_hits),
                "reads_not_modified": float(self.reads_not_modified),
                "replica_lag_versions": float(self.replica_lag_versions),
                "follower_bytes_relayed": float(
                    self.follower_bytes_relayed),
            }
        nat = self._native_stats()
        out["native_read_conns"] = float(nat["conns"]) if nat else 0.0
        if nat is not None:
            for key in ("reads_total", "reads_shed", "coalesce_hits",
                        "reads_not_modified", "delta_bytes_saved"):
                out[key] += float(nat[key])
        out["read_p50_ms"] = self._quantile_ms(0.50)
        out["read_p95_ms"] = self._quantile_ms(0.95)
        with self._lock:
            lat = sorted(self._fresh_lat)
            hops = max((rec["doc"]["hop_count"]
                        for rec in self._fresh.values()), default=0)
        out["read_fresh_p50_ms"] = _seq_quantile(lat, 0.50)
        out["read_fresh_p95_ms"] = _seq_quantile(lat, 0.95)
        out["serving_age_ms"] = self.serving_age_ms()
        out["fresh_hop_count"] = float(hops)
        return out

    def serving_snapshot(self) -> Dict[str, Any]:
        """The ``serving`` section: ring occupancy, queue depth, per-tenant
        reads, shed and coalesce counters, freshness."""
        with self._lock:
            tenants = {t: {**store.snapshot(),
                           "reads": self._tenant_reads.get(t, 0)}
                       for t, store in self._stores.items()}
            counters = {k: getattr(self, k) for k in (
                *_NATIVE_COUNTERS, "ring_ageouts", "delta_full_fallbacks")}
        out = {
            "armed": self.armed,
            "read_port": self.read_port,
            "admission_depth": self.admission_depth,
            "retry_after_s": self.retry_after_s,
            "queue_depth": (self.read_server.queue_depth()
                            if self.read_server is not None else 0),
            "connections": (self.read_server.connections()
                            if self.read_server is not None else 0),
            "reads_per_s": round(self.reads_per_s(), 3),
            "read_p50_ms": round(self._quantile_ms(0.50), 4),
            "read_p95_ms": round(self._quantile_ms(0.95), 4),
            "lossy_fallbacks": self.lossy_fallbacks(),
            "tenants": tenants,
            **counters,
        }
        if hasattr(self.server, "_reads_total"):
            # the transport's own worker reads (TCP GET_PARAMS)
            out["native_reads"] = {
                "total": int(self.server._reads_total),
                "not_modified": int(self.server._reads_not_modified)}
        out["read_native"] = self.read_native
        nrs = self._native_stats()
        if nrs is not None:
            out["native_read"] = nrs
            for k in _NATIVE_COUNTERS:
                out[k] += nrs[k]
        elif self.read_server is not None and not self.read_native:
            out["rejected_frames"] = self.read_server.rejected_frames
            out["eof_mid_request"] = self.read_server.eof_mid_request
        out["replica_lag_versions"] = self.replica_lag_versions
        out["follower_bytes_relayed"] = self.follower_bytes_relayed
        out["freshness"] = self.freshness_snapshot()
        return out

    def freshness_snapshot(self) -> Dict[str, Any]:
        """Per tenant the age and birth record of the version served,
        the publish -> visible quantiles, trailered replies and the
        laggiest reader's base (the native tier's pair included)."""
        now = time.time()
        with self._lock:
            tenants = {
                tn: {"version": rec["version"],
                     "age_ms": round(
                         max(0.0, (now - rec["birth_local"]) * 1e3), 3),
                     "hop_count": rec["doc"]["hop_count"],
                     "publish_wall": rec["doc"]["publish_wall"],
                     "root_gen": rec["doc"]["root_gen"]}
                for tn, rec in self._fresh.items()}
            lat = sorted(self._fresh_lat)
            out = {
                "tenants": tenants,
                "read_fresh_p50_ms": round(_seq_quantile(lat, 0.50), 3),
                "read_fresh_p95_ms": round(_seq_quantile(lat, 0.95), 3),
                "fresh_replies": self.fresh_replies,
                "min_have_version": dict(self._fresh_min_have),
            }
        if self.read_native and self.read_server is not None:
            nf = self.read_server.fresh_stats_all()
            if nf:
                out["native_fresh"] = nf
        return out

    def _register_scrape(self) -> None:
        def collect(r) -> None:
            if self.server is None:
                # a standalone core emits the ordering and ageing gauges
                # a server's registry would
                r.gauge("ps_scrape_ts_seconds",
                        "wall-clock timestamp of this scrape").set(
                            time.time())
                r.gauge("ps_uptime_seconds",
                        "monotonic age of this serving-core generation"
                        ).set(max(0.0, time.monotonic() - self._t0))
            m = self.read_metrics()
            for kind, name, key, help_ in (
                    ("counter", "ps_reads_total", "reads_total",
                     "read-tier requests served (all kinds)"),
                    ("counter", "ps_reads_shed_total", "reads_shed",
                     "read requests shed by admission control"),
                    ("counter", "ps_coalesce_hits_total", "coalesce_hits",
                     "delta reads served from an existing encode"),
                    ("counter", "ps_delta_bytes_saved_total",
                     "delta_bytes_saved", "payload bytes saved by delta "
                     "replies vs full snapshots"),
                    ("counter", "ps_reads_not_modified_total",
                     "reads_not_modified", "version-conditional reads "
                     "answered without a payload"),
                    ("gauge", "ps_read_p50_ms", "read_p50_ms",
                     "read-tier service time p50 (ms)"),
                    ("gauge", "ps_read_p95_ms", "read_p95_ms",
                     "read-tier service time p95 (ms)"),
                    ("gauge", "ps_native_read_conns", "native_read_conns",
                     "reader connections open on the native PSR1 tier"),
                    ("gauge", "ps_replica_lag_versions",
                     "replica_lag_versions", "versions this replica "
                     "trails its upstream (follower tier; 0 standalone)"),
                    ("counter", "ps_follower_bytes_relayed_total",
                     "follower_bytes_relayed", "bytes pulled from "
                     "upstream and re-served by this follower"),
                    ("gauge", "ps_serving_age_ms", "serving_age_ms",
                     "wall age of the version currently being served "
                     "(worst tenant; the age-of-information gauge)"),
                    ("gauge", "ps_read_fresh_p50_ms", "read_fresh_p50_ms",
                     "publish->visible-here propagation latency p50 "
                     "(ms; zero at the root)"),
                    ("gauge", "ps_read_fresh_p95_ms", "read_fresh_p95_ms",
                     "publish->visible-here propagation latency p95 "
                     "(ms; zero at the root)"),
                    ("gauge", "ps_fresh_hop_count", "fresh_hop_count",
                     "replica hops recorded in the served version's "
                     "freshness trailer (this node's tree depth)")):
                getattr(r, kind)(name, help_).set(m[key])
            r.gauge("ps_read_queue_depth",
                    "read requests awaiting service").set(
                        float(self.read_server.queue_depth()
                              if self.read_server is not None else 0))
            r.counter("ps_fresh_replies_total",
                      "replies that carried an FRS1 freshness "
                      "trailer").set(float(self.fresh_replies))
            with self._lock:
                occ = sum(len(s._order) for s in self._stores.values())
                tenants = len(self._stores)
            r.gauge("ps_serving_ring_occupancy",
                    "snapshots resident across all tenant rings").set(
                        float(occ))
            r.gauge("ps_serving_tenants",
                    "tenant namespaces with a snapshot ring").set(
                        float(tenants))

        self._reg.add_collector(collect)

    def close(self) -> None:
        """Tear down the network read server. The native tier's counters
        and freshness pair die with its C++ handle, so its final block
        folds into the core's own counters first: accounting after
        ``close`` reads the same whichever loop served. A standalone
        core's own ``/metrics`` endpoint closes too, its fleet card
        removed first."""
        reg, self._fleet_registration = self._fleet_registration, None
        if reg is not None:
            from pytorch_ps_mpi_tpu_torch.telemetry.fleet import \
                deregister_endpoint

            deregister_endpoint(*reg)
        if self._own_http is not None:
            self._own_http.close()
            self._own_http = None
        if self.read_server is None:
            return
        self.read_server.close()
        nrs = self._native_stats()
        if nrs is not None:
            with self._lock:
                for k in _NATIVE_COUNTERS:
                    setattr(self, k, getattr(self, k) + nrs[k])
            self.read_native = False
        fs_all = getattr(self.read_server, "fresh_stats_all", dict)()
        with self._lock:
            for tn, fs in (fs_all or {}).items():
                self.fresh_replies += int(fs["fresh_replies"])
                mh = int(fs["min_have_version"])
                if mh:
                    cur = self._fresh_min_have.get(tn)
                    self._fresh_min_have[tn] = (mh if cur is None
                                                else min(cur, mh))
        self.read_server = None
