"""The read tier's wire: the PSR1 request and reply, the event-loop read
server and the reader client (``pytorch_ps_mpi_tpu/serving/net.py``).

One event-loop thread (:class:`ReadTierServer`, ``selectors``-based)
accepts connections, parses version-conditional read requests, applies
**admission control** (requests past ``admission_depth`` in the backlog
get an immediate retry-after reply) and answers through the
:class:`~.core.ServingCore`: **not-modified** when the reader is
current, a **delta** when its base is still in the snapshot ring
(encoded once per (base, latest) pair and shared by every coalesced
reader), **full** otherwise, the frozen snapshot sent as a zero-copy
``memoryview``. Reply headers come from a preallocated buffer pool.
The loop touches only Python and numpy state, never a native transport
handle and never CUDA.

Protocol (little-endian), the JAX package's byte for byte::

  request:  u32 magic 'PSR1' | u8 op (1=READ) | u8 flags (bit0
            want_delta, bit1 want_fresh) | u16 tenant_len
            | u64 have_version | tenant utf-8 bytes
  reply:    u32 magic | u8 kind (0 full / 1 delta / 2 not-modified /
            3 retry / 4 error) | u8 fresh_len | u16 pad | u64 version
            | u64 base_version | f64 retry_after_s | u64 payload_len
            | payload | FRS1 trailer (fresh_len bytes)

The trailer (``telemetry/freshness.py``) rides only a full or delta
reply to a request that set ``want_fresh``; other readers get the same
bytes as a server without freshness.

:class:`ReadClient` is one request and one reply over a socket;
:class:`ServingReader` remembers the version it holds, asks for deltas,
applies them (a lossy section's decode on its ``device``), honours
retry-after on a shed, and falls back to full reads when its version
aged out of the ring.
"""

from __future__ import annotations

import collections
import selectors
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

PyTree = Any

MAGIC = 0x31525350  # "PSR1"
OP_READ = 1
FLAG_WANT_DELTA = 1
FLAG_WANT_FRESH = 2

KIND_FULL, KIND_DELTA, KIND_NOT_MODIFIED, KIND_RETRY, KIND_ERROR = range(5)
KIND_NAMES = {KIND_FULL: "full", KIND_DELTA: "delta",
              KIND_NOT_MODIFIED: "not_modified", KIND_RETRY: "retry",
              KIND_ERROR: "error"}

_REQ = struct.Struct("<IBBHQ")
_REP = struct.Struct("<IBBHQQdQ")


def pack_request(have_version: int = 0, want_delta: bool = True,
                 tenant: str = "", want_fresh: bool = False) -> bytes:
    t = tenant.encode()
    flags = ((FLAG_WANT_DELTA if want_delta else 0)
             | (FLAG_WANT_FRESH if want_fresh else 0))
    return _REQ.pack(MAGIC, OP_READ, flags, len(t), int(have_version)) + t


class _BufferPool:
    """Preallocated reply-header buffers, recycled when a send drains —
    the read tier's steady state allocates no per-request header bytes."""

    def __init__(self, size: int = _REP.size, prealloc: int = 64):
        self.size = int(size)
        self._free: List[bytearray] = [bytearray(self.size)
                                       for _ in range(prealloc)]
        self._lock = threading.Lock()
        self.allocations = prealloc

    def get(self) -> bytearray:
        with self._lock:
            if self._free:
                return self._free.pop()
            self.allocations += 1
        return bytearray(self.size)

    def put(self, buf: bytearray) -> None:
        with self._lock:
            self._free.append(buf)


class _Conn:
    __slots__ = ("sock", "rx", "tx", "closing")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rx = bytearray()
        # tx: deque of [memoryview, on_drained] — on_drained releases a
        # pinned snapshot or returns a pooled header buffer
        self.tx: collections.deque = collections.deque()
        self.closing = False


class ReadTierServer:
    """Event-loop read server over a :class:`~.core.ServingCore`.

    ``port=0`` auto-assigns (read back via ``.port``). ``close()`` stops
    the loop thread and closes every connection.
    """

    def __init__(self, core, port: int = 0, host: str = "0.0.0.0",
                 max_per_tick: int = 64):
        self.core = core
        self.max_per_tick = int(max_per_tick)
        self._pool = _BufferPool()
        self._sel = selectors.DefaultSelector()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, int(port)))
        self._listen.listen(256)
        self._listen.setblocking(False)
        self.port = int(self._listen.getsockname()[1])
        self._sel.register(self._listen, selectors.EVENT_READ, None)
        # admission backlog: parsed-but-unanswered requests. Depth past
        # the core's admission_depth is shed at PARSE time.
        self._backlog: collections.deque = collections.deque()
        # torn-frame accounting (same fields as the native tier's
        # ReadStats): bad-magic/op requests and peers that vanished with
        # a partial request still buffered
        self.rejected_frames = 0
        self.eof_mid_request = 0
        self._conns: Dict[socket.socket, _Conn] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"read-tier:{self.port}")
        self._thread.start()

    # -- loop -------------------------------------------------------------
    def queue_depth(self) -> int:
        return len(self._backlog)

    def connections(self) -> int:
        return len(self._conns)

    def _loop(self) -> None:
        while not self._stop.is_set():
            # never sleep while admitted requests are still queued: a
            # burst deeper than max_per_tick drains in back-to-back
            # iterations instead of one 50 ms select timeout per batch
            events = self._sel.select(
                timeout=0.0 if self._backlog else 0.05)
            for key, mask in events:
                if key.fileobj is self._listen:
                    self._accept()
                    continue
                conn = key.data
                if mask & selectors.EVENT_READ:
                    self._readable(conn)
                if mask & selectors.EVENT_WRITE:
                    self._flush(conn)
            self._process_backlog()
        # teardown on the loop thread — no cross-thread socket races
        for conn in list(self._conns.values()):
            self._drop(conn)
        try:
            self._sel.unregister(self._listen)
        except Exception:
            pass
        self._listen.close()
        self._sel.close()

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _drop(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except Exception:
            pass
        # run every pending drain hook: pinned snapshots must be released
        # even when the reader disappeared mid-send
        while conn.tx:
            _, done = conn.tx.popleft()
            if done is not None:
                done()
        self._conns.pop(conn.sock, None)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _readable(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            if conn.rx:
                self.eof_mid_request += 1
            self._drop(conn)
            return
        if not chunk:
            if conn.rx:
                # peer hung up mid-frame: a partial request was buffered
                self.eof_mid_request += 1
            self._drop(conn)
            return
        conn.rx += chunk
        while True:
            req = self._parse_one(conn)
            if req is None:
                break
            if len(self._backlog) >= self.core.admission_depth:
                # admission control: shed at the door with an explicit
                # retry-after — the backlog never grows past the knob,
                # so queued work (and reply latency) stays bounded
                self.core.note_shed()
                self._reply(conn, KIND_RETRY, self.core.latest_version(
                    req[2]), 0, None,
                    retry_after=self.core.retry_after_s)
            else:
                self._backlog.append((conn, req))

    def _parse_one(self, conn: _Conn
                   ) -> Optional[Tuple[int, bool, str, bool]]:
        """One complete request off the rx buffer, or None."""
        if len(conn.rx) < _REQ.size:
            return None
        magic, op, flags, tlen, have = _REQ.unpack_from(conn.rx, 0)
        if magic != MAGIC or op != OP_READ:
            self.rejected_frames += 1
            conn.rx.clear()
            self._reply(conn, KIND_ERROR, 0, 0, b"bad request magic/op")
            conn.closing = True
            return None
        total = _REQ.size + tlen
        if len(conn.rx) < total:
            return None
        tenant = bytes(conn.rx[_REQ.size:total]).decode(errors="replace")
        del conn.rx[:total]
        return (int(have), bool(flags & FLAG_WANT_DELTA), tenant,
                bool(flags & FLAG_WANT_FRESH))

    def _process_backlog(self) -> None:
        for _ in range(min(self.max_per_tick, len(self._backlog))):
            conn, (have, want_delta, tenant, want_fresh) = (
                self._backlog.popleft())
            if conn.sock not in self._conns:
                continue  # reader went away while queued
            t0 = time.perf_counter()
            fresh = b""
            try:
                kind, version, base, payload, done = self.core.handle_read(
                    have_version=have, want_delta=want_delta,
                    tenant=tenant or None)
                if want_fresh and kind in (KIND_FULL, KIND_DELTA):
                    # the trailer must describe exactly the version this
                    # reply delivers — a publish racing in between
                    # yields b"" (no trailer) rather than a stale stamp
                    fresh = self.core.fresh_trailer(tenant or None,
                                                    version)
            except Exception as e:
                # one bad request/publish must never kill the loop thread
                # serving everyone else: answer with an error and move on
                kind, version, base, done = KIND_ERROR, 0, 0, None
                payload = f"{type(e).__name__}: {e}".encode()
            self._reply(conn, kind, version, base, payload,
                        done=done,
                        retry_after=(self.core.retry_after_s
                                     if kind == KIND_RETRY else 0.0),
                        fresh=fresh)
            self.core.observe_read(time.perf_counter() - t0)

    def _reply(self, conn: _Conn, kind: int, version: int, base: int,
               payload, done=None, retry_after: float = 0.0,
               fresh: bytes = b"") -> None:
        if isinstance(payload, (bytes, bytearray)):
            payload = memoryview(payload)
        elif isinstance(payload, np.ndarray):
            payload = memoryview(payload.view(np.uint8))
        plen = payload.nbytes if payload is not None else 0
        hdr = self._pool.get()
        _REP.pack_into(hdr, 0, MAGIC, kind, len(fresh), 0, int(version),
                       int(base), float(retry_after), plen)
        pool = self._pool
        conn.tx.append((memoryview(hdr), lambda b=hdr: pool.put(b)))
        if payload is not None:
            # zero-copy: the payload rides as a view of the frozen
            # snapshot / cached delta buffer; `done` un-pins it after
            # the last byte goes out
            conn.tx.append((payload, done))
        elif done is not None:
            done()
        if fresh:
            # freshness trailer after the payload; tiny and immutable,
            # so it rides as its own bytes object with no drain hook
            conn.tx.append((memoryview(fresh), None))
        self._want_write(conn)
        self._flush(conn)

    def _want_write(self, conn: _Conn) -> None:
        try:
            self._sel.modify(conn.sock, selectors.EVENT_READ
                             | selectors.EVENT_WRITE, conn)
        except Exception:
            pass

    def _flush(self, conn: _Conn) -> None:
        while conn.tx:
            mv, done = conn.tx[0]
            try:
                n = conn.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._drop(conn)
                return
            if n < len(mv):
                conn.tx[0] = (mv[n:], done)
                return
            conn.tx.popleft()
            if done is not None:
                done()
        # drained: back to read-only interest
        try:
            self._sel.modify(conn.sock, selectors.EVENT_READ, conn)
        except Exception:
            pass
        if conn.closing:
            self._drop(conn)

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5)


class ReadClient:
    """Blocking one-request/one-reply client for the read-tier wire."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 tenant: str = ""):
        self.tenant = tenant
        #: raw FRS1 trailer from the last full/delta reply (b"" when the
        #: server sent none or the request didn't ask)
        self.last_fresh = b""
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        try:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._sock.settimeout(timeout)

    def _recv_exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = self._sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("read-tier server closed connection")
            out += chunk
        return bytes(out)

    def request(self, have_version: int = 0, want_delta: bool = True,
                want_fresh: bool = False
                ) -> Tuple[str, int, int, float, bytes]:
        """Returns ``(kind, version, base_version, retry_after_s,
        payload_bytes)`` — kind is one of full/delta/not_modified/retry/
        error. A freshness trailer, when requested and sent, lands in
        :attr:`last_fresh` (return shape stays stable for old callers)."""
        self._sock.sendall(pack_request(have_version, want_delta,
                                        self.tenant, want_fresh))
        hdr = self._recv_exact(_REP.size)
        magic, kind, fresh_len, _, version, base, retry_after, plen = (
            _REP.unpack(hdr))
        if magic != MAGIC:
            raise ConnectionError(f"bad reply magic 0x{magic:08x}")
        payload = self._recv_exact(plen) if plen else b""
        self.last_fresh = self._recv_exact(fresh_len) if fresh_len else b""
        name = KIND_NAMES.get(kind, "error")
        if name == "error":
            raise RuntimeError(
                f"read-tier error: {payload.decode(errors='replace')}")
        return name, int(version), int(base), float(retry_after), payload

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ServingReader:
    """Stateful parameter reader over the read tier.

    Holds (flat vector, version) between reads so every subsequent
    ``read_params`` is a conditional request: not-modified when current,
    a delta when the base is still in the server's ring, a full snapshot
    otherwise. Shed replies are honored by sleeping ``retry_after_s``
    and retrying (bounded by ``max_retries``) — the cooperative-backoff
    contract that keeps p99 bounded past the admission limit.
    ``read_params`` returns the template's tree of numpy views (the JAX
    layout, ``parallel.dcn.unflatten_params``). ``device`` is where a
    lossy delta section decodes (``serving_kw``'s ``delta_codec``); the
    exact mode touches no device.
    """

    def __init__(self, host: str, port: int, template: PyTree,
                 tenant: str = "", timeout: float = 10.0,
                 want_delta: bool = True, max_retries: int = 100,
                 serving_kw: Optional[dict] = None,
                 want_fresh: bool = True, device="cuda"):
        from pytorch_ps_mpi_tpu_torch.serving.delta import DeltaCodec

        self.client = ReadClient(host, port, timeout=timeout, tenant=tenant)
        self.template = template
        self.want_delta = bool(want_delta)
        self.want_fresh = bool(want_fresh)
        self.max_retries = int(max_retries)
        self.delta = DeltaCodec.from_knobs(template, serving_kw or {},
                                           device=device)
        self.version = 0
        self._flat: Optional[np.ndarray] = None
        self._tree: Optional[PyTree] = None
        # accounting (the load bench reads these)
        self.reads = 0
        self.full_reads = 0
        self.delta_reads = 0
        self.not_modified = 0
        self.shed_retries = 0
        self.bytes_received = 0
        # freshness: the last version delivery's FRS1 trailer (raw +
        # decoded), its local receive wall, and the (upstream stamp,
        # local recv) pairs the lower-envelope skew fit consumes
        self.fresh_raw = b""
        self.fresh: Optional[Dict[str, Any]] = None
        self.fresh_recv_wall = 0.0
        self.fresh_rejects = 0
        self._skew_pairs: collections.deque = collections.deque(maxlen=64)

    def read_params(self) -> Tuple[PyTree, int]:
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import unflatten_params

        for _ in range(self.max_retries):
            kind, version, base, retry_after, payload = self.client.request(
                have_version=self.version if self._flat is not None else 0,
                want_delta=self.want_delta and self._flat is not None,
                want_fresh=self.want_fresh,
            )
            self.bytes_received += len(payload)
            if kind == "retry":
                self.shed_retries += 1
                time.sleep(max(retry_after, 0.001))
                continue
            self.reads += 1
            if kind == "not_modified":
                self.not_modified += 1
                return self._tree, self.version
            if kind == "delta":
                if base != self.version or self._flat is None:
                    raise RuntimeError(
                        f"delta against base {base} but reader holds "
                        f"{self.version}")
                self._flat = self.delta.apply(self._flat, payload)
                self.delta_reads += 1
            else:  # full
                self._flat = np.frombuffer(payload, np.float32).copy()
                self.full_reads += 1
            self.version = int(version)
            self._tree = unflatten_params(self._flat, self.template)
            if self.client.last_fresh:
                self._note_fresh(self.client.last_fresh)
            return self._tree, self.version
        raise TimeoutError(
            f"read shed {self.shed_retries} times; gave up after "
            f"{self.max_retries} attempts")

    # -- freshness --------------------------------------------------------
    def _note_fresh(self, raw: bytes) -> None:
        from pytorch_ps_mpi_tpu_torch.telemetry import freshness as _fresh

        try:
            doc = _fresh.unpack_trailer(raw)
        except ValueError:
            # truncated/corrupt trailer: reject, keep the previous one
            self.fresh_rejects += 1
            return
        now = time.time()
        self.fresh_raw, self.fresh, self.fresh_recv_wall = raw, doc, now
        # newest upstream-clock stamp in the trailer vs our receive wall
        stamp = (doc["hops"][-1]["arrival_wall"] if doc["hops"]
                 else doc["publish_wall"])
        self._skew_pairs.append((stamp, now))

    def reader_skew_s(self) -> float:
        """Lower-envelope estimate of (this reader's clock − the served
        trailer's last-hop clock); 0.0 until a pair exists. Absorbs the
        minimum poll+transfer delay — see the freshness module
        docstring's skew caveat."""
        if not self._skew_pairs:
            return 0.0
        from pytorch_ps_mpi_tpu_torch.telemetry.lineage import \
            estimate_clock_offset

        return estimate_clock_offset(list(self._skew_pairs))

    def fresh_age_ms(self, now: Optional[float] = None) -> float:
        """Wall age (reader clock) of the version this reader currently
        holds; 0.0 before any trailer arrived."""
        if self.fresh is None:
            return 0.0
        from pytorch_ps_mpi_tpu_torch.telemetry import freshness as _fresh

        t = time.time() if now is None else float(now)
        birth = _fresh.birth_wall_local(self.fresh) + self.reader_skew_s()
        return max(0.0, (t - birth) * 1e3)

    def fresh_delivery_row(self, reader: str = "reader") -> Dict[str, Any]:
        """One reader-delivery row for the freshness plane
        (``FreshnessTracker.note_delivery``'s input, ``net.py:557``)."""
        doc = self.fresh
        return {
            "reader": reader,
            "tenant": self.client.tenant or "default",
            "version": self.version,
            "age_ms": round(self.fresh_age_ms(), 3),
            "hop_count": doc["hop_count"] if doc is not None else 0,
            "root_gen": doc["root_gen"] if doc is not None else 0,
            "t": time.time(),
        }

    def close(self) -> None:
        self.client.close()
