"""Retry, backoff and reconnect around a PS worker
(``pytorch_ps_mpi_tpu/resilience/worker.py``).

A plain worker raises on its first ``TimeoutError`` and on any transport
error (a socket's EOF, a wedged mailbox), so a server restart would kill
every worker although the replacement serves the same snapshot seconds
later. :class:`ResilientWorker` keeps the worker's surface and absorbs
those failures:

- **timeouts**: exponential backoff with deterministic jitter (seeded a
  worker), then a reconnect after ``reconnect_after`` timeouts in a row.
  A restarted shm server creates its segment anew, so a surviving
  worker's pushes land in an orphaned mailbox and time out; the
  reconnect opens the name again and finds the live segment;
- **transport errors** (``RuntimeError``, ``OSError``): an immediate
  reconnect through the factory, which is itself retried with backoff
  while the replacement server comes up.

At most one in-flight gradient is lost a failover, the loss the async
protocol already takes from a stale drop.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional

from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event


class ResilientWorker:
    """Wraps a transport worker factory (``ShmPSWorker``/``TcpPSWorker``
    or anything with their surface) with retry, backoff and reconnect.
    ``retries`` and ``reconnects`` count what it absorbed."""

    def __init__(self, factory: Callable[[], Any], worker_id: int = 0, *,
                 max_retries: int = 12, backoff_base: float = 0.05,
                 backoff_max: float = 2.0, jitter: float = 0.5,
                 reconnect_after: int = 1, seed: int = 0):
        if max_retries < 1:
            raise ValueError(f"max_retries must be >= 1, got {max_retries}")
        self._factory = factory
        self.worker_id = worker_id
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.reconnect_after = int(reconnect_after)
        self._rng = random.Random((int(seed) << 16) ^ (worker_id + 1))
        self.retries = 0
        self.reconnects = 0
        # the fallback push seq lives here: a rebuilt transport restarts
        # its own at 0 and would reuse trace IDs the server consumed
        self._auto_seq = 0
        self._tamper = None
        self._w: Optional[Any] = None
        self._w = self._build(initial=True)

    @property
    def wire(self):
        return getattr(self._w, "wire", None)

    def set_tamper(self, fn) -> None:
        """A one-shot outgoing-frame hook; it survives a reconnect."""
        self._tamper = fn
        if self._w is not None:
            self._w._tamper = fn

    def set_wire_delay(self, delay_s: float) -> None:
        if self._w is not None:
            self._w._wire_delay_s = float(delay_s)

    def _backoff(self, attempt: int) -> None:
        d = min(self.backoff_max, self.backoff_base * (2.0 ** attempt))
        time.sleep(d * (1.0 + self.jitter * self._rng.random()))

    def _build(self, initial: bool = False):
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries):
            try:
                w = self._factory()
            except (TimeoutError, RuntimeError, OSError) as e:
                last = e
                self.retries += 1
                record_event("resilience.retry", worker=self.worker_id,
                             op="connect", attempt=attempt, error=str(e))
                self._backoff(attempt)
                continue
            if not initial:
                self.reconnects += 1
                record_event("resilience.reconnect", worker=self.worker_id,
                             attempt=attempt, reconnects=self.reconnects)
            w._tamper = self._tamper
            return w
        raise TimeoutError(f"worker {self.worker_id}: could not (re)connect "
                           f"after {self.max_retries} attempts") from last

    def _reconnect(self) -> None:
        if self._w is not None:
            # a tamper the failed call already fired is spent: the retry
            # re-seals the push clean (ROADMAP queue 3 item 18)
            self._tamper = getattr(self._w, "_tamper", None)
            try:
                self._w.close()
            except Exception:
                pass  # a dead transport may fail its own teardown
            self._w = None
        self._w = self._build()

    def _call(self, op: str, *args, **kw):
        in_a_row = 0
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries):
            try:
                return getattr(self._w, op)(*args, **kw)
            except TimeoutError as e:
                last = e
                self.retries += 1
                in_a_row += 1
                record_event("resilience.retry", worker=self.worker_id,
                             op=op, attempt=attempt, error=str(e))
                if in_a_row >= self.reconnect_after:
                    # timeouts on a live handle: an orphaned segment or a
                    # dead peer, so resolve the server again
                    self._reconnect()
                    in_a_row = 0
                else:
                    self._backoff(attempt)
            except (RuntimeError, OSError) as e:
                last = e
                self.retries += 1
                record_event("resilience.retry", worker=self.worker_id,
                             op=op, attempt=attempt, error=str(e))
                self._reconnect()
        raise TimeoutError(f"worker {self.worker_id}: {op} failed after "
                           f"{self.max_retries} attempts: {last}") from last

    # -- the worker's surface ------------------------------------------------
    def read_flat(self, timeout: float = 30.0):
        return self._call("read_flat", timeout=timeout)

    def read_params(self, timeout: float = 30.0):
        return self._call("read_params", timeout=timeout)

    def encode(self, grad):
        return self._w.encode(grad)

    def _pin(self, lineage):
        # a retransmitted frame is the same push: every retry re-seals
        # with the same (step, seq)
        if lineage is None:
            lineage = (0, self._auto_seq)
            self._auto_seq += 1
        return lineage

    def push_payload(self, flat, version: int, timeout: float = 30.0,
                     lineage=None, composed=None) -> None:
        self._call("push_payload", flat, version, timeout=timeout,
                   lineage=self._pin(lineage), composed=composed)
        self._tamper = getattr(self._w, "_tamper", None)

    def push_grad(self, grad, version: int, timeout: float = 30.0,
                  lineage=None, composed=None) -> None:
        self._call("push_grad", grad, version, timeout=timeout,
                   lineage=self._pin(lineage), composed=composed)
        self._tamper = getattr(self._w, "_tamper", None)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
