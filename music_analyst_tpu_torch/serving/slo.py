"""SLO/overload primitives: per-tenant token buckets and weighted fair
queueing with strict priority classes.

Counterpart of ``music_analyst_tpu/serving/slo.py``, copied with its imports
renamed; the port keeps its own copy.

Shared by the dynamic batcher (``serving/batcher.py``), the continuous
decode scheduler (``serving/decode_loop.py``), and the replica router
(``serving/router.py``) so all three admission points enforce ONE
overload contract:

* **priority classes** — an integer per request (higher serves first);
  classes are strict: queued high-priority work always dispatches before
  lower classes.  Within one class tenants share capacity fairly.
* **weighted fair queueing** — inside a priority class, each tenant owns
  a sub-queue and a virtual-time counter; the pop always takes the
  tenant with the smallest virtual time, so a tenant flooding the queue
  gets exactly its fair share of service while a light tenant's requests
  never wait behind the flood (the starvation-freedom contract the SLO
  tests pin).
* **token buckets** — ``TokenBucket`` meters per-tenant admission at a
  sustained requests/second budget with bounded burst; an over-budget
  tenant sheds at *its own* bucket while other tenants keep admitting
  (per-tenant shedding, not per-fleet).
* **priority-aware eviction** — when the bounded queue is full, the
  request shed is not blindly the newcomer: :meth:`FairQueue
  .shed_candidate` hands back a queued request from a lower priority
  class, or from the most over-represented tenant in the same class, so
  overload degrades the greedy/low-value traffic first.

Everything here is host-side bookkeeping with no device imports.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


class RateMeter:
    """Rolling-window event rate: a time-decayed accumulator with a
    ~``tau_s`` horizon, so a live ``stats`` poller reads req/s, tokens/s
    and shed/s directly instead of differencing cumulative counters.

    ``mark(n)`` decays the accumulator by ``exp(-dt/tau)`` then adds
    ``n``; at a steady arrival rate ``r`` the accumulator converges to
    ``r * tau``, so ``rate() = acc / tau`` reads the sustained rate and
    forgets a burst within a few windows.  An idle meter costs nothing
    (decay happens lazily on access).
    """

    def __init__(self, tau_s: float = 10.0) -> None:
        self.tau_s = float(tau_s)
        self._acc = 0.0
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def mark(self, n: float = 1.0) -> None:
        with self._lock:
            now = time.monotonic()
            self._acc *= math.exp(-(now - self._t_last) / self.tau_s)
            self._t_last = now
            self._acc += float(n)

    def rate(self) -> float:
        """Events per second over the rolling window."""
        with self._lock:
            now = time.monotonic()
            acc = self._acc * math.exp(-(now - self._t_last) / self.tau_s)
        return round(acc / self.tau_s, 6)


class TokenBucket:
    """Per-tenant admission meter: ``rate`` tokens/second, ``burst`` cap.

    ``rate <= 0`` disables metering (every ``take`` succeeds) — the
    resolve-from-env default.  Refill happens lazily on access, so an
    idle bucket costs nothing.
    """

    def __init__(self, rate: float, burst: Optional[float] = None) -> None:
        self.rate = float(rate)
        self.burst = (
            float(burst) if burst is not None
            else max(2.0 * self.rate, 1.0)
        )
        self._tokens = self.burst
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> bool:
        if self.rate <= 0.0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t_last) * self.rate
            )
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after_ms(self, n: float = 1.0) -> float:
        """Milliseconds until ``n`` tokens will have accrued — the
        backoff hint an over-budget shed carries."""
        if self.rate <= 0.0:
            return 0.0
        with self._lock:
            deficit = max(n - self._tokens, 0.0)
        return round(max(deficit / self.rate * 1000.0, 1.0), 3)


class FairQueue:
    """Strict priority classes; per-tenant WFQ within each class.

    Not thread-safe by itself — callers hold their own admission lock
    (the batcher/scheduler/router condition variable), exactly as they
    did around the plain ``deque`` this replaces.
    """

    def __init__(self) -> None:
        # priority -> tenant -> deque of requests
        self._classes: Dict[int, Dict[str, deque]] = {}
        # (priority, tenant) -> WFQ virtual finish time
        self._vtime: Dict[Tuple[int, str], float] = {}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def _tenant_queue(self, priority: int, tenant: str) -> deque:
        tenants = self._classes.setdefault(int(priority), {})
        q = tenants.get(tenant)
        if q is None:
            q = tenants[tenant] = deque()
        return q

    def append(self, req: Any) -> None:
        prio, tenant = int(req.priority), req.tenant
        q = self._tenant_queue(prio, tenant)
        if not q:
            # A tenant (re)joining the class starts at the current live
            # floor: an idle spell must not bank unbounded credit.
            live = [
                self._vtime.get((prio, t), 0.0)
                for t, tq in self._classes[prio].items() if tq
            ]
            floor = min(live) if live else 0.0
            key = (prio, tenant)
            self._vtime[key] = max(self._vtime.get(key, 0.0), floor)
        q.append(req)
        self._len += 1

    def requeue(self, req: Any) -> None:
        """Put a request back at the HEAD of its tenant sub-queue (a
        preempted or deferred request has already paid its wait) and
        refund the virtual-time charge its original pop cost."""
        prio, tenant = int(req.priority), req.tenant
        self._tenant_queue(prio, tenant).appendleft(req)
        key = (prio, tenant)
        self._vtime[key] = max(self._vtime.get(key, 0.0) - 1.0, 0.0)
        self._len += 1

    def peek(self) -> Optional[Any]:
        """The request the next :meth:`popleft` would return."""
        return self._select(pop=False)

    def popleft(self) -> Optional[Any]:
        return self._select(pop=True)

    def _select(self, pop: bool) -> Optional[Any]:
        for prio in sorted(self._classes, reverse=True):
            tenants = self._classes[prio]
            live = [(t, q) for t, q in tenants.items() if q]
            if not live:
                continue
            tenant, q = min(
                live,
                key=lambda kv: (self._vtime.get((prio, kv[0]), 0.0), kv[0]),
            )
            if not pop:
                return q[0]
            req = q.popleft()
            self._len -= 1
            self._vtime[(prio, tenant)] = (
                self._vtime.get((prio, tenant), 0.0) + 1.0
            )
            return req
        return None

    def head_wait_t(self) -> Optional[float]:
        """Earliest ``t_enqueue`` across every queued request (the flush
        deadline must honor the oldest request even if WFQ would serve a
        different one first)."""
        oldest: Optional[float] = None
        for tenants in self._classes.values():
            for q in tenants.values():
                if q and (oldest is None or q[0].t_enqueue < oldest):
                    oldest = q[0].t_enqueue
        return oldest

    def depth_ahead(self, priority: int) -> int:
        """How many queued requests would be served before a newcomer at
        ``priority`` (everything in higher classes, plus the newcomer's
        whole class — WFQ gives no head-of-class guarantee)."""
        ahead = 0
        for prio, tenants in self._classes.items():
            if prio >= int(priority):
                ahead += sum(len(q) for q in tenants.values())
        return ahead

    def tenant_depth(self, tenant: str) -> int:
        return sum(
            len(tenants.get(tenant) or ())
            for tenants in self._classes.values()
        )

    def shed_candidate(self, tenant: str, priority: int) -> Optional[Any]:
        """When the queue is full, pick a queued request to shed INSTEAD
        of the newcomer, or None to shed the newcomer itself.

        A victim is taken from the tail of the lowest priority class
        strictly below the newcomer's, or — within the newcomer's own
        class — from the tenant holding strictly more queued requests
        than the newcomer's tenant (the most over-represented one).
        Equal standing means no victim: the newcomer sheds, so two
        identical tenants cannot evict each other's work in a loop.
        """
        prio_in = int(priority)
        for prio in sorted(self._classes):
            if prio > prio_in:
                break
            tenants = self._classes[prio]
            if prio < prio_in:
                live = [(len(q), t) for t, q in tenants.items() if q]
                if not live:
                    continue
                _, victim_tenant = max(live)
                req = tenants[victim_tenant].pop()
                self._len -= 1
                return req
            mine = len(tenants.get(tenant) or ())
            live = [
                (len(q), t) for t, q in tenants.items()
                if q and t != tenant and len(q) > mine + 1
            ]
            if live:
                _, victim_tenant = max(live)
                req = tenants[victim_tenant].pop()
                self._len -= 1
                return req
        return None

    def drain_all(self) -> List[Any]:
        """Every queued request, in pop order (for fail-everything
        paths); leaves the queue empty."""
        out: List[Any] = []
        while True:
            req = self.popleft()
            if req is None:
                return out
            out.append(req)
