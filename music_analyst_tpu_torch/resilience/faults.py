"""Deterministic, seeded fault injection at named seams.

Counterpart of ``music_analyst_tpu/resilience/faults.py``, copied with its imports
renamed; the port keeps its own copy.

Chaos testing only earns its keep if an injected run is REPRODUCIBLE: the
same spec (including seed) must trip the same calls in the same order, so
a failing chaos case replays exactly.  Every probabilistic decision
therefore draws from a per-rule ``random.Random(seed)`` — never the
global RNG — and every trigger counts calls per rule, not per process.

Spec grammar (``--inject-faults`` / ``MUSICAAL_FAULTS``)::

    spec    := rule (';' rule)*
    rule    := site ':' mode trigger? ('seed=' int)?
    mode    := 'error' | 'fatal' | 'crash' | 'delay=' seconds 's'?
    trigger := '@' N        -- trip exactly on the Nth call (1-based)
             | '@' N '+'    -- trip on every call from the Nth on
             | '@' P '%'    -- trip each call with probability P percent
             | (absent)     -- trip on every call

Examples::

    ollama.request:error@2                 # 2nd HTTP attempt fails once
    h2d.transfer:delay=5s@0.1%seed=7       # seeded 0.1% per-transfer stall
    ingest.read:fatal                      # non-retryable, every call
    serve.reply:crash@3                    # SIGKILL self before 3rd reply

``error`` raises :class:`InjectedFault` (classified retryable — the
retry/failover machinery must recover); ``fatal`` raises
:class:`InjectedFatal` (non-retryable — the run must die with a
structured taxonomy error and no torn artifacts); ``delay`` sleeps;
``crash`` SIGKILLs the process on the spot — no atexit, no flight
record, no flushed buffers — the process-crash chaos primitive the
``crash`` bench suite and the request journal's replay guarantees are
drilled against (``serving/journal.py``).

The module-level fast path matters: :func:`fault_point` sits on hot
seams (per prefetch item, per serving dispatch), so with no spec
configured it is one global load and a ``None`` check.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from music_analyst_tpu_torch.telemetry import get_telemetry

# The named seams.  Adding a site means adding a fault_point() call at the
# real code path — keep this list in sync with PERFORMANCE.md's table.
SITES = frozenset(
    {
        "ingest.read",
        "corpus_cache.publish",
        "prefetch.stage",
        "compile.first",
        "h2d.transfer",
        "collective.psum",
        "ollama.request",
        "serving.dispatch",
        "decode.step",
        "spec.draft",
        "checkpoint.load",
        "kv_pages.lookup",
        "router.dispatch",
        "scheduler.preempt",
        "loadgen.tick",
        # Crash-consistency seams (serving/journal.py, serving/server.py):
        # post-admit, pre-reply, and the journal's own append/compaction
        # paths — the four named SIGKILL points of the crash drill.
        "serve.admit",
        "serve.reply",
        "journal.append",
        "journal.compact",
        # Request-trace flush (telemetry/reqtrace.py): a failing flush must
        # degrade to dropped spans, never block the reply path.
        "reqtrace.flush",
        # Metrics scrape (observability/metrics_plane.py): a failing
        # scrape marks the series stale and counts scrape_errors —
        # serving bytes and replies are never affected.
        "metrics.scrape",
        # int8 KV-page dequantization (serving/decode_loop.py): a fault
        # here degrades the scheduler to the unquantized paged pool at
        # construction time — replies stay byte-identical, the stats
        # block flags ``kv_quant.degraded``.
        "kv_quant.dequant",
        # Engine-ledger flush (observability/engine_ledger.py): a failing
        # JSONL append degrades to a counted ``ledger_drops`` — replies
        # stay byte-identical and the file is never torn.
        "ledger.flush",
        # Response-cache tiers (serving/response_cache.py): a faulted
        # read counts a ``read_fallbacks`` and recomputes (byte-identical
        # reply); a faulted write counts ``write_errors`` and the settle
        # proceeds uncached.  Neither can fail or change a reply.
        "response_cache.read",
        "response_cache.write",
    }
)

_MAX_DELAY_S = 60.0  # cap injected sleeps: a typo must not outlive the bench


class InjectedFault(RuntimeError):
    """A transient injected failure; retry/failover must recover it."""

    def __init__(self, site: str, call: int, detail: str = "") -> None:
        self.site = site
        self.call = call
        extra = f" {detail}" if detail else ""
        super().__init__(
            f"fault injected at {site} (call {call}{extra})"
        )


class InjectedFatal(InjectedFault):
    """A non-transient injected failure; the run must die structurally."""

    def __init__(self, site: str, call: int) -> None:
        super().__init__(site, call, detail="fatal")


@dataclass
class FaultRule:
    """One parsed rule; owns its RNG so trip schedules are per-rule."""

    site: str
    mode: str  # error | fatal | delay
    delay_s: float = 0.0
    nth: Optional[int] = None  # @N / @N+
    from_nth: bool = False  # True for @N+
    probability: Optional[float] = None  # @P% as fraction in [0, 1]
    seed: int = 0
    rng: random.Random = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)

    def should_trip(self, call: int) -> bool:
        """Decide for the ``call``-th (1-based) arrival at this site.

        Called for EVERY arrival, in order, so probabilistic draws stay
        aligned with the call counter regardless of earlier outcomes.
        """
        if self.probability is not None:
            return self.rng.random() < self.probability
        if self.nth is not None:
            return call >= self.nth if self.from_nth else call == self.nth
        return True

    def describe(self) -> Dict[str, object]:
        out: Dict[str, object] = {"site": self.site, "mode": self.mode}
        if self.mode == "delay":
            out["delay_s"] = self.delay_s
        if self.nth is not None:
            out["nth"] = self.nth
            if self.from_nth:
                out["from_nth"] = True
        if self.probability is not None:
            out["probability"] = self.probability
            out["seed"] = self.seed
        return out


def _parse_rule(text: str) -> FaultRule:
    head, sep, tail = text.partition(":")
    site = head.strip()
    if not sep or not tail.strip():
        raise ValueError(
            f"fault rule {text!r}: expected 'site:mode[@trigger][seed=K]'"
        )
    if site not in SITES:
        known = ", ".join(sorted(SITES))
        raise ValueError(f"fault rule {text!r}: unknown site {site!r} "
                         f"(known sites: {known})")

    body = tail.strip()
    seed = 0
    if "seed=" in body:
        body, _, seed_text = body.partition("seed=")
        try:
            seed = int(seed_text)
        except ValueError:
            raise ValueError(
                f"fault rule {text!r}: seed must be an integer, "
                f"got {seed_text!r}"
            ) from None

    mode_text, at, trigger = body.partition("@")
    mode_text = mode_text.strip()
    delay_s = 0.0
    if mode_text in ("error", "fatal", "crash"):
        mode = mode_text
    elif mode_text.startswith("delay="):
        mode = "delay"
        value = mode_text[len("delay="):].rstrip("s")
        try:
            delay_s = float(value)
        except ValueError:
            raise ValueError(
                f"fault rule {text!r}: delay must look like 'delay=5s', "
                f"got {mode_text!r}"
            ) from None
        if not 0.0 <= delay_s <= _MAX_DELAY_S:
            raise ValueError(
                f"fault rule {text!r}: delay must be in "
                f"[0, {_MAX_DELAY_S:g}] seconds, got {delay_s:g}"
            )
    else:
        raise ValueError(
            f"fault rule {text!r}: mode must be 'error', 'fatal', 'crash' "
            f"or 'delay=<seconds>s', got {mode_text!r}"
        )

    nth: Optional[int] = None
    from_nth = False
    probability: Optional[float] = None
    if at:
        trigger = trigger.strip()
        if trigger.endswith("%"):
            try:
                pct = float(trigger[:-1])
            except ValueError:
                raise ValueError(
                    f"fault rule {text!r}: bad probability {trigger!r}"
                ) from None
            if not 0.0 <= pct <= 100.0:
                raise ValueError(
                    f"fault rule {text!r}: probability must be in "
                    f"[0, 100]%, got {pct:g}%"
                )
            probability = pct / 100.0
        else:
            plus = trigger.endswith("+")
            if plus:
                trigger = trigger[:-1]
            try:
                nth = int(trigger)
            except ValueError:
                raise ValueError(
                    f"fault rule {text!r}: trigger must be '@N', '@N+' or "
                    f"'@P%', got '@{trigger}'"
                ) from None
            if nth < 1:
                raise ValueError(
                    f"fault rule {text!r}: call numbers are 1-based, "
                    f"got @{nth}"
                )
            from_nth = plus

    return FaultRule(
        site=site,
        mode=mode,
        delay_s=delay_s,
        nth=nth,
        from_nth=from_nth,
        probability=probability,
        seed=seed,
    )


def parse_fault_spec(spec: str) -> List[FaultRule]:
    """Parse a full ``MUSICAAL_FAULTS`` spec; raises ValueError loudly.

    Fault injection is an explicit testing tool: a malformed spec silently
    ignored would make a chaos run think it tested something it didn't,
    so — unlike the watchdog/prefetch env knobs — a bad ENV value raises
    too.
    """
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if part:
            rules.append(_parse_rule(part))
    if not rules:
        raise ValueError(f"fault spec {spec!r} contains no rules")
    return rules


def resolve_fault_spec(value: Optional[str] = None) -> Optional[str]:
    """Explicit flag value wins; otherwise ``MUSICAAL_FAULTS``; else None."""
    import os

    if value is not None and value.strip():
        return value
    env = os.environ.get("MUSICAAL_FAULTS", "").strip()
    return env or None


class FaultInjector:
    """Process-global registry: per-site rules, call and trip counters."""

    def __init__(self, rules: List[FaultRule]) -> None:
        self._rules: Dict[str, List[FaultRule]] = {}
        for rule in rules:
            self._rules.setdefault(rule.site, []).append(rule)
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._trips: Dict[str, int] = {}

    def check(self, site: str, **attrs: object) -> None:
        rules = self._rules.get(site)
        if not rules:
            return
        with self._lock:
            call = self._calls.get(site, 0) + 1
            self._calls[site] = call
            tripped = [r for r in rules if r.should_trip(call)]
            if tripped:
                self._trips[site] = self._trips.get(site, 0) + 1
        if not tripped:
            return
        rule = tripped[0]
        tel = get_telemetry()
        tel.event(
            "fault_injected",
            site=site,
            mode=rule.mode,
            call=call,
            **attrs,
        )
        tel.count(f"faults.{site}.trips")
        if rule.mode == "delay":
            time.sleep(rule.delay_s)
            return
        if rule.mode == "crash":
            # The real thing, not an exception anyone can catch: SIGKILL
            # self, exactly as the OOM killer or a pulled cord would.  No
            # flight record, no drain, no journal compaction — whatever
            # recovery story the process claims must start from disk.
            import os
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60.0)  # pragma: no cover — the signal lands first
            return
        if rule.mode == "fatal":
            raise InjectedFatal(site, call)
        raise InjectedFault(site, call)

    def stats(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            out: Dict[str, Dict[str, object]] = {}
            for site, rules in sorted(self._rules.items()):
                out[site] = {
                    "rules": [r.describe() for r in rules],
                    "calls": self._calls.get(site, 0),
                    "trips": self._trips.get(site, 0),
                }
            return out


_INJECTOR: Optional[FaultInjector] = None


def configure_faults(spec: Optional[str]) -> Optional[FaultInjector]:
    """Install (or, with None/empty, remove) the process fault injector."""
    global _INJECTOR
    if spec is None or not spec.strip():
        _INJECTOR = None
        return None
    _INJECTOR = FaultInjector(parse_fault_spec(spec))
    return _INJECTOR


def fault_point(site: str, **attrs: object) -> None:
    """Seam hook: no-op unless a configured rule targets ``site``."""
    injector = _INJECTOR
    if injector is not None:
        injector.check(site, **attrs)


def fault_stats() -> Dict[str, Dict[str, object]]:
    """Per-site calls/trips for the run manifest; {} when not configured."""
    injector = _INJECTOR
    return injector.stats() if injector is not None else {}
