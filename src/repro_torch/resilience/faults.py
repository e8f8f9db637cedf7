"""Deterministic, seedable fault injection for the serving stack (the port
of ``repro.resilience.faults``: the same seed fires the same hits).

The serving layers (engine, cluster, frontend, dynamic compaction) are
dotted with named **failure points**::

    fault_point("engine.query_batch", n=B)

Disabled — the default — a fault point is a single module-attribute
check returning immediately, mirroring the obs tracer's disabled span
path (the analytic <2% overhead gate in
``repro_torch.benchmarks.obs_overhead`` covers both).  Enabled, the hit is matched against the installed
:class:`FaultPlan`'s specs and may **raise** an injected exception,
**stall** (bounded hang, releasable by the test), or **delay** (latency
spike) — all scheduled deterministically from the plan's seed, so a
chaos run replays bit-for-bit.

Usage::

    plan = FaultPlan(
        FaultSpec("engine.query_batch", kind="raise", p=0.5),
        FaultSpec("dynamic.compaction.mid_swap", max_fires=1),
        seed=7,
    )
    with inject(plan):
        ... serve ...
    plan.fires_at("engine.query_batch")   # how many actually fired

Every fire is counted in the obs registry (``faults.injected`` plus a
per-point counter), so a chaos run's obs snapshot shows exactly what
was injected next to what the stack did about it.

Failure-point registry (the names the reference wires through its
stack; the port's ``core/engine.py`` carries the three ``engine.*``
points, the others arrive with the cluster, frontend and dynamic index):

==============================    =========================================
point                             site
==============================    =========================================
engine.query_batch                device ``QueryEngine.query_batch`` entry
engine.route_prune                shared phase 1 of every analytics class
cluster.query_batch               ``ShardedEngine.query_batch`` entry
                                  (``ShardDropout`` specs model one shard)
frontend.flush                    inside the scheduler's serve latch
frontend.queue_stall              serve entry, before batch assembly (a
                                  delay/hang here stalls the scheduler)
dynamic.compaction.build          compaction build start
dynamic.compaction.mid_build      between index build and substrate build
dynamic.compaction.pre_swap       swap critical section entry (lock held)
dynamic.compaction.mid_swap       after base install, before op-log replay
dynamic.compaction.replay         before the racing-mutation replay loop
engine.answer                     value point on ``QueryEngine
                                  .query_batch`` output (``kind=
                                  "corrupt"`` flips answers — the
                                  wrong-answer fault the online
                                  exactness auditor must catch)
==============================    =========================================
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs import metrics as obs_metrics
from .errors import InjectedFault

KINDS = ("raise", "delay", "hang", "corrupt")


def _default_mutator(value):
    """Flip a boolean answer array's first element — the canonical
    silent wrong answer the exactness auditor exists to catch."""
    out = np.array(value, dtype=bool).copy()
    if out.size:
        out.flat[0] = ~out.flat[0]
    return out


@dataclasses.dataclass
class FaultSpec:
    """One scheduled failure at a named point.

    Parameters
    ----------
    point:     failure-point name (see the module registry table).
    kind:      ``"raise"`` (raise ``exc``), ``"delay"`` (sleep
               ``delay_s`` — a latency spike), or ``"hang"`` (block up
               to ``hang_s`` or until the plan's ``release`` event —
               a bounded stall the test can end).
    p:         per-hit firing probability, drawn from the plan's seeded
               rng (1.0 = every eligible hit fires).
    after:     skip the first ``after`` hits of this point (placing a
               crash at the N-th batch / stage boundary).
    max_fires: stop firing after this many (``None`` = unbounded).
    delay_s:   sleep duration for ``kind="delay"``.
    hang_s:    stall bound for ``kind="hang"`` (a safety net: chaos
               tests end hangs via ``plan.release``; real hangs are the
               frontend's deadline machinery's problem).
    exc:       exception *factory* ``(point, fire_no) -> BaseException``
               for ``kind="raise"``; default :class:`InjectedFault`.
    mutator:   value transform for ``kind="corrupt"`` — applied to the
               value crossing a :func:`fault_value` point (a **silent
               wrong answer**, the failure mode the online exactness
               auditor exists to catch); default flips the first
               element of a boolean answer array.  Corrupt specs only
               fire at value points; at plain :func:`fault_point` sites
               they are ignored.
    """

    point: str
    kind: str = "raise"
    p: float = 1.0
    after: int = 0
    max_fires: Optional[int] = 1
    delay_s: float = 0.0
    hang_s: float = 30.0
    exc: Optional[Callable[[str, int], BaseException]] = None
    mutator: Optional[Callable] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {KINDS}")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"need 0 <= p <= 1, got {self.p}")

    def make_exc(self, fire: int) -> BaseException:
        if self.exc is not None:
            return self.exc(self.point, fire)
        return InjectedFault(self.point, fire)


class FaultPlan:
    """A seeded, deterministic schedule of :class:`FaultSpec` s.

    Thread-safe: hits arrive concurrently from the caller, the frontend
    scheduler thread and background compaction builders; one lock
    serialises the rng draws and counters so a fixed seed yields a
    fixed global firing order.
    """

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self.specs: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self.specs.setdefault(s.point, []).append(s)
        self.seed = int(seed)
        self.release = threading.Event()   # opens every pending hang
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fires: Dict[str, int] = {}

    # -- introspection --------------------------------------------------

    @property
    def total_fires(self) -> int:
        with self._lock:
            return sum(self._fires.values())

    def hits_at(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def fires_at(self, point: str) -> int:
        with self._lock:
            return self._fires.get(point, 0)

    # -- scheduling -----------------------------------------------------

    def _decide(self, point: str) -> Optional[tuple]:
        """Under the lock: should this hit fire, and with which spec?
        Returns ``(spec, fire_no)`` or None."""
        with self._lock:
            hit = self._hits.get(point, 0)
            self._hits[point] = hit + 1
            for spec in self.specs.get(point, ()):
                if hit < spec.after:
                    continue
                fired = self._fires.get(point, 0)
                if spec.max_fires is not None and fired >= spec.max_fires:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                self._fires[point] = fired + 1
                return spec, fired + 1
        return None


class FaultInjector:
    """Process-wide fault switchboard (one instance: :data:`INJECTOR`).

    ``enabled`` is the single-attribute hot-path gate; ``hits_total``
    counts fault-point crossings while enabled (the overhead bench uses
    it to count hook sites per batch with an *empty* plan installed).
    """

    def __init__(self):
        self.enabled = False
        self._plan: Optional[FaultPlan] = None
        self.hits_total = 0
        self._c_injected = obs_metrics.REGISTRY.counter("faults.injected")

    def install(self, plan: FaultPlan) -> None:
        self._plan = plan
        self.enabled = True

    def uninstall(self) -> None:
        self.enabled = False
        plan, self._plan = self._plan, None
        if plan is not None:
            plan.release.set()      # never strand a pending hang

    @property
    def plan(self) -> Optional[FaultPlan]:
        return self._plan

    def hit(self, point: str, ctx: Optional[dict]) -> None:
        self.hits_total += 1
        plan = self._plan
        if plan is None:
            return
        decision = plan._decide(point)
        if decision is None:
            return
        spec, fire = decision
        self._count_fire(point, spec, fire)
        if spec.kind == "raise":
            raise spec.make_exc(fire)
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.kind == "corrupt":
            return        # corrupt specs only act at fault_value points
        plan.release.wait(timeout=spec.hang_s)   # "hang": bounded stall

    def hit_value(self, point: str, value, ctx: Optional[dict]):
        """A :func:`fault_value` crossing: like :meth:`hit`, but the
        point carries a value a ``kind="corrupt"`` spec may silently
        mutate; every other kind behaves as at a plain point."""
        self.hits_total += 1
        plan = self._plan
        if plan is None:
            return value
        decision = plan._decide(point)
        if decision is None:
            return value
        spec, fire = decision
        self._count_fire(point, spec, fire)
        if spec.kind == "corrupt":
            return (spec.mutator or _default_mutator)(value)
        if spec.kind == "raise":
            raise spec.make_exc(fire)
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
            return value
        plan.release.wait(timeout=spec.hang_s)
        return value

    def _count_fire(self, point: str, spec: FaultSpec, fire: int) -> None:
        self._c_injected.inc()
        obs_metrics.REGISTRY.counter(f"faults.{point}").inc()
        # black-box note: injected faults land in the flight recorder's
        # always-on event ring next to what the stack did about them
        from ..obs.flight import FLIGHT  # deferred: keeps import light
        FLIGHT.note("fault.injected", point=point, fault_kind=spec.kind,
                    fire=fire)


INJECTOR = FaultInjector()


def fault_point(name: str, **ctx) -> None:
    """Named failure point.  Disabled (the default): one attribute
    check, nothing else — safe on the serve hot path.  Enabled: the
    installed plan decides whether this hit raises / stalls / delays."""
    if not INJECTOR.enabled:
        return
    INJECTOR.hit(name, ctx or None)


def fault_value(name: str, value, **ctx):
    """Named failure point **carrying a value** (an answer array about
    to be returned).  Disabled: one attribute check and the value flows
    through untouched.  Enabled: a ``kind="corrupt"`` spec may mutate
    it — the silent-wrong-answer injection the online exactness auditor
    is proven against — and every other kind acts as at a plain
    :func:`fault_point`."""
    if not INJECTOR.enabled:
        return value
    return INJECTOR.hit_value(name, value, ctx or None)


class inject:
    """Context manager installing a plan for the dynamic extent of a
    test (uninstall releases any hang still pending)::

        with inject(FaultPlan(FaultSpec("engine.query_batch"), seed=3)):
            ...
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        INJECTOR.install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> bool:
        INJECTOR.uninstall()
        return False
