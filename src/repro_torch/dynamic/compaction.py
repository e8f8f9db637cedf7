"""Compaction policy + background compactor for `DynamicIndex` (the port
of ``repro.dynamic.compaction``).

Query latency over a `DynamicIndex` degrades with overlay size (each
query pays one base-index probe per "entry component" the delta edges
open, plus the staging-set probe).  Compaction rebuilds the static index
over the materialised mutated graph and swaps it in, resetting the
overlay — restoring fresh-build latency at an amortised cost the policy
bounds.

``CompactionPolicy`` is a pure threshold test; ``Compactor`` runs the
rebuild either inline (``background=False``) or on a daemon thread.  The
background path snapshots the graph and an op-log cut under the index
lock, builds without the lock (queries and mutations keep flowing), and
swaps atomically: mutations that arrived during the build are replayed
into the fresh overlay, so no update is ever lost or double-applied.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional


@dataclasses.dataclass
class CompactionPolicy:
    """Size/staleness thresholds that trigger a compaction.

    Any threshold set to ``None`` is ignored.  ``updates_since_compaction``
    is the staleness guard: even a slow trickle of tiny updates eventually
    forces a rebuild so the overlay's auxiliary structures (union-find,
    reach-cache) cannot grow without bound.
    """

    max_overlay_edges: Optional[int] = 4096
    max_staged: Optional[int] = 1024
    max_updates: Optional[int] = 16384
    background: bool = False

    def should_compact(self, n_overlay_edges: int, n_staged: int,
                       updates_since_compaction: int) -> bool:
        if self.max_overlay_edges is not None \
                and n_overlay_edges >= self.max_overlay_edges:
            return True
        if self.max_staged is not None and n_staged >= self.max_staged:
            return True
        if self.max_updates is not None \
                and updates_since_compaction >= self.max_updates:
            return True
        return False


NEVER = CompactionPolicy(
    max_overlay_edges=None, max_staged=None, max_updates=None
)


class Compactor:
    """Owns the (optional) background build thread of one DynamicIndex.

    A build that raises latches ``last_error``: policy-driven triggers
    stop retrying (no rebuild storm on a deterministic failure) until an
    explicit ``compact()`` clears the latch, and ``join`` re-raises so a
    caller waiting on the swap cannot mistake the failure for success.
    """

    def __init__(self, index) -> None:
        self._index = index
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def trigger(self, background: bool) -> bool:
        """Start (or run inline) one compaction; returns False when a
        background build is already in flight."""
        idx = self._index
        # the running-check and thread assignment must be atomic with the
        # snapshot/cut capture: two racing triggers would otherwise both
        # start builds, and the loser's swap would replay a stale op-log
        # tail against the wrong base
        with idx._lock:
            if self.running:
                return False
            self.last_error = None  # explicit trigger clears the latch
            if not background:
                self._index._compact_sync()
                return True
            snapshot, cut = idx._begin_compaction()

            def _build() -> None:
                t0 = time.perf_counter()
                try:
                    built = idx._build_static(snapshot)
                    idx._finish_compaction(snapshot, built, cut,
                                           time.perf_counter() - t0)
                except BaseException as e:  # noqa: BLE001 - latched for caller
                    self.last_error = e
                    with idx._lock:
                        idx.stats["n_compaction_failures"] = (
                            idx.stats.get("n_compaction_failures", 0) + 1
                        )

            self._thread = threading.Thread(
                target=_build, name="repro-torch-dynamic-compaction", daemon=True
            )
            self._thread.start()
        return True

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)
        if self.last_error is not None:
            raise RuntimeError(
                "background compaction failed; the overlay is intact and "
                "an explicit compact() will retry"
            ) from self.last_error
