"""Small bounded LRU mappings (dict-compatible).

Used where an unbounded dict used to grow for the life of a process:
`ProfileSession.fn_cache` (compiled per-op callables) and the module
feature-matrix cache in `repro.core.features`.  Reads refresh recency;
inserts evict the least-recently-used entry past ``maxsize``.

`SegmentedLRUCache` adds scan resistance for search workloads: a
one-shot stream of NAS candidates cycling the probation segment cannot
evict entries the profiling/training paths pinned into the protected
segment.

Both caches are thread-safe on their cache-shaped operations (`get`,
`[]`, `[]=`, `put`, `in`, `len`, `clear`, `info`): they are shared
process-wide (the module feature cache) and across RPC server threads,
where the unguarded check-then-move in `get` raised KeyError when an
eviction won the race, and concurrent eviction loops could pop the same
head twice.  A reentrant lock per cache serializes exactly the compound
read-modify-write ops; plain-dict iteration helpers inherited from
OrderedDict remain unsynchronized (don't iterate a shared cache while
writers run).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable


class LRUCache(OrderedDict):
    """An OrderedDict capped at ``maxsize`` entries with LRU eviction.

    Drop-in for plain dicts used as caches (`get`/`[]`/`in`): consumers
    like `GraphExecutor(fn_cache=...)` need no changes.
    """

    def __init__(self, maxsize: int = 256):
        super().__init__()
        self.maxsize = max(1, int(maxsize))
        # RLock: eviction inside __setitem__ re-enters __delitem__.
        self._lock = threading.RLock()

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            if key in self:
                self.move_to_end(key)
                return super().__getitem__(key)
            return default

    def __getitem__(self, key: Hashable) -> Any:
        with self._lock:
            val = super().__getitem__(key)
            self.move_to_end(key)
            return val

    def __setitem__(self, key: Hashable, value: Any) -> None:
        with self._lock:
            super().__setitem__(key, value)
            self.move_to_end(key)
            while len(self) > self.maxsize:
                # NOT popitem(): OrderedDict.popitem re-enters the overridden
                # __getitem__ after unlinking the entry, which then KeyErrors
                # in move_to_end.
                del self[next(iter(self))]


class SegmentedLRUCache:
    """Two-segment LRU: a scan-resistant cache for mixed workloads.

    Plain inserts land in the *probation* segment (an ordinary LRU), so
    an unbounded stream of one-shot keys — a NAS loop featurizing
    thousands of distinct candidates — only ever recycles probation.
    Entries inserted with ``protect=True`` (long-lived keys: profiled /
    training graphs) live in the *protected* segment, which the scan
    cannot touch; protected evictions demote to probation's MRU end
    rather than dropping, so a momentarily-over-capacity protected set
    degrades gracefully instead of losing entries outright.

    Reads check protected first and refresh recency within the owning
    segment only — a probation hit does NOT promote (a second touch is
    exactly what a two-setting batched query produces for every
    one-shot candidate, so hit-count promotion would let candidates
    flood the protected segment).
    """

    def __init__(self, probation: int = 256, protected: int = 256):
        self.probation_size = max(1, int(probation))
        self.protected_size = max(1, int(protected))
        self._probation: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._protected: "OrderedDict[Hashable, Any]" = OrderedDict()
        # RLock: `put(protect=True)` demotion re-enters `_put_probation`.
        self._lock = threading.RLock()

    # -- reads ----------------------------------------------------------------
    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            for seg in (self._protected, self._probation):
                if key in seg:
                    seg.move_to_end(key)
                    return seg[key]
            return default

    def __getitem__(self, key: Hashable) -> Any:
        with self._lock:
            for seg in (self._protected, self._probation):
                if key in seg:
                    seg.move_to_end(key)
                    return seg[key]
        raise KeyError(key)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._protected or key in self._probation

    def __len__(self) -> int:
        with self._lock:
            return len(self._protected) + len(self._probation)

    # -- writes ---------------------------------------------------------------
    def put(self, key: Hashable, value: Any, *, protect: bool = False) -> None:
        """Insert/update; ``protect=True`` places (or upgrades) the entry
        into the protected segment."""
        with self._lock:
            if key in self._protected:
                self._protected[key] = value
                self._protected.move_to_end(key)
                return
            if protect:
                self._probation.pop(key, None)
                self._protected[key] = value
                self._protected.move_to_end(key)
                while len(self._protected) > self.protected_size:
                    old_key, old_val = self._protected.popitem(last=False)
                    self._put_probation(old_key, old_val)   # demote, not drop
            else:
                self._put_probation(key, value)

    def _put_probation(self, key: Hashable, value: Any) -> None:
        with self._lock:
            self._probation[key] = value
            self._probation.move_to_end(key)
            while len(self._probation) > self.probation_size:
                self._probation.popitem(last=False)

    def __setitem__(self, key: Hashable, value: Any) -> None:
        self.put(key, value)

    def clear(self) -> None:
        with self._lock:
            self._probation.clear()
            self._protected.clear()

    def info(self) -> Dict[str, int]:
        with self._lock:                    # RLock: len(self) re-enters
            return {
                "size": len(self),
                "capacity": self.probation_size + self.protected_size,
                "probation": len(self._probation),
                "probation_capacity": self.probation_size,
                "protected": len(self._protected),
                "protected_capacity": self.protected_size,
            }
