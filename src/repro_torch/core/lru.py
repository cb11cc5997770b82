"""A tiny bounded LRU mapping for the framework's compile/memo caches.

``functools.lru_cache`` wraps a *function*; several hot paths here memoize
by explicit key (compiled step vectors keyed on ``(ArchConfig, kind,
remat)``, compiled collective vectors keyed on topology class) and need an
*object* with dict-like access.  This is that object: insertion is O(1),
hits refresh recency, and inserts beyond ``maxsize`` evict the least
recently used entry — so caches keyed on whole frozen ``ArchConfig``
dataclasses stay small instead of pinning every config ever scored.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Generic, Hashable, Optional, TypeVar

from repro_torch.obs import metrics as _obs_metrics

V = TypeVar("V")

_EVICTIONS = _obs_metrics.REGISTRY.counter(
    "repro_lru_evictions_total",
    "entries dropped from bounded LRU caches on capacity overflow")


class LRUCache(Generic[V]):
    __slots__ = ("maxsize", "_data")

    def __init__(self, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._data: "OrderedDict[Hashable, V]" = OrderedDict()

    def get(self, key: Hashable, default: Optional[V] = None) -> Optional[V]:
        try:
            self._data.move_to_end(key)
        except KeyError:
            return default
        return self._data[key]

    def __setitem__(self, key: Hashable, value: V) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            _EVICTIONS.inc()

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()
