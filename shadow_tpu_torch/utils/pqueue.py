"""Binary-heap priority queue with a deterministic total order (the
port's copy of the reference package's utils/pqueue.py).

Entries are (key, item); ties cannot happen, because every event key
ends in a sequence number unique per source host (core/event.py).
"""

from __future__ import annotations

import heapq
from typing import Any, Optional


class PriorityQueue:
    __slots__ = ("_heap",)

    def __init__(self):
        self._heap: list[tuple[Any, Any]] = []

    def push(self, key, item) -> None:
        heapq.heappush(self._heap, (key, item))

    def peek(self) -> Optional[tuple[Any, Any]]:
        return self._heap[0] if self._heap else None

    def peek_key(self):
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Optional[tuple[Any, Any]]:
        return heapq.heappop(self._heap) if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
