"""Distance-prioritised asset streaming.

A copy of ``substrata_tpu/loading.py``: importing any module of the
reference package loads jax, so the port keeps its own.

Parity with the reference's loading layer (gui_client/LoadItemQueue.*,
ProximityLoader.{h,cpp}, DownloadResourcesThread.*, and the per-tick
processLoading drain, GUIClient.cpp:5071): load tasks are ordered by
distance to the camera (closest first), re-prioritised as the camera moves,
deduplicated by URL, processed a bounded number per tick, and objects
outside the load radius are unloaded.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass, field

import numpy as np


@dataclass(order=True)
class _QueuedItem:
    priority: float
    seq: int = field(compare=True)
    key: str = field(compare=False)
    pos: np.ndarray = field(compare=False, default=None)
    task: object = field(compare=False, default=None)
    cancelled: bool = field(compare=False, default=False)


class LoadItemQueue:
    """gui_client/LoadItemQueue parity: a priority queue of load tasks keyed
    by URL, ordered by distance to the camera, lazily re-sorted when the
    camera has moved far enough."""

    REPRIORITISE_CAM_DIST = 10.0

    def __init__(self):
        self._heap: list[_QueuedItem] = []
        self._by_key: dict[str, _QueuedItem] = {}
        self._seq = itertools.count()
        self._campos = np.zeros(3)
        self.lock = threading.Lock()

    def enqueue(self, key: str, pos, task) -> bool:
        """False if the key is already queued (dedup)."""
        with self.lock:
            if key in self._by_key:
                return False
            pos = np.asarray(pos, np.float64)
            item = _QueuedItem(priority=float(np.linalg.norm(pos - self._campos)),
                               seq=next(self._seq), key=key, pos=pos, task=task)
            heapq.heappush(self._heap, item)
            self._by_key[key] = item
            return True

    def cancel(self, key: str):
        with self.lock:
            item = self._by_key.pop(key, None)
            if item is not None:
                item.cancelled = True

    def update_campos(self, campos):
        """Re-prioritise when the camera moved far enough (the reference
        re-sorts the queue on significant camera motion)."""
        campos = np.asarray(campos[:3], np.float64)
        with self.lock:
            if np.linalg.norm(campos - self._campos) < self.REPRIORITISE_CAM_DIST:
                return
            self._campos = campos
            live = [i for i in self._heap if not i.cancelled]
            for i in live:
                i.priority = float(np.linalg.norm(i.pos - campos))
            heapq.heapify(live)
            self._heap = live

    def pop_n(self, n: int) -> list:
        """Up to n closest tasks (the per-tick processLoading budget)."""
        out = []
        with self.lock:
            while self._heap and len(out) < n:
                item = heapq.heappop(self._heap)
                if item.cancelled:
                    continue
                self._by_key.pop(item.key, None)
                out.append((item.key, item.task))
        return out

    def __len__(self):
        with self.lock:
            return len(self._by_key)


class ProximityLoader:
    """gui_client/ProximityLoader parity: objects within load_distance of
    the camera get loaded (callback), objects leaving it get unloaded; state
    transitions fire exactly once per crossing."""

    def __init__(self, load_distance: float = 100.0,
                 on_object_entered=None, on_object_left=None):
        self.load_distance = load_distance
        self.on_object_entered = on_object_entered or (lambda ob: None)
        self.on_object_left = on_object_left or (lambda ob: None)
        self._in_range: set[int] = set()

    def update(self, campos, objects: dict):
        """objects: uid -> object with .pos.  Returns (entered, left) uids."""
        campos = np.asarray(campos[:3], np.float64)
        entered, left = [], []
        d2_max = self.load_distance ** 2
        if objects:
            uids = list(objects.keys())
            pos = np.array([np.asarray(objects[u].pos[:3], np.float64)
                            for u in uids])
            d2 = np.sum((pos - campos) ** 2, axis=1)
            now_in = {u for u, dd in zip(uids, d2) if dd <= d2_max}
        else:
            now_in = set()
        for u in now_in - self._in_range:
            entered.append(u)
            self.on_object_entered(objects[u])
        for u in self._in_range - now_in:
            left.append(u)
            if u in objects:
                self.on_object_left(objects[u])
        self._in_range = now_in
        return entered, left

    def set_load_distance(self, d: float):
        self.load_distance = d
