"""Simulated S3: in-memory object store with the S3 contract.

Reproduces the properties Starling depends on (§3.2):
  * binary objects under bucket/key, write-once REPLACE semantics
    (conditional create used for first-writer-wins backup tasks),
  * atomic reads and writes (readers never see partial data),
  * range GETs,
  * NO read-after-write visibility guarantee: a PUT may stay invisible for a
    sampled lag (§3.3.1) — the motivation for doublewrite,
  * per-request accounting at the paper's prices (GET $0.0004/1k,
    PUT $0.005/1k).

Timing: request *latencies* are sampled from objectstore.latency models; the
store applies them by sleeping ``latency * time_scale``, so end-to-end runs
are faithful in structure but fast in wall-clock (time_scale defaults small
for tests; cost accounting never depends on the scale).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.objectstore.latency import (S3_GET_MODEL, S3_PUT_MODEL,
                                       LatencyModel, sample_visibility_lag)

GET_PRICE = 0.0004 / 1000           # $ per GET (any size)
PUT_PRICE = 0.005 / 1000            # $ per PUT


@dataclasses.dataclass
class StoreConfig:
    seed: int = 0
    time_scale: float = 0.0          # 0 = no sleeping (pure accounting)
    get_model: LatencyModel = S3_GET_MODEL
    put_model: LatencyModel = S3_PUT_MODEL
    simulate_visibility_lag: bool = True


class RequestStats:
    def __init__(self):
        self.gets = 0
        self.puts = 0
        self.get_bytes = 0
        self.put_bytes = 0
        self.lock = threading.Lock()

    def snapshot(self) -> dict:
        return {"gets": self.gets, "puts": self.puts,
                "get_bytes": self.get_bytes, "put_bytes": self.put_bytes,
                "request_cost": self.cost()}

    def cost(self) -> float:
        return self.gets * GET_PRICE + self.puts * PUT_PRICE


class ObjectStore:
    def __init__(self, config: StoreConfig | None = None):
        self.config = config or StoreConfig()
        self._objects: dict[str, bytes] = {}
        self._visible_at: dict[str, float] = {}
        self._lock = threading.Lock()
        self._rng_lock = threading.Lock()
        self._rng = np.random.default_rng(self.config.seed)
        self.stats = RequestStats()
        # §3.2 immutability check for fault-path replays: when armed, an
        # overwrite must carry byte-identical data (repro_torch.faults.journal)
        self.verify_replay = False

    # -- internals ----------------------------------------------------------
    def _sample(self, fn, *a):
        with self._rng_lock:
            return fn(*a, self._rng)

    def _sleep(self, seconds: float):
        if self.config.time_scale > 0:
            time.sleep(seconds * self.config.time_scale)

    # -- API ----------------------------------------------------------------
    def put(self, key: str, data: bytes, *, if_none_match: bool = False
            ) -> bool:
        """Atomic PUT. if_none_match=True -> only create (first writer wins).

        Returns True if the object was written.
        """
        lat = self._sample(self.config.put_model.sample, len(data))
        self._sleep(lat)
        now = time.monotonic()
        lag = self._sample(sample_visibility_lag) \
            if self.config.simulate_visibility_lag else 0.0
        with self._lock:
            if if_none_match and key in self._objects:
                with self.stats.lock:
                    self.stats.puts += 1
                return False
            if self.verify_replay and key in self._objects and \
                    self._objects[key] != bytes(data):
                raise AssertionError(
                    f"replay divergence: overwrite of {key!r} with "
                    "different bytes — §3.2 immutability violated")
            self._objects[key] = bytes(data)
            self._visible_at[key] = now + lag * max(self.config.time_scale,
                                                    1e-9)
        with self.stats.lock:
            self.stats.puts += 1
            self.stats.put_bytes += len(data)
        return True

    def exists(self, key: str) -> bool:
        with self._lock:
            return (key in self._objects
                    and time.monotonic() >= self._visible_at.get(key, 0.0))

    def get(self, key: str, start: int | None = None,
            end: int | None = None) -> bytes:
        """Range GET [start, end). Raises KeyError if (visibly) absent."""
        with self._lock:
            visible = (key in self._objects
                       and time.monotonic() >= self._visible_at.get(key, 0.0))
            data = self._objects.get(key) if visible else None
        if data is None:
            with self.stats.lock:
                self.stats.gets += 1
            raise KeyError(key)
        body = data[start or 0: end if end is not None else len(data)]
        lat = self._sample(self.config.get_model.sample, len(body))
        self._sleep(lat)
        with self.stats.lock:
            self.stats.gets += 1
            self.stats.get_bytes += len(body)
        return body

    def size(self, key: str) -> int:
        with self._lock:
            return len(self._objects[key])

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._objects)

    def delete_all(self):
        with self._lock:
            self._objects.clear()
            self._visible_at.clear()
