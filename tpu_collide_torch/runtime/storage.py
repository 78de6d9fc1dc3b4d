"""Host-side KV storage with TTL + domain stores.

Covers the reference's storage layer surface (storage.py:15-546:
StorageInterface, InMemoryStorage, VehicleLocationStorage,
CollisionRiskStorage, GridVehicleStorage, StorageFactory). The device holds
the authoritative fleet state; these stores serve the REST/query surface
(current location, history, recent risks) without touching the device.
"""
from __future__ import annotations

import abc
import time
from typing import Any, Dict, List, Optional

from tpu_collide_torch.core.types import CollisionRisk, LocationData
from tpu_collide_torch.core.utils import CircuitBreaker, get_logger

logger = get_logger(__name__)


class StorageInterface(abc.ABC):
    """reference storage.py:15-28"""

    @abc.abstractmethod
    async def connect(self) -> None: ...

    @abc.abstractmethod
    async def disconnect(self) -> None: ...

    @abc.abstractmethod
    def is_connected(self) -> bool: ...


class InMemoryStorage(StorageInterface):
    """dict KV with TTL expiry-on-read (reference storage.py:31-140)."""

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self._expiry: Dict[str, float] = {}
        self._connected = False
        self.stats = {"sets": 0, "gets": 0, "hits": 0, "expired": 0}

    async def connect(self) -> None:
        self._connected = True

    async def disconnect(self) -> None:
        self._connected = False
        self._data.clear()
        self._expiry.clear()

    def is_connected(self) -> bool:
        return self._connected

    def _check_expiry(self, key: str) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and time.monotonic() >= exp:
            self._data.pop(key, None)
            self._expiry.pop(key, None)
            self.stats["expired"] += 1
            return True
        return False

    async def set(self, key: str, value: Any,
                  ttl: Optional[float] = None) -> bool:
        self._data[key] = value
        if ttl is not None:
            self._expiry[key] = time.monotonic() + ttl
        else:
            self._expiry.pop(key, None)
        self.stats["sets"] += 1
        return True

    async def get(self, key: str) -> Optional[Any]:
        self.stats["gets"] += 1
        if self._check_expiry(key):
            return None
        v = self._data.get(key)
        if v is not None:
            self.stats["hits"] += 1
        return v

    async def delete(self, key: str) -> bool:
        self._expiry.pop(key, None)
        return self._data.pop(key, None) is not None

    async def exists(self, key: str) -> bool:
        if self._check_expiry(key):
            return False
        return key in self._data


class VehicleLocationStorage:
    """Current location (TTL 60 s) + bounded history (TTL 1 h), guarded by a
    circuit breaker (reference storage.py:143-247)."""

    LOCATION_TTL = 60.0
    HISTORY_TTL = 3600.0
    MAX_HISTORY = 10

    def __init__(self, storage: InMemoryStorage):
        self.storage = storage
        self.breaker = CircuitBreaker(failure_threshold=5,
                                      recovery_timeout=10.0)

    @staticmethod
    def _loc_key(vid: str) -> str:
        return f"vehicle:location:{vid}"

    @staticmethod
    def _hist_key(vid: str) -> str:
        return f"vehicle:history:{vid}"

    async def store_location(self, location: LocationData) -> bool:
        if not self.breaker.allow():
            return False
        try:
            vid = location.vehicle_id
            await self.storage.set(self._loc_key(vid), location,
                                   ttl=self.LOCATION_TTL)
            hist: List[LocationData] = (
                await self.storage.get(self._hist_key(vid)) or [])
            hist.append(location)
            await self.storage.set(self._hist_key(vid),
                                   hist[-self.MAX_HISTORY:],
                                   ttl=self.HISTORY_TTL)
        except Exception:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return True

    async def get_location(self, vehicle_id: str) -> Optional[LocationData]:
        return await self.storage.get(self._loc_key(vehicle_id))

    async def get_location_history(self, vehicle_id: str) -> List[LocationData]:
        return await self.storage.get(self._hist_key(vehicle_id)) or []


class CollisionRiskStorage:
    """Risk by id (TTL 1 h) + last-20 per vehicle (reference
    storage.py:250-359)."""

    RISK_TTL = 3600.0
    MAX_PER_VEHICLE = 20

    def __init__(self, storage: InMemoryStorage):
        self.storage = storage

    async def store_risk(self, risk: CollisionRisk) -> bool:
        await self.storage.set(f"risk:{risk.id}", risk, ttl=self.RISK_TTL)
        for vid in (risk.vehicle_id, risk.other_vehicle_id):
            key = f"vehicle:risks:{vid}"
            ids: List[str] = await self.storage.get(key) or []
            ids.append(risk.id)
            await self.storage.set(key, ids[-self.MAX_PER_VEHICLE:],
                                   ttl=self.RISK_TTL)
        return True

    async def get_risk(self, risk_id: str) -> Optional[CollisionRisk]:
        return await self.storage.get(f"risk:{risk_id}")

    async def get_vehicle_risks(self, vehicle_id: str) -> List[CollisionRisk]:
        ids = await self.storage.get(f"vehicle:risks:{vehicle_id}") or []
        out = []
        for rid in ids:
            r = await self.storage.get(f"risk:{rid}")
            if r is not None:
                out.append(r)
        return out


class GridVehicleStorage:
    """grid <-> vehicle membership (reference storage.py:362-493)."""

    def __init__(self, storage: InMemoryStorage):
        self.storage = storage

    async def add_vehicle_to_grid(self, grid_id: str, vehicle_id: str) -> bool:
        key = f"grid:vehicles:{grid_id}"
        s = await self.storage.get(key) or set()
        s.add(vehicle_id)
        await self.storage.set(key, s)
        await self.storage.set(f"vehicle:grid:{vehicle_id}", grid_id)
        return True

    async def remove_vehicle_from_grid(self, grid_id: str,
                                       vehicle_id: str) -> bool:
        key = f"grid:vehicles:{grid_id}"
        s = await self.storage.get(key) or set()
        s.discard(vehicle_id)
        await self.storage.set(key, s)
        await self.storage.delete(f"vehicle:grid:{vehicle_id}")
        return True

    async def get_grid_vehicles(self, grid_id: str) -> List[str]:
        return sorted(await self.storage.get(f"grid:vehicles:{grid_id}") or [])

    async def get_vehicle_grid(self, vehicle_id: str) -> Optional[str]:
        return await self.storage.get(f"vehicle:grid:{vehicle_id}")


class StorageFactory:
    """reference storage.py:496-546. The reference also advertised
    redis:// URLs it never parsed (SURVEY.md §2.3); we accept the scheme
    and say so instead of silently ignoring it."""

    @staticmethod
    def create_storage(url: str = "memory://") -> InMemoryStorage:
        if not url.startswith("memory://"):
            logger.warning("external storage %r not available in this build; "
                           "using in-memory storage", url)
        return InMemoryStorage()

    @staticmethod
    def create_vehicle_location_storage(
            storage: Optional[InMemoryStorage] = None) -> VehicleLocationStorage:
        return VehicleLocationStorage(storage or InMemoryStorage())

    @staticmethod
    def create_collision_risk_storage(
            storage: Optional[InMemoryStorage] = None) -> CollisionRiskStorage:
        return CollisionRiskStorage(storage or InMemoryStorage())

    @staticmethod
    def create_grid_vehicle_storage(
            storage: Optional[InMemoryStorage] = None) -> GridVehicleStorage:
        return GridVehicleStorage(storage or InMemoryStorage())
