"""Content-addressed resource store.

Parity with shared/Resource.{h,cpp} + shared/ResourceManager.{h,cpp} +
shared/URLUtils: resources are addressed by URL; the manager maps URL ->
local file path (content-hashed layout), tracks per-resource state
(NotPresent / Transferring / Present), and both client and server use it
for model/texture/audio payloads.

A copy of ``substrata_tpu/shared/resources.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
from dataclasses import dataclass, field
from enum import IntEnum


class ResourceState(IntEnum):
    NOT_PRESENT = 0
    TRANSFERRING = 1
    PRESENT = 2


@dataclass(eq=False)
class Resource:
    url: str
    local_path: str = ""
    state: int = int(ResourceState.NOT_PRESENT)
    owner_id: int = 0

    def getState(self):
        return self.state


def escape_url_to_filename(url: str) -> str:
    """URLUtils-style sanitisation: keep [A-Za-z0-9._-] (no path
    separators, no '..' runs), hash anything lossy back in."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", url)
    safe = re.sub(r"\.\.+", "_", safe)
    if safe != url or len(safe) > 100:
        digest = hashlib.sha1(url.encode()).hexdigest()[:16]
        safe = safe[:80] + "_" + digest
    return safe


def compute_content_url(data: bytes, name_hint: str = "res", ext: str = "") -> str:
    """Content-addressed URL for an uploaded payload (the reference derives
    URLs from file hashes so identical content dedupes)."""
    digest = hashlib.sha256(data).hexdigest()[:24]
    return f"{name_hint}_{digest}{ext}"


class ResourceManager:
    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self.lock = threading.RLock()
        self.resources: dict[str, Resource] = {}

    def path_for_url(self, url: str) -> str:
        return os.path.join(self.base_dir, escape_url_to_filename(url))

    def get_or_create_resource(self, url: str) -> Resource:
        with self.lock:
            r = self.resources.get(url)
            if r is None:
                path = self.path_for_url(url)
                r = Resource(url=url, local_path=path)
                if os.path.exists(path):
                    r.state = int(ResourceState.PRESENT)
                self.resources[url] = r
            return r

    def is_file_present(self, url: str) -> bool:
        return self.get_or_create_resource(url).state == int(ResourceState.PRESENT)

    def set_resource_transferring(self, url: str):
        with self.lock:
            self.get_or_create_resource(url).state = int(ResourceState.TRANSFERRING)

    def store_resource(self, url: str, data: bytes) -> Resource:
        """Write payload to the content store and mark present."""
        r = self.get_or_create_resource(url)
        tmp = r.local_path + ".part"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, r.local_path)
        with self.lock:
            r.state = int(ResourceState.PRESENT)
        return r

    def load_resource(self, url: str) -> bytes:
        r = self.get_or_create_resource(url)
        if r.state != int(ResourceState.PRESENT):
            raise FileNotFoundError(url)
        with open(r.local_path, "rb") as f:
            return f.read()

    def total_size_bytes(self) -> int:
        with self.lock:
            return sum(os.path.getsize(r.local_path)
                       for r in self.resources.values()
                       if r.state == int(ResourceState.PRESENT)
                       and os.path.exists(r.local_path))
