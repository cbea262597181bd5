"""DataManager abstraction (paper §III): anything deployable on granted
storage nodes that exposes file I/O to compute-node clients.

The paper deploys BeeGFS but explicitly frames the mechanism as generic
("parallel file system, but also ... object-based storage or databases in the
future"). We keep the abstraction so `EphemeralFS` (BeeGFS-analogue) and
`GlobalFS` (Lustre-analogue baseline) serve the same client API, and future
managers (KV store, object store) can slot in.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Iterable, Optional

from .resources import StorageNode


@dataclasses.dataclass(frozen=True)
class FileStat:
    path: str
    size: int
    is_dir: bool
    stripe_size: int
    n_targets: int


@dataclasses.dataclass
class ServiceInfo:
    kind: str              # "management" | "metadata" | "storage" | "monitor" | "mds" | "ost"
    node_id: str
    disk_name: str
    alive: bool = True


class FSError(OSError):
    pass


class DataManager(abc.ABC):
    """File-oriented data manager. All paths are absolute ('/a/b')."""

    # -- lifecycle -----------------------------------------------------------
    @abc.abstractmethod
    def services(self) -> list[ServiceInfo]:
        ...

    @abc.abstractmethod
    def teardown(self) -> None:
        """Stop services and delete all data (the paper: on release, services
        are killed and data on disks is deleted)."""

    # -- namespace -----------------------------------------------------------
    @abc.abstractmethod
    def create(self, path: str) -> None: ...

    @abc.abstractmethod
    def mkdir(self, path: str) -> None: ...

    @abc.abstractmethod
    def stat(self, path: str) -> FileStat: ...

    @abc.abstractmethod
    def readdir(self, path: str) -> list[str]: ...

    @abc.abstractmethod
    def unlink(self, path: str) -> None: ...

    @abc.abstractmethod
    def rmdir(self, path: str) -> None: ...

    def exists(self, path: str) -> bool:
        try:
            self.stat(path)
            return True
        except FSError:
            return False

    # -- data ----------------------------------------------------------------
    @abc.abstractmethod
    def write(self, path: str, offset: int, data: bytes) -> int: ...

    @abc.abstractmethod
    def read(self, path: str, offset: int, length: int) -> bytes: ...

    # -- failure injection / health ------------------------------------------
    @abc.abstractmethod
    def kill_node(self, node_id: str) -> None: ...

    @abc.abstractmethod
    def healthy(self) -> bool: ...


def normpath(path: str) -> str:
    if not path.startswith("/"):
        raise FSError(f"path must be absolute: {path!r}")
    parts = [p for p in path.split("/") if p]
    for p in parts:
        if p in (".", ".."):
            raise FSError(f"no relative components allowed: {path!r}")
    return "/" + "/".join(parts)


def parent_of(path: str) -> str:
    p = normpath(path)
    if p == "/":
        return "/"
    return p.rsplit("/", 1)[0] or "/"
