"""Compute-node client for a deployed data manager (paper §III-C).

BeeGFS needs a kernel module and a privileged mount; the paper lists this as
its main limitation (§V) and sketches prolog/epilog workarounds. Our client is
pure user-space (the abstraction the paper wishes it had), bound to a
``DataManager`` instance; it adds per-client op/byte accounting used by the
benchmarks and the monitoring service.
"""

from __future__ import annotations

import dataclasses

from .datamanager import DataManager, FSError, FileStat


@dataclasses.dataclass
class ClientStats:
    bytes_written: int = 0
    bytes_read: int = 0
    ops: int = 0


class FSClient:
    """One logical client (one compute-node process in the paper's runs)."""

    def __init__(self, fs: DataManager, client_id: str = "client0"):
        self._fs = fs
        self.client_id = client_id
        self.stats = ClientStats()
        self._mounted = True

    # -- lifecycle ---------------------------------------------------------
    def unmount(self) -> None:
        """Paper: 'on compute nodes, clients are properly stopped'."""
        self._mounted = False

    def _check(self) -> None:
        if not self._mounted:
            raise FSError(f"client {self.client_id} is unmounted")

    # -- namespace -----------------------------------------------------------
    def create(self, path: str) -> None:
        self._check()
        self.stats.ops += 1
        self._fs.create(path)

    def mkdir(self, path: str) -> None:
        self._check()
        self.stats.ops += 1
        self._fs.mkdir(path)

    def makedirs(self, path: str) -> None:
        self._check()
        parts = [p for p in path.split("/") if p]
        cur = ""
        for p in parts:
            cur += "/" + p
            if not self._fs.exists(cur):
                self.mkdir(cur)

    def stat(self, path: str) -> FileStat:
        self._check()
        self.stats.ops += 1
        return self._fs.stat(path)

    def exists(self, path: str) -> bool:
        self._check()
        self.stats.ops += 1
        return self._fs.exists(path)

    def readdir(self, path: str) -> list[str]:
        self._check()
        self.stats.ops += 1
        return self._fs.readdir(path)

    def unlink(self, path: str) -> None:
        self._check()
        self.stats.ops += 1
        self._fs.unlink(path)

    def rmdir(self, path: str) -> None:
        self._check()
        self.stats.ops += 1
        self._fs.rmdir(path)

    # -- data ----------------------------------------------------------------
    def pwrite(self, path: str, offset: int, data: bytes) -> int:
        self._check()
        n = self._fs.write(path, offset, data)
        self.stats.bytes_written += n
        self.stats.ops += 1
        return n

    def pread(self, path: str, offset: int, length: int) -> bytes:
        self._check()
        buf = self._fs.read(path, offset, length)
        self.stats.bytes_read += len(buf)
        self.stats.ops += 1
        return buf

    def write_file(self, path: str, data: bytes) -> int:
        if not self._fs.exists(path):
            self.create(path)
        return self.pwrite(path, 0, data)

    def read_file(self, path: str) -> bytes:
        st = self.stat(path)
        return self.pread(path, 0, st.size)
