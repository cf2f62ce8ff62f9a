"""Physical object-store backends (the per-region stores SkyStore overlays).

The PyTorch port's copy of :mod:`repro.core.backends`: bytes on the host,
ETags the same ``hashlib`` digests of the same bytes.

The data plane speaks a minimal S3-ish interface.  Two implementations:

* :class:`InMemoryBackend` -- dict-backed, for tests and the cost simulator;
* :class:`FSBackend`       -- a directory per region, used by the training
  framework so checkpoints and data shards genuinely move through the store.

Backends know nothing about placement; they are what the paper calls the
"physical object stores" behind the S3-Proxy (§4.3).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class HeadResult:
    key: str
    size: int
    etag: str
    last_modified: float


class Backend:
    """One physical region's object store."""

    region: str
    #: Injected time source for ``last_modified`` stamps.  Backends never
    #: read the host clock themselves (replaylint RS001): the VirtualStore
    #: boundary installs its plane clock here, and a bare backend stamps the
    #: virtual-time origin 0.0 -- deterministic either way.
    clock: Optional[Callable[[], float]] = None

    def _stamp(self) -> float:
        return self.clock() if self.clock is not None else 0.0

    def put(self, bucket: str, key: str, data: bytes) -> HeadResult:
        raise NotImplementedError

    def put_stream(self, bucket: str, key: str,
                   chunks: Iterable[bytes]) -> HeadResult:
        """Write an object from an iterator of chunks.  The base
        implementation spools into one buffer (a backend that *is* RAM has
        to hold the bytes anyway); backends with real media override it to
        keep the writer's working set at one chunk (see
        :class:`FSBackend`)."""
        buf = bytearray()
        for c in chunks:
            buf += c
        return self.put(bucket, key, bytes(buf))

    def get(self, bucket: str, key: str,
            byte_range: Optional[Tuple[int, int]] = None) -> bytes:
        """Read an object, or -- with ``byte_range=(start, end)`` inclusive --
        just that slice (the S3 ranged-GET primitive)."""
        raise NotImplementedError

    def head(self, bucket: str, key: str) -> HeadResult:
        raise NotImplementedError

    def delete(self, bucket: str, key: str) -> None:
        raise NotImplementedError

    def list(self, bucket: str, prefix: str = "") -> Iterator[HeadResult]:
        raise NotImplementedError

    def exists(self, bucket: str, key: str) -> bool:
        try:
            self.head(bucket, key)
            return True
        except KeyError:
            return False

    def copy_from(self, src: "Backend", bucket: str, key: str) -> HeadResult:
        """Server-side-ish copy: the replication primitive of §2.3."""
        return self.put(bucket, key, src.get(bucket, key))


def _etag(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


class InMemoryBackend(Backend):
    """Dict-backed region store with per-op counters.

    The counters (`op_counts`, `bytes_in`, `bytes_out`) let the differential
    replay harness cross-check that metadata-level accounting corresponds to
    real physical traffic: every charged replication moved actual bytes.
    """

    def __init__(self, region: str):
        self.region = region
        self._data: Dict[Tuple[str, str], Tuple[bytes, HeadResult]] = {}
        self.op_counts: Dict[str, int] = {"put": 0, "get": 0, "delete": 0,
                                          "head": 0, "list": 0}
        self.bytes_in = 0
        self.bytes_out = 0

    def put(self, bucket, key, data):
        h = HeadResult(key, len(data), _etag(data), self._stamp())
        self._data[(bucket, key)] = (bytes(data), h)
        self.op_counts["put"] += 1
        self.bytes_in += len(data)
        return h

    def get(self, bucket, key, byte_range=None):
        try:
            data = self._data[(bucket, key)][0]
        except KeyError:
            raise KeyError(f"{self.region}: {bucket}/{key} not found") from None
        self.op_counts["get"] += 1
        if byte_range is not None:
            start, end = byte_range
            data = data[start:end + 1]
        self.bytes_out += len(data)
        return data

    def head(self, bucket, key):
        self.op_counts["head"] += 1
        try:
            return self._data[(bucket, key)][1]
        except KeyError:
            raise KeyError(f"{self.region}: {bucket}/{key} not found") from None

    def delete(self, bucket, key):
        self.op_counts["delete"] += 1
        self._data.pop((bucket, key), None)

    def list(self, bucket, prefix=""):
        self.op_counts["list"] += 1      # counted even if never iterated
        matches = [h for (b, k), (_d, h) in sorted(self._data.items())
                   if b == bucket and k.startswith(prefix)]
        return iter(matches)

    @property
    def stored_bytes(self) -> int:
        return sum(h.size for (_d, h) in self._data.values())


class FSBackend(Backend):
    """A local directory tree per region: <root>/<bucket>/<key>."""

    def __init__(self, region: str, root: str):
        self.region = region
        self.root = os.path.join(root, region.replace(":", "_"))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, bucket: str, key: str) -> str:
        safe = key.replace("..", "_")
        return os.path.join(self.root, bucket, safe)

    def put(self, bucket, key, data):
        p = self._path(bucket, key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)            # atomic within the region
        return HeadResult(key, len(data), _etag(data), self._stamp())

    def put_stream(self, bucket, key, chunks):
        """True streaming write: chunks go straight to the temp file, so
        proxy RAM holds one chunk at a time (the multipart-completion
        working-set bound); the ETag is digested incrementally."""
        p = self._path(bucket, key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        md5 = hashlib.md5()
        size = 0
        with open(tmp, "wb") as f:
            for c in chunks:
                f.write(c)
                md5.update(c)
                size += len(c)
        os.replace(tmp, p)            # atomic within the region
        return HeadResult(key, size, md5.hexdigest(), self._stamp())

    def get(self, bucket, key, byte_range=None):
        p = self._path(bucket, key)
        if not os.path.exists(p):
            raise KeyError(f"{self.region}: {bucket}/{key} not found")
        with open(p, "rb") as f:
            if byte_range is not None:
                start, end = byte_range
                f.seek(start)
                return f.read(end - start + 1)
            return f.read()

    def head(self, bucket, key):
        p = self._path(bucket, key)
        if not os.path.exists(p):
            raise KeyError(f"{self.region}: {bucket}/{key} not found")
        st = os.stat(p)
        return HeadResult(key, st.st_size, "", st.st_mtime)

    def delete(self, bucket, key):
        p = self._path(bucket, key)
        if os.path.exists(p):
            os.remove(p)

    def list(self, bucket, prefix=""):
        base = os.path.join(self.root, bucket)
        if not os.path.isdir(base):
            return
        for dirpath, _dirs, files in os.walk(base):
            for fn in sorted(files):
                full = os.path.join(dirpath, fn)
                key = os.path.relpath(full, base)
                if key.startswith(prefix):
                    st = os.stat(full)
                    yield HeadResult(key, st.st_size, "", st.st_mtime)


def make_backends(
    regions: List[str], kind: str = "memory", root: Optional[str] = None
) -> Dict[str, Backend]:
    if kind == "memory":
        return {r: InMemoryBackend(r) for r in regions}
    if kind == "fs":
        assert root is not None, "FS backends need a root directory"
        return {r: FSBackend(r, root) for r in regions}
    raise KeyError(kind)
