"""Archive container: a tar of named stream members plus a JSON manifest.

Reference analog: the reference shells out to `tar -cf` over its temp dir
(src/spring.cpp:250-255) with a raw-struct `cp.bin` manifest
(src/spring.cpp:217-221). We keep the tar interop (the archive can be
inspected with standard tools) but write it in-process and use a versioned
JSON manifest (`params.json`) — the raw-struct dump is ABI-fragile and
deliberately not reproduced. The manifest also carries a CRC32 per member,
checked on every read: the entropy codecs have no checksum of their own,
so a corrupted byte would otherwise decode silently into wrong records.

Per-block streams are named `<stream>.<block>` so random-access decompression
(--decompress-range) can extract only the blocks it needs.
"""
from __future__ import annotations

import io
import json
import os
import tarfile
import zlib
from typing import Iterator, Optional

from ..params import CompressionParams

MANIFEST_NAME = "params.json"
CRC_KEY = "member_crc32"     # manifest key: {member name: CRC32}


def _member_key(name: str) -> tuple:
    """Canonical member order: stream name, then numeric block index (so
    `quality.10` sorts after `quality.2`)."""
    stem, _, blk = name.rpartition(".")
    if stem and blk.isdigit():
        return (stem, 1, int(blk))
    return (name, 0, 0)


class ArchiveWriter:
    """`spooled=True`: thread-safe `add` that streams each member's bytes
    to an unlinked spill file immediately (codec outputs never accumulate
    in memory — at 10M reads the quality stream alone is ~300 MB of
    retained futures otherwise) and writes the tar at `finish()` in
    canonical name order, so archive bytes stay deterministic no matter
    which worker finished first (test_recompression_deterministic)."""

    def __init__(self, path: str, spooled: bool = False):
        self._tar = tarfile.open(path, "w", format=tarfile.GNU_FORMAT)
        self._names: set[str] = set()
        self._crc: dict[str, int] = {}
        self._spool = None
        if spooled:
            import tempfile
            import threading
            self._spool = tempfile.TemporaryFile(
                dir=os.path.dirname(os.path.abspath(path)) or ".")
            self._lock = threading.Lock()
            self._index: dict[str, tuple[int, int]] = {}

    def add(self, name: str, data: bytes) -> None:
        if self._spool is not None:
            with self._lock:
                if name in self._names:
                    raise ValueError(f"duplicate archive member {name}")
                self._names.add(name)
                self._crc[name] = zlib.crc32(data)
                off = self._spool.seek(0, 2)
                self._spool.write(data)
                self._index[name] = (off, len(data))
            return
        if name in self._names:
            raise ValueError(f"duplicate archive member {name}")
        self._names.add(name)
        self._crc[name] = zlib.crc32(data)
        info = tarfile.TarInfo(name)
        info.size = len(data)
        self._tar.addfile(info, io.BytesIO(data))

    def add_block(self, stream: str, block: int, data: bytes) -> None:
        self.add(f"{stream}.{block}", data)

    def _flush_spool(self) -> None:
        self._spool.flush()   # pread below bypasses the userspace buffer
        fd = self._spool.fileno()
        for name in sorted(self._index, key=_member_key):
            off, size = self._index[name]
            info = tarfile.TarInfo(name)
            info.size = size
            self._tar.addfile(info, _PreadReader(fd, off, size))
        self._index.clear()

    def finish(self, params: CompressionParams) -> None:
        if self._spool is not None:
            self._flush_spool()
        manifest = json.loads(params.to_json())
        manifest[CRC_KEY] = self._crc
        self.add_direct(MANIFEST_NAME, json.dumps(
            manifest, indent=1, sort_keys=True).encode())
        self._tar.close()
        if self._spool is not None:
            self._spool.close()

    def add_direct(self, name: str, data: bytes) -> None:
        """Bypass the spool (manifest goes last, after the sorted body)."""
        info = tarfile.TarInfo(name)
        info.size = len(data)
        self._tar.addfile(info, io.BytesIO(data))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            return
        self._tar.close()
        if self._spool is not None:
            self._spool.close()


class _PreadReader:
    """File-like over a (fd, offset, size) window for tarfile.addfile —
    copies spool bytes into the tar in bounded chunks."""

    def __init__(self, fd: int, off: int, size: int):
        self._fd, self._off, self._left = fd, off, size

    def read(self, n: int = -1) -> bytes:
        if n < 0 or n > self._left:
            n = self._left
        if n == 0:
            return b""
        data = os.pread(self._fd, n, self._off)
        self._off += len(data)
        self._left -= len(data)
        return data


class ArchiveReader:
    def __init__(self, path: str):
        self._tar = tarfile.open(path, "r")
        self._members = {m.name: m for m in self._tar.getmembers()}
        # member reads use os.pread at the recorded data offset: tarfile's
        # extractfile().read() seeks a SHARED file object and is not
        # thread-safe — the block-parallel decoder read corrupt bytes
        self._fd = os.open(path, os.O_RDONLY)
        self._crc: dict[str, int] = {}
        raw = self.get(MANIFEST_NAME)
        self.params = CompressionParams.from_json(raw.decode())
        # archives written before the CRC map existed carry none
        self._crc = json.loads(raw).get(CRC_KEY, {})

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def get(self, name: str) -> bytes:
        m = self._members.get(name)
        if m is None:
            raise KeyError(f"archive member {name} not found")
        data = os.pread(self._fd, m.size, m.offset_data)
        crc = self._crc.get(name)
        if crc is not None and zlib.crc32(data) != crc:
            raise RuntimeError(f"archive member {name} is corrupt "
                               "(CRC32 mismatch)")
        return data

    def get_block(self, stream: str, block: int) -> bytes:
        return self.get(f"{stream}.{block}")

    def has_block(self, stream: str, block: int) -> bool:
        return f"{stream}.{block}" in self._members

    def names(self) -> Iterator[str]:
        return iter(self._members)

    def size_by_prefix(self) -> dict[str, int]:
        """Compressed bytes per stream family (reference reports stream
        sizes by filename first letter, src/spring.cpp:228-248)."""
        sizes: dict[str, int] = {}
        for name, m in self._members.items():
            key = name.split(".")[0]
            sizes[key] = sizes.get(key, 0) + m.size
        return sizes

    def close(self) -> None:
        self._tar.close()
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
