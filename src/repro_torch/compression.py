"""Compression: zstandard when the wheel is present, stdlib zlib
otherwise (the port's copy of the JAX package's shim).

The migration pipeline compresses a workspace or slot before the wire.
``zstandard`` is an optional wheel (the card machine has none), so the
module degrades to zlib instead of failing at import time.
``decompress`` sniffs the frame magic, so a blob written by one backend
is readable wherever the matching codec exists; a zstd frame on a
zlib-only host raises a clear error instead of garbage.
"""

from __future__ import annotations

import zlib

try:
    import zstandard as _zstd
    HAVE_ZSTD = True
except ImportError:          # optional wheel absent: stdlib fallback
    _zstd = None
    HAVE_ZSTD = False

BACKEND = "zstd" if HAVE_ZSTD else "zlib"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def compress(data: bytes, level: int = 3) -> bytes:
    """One-shot compress with the best available backend."""
    if HAVE_ZSTD:
        return _zstd.ZstdCompressor(level=level).compress(data)
    return zlib.compress(data, min(level, 9))


def decompress(data: bytes) -> bytes:
    """One-shot decompress; routes on the frame magic."""
    if data[:4] == _ZSTD_MAGIC:
        if not HAVE_ZSTD:
            raise RuntimeError(
                "blob is a zstd frame but the zstandard wheel is not "
                "installed; re-create it or install zstandard")
        return _zstd.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


class Compressor:
    """Reusable compressor context (the shape the Migrator holds)."""

    def __init__(self, level: int = 3):
        self.level = level
        self._cctx = _zstd.ZstdCompressor(level=level) if HAVE_ZSTD else None

    def compress(self, data: bytes) -> bytes:
        if self._cctx is not None:
            return self._cctx.compress(data)
        return zlib.compress(data, min(self.level, 9))


class Decompressor:
    def __init__(self):
        self._dctx = _zstd.ZstdDecompressor() if HAVE_ZSTD else None

    def decompress(self, data: bytes) -> bytes:
        if self._dctx is not None and data[:4] == _ZSTD_MAGIC:
            return self._dctx.decompress(data)
        return decompress(data)
