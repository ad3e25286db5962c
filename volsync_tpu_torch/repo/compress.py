"""Compression backend: zstd when the wheel is present, stdlib zlib
otherwise.

Ports ``volsync_tpu/repo/compress.py`` unchanged: without the
``zstandard`` wheel writes are zlib,
and the frame sniffing below reads either codec's objects.

The repository format prefers zstd (restic's own choice), but the
``zstandard`` wheel is an optional binary dependency — a container
without it must still run every mover end-to-end. Readers sniff the
frame (zstd's 4-byte magic vs zlib's deflate CMF header), so objects
written by either build decode on any build that has the matching
codec: zlib is stdlib and always decodable; a zstd object read on a
zlib-only build fails with a clear error naming the missing wheel
instead of corrupt-looking garbage.
"""

from __future__ import annotations

import zlib

try:
    import zstandard as _zstd
except ImportError:  # optional binary wheel
    _zstd = None

HAVE_ZSTD = _zstd is not None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


class CompressError(RuntimeError):
    pass


class Compressor:
    """zstandard.ZstdCompressor-shaped writer (zlib when zstd is absent).

    NOT thread-safe on the zstd path (one ZSTD_CCtx) — hold one per
    thread, exactly like zstandard.ZstdCompressor.
    """

    def __init__(self, level: int = 3):
        self._c = _zstd.ZstdCompressor(level=level) if _zstd else None
        self._level = min(level, 9)  # zlib's scale tops out at 9

    def compress(self, data: bytes) -> bytes:
        if self._c is not None:
            return self._c.compress(data)
        return zlib.compress(data, self._level)


class Decompressor:
    """Frame-sniffing reader for both codecs' output.

    NOT thread-safe on the zstd path (one ZSTD_DCtx) — hold one per
    thread, exactly like zstandard.ZstdDecompressor.
    """

    def __init__(self):
        self._d = _zstd.ZstdDecompressor() if _zstd else None

    def decompress(self, data: bytes, max_output_size: int = 0) -> bytes:
        if data[:4] == _ZSTD_MAGIC:
            if self._d is None:
                raise CompressError(
                    "object is zstd-compressed but the zstandard wheel "
                    "is not installed in this environment")
            try:
                if max_output_size:
                    return self._d.decompress(
                        data, max_output_size=max_output_size)
                return self._d.decompress(data)
            except _zstd.ZstdError as e:
                raise CompressError(str(e)) from None
        # zlib stream (the stdlib fallback writer always uses wbits=15,
        # whose CMF byte can never collide with the zstd magic)
        try:
            if max_output_size:
                d = zlib.decompressobj()
                out = d.decompress(data, max_output_size)
                if d.unconsumed_tail:
                    raise CompressError(
                        f"decompressed size exceeds {max_output_size}")
                return out
            return zlib.decompress(data)
        except zlib.error as e:
            raise CompressError(str(e)) from None
