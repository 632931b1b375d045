"""Framed byte codec used by the arena store.

``encode_bytes``/``decode_bytes`` wrap raw blob bytes in a small
self-describing frame so store transfers can pick a codec per blob and
always decode on the other side. Codecs: ``none`` (identity), ``rle``
(byte run-length, good for zero-padded arena images), ``zlib`` (general).
Every encoder falls back to a ``none`` frame when the codec is unavailable
or would *grow* the payload, so the knob is safe to leave on everywhere.

Frame layout (little-endian)::

    0..4   magic  b"RPBC"
    4      version (1)
    5      codec id (0=none, 1=rle, 2=zlib)
    6..14  raw (decoded) length, uint64
    14..   payload

``decode_bytes`` validates magic, version, codec id and the decoded
length; any mismatch raises :class:`CodecError` — the store treats that
exactly like a content-hash mismatch (quarantine, never admit).

This is the byte half of the reference package's ``dist/compression.py``,
frame for frame; the int8 gradient half is not ported yet.
"""

from __future__ import annotations

import struct


# ------------------------------------------------------------- byte codec
class CodecError(ValueError):
    """Frame is not a valid codec frame, or the payload does not decode
    to the advertised length (truncated / flipped bytes in transit)."""


_MAGIC = b"RPBC"
_VERSION = 1
_HEADER = struct.Struct("<4sBBQ")  # magic, version, codec id, raw length

_CODEC_IDS = {"none": 0, "rle": 1, "zlib": 2}
_CODEC_NAMES = {v: k for k, v in _CODEC_IDS.items()}


def available_codecs() -> list[str]:
    """Codec names ``encode_bytes`` accepts, in preference order."""
    names = ["none", "rle"]
    try:
        import zlib  # noqa: F401

        names.append("zlib")
    except ImportError:  # pragma: no cover - zlib is stdlib everywhere
        pass
    return names


def _rle_encode(data: bytes) -> bytes:
    # (run_len u8, value u8) pairs; runs longer than 255 split. Vectorised
    # boundary-finding via numpy keeps this usable on multi-MB arenas.
    import numpy as np

    if not data:
        return b""
    arr = np.frombuffer(data, dtype=np.uint8)
    boundaries = np.flatnonzero(np.diff(arr)) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [arr.size]))
    lengths = ends - starts
    values = arr[starts]
    # split runs > 255 into ceil(n/255) chunks
    n_chunks = (lengths + 254) // 255
    out_vals = np.repeat(values, n_chunks)
    out_lens = np.full(out_vals.size, 255, dtype=np.uint64)
    last_idx = np.cumsum(n_chunks) - 1
    rem = lengths - (n_chunks - 1) * 255
    out_lens[last_idx] = rem
    pairs = np.empty((out_vals.size, 2), dtype=np.uint8)
    pairs[:, 0] = out_lens.astype(np.uint8)
    pairs[:, 1] = out_vals
    return pairs.tobytes()


def _rle_decode(payload: bytes) -> bytes:
    import numpy as np

    if not payload:
        return b""
    if len(payload) % 2:
        raise CodecError("rle payload has odd length")
    pairs = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 2)
    if (pairs[:, 0] == 0).any():
        raise CodecError("rle payload contains a zero-length run")
    return np.repeat(pairs[:, 1], pairs[:, 0]).tobytes()


def encode_bytes(data: bytes, codec: str = "zlib", *, level: int = 6) -> bytes:
    """Frame ``data`` with ``codec``; falls back to a ``none`` frame when
    the codec is unavailable or does not shrink the payload."""
    data = bytes(data)
    if codec not in _CODEC_IDS:
        raise CodecError(
            f"unknown codec {codec!r}; available: {', '.join(_CODEC_IDS)}"
        )
    payload = data
    used = "none"
    if codec == "rle":
        encoded = _rle_encode(data)
        if len(encoded) < len(data):
            payload, used = encoded, "rle"
    elif codec == "zlib":
        try:
            import zlib

            encoded = zlib.compress(data, level)
            if len(encoded) < len(data):
                payload, used = encoded, "zlib"
        except ImportError:  # pragma: no cover - stdlib
            pass
    header = _HEADER.pack(_MAGIC, _VERSION, _CODEC_IDS[used], len(data))
    return header + payload


def decode_bytes(frame: bytes) -> bytes:
    """Inverse of :func:`encode_bytes`; raises :class:`CodecError` on any
    malformed, truncated, or wrong-length frame."""
    frame = bytes(frame)
    if len(frame) < _HEADER.size:
        raise CodecError(
            f"frame too short ({len(frame)} bytes < {_HEADER.size} header)"
        )
    magic, version, codec_id, raw_len = _HEADER.unpack_from(frame)
    if magic != _MAGIC:
        raise CodecError(f"bad magic {magic!r} (expected {_MAGIC!r})")
    if version != _VERSION:
        raise CodecError(f"unsupported frame version {version}")
    name = _CODEC_NAMES.get(codec_id)
    if name is None:
        raise CodecError(f"unknown codec id {codec_id}")
    payload = frame[_HEADER.size:]
    if name == "none":
        data = payload
    elif name == "rle":
        data = _rle_decode(payload)
    else:
        import zlib

        try:
            data = zlib.decompress(payload)
        except zlib.error as e:
            raise CodecError(f"zlib payload does not decompress: {e}") from e
    if len(data) != raw_len:
        raise CodecError(
            f"decoded length {len(data)} != advertised {raw_len}"
        )
    return data
