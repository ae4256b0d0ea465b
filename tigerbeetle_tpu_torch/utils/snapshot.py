"""Fixed-layout, versioned, checksummed snapshot encoding.

Replaces pickle for every durable blob (state-machine checkpoints,
client sessions, forest manifests): pickle is version-fragile — which
undercuts multiversion upgrades — and `pickle.loads` on bytes read from
disk or shipped by peers (state sync) is an arbitrary-code-execution
surface.  This codec can only produce numpy arrays of allowlisted plain
dtypes, unsigned ints (u128 max), and raw bytes — nothing executable.

The encoding is canonical: equal inputs give byte-equal blobs (the
convergence checkers compare snapshot bytes across replicas), entries
are emitted in the caller-provided order, and every blob carries a
SHA-256 of its payload verified before any parsing.

Discipline follows the reference's CheckpointState approach: explicit
layout, size asserts, verify-before-use (reference:
src/vsr/superblock.zig:1-56, src/vsr/checksum.zig:1-10).

Wire layout (little-endian):
    magic   8B  b"TBSNAP\\x01\\x00"
    count   u32  number of entries
    paylen  u64  byte length of the entry stream that follows
    sha256 32B  digest of the entry stream
    entries, each:
        key_len u16 | key utf-8 | kind u8 | meta | data_len u64 | data
    kind 0 ndarray: meta = dtype_len u16, dtype ascii, ndim u8, dims u64*
    kind 1 uint (<= 2^128-1): no meta, data = 16B LE
    kind 2 bytes: no meta
"""

from __future__ import annotations

import hashlib
import re
import struct

import numpy as np

MAGIC = b"TBSNAP\x01\x00"

# Plain data dtypes only — no objects, no structured records.
_DTYPE_RE = re.compile(r"^(\||<)([buif][1248]|V16|V8)$")


class SnapshotError(ValueError):
    pass


def _check_dtype(dtype: np.dtype) -> str:
    s = dtype.str
    if not _DTYPE_RE.match(s):
        raise SnapshotError(f"dtype not allowlisted: {s!r}")
    return s


def encode(entries: dict) -> bytes:
    """entries: ordered mapping key -> np.ndarray | int | bytes."""
    parts = []
    for key, value in entries.items():
        kb = key.encode("utf-8")
        head = struct.pack("<H", len(kb)) + kb
        if isinstance(value, np.ndarray):
            ds = _check_dtype(value.dtype).encode("ascii")
            value = np.ascontiguousarray(value)
            meta = struct.pack("<BH", 0, len(ds)) + ds
            meta += struct.pack("<B", value.ndim)
            meta += struct.pack(f"<{value.ndim}Q", *value.shape)
            data = value.tobytes()
        elif isinstance(value, (int, np.integer)):
            value = int(value)
            if not 0 <= value < (1 << 128):
                raise SnapshotError(f"int out of u128 range: {key}")
            meta = struct.pack("<B", 1)
            data = value.to_bytes(16, "little")
        elif isinstance(value, (bytes, bytearray, memoryview)):
            meta = struct.pack("<B", 2)
            data = bytes(value)
        else:
            raise SnapshotError(f"unsupported type for {key}: {type(value)}")
        parts.append(head + meta + struct.pack("<Q", len(data)) + data)
    payload = b"".join(parts)
    header = (
        MAGIC
        + struct.pack("<IQ", len(entries), len(payload))
        + hashlib.sha256(payload).digest()
    )
    return header + payload


def decode(blob: bytes) -> dict:
    """-> dict key -> np.ndarray | int | bytes.  Raises SnapshotError on
    any structural or checksum violation; never executes content."""
    if len(blob) < len(MAGIC) + 4 + 8 + 32:
        raise SnapshotError("snapshot truncated (header)")
    if blob[: len(MAGIC)] != MAGIC:
        raise SnapshotError("bad snapshot magic/version")
    at = len(MAGIC)
    count, paylen = struct.unpack_from("<IQ", blob, at)
    at += 12
    digest = blob[at : at + 32]
    at += 32
    payload = blob[at : at + paylen]
    if len(payload) != paylen:
        raise SnapshotError("snapshot truncated (payload)")
    if hashlib.sha256(payload).digest() != digest:
        raise SnapshotError("snapshot checksum mismatch")

    out: dict = {}
    at = 0

    def take(n: int) -> bytes:
        nonlocal at
        if at + n > len(payload):
            raise SnapshotError("snapshot truncated (entry)")
        piece = payload[at : at + n]
        at += n
        return piece

    for _ in range(count):
        (key_len,) = struct.unpack("<H", take(2))
        try:
            key = take(key_len).decode("utf-8")
        except UnicodeDecodeError as e:
            raise SnapshotError("key not utf-8") from e
        if key in out:
            raise SnapshotError(f"duplicate key {key}")
        (kind,) = struct.unpack("<B", take(1))
        if kind == 0:
            (dtype_len,) = struct.unpack("<H", take(2))
            try:
                dtype_str = take(dtype_len).decode("ascii")
            except UnicodeDecodeError as e:
                raise SnapshotError("dtype not ascii") from e
            if not _DTYPE_RE.match(dtype_str):
                raise SnapshotError(f"dtype not allowlisted: {dtype_str!r}")
            dtype = np.dtype(dtype_str)
            (ndim,) = struct.unpack("<B", take(1))
            if ndim > 4:
                raise SnapshotError("ndarray rank too large")
            shape = struct.unpack(f"<{ndim}Q", take(8 * ndim))
            (data_len,) = struct.unpack("<Q", take(8))
            # Python-int product: no u64 wrap for hostile dims.
            n_items = 1
            for dim in shape:
                n_items *= int(dim)
            expect = dtype.itemsize * n_items
            if data_len != expect:
                raise SnapshotError(f"array size mismatch for {key}")
            data = take(data_len)
            out[key] = np.frombuffer(data, dtype).reshape(shape).copy()
        elif kind == 1:
            (data_len,) = struct.unpack("<Q", take(8))
            if data_len != 16:
                raise SnapshotError("int entry must be 16 bytes")
            out[key] = int.from_bytes(take(16), "little")
        elif kind == 2:
            (data_len,) = struct.unpack("<Q", take(8))
            out[key] = take(data_len)
        else:
            raise SnapshotError(f"unknown entry kind {kind}")
    if at != len(payload):
        raise SnapshotError("trailing bytes after last entry")
    return out


def encode_tree(tree: dict, prefix: str = "") -> bytes:
    """Encode a nested dict by flattening keys with '/'."""
    return encode(flatten(tree, prefix))


def flatten(tree: dict, prefix: str = "") -> dict:
    flat: dict = {}
    for k, v in tree.items():
        assert "/" not in str(k), k
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, f"{key}/"))
        else:
            flat[key] = v
    return flat


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def decode_tree(blob: bytes) -> dict:
    return unflatten(decode(blob))
