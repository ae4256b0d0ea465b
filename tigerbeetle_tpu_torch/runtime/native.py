"""ctypes bindings for the native host runtime (csrc/host/tb_runtime.cpp).

The port's own copy of ``tigerbeetle_tpu/runtime/native.py``.  The C++
library provides the epoll event loop, the header-framed TCP message
bus, and the C-ABI client session (the reference's io / message_bus /
tb_client components, reference: src/io/linux.zig, src/message_bus.zig,
src/clients/c/tb_client.zig).  It is built from the package's own
sources (``csrc/host/tb_runtime.cpp``, ``tb_async.cpp``) by
``kernels/host_build.py`` into ``build/native/libtb_runtime-<digest>.so``
at first use (under TB_NATIVE_SANITIZE=asan, its sanitized build in
``build/native/asan/``: one knob switches this library and the fast
path's).  No fallback: a failed build or load raises
NativeRuntimeError with the compiler's output.
"""

from __future__ import annotations

import ctypes
import threading

from tigerbeetle_tpu_torch import envcheck
from tigerbeetle_tpu_torch.kernels import host_build

_lib = None
_lib_lock = threading.RLock()


class NativeRuntimeError(RuntimeError):
    """The native runtime library could not be built or loaded (the
    message carries the compiler's output)."""


class _Event(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_int32),
        ("conn", ctypes.c_int32),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("len", ctypes.c_uint32),
    ]


EV_ACCEPTED, EV_CONNECTED, EV_MESSAGE, EV_CLOSED = 1, 2, 3, 4


def _load():
    """The runtime library, built first when missing; raises
    NativeRuntimeError when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        sanitize = envcheck.native_sanitize()
        try:
            path, _seconds = host_build.build(name="runtime", sanitize=sanitize)
        except host_build.NativeBuildError as exc:
            raise NativeRuntimeError(f"native runtime build failed: {exc}") from exc
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise NativeRuntimeError(f"native runtime load failed ({path}): {exc}") from exc

        lib.tb_bus_create.restype = ctypes.c_void_p
        lib.tb_bus_create.argtypes = [ctypes.c_uint32]
        lib.tb_bus_destroy.argtypes = [ctypes.c_void_p]
        lib.tb_bus_listen.restype = ctypes.c_int
        lib.tb_bus_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16]
        lib.tb_bus_listen_port.restype = ctypes.c_int
        lib.tb_bus_listen_port.argtypes = [ctypes.c_void_p]
        lib.tb_bus_connect.restype = ctypes.c_int
        lib.tb_bus_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16]
        lib.tb_bus_send.restype = ctypes.c_int
        lib.tb_bus_send.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.tb_bus_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tb_bus_poll.restype = ctypes.c_int
        lib.tb_bus_poll.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tb_bus_next_event.restype = ctypes.c_int
        lib.tb_bus_next_event.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Event)]
        lib.tb_client_init.restype = ctypes.c_void_p
        lib.tb_client_init.argtypes = [
            ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint64,
        ]
        lib.tb_client_deinit.argtypes = [ctypes.c_void_p]
        lib.tb_client_add_address.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16,
        ]
        lib.tb_client_request.restype = ctypes.c_int64
        lib.tb_client_request.argtypes = [
            ctypes.c_void_p, ctypes.c_uint8, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int,
        ]
        lib.tb_checksum128.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64 * 2,
        ]
        lib.tb_bus_send2.restype = ctypes.c_int
        lib.tb_bus_send2.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.tb_bus_sendv.restype = ctypes.c_int
        lib.tb_bus_sendv.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
        ]
        lib.tb_bus_poll_drain.restype = ctypes.c_int
        lib.tb_bus_poll_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the runtime library builds and loads (raises
    otherwise)."""
    return _load() is not None


def native_checksum128(data: bytes) -> int:
    lib = _load()
    out = (ctypes.c_uint64 * 2)()
    lib.tb_checksum128(data, len(data), out)
    return int(out[0]) | (int(out[1]) << 64)


class NativeBus:
    """Event-loop TCP bus: listen/connect/send/poll."""

    def __init__(self, message_size_max: int = 1 << 20) -> None:
        self._lib = _load()
        self._bus = self._lib.tb_bus_create(message_size_max)
        if not self._bus:
            raise RuntimeError("tb_bus_create failed")
        self._message_size_max = message_size_max
        self._drain_bufs = None

    @property
    def supports_drain(self) -> bool:
        return True

    def poll_drain(self, timeout_ms: int = 0, max_events: int = 4096):
        """Columnar drain: one C call copies every ready event into a
        reusable arena — `(n, types, conns, offsets, lens, arena)`
        numpy views, valid until the NEXT poll_drain/poll call.
        Message payloads are `arena[offsets[i]: offsets[i]+lens[i]]`;
        non-message events have len 0."""
        import numpy as np

        bufs = self._drain_bufs
        if bufs is None or len(bufs[0]) < max_events:
            cap = max(
                4 << 20, 2 * (self._message_size_max + 256)
            )
            bufs = self._drain_bufs = (
                np.empty(max(max_events, 4096), np.int32),   # types
                np.empty(max(max_events, 4096), np.int32),   # conns
                np.empty(max(max_events, 4096), np.uint64),  # offsets
                np.empty(max(max_events, 4096), np.uint32),  # lens
                np.empty(cap, np.uint8),                     # arena
            )
        types, conns, offsets, lens, arena = bufs
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = self._lib.tb_bus_poll_drain(
            self._bus, timeout_ms,
            arena.ctypes.data_as(u8p), arena.nbytes,
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            conns.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            min(max_events, len(types)),
        )
        return n, types, conns, offsets, lens, arena

    def listen(self, host: str, port: int) -> int:
        rc = self._lib.tb_bus_listen(self._bus, host.encode(), port)
        if rc != 0:
            raise OSError(f"listen {host}:{port} failed")
        return self._lib.tb_bus_listen_port(self._bus)

    def connect(self, host: str, port: int) -> int:
        conn = self._lib.tb_bus_connect(self._bus, host.encode(), port)
        if conn < 0:
            raise OSError(f"connect {host}:{port} failed")
        return conn

    def send(self, conn: int, data: bytes) -> None:
        self._lib.tb_bus_send(self._bus, conn, data, len(data))

    def send2(self, conn: int, head: bytes, body: bytes) -> None:
        """One queued message from two parts — no Python-side concat
        (a megabyte body saved one full copy per hop)."""
        self._lib.tb_bus_send2(
            self._bus, conn, head, len(head), body, len(body)
        )

    def sendv(self, conn: int, frames: list[bytes]) -> None:
        """Queue a run of complete frames for one connection in a
        single crossing (the drain loop: the backup's per-drain
        prepare_ok burst)."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        k = len(frames)
        bufs = (u8p * k)(
            *[ctypes.cast(ctypes.c_char_p(f), u8p) for f in frames]
        )
        lens = (ctypes.c_uint32 * k)(*[len(f) for f in frames])
        self._lib.tb_bus_sendv(self._bus, conn, bufs, lens, k)

    def close_conn(self, conn: int) -> None:
        self._lib.tb_bus_close(self._bus, conn)

    def poll(self, timeout_ms: int = 0) -> list[tuple[int, int, bytes]]:
        """-> [(event_type, conn, payload)]; payload copied out."""
        self._lib.tb_bus_poll(self._bus, timeout_ms)
        events = []
        ev = _Event()
        while self._lib.tb_bus_next_event(self._bus, ctypes.byref(ev)):
            payload = b""
            if ev.type == EV_MESSAGE and ev.len:
                payload = ctypes.string_at(ev.data, ev.len)
            events.append((int(ev.type), int(ev.conn), payload))
        return events

    def close(self) -> None:
        if self._bus:
            self._lib.tb_bus_destroy(self._bus)
            self._bus = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        # tbcheck: allow(broad-except): __del__ during interpreter
        # teardown — the bus handle may already be torn down; any
        # raise here becomes an unraisable-exception warning storm.
        except Exception:
            pass


class NativeClient:
    """Synchronous C-ABI client session (the tb_client analog)."""

    def __init__(self, host: str, port: int, cluster: int, client_id: int,
                 reply_cap: int = 1 << 20) -> None:
        self._lib = _load()
        self._client = self._lib.tb_client_init(
            host.encode(), port, cluster,
            client_id & 0xFFFFFFFFFFFFFFFF, client_id >> 64,
        )
        if not self._client:
            raise OSError(f"tb_client_init {host}:{port} failed")
        self._reply_buf = ctypes.create_string_buffer(reply_cap)

    def add_address(self, host: str, port: int) -> None:
        """Additional cluster replica: retransmissions rotate through
        every known address, so a view change (new primary without
        this client's connection) recovers."""
        self._lib.tb_client_add_address(
            self._client, host.encode(), port
        )

    def request(self, operation: int, body: bytes = b"",
                timeout_ms: int = 10_000) -> bytes:
        rc = self._lib.tb_client_request(
            self._client, operation, body, len(body),
            self._reply_buf, len(self._reply_buf), timeout_ms,
        )
        if rc < 0:
            raise OSError(
                {-2: "evicted", -3: "timeout", -4: "io error", -5: "reply too large"}
                .get(rc, f"error {rc}")
            )
        return self._reply_buf.raw[:rc]

    def close(self) -> None:
        if self._client:
            self._lib.tb_client_deinit(self._client)
            self._client = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        # tbcheck: allow(broad-except): same __del__-at-teardown story
        # as NativeBus above.
        except Exception:
            pass
