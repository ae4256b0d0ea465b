"""Reply demultiplexing for logically-batched requests.

The primary may pack several client requests of the same operation
into one prepare (cutting consensus/commit overhead per event); the
reply then contains results for the whole event batch, and each client
must receive only the slice covering its own events, with indexes
rebased to its sub-batch (reference: src/state_machine.zig:122-176
DemuxerType; batching allowed only for create_accounts /
create_transfers — batch_logical_allowed :122-131).

Result layouts are `{index: u32, result: u32}` pairs sorted by index
(the state machine emits failures in event order), so each slice is a
binary-searchable contiguous range.

This package's own copy of ``tigerbeetle_tpu/state_machine/demuxer.py``
(numpy only), pinned to it by tests/test_torch_demuxer.py.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.types import CREATE_RESULT_DTYPE, Operation

# reference: src/state_machine.zig:122-131
BATCH_LOGICAL_ALLOWED = frozenset(
    {Operation.create_accounts, Operation.create_transfers}
)


def batch_logical_allowed(operation: Operation) -> bool:
    return operation in BATCH_LOGICAL_ALLOWED


# Both batchable event types are 128-byte wire records
# (reference: src/tigerbeetle.zig:7-40, :80-111).
EVENT_SIZE = 128

# Batched prepares append this trailer (one record per sub-request) so
# every replica — primary, backup, or WAL replay — demuxes and stores
# per-client replies identically.
TRAILER_DTYPE = np.dtype(
    [
        ("client_lo", "<u8"), ("client_hi", "<u8"),
        ("request", "<u4"), ("count", "<u4"),
    ]
)


def encode_trailer(subs: list[tuple[int, int, int]]) -> bytes:
    """subs: [(client u128, request, event_count)] -> trailer bytes."""
    arr = np.zeros(len(subs), TRAILER_DTYPE)
    for i, (client, request, count) in enumerate(subs):
        arr[i]["client_lo"] = client & 0xFFFFFFFFFFFFFFFF
        arr[i]["client_hi"] = client >> 64
        arr[i]["request"] = request
        arr[i]["count"] = count
    return arr.tobytes()


def decode_trailer(
    body: bytes, n_subs: int
) -> tuple[bytes, list[tuple[int, int, int]]]:
    """-> (events bytes, subs) for a batched prepare body."""
    tsize = n_subs * TRAILER_DTYPE.itemsize
    assert len(body) >= tsize, (len(body), n_subs)
    arr = np.frombuffer(body[len(body) - tsize :], TRAILER_DTYPE)
    subs = [
        (
            int(r["client_lo"]) | (int(r["client_hi"]) << 64),
            int(r["request"]),
            int(r["count"]),
        )
        for r in arr
    ]
    events = body[: len(body) - tsize]
    assert len(events) == sum(s[2] for s in subs) * EVENT_SIZE
    return events, subs


def strip_trailer(body: bytes, subs: list[tuple[int, int, int]]) -> bytes:
    return body[: len(body) - len(subs) * TRAILER_DTYPE.itemsize]


class Demuxer:
    """Splits one batched reply into per-request slices, in order.

    reference: src/state_machine.zig:133-176 — decode() consumes
    monotonically increasing (event_offset, event_count) windows.
    """

    def __init__(self, operation: Operation, reply: bytes) -> None:
        assert batch_logical_allowed(operation), operation
        self._results = np.frombuffer(reply, CREATE_RESULT_DTYPE).copy()
        assert (np.diff(self._results["index"].astype(np.int64)) >= 0).all(), (
            "results must be sorted by index"
        )
        self._consumed = 0  # events consumed so far

    def decode(self, event_offset: int, event_count: int) -> bytes:
        """Results for events [event_offset, event_offset+event_count),
        rebased so the caller sees indexes starting at 0."""
        assert event_offset == self._consumed, (event_offset, self._consumed)
        idx = self._results["index"]
        lo = int(np.searchsorted(idx, event_offset, side="left"))
        hi = int(np.searchsorted(idx, event_offset + event_count, side="left"))
        out = self._results[lo:hi].copy()
        out["index"] -= np.uint32(event_offset)
        self._consumed += event_count
        return out.tobytes()
