"""Configuration constants.

Mirrors the reference's three-tier config system (reference:
src/config.zig:66-347, src/constants.zig) with the presets we need:
``production`` and ``test_min``. Consensus-critical cluster values keep
the reference's numbers so wire/disk artifacts stay compatible.  This
package's own copy of ``tigerbeetle_tpu/constants.py``.
"""

from __future__ import annotations

import dataclasses

SECTOR_SIZE = 4096  # reference: src/constants.zig sector_size
HEADER_SIZE = 256  # reference: src/vsr/message_header.zig:17 (@sizeOf(Header))

# reference: src/constants.zig:47
VSR_OPERATIONS_RESERVED = 128

# Event-loop tick length (ns): the simulator's wall-clock step, the
# replica's virtual monotonic increment, and the server's tick cadence
# all share this so clock-sync RTT arithmetic is consistent
# (reference: src/constants.zig tick_ms).
TICK_NS = 10_000_000


@dataclasses.dataclass(frozen=True)
class Config:
    """Cluster-critical + process config (subset used by this build)."""

    name: str
    # reference: src/config.zig:153
    message_size_max: int
    # reference: src/config.zig:158
    lsm_batch_multiple: int
    # reference: src/config.zig:149
    pipeline_prepare_queue_max: int
    # reference: src/config.zig journal_slot_count
    journal_slot_count: int
    # reference: src/config.zig:151
    clients_max: int = 64
    # Hot RAM tail retained across checkpoints: spill beats keep the
    # durable store at most this many rows ahead of the LSM tier, and
    # checkpoints spill only the excess — so checkpoint latency is
    # O(one beat), not O(interval).  0 = spill everything at
    # checkpoint (the small-state test configs).
    spill_keep_rows: int = 0
    quorum_replication_max: int = 3

    @property
    def message_body_size_max(self) -> int:
        # reference: src/constants.zig:220
        return self.message_size_max - HEADER_SIZE

    def batch_max(self, event_size: int, result_size: int = 8) -> int:
        # reference: src/state_machine.zig:75-81
        return self.message_body_size_max // max(event_size, result_size)

    @property
    def batch_max_create_transfers(self) -> int:
        return self.batch_max(128)

    @property
    def vsr_checkpoint_interval(self) -> int:
        # reference: src/constants.zig:55-57
        m = self.lsm_batch_multiple
        p = self.pipeline_prepare_queue_max
        return self.journal_slot_count - m - m * ((p + m - 1) // m)


# reference: src/config.zig:66-175 (default/production values)
PRODUCTION = Config(
    name="production",
    message_size_max=1 * 1024 * 1024,
    lsm_batch_multiple=32,
    pipeline_prepare_queue_max=8,
    journal_slot_count=1024,
    spill_keep_rows=16_384,
)

# reference: src/config.zig:256-286 (config=test_min)
TEST_MIN = Config(
    name="test_min",
    message_size_max=4096,
    lsm_batch_multiple=4,
    pipeline_prepare_queue_max=4,
    journal_slot_count=32,
    clients_max=4,
)

assert PRODUCTION.batch_max_create_transfers == 8190
assert PRODUCTION.vsr_checkpoint_interval == 960
