"""Configuration constants (the subset this port reads).

Mirrors the reference's config presets (reference: src/config.zig:66-347,
src/constants.zig) — this package's own copy of
``tigerbeetle_tpu/constants.py``.
"""

from __future__ import annotations

import dataclasses

HEADER_SIZE = 256  # reference: src/vsr/message_header.zig:17


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    # reference: src/config.zig:153
    message_size_max: int

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


# reference: src/config.zig:66-175 (default/production values)
PRODUCTION = Config(name="production", message_size_max=1 * 1024 * 1024)

assert PRODUCTION.batch_max_create_transfers == 8190
