"""The port's copy of ``tigerbeetle_tpu/vsr/__init__.py``."""

from tigerbeetle_tpu_torch.vsr.wire import (  # noqa: F401
    HEADER_DTYPE,
    Command,
    VsrOperation,
    checksum,
    finalize_header,
    header_from_bytes,
    make_header,
    root_prepare,
    verify_header,
)
