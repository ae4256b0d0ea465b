"""The port's copy of ``tigerbeetle_tpu/lsm/__init__.py``."""

from tigerbeetle_tpu_torch.lsm.runs import pack_u128

__all__ = ["pack_u128"]
