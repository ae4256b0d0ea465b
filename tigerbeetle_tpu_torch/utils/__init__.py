from tigerbeetle_tpu_torch.utils.hashindex import HashIndex, RunIndex

__all__ = ["HashIndex", "RunIndex"]
