from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness, account, transfer

__all__ = ["SingleNodeHarness", "account", "transfer"]
