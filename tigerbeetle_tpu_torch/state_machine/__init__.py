from tigerbeetle_tpu_torch.state_machine.cpu import CpuStateMachine

__all__ = ["CpuStateMachine"]
