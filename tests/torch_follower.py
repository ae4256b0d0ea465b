"""What the port's follower tests share: the reference's follower cases
and a read-without-commit on the reference's JAX machine.

tests/test_follower.py's FollowerVopr and
test_sim_follower_crash_restart_reattests read the upstream replica
with ``sm.execute_read`` at their end.  The port's TorchStateMachine
has that method; the reference's TpuStateMachine does not, so on the
host and device arms of tests/torch_repoint.py the reference's run gets
the same read here, through its own read executors, for the length of
one case (`tpu_execute_read`).
"""

import torch_repoint as rp

FILE = "test_follower.py"


def pinned_seeds() -> list:
    """(seed, expect) of the reference's pinned FollowerVopr seeds, as
    its parametrize mark lists them."""
    case = rp.load(FILE, rp.REF).test_follower_vopr_pinned
    mark = next(m for m in case.pytestmark if m.name == "parametrize")
    return list(mark.args[1])


def _tpu_execute_read(self, operation, input_bytes):
    from tigerbeetle_tpu.types import Operation

    operation = Operation(operation)
    assert self.input_valid(operation, input_bytes)
    self._engine_drain()
    if operation == Operation.lookup_accounts:
        return self._lookup_accounts(input_bytes)
    if operation == Operation.lookup_transfers:
        return self._lookup_transfers(input_bytes)
    if operation == Operation.get_account_transfers:
        return self._get_account_transfers(input_bytes)
    return self._get_account_balances(input_bytes)


def tpu_execute_read(monkeypatch) -> None:
    """Give the reference's TpuStateMachine an execute_read for this
    case: the reply its commit() gives for the read at the current
    state, after its device engine drains, as the port's
    TorchStateMachine.execute_read does."""
    from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine

    monkeypatch.setattr(TpuStateMachine, "execute_read", _tpu_execute_read, raising=False)


def run_both(case: str, arm: str, tmp_path, monkeypatch, extra=None) -> list:
    if arm != "oracle":
        tpu_execute_read(monkeypatch)
    return rp.run_both(FILE, case, arm, tmp_path, extra)
