"""The router's recovery of a transfer that a coordinator kill left with
one hold, on the port's ``RouterCore`` against the reference's.

A stopped router may have sent a batch's holds to one shard and not yet
to the other.  Each case drives both packages' sans-IO cores over two
shards of their CPU oracles: the first core loses its hold batch for one
shard and dies, a second core runs the in-doubt recovery, and a third
re-drives the client's retransmitted request.  Both packages must give
equal replies, recovery results, 2PC rows and balances, and every
cross-shard transfer of the batch must end in a terminal state that
conserves money, answered ``pending_transfer_expired``:

- its debit hold lost: the recovery's probe finds no debit hold and
  voids the credit hold; the retransmission then creates the debit hold,
  posts it, finds the credit hold voided and compensates (the debitor
  shows the posted debit and the refunding credit);
- its credit hold lost: the recovery voids the debit hold; the
  retransmission finds it voided and voids the new credit hold.
"""

import importlib

import numpy as np
import pytest

ROLES = ("hold_debit", "hold_credit", "post_debit", "post_credit", "void_debit",
         "void_credit", "comp")
BALANCES = ("debits_pending", "credits_pending", "debits_posted", "credits_posted")


def _drive(pkg, shards, task, drop=None) -> bool:
    """Complete `task`'s sub-ops on `shards` stage by stage; a sub-op for
    which `drop` is true is never answered, and the task is abandoned
    after its stage (the coordinator dies).  -> whether it finished."""
    commitment = importlib.import_module(f"{pkg}.state_machine.commitment")
    pending = list(task.subops)
    while True:
        dropped = False
        for sub in pending:
            if drop is not None and drop(sub):
                dropped = True
                continue
            shard = shards[sub.shard]
            if sub.kind == "root":
                sub.complete(commitment.root_body(shard.sm.state_root(), shard.op))
            else:
                sub.complete(shard.submit(sub.operation, sub.body))
        if dropped:
            return False
        if task.done:
            return True
        pending = task.pump()
        assert pending or task.done, "a stage issued nothing and did not finish"


def _run(pkg: str, lost: int, seed: int) -> dict:
    types = importlib.import_module(f"{pkg}.types")
    harness = importlib.import_module(f"{pkg}.testing.harness")
    RouterCore = importlib.import_module(f"{pkg}.runtime.router").RouterCore
    CpuStateMachine = importlib.import_module(f"{pkg}.state_machine").CpuStateMachine
    Operation = types.Operation
    shards = [harness.SingleNodeHarness(CpuStateMachine()) for _ in range(2)]
    ids = list(range(1, 41))
    pools = [[a for a in ids if types.shard_of_account(a, 2) == s] for s in range(2)]
    core = RouterCore(2)
    task = core.open_request(1, 1, Operation.create_accounts,
                             harness.pack([harness.account(a) for a in ids]))
    assert _drive(pkg, shards, task) and task.result == b""
    rng = np.random.default_rng(seed)
    rows, crossing = [], []
    for i in range(12):
        home = i % 2
        peer = (home + 1) % 2 if i % 3 == 0 else home
        dr, cr = int(rng.choice(pools[home])), int(rng.choice(pools[peer]))
        cr = cr if cr != dr else next(a for a in pools[peer] if a != dr)
        rows.append(harness.transfer(1000 + i, debit_account_id=dr, credit_account_id=cr,
                                     amount=int(rng.integers(1, 100))))
        if peer != home:
            crossing.append((1000 + i, dr, cr, home, peer))
    body = harness.pack(rows)
    holds = {h for tid, *_rest in crossing
             for h in (types.XShardIds(tid).hold_debit, types.XShardIds(tid).hold_credit)}

    def drop(sub) -> bool:
        if sub.shard != lost or sub.kind != "coord" or sub.operation != Operation.create_transfers:
            return False
        return any(types.u128_get(r, "id") in holds
                   for r in np.frombuffer(sub.body, types.TRANSFER_DTYPE))

    first_done = _drive(pkg, shards, core.open_request(2, 1, Operation.create_transfers, body),
                        drop)
    recovery = RouterCore(2).recover()
    assert _drive(pkg, shards, recovery)
    retry = RouterCore(2).open_request(2, 1, Operation.create_transfers, body)
    assert _drive(pkg, shards, retry)
    reply = [(int(r["index"]), int(r["result"]))
             for r in np.frombuffer(retry.result, types.CREATE_RESULT_DTYPE)]
    present = {}
    for tid, _dr, _cr, dshard, cshard in crossing:
        x = types.XShardIds(tid)
        present[tid] = tuple(
            bool(len(shards[cshard if r.endswith("credit") else dshard].lookup_transfers(
                [getattr(x, r)])))
            for r in ROLES)
    balances = {a: [types.u128_get(shards[types.shard_of_account(a, 2)].lookup_accounts([a])[0], c)
                    for c in BALANCES] for a in ids}
    return dict(first_done=first_done, recovery=recovery.result, reply=reply, present=present,
                balances=balances, crossing=crossing,
                expired=int(types.CreateTransferResult.pending_transfer_expired),
                exists=int(types.CreateTransferResult.exists),
                rows=[(types.u128_get(r, "debit_account_id"), types.u128_get(r, "credit_account_id"),
                       types.u128_get(r, "amount")) for r in rows])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lost", [0, 1])
def test_recovery_of_a_one_sided_hold_matches_reference(lost, seed):
    got = _run("tigerbeetle_tpu_torch", lost, seed)
    ref = _run("tigerbeetle_tpu", lost, seed)
    assert got == ref
    assert not got["first_done"]
    assert got["recovery"]["indoubt"] == len(got["crossing"])
    # The harness keeps no client sessions, so the retransmission runs the
    # shard-local transfers again and they answer `exists` (a replica's
    # session would replay their first reply).
    crossing = {t - 1000 for t, *_rest in got["crossing"]}
    assert got["reply"] == [(i, got["expired"] if i in crossing else got["exists"])
                            for i in range(len(got["rows"]))]
    refunded = set()
    for tid, _dr, _cr, dshard, _cshard in got["crossing"]:
        roles = dict(zip(ROLES, got["present"][tid]))
        if dshard == lost:
            refunded.add(tid - 1000)
            assert roles == dict(hold_debit=True, hold_credit=True, post_debit=True,
                                 post_credit=False, void_debit=False, void_credit=True,
                                 comp=True)
        else:
            assert roles == dict(hold_debit=True, hold_credit=True, post_debit=False,
                                 post_credit=False, void_debit=True, void_credit=True,
                                 comp=False)
    assert refunded and len(refunded) < len(crossing)
    # Every account against the batch: the shard-local transfers posted,
    # the refunded debitors show both entries, the other cross-shard
    # transfers are absent.
    want = {a: [0, 0, 0, 0] for a in got["balances"]}
    for i, (dr, cr, amount) in enumerate(got["rows"]):
        if i in crossing:
            if i in refunded:
                want[dr][2] += amount
                want[dr][3] += amount
            continue
        want[dr][2] += amount
        want[cr][3] += amount
    assert got["balances"] == want
