"""Account-sharded multi-cluster router with crash-safe cross-shard 2PC.

One VSR group caps the whole system at a single primary's pipeline;
this module serves N independent consensus groups ("shards"), each
owning the account range `types.shard_of_account` maps to it, behind
one client-facing router:

- Shard-local work (both accounts on one shard, lookups, queries) is
  FORWARDED on the client's own session: the router impersonates the
  client on each shard, reusing the client's request numbers, so the
  shards' at-most-once session dedupe keeps working across router
  crashes (a retransmitted request replays the stored sub-replies).
- A cross-shard transfer is a distributed transaction built from the
  state machine's own two-phase machinery (the idempotent commit
  primitive of the cross-shard atomic transfer protocols,
  arXiv:2102.09688 / arXiv:2503.04595): a pending hold debiting the
  client account into a coordinator-owned settlement account on the
  debit shard, a mirrored hold on the credit shard, then a coordinator
  post (commit) or void (abort) of both.

Crash safety is structural, not stateful — the router keeps NOTHING
durable of its own:

- Every 2PC artifact has a DETERMINISTIC id derived from the client's
  transfer id (`types.XShardIds`), so re-driving any leg after a crash
  is deduplicated by transfer-id uniqueness (`exists`), never
  double-applied.
- The COMMIT DECISION is itself a replicated op: posting the
  debit-side hold rides the debit shard's consensus log.  A recovered
  coordinator reads the decision back from hold state and finishes the
  credit side idempotently.
- ABORT decisions record the client-visible result code in the void
  record's `user_data_64`, so a retransmitted aborted transfer replays
  its original error.
- In-doubt DISCOVERY needs no coordinator state either: settlement
  accounts are enumerable through a ledger-registry trail (a posted
  registry transfer per (shard, ledger), amount = ledger number), and
  every 2PC row touches a settlement account, so
  `get_account_transfers` over the settlement accounts re-surfaces
  every transfer the old coordinator ever started.
- Holds carry the TB_COORD_TIMEOUT_S pending timeout: an orphaned hold
  (coordinator lost before any decision) is voided by the shard's own
  expiry pulse — a clean abort, never lost money.

`RouterCore` is sans-IO (generators yielding SubOp batches) and shared
by the TCP `RouterServer` below and the deterministic simulation
transport in `testing/cluster.py`.

This package's own copy of ``tigerbeetle_tpu/runtime/router.py``; the
shards it fronts run the port's state machines.
"""

from __future__ import annotations

import time

import numpy as np

from tigerbeetle_tpu_torch import envcheck, types
from tigerbeetle_tpu_torch.constants import HEADER_SIZE
from tigerbeetle_tpu_torch.types import (
    ACCOUNT_DTYPE,
    ACCOUNT_FILTER_DTYPE,
    CREATE_RESULT_DTYPE,
    TRANSFER_DTYPE,
    U128_PAIR_DTYPE,
    AccountFilterFlags,
    CreateAccountResult,
    CreateTransferResult,
    Operation,
    TransferFlags,
    XShardIds,
    coord_account_id,
    shard_of_account,
    u128_get,
    u128_set,
    xleg_tag,
    xleg_untag,
)

CTR = CreateTransferResult
CAR = CreateAccountResult

# Result codes that mean "this row is (already) applied" for an
# idempotent re-drive: `exists` is the id-dedupe answer for a row the
# previous coordinator incarnation already committed.
_OKISH = (int(CTR.ok), int(CTR.exists))

_POST_VOID = int(TransferFlags.post_pending_transfer | TransferFlags.void_pending_transfer)

# Registry marker ids are derived like 2PC ids but keyed by ledger.
def ledger_marker_id(ledger: int) -> int:
    return XShardIds._derive(ledger, "ledger-marker")


# The coordinator's STABLE wire identity: one session per shard for the
# lifetime of the deployment, re-registered (an idempotent replay) by
# every router incarnation.  A fresh id per incarnation would grow the
# shards' session tables until an eviction hit a live client session.
COORD_CLIENT_ID = 0xC00D_1D00_0000_0001

# Request-number gap a recovering coordinator leaves above the
# session's last committed request (the register reply's resume hint):
# anything the dead incarnation still had in flight is both out of the
# new range and permanently fenced as stale once a new request commits.
COORD_RESUME_GAP = 1 << 16


def result_codes(n_rows: int, reply: bytes) -> list[int]:
    """Expand a create_* reply (nonzero results only) into a dense
    per-row code list (0 = ok)."""
    codes = [0] * n_rows
    for r in np.frombuffer(reply, CREATE_RESULT_DTYPE):
        codes[int(r["index"])] = int(r["result"])
    return codes


def pack_results(pairs: list[tuple[int, int]]) -> bytes:
    """(index, code) pairs (nonzero codes), sorted by index, to wire."""
    pairs = sorted(p for p in pairs if p[1] != 0)
    arr = np.zeros(len(pairs), dtype=CREATE_RESULT_DTYPE)
    for i, (idx, code) in enumerate(pairs):
        arr[i]["index"] = idx
        arr[i]["result"] = code
    return arr.tobytes()


def _transfer_row(id: int, *, debit: int = 0, credit: int = 0,
                  amount: int = 0, pending_id: int = 0, ledger: int = 0,
                  code: int = 0, flags: int = 0, timeout: int = 0,
                  user_data_128: int = 0, user_data_64: int = 0) -> np.ndarray:
    row = np.zeros(1, dtype=TRANSFER_DTYPE)[0]
    u128_set(row, "id", id)
    u128_set(row, "debit_account_id", debit)
    u128_set(row, "credit_account_id", credit)
    u128_set(row, "amount", amount)
    u128_set(row, "pending_id", pending_id)
    u128_set(row, "user_data_128", user_data_128)
    row["user_data_64"] = user_data_64
    row["ledger"] = ledger
    row["code"] = code
    row["flags"] = flags
    row["timeout"] = timeout
    return row


def _account_row(id: int, *, ledger: int, code: int = 1) -> np.ndarray:
    row = np.zeros(1, dtype=ACCOUNT_DTYPE)[0]
    u128_set(row, "id", id)
    row["ledger"] = ledger
    row["code"] = code
    return row


def _filter_body(account_id: int, *, timestamp_min: int = 0,
                 limit: int = 8190) -> bytes:
    row = np.zeros(1, dtype=ACCOUNT_FILTER_DTYPE)[0]
    u128_set(row, "account_id", account_id)
    row["timestamp_min"] = timestamp_min
    row["limit"] = limit
    row["flags"] = AccountFilterFlags.debits | AccountFilterFlags.credits
    return row.tobytes()


def _ids_body(ids: list[int]) -> bytes:
    arr = np.zeros(len(ids), dtype=U128_PAIR_DTYPE)
    for i, v in enumerate(ids):
        arr[i]["lo"] = v & types.U64_MAX
        arr[i]["hi"] = v >> 64
    return arr.tobytes()


class SubOp:
    """One shard-bound operation the transport must complete.

    kind "fwd":   impersonated forward on the CLIENT's session — the
                  transport must use the client's own id and the
                  client's request number (at-most-once dedupe).
    kind "coord": coordinator-session op — the transport picks request
                  numbers freely; idempotency is id-level.
    kind "root":  sessionless proof-of-state query (VsrOperation.
                  state_root) — answered by the shard's server loop
                  outside consensus, so the transport sends it with
                  no session at all (read-only, trivially idempotent).
    """

    __slots__ = ("shard", "kind", "operation", "body", "done", "reply",
                 "client", "request", "trace")

    def __init__(self, shard: int, kind: str, operation, body: bytes, *,
                 client: int = 0, request: int = 0,
                 trace: tuple[int, int, int] = (0, 0, 0)) -> None:
        self.shard = shard
        self.kind = kind
        self.operation = operation
        self.body = body
        self.client = client
        self.request = request
        self.trace = trace
        self.done = False
        self.reply: bytes | None = None

    def complete(self, reply: bytes) -> None:
        self.done = True
        self.reply = reply


class _Task:
    """A generator-driven multi-stage operation: the generator yields
    lists of SubOps; when all of a stage's subops complete, pump()
    resumes it.  The generator's final `return value` (StopIteration)
    becomes `.result`."""

    def __init__(self, gen) -> None:
        self._gen = gen
        self.subops: list[SubOp] = []
        self.done = False
        self.result = None
        self._advance()

    def _advance(self) -> None:
        while True:
            try:
                self.subops = next(self._gen) or []
            except StopIteration as stop:
                self.subops = []
                self.done = True
                self.result = stop.value
                return
            if self.subops:
                return  # a stage with nothing to wait for advances now

    def pump(self) -> list[SubOp]:
        """-> freshly issued subops (empty if waiting or done)."""
        if self.done or any(not s.done for s in self.subops):
            return []
        self._advance()
        return self.subops


class _XRow:
    """One cross-shard transfer row of a create_transfers batch."""

    __slots__ = ("index", "tid", "dr", "cr", "amount", "ledger", "code",
                 "dshard", "cshard", "ids", "commit", "client_code")

    def __init__(self, index, tid, dr, cr, amount, ledger, code,
                 dshard, cshard) -> None:
        self.index = index
        self.tid = tid
        self.dr = dr
        self.cr = cr
        self.amount = amount
        self.ledger = ledger
        self.code = code
        self.dshard = dshard
        self.cshard = cshard
        self.ids = XShardIds(tid)
        self.commit = False
        self.client_code = 0


class RouterCore:
    """Sans-IO router logic: batch splitting, cross-shard 2PC staging,
    reply merging, and crash recovery — all expressed as SubOp batches
    for a transport to execute."""

    def __init__(self, n_shards: int, *, coord_timeout_s: int | None = None,
                 registry=None) -> None:
        self.n_shards = n_shards
        self.coord_timeout_s = (
            coord_timeout_s if coord_timeout_s is not None
            else envcheck.coord_timeout_s()
        )
        # (shard, ledger) pairs whose settlement accounts this
        # incarnation has ensured.  Volatile by design: re-ensuring is
        # an idempotent create (`exists`).
        self._ensured: set[tuple[int, int]] = set()
        # Cross-shard tids owned by a LIVE open request of this
        # incarnation: the concurrent recovery scan must not
        # probe-void them — their open request makes the decision.
        self._active_tids: set[int] = set()
        # Optional flight recorder (obs/flight.py): 2PC stage instants
        # (holds issued, decision, credit post) land in the postmortem
        # ring tagged with the client's trace id, so one merge_traces
        # pass over router flight dump + shard traces reads
        # hold -> hold -> post end to end.
        self.flight = None
        from tigerbeetle_tpu_torch import obs

        self.registry = registry if registry is not None else obs.Registry()
        self._c_requests = self.registry.counter("router.requests")
        self._c_cross = self.registry.counter("router.cross_shard_transfers")
        self._c_local = self.registry.counter("router.local_transfers")
        self._c_commits = self.registry.counter("router.2pc_commits")
        self._c_aborts = self.registry.counter("router.2pc_aborts")
        self._c_roundtrips = self.registry.counter("router.2pc_roundtrips")
        self._c_conflicts = self.registry.counter("router.2pc_conflicts")
        self._c_compensations = self.registry.counter(
            "router.2pc_compensations"
        )
        self._c_recovered = self.registry.counter("router.indoubt_recovered")

    # ------------------------------------------------------------------
    # Batch splitting.

    def _chain_groups(self, flags_col) -> list[list[int]]:
        """Partition row indices into linked-chain groups (singletons
        for unlinked rows).  A trailing open chain stays one group (the
        state machine answers linked_event_chain_open for it)."""
        groups: list[list[int]] = []
        current: list[int] = []
        for i, f in enumerate(flags_col):
            current.append(i)
            if not (int(f) & int(TransferFlags.linked)):
                groups.append(current)
                current = []
        if current:
            groups.append(current)
        return groups

    def _plan_create_transfers(self, body: bytes):
        """-> (fwd_rows per shard, broadcast row indices, xrows,
        router_rejects [(index, code)])."""
        rows = np.frombuffer(body, dtype=TRANSFER_DTYPE)
        fwd: dict[int, list[int]] = {}
        broadcast: list[int] = []
        xrows: list[_XRow] = []
        rejects: list[tuple[int, int]] = []
        for group in self._chain_groups(rows["flags"]):
            if len(group) > 1:
                # Chain: routed as a unit to the first member's debit
                # shard.  A chain whose accounts span shards fails
                # closed there (account_not_found aborts the whole
                # chain) — never partially applied.
                first = rows[group[0]]
                shard = shard_of_account(
                    u128_get(first, "debit_account_id"), self.n_shards
                )
                fwd.setdefault(shard, []).extend(group)
                continue
            i = group[0]
            row = rows[i]
            flags = int(row["flags"])
            if flags & _POST_VOID:
                # Post/void routes by its pending transfer's location,
                # which only the owning shard knows: broadcast; the
                # merge keeps the one non-not_found verdict.
                broadcast.append(i)
                continue
            dr = u128_get(row, "debit_account_id")
            cr = u128_get(row, "credit_account_id")
            dshard = shard_of_account(dr, self.n_shards)
            cshard = shard_of_account(cr, self.n_shards)
            if dshard == cshard or flags != 0:
                # Shard-local — or flagged (pending/balancing)
                # cross-shard, which is unsupported and fails closed on
                # the debit shard (credit_account_not_found).
                fwd.setdefault(dshard, []).append(i)
                continue
            if int(row["timeout"]) != 0:
                # The state machine would reject this; the 2PC holds
                # carry their own timeout, so reject router-side with
                # the exact code the oracle returns.
                rejects.append(
                    (i, int(CTR.timeout_reserved_for_pending_transfer))
                )
                continue
            xrows.append(_XRow(
                i, u128_get(row, "id"), dr, cr, u128_get(row, "amount"),
                int(row["ledger"]), int(row["code"]), dshard, cshard,
            ))
        return rows, fwd, broadcast, xrows, rejects

    def _fwd_bodies(self, rows, fwd: dict[int, list[int]],
                    broadcast: list[int]):
        """-> {shard: (body, index_map)} with broadcast rows appended
        to EVERY shard's sub-batch, original order preserved."""
        out = {}
        shards = set(fwd)
        if broadcast:
            shards.update(range(self.n_shards))
        for shard in sorted(shards):
            indices = sorted(set(fwd.get(shard, [])) | set(broadcast))
            out[shard] = (rows[indices].tobytes(), indices)
        return out

    # ------------------------------------------------------------------
    # Settlement-account provisioning.

    def _ensure_subops(self, needed: set[tuple[int, int]]):
        """Two coordinator stages creating settlement + registry
        accounts and the durable ledger-registry marker for every
        (shard, ledger) not yet ensured this incarnation."""
        todo = sorted(needed - self._ensured)
        if not todo:
            return
        by_shard: dict[int, list[int]] = {}
        for shard, ledger in todo:
            by_shard.setdefault(shard, []).append(ledger)
        accounts = {}
        for shard, ledgers in sorted(by_shard.items()):
            rows = [
                _account_row(types.COORD_REGISTRY_ACCOUNT,
                             ledger=types.COORD_REGISTRY_LEDGER),
                _account_row(types.COORD_REGISTRY_FUNDING,
                             ledger=types.COORD_REGISTRY_LEDGER),
            ]
            for ledger in ledgers:
                rows.append(_account_row(coord_account_id(ledger),
                                         ledger=ledger))
            accounts[shard] = SubOp(
                shard, "coord", Operation.create_accounts,
                np.stack(rows).tobytes(),
            )
        yield list(accounts.values())
        # A shard that rejected any provisioning row (e.g. account
        # table at capacity) must NOT be marked ensured — the next
        # request retries, and the failure is counted, not sticky.
        ok_shards = set()
        for shard, sub in accounts.items():
            codes = result_codes(2 + len(by_shard[shard]), sub.reply)
            if all(c in _OKISH for c in codes):
                ok_shards.add(shard)
            else:
                self._c_conflicts.inc()
                if self.flight is not None:
                    self.flight.note("ensure_failed", shard=shard,
                                     codes=[c for c in codes if c])
        markers = {}
        for shard, ledgers in sorted(by_shard.items()):
            if shard not in ok_shards:
                continue
            rows = [
                _transfer_row(
                    ledger_marker_id(ledger),
                    debit=types.COORD_REGISTRY_FUNDING,
                    credit=types.COORD_REGISTRY_ACCOUNT,
                    amount=ledger, ledger=types.COORD_REGISTRY_LEDGER,
                    code=1,
                )
                for ledger in ledgers
            ]
            markers[shard] = SubOp(
                shard, "coord", Operation.create_transfers,
                np.stack(rows).tobytes(),
            )
        yield list(markers.values())
        for shard, sub in markers.items():
            codes = result_codes(len(by_shard[shard]), sub.reply)
            if all(c in _OKISH for c in codes):
                self._ensured.update(
                    (shard, lg) for lg in by_shard[shard]
                )
            else:
                self._c_conflicts.inc()
                if self.flight is not None:
                    self.flight.note("ensure_failed", shard=shard,
                                     codes=[c for c in codes if c])

    # ------------------------------------------------------------------
    # Client requests.

    def open_request(self, client: int, request: int, operation,
                     body: bytes,
                     trace: tuple[int, int, int] = (0, 0, 0)) -> _Task:
        self._c_requests.inc()
        op = Operation(int(operation))
        if op == Operation.create_transfers:
            gen = self._run_create_transfers(client, request, body, trace)
        elif op == Operation.create_accounts:
            gen = self._run_create_accounts(client, request, body, trace)
        elif op == Operation.lookup_accounts:
            gen = self._run_lookup_accounts(client, request, body, trace)
        elif op == Operation.lookup_transfers:
            gen = self._run_lookup_transfers(client, request, body, trace)
        elif op in (Operation.get_account_transfers,
                    Operation.get_account_balances):
            gen = self._run_single_shard_query(client, request, op, body,
                                               trace)
        else:
            gen = self._run_noop()
        return _Task(gen)

    def _run_noop(self):
        return b""
        yield  # pragma: no cover

    def _run_create_accounts(self, client, request, body, trace):
        rows = np.frombuffer(body, dtype=ACCOUNT_DTYPE)
        fwd: dict[int, list[int]] = {}
        rejects: list[tuple[int, int]] = []
        for group in self._chain_groups(rows["flags"]):
            shards = {
                shard_of_account(u128_get(rows[i], "id"), self.n_shards)
                for i in group
            }
            if len(shards) > 1:
                # A linked account chain spanning shards cannot be
                # atomic across consensus groups; fail the whole chain
                # closed rather than place accounts off their shard.
                rejects.extend(
                    (i, int(CAR.linked_event_failed)) for i in group
                )
                continue
            fwd.setdefault(shards.pop(), []).extend(group)
        bodies = self._fwd_bodies(rows, fwd, [])
        subops = {
            shard: SubOp(shard, "fwd", Operation.create_accounts, b,
                         client=client, request=request, trace=trace)
            for shard, (b, _imap) in bodies.items()
        }
        yield list(subops.values())
        pairs = list(rejects)
        for shard, sub in subops.items():
            _body, imap = bodies[shard]
            for sub_idx, code in enumerate(result_codes(len(imap),
                                                        sub.reply)):
                if code:
                    pairs.append((imap[sub_idx], code))
        return pack_results(pairs)

    def _run_create_transfers(self, client, request, body, trace):
        rows, fwd, broadcast, xrows, rejects = (
            self._plan_create_transfers(body)
        )
        self._c_local.inc(sum(len(v) for v in fwd.values()))
        self._c_cross.inc(len(xrows))
        self._active_tids.update(x.tid for x in xrows)
        try:
            reply = yield from self._drive_create_transfers(
                client, request, rows, fwd, broadcast, xrows, rejects,
                trace,
            )
        finally:
            self._active_tids.difference_update(x.tid for x in xrows)
        return reply

    def _drive_create_transfers(self, client, request, rows, fwd,
                                broadcast, xrows, rejects, trace):
        needed = set()
        for x in xrows:
            needed.add((x.dshard, x.ledger))
            needed.add((x.cshard, x.ledger))
        yield from self._ensure_subops(needed)

        # Stage 1: impersonated forwards + both holds, in parallel.
        bodies = self._fwd_bodies(rows, fwd, broadcast)
        fwd_subs = {
            shard: SubOp(shard, "fwd", Operation.create_transfers, b,
                         client=client, request=request, trace=trace)
            for shard, (b, _imap) in bodies.items()
        }
        hold_batches: dict[int, list[tuple[_XRow, str]]] = {}
        for x in xrows:
            hold_batches.setdefault(x.dshard, []).append((x, "debit"))
            hold_batches.setdefault(x.cshard, []).append((x, "credit"))
        hold_subs: dict[int, tuple[SubOp, list[tuple[_XRow, str]]]] = {}
        for shard, legs in sorted(hold_batches.items()):
            hrows = []
            for x, leg in legs:
                if leg == "debit":
                    hrows.append(_transfer_row(
                        x.ids.hold_debit, debit=x.dr,
                        credit=coord_account_id(x.ledger),
                        amount=x.amount, ledger=x.ledger, code=x.code,
                        flags=int(TransferFlags.pending),
                        timeout=self.coord_timeout_s,
                        user_data_128=x.tid,
                        user_data_64=xleg_tag(types.XLEG_DEBIT, x.cshard),
                    ))
                else:
                    hrows.append(_transfer_row(
                        x.ids.hold_credit,
                        debit=coord_account_id(x.ledger), credit=x.cr,
                        amount=x.amount, ledger=x.ledger, code=x.code,
                        flags=int(TransferFlags.pending),
                        timeout=self.coord_timeout_s,
                        user_data_128=x.tid,
                        user_data_64=xleg_tag(types.XLEG_CREDIT, x.dshard),
                    ))
            sub = SubOp(shard, "coord", Operation.create_transfers,
                        np.stack(hrows).tobytes(), trace=trace)
            hold_subs[shard] = (sub, legs)
        if xrows:
            self._c_roundtrips.inc()
            if self.flight is not None:
                for x in xrows:
                    self.flight.note(
                        "x2pc_holds", tid=x.tid, trace_id=trace[0],
                        dshard=x.dshard, cshard=x.cshard,
                    )
        yield list(fwd_subs.values()) + [s for s, _ in hold_subs.values()]

        # Stage 2: decide per xrow — post the debit hold (the durable
        # commit decision) or void the surviving hold(s).
        hold_code: dict[tuple[int, str], int] = {}
        for shard, (sub, legs) in hold_subs.items():
            for (x, leg), code in zip(legs,
                                      result_codes(len(legs), sub.reply)):
                hold_code[(x.index, leg)] = code
        p1: dict[int, list[tuple[_XRow, str]]] = {}
        for x in xrows:
            cd = hold_code[(x.index, "debit")]
            cc = hold_code[(x.index, "credit")]
            if cd in _OKISH and cc in _OKISH:
                x.commit = True
                p1.setdefault(x.dshard, []).append((x, "post_debit"))
            else:
                # Minimum nonzero non-exists code reproduces the
                # oracle's descending-precedence ordering.
                fails = [c for c in (cd, cc) if c not in _OKISH]
                x.client_code = min(fails)
                self._c_aborts.inc()
                if cd in _OKISH:
                    p1.setdefault(x.dshard, []).append((x, "void_debit"))
                if cc in _OKISH:
                    p1.setdefault(x.cshard, []).append((x, "void_credit"))
        p1_subs = self._resolution_subops(p1, trace)
        if p1_subs:
            self._c_roundtrips.inc()
            if self.flight is not None:
                for x in xrows:
                    self.flight.note(
                        "x2pc_decide", tid=x.tid, trace_id=trace[0],
                        commit=x.commit,
                    )
        yield [s for s, _ in p1_subs.values()]

        # Stage 3: read decisions; committed rows drive the credit-side
        # post, freshly-aborted ones clean up the credit hold, and a
        # decision found already-voided (a recovery probe beat us)
        # replays its recorded client code.
        p2: dict[int, list[tuple[_XRow, str]]] = {}
        code_lookups: dict[int, list[_XRow]] = {}
        for shard, (sub, legs) in p1_subs.items():
            for (x, role), code in zip(legs,
                                       result_codes(len(legs), sub.reply)):
                if role == "post_debit":
                    if code in _OKISH:
                        p2.setdefault(x.cshard, []).append(
                            (x, "post_credit")
                        )
                    elif code == int(CTR.pending_transfer_already_posted):
                        self._c_conflicts.inc()
                        p2.setdefault(x.cshard, []).append(
                            (x, "post_credit")
                        )
                    elif code == int(CTR.pending_transfer_already_voided):
                        # Aborted by a concurrent/recovered coordinator:
                        # fetch the recorded client code off the void
                        # record.
                        x.commit = False
                        code_lookups.setdefault(x.dshard, []).append(x)
                        p2.setdefault(x.cshard, []).append(
                            (x, "void_credit")
                        )
                    else:
                        # Expired (or failed) before the decision: a
                        # clean abort.
                        x.commit = False
                        x.client_code = int(CTR.pending_transfer_expired)
                        self._c_aborts.inc()
                        p2.setdefault(x.cshard, []).append(
                            (x, "void_credit")
                        )
                elif code == int(CTR.pending_transfer_already_posted):
                    # Tried to void a hold that is posted: the durable
                    # decision says commit — follow it.
                    self._c_conflicts.inc()
                    if role == "void_debit":
                        x.commit = True
                        x.client_code = 0
                        p2.setdefault(x.cshard, []).append(
                            (x, "post_credit")
                        )
        lookup_subs = {
            shard: (SubOp(shard, "coord", Operation.lookup_transfers,
                          _ids_body([x.ids.void_debit for x in xs]),
                          trace=trace), xs)
            for shard, xs in sorted(code_lookups.items())
        }
        p2_subs = self._resolution_subops(p2, trace)
        if p2_subs:
            self._c_roundtrips.inc()
            if self.flight is not None:
                for shard, (_sub, legs) in p2_subs.items():
                    for x, role in legs:
                        if role == "post_credit":
                            self.flight.note(
                                "x2pc_post_credit", tid=x.tid,
                                trace_id=trace[0], shard=shard,
                            )
        yield ([s for s, _ in p2_subs.values()]
               + [s for s, _ in lookup_subs.values()])

        # Stage 4: credit-side outcomes; a posted decision whose credit
        # hold expired anyway (timeout budget violated) is compensated
        # — money returns to the debitor, flagged loudly, never parked.
        comp: dict[int, list[_XRow]] = {}
        for shard, (sub, xs) in lookup_subs.items():
            found = {}
            for row in np.frombuffer(sub.reply, dtype=TRANSFER_DTYPE):
                found[u128_get(row, "id")] = int(row["user_data_64"])
            for x in xs:
                x.client_code = found.get(
                    x.ids.void_debit, int(CTR.pending_transfer_expired)
                ) or int(CTR.pending_transfer_expired)
        for shard, (sub, legs) in p2_subs.items():
            for (x, role), code in zip(legs,
                                       result_codes(len(legs), sub.reply)):
                if role != "post_credit":
                    continue
                if code in _OKISH:
                    self._c_commits.inc()
                else:
                    # The decided commit cannot complete on the credit
                    # side (hold expired past the timeout budget, or —
                    # a flagged protocol conflict — voided by another
                    # actor): compensate, returning the posted money
                    # to the debitor.  Never silently parked.
                    if code != int(CTR.pending_transfer_expired):
                        self._c_conflicts.inc()
                    self._c_compensations.inc()
                    x.commit = False
                    x.client_code = int(CTR.pending_transfer_expired)
                    comp.setdefault(x.dshard, []).append(x)
        comp_subs = []
        for shard, xs in sorted(comp.items()):
            rows_c = [
                _transfer_row(
                    x.ids.comp, debit=coord_account_id(x.ledger),
                    credit=x.dr, amount=x.amount, ledger=x.ledger,
                    code=x.code or 1, user_data_128=x.tid,
                )
                for x in xs
            ]
            comp_subs.append(SubOp(shard, "coord",
                                   Operation.create_transfers,
                                   np.stack(rows_c).tobytes(),
                                   trace=trace))
        yield comp_subs

        pairs = list(rejects)
        pairs.extend((x.index, x.client_code) for x in xrows)
        for shard, sub in fwd_subs.items():
            _body, imap = bodies[shard]
            codes = result_codes(len(imap), sub.reply)
            for sub_idx, orig in enumerate(imap):
                if orig in broadcast:
                    continue  # merged below
                if codes[sub_idx]:
                    pairs.append((orig, codes[sub_idx]))
        not_found = int(CTR.pending_transfer_not_found)
        for orig in broadcast:
            verdicts = []
            for shard, sub in fwd_subs.items():
                _body, imap = bodies[shard]
                verdicts.append(result_codes(len(imap), sub.reply)[
                    imap.index(orig)
                ])
            if 0 in verdicts:
                continue  # some shard applied it
            real = [c for c in verdicts if c != not_found]
            pairs.append((orig, min(real) if real else not_found))
        return pack_results(pairs)

    def _resolution_subops(self, batches: dict[int, list[tuple[_XRow, str]]],
                           trace):
        """post/void batches per shard -> {shard: (SubOp, legs)}."""
        out = {}
        for shard, legs in sorted(batches.items()):
            rows = []
            for x, role in legs:
                if role == "post_debit":
                    rows.append(_transfer_row(
                        x.ids.post_debit, pending_id=x.ids.hold_debit,
                        flags=int(TransferFlags.post_pending_transfer),
                    ))
                elif role == "post_credit":
                    rows.append(_transfer_row(
                        x.ids.post_credit, pending_id=x.ids.hold_credit,
                        flags=int(TransferFlags.post_pending_transfer),
                    ))
                elif role == "void_debit":
                    rows.append(_transfer_row(
                        x.ids.void_debit, pending_id=x.ids.hold_debit,
                        flags=int(TransferFlags.void_pending_transfer),
                        user_data_64=x.client_code
                        or int(CTR.pending_transfer_expired),
                    ))
                else:
                    rows.append(_transfer_row(
                        x.ids.void_credit, pending_id=x.ids.hold_credit,
                        flags=int(TransferFlags.void_pending_transfer),
                        user_data_64=x.client_code
                        or int(CTR.pending_transfer_expired),
                    ))
            out[shard] = (
                SubOp(shard, "coord", Operation.create_transfers,
                      np.stack(rows).tobytes(), trace=trace),
                legs,
            )
        return out

    def _run_lookup_accounts(self, client, request, body, trace):
        arr = np.frombuffer(body, dtype=U128_PAIR_DTYPE)
        ids = [int(r["lo"]) | (int(r["hi"]) << 64) for r in arr]
        by_shard: dict[int, list[int]] = {}
        for v in ids:
            by_shard.setdefault(shard_of_account(v, self.n_shards),
                                []).append(v)
        subs = {
            shard: SubOp(shard, "fwd", Operation.lookup_accounts,
                         _ids_body(vs), client=client, request=request,
                         trace=trace)
            for shard, vs in sorted(by_shard.items())
        }
        yield list(subs.values())
        found: dict[int, bytes] = {}
        for sub in subs.values():
            for row in np.frombuffer(sub.reply, dtype=ACCOUNT_DTYPE):
                found[u128_get(row, "id")] = row.tobytes()
        return b"".join(found[v] for v in ids if v in found)

    # Chunk bound for derived-id chases on the coordinator session —
    # conservative against small-config shards' batch caps.
    _LOOKUP_CHUNK = 200

    def _run_lookup_transfers(self, client, request, body, trace):
        arr = np.frombuffer(body, dtype=U128_PAIR_DTYPE)
        ids = [int(r["lo"]) | (int(r["hi"]) << 64) for r in arr]
        # Stage 1 — broadcast the client's own ids on the client's
        # session: a transfer row lives on whichever shard executed it.
        subs = [
            SubOp(shard, "fwd", Operation.lookup_transfers, body,
                  client=client, request=request, trace=trace)
            for shard in range(self.n_shards)
        ]
        yield subs
        found: dict[int, np.void] = {}
        for sub in subs:
            for row in np.frombuffer(sub.reply, dtype=TRANSFER_DTYPE):
                found.setdefault(u128_get(row, "id"), row)
        # Stage 2 — ids with no direct row anywhere may be cross-shard
        # transfers (no row under the client id exists at all): chase
        # their 2PC legs on the coordinator session, chunked so the
        # 3x-derived expansion never exceeds a shard's batch cap.
        missing = [v for v in dict.fromkeys(ids) if v not in found]
        derived = {v: XShardIds(v) for v in missing}
        chase: list[SubOp] = []
        for i in range(0, len(missing), self._LOOKUP_CHUNK):
            chunk = missing[i:i + self._LOOKUP_CHUNK]
            query: list[int] = []
            for v in chunk:
                x = derived[v]
                query.extend((x.hold_debit, x.hold_credit, x.post_debit))
            for shard in range(self.n_shards):
                chase.append(SubOp(shard, "coord",
                                   Operation.lookup_transfers,
                                   _ids_body(query), trace=trace))
        yield chase
        for sub in chase:
            for row in np.frombuffer(sub.reply, dtype=TRANSFER_DTYPE):
                found.setdefault(u128_get(row, "id"), row)
        out = []
        for v in ids:
            if v in found:
                out.append(found[v].tobytes())
                continue
            x = derived.get(v)
            if x is None:
                continue
            if x.hold_debit in found and x.post_debit in found and (
                x.hold_credit in found
            ):
                hd, hc = found[x.hold_debit], found[x.hold_credit]
                pd = found[x.post_debit]
                row = _transfer_row(
                    v, debit=u128_get(hd, "debit_account_id"),
                    credit=u128_get(hc, "credit_account_id"),
                    amount=u128_get(pd, "amount"),
                    ledger=int(hd["ledger"]), code=int(hd["code"]),
                )
                row["timestamp"] = pd["timestamp"]
                out.append(row.tobytes())
        return b"".join(out)

    def _run_single_shard_query(self, client, request, op, body, trace):
        row = np.frombuffer(body, dtype=ACCOUNT_FILTER_DTYPE)[0]
        shard = shard_of_account(u128_get(row, "account_id"),
                                 self.n_shards)
        sub = SubOp(shard, "fwd", op, body, client=client,
                    request=request, trace=trace)
        yield [sub]
        return sub.reply

    # ------------------------------------------------------------------
    # Proof of state: fold per-shard roots into ONE deterministic
    # cluster commitment (commitment.fold_cluster).  Runs as a normal
    # task — the `state_root` client query and the recovery audit both
    # ride it.

    def _root_subops(self) -> list[SubOp]:
        from tigerbeetle_tpu_torch.vsr.wire import VsrOperation

        return [
            SubOp(shard, "root", VsrOperation.state_root, b"")
            for shard in range(self.n_shards)
        ]

    def _fold_roots(self, subs: list[SubOp]) -> bytes:
        from tigerbeetle_tpu_torch.state_machine import commitment

        roots = []
        for sub in subs:
            root, _commit_min = commitment.parse_root_body(sub.reply)
            roots.append(root)
        return commitment.fold_cluster(roots)

    def state_root(self) -> _Task:
        """Cluster-wide proof of state: query every shard's root,
        fold deterministically, reply with root_body(folded,
        n_shards)."""
        return _Task(self._run_state_root())

    def _run_state_root(self):
        from tigerbeetle_tpu_torch.state_machine import commitment

        subs = self._root_subops()
        yield subs
        return commitment.root_body(self._fold_roots(subs), self.n_shards)

    # ------------------------------------------------------------------
    # Crash recovery.

    def recover(self) -> _Task:
        """In-doubt recovery for a restarted coordinator: rediscover
        every cross-shard transfer through the shards' own logs and
        re-drive each to a terminal state (post or void), idempotently.
        Returns a _Task; `.result` is {"indoubt": n, "scanned": n}."""
        return _Task(self._run_recovery())

    def _scan_account(self, shard: int, account: int):
        """Generator stage helper: paginated get_account_transfers of
        one account; yields SubOp stages, accumulates rows into the
        returned list."""
        rows: list[np.void] = []
        timestamp_min = 0
        while True:
            sub = SubOp(shard, "coord", Operation.get_account_transfers,
                        _filter_body(account, timestamp_min=timestamp_min))
            yield [sub]
            page = np.frombuffer(sub.reply, dtype=TRANSFER_DTYPE)
            if len(page) == 0:
                return rows
            rows.extend(page)
            timestamp_min = int(page[-1]["timestamp"]) + 1

    def _run_recovery(self):
        # Stage R1: enumerate ledgers per shard via the registry trail.
        ledgers: dict[int, set[int]] = {}
        for shard in range(self.n_shards):
            rows = yield from self._scan_account(
                shard, types.COORD_REGISTRY_ACCOUNT
            )
            ledgers[shard] = {
                int(u128_get(r, "amount")) for r in rows
                if int(r["ledger"]) == types.COORD_REGISTRY_LEDGER
            }
            self._ensured.update((shard, lg) for lg in ledgers[shard])
        # Stage R2: scan every settlement account; every 2PC row
        # touches one, so this re-surfaces all transfers ever started.
        evidence: dict[int, dict[str, np.void]] = {}
        amounts: dict[int, int] = {}
        meta: dict[int, dict] = {}
        for shard in sorted(ledgers):
            for ledger in sorted(ledgers[shard]):
                rows = yield from self._scan_account(
                    shard, coord_account_id(ledger)
                )
                for row in rows:
                    tid = u128_get(row, "user_data_128")
                    if tid == 0:
                        continue
                    ids = XShardIds(tid)
                    rid = u128_get(row, "id")
                    role = next(
                        (r for r in XShardIds._ROLES
                         if getattr(ids, r) == rid), None,
                    )
                    if role is None:
                        continue
                    ev = evidence.setdefault(tid, {})
                    ev[role] = row
                    m = meta.setdefault(tid, {"ledger": ledger})
                    if role == "hold_debit":
                        m["dshard"] = shard
                        _leg, m["cshard"] = xleg_untag(
                            int(row["user_data_64"])
                        )
                        amounts[tid] = u128_get(row, "amount")
                    elif role == "hold_credit":
                        m["cshard"] = shard
                        _leg, m["dshard"] = xleg_untag(
                            int(row["user_data_64"])
                        )
                        amounts.setdefault(tid, u128_get(row, "amount"))
        # Stage R3: classify and re-drive.
        probes: dict[int, list[tuple[int, XShardIds]]] = {}
        finish: dict[int, list[tuple[int, XShardIds, str, int]]] = {}
        indoubt = 0
        for tid in sorted(evidence):
            if tid in self._active_tids:
                # A live open request of THIS incarnation owns the
                # decision (a client retransmit racing recovery);
                # probing would abort a transfer it is re-driving.
                continue
            ev = evidence[tid]
            m = meta[tid]
            ids = XShardIds(tid)
            dshard, cshard = m.get("dshard"), m.get("cshard")
            if "comp" in ev:
                continue  # terminally compensated
            if "post_debit" in ev:
                if "post_credit" not in ev and cshard is not None:
                    indoubt += 1
                    finish.setdefault(cshard, []).append(
                        (tid, ids, "post_credit", 0)
                    )
                continue
            if "void_debit" in ev:
                # Abort decided: re-void the credit hold
                # unconditionally (a not_found answer for a hold that
                # never landed is harmless; gating on scan evidence
                # would miss a hold the scan raced).
                if "void_credit" not in ev and cshard is not None:
                    indoubt += 1
                    finish.setdefault(cshard, []).append(
                        (tid, ids, "void_credit",
                         int(ev["void_debit"]["user_data_64"]))
                    )
                continue
            if dshard is not None:
                # Undecided (debit hold pending, or only the credit
                # hold surfaced — the scan may have raced the debit
                # hold's commit): the DECISION must still be made on
                # the debit side.  Probe-void the debit hold: the void
                # itself IS the abort decision if it lands (and
                # answers not_found if the hold never existed); if the
                # hold turns out posted, the decision was commit.
                # Deciding the credit side unilaterally here once
                # half-posted a transfer whose debit hold the scan
                # missed (sharded-VOPR seed 4242).
                indoubt += 1
                probes.setdefault(dshard, []).append((tid, ids))
        probe_subs = {}
        for shard, items in sorted(probes.items()):
            rows_p = [
                _transfer_row(
                    ids.void_debit, pending_id=ids.hold_debit,
                    flags=int(TransferFlags.void_pending_transfer),
                    user_data_64=int(CTR.pending_transfer_expired),
                )
                for _tid, ids in items
            ]
            probe_subs[shard] = (
                SubOp(shard, "coord", Operation.create_transfers,
                      np.stack(rows_p).tobytes()),
                items,
            )
        yield [s for s, _ in probe_subs.values()]
        for shard, (sub, items) in probe_subs.items():
            codes = result_codes(len(items), sub.reply)
            for (tid, ids), code in zip(items, codes):
                m = meta[tid]
                cshard = m.get("cshard")
                if cshard is None:
                    continue
                if code == int(CTR.pending_transfer_already_posted):
                    finish.setdefault(cshard, []).append(
                        (tid, ids, "post_credit", 0)
                    )
                else:
                    # Abort decided (void landed / hold expired /
                    # hold never existed): void the credit hold
                    # unconditionally.
                    finish.setdefault(cshard, []).append(
                        (tid, ids, "void_credit",
                         int(CTR.pending_transfer_expired))
                    )
        finish_subs = {}
        for shard, items in sorted(finish.items()):
            rows_f = []
            for _tid, ids, role, code in items:
                if role == "post_credit":
                    rows_f.append(_transfer_row(
                        ids.post_credit, pending_id=ids.hold_credit,
                        flags=int(TransferFlags.post_pending_transfer),
                    ))
                else:
                    rows_f.append(_transfer_row(
                        ids.void_credit, pending_id=ids.hold_credit,
                        flags=int(TransferFlags.void_pending_transfer),
                        user_data_64=code
                        or int(CTR.pending_transfer_expired),
                    ))
            finish_subs[shard] = (
                SubOp(shard, "coord", Operation.create_transfers,
                      np.stack(rows_f).tobytes()),
                items,
            )
        yield [s for s, _ in finish_subs.values()]
        # Stage R4: a re-driven credit post that finds its hold expired
        # (timeout budget violated while the coordinator was down) is
        # compensated so the decided money is never parked.
        comp: dict[int, list[tuple[int, XShardIds]]] = {}
        for shard, (sub, items) in finish_subs.items():
            codes = result_codes(len(items), sub.reply)
            for (tid, ids, role, _code), code in zip(items, codes):
                if role != "post_credit":
                    continue
                if code not in _OKISH:
                    # Decided commit that cannot complete on the
                    # credit side: compensate (see the open-request
                    # path for rationale).
                    if code != int(CTR.pending_transfer_expired):
                        self._c_conflicts.inc()
                    self._c_compensations.inc()
                    m = meta[tid]
                    comp.setdefault(m["dshard"], []).append((tid, ids))
        # The compensation row needs the debit hold's fields; fetch any
        # the scan raced past (the hold exists — its post succeeded).
        fetch = {
            shard: [tid for tid, _ids in items
                    if "hold_debit" not in evidence[tid]]
            for shard, items in comp.items()
        }
        fetch_subs = {
            shard: SubOp(shard, "coord", Operation.lookup_transfers,
                         _ids_body([XShardIds(t).hold_debit for t in tids]))
            for shard, tids in fetch.items() if tids
        }
        yield list(fetch_subs.values())
        for shard, sub in fetch_subs.items():
            for row in np.frombuffer(sub.reply, dtype=TRANSFER_DTYPE):
                tid = u128_get(row, "user_data_128")
                if tid:
                    evidence.setdefault(tid, {})["hold_debit"] = row
                    amounts.setdefault(tid, u128_get(row, "amount"))
        comp_subs = []
        for shard, items in sorted(comp.items()):
            rows_c = []
            for tid, ids in items:
                m = meta[tid]
                hd = evidence[tid].get("hold_debit")
                if hd is None:
                    self._c_conflicts.inc()
                    continue  # next recovery run retries
                rows_c.append(_transfer_row(
                    ids.comp, debit=coord_account_id(m["ledger"]),
                    credit=u128_get(hd, "debit_account_id"),
                    amount=amounts[tid], ledger=m["ledger"],
                    code=int(hd["code"]) or 1, user_data_128=tid,
                ))
            if rows_c:
                comp_subs.append(SubOp(shard, "coord",
                                       Operation.create_transfers,
                                       np.stack(rows_c).tobytes()))
        yield comp_subs
        self._c_recovered.inc(indoubt)
        # Post-recovery audit point: fetch every shard's state root
        # through the proof-of-state query and record the folded
        # cluster commitment with the recovery result (flight note
        # "router_recovered" carries it into the postmortem ring).
        root_subs = self._root_subops()
        yield root_subs
        cluster_root = self._fold_roots(root_subs)
        return {
            "indoubt": indoubt,
            "scanned": len(evidence),
            "cluster_root": cluster_root.hex(),
        }


# ----------------------------------------------------------------------
# TCP transport: the router as a wire-protocol front-end process.


class RouterServer:
    """Client-facing TCP router over N shard clusters.

    Clients speak the normal wire protocol to the router exactly as
    they would to a replica; the router forwards/filters per the
    RouterCore plan over per-shard native-bus connections.  Volatile by
    design: `recover=True` (the default when restarting over existing
    shards) runs the in-doubt recovery scan before serving.
    """

    RETRY_NS_DEFAULT = 1_000_000_000

    def __init__(self, listen_address: str, shard_addresses: list[str],
                 *, cluster: int = 0, recover: bool = True,
                 message_size_max: int = 1 << 20,
                 incarnation: int | None = None,
                 follower_addresses: list[str] | None = None) -> None:
        from tigerbeetle_tpu_torch.obs.flight import FlightRecorder
        from tigerbeetle_tpu_torch.runtime.native import (
            EV_CLOSED, EV_MESSAGE, NativeBus,
        )
        from tigerbeetle_tpu_torch.runtime.server import parse_address
        from tigerbeetle_tpu_torch.vsr import wire

        self._wire = wire
        self._ev_message = EV_MESSAGE
        self._ev_closed = EV_CLOSED
        self.cluster = cluster
        # Shard address lists: each entry is a comma-joined replica
        # address list for one shard.
        self.shard_addrs = [
            [parse_address(a) for a in entry.split(",")]
            for entry in shard_addresses
        ]
        self.n_shards = len(self.shard_addrs)
        from tigerbeetle_tpu_torch import obs

        self.registry = obs.Registry()
        self.core = RouterCore(self.n_shards, registry=self.registry)
        self.flight = FlightRecorder(
            process_id=0,
            dump_path=envcheck.env_str(
                "TB_FLIGHT_PATH", "tb_flight_router.json"
            ),
        )
        self.core.flight = self.flight
        self.admit_queue = envcheck.router_queue()
        # Multi-tenant QoS: the router keys its own
        # admission (open-request slots) and its retry sweep's drain
        # order by tenant (ledger), mirroring the replica-side
        # contract — one hot tenant cannot pin every open slot or
        # starve other tenants' retries.  TB_TENANT_QOS=0 pins the
        # legacy single-bound path.
        self.qos = None
        if envcheck.tenant_qos():
            from tigerbeetle_tpu_torch.qos import TenantQos

            self.qos = TenantQos(
                rate=envcheck.tenant_rate(),
                rate_bytes=envcheck.tenant_rate_bytes(),
                queue_bound=envcheck.tenant_queue(self.admit_queue),
                weights=envcheck.tenant_weights(),
                registry=self.registry.scope("router.qos"),
            )
        self.retry_ns = envcheck.coord_retry_ms() * 1_000_000
        self._c_shed = self.registry.counter("router.shed")
        self._c_retries = self.registry.counter("router.retries")
        self._c_shard_busy = self.registry.counter("router.shard_busy")
        # Read steering: reads go to root-attested
        # followers under TB_READ_POLICY, falling back to the primary
        # path on refusal / timeout / death — a dead follower can slow
        # one read by TB_READ_FALLBACK_MS, never fail it.  Entries are
        # "shard:host:port" (or "host:port" = shard 0); a follower
        # tails ONE shard's AOF and serves only reads that resolve to
        # that shard (lookup_transfers additionally needs n_shards==1:
        # the sharded path merges 2PC legs across shards into
        # client-view rows, which a single shard's follower cannot).
        self.followers: list[dict] = []
        for fid, entry in enumerate(follower_addresses or []):
            shard_s, sep, addr = entry.partition(":")
            if sep and ":" in addr and shard_s.isdigit():
                shard = int(shard_s)
            else:
                shard, addr = 0, entry
            assert 0 <= shard < self.n_shards, entry
            self.followers.append({
                "id": fid, "shard": shard,
                "addr": parse_address(addr), "conn": None,
                "streak": 0, "not_before": 0,
            })
        self.read_policy = envcheck.read_policy()
        if self.read_policy == "auto":
            self.read_policy = (
                "follower" if self.followers else "primary"
            )
        self.read_fallback_ns = envcheck.read_fallback_ms() * 1_000_000
        self._conn_follower: dict[int, int] = {}  # conn -> follower idx
        # (client, request) of reads currently riding a follower.
        self._frd: dict[tuple[int, int], dict] = {}
        self._c_frd = self.registry.counter("router.follower_reads")
        self._c_frd_redirects = self.registry.counter(
            "router.follower_redirects"
        )
        self._c_frd_timeouts = self.registry.counter(
            "router.follower_timeouts"
        )
        self.registry.gauge_fn("router.open_requests",
                               lambda: len(self._open))
        self.registry.gauge_fn("router.admit_queue",
                               lambda: self.admit_queue)
        self.bus = NativeBus(message_size_max)
        host, port = parse_address(listen_address)
        self.port = self.bus.listen(host, port)
        # Coordinator identity: STABLE across incarnations (see
        # COORD_CLIENT_ID); request numbering resumes above the
        # session's last committed request via the register reply's
        # resume hint.  `incarnation` only labels flight dumps.
        self.coord_client = COORD_CLIENT_ID
        self.incarnation = incarnation if incarnation is not None else 0
        # Shard connection state.
        self._shard_conn: dict[int, int | None] = {
            s: None for s in range(self.n_shards)
        }
        self._shard_target: dict[int, int] = {
            s: 0 for s in range(self.n_shards)
        }
        self._conn_shard: dict[int, int] = {}
        self._client_conns: dict[int, int] = {}
        # Wire bookkeeping.
        self._coord_request = 0
        # Sessionless "root" subop numbering: client=0 frames, so the
        # request field alone correlates replies.  Starts high to stay
        # clear of register's request=0.
        self._root_request = 0x5A00_0000
        self._pending: dict[tuple[int, int, int], SubOp] = {}
        self._sent_at: dict[int, tuple] = {}  # id(subop) -> state
        self._registered: dict[int, set[int]] = {}  # client -> shards
        self._register_waiters: dict[tuple[int, int], list[SubOp]] = {}
        self._register_pending: dict[tuple[int, int], np.ndarray] = {}
        self._register_sent: dict[tuple[int, int], int] = {}
        self._client_register: dict[int, np.ndarray] = {}
        self._open: dict[tuple[int, int], dict] = {}
        # tenant -> open-request count, maintained incrementally at
        # every _open insert/remove: admission (and the busy payload)
        # reads a tenant's slot usage per incoming request, and a
        # full-table scan there would put O(TB_ROUTER_QUEUE) work on
        # the router's per-request hot path (same reasoning as
        # VsrReplica._tenant_depth).
        self._tenant_open: dict[int, int] = {}
        self._tasks: list[tuple[_Task, dict | None]] = []
        self._recovery: _Task | None = None
        if recover:
            self._recovery = self.core.recover()
            self._issue_subops(self._recovery.subops)
            self._tasks.append((self._recovery, None))

    # -- shard connections ---------------------------------------------

    def _connect_shard(self, shard: int) -> int | None:
        conn = self._shard_conn[shard]
        if conn is not None:
            return conn
        addrs = self.shard_addrs[shard]
        for _ in range(len(addrs)):
            host, port = addrs[self._shard_target[shard] % len(addrs)]
            try:
                conn = self.bus.connect(host, port)
            except OSError:
                self._shard_target[shard] += 1
                continue
            self._shard_conn[shard] = conn
            self._conn_shard[conn] = shard
            return conn
        return None

    def _drop_shard_conn(self, conn: int) -> None:
        shard = self._conn_shard.pop(conn, None)
        if shard is not None and self._shard_conn.get(shard) == conn:
            self._shard_conn[shard] = None
            self._shard_target[shard] += 1  # rotate replica on reconnect

    # -- follower read steering ----------------------------------------

    # Int view of the one shared read-op definition (types.py).
    _READ_OPS = frozenset(int(op) for op in types.READ_OPERATIONS)

    def _read_shard(self, operation: int, body: bytes) -> int | None:
        """The single shard a read resolves to, or None when it is not
        follower-servable (multi-shard id set; lookup_transfers in a
        sharded deployment — see __init__)."""
        try:
            if operation in (int(Operation.get_account_transfers),
                             int(Operation.get_account_balances)):
                if len(body) != ACCOUNT_FILTER_DTYPE.itemsize:
                    return None
                row = np.frombuffer(body, ACCOUNT_FILTER_DTYPE)[0]
                return shard_of_account(
                    u128_get(row, "account_id"), self.n_shards
                )
            if operation == int(Operation.lookup_accounts):
                if len(body) % U128_PAIR_DTYPE.itemsize or not body:
                    return None
                rows = np.frombuffer(body, U128_PAIR_DTYPE)
                shards = {
                    shard_of_account(
                        int(r["lo"]) | (int(r["hi"]) << 64),
                        self.n_shards,
                    )
                    for r in rows
                }
                return shards.pop() if len(shards) == 1 else None
            if operation == int(Operation.lookup_transfers):
                return 0 if self.n_shards == 1 else None
        except (ValueError, KeyError):
            return None
        return None

    def _pick_follower(self, shard: int, now: int) -> dict | None:
        """A healthy follower for `shard`: not inside its failure
        backoff window (qos.backoff_delay per consecutive failure, so
        a dead follower costs one timeout per backoff window, not one
        per read)."""
        best = None
        for f in self.followers:
            if f["shard"] != shard or now < f["not_before"]:
                continue
            if best is None or f["streak"] < best["streak"]:
                best = f
        return best

    def _connect_follower(self, f: dict) -> int | None:
        if f["conn"] is not None:
            return f["conn"]
        try:
            conn = self.bus.connect(*f["addr"])
        except OSError:
            return None
        f["conn"] = conn
        self._conn_follower[conn] = f["id"]
        return conn

    def _follower_failed(self, f: dict, now: int) -> None:
        f["streak"] = min(f["streak"] + 1, 16)
        from tigerbeetle_tpu_torch import qos as qos_mod

        f["not_before"] = now + qos_mod.backoff_delay(
            f["id"] + 1, 0, f["streak"], self.read_fallback_ns
        )

    def _try_follower_read(self, ctx: dict, operation: int,
                           body: bytes, now: int) -> bool:
        """Steer one admitted read at a follower.  True = in flight
        (reply or fallback will finish it); False = use the primary
        path now."""
        if self.read_policy != "follower":
            return False
        shard = self._read_shard(operation, body)
        if shard is None:
            return False
        f = self._pick_follower(shard, now)
        if f is None:
            return False
        conn = self._connect_follower(f)
        if conn is None:
            self._follower_failed(f, now)
            return False
        wire = self._wire
        h = wire.make_header(
            command=wire.Command.request, operation=operation,
            cluster=self.cluster, client=ctx["client"],
            request=ctx["request"],
        )
        wire.copy_trace(h, ctx["header"])
        h["tenant"] = ctx["header"]["tenant"]
        wire.finalize_header(h, body)
        self.bus.send(conn, h.tobytes() + body)
        self._c_frd.inc()
        key = (ctx["client"], ctx["request"])
        self._frd[key] = {
            "ctx": ctx, "follower": f, "body": body,
            "operation": operation, "deadline": now + self.read_fallback_ns,
        }
        return True

    def _frd_fallback(self, key: tuple, *, timeout: bool) -> None:
        """Follower refused / timed out / died: re-drive the read
        through the primary path — reads never fail because a
        follower did."""
        state = self._frd.pop(key, None)
        if state is None:
            return
        # tbcheck: allow(determinism): RouterServer is the real-TCP
        # front-end; retry/observe cadence runs on wall time.  The
        # sim drives RouterCore, which takes injected ticks.
        now = time.monotonic_ns()
        self._follower_failed(state["follower"], now)
        (self._c_frd_timeouts if timeout
         else self._c_frd_redirects).inc()
        ctx = state["ctx"]
        self.flight.note(
            "follower_read_fallback", client=ctx["client"],
            request=ctx["request"], follower=state["follower"]["id"],
            timeout=int(timeout),
        )
        if self._open.get((ctx["client"], ctx["request"])) is not ctx:
            return  # request since completed/dropped elsewhere
        trace = (int(ctx["header"]["trace_id"]),
                 int(ctx["header"]["trace_ts"]),
                 int(ctx["header"]["trace_flags"]))
        task = self.core.open_request(
            ctx["client"], ctx["request"], state["operation"],
            state["body"], trace,
        )
        self._issue_subops(task.subops)
        self._tasks.append((task, ctx))

    def _on_follower_message(self, conn: int, header, body: bytes,
                             cmd: int) -> None:
        wire = self._wire
        f = self.followers[self._conn_follower[conn]]
        key = (wire.u128(header, "client"), int(header["request"]))
        state = self._frd.get(key)
        if state is None or state["follower"] is not f:
            return
        if cmd == int(wire.Command.reply):
            self._frd.pop(key)
            f["streak"] = 0
            ctx = state["ctx"]
            self._tenant_open_dec(self._open.pop(
                (ctx["client"], ctx["request"]), None
            ))
            if self.qos is not None and ctx.get("tenant") is not None:
                self.qos.on_reply(ctx["tenant"], ctx["header"])
            cconn = self._client_conns.get(ctx["client"])
            if cconn is None:
                return
            h = wire.make_header(
                command=wire.Command.reply, cluster=self.cluster,
                client=ctx["client"], request=ctx["request"],
                operation=int(ctx["operation"]),
                replica=int(header["replica"]),
            )
            wire.copy_trace(h, ctx["header"])
            # Relay the attestation untouched: the CLIENT verifies
            # (root, commit_min) against the cluster commitment — the
            # router must not launder an unattested reply into an
            # attested-looking one or vice versa.
            h["state_root_lo"] = header["state_root_lo"]
            h["state_root_hi"] = header["state_root_hi"]
            h["root_op"] = header["root_op"]
            wire.finalize_header(h, body)
            self.bus.send(cconn, h.tobytes() + body)
        elif cmd == int(wire.Command.client_busy):
            # Typed follower refusal (lagging / unattested / corrupt /
            # overload): redirect to the primary path.
            self._frd_fallback(key, timeout=False)

    # -- subop issue / retry -------------------------------------------

    def _issue_subops(self, subops: list[SubOp]) -> None:
        for sub in subops:
            self._send_subop(sub, first=True)

    def _send_subop(self, sub: SubOp, first: bool = False) -> None:
        wire = self._wire
        if sub.kind == "root":
            # Sessionless proof-of-state query: no registration, no
            # session — the shard's server loop answers it directly.
            self._root_request += 1
            request = self._root_request
            key = (sub.shard, 0, request)
            old_key = self._sent_at.get(id(sub))
            if old_key is not None:
                self._pending.pop(old_key[0], None)
            self._pending[key] = sub
            # tbcheck: allow(determinism): RouterServer is the real-TCP
            # front-end; retry/observe cadence runs on wall time.  The
            # sim drives RouterCore, which takes injected ticks.
            self._sent_at[id(sub)] = (key, time.monotonic_ns())
            h = wire.make_header(
                command=wire.Command.request,
                operation=wire.VsrOperation.state_root,
                cluster=self.cluster, client=0, request=request,
            )
            wire.finalize_header(h, b"")
            conn = self._connect_shard(sub.shard)
            if conn is not None:
                self.bus.send(conn, h.tobytes())
            if not first:
                self._c_retries.inc()
            return
        if sub.kind == "fwd":
            client, request = sub.client, sub.request
        else:
            client = self.coord_client
        # Sessions (the client's impersonated one AND the
        # coordinator's own) must exist shard-side before any request,
        # or the shard answers with an eviction.  Registering is
        # idempotent: an existing session just replays its register
        # reply.
        regset = self._registered.setdefault(client, set())
        if sub.shard not in regset:
            self._ensure_registered(client, sub.shard, sub)
            return
        if sub.kind != "fwd":
            self._coord_request += 1
            request = self._coord_request
        key = (sub.shard, client, request)
        old_key = self._sent_at.get(id(sub))
        if old_key is not None:
            self._pending.pop(old_key[0], None)
        self._pending[key] = sub
        # tbcheck: allow(determinism): RouterServer is the real-TCP
        # front-end; retry/observe cadence runs on wall time.  The
        # sim drives RouterCore, which takes injected ticks.
        self._sent_at[id(sub)] = (key, time.monotonic_ns())
        h = wire.make_header(
            command=wire.Command.request, operation=int(sub.operation),
            cluster=self.cluster, client=client, request=request,
            trace_id=sub.trace[0], trace_ts=sub.trace[1],
            trace_flags=sub.trace[2],
        )
        wire.finalize_header(h, sub.body)
        conn = self._connect_shard(sub.shard)
        if conn is not None:
            self.bus.send(conn, h.tobytes() + sub.body)
        if not first:
            self._c_retries.inc()
            self.flight.note("router_retry", shard=sub.shard,
                             request=request, kind=sub.kind)

    def _ensure_registered(self, client: int, shard: int,
                           waiter: SubOp | None) -> None:
        key = (client, shard)
        if waiter is not None:
            self._register_waiters.setdefault(key, []).append(waiter)
        if key in self._register_pending:
            return
        wire = self._wire
        h = wire.make_header(
            command=wire.Command.request,
            operation=wire.VsrOperation.register,
            cluster=self.cluster, client=client, request=0,
        )
        wire.finalize_header(h, b"")
        self._register_pending[key] = h
        self._pending[(shard, client, 0)] = SubOp(
            shard, "register", wire.VsrOperation.register, b"",
            client=client,
        )
        conn = self._connect_shard(shard)
        if conn is not None:
            # tbcheck: allow(determinism): RouterServer is the real-TCP
            # front-end; retry/observe cadence runs on wall time.  The
            # sim drives RouterCore, which takes injected ticks.
            self._register_sent[key] = time.monotonic_ns()
            self.bus.send(conn, h.tobytes())

    def _retry_sweep(self) -> None:
        # tbcheck: allow(determinism): RouterServer is the real-TCP
        # front-end; retry/observe cadence runs on wall time.  The
        # sim drives RouterCore, which takes injected ticks.
        now = time.monotonic_ns()
        due = []
        for sub in list(self._pending.values()):
            if sub.kind == "register":
                continue
            state = self._sent_at.get(id(sub))
            if state is not None and now - state[1] >= self.retry_ns:
                due.append(sub)
        if self.qos is None or len(due) <= 1:
            for sub in due:
                self._send_subop(sub)
        else:
            # Weighted-fair retry order: coordinator legs (2PC
            # decisions — cluster safety, never a tenant's fault)
            # re-drive first; forwarded client ops then drain across
            # tenant groups by WFQ pick, so a flooding tenant's retry
            # backlog cannot starve other tenants' re-drives.
            by_tenant: dict[int, list] = {}
            for sub in due:
                if sub.kind != "fwd":
                    self._send_subop(sub)
                    continue
                ctx = self._open.get((sub.client, sub.request))
                tenant = ctx.get("tenant", 0) if ctx else 0
                by_tenant.setdefault(tenant, []).append(sub)
            while by_tenant:
                t = self.qos.pick(by_tenant.keys())
                group = by_tenant[t]
                self._send_subop(group.pop(0))
                if not group:
                    del by_tenant[t]
        # Re-send pending registers on the same cadence (NOT every
        # poll — a shard mid-view-change must not be flooded).
        for key, h in list(self._register_pending.items()):
            last = self._register_sent.get(key, 0)
            if now - last < self.retry_ns:
                continue
            conn = self._connect_shard(key[1])
            if conn is not None:
                self._register_sent[key] = now
                self.bus.send(conn, h.tobytes())

    # -- main loop ------------------------------------------------------

    def poll_once(self, timeout_ms: int = 10) -> None:
        for ev_type, conn, payload in self.bus.poll(timeout_ms):
            if ev_type == self._ev_closed:
                self._drop_shard_conn(conn)
                self._drop_follower_conn(conn)
                self._client_conns = {
                    c: k for c, k in self._client_conns.items()
                    if k != conn
                }
            elif ev_type == self._ev_message:
                self._on_message(conn, payload)
        self._retry_sweep()
        self._frd_sweep()
        self._pump_tasks()

    def _drop_follower_conn(self, conn: int) -> None:
        fid = self._conn_follower.pop(conn, None)
        if fid is None:
            return
        f = self.followers[fid]
        if f["conn"] == conn:
            f["conn"] = None
        # Reads in flight on the dead follower fall back NOW (kill -9
        # redirect, not a fallback-timeout wait).
        for key in [k for k, s in self._frd.items()
                    if s["follower"] is f]:
            self._frd_fallback(key, timeout=False)

    def _frd_sweep(self) -> None:
        if not self._frd:
            return
        # tbcheck: allow(determinism): RouterServer is the real-TCP
        # front-end; retry/observe cadence runs on wall time.  The
        # sim drives RouterCore, which takes injected ticks.
        now = time.monotonic_ns()
        for key in [k for k, s in self._frd.items()
                    if now >= s["deadline"]]:
            self._frd_fallback(key, timeout=True)

    def serve_forever(self) -> None:
        while True:
            self.poll_once()

    def close(self) -> None:
        self.bus.close()

    def _pump_tasks(self) -> None:
        done = []
        for task, ctx in self._tasks:
            issued = task.pump()
            if issued:
                self._issue_subops(issued)
            if task.done:
                done.append((task, ctx))
        for task, ctx in done:
            self._tasks.remove((task, ctx))
            if ctx is not None:
                self._reply_client(ctx, task.result)
            elif task is self._recovery:
                self.flight.note("router_recovered", **(task.result or {}))

    def _reply_client(self, ctx: dict, body: bytes) -> None:
        wire = self._wire
        self._tenant_open_dec(self._open.pop(
            ctx.get("open_key", (ctx["client"], ctx["request"])), None
        ))
        if self.qos is not None and ctx.get("tenant") is not None:
            self.qos.on_reply(ctx["tenant"], ctx["header"])
        # Sessionless queries (state_root) reply to the requesting
        # CONNECTION — concurrent scrapers share client id 0, so the
        # per-client conn map would route every reply to whichever
        # scraper connected last.
        conn = ctx.get("conn")
        if conn is None:
            conn = self._client_conns.get(ctx["client"])
        if conn is None:
            return  # client gone; retransmission re-derives the reply
        h = wire.make_header(
            command=wire.Command.reply, cluster=self.cluster,
            client=ctx["client"], request=ctx["request"],
            operation=int(ctx["operation"]),
        )
        wire.copy_trace(h, ctx["header"])
        wire.finalize_header(h, body)
        self.bus.send(conn, h.tobytes() + body)

    # -- wire dispatch --------------------------------------------------

    def _on_message(self, conn: int, payload: bytes) -> None:
        wire = self._wire
        if len(payload) < HEADER_SIZE:
            return
        header = wire.header_from_bytes(payload[:HEADER_SIZE])
        body = payload[HEADER_SIZE:]
        if not wire.verify_header(header, body):
            return
        cmd = int(header["command"])
        if conn in self._conn_follower:
            self._on_follower_message(conn, header, body, cmd)
            return
        if conn in self._conn_shard:
            self._on_shard_message(conn, header, body, cmd)
            return
        if cmd == int(wire.Command.request):
            self._on_client_request(conn, header, body)

    def _on_shard_message(self, conn: int, header, body: bytes,
                          cmd: int) -> None:
        wire = self._wire
        shard = self._conn_shard[conn]
        client = wire.u128(header, "client")
        request = int(header["request"])
        key = (shard, client, request)
        if cmd == int(wire.Command.reply):
            sub = self._pending.pop(key, None)
            if sub is None:
                return
            if sub.kind == "register":
                self._register_pending.pop((client, shard), None)
                self._register_sent.pop((client, shard), None)
                self._registered.setdefault(client, set()).add(shard)
                if client == self.coord_client:
                    # Resume coordinator numbering above everything
                    # the previous incarnation committed (register
                    # reply's session-resume hint).
                    resume = wire.u128(header, "context")
                    if resume:
                        self._coord_request = max(
                            self._coord_request,
                            resume + COORD_RESUME_GAP,
                        )
                for waiter in self._register_waiters.pop(
                    (client, shard), []
                ):
                    self._send_subop(waiter, first=True)
                self._maybe_finish_client_register(client)
                return
            self._sent_at.pop(id(sub), None)
            sub.complete(bytes(body))
        elif cmd == int(wire.Command.client_busy):
            # Shard overload: coordinator ops just retry later; a
            # forwarded client op propagates the typed busy so the
            # client backs off and re-drives the whole request.
            self._c_shard_busy.inc()
            sub = self._pending.get(key)
            if sub is not None and sub.kind == "fwd":
                self._fail_open_request(client, sub.request)
        elif cmd == int(wire.Command.eviction):
            if client != self.coord_client:
                # The client's impersonated session on this shard is
                # gone: forward the (terminal) eviction and DROP the
                # client's open requests — retrying them against a
                # dead session would spin forever and pin admit-queue
                # slots until the router sheds everything.
                self._registered.get(client, set()).discard(shard)
                self._drop_client_requests(client)
                cconn = self._client_conns.get(client)
                if cconn is not None:
                    self.bus.send(cconn, header.tobytes() + bytes(body))
                return
            # The COORDINATOR's session was evicted on this shard (a
            # session-table overflow landed on it): re-register — the
            # identity is stable, the ops are id-idempotent — and
            # re-drive every coord subop bound for the shard, which
            # would otherwise be retried into the void forever.
            self.flight.note("coord_evicted", shard=shard)
            self._registered.get(self.coord_client, set()).discard(shard)
            for sub in list(self._pending.values()):
                if sub.kind == "coord" and sub.shard == shard:
                    state = self._sent_at.pop(id(sub), None)
                    if state is not None:
                        self._pending.pop(state[0], None)
                    self._send_subop(sub, first=True)

    def _drop_client_requests(self, client: int) -> None:
        """Remove every open request of `client` (no busy reply: the
        caller already delivered a terminal eviction)."""
        for key in [k for k in self._open if k[0] == client]:
            ctx = self._open.pop(key)
            self._frd.pop(key, None)
            self._tenant_open_dec(ctx)
            dead = [t for t, c in self._tasks if c is ctx]
            self._tasks = [(t, c) for t, c in self._tasks
                           if c is not ctx]
            for task in dead:
                for sub in task.subops:
                    state = self._sent_at.pop(id(sub), None)
                    if state is not None:
                        self._pending.pop(state[0], None)

    def _fail_open_request(self, client: int, request: int) -> None:
        ctx = self._open.pop((client, request), None)
        if ctx is None:
            return
        self._frd.pop((client, request), None)
        self._tenant_open_dec(ctx)
        # Drop the task AND every outstanding subop it owns (fwd and
        # coord alike) — an orphaned coord subop would otherwise stay
        # in the retry sweep forever.  Its holds, if any, expire: a
        # clean abort; the client's retried request re-drives them.
        dead = [t for t, c in self._tasks if c is ctx]
        self._tasks = [(t, c) for t, c in self._tasks if c is not ctx]
        for task in dead:
            for sub in task.subops:
                state = self._sent_at.pop(id(sub), None)
                if state is not None:
                    self._pending.pop(state[0], None)
        self._send_busy(ctx["header"], ctx.get("tenant"), admission=False)

    def _send_busy(self, req_header, tenant=None, *,
                   admission: bool = True) -> None:
        """`admission=False` marks a busy for an ALREADY-ADMITTED
        request (a shard shed its sub-op): the typed payload and the
        flight note still go out, but it must not count as a tenant
        admission shed — the t<ledger>.shed counter is the router's
        own admission discriminator, and mixing downstream shard
        overload into it would let shed+admit both increment for one
        request."""
        wire = self._wire
        client = wire.u128(req_header, "client")
        conn = self._client_conns.get(client)
        payload = b""
        if self.qos is not None and tenant is not None:
            payload = wire.busy_body(
                tenant, self._open_of_tenant(tenant),
                self.qos.rate_of(tenant),
            )
            if admission:
                self.qos.on_shed(tenant)
        busy = wire.make_header(
            command=wire.Command.client_busy, cluster=self.cluster,
            client=client, request=int(req_header["request"]),
        )
        wire.copy_trace(busy, req_header)
        wire.finalize_header(busy, payload)
        if conn is not None:
            self.bus.send(conn, busy.tobytes() + payload)
        self._c_shed.inc()
        self.flight.note("router_shed", client=client,
                         request=int(req_header["request"]),
                         open=len(self._open),
                         tenant=-1 if tenant is None else tenant)
        if tenant is not None:
            self.flight.note(f"shed.t{tenant}")

    def _open_of_tenant(self, tenant: int) -> int:
        return self._tenant_open.get(tenant, 0)

    def _tenant_open_dec(self, ctx: dict | None) -> None:
        """Bookkeeping for an _open removal (reply/fail/drop): ctxs
        without a tenant (QoS off, sessionless state_root queries)
        are not counted on insert and skip here too."""
        tenant = None if ctx is None else ctx.get("tenant")
        if tenant is None:
            return
        count = self._tenant_open.get(tenant, 0) - 1
        if count > 0:
            self._tenant_open[tenant] = count
        else:
            self._tenant_open.pop(tenant, None)

    def _on_client_request(self, conn: int, header, body: bytes) -> None:
        wire = self._wire
        client = wire.u128(header, "client")
        request = int(header["request"])
        operation = int(header["operation"])
        self._client_conns[client] = conn
        if operation == int(wire.VsrOperation.stats):
            from tigerbeetle_tpu_torch.obs.scrape import stats_reply

            reply, rbody = stats_reply(self.registry.snapshot(), header)
            self.bus.send(conn, reply.tobytes() + rbody)
            return
        if operation == int(wire.VsrOperation.state_root):
            # Cluster proof of state: fan the sessionless query out to
            # every shard and fold — a normal task, so it shares the
            # retry sweep, the admission bound (a polling monitor with
            # fresh request numbers must not grow _open past the queue
            # while a shard is unreachable), and replies through
            # _reply_client.  Scrapers share one well-known (client=0,
            # SCRAPE_REQUEST) identity, so the open key and the reply
            # route carry the CONNECTION: two concurrent scrapes are
            # independent requests, not a retransmission.
            open_key = (client, request, conn)
            if open_key in self._open:
                return
            if len(self._open) >= self.admit_queue:
                self._send_busy(header)
                return
            ctx = {
                "client": client, "request": request,
                "operation": operation, "header": header.copy(),
                "conn": conn, "open_key": open_key,
            }
            self._open[open_key] = ctx
            task = self.core.state_root()
            self._issue_subops(task.subops)
            self._tasks.append((task, ctx))
            self._pump_tasks()
            return
        if operation == int(wire.VsrOperation.register):
            self._client_register[client] = header.copy()
            for shard in range(self.n_shards):
                if shard not in self._registered.setdefault(client, set()):
                    self._ensure_registered(client, shard, None)
            self._maybe_finish_client_register(client)
            return
        if operation < types.Operation.pulse:
            return  # VSR-internal ops are not routable
        if (client, request) in self._open:
            return  # retransmission of an in-flight request
        tenant = None
        if self.qos is not None:
            # Tenant-keyed admission (retransmissions of in-flight
            # requests returned above — shedding here never answers a
            # request the router is already driving): a rate-capped
            # or slot-hogging tenant is shed with its own typed
            # payload while other tenants' requests still fit.  The
            # GLOBAL slot bound checks first so a request the full
            # table sheds anyway never consumes one of its tenant's
            # tokens (the tenant still rides the busy payload).
            tenant = wire.tenant_of(header, body)
            # tbcheck: allow(determinism): RouterServer is the real-TCP
            # front-end; retry/observe cadence runs on wall time.  The
            # sim drives RouterCore, which takes injected ticks.
            now = time.monotonic_ns()
            self.qos.observe(tenant, now)
        if len(self._open) >= self.admit_queue:
            self._send_busy(header, tenant)
            return
        if self.qos is not None:
            if not self.qos.admit(tenant, now, self._open_of_tenant(tenant),
                                  body_bytes=len(body)):
                self._send_busy(header, tenant)
                return
            self.qos.on_admit(tenant)
        trace = (int(header["trace_id"]), int(header["trace_ts"]),
                 int(header["trace_flags"]))
        ctx = {
            "client": client, "request": request,
            "operation": operation, "header": header.copy(),
            "tenant": tenant,
        }
        self._open[(client, request)] = ctx
        if tenant is not None:
            self._tenant_open[tenant] = (
                self._tenant_open.get(tenant, 0) + 1
            )
        if operation in self._READ_OPS:
            # tbcheck: allow(determinism): RouterServer is the
            # real-TCP front-end; retry/observe cadence runs on wall
            # time.  The sim drives RouterCore, with injected ticks.
            frd_now = time.monotonic_ns()
            if self._try_follower_read(ctx, operation, bytes(body),
                                       frd_now):
                return  # reply/fallback finishes it
        task = self.core.open_request(client, request, operation, body,
                                      trace)
        self._issue_subops(task.subops)
        self._tasks.append((task, ctx))
        self._pump_tasks()

    def _maybe_finish_client_register(self, client: int) -> None:
        wire = self._wire
        req = self._client_register.get(client)
        if req is None:
            return
        if len(self._registered.get(client, ())) < self.n_shards:
            return
        del self._client_register[client]
        conn = self._client_conns.get(client)
        if conn is None:
            return
        h = wire.make_header(
            command=wire.Command.reply, cluster=self.cluster,
            client=client, request=0,
            operation=wire.VsrOperation.register,
        )
        wire.finalize_header(h, b"")
        self.bus.send(conn, h.tobytes())
