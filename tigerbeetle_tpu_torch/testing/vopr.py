"""VOPR-style deterministic whole-cluster fuzzing.

The reference's VOPR (reference: src/simulator.zig, docs/about/vopr.md)
replaces every nondeterministic component with a seeded fake and then
drives random workload + nemesis events, checking invariants the whole
way.  This build reuses the deterministic cluster (testing/cluster.py)
and layers on:

- Workload: seeded mix of create_accounts / create_transfers (plain,
  pending, post/void, linked chains), with guaranteed-success requests
  tracked for auditing (reference: src/state_machine/workload.zig).
- Nemesis: seeded replica crash (losing unsynced sectors) + restart,
  partitions/heals (reference: src/simulator.zig:194-204).
- Checkers: linearized commit history, state convergence,
  double-entry conservation (sum of debits == sum of credits, posted
  and pending), and restart-replay equivalence (a fresh replica opened
  from a live replica's storage must reach the identical state).

This package's own copy of ``tigerbeetle_tpu/testing/vopr.py``; the
default state machine is the port's oracle ``state_machine/cpu.py``,
and the device-loss nemesis builds ``TorchStateMachine`` on the first
CUDA card.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.state_machine import CpuStateMachine
from tigerbeetle_tpu_torch.testing.cluster import (
    Cluster,
    PacketOptions,
    ShardedCluster,
)
from tigerbeetle_tpu_torch.testing.harness import account, ids_bytes, pack, transfer
from tigerbeetle_tpu_torch.vsr.multi import VsrReplica
from tigerbeetle_tpu_torch.vsr.storage import FsyncCrash
from tigerbeetle_tpu_torch.vsr.wire import VsrOperation


class Workload:
    def __init__(self, seed: int, queries: bool = False) -> None:
        """queries=False is the frozen v1 stream: regression seed
        tests reproduce their original fault interleavings only if
        the RNG consumption stays byte-identical.  queries=True (the
        v2 profile, used by soaks and its own tests) widens the op
        surface with lookup_transfers, AccountFilter queries over the
        committed scan engine, history balances, and balancing
        transfers — cross-replica determinism of every reply is
        enforced by the cluster's hash-log convergence checker."""
        self.rng = np.random.default_rng(seed)
        self.queries = queries
        self.account_ids: list[int] = []
        self.history_ids: list[int] = []
        self.pending_ids: list[int] = []
        self.transfer_ids: list[int] = []
        self.next_account = 1
        self.next_transfer = 1_000_000

    def next_request(self) -> tuple[types.Operation, bytes, bool]:
        """-> (operation, body, must_succeed)."""
        roll = self.rng.random()
        if not self.queries:
            if len(self.account_ids) < 4 or roll < 0.08:
                return self._create_accounts()
            if roll < 0.70:
                return self._create_transfers()
            if roll < 0.80 and self.pending_ids:
                return self._post_or_void()
            if roll < 0.90:
                return self._lookup_accounts()
            return self._create_transfers()
        if len(self.account_ids) < 4 or roll < 0.08:
            return self._create_accounts()
        if roll < 0.58:
            return self._create_transfers()
        if roll < 0.68 and self.pending_ids:
            return self._post_or_void()
        if roll < 0.74:
            return self._lookup_accounts()
        if roll < 0.80 and self.transfer_ids:
            return self._lookup_transfers()
        if roll < 0.88:
            return self._get_account_transfers()
        if roll < 0.94:
            return self._get_account_balances()
        return self._balancing_transfer()

    def _create_accounts(self):
        n = int(self.rng.integers(1, 5))
        rows = []
        for _ in range(n):
            flags = 0
            if self.queries and self.rng.random() < 0.4:
                flags |= types.AccountFlags.history
                self.history_ids.append(self.next_account)
            rows.append(
                account(self.next_account, ledger=1, code=1, flags=flags)
            )
            self.account_ids.append(self.next_account)
            self.next_account += 1
        return types.Operation.create_accounts, pack(rows), True

    def _lookup_accounts(self):
        ids = [
            int(v) for v in
            self.rng.choice(self.account_ids, size=min(4, len(self.account_ids)))
        ]
        return types.Operation.lookup_accounts, ids_bytes(ids), True

    def _lookup_transfers(self):
        ids = [
            int(v) for v in
            self.rng.choice(self.transfer_ids,
                            size=min(4, len(self.transfer_ids)))
        ]
        return types.Operation.lookup_transfers, ids_bytes(ids), True

    def _account_filter(self, account_id: int) -> bytes:
        row = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
        types.u128_set(row, "account_id", account_id)
        flags = 0
        if self.rng.random() < 0.8:
            flags |= types.AccountFilterFlags.debits
        if self.rng.random() < 0.8:
            flags |= types.AccountFilterFlags.credits
        if not flags:
            flags = (types.AccountFilterFlags.debits
                     | types.AccountFilterFlags.credits)
        if self.rng.random() < 0.3:
            flags |= types.AccountFilterFlags.reversed
        row["flags"] = flags
        row["limit"] = int(self.rng.choice([1, 3, 50, 8190]))
        return row.tobytes()

    def _get_account_transfers(self):
        aid = int(self.rng.choice(self.account_ids))
        return (
            types.Operation.get_account_transfers,
            self._account_filter(aid),
            True,
        )

    def _get_account_balances(self):
        # Prefer a history-flagged account (rows exist only for
        # those); a non-history target legitimately returns empty and
        # still exercises the committed scan path.
        pool = self.history_ids or self.account_ids
        aid = int(self.rng.choice(pool))
        return (
            types.Operation.get_account_balances,
            self._account_filter(aid),
            True,
        )

    def _balancing_transfer(self):
        dr, cr = self._pick_pair()
        tid = self.next_transfer
        self.next_transfer += 1
        flags = (
            types.TransferFlags.balancing_debit
            # tbcheck: allow(money): seeded-RNG coin flip choosing a
            # flag — the 0.5 is a probability, not an amount.
            if self.rng.random() < 0.5
            else types.TransferFlags.balancing_credit
        )
        # Legitimately fails with exceeds_credits/debits when nothing
        # is transferable — exercised for determinism, not audited.
        return (
            types.Operation.create_transfers,
            pack([transfer(tid, debit_account_id=dr, credit_account_id=cr,
                           amount=int(self.rng.integers(0, 50)),
                           flags=flags)]),
            False,
        )

    def _pick_pair(self) -> tuple[int, int]:
        dr, cr = self.rng.choice(self.account_ids, size=2, replace=False)
        return int(dr), int(cr)

    def _create_transfers(self):
        n = int(self.rng.integers(1, 6))
        rows = []
        linked_open = False
        for k in range(n):
            dr, cr = self._pick_pair()
            flags = 0
            is_pending = self.rng.random() < 0.25
            if is_pending:
                flags |= types.TransferFlags.pending
            # Linked chains (never the last event, so chains close).
            if k < n - 1 and self.rng.random() < 0.2:
                flags |= types.TransferFlags.linked
                linked_open = True
            else:
                linked_open = False
            tid = self.next_transfer
            self.next_transfer += 1
            timeout = int(self.rng.integers(1, 5)) if is_pending and self.rng.random() < 0.3 else 0
            rows.append(
                transfer(tid, debit_account_id=dr, credit_account_id=cr,
                         amount=int(self.rng.integers(1, 100)), flags=flags,
                         timeout=timeout)
            )
            if is_pending and timeout == 0:
                self.pending_ids.append(tid)
            self.transfer_ids.append(tid)
        del self.transfer_ids[:-512]  # bound lookup pool memory
        assert not linked_open
        return types.Operation.create_transfers, pack(rows), True

    def _post_or_void(self):
        pid = self.pending_ids.pop(int(self.rng.integers(len(self.pending_ids))))
        void = self.rng.random() < 0.3
        tid = self.next_transfer
        self.next_transfer += 1
        flags = (
            types.TransferFlags.void_pending_transfer if void
            else types.TransferFlags.post_pending_transfer
        )
        # amount=0 means inherit (post) / full (void) — always valid.
        return (
            types.Operation.create_transfers,
            pack([transfer(tid, pending_id=pid, flags=flags)]),
            True,
        )


def check_conservation(cluster) -> None:
    """Double-entry invariant on every replica: total debits == total
    credits, in both posted and pending columns."""
    for r in cluster.replicas:
        sm = r.sm
        if isinstance(sm, CpuStateMachine):
            dp = sum(a.debits_pending for a in sm.accounts.values())
            cp = sum(a.credits_pending for a in sm.accounts.values())
            dpo = sum(a.debits_posted for a in sm.accounts.values())
            cpo = sum(a.credits_posted for a in sm.accounts.values())
        else:  # TpuStateMachine: sum the balance-mirror columns
            n = sm._attrs.count
            lo = sm._mirror.lo[:n].astype(object)
            hi = sm._mirror.hi[:n].astype(object)
            totals = [
                int((lo[:, c] + (hi[:, c] * (1 << 64))).sum())
                for c in range(4)
            ]
            dp, dpo, cp, cpo = totals
        assert dp == cp, (dp, cp)
        assert dpo == cpo, (dpo, cpo)


class FaultAtlas:
    """Seeded targeting for sector corruption that guarantees >= 1
    intact copy of everything cluster-wide (reference:
    src/testing/storage.zig:58-95 ClusterFaultAtlas): corruption only
    ever hits a fixed minority of replicas (f = (n-1)//2), and locally
    at most one of the four superblock copies."""

    def __init__(self, seed: int, replica_count: int) -> None:
        rng = np.random.default_rng(seed)
        f = (replica_count - 1) // 2
        self.faulty: set[int] = (
            {int(x) for x in rng.choice(replica_count, size=f, replace=False)}
            if f else set()
        )


class Vopr:
    def __init__(self, seed: int, *, replica_count: int = 3,
                 standby_count: int = 0,
                 requests: int = 40,
                 packet_loss: float = 0.02,
                 crash_probability: float = 0.01,
                 corruption_probability: float = 0.0,
                 upgrade_nemesis: bool = False,
                 queries: bool = False,
                 reconfigure_nemesis: bool = False,
                 partition_probability: float = 0.0,
                 device_loss_probability: float = 0.0,
                 state_machine_factory=None) -> None:
        self.seed = seed
        self.rng = np.random.default_rng(seed + 1)
        # Device-loss nemesis (opt-in, like partitions): replicas run
        # the device-authoritative engine behind seeded ChaosLinks
        # (testing/chaos.py), and the nemesis kills/heals those links
        # mid-run.  The degraded-mode lifecycle must keep replies
        # bit-identical across replicas losing their device at
        # DIFFERENT times — enforced by the existing hash-log
        # convergence checker.
        self.device_loss_probability = device_loss_probability
        self._chaos_links: list = []
        if device_loss_probability > 0.0:
            if state_machine_factory is not None:
                # The nemesis can only target links it owns; silently
                # dropping the knob would fake device-loss coverage.
                raise ValueError(
                    "device_loss_probability requires the built-in "
                    "chaos factory; do not also pass "
                    "state_machine_factory"
                )
            from tigerbeetle_tpu_torch.testing.chaos import device_chaos_factory

            state_machine_factory, self._chaos_links = device_chaos_factory(
                seed + 4
            )
        self.cluster = Cluster(
            replica_count=replica_count, seed=seed,
            standby_count=standby_count,
            options=PacketOptions(packet_loss_probability=packet_loss),
            state_machine_factory=state_machine_factory,
        )
        self.workload = Workload(seed + 2, queries=queries)
        self.requests = requests
        self.crash_probability = crash_probability
        self.corruption_probability = corruption_probability
        self.upgrade_nemesis = upgrade_nemesis
        self.reconfigure_nemesis = reconfigure_nemesis and standby_count > 0
        # Opt-in (0.0 keeps pinned seeds' RNG streams byte-identical):
        # unlike a crash, a partitioned process keeps RUNNING — state
        # intact, clock advancing — and rejoins live-but-stale,
        # exercising view-change rejoin paths crashes cannot.
        self.partition_probability = partition_probability
        self._partitioned: set[int] = set()
        self.atlas = FaultAtlas(seed + 3, replica_count)
        self.crashed: set[int] = set()
        self.restart_check_skipped = False
        self.corruptions = 0
        self._sb_corrupt_copy: dict[int, int] = {}

    def run(self) -> None:
        c = self.cluster
        client = c.client(9000 + self.seed)
        client.register()
        c.run_until(lambda: client.registered, max_steps=4000)

        sent = 0
        guard = 0
        pending_audit: tuple[types.Operation, bool] | None = None
        while sent < self.requests or client.busy():
            guard += 1
            assert guard < 200_000, "vopr stalled"
            self._nemesis()
            if not client.busy():
                if pending_audit is not None:
                    self._audit(client, *pending_audit)
                    pending_audit = None
                if sent < self.requests:
                    reconf = (
                        self._propose_reconfigure()
                        if self.reconfigure_nemesis
                        and self.rng.random() < 0.04
                        else None
                    )
                    if reconf is not None:
                        # Membership change rides the normal request
                        # path; a stale-epoch rejection is a legal
                        # outcome under concurrent proposals.
                        client.request(VsrOperation.reconfigure, reconf)
                        pending_audit = (VsrOperation.reconfigure, False)
                    else:
                        operation, body, must_succeed = (
                            self.workload.next_request()
                        )
                        client.request(operation, body)
                        pending_audit = (operation, must_succeed)
                    sent += 1
            c.step()
        if pending_audit is not None:
            self._audit(client, *pending_audit)

        # Heal everything, restart the dead, settle, check.
        for link in self._chaos_links:
            link.heal()
        c.network.heal()
        for i in sorted(self.crashed):
            c.restart_replica(i)
        self.crashed.clear()
        c.run_until(lambda: not client.busy(), max_steps=20_000)
        if self.upgrade_nemesis:
            # Finish any half-rolled upgrade BEFORE requiring
            # convergence: a replica still on the old release cannot
            # execute prepares stamped with the new one (the reference
            # re-execs each process; the harness restarts it).
            for _ in range(4):
                target = max(
                    max(r.release for r in c.replicas),
                    max((r.upgrade_target or 0) for r in c.replicas),
                )
                stale = [
                    i for i, r in enumerate(c.replicas)
                    if r.release < target
                ]
                if not stale:
                    break
                for i in stale:
                    c.restart_replica(
                        i, release=target,
                        releases_available=tuple(range(1, target + 1)),
                    )
                for _ in range(400):
                    c.step()
        c.settle(max_steps=20_000)
        if self.corruption_probability:
            # Surface and heal ALL latent WAL damage before the
            # journal-reading checkers run: production paces scrubbing
            # over minutes; the harness forces full passes (repair may
            # take a couple of request/response rounds).
            for _ in range(6):
                for r in c.replicas:
                    r.wal_scrub_window()
                for _ in range(8 * c.replica_count):
                    c.step()
                if all(not r._wal_scrub_wanted for r in c.replicas):
                    break
            # The extra steps may have committed a pulse mid-stride:
            # re-quiesce before the checkers read cluster state.
            c.settle(max_steps=20_000)
        c.check_linearized()
        c.check_convergence()
        self.check_conservation()
        self.check_restart_equivalence()

    def _audit(self, client, operation: types.Operation,
               must_succeed: bool) -> None:
        """Auditor (reference: src/state_machine/auditor.zig): requests
        constructed to be valid must report zero failures."""
        # A registered client must never be evicted mid-run (sessions
        # are durable state): surface it as the finding, not as a
        # TypeError on the absent reply — for every request, not just
        # must-succeed ones.
        assert not client.evicted, "registered client wrongly evicted"
        if not must_succeed:
            return
        if operation in (types.Operation.create_accounts,
                         types.Operation.create_transfers):
            results = np.frombuffer(client.reply, types.CREATE_RESULT_DTYPE)
            # Strict: ids are globally unique and sessions dedupe
            # retransmissions by replaying the stored reply, so even
            # `exists` would signal a double execution.
            assert len(results) == 0, (operation, results[:6])

    def _propose_reconfigure(self) -> bytes | None:
        """Propose swapping a random active slot with a random standby
        (epoch + 1 over the freshest known membership) — standby
        promotion under the full nemesis suite.  reference:
        src/vsr.zig:273-311 (reconfiguration epochs)."""
        c = self.cluster
        total = c.replica_count + c.standby_count
        best = max(c.replicas, key=lambda r: r.epoch)
        members = list(best.members) if best.members else list(range(total))
        if len(members) != total:
            return None
        a = int(self.rng.integers(c.replica_count))
        s = int(self.rng.integers(c.replica_count, total))
        members[a], members[s] = members[s], members[a]
        return VsrReplica.encode_reconfigure(best.epoch + 1, members)

    # -- nemesis --

    def _nemesis(self) -> None:
        c = self.cluster
        # Clock-skew nemesis: wall clocks drift within the Marzullo
        # tolerance (larger skews legitimately stall writes — see
        # test_cluster_divergent_clocks_refuse_writes).
        if self.rng.random() < 0.01:
            i = int(self.rng.integers(c.replica_count))
            c.clock_skew[i] = int(self.rng.integers(-5_000_000, 5_000_000))
        if self.corruption_probability and (
            self.rng.random() < self.corruption_probability
        ):
            self._corrupt_random_sector()
        if self.upgrade_nemesis:
            self._upgrade_tick()
        if self.device_loss_probability and self._chaos_links:
            downed = [link for link in self._chaos_links if link.down]
            if downed:
                # Heal with ~10%/tick so device outages stay short
                # enough for re-promotion to happen within the run.
                if self.rng.random() < 0.10:
                    for link in downed:
                        link.heal()
            elif self.rng.random() < self.device_loss_probability:
                pick = int(self.rng.integers(len(self._chaos_links)))
                self._chaos_links[pick].kill()
        if self.partition_probability:
            if self._partitioned:
                # Heal with ~4%/tick so isolation windows are short.
                if self.rng.random() < 0.04:
                    c.network.heal(*self._partitioned)
                    self._partitioned.clear()
            elif self.rng.random() < self.partition_probability:
                i = int(self.rng.integers(len(c.replicas)))
                if i not in self.crashed:
                    c.network.partition(i)
                    self._partitioned.add(i)
        if self.crashed:
            # Restart with probability ~5%/tick so outages are short.
            if self.rng.random() < 0.05:
                i = self.crashed.pop()
                c.restart_replica(i)
            return
        if self.rng.random() < self.crash_probability:
            i = int(self.rng.integers(len(c.replicas)))
            c.crash_replica(i)
            self.crashed.add(i)

    def _corrupt_random_sector(self) -> None:
        """Latent-sector-error nemesis over live replicas, targeted by
        the FaultAtlas: WAL prepare slots, WAL header-ring sectors, one
        superblock copy, and live forest grid blocks — every zone with
        an automated recovery path (redundant headers + protocol WAL
        repair, superblock quorum, scrubber block repair)."""
        from tigerbeetle_tpu_torch.vsr.storage import SECTOR_SIZE
        from tigerbeetle_tpu_torch.vsr.superblock import SUPERBLOCK_COPIES

        c = self.cluster
        candidates = [
            i for i in sorted(self.atlas.faulty) if i not in self.crashed
        ]
        if not candidates:
            return
        i = int(self.rng.choice(candidates))
        storage = c.storages[i]
        layout = storage.layout
        replica = c.replicas[i]
        zones = ["wal_prepare", "wal_header", "superblock"]
        if replica.forest is not None and (
            ~replica.forest.grid.free_set.free
        ).any():
            zones.append("grid")
        zone = zones[int(self.rng.integers(len(zones)))]
        if zone == "wal_prepare":
            slot = int(self.rng.integers(layout.config.journal_slot_count))
            offset = layout.prepare_slot_offset(slot)
        elif zone == "wal_header":
            n_sectors = layout.wal_headers_size // SECTOR_SIZE
            offset = (
                layout.wal_headers_offset
                + int(self.rng.integers(n_sectors)) * SECTOR_SIZE
            )
        elif zone == "superblock":
            # At most ONE copy per replica ever corrupts (4-copy
            # quorum stays decidable locally).
            copy = self._sb_corrupt_copy.setdefault(
                i, int(self.rng.integers(SUPERBLOCK_COPIES))
            )
            offset = layout.superblock_offset + copy * (
                layout.superblock_size // SUPERBLOCK_COPIES
            )
        else:
            grid = replica.forest.grid
            allocated = np.flatnonzero(~grid.free_set.free)
            addr = int(self.rng.choice(allocated)) + 1
            offset = grid._offset(addr)
        storage.corrupt_sector(offset)
        self.corruptions += 1

    def _upgrade_tick(self) -> None:
        """Release-upgrade nemesis (reference: src/simulator.zig
        :194-204 restart-with-new-release probabilities): roll replicas
        to advertise release 2, then re-exec each one once the upgrade
        op commits its target."""
        c = self.cluster
        if self.rng.random() < 0.005:
            i = int(self.rng.integers(len(c.replicas)))
            if i not in self.crashed and (
                max(c.replicas[i].releases_available) < 2
            ):
                c.restart_replica(i, releases_available=(1, 2))
        for i, r in enumerate(c.replicas):
            if i in self.crashed:
                continue
            if r.upgrade_target == 2 and r.release == 1 and (
                self.rng.random() < 0.05
            ):
                c.restart_replica(i, release=2, releases_available=(1, 2))

    # -- checkers --

    def check_conservation(self) -> None:
        check_conservation(self.cluster)

    def check_restart_equivalence(self) -> None:
        """Recovery is re-execution: opening a fresh replica over live
        storage must reproduce the live state bit-for-bit.  The run has
        settled, so the live journal tail is the canonical committed
        chain — replay_tail=True executes it deliberately (a normal
        multi-replica open defers the tail to consensus re-commit)."""
        c = self.cluster
        # Corruption targets atlas replicas; restart-replay needs a
        # replica whose local WAL is intact.
        live_index = 0
        if self.corruption_probability:
            live_index = next(
                i for i in range(c.replica_count)
                if i not in self.atlas.faulty
            )
        live = c.replicas[live_index]
        if live.op != live.commit_min:
            # A prepared-but-uncommitted suffix remains (quorum raced
            # the end of the run); tail replay would execute it, so the
            # bit-exact comparison only holds without one.  Recorded so
            # a seed corpus that never exercises this check is visible.
            self.restart_check_skipped = True
            return
        import copy

        # Deep-copy the storage: replay writes reply slots (stamped
        # with the recovered view) and must not mutate live state.
        fresh = VsrReplica(
            copy.deepcopy(c.storages[live_index]), c.cluster_id,
            c._factory(), live.bus, replica=live_index,
            replica_count=c.replica_count,
            release=live.release,
            releases_available=live.releases_available,
        )
        fresh.open(replay_tail=True)
        assert fresh.commit_min == live.commit_min
        assert fresh.sm.snapshot() == live.sm.snapshot()


# ----------------------------------------------------------------------
# Multi-tenant VOPR (round 16): one tenant floods while others
# trickle, with per-tenant QoS live on every replica.


class TenantStream:
    """One tenant's seeded request stream: its own ledger, its own
    account pool, every request constructed-valid (unique ids, no
    balance limits) so any failure row in a reply is a finding."""

    def __init__(self, seed: int, ledger: int, namespace: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.ledger = ledger
        self.account_ids: list[int] = []
        # Per-STREAM id namespaces: several clients may drive the same
        # tenant (the flood), and ids are globally unique.
        self.next_account = namespace * 1_000_000 + 1
        self.next_transfer = namespace * 1_000_000 + 500_000

    def next_request(self) -> tuple[types.Operation, bytes]:
        if len(self.account_ids) < 4 or self.rng.random() < 0.06:
            rows = []
            for _ in range(int(self.rng.integers(2, 5))):
                rows.append(account(self.next_account, ledger=self.ledger))
                self.account_ids.append(self.next_account)
                self.next_account += 1
            return types.Operation.create_accounts, pack(rows)
        rows = []
        for _ in range(int(self.rng.integers(1, 4))):
            dr, cr = self.rng.choice(self.account_ids, size=2,
                                     replace=False)
            rows.append(transfer(
                self.next_transfer, debit_account_id=int(dr),
                credit_account_id=int(cr),
                amount=int(self.rng.integers(1, 100)),
                ledger=self.ledger,
            ))
            self.next_transfer += 1
        return types.Operation.create_transfers, pack(rows)


class MultiTenantVopr:
    """Seeded multi-tenant overload fuzz: a flooding tenant (ledger 1,
    several back-to-back clients) vs trickling tenants (one client
    each, paced), against replicas running per-tenant QoS with a
    deliberately tight admit queue so the flood tenant is SHED —
    hash-log convergence, linearizability, and conservation-of-money
    must hold across the shed/retry/backoff storms, crash/restart and
    packet-loss nemeses included.  Typed busy is load shedding, not
    data loss: every constructed-valid request must eventually commit
    with zero failure rows."""

    def __init__(self, seed: int, *, tenants: int = 3,
                 flood_clients: int = 3, requests: int = 45,
                 replica_count: int = 3, packet_loss: float = 0.01,
                 crash_probability: float = 0.004,
                 trickle_every: int = 12,
                 tenant_queue: int = 2, admit_queue: int = 4,
                 weights: dict | None = None) -> None:
        import dataclasses as _dc

        self.seed = seed
        self.rng = np.random.default_rng(seed + 1)
        self.requests = requests
        self.crash_probability = crash_probability
        self.trickle_every = trickle_every
        self.crashed: set[int] = set()
        self.cluster = Cluster(
            replica_count=replica_count, seed=seed,
            config=_dc.replace(
                cfg.TEST_MIN, clients_max=flood_clients + tenants + 2
            ),
            options=PacketOptions(packet_loss_probability=packet_loss),
            tenant_qos=dict(
                rate=0.0, queue_bound=tenant_queue,
                weights=weights, admit_queue=admit_queue,
            ),
        )
        c = self.cluster
        # Flood tenant: ledger 1, several closed-loop clients driving
        # back-to-back (well past its fair share); trickle tenants:
        # ledgers 2..tenants, one paced client each.
        self.streams: list[tuple] = []  # (client, stream, paced)
        cid = 9000
        ns = 1
        for k in range(flood_clients):
            self.streams.append(
                (c.client(cid), TenantStream(seed + 10 + k, 1, ns), False)
            )
            cid += 1
            ns += 1
        for ledger in range(2, tenants + 1):
            self.streams.append(
                (c.client(cid),
                 TenantStream(seed + 50 + ledger, ledger, ns), True)
            )
            cid += 1
            ns += 1
        self.sheds = 0
        self.busy_replies = 0
        self.busy_backoffs = 0

    def _nemesis(self) -> None:
        c = self.cluster
        if self.crashed:
            if self.rng.random() < 0.05:
                c.restart_replica(self.crashed.pop())
            return
        if self.rng.random() < self.crash_probability:
            i = int(self.rng.integers(len(c.replicas)))
            c.crash_replica(i)
            self.crashed.add(i)

    def run(self) -> None:
        c = self.cluster
        for client, _stream, _paced in self.streams:
            client.register()
        c.run_until(
            lambda: all(cl.registered for cl, _s, _p in self.streams),
            max_steps=8000,
        )
        sent = {id(cl): 0 for cl, _s, _p in self.streams}
        pending: dict[int, types.Operation] = {}
        guard = 0
        while any(
            sent[id(cl)] < self.requests or cl.busy()
            for cl, _s, _p in self.streams
        ):
            guard += 1
            assert guard < 400_000, "multi-tenant vopr stalled"
            self._nemesis()
            for client, stream, paced in self.streams:
                if client.busy():
                    continue
                assert not client.evicted, "tenant client wrongly evicted"
                op = pending.pop(id(client), None)
                if op in (types.Operation.create_accounts,
                          types.Operation.create_transfers):
                    results = np.frombuffer(
                        client.reply, types.CREATE_RESULT_DTYPE
                    )
                    assert len(results) == 0, (
                        "constructed-valid request failed under QoS",
                        op, results[:4],
                    )
                if sent[id(client)] >= self.requests:
                    continue
                if paced and guard % self.trickle_every:
                    continue  # trickle cadence
                op, body = stream.next_request()
                client.request(op, body)
                pending[id(client)] = op
                sent[id(client)] += 1
            c.step()

        # Drain the last replies' audits.
        for client, _stream, _paced in self.streams:
            op = pending.pop(id(client), None)
            if op is not None:
                results = np.frombuffer(
                    client.reply, types.CREATE_RESULT_DTYPE
                )
                assert len(results) == 0, (op, results[:4])

        # Heal, restart the dead, settle, check everything.
        c.network.heal()
        for i in sorted(self.crashed):
            c.restart_replica(i)
        self.crashed.clear()
        c.settle(max_steps=30_000)
        c.check_linearized()
        c.check_convergence()
        check_conservation(c)
        # Shed/backoff accounting (restarts reset replica counters;
        # this is a floor, not a total).
        self.sheds = sum(
            r.qos.sheds for r in c.replicas if r.qos is not None
        )
        self.busy_replies = sum(
            cl.busy_replies for cl, _s, _p in self.streams
        )
        self.busy_backoffs = sum(
            cl.busy_backoffs for cl, _s, _p in self.streams
        )


# ----------------------------------------------------------------------
# Sharded VOPR: the multi-cluster router under the full nemesis mix.


class ShardedWorkload:
    """Seeded request mix over an account-sharded cluster: shard-local
    transfers, CROSS-shard transfers (the 2PC path), local two-phase
    pending/post/void, and lookups.

    Every account is limit-free (no debits/credits_must_not_exceed
    flags) and every transfer id unique, so each well-formed request
    succeeds regardless of the interleaving the router's relaxed
    intra-batch ordering produces — which makes the end state exactly
    reproducible by a single-node oracle replay of the reported-ok
    stream (`oracle_replay`).
    """

    def __init__(self, seed: int, n_shards: int,
                 cross_ratio: float = 0.35, tenants: int = 1) -> None:
        self.rng = np.random.default_rng(seed)
        self.n_shards = n_shards
        self.cross_ratio = cross_ratio
        # Multi-tenant mode (round 16): accounts spread round-robin
        # over `tenants` ledgers; transfer traffic is flood-biased
        # toward ledger 1 (one tenant drives most of the load while
        # the rest trickle).  tenants=1 consumes the RNG stream
        # byte-identically to the frozen v1 profile — the pinned
        # regression seeds (4242/2046/3013) must keep reproducing
        # their original fault interleavings.
        self.tenants = tenants
        self.by_shard: dict[int, list[int]] = {s: [] for s in range(n_shards)}
        self.pools: dict[tuple[int, int], list[int]] = {}  # (shard, ledger)
        self.ledger_of: dict[int, int] = {}
        self.account_ids: list[int] = []
        # Local (same-shard) pending transfers awaiting post/void:
        # (tid, shard, ledger).
        self.pending_local: list[tuple[int, int, int]] = []
        self.next_account = 1
        self.next_transfer = 1_000_000
        # Every attempted cross-shard transfer: (tid, dshard, cshard),
        # with amount/debitor alongside (the oracle needs them to
        # model compensations).
        self.xfers: list[tuple[int, int, int]] = []
        self.xfer_amount: dict[int, int] = {}
        self.xfer_debitor: dict[int, int] = {}

    def _pick_tenant(self) -> int:
        """Flood-biased ledger choice: tenant 1 drives ~70% of the
        traffic, the rest trickle.  No RNG draw in single-tenant mode
        (the frozen stream)."""
        if self.tenants == 1:
            return 1
        if self.rng.random() < 0.7:
            return 1
        return 2 + int(self.rng.integers(self.tenants - 1))

    def _new_accounts(self, n: int):
        rows = []
        for _ in range(n):
            aid = self.next_account
            self.next_account += 1
            # Round-robin ledger assignment (deterministic, no RNG):
            # every tenant's pool fills on every shard.
            ledger = 1 + (aid % self.tenants) if self.tenants > 1 else 1
            rows.append(account(aid, ledger=ledger, code=1))
            self.account_ids.append(aid)
            self.ledger_of[aid] = ledger
            shard = types.shard_of_account(aid, self.n_shards)
            self.by_shard[shard].append(aid)
            self.pools.setdefault((shard, ledger), []).append(aid)
        return types.Operation.create_accounts, pack(rows), "accounts"

    def _pick_local_pair(self, ledger: int = 0) -> tuple[int, int, int]:
        """(debit, credit, shard) on one shard (needs >= 2 accounts
        of `ledger`; 0 = any, the frozen single-tenant path)."""
        if not ledger:
            shards = [s for s, ids in self.by_shard.items() if len(ids) >= 2]
            s = int(self.rng.choice(shards))
            dr, cr = self.rng.choice(self.by_shard[s], size=2, replace=False)
            return int(dr), int(cr), s
        shards = [
            s for s in range(self.n_shards)
            if len(self.pools.get((s, ledger), ())) >= 2
        ]
        s = int(self.rng.choice(shards))
        dr, cr = self.rng.choice(self.pools[(s, ledger)], size=2,
                                 replace=False)
        return int(dr), int(cr), s

    def _pick_cross_pair(self, ledger: int = 0) -> tuple[int, int, int, int]:
        if not ledger:
            shards = [s for s, ids in self.by_shard.items() if ids]
            a, b = self.rng.choice(shards, size=2, replace=False)
            dr = int(self.rng.choice(self.by_shard[int(a)]))
            cr = int(self.rng.choice(self.by_shard[int(b)]))
            return dr, cr, int(a), int(b)
        shards = [
            s for s in range(self.n_shards)
            if self.pools.get((s, ledger))
        ]
        a, b = self.rng.choice(shards, size=2, replace=False)
        dr = int(self.rng.choice(self.pools[(int(a), ledger)]))
        cr = int(self.rng.choice(self.pools[(int(b), ledger)]))
        return dr, cr, int(a), int(b)

    def _ready(self) -> bool:
        if self.tenants == 1:
            return (
                sum(1 for ids in self.by_shard.values() if len(ids) >= 2)
                >= self.n_shards
            )
        # Every tenant needs a local pair somewhere AND presence on
        # two distinct shards (for the cross-shard leg).
        for ledger in range(1, self.tenants + 1):
            if not any(
                len(self.pools.get((s, ledger), ())) >= 2
                for s in range(self.n_shards)
            ):
                return False
            if sum(
                1 for s in range(self.n_shards)
                if self.pools.get((s, ledger))
            ) < 2:
                return False
        return True

    def next_request(self):
        """-> (operation, body, kind); kind in accounts/local/cross/
        post_void/lookup."""
        if not self._ready() or self.rng.random() < 0.06:
            return self._new_accounts(int(self.rng.integers(2, 5)))
        roll = self.rng.random()
        # 0 = frozen single-tenant path (ledger defaults on the rows);
        # >0 = the flood-biased tenant whose pools the pickers filter.
        ledger = self._pick_tenant() if self.tenants > 1 else 0
        if roll < self.cross_ratio:
            dr, cr, ds, cs = self._pick_cross_pair(ledger)
            rows = []
            for _ in range(int(self.rng.integers(1, 4))):
                tid = self.next_transfer
                self.next_transfer += 1
                self.xfers.append((tid, ds, cs))
                amount = int(self.rng.integers(1, 100))
                self.xfer_amount[tid] = amount
                self.xfer_debitor[tid] = dr
                rows.append(transfer(
                    tid, debit_account_id=dr, credit_account_id=cr,
                    amount=amount, ledger=ledger or 1,
                ))
            return types.Operation.create_transfers, pack(rows), "cross"
        if roll < self.cross_ratio + 0.30:
            dr, cr, _s = self._pick_local_pair(ledger)
            rows = []
            for _ in range(int(self.rng.integers(1, 5))):
                tid = self.next_transfer
                self.next_transfer += 1
                rows.append(transfer(
                    tid, debit_account_id=dr, credit_account_id=cr,
                    amount=int(self.rng.integers(1, 100)),
                    ledger=ledger or 1,
                ))
            return types.Operation.create_transfers, pack(rows), "local"
        if roll < self.cross_ratio + 0.42:
            dr, cr, s = self._pick_local_pair(ledger)
            tid = self.next_transfer
            self.next_transfer += 1
            self.pending_local.append((tid, s, ledger or 1))
            return (
                types.Operation.create_transfers,
                pack([transfer(tid, debit_account_id=dr,
                               credit_account_id=cr,
                               amount=int(self.rng.integers(1, 50)),
                               ledger=ledger or 1,
                               flags=types.TransferFlags.pending)]),
                "local",
            )
        if roll < self.cross_ratio + 0.52 and self.pending_local:
            pid, _s, pledger = self.pending_local.pop(
                int(self.rng.integers(len(self.pending_local)))
            )
            tid = self.next_transfer
            self.next_transfer += 1
            void = self.rng.random() < 0.3
            flags = (
                types.TransferFlags.void_pending_transfer if void
                else types.TransferFlags.post_pending_transfer
            )
            return (
                types.Operation.create_transfers,
                pack([transfer(tid, pending_id=pid, ledger=pledger,
                               flags=flags)]),
                "post_void",
            )
        ids = [
            int(v) for v in self.rng.choice(
                self.account_ids, size=min(4, len(self.account_ids))
            )
        ]
        return types.Operation.lookup_accounts, ids_bytes(ids), "lookup"


class ShardedVopr:
    """Deterministic whole-system fuzz of the sharded router: per-shard
    nemeses (replica crash losing unsynced sectors, crash INSIDE a
    covering fsync, partitions, optional device loss) plus the
    coordinator-kill nemesis, with conservation-of-money and 2PC
    atomicity checked at every audit point and an oracle replay at the
    end."""

    AUDIT_EVERY = 41  # steps between mid-run invariant audits

    @property
    def _chaos_links(self) -> list:
        """Flattened per-shard chaos links (factories append lazily)."""
        return [lk for links in self._chaos_link_lists for lk in links]

    def __init__(self, seed: int, *, n_shards: int = 2,
                 replica_count: int = 2, requests: int = 30,
                 packet_loss: float = 0.01,
                 crash_probability: float = 0.004,
                 fsync_crash_probability: float = 0.002,
                 partition_probability: float = 0.004,
                 coordinator_kill_probability: float = 0.004,
                 device_loss_probability: float = 0.0,
                 cross_ratio: float = 0.35,
                 tenants: int = 1,
                 tenant_qos: dict | None = None) -> None:
        self.seed = seed
        self.rng = np.random.default_rng(seed + 1)
        factories = None
        # Per-shard link lists, populated LAZILY by the factories as
        # machines are built — flatten at use time, not here.
        self._chaos_link_lists: list[list] = []
        if device_loss_probability > 0.0:
            from tigerbeetle_tpu_torch.testing.chaos import device_chaos_factory

            factories = []
            for s in range(n_shards):
                factory, links = device_chaos_factory(seed + 40 + s)
                factories.append(factory)
                self._chaos_link_lists.append(links)
        self.cluster = ShardedCluster(
            n_shards, replica_count=replica_count, seed=seed,
            options=PacketOptions(packet_loss_probability=packet_loss),
            state_machine_factories=factories,
            tenant_qos=tenant_qos,
        )
        self.workload = ShardedWorkload(seed + 2, n_shards,
                                        cross_ratio=cross_ratio,
                                        tenants=tenants)
        self.requests = requests
        self.crash_probability = crash_probability
        self.fsync_crash_probability = fsync_crash_probability
        self.partition_probability = partition_probability
        self.coordinator_kill_probability = coordinator_kill_probability
        self.device_loss_probability = device_loss_probability
        self.crashed: set[tuple[int, int]] = set()  # (shard, replica)
        # With no shard nemeses in the mix, a cross-shard abort needs a
        # coordinator kill to be legal; under the full mix, a long
        # stall can legitimately expire a hold.
        self._strict_cross = (
            crash_probability == 0 and fsync_crash_probability == 0
            and partition_probability == 0 and packet_loss == 0
            and device_loss_probability == 0
        )
        self._partitioned: dict[int, set[int]] = {}
        self._fsync_armed: tuple[int, int] | None = None
        self.coordinator_kills = 0
        # Requests whose submit/reply window overlapped a coordinator
        # kill may legally abort with pending_transfer_expired.
        self._kill_epoch = 0
        self.audits = 0
        # The reported-ok logical stream, for the oracle replay:
        # (operation, body, per-row ok mask).
        self.ok_stream: list[tuple[types.Operation, bytes, list[bool]]] = []

    # -- nemesis -------------------------------------------------------

    def _nemesis(self) -> None:
        c = self.cluster
        # Coordinator kill/restart: the defining nemesis of this VOPR.
        if c.router is None:
            if self.rng.random() < 0.08:
                c.start_router()  # recovery runs before/while serving
        elif self.rng.random() < self.coordinator_kill_probability:
            c.kill_router()
            self.coordinator_kills += 1
            self._kill_epoch += 1
        for s, shard in enumerate(c.shards):
            # Partition / heal, per shard.
            parts = self._partitioned.setdefault(s, set())
            if parts:
                if self.rng.random() < 0.05:
                    shard.network.heal(*parts)
                    parts.clear()
            elif self.rng.random() < self.partition_probability:
                i = int(self.rng.integers(len(shard.replicas)))
                if (s, i) not in self.crashed:
                    shard.network.partition(i)
                    parts.add(i)
            # Crash (power loss: unsynced sectors gone) / restart.
            down = [r for (sh, r) in self.crashed if sh == s]
            if down:
                if self.rng.random() < 0.06:
                    i = down[0]
                    shard.restart_replica(i)
                    self.crashed.discard((s, i))
            elif self.rng.random() < self.crash_probability:
                i = int(self.rng.integers(len(shard.replicas)))
                if i not in parts:
                    shard.crash_replica(i)
                    self.crashed.add((s, i))
            # Crash INSIDE a covering fsync (storage fault point).
            if self._fsync_armed is None and not down and (
                self.rng.random() < self.fsync_crash_probability
            ):
                i = int(self.rng.integers(len(shard.replicas)))
                if (s, i) not in self.crashed and i not in parts:
                    shard.storages[i].crash_at_fsync = 1
                    self._fsync_armed = (s, i)
        if self.device_loss_probability and self._chaos_links:
            downed = [lk for lk in self._chaos_links if lk.down]
            if downed:
                if self.rng.random() < 0.10:
                    for lk in downed:
                        lk.heal()
            elif self.rng.random() < self.device_loss_probability:
                pick = int(self.rng.integers(len(self._chaos_links)))
                self._chaos_links[pick].kill()

    def _step(self) -> None:
        try:
            self.cluster.step()
        except FsyncCrash:
            # The armed replica died inside its fsync: finish the crash
            # (its unsynced sectors are gone with it).
            assert self._fsync_armed is not None
            s, i = self._fsync_armed
            self._fsync_armed = None
            self.cluster.shards[s].crash_replica(i)
            self.crashed.add((s, i))

    # -- audits --------------------------------------------------------

    def _audit_point(self) -> None:
        self.audits += 1
        self.cluster.check_conservation()
        self.cluster.check_atomicity(self.workload.xfers)

    def _audit_reply(self, kind: str, body: bytes, reply: bytes,
                     submitted_epoch: int) -> None:
        if kind == "lookup":
            return
        results = np.frombuffer(reply, dtype=types.CREATE_RESULT_DTYPE)
        for r in results:
            code = int(r["result"])
            idx = int(r["index"])
            if kind == "cross" and code == int(
                types.CreateTransferResult.pending_transfer_expired
            ) and (not self._strict_cross
                   or submitted_epoch != (self._kill_epoch, True)):
                # Legal abort: the coordinator died between this
                # transfer's holds and its decision, the request raced
                # a restarted coordinator's still-running in-doubt
                # recovery, or a nemesis stalled the 2PC past the hold
                # timeout.  With every nemesis off (_strict_cross) an
                # abort is only legal when a kill overlapped the
                # request.
                continue
            raise AssertionError(
                f"{kind} request row {idx} failed with "
                f"{types.CreateTransferResult(code).name} "
                f"(kills={self.coordinator_kills})"
            )

    # -- run -----------------------------------------------------------

    def run(self) -> None:
        c = self.cluster
        client = c.client(9000 + self.seed % 100)
        client.register()
        c.run_until(lambda: client.registered, max_steps=6000)

        sent = 0
        guard = 0
        pending_audit = None
        while sent < self.requests or client.busy():
            guard += 1
            assert guard < 400_000, "sharded vopr stalled"
            self._nemesis()
            if not client.busy() and c.router is not None:
                if pending_audit is not None:
                    op, body, kind, epoch = pending_audit
                    self._audit_reply(kind, body, client.reply, epoch)
                    self._record_ok(op, body, kind, client.reply)
                    pending_audit = None
                if sent < self.requests:
                    op, body, kind = self.workload.next_request()
                    client.request(op, body)
                    # Submit context for the audit: the kill epoch AND
                    # whether recovery had already finished — an abort
                    # is only a finding when neither a kill nor a live
                    # recovery overlapped the request.
                    settled = (
                        c.router._recovery is None
                        or c.router.recovery_result is not None
                    )
                    pending_audit = (
                        op, body, kind, (self._kill_epoch, settled)
                    )
                    sent += 1
            self._step()
            if guard % self.AUDIT_EVERY == 0:
                self._audit_point()
        if pending_audit is not None:
            op, body, kind, epoch = pending_audit
            self._audit_reply(kind, body, client.reply, epoch)
            self._record_ok(op, body, kind, client.reply)

        # Heal everything, finish recovery, settle, final checks.
        if self._fsync_armed is not None:
            # Disarm an unfired fault: the quiesce phase below must
            # not crash a replica outside the nemesis loop.
            s, i = self._fsync_armed
            c.shards[s].storages[i].crash_at_fsync = None
            self._fsync_armed = None
        for lk in self._chaos_links:
            lk.heal()
        for s, shard in enumerate(c.shards):
            shard.network.heal()
            self._partitioned.get(s, set()).clear()
        for s, i in sorted(self.crashed):
            c.shards[s].restart_replica(i)
        self.crashed.clear()
        if c.router is None:
            c.start_router()
        c.settle(max_steps=40_000)
        self._audit_point()
        c.check_shards()
        c.check_atomicity(self.workload.xfers, final=True)
        # Final proof-of-state audit: per-shard roots agree across
        # replicas, the folded cluster commitment is well-defined, and
        # the router's query path folds to the same value.
        folded = c.check_cluster_commitment()
        if c.router is not None:
            from tigerbeetle_tpu_torch.state_machine import commitment as _cm

            root, _n = _cm.parse_root_body(c.router.query_cluster_root())
            assert root == folded, (root.hex(), folded.hex())
        self.oracle_compare()

    def _record_ok(self, op, body: bytes, kind: str, reply: bytes) -> None:
        if kind not in ("accounts", "local", "cross", "post_void"):
            return
        dtype = (
            types.ACCOUNT_DTYPE if kind == "accounts"
            else types.TRANSFER_DTYPE
        )
        n = len(body) // dtype.itemsize
        ok = [True] * n
        for r in np.frombuffer(reply, dtype=types.CREATE_RESULT_DTYPE):
            ok[int(r["index"])] = False
        self.ok_stream.append((op, body, ok))

    def oracle_compare(self) -> None:
        """Replay the reported-ok stream through a single-node CPU
        oracle and require every client account's balances to match the
        sharded reality exactly — cross-shard transfers included."""
        from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness

        oracle = SingleNodeHarness(CpuStateMachine(self.cluster.config))
        for op, body, ok in self.ok_stream:
            dtype = (
                types.ACCOUNT_DTYPE if op == types.Operation.create_accounts
                else types.TRANSFER_DTYPE
            )
            rows = np.frombuffer(body, dtype=dtype)
            keep = [rows[i] for i in range(len(rows)) if ok[i]]
            if not keep:
                continue
            out = oracle.submit(op, pack(keep))
            results = np.frombuffer(out, dtype=types.CREATE_RESULT_DTYPE)
            assert len(results) == 0, (
                "oracle rejected a reported-ok row", op, results[:4],
            )
        # A compensated cross-shard transfer (decided commit whose
        # credit hold died — budget violation) is a reversing entry,
        # not an erasure: the debitor shows the posted debit AND the
        # refunding credit.  Fold those trail entries into the oracle's
        # expectation.
        adjust: dict[int, int] = {}
        compensated = 0
        for tid, ds, cs in self.workload.xfers:
            _sd, _sc, comp = self.cluster.cross_status(tid, ds, cs)
            if comp:
                compensated += 1
                debitor = self.workload.xfer_debitor[tid]
                adjust[debitor] = (
                    adjust.get(debitor, 0) + self.workload.xfer_amount[tid]
                )
        self.compensations = compensated
        for aid in self.workload.account_ids:
            shard = types.shard_of_account(aid, self.cluster.n_shards)
            got = self.cluster._live_sm(shard).account_balances_raw(aid)
            dp, dpo, cp, cpo = oracle.sm.account_balances_raw(aid)
            extra = adjust.get(aid, 0)
            want = (dp, dpo + extra, cp, cpo + extra)
            assert got == want, (aid, shard, got, want)


# ----------------------------------------------------------------------
# Follower nemesis VOPR: root-attested follower serving
# under crash / torn tail / corruption / partition / lag.


class FollowerVopr:
    """Adversarial proof of the follower robustness contract.

    A 2-replica cluster commits a seeded workload while replica 0's
    SimAof feeds a SimFollower; reads are attempted against the
    follower throughout.  Nemeses (all seeded):

    - follower crash/restart mid-tail (volatile state re-derives from
      the log, serving re-gated on fresh attestation),
    - upstream replica crash — power loss AND crash-INSIDE-fsync
      (storage.crash_at_fsync) — both tearing the AOF's unsynced
      tail, healed by repair-on-open + recovery gap-fill,
    - seeded corruption of a tailed-log byte (latent sector error),
    - partition follower <-> upstream (attestations stop; staleness
      refusals take over),
    - lag injection (replay paused under continued commits).

    THE invariant (check_never_lied): no served reply ever carries a
    (root, commit_min) differing from the cluster's committed root at
    that op — every nemesis may only produce refusals/redirects.
    """

    def __init__(self, seed: int, *, replica_count: int = 2,
                 request_count: int = 120, staleness_ops: int = 24,
                 corruption_probability: float = 0.0015,
                 follower_crash_probability: float = 0.004,
                 partition_probability: float = 0.008,
                 pause_probability: float = 0.008,
                 crash_probability: float = 0.002,
                 fsync_crash_probability: float = 0.001) -> None:
        from tigerbeetle_tpu_torch.testing.cluster import SimFollower

        self.seed = seed
        self.rng = np.random.default_rng(seed ^ 0xF0110)
        self.cluster = Cluster(
            replica_count=replica_count, seed=seed,
            aof_replicas=(0,), root_ring=1 << 20,
        )
        self.follower = SimFollower(
            self.cluster, 0, staleness_ops=staleness_ops,
            attest_every=4,
        )
        self.workload = Workload(seed)
        self.request_count = request_count
        self.corruption_probability = corruption_probability
        self.follower_crash_probability = follower_crash_probability
        self.partition_probability = partition_probability
        self.pause_probability = pause_probability
        self.crash_probability = crash_probability
        self.fsync_crash_probability = fsync_crash_probability
        # Nemesis state/coverage.
        self.crashed: set[int] = set()
        self._fsync_armed: int | None = None
        self.follower_crashes = 0
        self.upstream_crashes = 0
        self.fsync_crashes = 0
        self.corruptions = 0
        self.partitions = 0
        self.pauses = 0
        self.reads_attempted = 0
        self.reads_served = 0
        self.reads_fallback = 0  # refused -> redirected to primary

    # -- nemesis --------------------------------------------------------

    def _nemesis(self) -> None:
        c = self.cluster
        f = self.follower
        rng = self.rng
        # Follower crash/restart mid-tail.
        if rng.random() < self.follower_crash_probability:
            f.crash_restart()
            self.follower_crashes += 1
        # Partition follower <-> upstream.
        if f.partitioned:
            if rng.random() < 0.05:
                f.partitioned = False
        elif rng.random() < self.partition_probability:
            f.partitioned = True
            self.partitions += 1
        # Lag injection: replay paused while commits continue.
        if f.paused:
            if rng.random() < 0.05:
                f.paused = False
        elif rng.random() < self.pause_probability:
            f.paused = True
            self.pauses += 1
        # Seeded corruption of a tailed-log byte.
        if rng.random() < self.corruption_probability:
            if c.aofs[0].corrupt(rng) is not None:
                self.corruptions += 1
        # Upstream crash (power loss, torn AOF tail) / restart.
        if self.crashed:
            if rng.random() < 0.06:
                i = self.crashed.pop()
                c.restart_replica(i)
            return
        if rng.random() < self.crash_probability:
            i = int(rng.integers(len(c.replicas)))
            c.crash_replica(i)
            self.upstream_crashes += i == 0
            self.crashed.add(i)
            return
        # Crash INSIDE a covering fsync (storage fault point): the
        # sharpest torn-tail producer — the process dies with the WAL
        # sync half-applied AND the AOF suffix unsynced.
        if self._fsync_armed is None and (
            rng.random() < self.fsync_crash_probability
        ):
            i = int(rng.integers(len(c.replicas)))
            c.storages[i].crash_at_fsync = 1
            self._fsync_armed = i

    def _step(self) -> None:
        try:
            self.cluster.step()
        except FsyncCrash:
            assert self._fsync_armed is not None
            i = self._fsync_armed
            self._fsync_armed = None
            self.cluster.crash_replica(i)
            self.upstream_crashes += i == 0
            self.fsync_crashes += 1
            self.crashed.add(i)

    # -- reads ----------------------------------------------------------

    def _try_read(self) -> None:
        """One steered read: follower first; a refusal 'redirects' to
        a live replica's state machine (the router fallback, modeled
        transport-free)."""
        from tigerbeetle_tpu_torch.runtime.follower import FollowerReply

        w = self.workload
        if not w.account_ids:
            return
        ids = [
            int(v) for v in self.rng.choice(
                w.account_ids, size=min(4, len(w.account_ids))
            )
        ]
        body = ids_bytes(ids)
        self.reads_attempted += 1
        result = self.follower.read(types.Operation.lookup_accounts, body)
        if isinstance(result, FollowerReply):
            self.reads_served += 1
        else:
            self.reads_fallback += 1

    # -- run -------------------------------------------------------------

    def run(self) -> None:
        c = self.cluster
        client = c.client(0x9F01)
        client.register()
        c.run_until(lambda: not client.busy(), 4000)
        sent = 0
        steps = 0
        while sent < self.request_count:
            steps += 1
            assert steps < 200_000, "follower VOPR stalled"
            self._nemesis()
            if not client.busy() and not client.evicted:
                op, body, _must = self.workload.next_request()
                client.request(op, body)
                sent += 1
            if steps % 7 == 0:
                self._try_read()
            self._step()
        # Quiesce: heal everything, restart the dead, settle.
        if self._fsync_armed is not None:
            c.storages[self._fsync_armed].crash_at_fsync = None
            self._fsync_armed = None
        for i in sorted(self.crashed):
            c.restart_replica(i)
        self.crashed.clear()
        self.follower.partitioned = False
        self.follower.paused = False
        c.network.heal()
        for _ in range(600):
            self._step()
            if not client.busy():
                break
        c.settle(max_steps=8000)
        # Let the follower catch up + re-attest at the quiesced head.
        for _ in range(400):
            self._step()
            if self.follower.core.refuse_reason() is None and (
                self.follower.core.commit_min
                == c.replicas[0].commit_min
            ):
                break

        # THE invariant, unconditionally: refusals allowed, lies never.
        self.follower.check_never_lied()

        core = self.follower.core
        # A follower may end the run un-servable for honest reasons:
        # latched corruption/gap, or a permanently torn tail (e.g.
        # corruption at EOF, or a gap-fill cut short by the
        # checkpoint floor leaves the stream short of its resume
        # offset).  All of those REFUSE; none may lie.
        damaged = core.tail.corrupt or core.gapped or core.poisoned
        stalled = core.commit_min < c.replicas[0].commit_min
        assert not core.poisoned, (
            "deterministic replay of a checksummed log diverged: "
            "poisoned follower without corruption"
        )
        if not damaged and not stalled:
            # Liveness after heal: the follower must serve again, and
            # serve bit-identically to the primary at the same op.
            assert core.refuse_reason() is None, core.refuse_reason()
            assert core.commit_min == c.replicas[0].commit_min
            ids = [int(v) for v in self.workload.account_ids[:8]]
            body = ids_bytes(ids)
            from tigerbeetle_tpu_torch.runtime.follower import FollowerReply

            got = self.follower.read(
                types.Operation.lookup_accounts, body
            )
            assert isinstance(got, FollowerReply), got
            want = c.replicas[0].sm.execute_read(
                types.Operation.lookup_accounts, body
            )
            assert got.body == want, "follower read diverged from primary"
            self.follower.check_never_lied()
