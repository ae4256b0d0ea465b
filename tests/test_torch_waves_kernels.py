"""The wave kernels' plain versions against the JAX package's step
functions, from the same carry, bit for bit: K7 (waves._wave_step_keep,
with and without a commit mask), K8 (_chain_step_keep: dead chains,
hub accounts written by several chains), K9 (_spec_conflicts and the
whole _spec_exec step), K3 segments (kernel.scan_segment_keep) resumed
from wave carries, finalize (_finalize_keep) and the carry's image
(kernel.carry_from_dict / carry_to_dict).

After every step the port's carry image must equal carry_from_dict of
the reference's carry and the tables must be equal.  One batch shape
(B = 256 over small tables), so the JAX side compiles each segment
bucket once per module."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tigerbeetle_tpu.state_machine import kernel as rk
from tigerbeetle_tpu.state_machine import waves as rw
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.testing import scan_cases, wave_cases

B = 256


def jax_events(ev):
    return {name: np.asarray(ev[name]).astype(dt) for name, dt in rk.EVENT_FIELDS}


def carry_np(carry) -> dict:
    out = {k: np.asarray(v) for k, v in carry.items() if k not in ("balances", "created")}
    out["created"] = {f: np.asarray(v) for f, v in carry["created"].items()}
    return out


class Pair:
    """The reference's carry and the port's (table, packed events, carry
    image) for one batch, stepped together."""

    def __init__(self, table, ev, dstat, n, ts_base):
        self.ev, self.jev, self.n, self.ts = ev, jax_events(ev), n, ts_base
        self.ref = rk.make_carry(jnp.asarray(table), jnp.asarray(dstat, jnp.uint32), B)
        self.table = torch.from_numpy(table.view(np.int64).copy())
        self.pk = torch.from_numpy(k3.pack_events(ev).view(np.int64))
        self.words = k3.exact_init(torch.empty(k3.scratch_words(B), dtype=torch.int64),
                                   torch.from_numpy(dstat.view(np.int32).copy()))
        self.check("init")

    def check(self, what):
        want = k3.carry_from_dict(carry_np(self.ref))
        got = self.words.numpy().view(np.uint64)
        bad = np.flatnonzero(want != got)
        assert len(bad) == 0, f"{what}: carry words differ from region {bad[0] // B}"
        np.testing.assert_array_equal(self.table.numpy().view(np.uint64),
                                      np.asarray(self.ref["balances"]), err_msg=what)

    def jn(self):
        return jnp.int32(self.n), jnp.uint64(self.ts)

    def wave(self, idx, mask=None):
        seg = rw._gather_events(self.jev, idx, rw._bucket(len(idx)), B)
        kw = {}
        if mask is not None:
            m = np.zeros(rw._bucket(len(idx)), bool)
            m[:len(idx)] = mask
            kw["commit_mask"] = jnp.asarray(m)
        self.ref = rw._wave_step_keep(self.ref, seg, *self.jn(), **kw)
        waves.wave_step(self.table, self.pk, self.words, torch.from_numpy(
            np.asarray(idx, np.int32)), self.n, self.ts,
            mask=None if mask is None else torch.from_numpy(mask.astype(np.uint8)))
        self.check("wave")

    def chains(self, idx, steps):
        seg = rw._gather_chain_events(self.jev, idx, steps, self.n, B)
        self.ref = rw._chain_step_keep(self.ref, seg, *self.jn())
        plane = torch.from_numpy(waves._chain_plane(self.ev["flags"], idx, steps, B))
        waves.chain_wave(self.table, self.pk, self.words, plane, self.n, self.ts)
        self.check("chains")

    def scan(self, idx):
        seg = rw._gather_events(self.jev, idx, rw._bucket(len(idx)), B)
        self.ref = rk.scan_segment_keep(self.ref, seg, jnp.asarray(self.jev["id_group"]),
                                        *self.jn())
        k3.scan_segment(self.table, self.pk, self.words,
                        torch.from_numpy(np.asarray(idx, np.int32)), self.n, self.ts)
        self.check("scan segment")

    def run(self, plan):
        for k, (kind, idx) in enumerate(plan.segments):
            if kind == "wave":
                self.wave(idx)
            elif kind == "chains":
                self.chains(idx, plan.chain_steps[k])
            else:
                self.scan(idx)

    def finalize(self, hist_fix):
        bal, packed = rw._finalize_keep(self.ref, jnp.asarray(hist_fix))
        out = k3.finalize(self.table, self.words, B, torch.from_numpy(hist_fix.astype(np.uint8)))
        np.testing.assert_array_equal(out.numpy().view(np.uint64), np.asarray(packed))
        np.testing.assert_array_equal(self.table.numpy().view(np.uint64), np.asarray(bal))
        return k3.unpack_outputs(out.numpy().view(np.uint64))


def _mask(plan, n):
    fix = np.zeros(B, bool)
    fix[:n] = plan.wave_mask
    return fix


@pytest.mark.parametrize("cls", scan_cases.CLASSES)
def test_plan_steps_match_jax(cls):
    """Waves, scan segments (resumed from wave carries) and finalize."""
    kinds, codes = set(), set()
    for seed in range(3):
        table, ev, dstat, n, ts_base, plan = wave_cases.plan_case(
            900 + 7 * seed + scan_cases.CLASSES.index(cls), B, cls)
        pair = Pair(table, ev, dstat, n, ts_base)
        pair.run(plan)
        out = pair.finalize(_mask(plan, n))
        kinds |= {k for k, _ in plan.segments}
        codes |= set(out["results"][:n].tolist())
    assert "wave" in kinds and len(codes) > 3


@pytest.mark.parametrize("seed", range(4))
def test_chain_wave_matches_jax(seed):
    """K8's plain version: chains dying on static codes, durable
    duplicates, balancing clamps and limits, an open tail; hub accounts
    credited by many chains."""
    table, ev, dstat, n, ts_base, plan = wave_cases.chain_case(seed, 40, B)
    pair = Pair(table, ev, dstat, n, ts_base)
    pair.run(plan)
    out = pair.finalize(_mask(plan, n))
    res = out["results"][:n]
    assert (res == 1).any() and (res == 0).any()  # dead and live chains
    assert res[n - 1] == 2 or (res[n - 1] == 1)    # the open tail
    hub_cr = np.bincount(ev["cr_slot"][:n])
    assert hub_cr.max() > 2  # a slot written by several chains


@pytest.mark.parametrize("seed", range(3))
def test_wave_step_commit_mask_matches_jax(seed):
    """K7 with a commit mask: masked lanes write nothing at all."""
    table, ev, dstat, n, ts_base, plan = wave_cases.wide_case(seed, B, 4096)
    idx = np.asarray(plan.segments[0][1])
    mask = np.random.default_rng(seed).random(len(idx)) < 0.6
    pair = Pair(table, ev, dstat, n, ts_base)
    pair.wave(idx[: len(idx) // 2], mask[: len(idx) // 2])
    pair.wave(idx[len(idx) // 2:])  # unmasked, from the masked carry
    pair.finalize(_mask(plan, n))


@pytest.mark.parametrize("cls", ["mixed", "post_void", "balancing", "limits", "exists"])
def test_speculative_step_matches_jax(cls):
    """K9 against _spec_conflicts, then the whole speculative step
    (fresh carry, validation, masked K7) against _spec_exec, then the
    residue plan from that carry and finalize, as the engine runs it."""
    from tigerbeetle_tpu_torch.state_machine import resolve

    table, ev, dstat, n, ts_base = scan_cases.make_case(
        40 + scan_cases.CLASSES.index(cls), B, cls)
    rng = np.random.default_rng(1)
    meta = resolve.spec_meta_from_events(ev, n, False)
    serial = np.zeros(B, bool)  # the engine's: chain members, plus a few
    serial[:n] = meta["chain_member"] | (rng.random(n) < 0.05)
    jev = jax_events(ev)
    seg = rw._gather_events(jev, np.arange(n), B, B)
    ss = jnp.asarray(serial)
    want = np.asarray(rw._spec_conflicts(seg, ss, jnp.int32(n), table.shape[0], B))[:n]
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64))
    idx = torch.arange(n, dtype=torch.int32)
    got = waves.spec_conflicts(pk, idx, torch.from_numpy(serial[:n].astype(np.uint8)), n,
                               table.shape[0])
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    assert 0 < want.sum() < n

    ref_carry, ref_confl = rw._spec_exec(
        jnp.asarray(table), seg, jnp.asarray(dstat, jnp.uint32), ss, jnp.int32(n),
        jnp.uint64(ts_base))
    t = torch.from_numpy(table.view(np.int64).copy())
    carry, confl = waves.run_speculative_engine(t, ev, dstat, serial, n, ts_base)
    np.testing.assert_array_equal(confl.numpy().astype(bool), np.asarray(ref_confl)[:n])
    pair = Pair.__new__(Pair)
    pair.ev, pair.jev, pair.n, pair.ts = ev, jev, n, ts_base
    pair.ref, pair.table, pair.pk, pair.words = ref_carry, t, carry.events, carry.words
    pair.check("speculative step")
    residue = np.flatnonzero(want)
    plan = waves.plan_residue(n, meta, residue)
    pair.run(plan)
    fix = np.zeros(B, bool)
    fix[:n] = ~want | plan.wave_mask
    pair.finalize(fix)


def _spec_against_jax(ev, n, serial, A):
    """K9's plain version (through the wrapper, CPU tensors) and the
    reference's _spec_conflicts on one batch: both flags."""
    seg = rw._gather_events(jax_events(ev), np.arange(n), B, B)
    want = np.asarray(rw._spec_conflicts(seg, jnp.asarray(serial.astype(bool)), jnp.int32(n),
                                         A, B))[:n]
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64))
    got = waves.spec_conflicts(pk, torch.arange(n, dtype=torch.int32),
                               torch.from_numpy(serial[:n].copy()), n, A)
    return got.numpy().astype(bool), want


def test_spec_conflicts_stream_matches_jax():
    """Consecutive K9 batches of seven classes over one row pool, each
    reusing the slots, groups and targets of the batches before it (the
    card test runs the same stream back to back through one scratch):
    the plain version against _spec_conflicts, batch by batch."""
    A = 61
    blocked = []
    for ev, n, serial in wave_cases.spec_stream(11, 7, B, A):
        got, want = _spec_against_jax(ev, n, serial, A)
        np.testing.assert_array_equal(got, want)
        blocked.append(int(want.sum()))
    assert all(0 < b for b in blocked)


def test_spec_conflicts_distinct_slots_match_jax():
    """A batch whose slots, groups and targets are all distinct: only
    the serial mask blocks a lane."""
    A = 4 * B + 3
    ev, n, serial = wave_cases.distinct_spec_case(12, B, A)
    got, want = _spec_against_jax(ev, n, serial, A)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, serial[:n].astype(bool))


def test_carry_image_round_trip():
    """carry_to_dict(carry_from_dict(c)) == c for a mid-batch carry, in
    the reference's dtypes."""
    table, ev, dstat, n, ts_base, plan = wave_cases.plan_case(5, B, "linked")
    pair = Pair(table, ev, dstat, n, ts_base)
    pair.run(plan)
    want = carry_np(pair.ref)
    got = k3.carry_to_dict(pair.words, B)
    assert got.keys() == want.keys()
    for key, val in want.items():
        if key == "created":
            for f, col in val.items():
                np.testing.assert_array_equal(got[key][f], col)
                assert got[key][f].dtype == col.dtype, f
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)
            assert np.asarray(got[key]).dtype == val.dtype, key
    np.testing.assert_array_equal(k3.carry_from_dict(got), pair.words.numpy().view(np.uint64))
