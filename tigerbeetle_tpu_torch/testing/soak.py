"""Continuous-fuzzing soak orchestrator (reference: src/scripts/cfo.zig
— the CFO fleet runs seeded VOPR simulators and component fuzzers
around the clock and files whatever falls out).

Runs waves of randomized-parameter VOPR clusters and/or long-round
component fuzzers, one JSONL record per case, and prints a repro
command for every failure:

    python -m tigerbeetle_tpu_torch.testing.soak vopr --n 200 --seed-base 7
    python -m tigerbeetle_tpu_torch.testing.soak fuzz --n 40
    python -m tigerbeetle_tpu_torch.testing.soak all  --n 100 --out soak.jsonl

Every case is fully determined by its printed parameters: a failing
record replays exactly (the VOPR regression tests in
tests/test_vopr.py are pinned soak finds).

This package's own copy of ``tigerbeetle_tpu/testing/soak.py``: it runs
the port's ``Vopr`` and ``FUZZERS``."""
# tbcheck: allow-file(no-print): soak orchestrator — case records
# and repro commands print to the operator by design.

from __future__ import annotations

import argparse
import json
import random
import sys
import traceback


def _vopr_case(rng: random.Random) -> dict:
    return {
        "seed": rng.randrange(1, 1_000_000_000),
        "packet_loss": rng.uniform(0.0, 0.08),
        "crash_probability": rng.uniform(0.0, 0.035),
        "corruption_probability": rng.choice([0.0, 0.001, 0.005, 0.01]),
        "upgrade_nemesis": rng.random() < 0.3,
        "queries": rng.random() < 0.6,
        "replica_count": rng.choice([3, 3, 3, 5]),
        "standby_count": rng.choice([0, 0, 1]),
        "reconfigure_nemesis": rng.random() < 0.5,
        "partition_probability": rng.choice([0.0, 0.01, 0.02]),
        "requests": rng.choice([60, 120]),
    }


def _run_vopr(case: dict) -> None:
    from tigerbeetle_tpu_torch.testing.vopr import Vopr

    kw = dict(case)
    seed = kw.pop("seed")
    Vopr(seed, **kw).run()


def _fuzz_case(rng: random.Random) -> dict:
    from tigerbeetle_tpu_torch.testing.fuzz import FUZZERS

    return {
        "fuzzer": rng.choice(sorted(FUZZERS)),
        "seed": rng.randrange(1, 1_000_000_000),
        "rounds": rng.choice([500, 2000]),
    }


def _run_fuzz(case: dict) -> None:
    from tigerbeetle_tpu_torch.testing.fuzz import FUZZERS

    FUZZERS[case["fuzzer"]](case["seed"], case["rounds"])


_KINDS = {"vopr": (_vopr_case, _run_vopr), "fuzz": (_fuzz_case, _run_fuzz)}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="soak")
    ap.add_argument("kind", choices=[*_KINDS, "all"])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    rng = random.Random(args.seed_base)
    out = open(args.out, "a") if args.out else None
    kinds = list(_KINDS) if args.kind == "all" else [args.kind]
    failures = 0
    for i in range(args.n):
        kind = kinds[i % len(kinds)]
        make, run = _KINDS[kind]
        case = make(rng)
        rec = {"kind": kind, **case}
        try:
            run(case)
            rec["ok"] = True
        # tbcheck: allow(broad-except): the soak fleet's whole job is
        # to record ANY failure as a JSONL repro case and keep going.
        except Exception:
            failures += 1
            rec["ok"] = False
            rec["traceback"] = traceback.format_exc()[-1500:]
            print(f"FAIL {kind} {json.dumps(case)}", file=sys.stderr)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        if (i + 1) % 25 == 0:
            print(f"soak: {i + 1}/{args.n}, failures={failures}", flush=True)
    print(f"soak: done, {args.n - failures}/{args.n} ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
