"""REPL: interactive / --command client (reference: src/repl.zig).

Statement syntax (same shape as the reference's):

    create_accounts id=1 code=10 ledger=700, id=2 code=10 ledger=700;
    create_transfers id=1 debit_account_id=1 credit_account_id=2
        amount=10 ledger=700 code=10 flags=linked|pending;
    lookup_accounts id=1, id=2;
    get_account_transfers account_id=1 limit=10;

Objects are comma-separated; `flags` takes |-separated names.  Output
is JSON-ish, one object per line.

This package's own copy of ``tigerbeetle_tpu/repl.py``.
"""
# tbcheck: allow-file(no-print): the REPL's stdout is the user
# conversation.

from __future__ import annotations

import json
import sys

import numpy as np

from tigerbeetle_tpu_torch import types

OPERATIONS = {
    "create_accounts", "create_transfers", "lookup_accounts",
    "lookup_transfers", "get_account_transfers", "get_account_balances",
}

_ACCOUNT_U128 = {"id", "debits_pending", "debits_posted", "credits_pending",
                 "credits_posted", "user_data_128"}
_TRANSFER_U128 = {"id", "debit_account_id", "credit_account_id", "amount",
                  "pending_id", "user_data_128"}

_FLAG_TYPES = {
    "create_accounts": types.AccountFlags,
    "create_transfers": types.TransferFlags,
    "get_account_transfers": types.AccountFilterFlags,
    "get_account_balances": types.AccountFilterFlags,
}


def parse_statement(statement: str) -> tuple[str, list[dict]]:
    statement = statement.strip().rstrip(";").strip()
    if not statement:
        raise ValueError("empty statement")
    parts = statement.split(None, 1)
    operation = parts[0]
    if operation not in OPERATIONS:
        raise ValueError(f"unknown operation {operation!r}")
    objects: list[dict] = []
    rest = parts[1] if len(parts) > 1 else ""
    for chunk in rest.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        obj: dict = {}
        for pair in chunk.split():
            key, eq, value = pair.partition("=")
            if not eq:
                raise ValueError(f"expected key=value, got {pair!r}")
            if key == "flags":
                flag_type = _FLAG_TYPES.get(operation)
                if flag_type is None:
                    raise ValueError("flags not valid here")
                bits = 0
                for name in value.split("|"):
                    bits |= int(flag_type[name.strip()])
                obj[key] = bits
            else:
                obj[key] = int(value, 0)
        if obj:
            objects.append(obj)
    return operation, objects


def _row_to_dict(row: np.void, u128_fields: set[str]) -> dict:
    out = {}
    done = set()
    for name in row.dtype.names:
        if name.endswith("_lo"):
            base = name[:-3]
            if base in u128_fields:
                out[base] = types.u128_get(row, base)
                done.add(base)
                continue
        if name.endswith("_hi") and name[:-3] in done:
            continue
        if name == "reserved":
            continue
        value = row[name]
        out[name] = int(value) if np.isscalar(value) or value.shape == () else None
    return out


def execute(client, statement: str) -> list[dict]:
    """Run one statement against a Client; returns printable objects."""
    operation, objects = parse_statement(statement)
    if operation == "create_accounts":
        results = client.create_accounts(objects)
        return [{"index": i, "result": r.name} for i, r in results]
    if operation == "create_transfers":
        results = client.create_transfers(objects)
        return [{"index": i, "result": r.name} for i, r in results]
    if operation in ("lookup_accounts", "lookup_transfers"):
        ids = [obj["id"] for obj in objects]
        rows = (
            client.lookup_accounts(ids) if operation == "lookup_accounts"
            else client.lookup_transfers(ids)
        )
        u128 = _ACCOUNT_U128 if operation == "lookup_accounts" else _TRANSFER_U128
        return [_row_to_dict(r, u128) for r in rows]
    # Query filters take exactly one object.
    if len(objects) != 1:
        raise ValueError(f"{operation} takes exactly one filter object")
    kw = dict(objects[0])
    account_id = kw.pop("account_id")
    if operation == "get_account_transfers":
        rows = client.get_account_transfers(account_id, **kw)
        return [_row_to_dict(r, _TRANSFER_U128) for r in rows]
    rows = client.get_account_balances(account_id, **kw)
    return [
        _row_to_dict(r, {"debits_pending", "debits_posted", "credits_pending",
                         "credits_posted"})
        for r in rows
    ]


def run(client, command: str | None = None,
        stdin=None, stdout=None) -> None:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout

    def run_one(statement: str) -> None:
        statement = statement.strip()
        if not statement:
            return
        try:
            for obj in execute(client, statement):
                print(json.dumps(obj), file=stdout)
            print("ok", file=stdout)
        except (ValueError, KeyError, OSError) as e:
            print(f"error: {e}", file=stdout)

    if command is not None:
        for statement in command.split(";"):
            run_one(statement)
        return
    buffer = ""
    for line in stdin:
        buffer += line
        while ";" in buffer:
            statement, _, buffer = buffer.partition(";")
            run_one(statement)
