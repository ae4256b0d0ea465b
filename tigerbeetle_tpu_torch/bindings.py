"""Language-binding code generation from the wire types.

The reference generates every client language's type definitions from
the Zig structs/enums by comptime reflection, so there is exactly one
source of truth for the 128-byte wire layouts and the result-code
vocabularies (reference: src/java_bindings.zig, src/go_bindings.zig,
src/dotnet_bindings.zig, src/node_bindings.zig).  Here the source of
truth is types.py (numpy dtypes + IntEnum/IntFlag);
this module emits:

- C header (`tb_types.h`): packed structs with _Static_assert'd sizes,
  enums, and the tb_client C ABI prototypes (native/tb_runtime.cpp).
- TypeScript (`types.ts`): interfaces (u64/u128 as bigint) + enums.
- Go (`types.go`): structs (u128 as [2]uint64 limbs) + typed consts.
- Java (`Types.java`): flag-constant classes + result-code enums for
  the com.tigerbeetle client (clients/java).
- C# (`Types.cs`): [Flags]/value enums for the TigerBeetle dotnet
  client (clients/dotnet).

Run `python -m tigerbeetle_tpu_torch bindings --out DIR` to (re)generate.

This package's own copy of ``tigerbeetle_tpu/bindings.py``.  The files it
writes are byte-equal to the reference's, their "Generated by" lines
included, so either package regenerates the committed ``clients/``.
"""

from __future__ import annotations

import enum

import numpy as np

from tigerbeetle_tpu_torch import types

# (python name, emitted struct name) — u128 limb pairs are collapsed
# into one logical field per language's idiom.
STRUCTS = [
    (types.ACCOUNT_DTYPE, "Account", 128),
    (types.TRANSFER_DTYPE, "Transfer", 128),
    (types.ACCOUNT_BALANCE_DTYPE, "AccountBalance", 128),
    (types.ACCOUNT_FILTER_DTYPE, "AccountFilter", 64),
    (types.CREATE_RESULT_DTYPE, "CreateResult", 8),
]

ENUMS = [
    types.AccountFlags,
    types.TransferFlags,
    types.AccountFilterFlags,
    types.TransferPendingStatus,
    types.CreateAccountResult,
    types.CreateTransferResult,
    types.Operation,
]

_C_TYPES = {"<u8": "uint64_t", "<u4": "uint32_t", "<u2": "uint16_t", "|u1": "uint8_t"}
_GO_TYPES = {"<u8": "uint64", "<u4": "uint32", "<u2": "uint16", "|u1": "uint8"}

# Go enum base types sized to the wire width of the field holding them
# (flags are u16, operation is u8 — reference: src/tigerbeetle.zig).
_GO_ENUM_BASE = {
    "AccountFlags": "uint16",
    "TransferFlags": "uint16",
    "AccountFilterFlags": "uint32",
    "TransferPendingStatus": "uint8",
    "CreateAccountResult": "uint32",
    "CreateTransferResult": "uint32",
    "Operation": "uint8",
}

# Struct fields typed as their enum so Go user code assigns members
# without casts.
_GO_FIELD_ENUM = {
    ("Account", "flags"): "AccountFlags",
    ("Transfer", "flags"): "TransferFlags",
    ("AccountFilter", "flags"): "AccountFilterFlags",
}


def _fields(dtype: np.dtype):
    """-> [(name, dtype_str, size)] in offset order, padding included."""
    out = []
    for name in dtype.names:
        sub, _ = dtype.fields[name][:2]
        out.append((name, sub.str.replace(">", "<"), sub.itemsize))
    return out


def _camel(name: str) -> str:
    return "".join(p.capitalize() for p in name.split("_"))


# ---------------------------------------------------------------------------
# C


def emit_c() -> str:
    lines = [
        "// Generated by tigerbeetle_tpu/bindings.py — do not edit.",
        "// Wire layouts are little-endian, 128-byte packed",
        "// (reference: src/tigerbeetle.zig:7-40,80-111,324-340).",
        "#ifndef TB_TYPES_H",
        "#define TB_TYPES_H",
        "",
        "#include <stdint.h>",
        "",
        "#ifdef __cplusplus",
        "#define TB_STATIC_ASSERT(c, m) static_assert(c, m)",
        'extern "C" {',
        "#else",
        "#define TB_STATIC_ASSERT(c, m) _Static_assert(c, m)",
        "#endif",
        "",
    ]
    for e in ENUMS:
        prefix = "TB_" + _snake(e.__name__).upper()
        lines.append("typedef enum {")
        for member in _members(e):
            lines.append(f"    {prefix}_{member.name.upper()} = {member.value},")
        lines.append(f"}} tb_{_snake(e.__name__)}_t;")
        lines.append("")
    lines.append("#pragma pack(push, 1)")
    lines.append("")
    for dtype, name, size in STRUCTS:
        lines.append("typedef struct {")
        for fname, fstr, fsize in _fields(dtype):
            if fstr.startswith("|V"):  # padding / reserved bytes
                lines.append(f"    uint8_t {fname}[{fsize}];")
            else:
                lines.append(f"    {_C_TYPES[fstr]} {fname};")
        lines.append(f"}} tb_{_snake(name)}_t;")
        lines.append(
            f"TB_STATIC_ASSERT(sizeof(tb_{_snake(name)}_t) == {size}, "
            f'"{name} must be {size} bytes");'
        )
        lines.append("")
    lines += [
        "#pragma pack(pop)",
        "",
        "// tb_client session API (exact ABI of native/tb_runtime.cpp).",
        "typedef struct tb_client tb_client_t;",
        "tb_client_t* tb_client_init(const char* host, uint16_t port,",
        "                            uint64_t cluster, uint64_t client_lo,",
        "                            uint64_t client_hi);",
        "void tb_client_deinit(tb_client_t* client);",
        "int64_t tb_client_request(tb_client_t* client, uint8_t operation,",
        "                          const uint8_t* body, uint32_t body_len,",
        "                          uint8_t* reply, uint32_t reply_cap,",
        "                          int timeout_ms);",
        "",
        "#ifdef __cplusplus",
        "}",
        "#endif",
        "#endif // TB_TYPES_H",
        "",
    ]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# TypeScript


def emit_typescript() -> str:
    lines = [
        "// Generated by tigerbeetle_tpu/bindings.py — do not edit.",
        "",
    ]
    # `as const` objects + derived union types instead of TS enums:
    # fully erasable syntax, so the sources run directly under Node's
    # type stripping without a build step.
    for e in ENUMS:
        lines.append(f"export const {e.__name__} = {{")
        for member in _members(e):
            lines.append(f"  {member.name}: {member.value},")
        lines.append("} as const;")
        lines.append(
            f"export type {e.__name__} ="
            f" (typeof {e.__name__})[keyof typeof {e.__name__}];"
        )
        lines.append("")
    for dtype, name, _size in STRUCTS:
        lines.append(f"export interface {name} {{")
        for fname, fstr, size in _merged_u128_fields(dtype):
            if fstr.startswith("|V"):
                continue  # reserved padding is an encoding detail
            ts_type = "bigint" if size >= 8 else "number"
            lines.append(f"  {_lower_camel(fname)}: {ts_type};")
        lines.append("}")
        lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Go


def emit_go() -> str:
    lines = [
        "// Code generated by tigerbeetle_tpu/bindings.py. DO NOT EDIT.",
        "package tigerbeetle",
        "",
    ]
    for e in ENUMS:
        lines.append(f"type {e.__name__} {_GO_ENUM_BASE[e.__name__]}")
        lines.append("const (")
        for member in _members(e):
            lines.append(
                f"\t{e.__name__}{_camel(member.name)} {e.__name__} = {member.value}"
            )
        lines.append(")")
        lines.append("")
    for dtype, name, _size in STRUCTS:
        lines.append(f"type {name} struct {{")
        for fname, fstr, size in _merged_u128_fields(dtype):
            if fstr.startswith("|V"):
                gtype = f"[{size}]uint8"  # reserved padding (ABI layout)
            elif size == 16:
                gtype = "[2]uint64"
            else:
                gtype = _GO_FIELD_ENUM.get((name, fname), _GO_TYPES[fstr])
            lines.append(f"\t{_camel(fname)} {gtype}")
        lines.append("}")
        lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# helpers


def _members(e):
    """Public enum members only — excludes pseudo-members like the
    IntFlag _valid_mask that Python 3.10 includes in iteration."""
    return [m for m in e if not m.name.startswith("_")]


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i and not name[i - 1].isupper():
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def _lower_camel(name: str) -> str:
    c = _camel(name)
    return c[0].lower() + c[1:]


def _merged_u128_fields(dtype: np.dtype):
    """Collapse (x_lo, x_hi) u64 pairs into one 16-byte logical field."""
    fields = _fields(dtype)
    out = []
    i = 0
    while i < len(fields):
        name, fstr, size = fields[i]
        if (
            name.endswith("_lo")
            and i + 1 < len(fields)
            and fields[i + 1][0] == name[:-3] + "_hi"
        ):
            out.append((name[:-3], fstr, 16))
            i += 2
        else:
            out.append((name, fstr, size))
            i += 1
    return out


def emit_java() -> str:
    """Java: one Types holder class — flag sets as int-constant
    classes, result codes as real enums with fromValue (mirrors the
    reference's generated com.tigerbeetle enums —
    src/java_bindings.zig)."""
    lines = [
        "// Generated by tigerbeetle_tpu/bindings.py - do not edit.",
        "package com.tigerbeetle;",
        "",
        "/** Wire-type vocabularies (tigerbeetle_tpu/types.py). */",
        "public final class Types {",
        "    private Types() {}",
    ]
    for e in ENUMS:
        is_flags = issubclass(e, enum.IntFlag)
        if is_flags:
            lines.append("")
            lines.append(f"    public static final class {e.__name__} {{")
            lines.append(f"        private {e.__name__}() {{}}")
            for m in _members(e):
                lines.append(
                    f"        public static final int {_camel(m.name)}"
                    f" = {m.value};"
                )
            lines.append("    }")
        else:
            lines.append("")
            lines.append(f"    public enum {e.__name__} {{")
            members = _members(e)
            for i, m in enumerate(members):
                sep = "," if i + 1 < len(members) else ";"
                lines.append(f"        {_camel(m.name)}({m.value}){sep}")
            lines.append("")
            lines.append("        public final int value;")
            lines.append(f"        {e.__name__}(int value)"
                         " { this.value = value; }")
            lines.append(
                f"        public static {e.__name__} fromValue(int value) {{"
            )
            lines.append(f"            for ({e.__name__} m : values())")
            lines.append("                if (m.value == value) return m;")
            lines.append(
                "            throw new IllegalArgumentException"
                "(\"unknown value \" + value);"
            )
            lines.append("        }")
            lines.append("    }")
    lines.append("}")
    return "\n".join(lines) + "\n"


def emit_csharp() -> str:
    """C#: enums with explicit values ([Flags] for bit sets) — mirrors
    the reference's generated dotnet bindings
    (src/dotnet_bindings.zig)."""
    lines = [
        "// Generated by tigerbeetle_tpu/bindings.py - do not edit.",
        "namespace TigerBeetle;",
        "",
    ]
    base = {
        "AccountFlags": "ushort",
        "TransferFlags": "ushort",
        "AccountFilterFlags": "uint",
        "TransferPendingStatus": "byte",
        "CreateAccountResult": "uint",
        "CreateTransferResult": "uint",
        "Operation": "byte",
    }
    for e in ENUMS:
        is_flags = issubclass(e, enum.IntFlag)
        if is_flags:
            lines.append("[System.Flags]")
        lines.append(f"public enum {e.__name__} : {base[e.__name__]}")
        lines.append("{")
        for m in _members(e):
            lines.append(f"    {_camel(m.name)} = {m.value},")
        lines.append("}")
        lines.append("")
    return "\n".join(lines)


def emit_readme() -> str:
    """Client-facing README for the generated bindings (the reference
    generates per-language client READMEs the same way —
    src/scripts/client_readmes.zig)."""
    return """# tigerbeetle-tpu client bindings

Generated by `python -m tigerbeetle_tpu bindings` from
`tigerbeetle_tpu/types.py` — the single source of truth for the
128-byte little-endian wire layouts and result-code vocabularies.
Do not edit these files; regenerate them.

| File | Use |
|---|---|
| `tb_types.h` | C/C++: packed structs + enums + `tb_client` ABI |
| `types.ts` | TypeScript: enums + interfaces (u64/u128 as `bigint`) |
| `types.go` | Go: typed constants + structs (u128 as `[2]uint64`) |
| `Types.java` | Java: flag constants + result-code enums |
| `Types.cs` | C#: [Flags]/value enums |

The `tb_client` session ABI (`tb_client_init` / `tb_client_request` /
`tb_client_deinit`) is exported by `native/libtb_runtime.so`.

## C quickstart

```c
#include "tb_types.h"
tb_client_t* c = tb_client_init("127.0.0.1", 3000, /*cluster=*/0xC1,
                                /*client_lo=*/42, /*client_hi=*/0);
tb_transfer_t t = {0};
t.id_lo = 1; t.debit_account_id_lo = 1; t.credit_account_id_lo = 2;
t.amount_lo = 100; t.ledger = 1; t.code = 1;
uint8_t reply[4096];
int64_t n = tb_client_request(c, TB_OPERATION_CREATE_TRANSFERS,
                              (const uint8_t*)&t, sizeof t,
                              reply, sizeof reply, 10000);
/* n = reply bytes; 0 means every event succeeded
   (failures arrive as {index u32, result u32} pairs). */
tb_client_deinit(c);
```

For create_accounts/create_transfers the reply contains FAILURES
ONLY (an empty reply means every event succeeded); lookup and query
operations return the found records themselves.
"""


def generate(out_dir: str) -> list[str]:
    import os

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fname, emit in (
        ("tb_types.h", emit_c),
        ("types.ts", emit_typescript),
        ("types.go", emit_go),
        ("Types.java", emit_java),
        ("Types.cs", emit_csharp),
        ("README.md", emit_readme),
    ):
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            f.write(emit())
        written.append(path)
    return written
