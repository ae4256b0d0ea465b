"""K3 finalize's plain version (tigerbeetle_tpu_torch/state_machine/
kernel.py finalize_plain, reached through the finalize wrapper on CPU
tensors) against the JAX package's waves._finalize_keep, from the same
seeded carry, bit for bit: batches whose size is neither even nor a
multiple of the kernel's 32-row tile, with no row, every row or a third
of the rows fixed, rewritten rows at created slots that clip (-1 and
>= A), on a compact table and a wider one.  The table comes back
untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.state_machine import waves as rw
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.testing import wave_cases


def reference(table, words, B, hist_fix):
    carry = {k: v if k == "created" else jnp.asarray(v)
             for k, v in k3.carry_to_dict(words, B).items()}
    carry["created"] = {f: jnp.asarray(v) for f, v in carry["created"].items()}
    carry["balances"] = jnp.asarray(table)
    fix = np.zeros(B, bool) if hist_fix is None else hist_fix
    bal, packed = rw._finalize_keep(carry, jnp.asarray(fix))
    np.testing.assert_array_equal(np.asarray(bal), table)
    return np.asarray(packed)


@pytest.mark.parametrize("fix", wave_cases.FIX_MODES)
@pytest.mark.parametrize("B,A", [(203, 37), (75, 5000)])
def test_finalize_matches_jax(B, A, fix):
    table, words, hist_fix = wave_cases.finalize_case(B + A, B, A, fix)
    want = reference(table, words, B, hist_fix)
    t = torch.from_numpy(table.view(np.int64).copy())
    w = torch.from_numpy(words.view(np.int64).copy())
    hf = None if hist_fix is None else torch.from_numpy(hist_fix.astype(np.uint8))
    out = k3.finalize(t, w, B, hf)
    np.testing.assert_array_equal(out.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(t.numpy().view(np.uint64), table)
    if hist_fix is not None:
        res = k3.carry_views(w, B)["results"].numpy()
        dr = k3.carry_views(w, B)["created"][k3.CREATED_FIELDS.index("dr_slot")].numpy()
        rewritten = hist_fix & (res == 0)
        assert rewritten.any() and ((dr[rewritten] < 0) | (dr[rewritten] >= A)).any()


def test_finalize_without_fix_equals_an_empty_fix():
    """hist_fix None (the kernel's null pointer) and an all-zero mask
    give the same packed outputs."""
    B, A = 203, 37
    table, words, _ = wave_cases.finalize_case(7, B, A, "none")
    t = torch.from_numpy(table.view(np.int64).copy())
    w = torch.from_numpy(words.view(np.int64).copy())
    assert torch.equal(k3.finalize(t, w, B, None),
                       k3.finalize(t, w, B, torch.zeros(B, dtype=torch.uint8)))
