"""The port's graft entry (tigerbeetle_tpu_torch/graft_entry.py) against
the repository's __graft_entry__.py: entry()'s step on the CPU (K3's
plain version) gives the table and the whole packed output the JAX
step gives on the same example, and dryrun_multichip passes on an
8-device CPU mesh, as tests/test_sharded.py's graft-entry tests run the
reference's."""

import jax
import numpy as np
import torch

from tigerbeetle_tpu.state_machine import kernel as ref_kernel
from tigerbeetle_tpu_torch import graft_entry as ge
from tigerbeetle_tpu_torch.state_machine import kernel


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as ref_ge

    fn, args = ge.entry(device="cpu")
    table, packed = fn(*args)
    assert table is args[0]  # in place
    ref_fn, ref_args = ref_ge.entry()
    ref_table, ref_packed = jax.jit(ref_fn)(*ref_args)
    np.testing.assert_array_equal(table.numpy().view(np.uint64), np.asarray(ref_table))
    np.testing.assert_array_equal(packed.numpy().view(np.uint64), np.asarray(ref_packed))
    out = kernel.unpack_outputs(packed.numpy().view(np.uint64))
    assert (out["results"][:8] == 0).all()
    ref_out = ref_kernel.unpack_outputs(np.asarray(ref_packed))
    np.testing.assert_array_equal(out["results"], ref_out["results"])


def test_example_events_match_the_reference():
    import __graft_entry__ as ref_ge

    for n in (0, 8):
        mine, theirs = ge._example_events(n), ref_ge._example_events(n)
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]), err_msg=k)
            assert mine[k].dtype == np.asarray(theirs[k]).dtype, k


def test_dryrun_multichip_on_eight_cpu_devices():
    ge.dryrun_multichip(8, devices=["cpu"] * 8)


def test_mesh_devices_takes_the_first_n():
    assert ge.mesh_devices(4, ["cpu"] * 8) == [torch.device("cpu")] * 4
