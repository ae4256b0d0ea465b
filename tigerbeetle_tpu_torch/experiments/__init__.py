"""Probes of the multi-batch launchers (``device_kernels.scan_of`` and
``staged``), the counterparts of the reference's ``experiments/`` probes
that drive them.  Each is ``python -m
tigerbeetle_tpu_torch.experiments.<name> [--device D] [--rows A]
[--reps K]``; nothing runs at import."""
