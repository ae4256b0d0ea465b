"""PyTorch + CUDA port of the device-authoritative create_transfers loop.

A second package beside ``tigerbeetle_tpu`` (the JAX reference, which
this package never imports).  Module names follow the reference so
each counterpart is easy to find; inside, the code is plain PyTorch on
tensors with an explicit ``device``.  u64 values live in int64 lanes:
add, sub and mul wrap mod 2^64 with the same bits, and unsigned
compare / logical shift are emulated (``ops/u128.py``).

Entry point: ``state_machine.gpu.TorchStateMachine`` behind the same
``StateMachine`` operator boundary (``input_valid`` / ``prepare`` /
``prefetch`` / ``commit``) over the 128-byte wire structs, driven by
``testing.harness.SingleNodeHarness``.  It runs on CUDA unless the
caller passes ``device="cpu"``; the hand-written kernels live in
``csrc/`` and are built by ``kernels/build.py`` at first use.  Above
it: the durable replica and VSR consensus (``vsr/``), the TCP server
(``runtime/server.py``), the client (``client.py``) and the CLI
(``python -m tigerbeetle_tpu_torch``: ``version``, ``format``,
``start``, ``repl``, ``benchmark``, ``bindings``, ``trace-demo``), and
the VOPR, fuzzers and soak under ``testing/``.
"""
