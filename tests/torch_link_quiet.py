"""The port's tests' check that no device engine lost its link.

A device engine turns a link fault (a LinkError from its DeviceLink, a
CUDA runtime error on the card) into a demotion to exact host service,
whose replies and roots stay right.  A differential that compares only
replies and roots would then pass over a broken device path.  The
autouse fixture `link_quiet` records every DeviceEngine a test builds
and fails the test unless each one that crosses through the plain
DeviceLink ends it with no link error and no demotion.  A test that
passes its own link (a chaos shim, a fault-raising stub) injects its
faults on purpose and asserts its counters itself.

Import it into a test module to apply it there:

    from torch_link_quiet import link_quiet  # noqa: F401
"""

import pytest

from tigerbeetle_tpu_torch.state_machine import device_engine as de


@pytest.fixture(autouse=True)
def link_quiet(monkeypatch):
    engines = []
    init = de.DeviceEngine.__init__

    def recording_init(self, *args, **kwargs):
        engines.append(self)
        init(self, *args, **kwargs)

    monkeypatch.setattr(de.DeviceEngine, "__init__", recording_init)
    yield engines
    for eng in engines:
        if type(getattr(eng, "link", None)) is not de.DeviceLink:
            continue
        assert (eng.stat_link_errors, eng.stat_demotions) == (0, 0), (
            f"a device engine lost its link: {eng.stat_link_errors} link errors, "
            f"{eng.stat_demotions} demotions, last {eng.last_demotion}"
        )
