"""A module-scoped autouse fixture for the port's test files that write
hundreds of MB under pytest's temporary root (checkpoints, traces, run
dirs): what the module's tests made there goes when the module ends.

pytest keeps the temporary roots of its last three runs, and one tier-1 run
of the whole suite leaves ~10 GB there, so a second run can find the disk
full.  A file opts in by importing the fixture:

    from torch_port_tmp import _remove_module_tmp  # noqa: F401

Under ``--dist loadfile`` a worker runs one file's tests together, so what
appears under its root while the module runs is the module's own.
"""

import shutil

import pytest


@pytest.fixture(autouse=True, scope="module")
def _remove_module_tmp(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    before = set(root.iterdir())
    yield
    for path in set(root.iterdir()) - before:
        shutil.rmtree(path, ignore_errors=True)
