"""PyTorch port, the learning-parity gate for the ``categorical`` config:
the same run and the same two readings as ``test_torch_port_quality.py``
holds for ``default`` (its docstring).  A file of its own, so that xdist's
``--dist loadfile`` runs the two configs' runs on two workers."""

import pytest

from tests.test_torch_port_quality import (  # noqa: F401 (collected here)
    _learning_threads, learning_run_for, test_forced_run_matches_jax_at_every_step,
    test_free_run_learns_as_jax_does)


@pytest.fixture(scope="module", params=["categorical"])
def learning_run(request, tmp_path_factory):
    return learning_run_for(request.param, tmp_path_factory)
