"""Fixtures shared by the port's test files (``tests/test_torch_*.py``).

A test file takes :func:`one_torch_thread` by importing it::

    from _torch_port_fixtures import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_train_state(variables, tx, ema: bool = False):
    """The JAX package's ``create_train_state(variables, tx, ema)`` under
    one ``jax.jit``: the same state, in one compile instead of one eager
    compile for each parameter shape."""
    import jax

    from single_shot_detection_tpu.train.state import create_train_state
    return jax.jit(lambda v: create_train_state(v, tx, ema=ema))(variables)
