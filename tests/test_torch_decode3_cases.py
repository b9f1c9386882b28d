"""The per-case tests of tests/test_torch_decode3.py (the port's v3 decode
against the JAX v3 kernel in interpret mode, the host shim's windowed and
direct per-lane code against the plain version) on every case but the ones
that file keeps (HERE).  Same tests, same names, same checks: the bodies
are that file's `check_*` functions.  A file of its own so that
`--dist loadfile` runs the two files' JAX batches on two workers; no JAX
batch shape is staged in both.
"""

import pytest

import test_torch_decode3 as T

CASES = [name for name in T.CASES if name not in T.HERE]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    T.check_plain_matches_jax(name)


@pytest.mark.parametrize("name", CASES)
def test_host_shim_matches_plain(name):
    T.check_host_shim_matches_plain(name)


@pytest.mark.parametrize("window", T.WINDOWS)
@pytest.mark.parametrize("name", CASES)
def test_windowed_shim_matches_plain_and_jax(name, window):
    T.check_windowed_shim_matches_plain_and_jax(name, window)


@pytest.mark.parametrize("name", CASES)
def test_direct_shim_matches_plain(name):
    T.check_direct_shim_matches_plain(name)
