"""Shared pieces of the benchmark twins' parity tests
(``tests/test_torch_bench_*.py``): the comparisons of two packages' bench
results, and ``bench_slot``, which lets one bench run at a time.

A bench twin's test runs two whole benches (JAX's and the port's): process
pools, fleets of reader processes, timed passes of several threads. Under
``pytest -n N --dist loadfile`` the bench files go to different workers,
and several such tests at once load the host enough to move the timing
bars of the other tests running beside them. ``bench_slot`` holds an
exclusive ``flock`` on one file in the session's temporary root, which
every xdist worker of the session shares, for the length of the test.
"""

import fcntl
import os

import pytest

#: time limit of a test that takes the bench slot: its own run plus the
#: waits for the other bench tests of the session, which hold the slot in
#: turn
BENCH_TIMEOUT_S = 600


def same_keys(want, got, *sections):
    """Equal key sets at the top and in each named dict-valued section
    (a dotted path)."""
    assert set(got) == set(want)
    for section in sections:
        a, b = want, got
        for part in section.split('.'):
            a, b = a[part], b[part]
        assert set(b) == set(a), section


def same_fields(want, got, section, fields):
    """Equal values of ``fields`` in ``section`` of both results."""
    for field in fields:
        assert got[section][field] == want[section][field], (section, field)


@pytest.fixture
def bench_slot(tmp_path_factory):
    """Holds the session's one bench slot while the test runs."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent      # .../pytest-N, above each worker's popen-gwK
    with open(root / 'torch-bench.lock', 'a') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def bars_well_formed(module, result):
    """Each of a twin's timing bars on ``result`` is ``(label, value, op,
    bar)`` with a number or ``None`` for the value and a known sign."""
    from petastorm_tpu_torch.benchmark import BAR_OPS
    for label, value, op, bar in module._bars(result):
        assert isinstance(label, str) and label, label
        assert value is None or isinstance(value, (int, float)), label
        assert op in BAR_OPS and isinstance(bar, (int, float)), label
