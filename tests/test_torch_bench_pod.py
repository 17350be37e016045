"""The pod and scaling group of the port's benchmark twins against the JAX
package's, on the CPU: ``podobs`` and ``podelastic`` at ``quick=True``
with their checks off, and ``scaling`` at JAX's CPU sizes over 1 and 2
workers (``device='cpu'``), each in the session's one bench slot
(``torch_bench_util.bench_slot``).

Each test runs both packages' bench and asserts JAX's result keys and
equal exact fields: the pod certificate's ``fills`` and ``peer_hits``,
the merged percentiles' bit-identity, the ``partial_pod`` verdict, the
host death, the exactly-once certificate and the leases moved, and the
scaling curve's steps and samples. Timing ratios are not compared. Each
test then runs the port twin's ``_check_exact``: the conditions
``chip_smoke.py`` asserts on the card. ``scaling`` writes a file only
where it is given a path.
"""

import json
import os

import pytest

from petastorm_tpu.benchmark import northstar as jnorthstar
from petastorm_tpu.benchmark import podelastic as jpodelastic
from petastorm_tpu.benchmark import podobs as jpodobs
from petastorm_tpu.benchmark import scaling as jscaling

from petastorm_tpu_torch.benchmark import podelastic as tpodelastic
from petastorm_tpu_torch.benchmark import podobs as tpodobs
from petastorm_tpu_torch.benchmark import scaling as tscaling

from torch_bench_util import (  # noqa: F401
    BENCH_TIMEOUT_S, bars_well_formed, bench_slot)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_podobs_certifies_as_jax():
    want = jpodobs.run_podobs_bench(quick=True, check=False)
    got = tpodobs.run_podobs_bench(quick=True, check=False)
    assert set(got) == set(want)
    for section in ('overhead', 'pod', 'roofline'):
        assert set(got[section]) == set(want[section]), section
    for key in ('benchmark', 'quick', 'rows', 'trace',
                'merge_bit_identical'):
        assert got[key] == want[key], key
    for key in ('k_hosts', 'row_groups', 'local_fill_calls', 'verdict'):
        assert got['pod'][key] == want['pod'][key], key
    for key in ('ok', 'fills', 'peer_hits'):
        assert got['pod']['certificate'][key] == \
            want['pod']['certificate'][key], key
    assert got['pod']['partial_pod'] == want['pod']['partial_pod']
    assert set(got['direct_percentiles']) == set(want['direct_percentiles'])
    tpodobs._check_exact(got)
    bars_well_formed(tpodobs, got)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_podelastic_recovers_as_jax():
    want = jpodelastic.run_podelastic_bench(quick=True, check=False)
    got = tpodelastic.run_podelastic_bench(quick=True, check=False)
    assert set(got) == set(want)
    for section in ('clean', 'rebalance', 'recovery', 'roofline'):
        assert set(got[section]) == set(want[section]), section
    for key in ('benchmark', 'quick', 'rows', 'k_hosts', 'trace'):
        assert got[key] == want[key], key
    for key in ('k_hosts', 'deaths', 'rows_delivered', 'leases_rebalanced',
                'rows_resumed', 'certificate_ok', 'certificate_problems'):
        assert got['recovery'][key] == want['recovery'][key], key
    assert got['clean']['pairs'] == want['clean']['pairs']
    assert got['rebalance']['trials'] == want['rebalance']['trials']
    tpodelastic._check_exact(got)
    bars_well_formed(tpodelastic, got)


@pytest.fixture
def jax_scaling_store(tmp_path, monkeypatch):
    """JAX's ``scaling.run`` keeps its store under a fixed ``/tmp`` path;
    send its store writes and reads to ``tmp_path`` instead."""
    fixed = 'file:///tmp/petastorm_tpu_scaling_mnist_'
    moved = 'file://' + str(tmp_path / 'jax_mnist_')
    generate = jnorthstar.generate_mnist_images_dataset
    bench = jnorthstar.run_mnist_train_bench
    exists = os.path.exists
    monkeypatch.setattr(
        jnorthstar, 'generate_mnist_images_dataset',
        lambda url, **kw: generate(url.replace(fixed, moved), **kw))
    monkeypatch.setattr(
        jnorthstar, 'run_mnist_train_bench',
        lambda url, **kw: bench(url.replace(fixed, moved), **kw))
    monkeypatch.setattr(
        os.path, 'exists',
        lambda p: (False if str(p).startswith(
            '/tmp/petastorm_tpu_scaling_mnist_') else exists(p)))


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_scaling_curve_as_jax(tmp_path, monkeypatch, jax_scaling_store):
    want = jscaling.run(str(tmp_path / 'jax.json'), worker_counts=(1, 2))
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    before = sorted(os.listdir(tmp_path))
    got = tscaling.run(worker_counts=(1, 2), device='cpu')
    assert sorted(os.listdir(tmp_path)) == before   # no path: no file
    assert set(got) == set(want)
    for key in ('platform', 'batch_size', 'num_steps', 'rows'):
        assert got[key] == want[key], key
    assert [set(e) for e in got['curve']] == [set(e) for e in want['curve']]
    for mine, theirs in zip(got['curve'], want['curve']):
        for key in ('workers', 'steps', 'samples'):
            assert mine[key] == theirs[key], key
    tscaling._check_exact(got)
    path = str(tmp_path / 'curve.json')
    again = tscaling.run(path, worker_counts=(1,), device='cpu')
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(again))
