"""The decode and read group of the port's benchmark twins against the JAX
package's, on the CPU: ``decode_batch``, ``transport``, ``readahead``,
``shared_cache`` and ``roofline``, each at ``quick=True`` with its checks
off (``device='cpu'`` where the bench calibrates), the shared-cache fleet
at 2 readers and the roofline pass on 2 workers: the other test files run
beside these. Each bench test takes the session's one bench slot
(``torch_bench_util.bench_slot``), so no two of them load the host at once.

Each test runs both packages' bench and asserts JAX's result keys and
equal exact fields: rows, row groups, split counters, payload copies,
fills, bit-identity, certificate verdicts. Timing ratios are not compared;
the transport speedup and the readahead speedup and hits are held at the
bounds JAX's own tier-1 smokes hold them to. Each test then runs the
port twin's ``_check_exact``: the conditions ``chip_smoke.py`` asserts on
the card.
"""

import pytest

from petastorm_tpu.benchmark import decode_batch as jdecode
from petastorm_tpu.benchmark import readahead as jreadahead
from petastorm_tpu.benchmark import roofline as jroofline
from petastorm_tpu.benchmark import shared_cache as jshared
from petastorm_tpu.benchmark import transport as jtransport

from petastorm_tpu_torch.benchmark import decode_batch as tdecode
from petastorm_tpu_torch.benchmark import readahead as treadahead
from petastorm_tpu_torch.benchmark import roofline as troofline
from petastorm_tpu_torch.benchmark import shared_cache as tshared
from petastorm_tpu_torch.benchmark import transport as ttransport

from torch_bench_util import (  # noqa: F401
    BENCH_TIMEOUT_S, bars_well_formed, bench_slot, same_fields, same_keys)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_decode_batch_counts_as_jax():
    want = jdecode.run_decode_batch_bench(quick=True, check=False)
    got = tdecode.run_decode_batch_bench(quick=True, check=False,
                                         device='cpu')
    same_keys(want, got, 'protocol', 'column_decode', 'lines', 'roofline')
    for key in ('quick', 'benchmark', 'rows', 'protocol', 'headline_line'):
        assert got[key] == want[key], key
    for name in want['column_decode']:
        same_keys(want['column_decode'][name], got['column_decode'][name])
        same_fields(want['column_decode'], got['column_decode'], name,
                    ('rows', 'codec', 'batched_cells', 'identical'))
    for key in want['lines']:
        same_keys(want['lines'][key], got['lines'][key])
        same_fields(want['lines'], got['lines'], key,
                    ('workers', 'rows_decoded_batched',
                     'rows_decoded_percell'))
    assert set(got['lines']['mnist_w1_batched']['roofline']) == set(
        want['lines']['mnist_w1_batched']['roofline'])
    tdecode._check_exact(got)
    bars_well_formed(tdecode, got)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_transport_copies_as_jax():
    want = jtransport.run_transport_bench(quick=True, check=False)
    got = ttransport.run_transport_bench(quick=True, check=False)
    same_keys(want, got, 'inprocess_roundtrip', 'pool_stream',
              'inprocess_roundtrip.pickle', 'pool_stream.zero_copy')
    assert got['payload_mb'] == want['payload_mb']
    for kind in ('pickle', 'zero_copy'):
        same_fields(want['inprocess_roundtrip'], got['inprocess_roundtrip'],
                    kind, ('rounds', 'payload_mb', 'copies',
                           'copies_per_roundtrip'))
        same_fields(want['pool_stream'], got['pool_stream'], kind,
                    ('workers', 'items', 'payload_copies',
                     'copies_per_item'))
    ttransport._check_exact(got)
    bars_well_formed(ttransport, got)
    # JAX's tier-1 smoke holds its speedup to the same bound
    assert got['speedup_inprocess'] >= 1.5


def test_transport_worker_function_is_importable_by_name():
    """A pool's ``python -S`` worker unpickles the process function by its
    module path: it must not live in ``__main__``."""
    assert ttransport.stream_image_payload.__module__ == \
        'petastorm_tpu_torch.benchmark.transport'
    payload = ttransport.stream_image_payload(2, 4, 4, 0)
    want = jtransport.make_image_payload(2, 4, 4)
    assert set(payload) == set(want)
    for name in want:
        assert payload[name].tobytes() == want[name].tobytes()


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_readahead_hits_as_jax():
    want = jreadahead.run_readahead_bench(quick=True, check=False)
    got = treadahead.run_readahead_bench(quick=True, check=False)
    same_keys(want, got, 'calibration', 'serial', 'readahead')
    for key in ('quick', 'rows', 'row_groups_per_epoch', 'epochs'):
        assert got[key] == want[key], key
    assert got['calibration']['stage_budget_ms_per_group'] == \
        want['calibration']['stage_budget_ms_per_group']
    for leg in ('serial', 'readahead'):
        same_fields(want, got, leg, ('rows', 'row_groups'))
    assert got['serial']['readahead_hits'] == 0
    treadahead._check_exact(got)
    bars_well_formed(treadahead, got)
    # JAX's tier-1 smoke holds its speedup to the same bound
    assert got['speedup_items_per_s'] >= 1.15


def test_generate_readahead_dataset_as_jax(tmp_path):
    import pyarrow.parquet as pq
    jreadahead.generate_readahead_dataset('file://' + str(tmp_path / 'j'),
                                          rows=40)
    treadahead.generate_readahead_dataset('file://' + str(tmp_path / 't'),
                                          rows=40)

    def rows(path):
        files = sorted(p for p in path.rglob('*.parquet'))
        return [(pq.ParquetFile(f).metadata.num_row_groups,
                 pq.read_table(f).to_pydict()) for f in files]
    assert rows(tmp_path / 't') == rows(tmp_path / 'j')


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_shared_cache_decodes_once_as_jax():
    want = jshared.run_shared_cache_bench(quick=True, check=False,
                                          k_readers=2)
    got = tshared.run_shared_cache_bench(quick=True, check=False,
                                         k_readers=2)
    same_keys(want, got, 'roofline', 'shared', 'local_disk_baseline',
              'warm', 'certificate')
    for key in ('quick', 'k_readers', 'rows', 'row_groups', 'expected_hits',
                'decoded_once'):
        assert got[key] == want[key], key
    assert got['shared_counters']['fills'] == \
        want['shared_counters']['fills'] == got['row_groups']
    same_fields(want, got, 'certificate', ('ok', 'fills'))
    same_fields(want, got, 'shared', ('samples',))
    same_fields(want, got, 'local_disk_baseline', ('samples',))
    same_fields(want, got, 'warm', ('shared_misses', 'shared_hits'))
    tshared._check_exact(got)
    bars_well_formed(tshared, got)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_roofline_verdict_as_jax():
    want = jroofline.run_roofline_bench(quick=True, check=False,
                                        workers_count=2)
    got = troofline.run_roofline_bench(quick=True, check=False,
                                       workers_count=2, device='cpu')
    same_keys(want, got, 'roofline', 'probes', 'attribution')
    for key in ('quick', 'benchmark', 'rows', 'row_groups', 'workers',
                'cpu_count', 'advisor_monotone'):
        assert got[key] == want[key], key
    assert [(c['check'], c['ok']) for c in got['model_checks']] == \
        [(c['check'], c['ok']) for c in want['model_checks']]
    assert got['attribution']['source'] == want['attribution']['source']
    assert set(got['ceilings_samples_per_sec']) == \
        set(want['ceilings_samples_per_sec'])
    troofline._check_exact(got)
    bars_well_formed(troofline, got)
