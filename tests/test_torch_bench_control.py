"""The control and fault group of the port's benchmark twins against the
JAX package's, on the CPU: ``autotune``, ``chaos`` and ``object_store``,
each at ``quick=True`` with its checks off (``device='cpu'`` for the
autotune bench's calibration; its grid's many-worker entry at 2 threads),
each in the session's one bench slot (``torch_bench_util.bench_slot``).

Each test runs both packages' bench and asserts JAX's result keys and
equal exact fields: rows, row groups, the model replay verdicts, the rows
read under injected faults, the three read planes' row digests, the pod's
``fills`` and ``peer_hits``, the certificate and the determinism flags.
Timing ratios are not compared. Each test then runs the port twin's
``_check_exact``: the conditions ``chip_smoke.py`` asserts on the card.
"""

import pytest

from petastorm_tpu.benchmark import autotune as jautotune
from petastorm_tpu.benchmark import chaos as jchaos
from petastorm_tpu.benchmark import object_store as jobject

from petastorm_tpu_torch.benchmark import autotune as tautotune
from petastorm_tpu_torch.benchmark import chaos as tchaos
from petastorm_tpu_torch.benchmark import object_store as tobject

from torch_bench_util import (  # noqa: F401
    BENCH_TIMEOUT_S, bars_well_formed, bench_slot, same_keys)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_autotune_recovers_as_jax(monkeypatch):
    # the hand-tuned grid's many-worker entry at 2 threads, not one a core:
    # the other test files run beside this one
    from petastorm_tpu.benchmark import northstar as jnorthstar
    from petastorm_tpu_torch.benchmark import northstar as tnorthstar
    for module in (jnorthstar, tnorthstar):
        monkeypatch.setattr(module, '_default_workers', lambda: 2)
    want = jautotune.run_autotune_bench(quick=True, check=False)
    got = tautotune.run_autotune_bench(quick=True, check=False,
                                       device='cpu')
    same_keys(want, got, 'protocol', 'hand_tuned', 'mistuned', 'recovered',
              'steady', 'roofline')
    for key in ('quick', 'benchmark', 'rows', 'cpu_count'):
        assert got[key] == want[key], key
    for key in ('pass_duration_s', 'recovery_budget_s', 'trailing_window_s',
                'steady_pairs', 'tick_interval_s', 'pool', 'rows_per_group'):
        assert got['protocol'][key] == want['protocol'][key], key
    assert set(got['hand_tuned']['grid']) == set(want['hand_tuned']['grid'])
    assert got['mistuned']['config'] == want['mistuned']['config']
    assert len(got['steady']['pairs']) == len(want['steady']['pairs'])
    assert [(c['check'], c['ok']) for c in got['model_checks']] == \
        [(c['check'], c['ok']) for c in want['model_checks']]
    for action in got['recovered']['actions']:
        assert set(action) == {'tick', 'knob', 'direction', 'from',
                               'applied', 'policy', 'predicted_gain_pct',
                               'measured_delta_pct', 'prediction_error_pct',
                               'graded'}
    tautotune._check_exact(got)
    bars_well_formed(tautotune, got)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_chaos_hedges_as_jax():
    want = jchaos.run_chaos_bench(quick=True, check=False)
    got = tchaos.run_chaos_bench(quick=True, check=False)
    same_keys(want, got, 'scenario', 'clean', 'unhedged', 'hedged',
              'roofline')
    for key in ('benchmark', 'quick', 'rows', 'epochs', 'scenario'):
        assert got[key] == want[key], key
    assert got['clean']['pairs'] == want['clean']['pairs']
    for leg in ('unhedged', 'hedged'):
        for field in ('rows', 'row_groups'):
            assert got[leg][field] == want[leg][field] == \
                (want['rows'] * want['epochs'] if field == 'rows'
                 else want[leg]['row_groups']), (leg, field)
    assert got['unhedged']['io_hedges'] == 0
    tchaos._check_exact(got)
    bars_well_formed(tchaos, got)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_object_store_certifies_as_jax():
    want = jobject.run_object_store_bench(quick=True, check=False)
    got = tobject.run_object_store_bench(quick=True, check=False)
    same_keys(want, got, 'trace', 'modes', 'modes.serial', 'modes.ranged',
              'hedge_overhead', 'roofline', 'pod', 'pod.certificate',
              'determinism', 'determinism.first')
    for key in ('benchmark', 'quick', 'rows', 'row_groups', 'trace',
                'bit_identical'):
        assert got[key] == want[key], key
    for mode in ('serial', 'prebuffer', 'ranged'):
        # the same rows, read three ways, hash alike in both packages
        assert got['modes'][mode]['digest'] == want['modes'][mode]['digest']
        assert got['modes'][mode]['rows'] == want['modes'][mode]['rows']
    assert got['hedge_overhead']['hedges_fired'] == \
        want['hedge_overhead']['hedges_fired'] == 0
    for field in ('k_hosts', 'readers_per_host', 'fills', 'peer_hits',
                  'peer_errors', 'row_groups', 'total_samples',
                  'decoded_once_pod_wide'):
        assert got['pod'][field] == want['pod'][field], field
    for field in ('ok', 'fills', 'peer_hits'):
        assert got['pod']['certificate'][field] == \
            want['pod']['certificate'][field], field
    for flag in ('identical_injected', 'identical_injected_s',
                 'identical_hedge_retry'):
        assert got['determinism'][flag] == want['determinism'][flag], flag
    tobject._check_exact(got)
    bars_well_formed(tobject, got)
