"""The four overhead twins against the JAX package's, on the CPU:
``lineage_overhead``, ``trace_overhead``, ``latency_overhead`` and
``health_overhead``, each at ``quick=True`` with its checks off
(``device='cpu'`` for the two whose loader stages batches), each in the
session's one bench slot (``torch_bench_util.bench_slot``).

Each test runs both packages' bench and asserts JAX's result keys and
equal exact fields: rows, epochs, workers and passes, and the evidence
that the plane ran (batch provenance and a complete audit; spans and a
valid Chrome trace; populated histograms and an evaluated SLO; a
``healthy`` verdict over the ventilator and the workers). Overhead
percentages are not compared. Each test then runs the port twin's
``_check_exact``: the conditions ``chip_smoke.py`` asserts on the card.
"""

import pytest

from petastorm_tpu.benchmark import health_overhead as jhealth
from petastorm_tpu.benchmark import latency_overhead as jlatency
from petastorm_tpu.benchmark import lineage_overhead as jlineage
from petastorm_tpu.benchmark import trace_overhead as jtrace

from petastorm_tpu_torch.benchmark import health_overhead as thealth
from petastorm_tpu_torch.benchmark import latency_overhead as tlatency
from petastorm_tpu_torch.benchmark import lineage_overhead as tlineage
from petastorm_tpu_torch.benchmark import trace_overhead as ttrace

from torch_bench_util import (  # noqa: F401
    BENCH_TIMEOUT_S, bars_well_formed, bench_slot)

PROTOCOL = ('quick', 'rows', 'epochs', 'workers', 'passes_per_mode')


def same_protocol(want, got):
    assert set(got) == set(want)
    for key in PROTOCOL:
        assert got[key] == want[key], key


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_lineage_overhead_audits_as_jax():
    want = jlineage.run_lineage_overhead_bench(quick=True, check=False)
    got = tlineage.run_lineage_overhead_bench(quick=True, check=False,
                                              device='cpu')
    same_protocol(want, got)
    for key in ('audit_complete', 'epochs_audited', 'provenanced_batches'):
        assert got[key] == want[key], key
    tlineage._check_exact(got)
    bars_well_formed(tlineage, got)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_trace_overhead_exports_as_jax():
    want = jtrace.run_trace_overhead_bench(quick=True, check=False)
    got = ttrace.run_trace_overhead_bench(quick=True, check=False)
    same_protocol(want, got)
    assert got['export_valid'] == want['export_valid'] is True
    assert got['spans_recorded'] == got['export_span_events'] > 0
    assert want['spans_recorded'] == want['export_span_events'] > 0
    ttrace._check_exact(got)
    bars_well_formed(ttrace, got)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_latency_overhead_populates_histograms_as_jax():
    want = jlatency.run_latency_overhead_bench(quick=True, check=False)
    got = tlatency.run_latency_overhead_bench(quick=True, check=False,
                                              device='cpu')
    same_protocol(want, got)
    assert set(got['roofline']) == set(want['roofline'])
    assert got['overhead_statistic'] == want['overhead_statistic']
    assert set(got['histogram_counts']) == set(want['histogram_counts'])
    for stage in ('io', 'decode', 'e2e_batch', 'infeed_wait'):
        assert got['histogram_counts'][stage] == \
            want['histogram_counts'][stage], stage
    assert got['slo_evaluated'] == want['slo_evaluated'] is True
    tlatency._check_exact(got)
    bars_well_formed(tlatency, got)


@pytest.mark.timeout(BENCH_TIMEOUT_S)
@pytest.mark.usefixtures('bench_slot')
def test_health_overhead_is_healthy_as_jax():
    want = jhealth.run_health_overhead_bench(quick=True, check=False)
    got = thealth.run_health_overhead_bench(quick=True, check=False)
    same_protocol(want, got)
    assert got['verdict'] == want['verdict'] == 'healthy'
    assert got['entities'] == want['entities']
    thealth._check_exact(got)
    bars_well_formed(thealth, got)
