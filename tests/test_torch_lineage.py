"""Sample lineage and bad-sample quarantine of the port against the JAX
package's, on the same stores (numpy-seeded rows, small row groups).

Every comparison is exact: provenance records field for field (without
``worker_id``), audit reports key for key, quarantine records field for
field (without the wall-clock ``ts``), delivered rows bit for bit. The
JAX package runs its own readers, pools and loader on the CPU.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import petastorm_tpu
from petastorm_tpu import lineage as jlineage
from petastorm_tpu.goodput import GoodputMonitor as JGoodputMonitor
from petastorm_tpu.jax_utils import JaxDataLoader
from petastorm_tpu.ngram import NGram as JNGram
from petastorm_tpu.predicates import in_lambda as jin_lambda
from petastorm_tpu.transform import TransformSpec as JTransformSpec

import petastorm_tpu_torch
from petastorm_tpu_torch import TorchDataLoader, materialize_dataset
from petastorm_tpu_torch import lineage as tlineage
from petastorm_tpu_torch.codecs import (CompressedImageCodec, NdarrayCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.goodput import GoodputMonitor
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops import decode as tdecode
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS = 48
ROW_GROUP_MB = 0.003              # row groups of 7, 7, 7 and 3 rows
#: (file, row group, row in the group) of the garbage ``image`` cells
POISON = ((0, 1, 2), (0, 1, 5), (1, 0, 0))

FACTORIES = {'row': 'make_reader', 'columnar': 'make_columnar_reader',
             'batch': 'make_batch_reader'}


def _schema():
    return Unischema('LineageRows', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (8, 6, 3),
                       CompressedImageCodec('png'), False),
        UnischemaField('matrix', np.float32, (4, 3), NdarrayCodec(), False)])


def _write(path, seed=0):
    rng = np.random.default_rng(seed)
    with materialize_dataset('file://' + path, _schema(),
                             row_group_size_mb=ROW_GROUP_MB,
                             rows_per_file=ROWS // 2) as w:
        w.write_rows({'idx': np.int64(i),
                      'image': rng.integers(0, 255, (8, 6, 3), np.uint8),
                      'matrix': rng.random((4, 3), dtype=np.float32)}
                     for i in range(ROWS))
    return 'file://' + path


def _files(path):
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith('.parquet'))


def corrupt_cells(path, field, targets):
    """Garbage bytes in ``field`` at each ``(file, row group, row)`` of
    ``targets``, every file's row groups kept as they were."""
    for fi, name in enumerate(_files(path)):
        hits = [(rg, row) for f, rg, row in targets if f == fi]
        if not hits:
            continue
        pf = pq.ParquetFile(name)
        groups = [pf.read_row_group(rg) for rg in range(pf.num_row_groups)]
        schema = pf.schema_arrow
        pf.close()
        with pq.ParquetWriter(name, schema) as writer:
            for rg, table in enumerate(groups):
                rows = [row for g, row in hits if g == rg]
                if rows:
                    cells = table.column(field).to_pylist()
                    for row in rows:
                        cells[row] = b'garbage-not-an-encoded-image'
                    table = table.set_column(
                        table.column_names.index(field), schema.field(field),
                        pa.array(cells, type=schema.field(field).type))
                writer.write_table(table)


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('lineage') / 'clean')
    return _write(path)


@pytest.fixture(scope='module')
def corrupt_store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('lineage') / 'corrupt')
    url = _write(path)
    corrupt_cells(path, 'image', POISON)
    return url


def _open(package, kind, url, **kw):
    module = petastorm_tpu if package == 'jax' else petastorm_tpu_torch
    return getattr(module, FACTORIES[kind])(url, **kw)


def _records(reader):
    """Every registered provenance record of the reader, without the
    worker, sorted."""
    out = []
    for epoch in reader.lineage.epochs():
        for records in reader.lineage.epoch_ledger(epoch)['delivered'].values():
            out.extend(tuple(r._replace(worker_id=0)) for r in records)
    return sorted(out, key=repr)


def _quarantines(reader):
    return sorted(({k: v for k, v in r.items() if k != 'ts'}
                   for r in reader.lineage.quarantines()), key=repr)


def _report(reader, shuffle=True):
    report = reader.audit().report()
    if not shuffle:
        for verdict in report['epochs'].values():
            verdict.pop('shuffle')
    return report


def _idx(kind, item):
    """The ``idx`` values of one yielded item."""
    return [int(item.idx)] if kind == 'row' else [int(i) for i in item.idx]


def _consume(package, kind, url, shuffle=True, **kw):
    """``(idx delivered, records, quarantines, report)`` of one reader."""
    with _open(package, kind, url, **kw) as reader:
        got = sorted(i for item in reader for i in _idx(kind, item))
        return (got, _records(reader), _quarantines(reader),
                _report(reader, shuffle))


# -- the units ----------------------------------------------------------------

def test_constants_and_packing_match_jax():
    for name in ('LINEAGE_ENV_VAR', 'LINEAGE_COLUMN', 'PROVENANCE_KEY',
                 'PACK_SHIFT', 'DEFAULT_RECORD_CAPACITY',
                 'DEFAULT_EPOCH_CAPACITY', 'DEFAULT_QUARANTINE_CAPACITY',
                 'DECODE_ERROR_POLICIES', 'NEVER_QUARANTINE'):
        assert getattr(tlineage, name) == getattr(jlineage, name), name
    assert tlineage.Provenance._fields == jlineage.Provenance._fields
    for seq, off in ((0, 0), (1234, 567), (2 ** 38, 2 ** 24 - 1)):
        packed = tlineage.pack_source(seq, off)
        assert packed == jlineage.pack_source(seq, off)
        assert tlineage.unpack_source(packed) == (seq, off)
    assert np.array_equal(tlineage.pack_rows(7, 5), jlineage.pack_rows(7, 5))
    assert tlineage.pack_rows(7, 5).dtype == np.int64
    for sel in (('all', 4), ('slice', 2, 6), ('index', (1, 3, 8)),
                ('windows', 3), ('opaque', 2)):
        a, b = tlineage.selection_offsets(sel), jlineage.selection_offsets(sel)
        assert (a is None and b is None) or np.array_equal(a, b)
    sources = np.asarray([tlineage.pack_source(s, i) for s, i in
                          [(1, 0), (1, 1), (2, 0), (1, 2), (2, 1)]])
    assert (tlineage.BatchProvenance(sources, None).shuffle_quality()
            == jlineage.BatchProvenance(sources, None).shuffle_quality())


def test_tracker_rings_and_epoch_eviction_match_jax():
    for mod in (tlineage, jlineage):
        tracker = mod.LineageTracker(enabled=True, record_capacity=4,
                                     epoch_capacity=2)
        record = mod.Provenance('d', 0, '/p', 0, 1, ('all', 1), 0, -1, 0,
                                (0, 1), 0)
        seqs = [tracker.register(record) for _ in range(10)]
        assert tracker.resolve(seqs[0]) is None
        assert tracker.resolve(seqs[-1]) == record
        assert tracker.records_registered == 10
        for epoch in range(5):
            tracker.record_ventilated(epoch, 0, (0, 1))
        assert tracker.epochs() == [3, 4]


def test_invalid_policy_message_is_jax_word_for_word(store):
    with pytest.raises(ValueError) as jax_info:
        petastorm_tpu.make_reader(store, on_decode_error='explode')
    for kind in FACTORIES:
        with pytest.raises(ValueError) as info:
            _open('torch', kind, store, on_decode_error='explode')
        assert str(info.value) == str(jax_info.value)


# -- provenance of every item -------------------------------------------------

@pytest.mark.timeout(240)
@pytest.mark.parametrize('pool', ['thread', 'dummy', 'process'])
@pytest.mark.parametrize('kind', ['row', 'columnar', 'batch'])
def test_item_provenance_matches_jax(store, kind, pool):
    kw = dict(reader_pool_type=pool, workers_count=2, num_epochs=1, seed=3)
    ref = _consume('jax', kind, store, shuffle=False, **kw)
    got = _consume('torch', kind, store, shuffle=False, **kw)
    assert got[0] == ref[0] == list(range(ROWS))
    assert got[1] == ref[1] and got[1]
    assert {r[5][0] for r in got[1]} == {'all'}
    assert got[3] == ref[3] and got[3]['complete']


def test_last_provenance_and_explain_batch_match_jax(store):
    kw = dict(reader_pool_type='dummy', num_epochs=1, seed=1)
    with petastorm_tpu.make_columnar_reader(store, **kw) as ref, \
            petastorm_tpu_torch.make_columnar_reader(store, **kw) as got:
        for want, batch in zip(ref, got):
            assert np.array_equal(want.idx, batch.idx)
            assert (got.last_provenance._replace(worker_id=0)
                    == tuple(ref.last_provenance._replace(worker_id=0)))
            a, b = got.explain_batch(), ref.explain_batch()
            for e in (a, b):
                e['sources'][0].pop('worker_id')
            assert a == b
        assert got.last_seq == ref.last_seq


@pytest.mark.parametrize('case', ['two_epochs', 'shard', 'row_drop',
                                  'predicate', 'filters'])
def test_audit_reports_match_jax(store, case):
    kw = dict(reader_pool_type='dummy', seed=5, num_epochs=1)
    jkw = {}
    if case == 'two_epochs':
        kw['num_epochs'] = 2
    elif case == 'shard':
        kw.update(cur_shard=1, shard_count=3)
    elif case == 'row_drop':
        kw['shuffle_row_drop_partitions'] = 3
    elif case == 'predicate':
        kw['predicate'] = in_lambda(['idx'], lambda v: v['idx'] % 3 == 0)
        jkw['predicate'] = jin_lambda(['idx'], lambda v: v['idx'] % 3 == 0)
    else:
        kw['filters'] = [('idx', '<', 30)]
    for kind in ('row', 'columnar'):
        ref = _consume('jax', kind, store, **dict(kw, **jkw))
        got = _consume('torch', kind, store, **kw)
        assert got == ref, (kind, case)
        report = got[3]
        assert report['complete']
        assert sorted(report['epochs']) == list(range(kw['num_epochs']))
        if case in ('predicate', 'filters'):
            assert not report['epochs'][0]['row_exact']      # row_filtered
        elif case == 'row_drop':
            assert {r[5][0] for r in got[1]} == {'slice'}


@pytest.mark.parametrize('pool', ['thread', 'process'])
def test_audits_of_pools_match_jax_but_arrival_order(store, pool):
    kw = dict(reader_pool_type=pool, workers_count=3, seed=2, num_epochs=2,
              shuffle_row_drop_partitions=2)
    ref = _consume('jax', 'row', store, shuffle=False, **kw)
    got = _consume('torch', 'row', store, shuffle=False, **kw)
    assert got == ref and got[3]['complete']


def test_reset_starts_fresh_ledgers_at_the_next_epoch(store):
    got = {}
    for package in ('jax', 'torch'):
        with _open(package, 'columnar', store, reader_pool_type='thread',
                   workers_count=2, num_epochs=2) as reader:
            list(reader)
            reader.reset()
            list(reader)
            report = reader.audit().assert_complete()
            got[package] = (sorted(report['epochs']), report['passes'],
                            {e: v['rows_delivered']
                             for e, v in report['epochs'].items()},
                            _records(reader))
    assert got['torch'] == got['jax']
    assert got['torch'][:3] == ([0, 1, 2, 3], 1, {e: ROWS for e in range(4)})


def test_cached_pass_selection_matches_jax(store, tmp_path):
    got = {}
    for package in ('jax', 'torch'):
        kw = dict(reader_pool_type='dummy', num_epochs=1, seed=0,
                  cache_type='local-disk',
                  cache_location=str(tmp_path / package),
                  cache_size_limit=1 << 30)
        passes = []
        for _ in range(2):
            with _open(package, 'columnar', store, **kw) as reader:
                list(reader)
                passes.append(_records(reader))
        got[package] = passes
    assert got['torch'] == got['jax']
    fill, hit = got['torch']
    assert {r[5][0] for r in fill} == {'all'}
    assert {r[5][0] for r in hit} == {'opaque'}


def test_ngram_items_record_windows_and_batches_carry_none(store):
    got = {}
    for package, gram in (('jax', JNGram), ('torch', NGram)):
        with _open(package, 'row', store, reader_pool_type='dummy',
                   num_epochs=1, seed=0,
                   schema_fields=gram({0: ['idx'], 1: ['idx']}, 1,
                                      'idx')) as reader:
            loader = (JaxDataLoader(reader, batch_size=4) if package == 'jax'
                      else TorchDataLoader(reader, batch_size=4,
                                           device='cpu'))
            batches = list(loader)
            assert all('_provenance' not in b for b in batches)
            got[package] = (_records(reader), _report(reader))
    assert got['torch'] == got['jax']
    assert {r[5][0] for r in got['torch'][0]} == {'windows'}


# -- quarantine ----------------------------------------------------------------

@pytest.mark.parametrize('kind', ['row', 'columnar'])
def test_corrupt_store_raises_under_raise(corrupt_store, kind):
    for package in ('jax', 'torch'):
        with pytest.raises(ValueError, match='imdecode'):
            with _open(package, kind, corrupt_store,
                       reader_pool_type='dummy') as reader:
                list(reader)


@pytest.mark.timeout(240)
@pytest.mark.parametrize('pool', ['dummy', 'thread', 'process'])
@pytest.mark.parametrize('policy', ['skip', 'quarantine'])
@pytest.mark.parametrize('kind', ['row', 'columnar'])
def test_corrupt_store_quarantines_as_jax(corrupt_store, kind, policy, pool):
    kw = dict(reader_pool_type=pool, workers_count=2, num_epochs=1, seed=4,
              on_decode_error=policy)
    ref = _consume('jax', kind, corrupt_store, shuffle=False, **kw)
    got = _consume('torch', kind, corrupt_store, shuffle=False, **kw)
    assert got == ref
    delivered, records, quarantines, report = got
    poisoned = {9, 12, 24}             # idx of the garbage cells
    assert delivered == sorted(set(range(ROWS)) - poisoned)
    if policy == 'skip':
        assert quarantines == []
        return
    assert [(q['stage'], q['field'], q['rows'], q['row_offsets'])
            for q in quarantines] == [('decode', 'image', 2, [2, 5]),
                                      ('decode', 'image', 1, [0])]
    assert all(q['error'] == "ValueError: cv2.imdecode failed for field "
               "'image'" for q in quarantines)
    assert report['complete'] and report['rows_quarantined_total'] == 3
    assert ('index', (0, 1, 3, 4, 6)) in {r[5] for r in records}


def test_columnar_quarantine_keeps_dense_columns(corrupt_store):
    with petastorm_tpu_torch.make_columnar_reader(
            corrupt_store, reader_pool_type='dummy',
            on_decode_error='quarantine') as reader:
        for batch in reader:
            assert batch.image.dtype == np.uint8 and batch.image.ndim == 4
            assert batch.matrix.dtype == np.float32
        reader.audit().assert_complete()


@pytest.mark.parametrize('kind', ['row', 'columnar', 'batch'])
def test_transform_error_quarantines_as_jax(store, kind):
    if kind == 'row':
        def poison(row):
            if row['idx'] == 7:
                raise ValueError('poisoned idx 7')
            return row
    elif kind == 'columnar':
        def poison(cols):
            if 7 in cols['idx']:
                raise ValueError('poisoned idx 7')
            return cols
    else:
        def poison(df):
            if 7 in df['idx'].values:
                raise ValueError('poisoned idx 7')
            return df
    kw = dict(reader_pool_type='dummy', num_epochs=1, seed=0,
              on_decode_error='quarantine')
    if kind != 'batch':
        kw['shuffle_row_drop_partitions'] = 2
    ref = _consume('jax', kind, store, transform_spec=JTransformSpec(poison),
                   **kw)
    got = _consume('torch', kind, store, transform_spec=TransformSpec(poison),
                   **kw)
    assert got == ref
    (record,) = got[2]
    assert record['stage'] == 'transform'
    assert 'poisoned idx 7' in record['error']
    if kind == 'row':
        assert got[0] == [i for i in range(ROWS) if i != 7]
        assert record['rows'] == 1 and len(record['row_offsets']) == 1
        assert got[3]['complete']
    else:
        assert 7 not in got[0] and record['rows'] > 1


def test_device_decode_declines_under_quarantine_with_jax_reason(
        store, monkeypatch):
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'on')
    for policy in ('skip', 'quarantine'):
        with petastorm_tpu_torch.make_columnar_reader(
                store, on_decode_error=policy) as reader:
            assert reader.device_decode_plans == {}
            got = reader.device_decode_declined
        with petastorm_tpu.make_columnar_reader(
                store, on_decode_error=policy) as reader:
            assert got == reader.device_decode_declined
        assert got == {'*': 'on_decode_error quarantines per-cell codec '
                            'failures, which only the host decode can '
                            'observe'}
    with petastorm_tpu_torch.make_columnar_reader(store) as reader:
        assert reader.lineage.enabled
        assert set(reader.device_decode_plans) == {'matrix'}


# -- loader batches, replay, goodput ------------------------------------------

def _sources(batch):
    """``idx -> (path, row group, source offset)`` of each row."""
    prov = jlineage.batch_provenance_of(batch) or \
        tlineage.batch_provenance_of(batch)
    out = {}
    for i, (seq, off) in enumerate(zip(prov.seqs(), prov.offsets())):
        record = prov._tracker.resolve(int(seq))
        source = jlineage.selection_offsets(record.selection)[int(off)]
        out[int(batch['idx'][i])] = (record.path, record.row_group,
                                     int(source))
    return out


@pytest.mark.parametrize('kind', ['row', 'columnar', 'batch'])
def test_shuffled_loader_provenance_and_replay_match_jax(store, kind):
    kw = dict(reader_pool_type='thread', workers_count=2, num_epochs=1,
              seed=9)
    if kind != 'batch':
        kw['shuffle_row_drop_partitions'] = 2
    with _open('jax', kind, store, **kw) as reader:
        ref = {}
        for batch in JaxDataLoader(reader, batch_size=10,
                                   shuffling_queue_capacity=20, seed=1):
            ref.update(_sources(batch))
    with _open('torch', kind, store, **kw) as reader:
        got, replayed = {}, 0
        for batch in TorchDataLoader(reader, batch_size=10,
                                     shuffling_queue_capacity=20, seed=1,
                                     device='cpu'):
            got.update(_sources(batch))
            again = reader.replay(batch)
            assert set(again) == set(batch) - {'_provenance'}
            for name, col in again.items():
                want = batch[name]
                want = want.numpy() if torch.is_tensor(want) else want
                assert col.dtype == want.dtype, name
                if col.dtype == object:        # the batch reader's bytes
                    assert list(col) == list(want), name
                else:
                    assert col.tobytes() == want.tobytes(), name
            replayed += 1
            assert reader.explain_batch(batch)['rows'] == len(batch['idx'])
        reader.audit().assert_complete()
    assert got == ref and sorted(got) == list(range(ROWS)) and replayed


def test_replay_of_a_record_and_a_seq_match_jax(store, monkeypatch):
    # JAX's replay hands back a device-decoded column's raw grid; the
    # port's decodes it (see the next test), so this one holds them equal
    # with the host decode
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'off')
    out = {}
    for package in ('jax', 'torch'):
        with _open(package, 'columnar', store, reader_pool_type='dummy',
                   num_epochs=1, shuffle_row_drop_partitions=2,
                   seed=0) as reader:
            first = next(reader)
            record, seq = reader.last_provenance, reader.last_seq
            by_record = reader.replay(record)
            by_seq = reader.replay(seq)
            assert np.array_equal(by_record['idx'], first.idx)
            out[package] = {k: v.tobytes() for k, v in by_seq.items()}
    assert out['torch'] == out['jax']


def test_replay_decodes_device_planned_columns(store, monkeypatch):
    monkeypatch.setenv(tdecode.DEVICE_DECODE_ENV_VAR, 'on')
    with petastorm_tpu_torch.make_columnar_reader(
            store, num_epochs=1, workers_count=2, seed=0) as reader:
        assert set(reader.device_decode_plans) == {'matrix'}
        for batch in TorchDataLoader(reader, batch_size=10,
                                     shuffling_queue_capacity=20, seed=2,
                                     device='cpu'):
            again = reader.replay(batch)
            assert again['matrix'].dtype == np.float32
            assert np.array_equal(again['matrix'], batch['matrix'].numpy())
            assert np.array_equal(again['idx'], batch['idx'].numpy())


def test_goodput_explain_step_names_the_source_row_group(store):
    chains = {}
    for package in ('jax', 'torch'):
        with _open(package, 'columnar', store, reader_pool_type='dummy',
                   num_epochs=1, seed=0) as reader:
            loader = (JaxDataLoader(reader, batch_size=8) if package == 'jax'
                      else TorchDataLoader(reader, batch_size=8,
                                           device='cpu'))
            batch = next(iter(loader))
            monitor = (JGoodputMonitor() if package == 'jax'
                       else GoodputMonitor())
            monitor.note_fetch(0.5, batch)       # a data stall
            monitor.finish_step(0.01)
            explained = monitor.explain_step()
            chains[package] = (explained['chain'], explained['provenance'])
    assert chains['torch'] == chains['jax']
    chain, provenance = chains['torch']
    source = provenance['sources'][0]
    assert chain[-1] == 'infeed_wait ({} rg{})'.format(
        source['path'].rsplit('/', 1)[-1], source['row_group'])
    with pytest.raises(NotImplementedError, match='tracing and health'):
        GoodputMonitor().explain_step(snapshot={'x': 1})


# -- the kill switch ----------------------------------------------------------

def test_kill_switch_turns_lineage_off_as_jax(store, monkeypatch):
    monkeypatch.setenv(tlineage.LINEAGE_ENV_VAR, '0')
    assert not tlineage.lineage_enabled() and not jlineage.lineage_enabled()
    for kind in FACTORIES:
        with _open('torch', kind, store, reader_pool_type='thread',
                   workers_count=2, num_epochs=1) as reader:
            assert not reader.lineage.enabled
            item = reader._pool.get_results()
            assert not isinstance(item, tlineage.LineageEnvelope)
            batches = list(TorchDataLoader(reader, batch_size=8,
                                           device='cpu'))
            assert batches and all('_provenance' not in b for b in batches)
            assert reader.last_provenance is None
            assert reader.audit().report()['epochs'] == {}
    for value in ('false', 'off', 'OFF'):
        monkeypatch.setenv(tlineage.LINEAGE_ENV_VAR, value)
        assert not tlineage.lineage_enabled()
    monkeypatch.delenv(tlineage.LINEAGE_ENV_VAR)
    assert tlineage.lineage_enabled()


def test_kill_switch_keeps_quarantine_working(corrupt_store, monkeypatch):
    monkeypatch.setenv(tlineage.LINEAGE_ENV_VAR, '0')
    kw = dict(reader_pool_type='dummy', num_epochs=1,
              on_decode_error='quarantine')
    ref = _consume('jax', 'columnar', corrupt_store, **kw)
    got = _consume('torch', 'columnar', corrupt_store, **kw)
    assert got == ref and len(got[0]) == ROWS - 3 and len(got[2]) == 2


@pytest.mark.cuda
def test_lineage_batches_stage_to_the_card(store):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the loader stages to the card')
    with petastorm_tpu_torch.make_columnar_reader(
            store, num_epochs=1, workers_count=2) as reader:
        loader = TorchDataLoader(reader, batch_size=8)
        rows = 0
        for batch in loader.iter_prefetched():
            assert batch['idx'].is_cuda
            prov = batch['_provenance']
            assert isinstance(prov, tlineage.BatchProvenance)
            assert len(prov) == len(batch['idx'])
            again = reader.replay(batch)
            assert np.array_equal(again['idx'], batch['idx'].cpu().numpy())
            rows += len(prov)
        assert rows == ROWS
        reader.audit().assert_complete()


@pytest.mark.parametrize('policy', ['skip', 'quarantine'])
def test_ngram_corruption_quarantines_the_item_as_jax(corrupt_store, policy):
    """A window item is quarantined whole (a dropped row would shift every
    window after it), with the row group's row count, as in JAX."""
    got = {}
    for package, gram in (('jax', JNGram), ('torch', NGram)):
        with _open(package, 'row', corrupt_store, reader_pool_type='dummy',
                   num_epochs=1, seed=0, on_decode_error=policy,
                   schema_fields=gram({0: ['idx', 'image'], 1: ['idx']}, 1,
                                      'idx')) as reader:
            chunks = list(reader.iter_ngram_chunks())
            got[package] = (sum(len(c) for c in chunks), _records(reader),
                            _quarantines(reader), _report(reader))
    assert got['torch'] == got['jax']
    windows, records, quarantines, report = got['torch']
    verdict = report['epochs'][0]
    assert windows and len(records) == verdict['items_ventilated'] - 2
    if policy == 'skip':
        # no record: the audit reads the 2 items as dropped, as JAX's
        assert quarantines == [] and len(verdict['dropped_items']) == 2
        return
    assert sorted((q['row_group'], q['rows'], q['stage'])
                  for q in quarantines) == [(0, 7, 'decode'), (1, 7, 'decode')]
    assert 'field' not in quarantines[0]
    assert report['complete'] and len(verdict['quarantined_items']) == 2


def test_epoch_caches_keep_batch_provenance(store):
    from petastorm_tpu_torch.torch_utils import epoch_cache_on_device
    with petastorm_tpu_torch.make_columnar_reader(
            store, reader_pool_type='dummy', num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu',
                                 inmemory_cache_all=True)
        first = list(loader)
        again = list(loader)                  # from memory, no reader pass
        assert [b['_provenance'] for b in again] == \
            [b['_provenance'] for b in first]
        assert all(isinstance(b['_provenance'], tlineage.BatchProvenance)
                   for b in first)
        staged = epoch_cache_on_device(loader, device='cpu')
        for want in first:
            got = next(staged)
            assert got['_provenance'] is want['_provenance']
            assert torch.equal(got['idx'], want['idx'])
        assert reader.lineage.passes == 0
        reader.audit().assert_complete()
