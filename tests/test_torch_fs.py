"""The port's URL resolution and HDFS namenode layer against the JAX
package's, on the CPU (no network: remote stores are fsspec ``memory://``).

A table of URLs gives equal ``_parse_url`` results and equal errors,
relative paths kept as given included; ``get_dataset_path`` and the
one-filesystem rule; ``FilesystemFactory`` pickles (and dill-pickles) with
its ``storage_options`` and resolves afresh in a ``python -S`` interpreter,
as a process-pool worker does; a missing fsspec names the scheme;
``LOCAL_FILESYSTEM`` lists a store as fsspec's local filesystem does;
``memory://`` stores written by either package read by all three
factories of both with equal rows; a relative URL read by JAX, then by the
port, over one ``local-disk`` root and one ``shared`` root adds no entry;
and the HDFS resolver, failover and ``_resolve_hdfs_namenodes`` on the same
Hadoop XML and fake connectors. Tests that start interpreters carry a
``timeout`` mark.
"""

import os
import pickle
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu import fs as jfs
from petastorm_tpu.codecs import NdarrayCodec as JNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JScalarCodec
from petastorm_tpu.etl.dataset_metadata import \
    materialize_dataset as jmaterialize
from petastorm_tpu.hdfs import namenode as jnamenode
from petastorm_tpu.unischema import Unischema as JUnischema
from petastorm_tpu.unischema import UnischemaField as JUnischemaField

import petastorm_tpu_torch
from petastorm_tpu_torch import fs as tfs
from petastorm_tpu_torch import materialize_dataset
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.hdfs import namenode as tnamenode
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

REPO = Path(__file__).resolve().parent.parent
ROWS = 30

URLS = [
    'store', './a/b', 'a/b/', '/abs/path', 'file:///abs/path',
    'file://localhost/abs/path', 'FILE:///Upper', 's3://bucket/key/x',
    's3a://bucket/key', 's3n://bucket/key', 'gs://bucket/key',
    'gcs://bucket/key', 'memory://bucket/store', 'memory:///rooted',
    'hdfs://nameservice1/data', 'hdfs://host:8020/data', 'hdfs:///data',
    # errors: the file:// typo, and schemes neither package takes
    'file://tmp/x', 'ftp://host/x', 'bogus://x', 'http://host/x',
]


def _outcome(fn, *args):
    try:
        return ('ok', fn(*args))
    except Exception as e:   # the error and its words are the result
        return ('raise', type(e).__name__, str(e))


@pytest.mark.parametrize('url', URLS)
def test_parse_url_as_jax(url):
    assert _outcome(tfs._parse_url, url) == _outcome(jfs._parse_url, url)
    assert _outcome(tfs.get_dataset_path, url) == \
        _outcome(jfs.get_dataset_path, url)


@pytest.mark.parametrize('url', ['store', 'a/b', '../up/x', './here'])
def test_relative_paths_stay_as_given(url):
    """F1: a scheme-less path is not made absolute (the store's path enters
    cache keys, piece paths and provenance records)."""
    assert tfs._parse_url(url) == ('file', url) == jfs._parse_url(url)


@pytest.mark.parametrize('urls', [['file:///a', 's3://bucket/b'],
                                  ['memory://x/a', 'file:///b'],
                                  ['bogus://x']])
def test_one_filesystem_rule_as_jax(urls):
    assert _outcome(lambda u: tfs.get_filesystem_and_path_or_paths(u)[1],
                    urls) == \
        _outcome(lambda u: jfs.get_filesystem_and_path_or_paths(u)[1], urls)


def test_url_list_resolves_to_one_filesystem(tmp_path):
    urls = ['file://' + str(tmp_path / 'a.parquet'), str(tmp_path / 'b')]
    fs, paths, factory = tfs.get_filesystem_and_path_or_paths(urls)
    assert fs is tfs.LOCAL_FILESYSTEM and factory.protocol == 'file'
    assert paths == jfs.get_filesystem_and_path_or_paths(urls)[1]


@pytest.mark.parametrize('dumps', ['pickle', 'dill'])
def test_filesystem_factory_pickles_with_its_options(dumps):
    import dill
    mod = {'pickle': pickle, 'dill': dill}[dumps]
    options = {'skip_instance_cache': True, 'anything': [1, 2]}
    factory = tfs.FilesystemFactory('memory', options)
    copy = mod.loads(mod.dumps(factory))
    assert copy.protocol == 'memory'
    assert copy.storage_options == options
    assert type(copy()).__name__ == 'MemoryFileSystem'
    assert repr(copy) == repr(jfs.FilesystemFactory('memory', options))
    local = mod.loads(mod.dumps(tfs.FilesystemFactory('file')))
    assert local() is tfs.LOCAL_FILESYSTEM


@pytest.mark.timeout(120)
def test_factory_resolves_afresh_in_a_worker_interpreter(tmp_path):
    """The factory crosses into a ``python -S`` interpreter, as the process
    pool sends it, and resolves there through fsspec."""
    import dill
    factory = tfs.FilesystemFactory('memory', {'skip_instance_cache': True})
    blob = tmp_path / 'factory.dill'
    blob.write_bytes(dill.dumps(factory))
    code = ('import dill, sys\n'
            'f = dill.load(open(sys.argv[1], "rb"))\n'
            'fs = f()\n'
            'with fs.open("/probe/x.bin", "wb") as out: out.write(b"abc")\n'
            'print(type(fs).__name__, f.storage_options, fs.size("/probe/x.bin"),'
            ' "fsspec" in sys.modules, "torch" in sys.modules)\n')
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO)] + [p for p in sys.path
                                                         if p]))
    out = subprocess.run([sys.executable, '-S', '-c', code, str(blob)],
                         capture_output=True, text=True, timeout=100, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ['MemoryFileSystem',
                                  "{'skip_instance_cache':", 'True}', '3',
                                  'True', 'False']


def test_missing_fsspec_names_the_scheme(monkeypatch):
    monkeypatch.setitem(sys.modules, 'fsspec', None)
    with pytest.raises(ImportError, match="'s3' url scheme needs fsspec"):
        tfs.get_filesystem_and_path_or_paths('s3://bucket/store')
    # the local path needs no filesystem package
    fs, path, _ = tfs.get_filesystem_and_path_or_paths('store')
    assert fs is tfs.LOCAL_FILESYSTEM and path == 'store'


def test_local_filesystem_lists_as_fsspec(tmp_path, monkeypatch):
    import fsspec
    (tmp_path / 'store' / 'k=1').mkdir(parents=True)
    for name in ('store/b.parquet', 'store/a.parquet', 'store/k=1/c.parquet',
                 'store/_common_metadata'):
        (tmp_path / name).write_bytes(b'x' * len(name))
    monkeypatch.chdir(tmp_path)
    local = fsspec.filesystem('file')
    fs = tfs.LOCAL_FILESYSTEM
    assert fs.protocol == 'file' == local.protocol[0]
    for path in ('store', str(tmp_path / 'store')):
        assert fs.find(path) == local.find(path)
    assert fs.size('store/a.parquet') == local.size('store/a.parquet')
    assert fs.exists('store') and not fs.exists('store/none')


def _schemas():
    t = Unischema('Mem', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (5,), NdarrayCodec(), False)])
    j = JUnischema('Mem', [
        JUnischemaField('idx', np.int64, (), JScalarCodec(), False),
        JUnischemaField('vec', np.float32, (5,), JNdarrayCodec(), False)])
    return {'torch': (t, materialize_dataset), 'jax': (j, jmaterialize)}


def _row(i):
    return {'idx': np.int64(i),
            'vec': np.arange(5, dtype=np.float32) + np.float32(i)}


def _rows(reader, batched):
    out = {}
    for item in reader:
        if batched:
            for i, v in zip(item.idx, item.vec):
                out[int(i)] = np.asarray(v).tolist()
        else:
            out[int(item.idx)] = np.asarray(item.vec).tolist()
    return out


FACTORIES = ['make_reader', 'make_columnar_reader', 'make_batch_reader']


@pytest.mark.parametrize('writer', ['torch', 'jax'])
@pytest.mark.parametrize('factory', FACTORIES)
def test_memory_store_reads_as_jax(writer, factory):
    url = 'memory://bucket-{}/store'.format(uuid.uuid4().hex[:8])
    schema, materialize = _schemas()[writer]
    with materialize(url, schema, rows_per_file=10,
                     row_group_size_mb=0.0005) as w:
        w.write_rows(_row(i) for i in range(ROWS))
    batched = factory != 'make_reader'
    kw = dict(workers_count=2, shuffle_row_groups=False)
    with getattr(petastorm_tpu_torch, factory)(url, **kw) as reader:
        got = _rows(reader, batched)
        pieces = [(p.path, p.row_group) for p in reader.pieces]
    with getattr(petastorm_tpu, factory)(url, **kw) as reader:
        want = _rows(reader, batched)
        jpieces = [(p.path, p.row_group) for p in reader._pieces]
    if factory == 'make_batch_reader':
        # as arrow stores it: the codec's bytes
        assert sorted(got) == sorted(want) == list(range(ROWS))
    else:
        assert got == want and sorted(got) == list(range(ROWS))
    assert pieces == jpieces
    assert pieces[0][0].startswith('/bucket-')


def _relative_store(tmp_path):
    schema, materialize = _schemas()['jax']
    with materialize('store', schema, rows_per_file=10,
                     row_group_size_mb=0.0005) as w:
        w.write_rows(_row(i) for i in range(ROWS))


def _entries(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob('*')
                  if p.is_file() and 'counters' not in p.parts
                  and 'pins' not in p.parts and 'locks' not in p.parts)


@pytest.mark.parametrize('cache_type', ['local-disk', 'shared'])
def test_relative_url_hits_the_jax_entries(tmp_path, monkeypatch,
                                           cache_type):
    """F1: JAX fills a root from a relative URL; the port's pass over the
    same URL and root adds no entry and gives JAX's rows."""
    monkeypatch.chdir(tmp_path)
    _relative_store(tmp_path)
    root = tmp_path / 'cache'
    mem = tmp_path / 'mem'
    extra = {'mem_dir': str(mem)} if cache_type == 'shared' else None
    kw = dict(cache_type=cache_type, cache_location=str(root),
              cache_size_limit=1 << 26, cache_extra_settings=extra,
              workers_count=1, shuffle_row_groups=False)
    with petastorm_tpu.make_columnar_reader('store', **kw) as reader:
        want = _rows(reader, True)
    filled = _entries(root) + _entries(mem)
    assert filled, 'JAX filled nothing'
    with petastorm_tpu_torch.make_columnar_reader('store', **kw) as reader:
        got = _rows(reader, True)
        assert reader.dataset_path == 'store'
        assert reader.pieces[0].path == 'store/part_00000.parquet'
        groups = len(reader.pieces)
    assert _entries(root) + _entries(mem) == filled
    assert got == want
    if cache_type == 'shared':
        totals = tshared_totals(root)
        # JAX's pass filled every group once; the port's only hit
        assert totals['fills'] == groups and totals['hits'] == groups


def tshared_totals(root):
    from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
    return SharedRowGroupCache.global_counters(str(root))


# -- HDFS --------------------------------------------------------------------

HA_CONFIG = {
    'fs.defaultFS': 'hdfs://nameservice1',
    'dfs.ha.namenodes.nameservice1': 'nn1,nn2',
    'dfs.namenode.rpc-address.nameservice1.nn1': 'host1:8020',
    'dfs.namenode.rpc-address.nameservice1.nn2': 'host2:8020',
}
NAMENODE = {'jax': jnamenode, 'torch': tnamenode}


@pytest.mark.parametrize('config,service', [
    (HA_CONFIG, 'nameservice1'), (HA_CONFIG, 'other'),
    ({'fs.defaultFS': 'hdfs://single:8020'}, 'single:8020'),
    ({'dfs.ha.namenodes.ns': 'a,b'}, 'ns'), ({}, 'nameservice1')])
def test_namenode_resolution_as_jax(config, service):
    def resolve(mod):
        r = mod.HdfsNamenodeResolver(dict(config))
        return (_outcome(r.resolve_hdfs_name_service, service),
                _outcome(r.resolve_default_hdfs_service))
    got, want = resolve(tnamenode), resolve(jnamenode)
    # the error classes are each package's own: compare names and words
    assert got == want


def _hadoop_home(tmp_path, monkeypatch):
    conf_dir = tmp_path / 'etc' / 'hadoop'
    conf_dir.mkdir(parents=True)
    (conf_dir / 'core-site.xml').write_text(
        '<configuration><property><name>fs.defaultFS</name>'
        '<value>hdfs://ns1</value></property></configuration>')
    (conf_dir / 'hdfs-site.xml').write_text(
        '<configuration>'
        '<property><name>dfs.ha.namenodes.ns1</name><value>a,b</value>'
        '</property><property><name>dfs.namenode.rpc-address.ns1.a</name>'
        '<value>h1:8020</value></property><property>'
        '<name>dfs.namenode.rpc-address.ns1.b</name><value>h2:8020</value>'
        '</property></configuration>')
    monkeypatch.setenv('HADOOP_HOME', str(tmp_path))


def test_hadoop_xml_and_name_service_urls_as_jax(tmp_path, monkeypatch):
    _hadoop_home(tmp_path, monkeypatch)
    for mod in (tnamenode, jnamenode):
        assert mod.HdfsNamenodeResolver().resolve_default_hdfs_service() == \
            ['ns1', ['h1:8020', 'h2:8020']]
    for url in ('hdfs://ns1/data', 'hdfs://host:8020/data', 'hdfs:///data',
                'hdfs://unknown/data'):
        assert tfs._resolve_hdfs_namenodes(url) == \
            jfs._resolve_hdfs_namenodes(url)
    assert tfs._resolve_hdfs_namenodes('hdfs://ns1/data') == ['h1:8020',
                                                              'h2:8020']


def test_name_service_url_routes_through_the_ha_client(tmp_path,
                                                       monkeypatch):
    _hadoop_home(tmp_path, monkeypatch)
    sentinel = object()
    captured = {}

    def fake_connect(namenodes):
        captured['namenodes'] = namenodes
        return sentinel

    monkeypatch.setattr(tnamenode.HdfsConnector, 'connect_to_either_namenode',
                        staticmethod(fake_connect))
    fs, path, factory = tfs.get_filesystem_and_path_or_paths(
        'hdfs://ns1/data')
    assert fs is sentinel and path == '/data'
    assert captured['namenodes'] == ['h1:8020', 'h2:8020']
    assert pickle.loads(pickle.dumps(factory))() is sentinel


class _FlakyFs(object):
    """Fails N times, then answers with the namenode that served."""

    def __init__(self, host, state):
        self.host = host
        self._state = state
        state['connects'].append(host)

    def ls(self, path):
        if self._state['remaining'] > 0:
            self._state['remaining'] -= 1
            raise IOError('connection refused')
        return ['{}:{}'.format(self.host, path)]


class _MissingFileFs(object):
    def __init__(self, host, state):
        state['connects'].append(host)

    def ls(self, path):
        raise FileNotFoundError(path)


@pytest.mark.parametrize('fs_cls,fails', [(_FlakyFs, 0), (_FlakyFs, 1),
                                          (_FlakyFs, 2), (_FlakyFs, 10),
                                          (_MissingFileFs, 0)])
def test_failover_as_jax(fs_cls, fails):
    def run(mod):
        state = {'remaining': fails, 'connects': []}
        client = mod.HAHdfsClient(lambda host: fs_cls(host, state),
                                  ['nn1:8020', 'nn2:8020'])
        try:
            result = ('ok', client.ls('/x'))
        except Exception as e:   # which error, and after which reconnects
            result = ('raise', type(e).__name__)
        return result, state['connects']
    assert run(tnamenode) == run(jnamenode)


def test_unreachable_namenodes_raise_as_jax():
    def refuse(host):
        raise IOError('refused ' + host)
    for mod in (tnamenode, jnamenode):
        with pytest.raises(mod.HdfsConnectError, match='Could not connect'):
            mod.HAHdfsClient(refuse, ['nn1:8020', 'nn2:8020'])
