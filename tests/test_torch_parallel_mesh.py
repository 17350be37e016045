"""The port's mesh and sharding records against the JAX package's.

``petastorm_tpu_torch.parallel.mesh`` is held against
``petastorm_tpu.parallel.mesh``: ``make_mesh``'s count error in JAX's
words, ``host_shard`` without a process group, and, on a 4-rank gloo mesh
``{'data': 2, 'seq': 2}`` (ranks started by ``launch_ranks`` over a
``FileStore`` under ``tmp_path``), each rank's axes and coordinates, its
``host_shard``, and the block each spec gives it equal to the block JAX's
``NamedSharding`` gives the device at the same place of
``make_mesh({'data': 2, 'seq': 2})`` on 4 virtual CPU devices; the
blocks gathered back equal the global array. Tolerance: exact.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from petastorm_tpu.parallel import batch_sharding as jbatch_sharding
from petastorm_tpu.parallel import host_shard as jhost_shard
from petastorm_tpu.parallel import make_mesh as jmake_mesh

import petastorm_tpu_torch
from petastorm_tpu_torch import parallel as tparallel
from petastorm_tpu_torch.parallel import launch_ranks
from petastorm_tpu_torch.parallel import mesh as tmesh

SHAPE = (8, 16)
SPECS = [('data',), ('data', 'seq'), (None, 'seq'), ('seq',), ()]


@pytest.fixture(scope='module')
def facts(tmp_path_factory):
    return launch_ranks('torch_mesh_ranks:mesh_facts', 4,
                        str(tmp_path_factory.mktemp('mesh')),
                        args=(SHAPE, SPECS), timeout_s=240)


def test_make_mesh_count_error_in_jax_words():
    with pytest.raises(ValueError) as jerr:
        jmake_mesh({'data': 2}, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as terr:
        tparallel.make_mesh({'data': 2}, 'cpu')    # a world of one rank
    assert str(terr.value) == str(jerr.value)


def test_make_mesh_needs_a_process_group_and_cuda(monkeypatch):
    with pytest.raises(RuntimeError, match='process group'):
        tparallel.make_mesh({'data': 1}, 'cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tparallel.make_mesh({'data': 1})


def test_host_shard_without_a_process_group_is_jax_single_process():
    assert tparallel.host_shard() == jhost_shard() == (0, 1)


def test_sharding_records_without_ranks():
    mesh = object()
    assert tparallel.batch_sharding(mesh).spec == ('data',)
    assert tparallel.batch_sharding(mesh, 'seq').spec == ('seq',)
    assert tparallel.replicated_sharding(mesh).spec == ()
    jmesh = jmake_mesh({'data': 2}, devices=jax.devices()[:2])
    assert tuple(jbatch_sharding(jmesh).spec) == \
        tparallel.batch_sharding(mesh).spec


@pytest.mark.timeout(300)
def test_mesh_axes_coordinates_and_host_shard(facts):
    for rank, f in enumerate(facts):
        assert f['names'] == ('data', 'seq')
        assert f['shape'] == (2, 2)
        assert f['coords'] == (rank // 2, rank % 2)
        assert f['device_type'] == 'cpu'
        assert f['host_shard'] == (rank, 4)
        assert f['batch'] == ('data',)


@pytest.mark.timeout(300)
@pytest.mark.parametrize('spec', SPECS)
def test_blocks_equal_jax_named_sharding(facts, spec):
    jmesh = jmake_mesh({'data': 2, 'seq': 2}, devices=jax.devices()[:4])
    index = JNamedSharding(jmesh, P(*spec)).devices_indices_map(SHAPE)
    full = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    for rank, f in enumerate(facts):
        want = index[jmesh.devices.flat[rank]]
        got = f['blocks'][spec]
        assert got == [sl.indices(n)[:2] for sl, n in zip(want, SHAPE)]
        np.testing.assert_array_equal(f['gathered'][spec], full)


def test_shard_slices_raise_on_an_uneven_split():
    class Mesh:
        mesh_dim_names = ('data',)
        shape = (3,)

        def get_local_rank(self, axis):
            return 1
    sharding = tmesh.NamedSharding(Mesh(), ('data',))
    assert sharding.shard_slices((6, 2)) == (slice(2, 4), slice(0, 2))
    with pytest.raises(ValueError, match="mesh axis 'data'"):
        sharding.shard_slices((8, 2))


@pytest.mark.timeout(120)
def test_launcher_results_failures_and_time_limit(tmp_path):
    assert launch_ranks('torch_mesh_ranks:fail_or_sleep', 2,
                        str(tmp_path / 'ok'), timeout_s=60) == [0, 1]
    with pytest.raises(RuntimeError,
                       match='(?s)rank 1 of 2 failed.*fails on purpose'):
        launch_ranks('torch_mesh_ranks:fail_or_sleep', 2,
                     str(tmp_path / 'fail'), kwargs={'fail_rank': 1},
                     timeout_s=60)
    with pytest.raises(RuntimeError,
                       match='rank 0 of 2 overran the time limit'):
        launch_ranks('torch_mesh_ranks:fail_or_sleep', 2,
                     str(tmp_path / 'late'),
                     kwargs={'sleep_rank': 0, 'seconds': 60}, timeout_s=8)


@pytest.mark.timeout(120)
def test_launcher_retries_a_failed_rendezvous(tmp_path):
    """A rank failing inside ``init_process_group`` starts the launch again
    over a fresh store, ``RENDEZVOUS_ATTEMPTS`` times in all, then fails
    naming the rank and its error."""
    from petastorm_tpu_torch.parallel import launch
    store = tmp_path / 'rdv'
    with pytest.raises(RuntimeError, match='(?s)rank [01] of 2 failed.*'
                       'Unknown backend type no-such-backend'):
        launch_ranks('torch_mesh_ranks:fail_or_sleep', 2, str(store),
                     backend='no-such-backend', timeout_s=100)
    runs = [store] + [store / ('retry-%d' % i)
                      for i in range(1, launch.RENDEZVOUS_ATTEMPTS)]
    assert all(any(run.glob('rank-*.rendezvous')) for run in runs)
    assert not (store / ('retry-%d' % launch.RENDEZVOUS_ATTEMPTS)).exists()


def test_public_names():
    for name in ('make_mesh', 'host_shard', 'batch_sharding',
                 'replicated_sharding', 'ring_attention', 'launch_ranks'):
        assert getattr(petastorm_tpu_torch, name) is getattr(tparallel, name)
        assert name in petastorm_tpu_torch.__all__
    assert set(tparallel.__all__) >= {'make_mesh', 'host_shard',
                                      'batch_sharding', 'replicated_sharding',
                                      'ring_attention'}
