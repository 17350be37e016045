"""The commands of the port's last fifteen benchmark twins against the JAX
package's, on the CPU: each ``main`` parser has JAX's option strings, plus
``--device`` on the six twins that work on a device (``scaling``, which
JAX runs from ``sys.argv``, takes its output path as an optional
argument); without CUDA and without ``--device cpu`` those six raise a
``RuntimeError`` that names ``--device cpu``, and their ``run`` functions
one that names ``device='cpu'``, before any work."""

import argparse
import importlib

import pytest
import torch

HOST_TWINS = ('transport', 'readahead', 'shared_cache', 'chaos',
              'object_store', 'trace_overhead', 'health_overhead', 'podobs',
              'podelastic')
DEVICE_TWINS = ('decode_batch', 'roofline', 'autotune', 'lineage_overhead',
                'latency_overhead')


class _Parsed(Exception):
    pass


def parser_of(main, monkeypatch):
    """The parser ``main`` builds (it is stopped at ``parse_args``)."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed()

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', capture)
    with pytest.raises(_Parsed):
        main([])
    return seen[0]


def option_strings(main, monkeypatch):
    return {s for action in parser_of(main, monkeypatch)._actions
            for s in action.option_strings}


def modules(name):
    return (importlib.import_module('petastorm_tpu.benchmark.' + name),
            importlib.import_module('petastorm_tpu_torch.benchmark.' + name))


@pytest.mark.parametrize('name', HOST_TWINS + DEVICE_TWINS)
def test_options_are_jaxs(name, monkeypatch):
    jax_, port = modules(name)
    want = option_strings(jax_.main, monkeypatch)
    got = option_strings(port.main, monkeypatch)
    extra = {'--device'} if name in DEVICE_TWINS else set()
    assert got == want | extra


def test_scaling_options(monkeypatch):
    from petastorm_tpu_torch.benchmark import scaling
    assert option_strings(scaling.main, monkeypatch) == {'-h', '--help',
                                                         '--device'}
    positional = [a for a in parser_of(scaling.main, monkeypatch)._actions
                  if not a.option_strings]
    assert [(a.dest, a.nargs, a.default) for a in positional] == [
        ('output', '?', None)]


@pytest.mark.parametrize('name', DEVICE_TWINS + ('scaling',))
def test_command_without_cuda_names_device_cpu(name, monkeypatch):
    _, port = modules(name)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        port.main(['--quick'] if name != 'scaling' else [])


@pytest.mark.parametrize('name', DEVICE_TWINS + ('scaling',))
def test_run_without_cuda_names_device_cpu(name, monkeypatch):
    _, port = modules(name)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    run = (port.run if name == 'scaling' else
           getattr(port, 'run_{}_bench'.format(name)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run() if name == 'scaling' else run(quick=True)


@pytest.mark.parametrize('name', HOST_TWINS)
def test_host_twins_take_no_device(name):
    import inspect
    _, port = modules(name)
    run = getattr(port, 'run_{}_bench'.format(name))
    assert 'device' not in inspect.signature(run).parameters


@pytest.mark.parametrize('value,op,bar,held', [
    (1.5, '>=', 1.5, True), (1.49, '>=', 1.5, False), (0.0, '>', 0.0, False),
    (15.0, '<=', 15.0, True), (25.0, '<', 25.0, False), (None, '<', 5.0,
                                                         False)])
def test_bar_held(value, op, bar, held):
    from petastorm_tpu_torch.benchmark import bar_held
    assert bar_held(value, op, bar) is held


def test_assert_bars_names_the_missed_bar():
    from petastorm_tpu_torch.benchmark import assert_bars
    assert_bars([('speedup', 2.0, '>=', 1.5), ('overhead %', 3.0, '<', 5.0)])
    with pytest.raises(AssertionError, match=r'overhead %: measured 7\.0, '
                                             r'bar < 5\.0'):
        assert_bars([('speedup', 2.0, '>=', 1.5),
                     ('overhead %', 7.0, '<', 5.0)])
