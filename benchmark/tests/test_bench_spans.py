"""The device-idle readers of the port's stage spans (benchmark/spans.py and
metrics/idle_ms_per_step.*): on a trace built from hand-made events, and
on a traced run of the tiny benchmark on the CPU, with and without the
program's spans."""

import contextlib

import pytest

from benchmark import spans
from benchmark.harness import Bench, Reading, run_cell
from benchmark.trace import Trace

GROUPS = ('augment', 'critic', 'generator', 'optimizer', 'outside')
US = 1000   # ns


def _events(extra=()):
    """Kernels busy 0-10, 20-30, 60-70, 100-120 us; on the main thread the
    spans draws 5-15, augment 15-40 (an operator inside it), critic_loss
    40-65, gen_adam 90-110, and an operator outside every span 70-80; the
    autograd thread runs a node 45-62; a launch call at 1 us."""
    ev = [('kernel', 'k', s * US, e * US, 0)
          for s, e in ((0, 10), (20, 30), (60, 70), (100, 120))]
    ev += [('cpu_op', name, s * US, e * US, 1)
           for name, s, e in (('step.draws', 5, 15), ('step.augment', 15, 40),
                              ('step.critic_loss', 40, 65),
                              ('step.gen_adam', 90, 110))]
    ev += [('cpu_op', 'aten::add', 16 * US, 20 * US, 1),
           ('cpu_op', 'aten::copy_', 70 * US, 80 * US, 1),
           ('cpu_op', 'autograd::engine::evaluate_function: X', 45 * US,
            62 * US, 2),
           ('cuda_runtime', 'cudaLaunchKernel', 1 * US, 2 * US, 1)]
    return ev + list(extra)


def _read(trace, units=2, kind='train'):
    r = Reading(kind, trace, units, 1.0, 1.0, 1.0, None, {}, 2)
    return {g: Bench().reader(f'idle_ms_per_step.{g}')(r) for g in GROUPS}


def test_idle_by_stage_group():
    got = _read(Trace(_events()))
    # idle: draws 5, augment 15, critic_loss 20, gen_adam 10, outside
    # 70-90 (the copy's 10 and 10 more): 20 us, over 2 steps
    want = {'augment': 0.010, 'critic': 0.010, 'generator': 0.0,
            'optimizer': 0.005, 'outside': 0.010}
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize('extra', [
    (),
    # a span on another thread over the others: each instant counted once
    (('cpu_op', 'step.ema', 50 * US, 95 * US, 3),),
    # a span nested in another: the outer one takes the time
    (('cpu_op', 'step.gen_loss', 20 * US, 25 * US, 1),)])
def test_readings_add_up_to_the_idle_time(extra):
    tr = Trace(_events(extra))
    got = _read(tr)
    idle_ms = (tr.window_s - tr.busy_s) / 2 * 1e3
    assert sum(got.values()) == pytest.approx(idle_ms, rel=1e-9)


def test_a_gap_outside_every_span_goes_to_outside():
    ev = [e for e in _events() if not e[1].startswith('step.')]
    ev.append(('cpu_op', 'step.draws', 0, 10 * US, 1))
    got = _read(Trace(ev))
    assert got['augment'] == 0.0
    assert got['outside'] == pytest.approx(70 / 2 / 1e3, rel=1e-12)


def test_no_step_span_reads_none():
    ev = [e for e in _events() if not e[1].startswith('step.')]
    assert _read(Trace(ev)) == dict.fromkeys(GROUPS)
    assert spans.idle_s(Trace(ev)) is None
    # a sampling run reads none either
    assert _read(Trace(_events()), kind='sample') == dict.fromkeys(GROUPS)


@pytest.mark.parametrize('with_spans', (True, False))
def test_traced_run_of_the_program(tiny, monkeypatch, with_spans):
    """The program's own spans in a traced run give all five readings,
    which add up to device_idle_pct.train's share of the window; a program
    without spans (as an older commit) gives none."""
    if not with_spans:
        from neuron_gan_tpu_torch import train_step
        monkeypatch.setattr(train_step, 'span',
                            lambda name: contextlib.nullcontext())
    res, out = run_cell('neuron512_ship.steady512', 5, 0.2, True, 'cpu',
                        bench=tiny)
    got = {g: res['metrics'].get(f'idle_ms_per_step.{g}') for g in GROUPS}
    if not with_spans:
        assert got == dict.fromkeys(GROUPS)
        return
    r = out['reading']
    idle_ms = (res['metrics']['device_idle_pct.train']['value'] / 100
               * r.trace.window_s / r.units * 1e3)
    assert all(v['unit'] == 'ms' for v in got.values())
    assert sum(v['value'] for v in got.values()) == pytest.approx(
        idle_ms, rel=1e-9)
    assert got['critic']['value'] > 0 and got['generator']['value'] > 0
