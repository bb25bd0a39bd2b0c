"""The training step's stage spans (runtime/timing.py::span): one step of
the shipping configuration at phase 0 on the CPU emits them flat, in the
order it runs its stages, on one thread, as host operators (no user
annotation, which the profiler would copy onto the device's timeline);
with no profiler running a span enters no profiler record."""

import numpy as np
import pytest
import torch

from neuron_gan_tpu_torch import flagship
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
from neuron_gan_tpu_torch.runtime import timing
from neuron_gan_tpu_torch.train_step import init_train_state, make_epoch_runner

CRITIC = ['step.critic_fakes', 'step.critic_loss', 'step.grad_penalty',
          'step.critic_backward', 'step.critic_adam']
GENERATOR = ['step.gen_loss', 'step.gen_backward', 'step.gen_adam']


def one_step(reuse, ema_beta=0.0):
    """(run, state, stack, rng) of one shipping step at phase 0: one epoch
    of one batch."""
    cfg = flagship.flagship_shipping_config()
    spec = flagship.flagship_shipping_chunk_spec(
        0, gp_reuse_fakes=reuse, ema_beta=ema_beta, n_images=8)
    init = torch.Generator().manual_seed(0)
    state = init_train_state(GeneratorPG(cfg, init, device='cpu'),
                             DiscriminatorPG(cfg, init, device='cpu'),
                             spec.beta1, ema_beta=ema_beta)
    stack = torch.from_numpy(np.random.default_rng(1).random(
        (8, 768, 768, 1)).astype(np.float32))
    return (make_epoch_runner(cfg, spec, 1), state, stack,
            torch.Generator().manual_seed(2))


def expected(reuse, ema_beta):
    critic = list(CRITIC)
    if not reuse:
        # the penalty's fresh fakes, after the critic loss
        critic.insert(2, 'step.critic_fakes')
    return (['step.draws', 'step.augment'] + critic + GENERATOR
            + (['step.ema'] if ema_beta > 0 else []))


@pytest.mark.parametrize('reuse,ema_beta', [(False, 0.0), (True, 0.0),
                                            (True, 0.999)])
def test_step_emits_its_stage_spans_in_order(reuse, ema_beta):
    run, state, stack, rng = one_step(reuse, ema_beta)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        stats = run(state, stack, rng, 1)
    assert torch.isfinite(stats).all()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                    e.start_thread_id(), e.activity_type())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith('step.'))
    assert [s[2] for s in spans] == expected(reuse, ema_beta)
    assert len({s[3] for s in spans}) == 1
    assert {s[4] for s in spans} == {'cpu_op'}
    # flat: each ends before the next starts
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    run, state, stack, rng = one_step(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(timing.span('step.x'),
                          torch._C._profiler._RecordFunctionFast)

    def refused(name):
        raise AssertionError(f'a profiler record of {name!r} with no '
                             f'profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', refused)
    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', refused)
    assert timing.span('step.x') is timing.span('step.y')
    assert torch.isfinite(run(state, stack, rng, 1)).all()
