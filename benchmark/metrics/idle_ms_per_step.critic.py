"""Device-idle ms a traced training step while the host runs the critic
update's G forwards, critic loss, gradient penalty and backward (the
step.critic_fakes, step.critic_loss, step.grad_penalty and
step.critic_backward spans; benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.idle_ms_per_step(r, 'critic')
