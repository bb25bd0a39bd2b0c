"""Small host-side IO helpers (a copy of neuron_gan_tpu/utils/io.py)."""

import sys


def validated_input(prompt: str, validate_func, invalid_ans_msg='Invalid answer.', default=None):
    """Prompt until the answer validates (reference: utils.py:234-245).

    Non-interactive safety (new): when stdin is not a TTY and a ``default`` is
    provided, return the default instead of blocking — lets the same CLIs run
    under CI/batch schedulers.
    """
    if not prompt.endswith('\n'):
        prompt += '\n'

    if default is not None and not sys.stdin.isatty():
        print(prompt + f'[non-interactive: using default "{default}"]')
        return default

    while True:
        ans = input(prompt)
        if validate_func(ans):
            return ans
        print(invalid_ans_msg)


def is_computer_remote():
    """Hostname check kept for parity (reference: utils.py:228-230)."""
    import socket
    return 'Hephaistos' not in socket.gethostname()
