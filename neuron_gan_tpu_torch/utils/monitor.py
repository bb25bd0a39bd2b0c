"""Monitoring: adaptive critic steps, progress bar, memory logger.

Ports of reference utils.py:105-120 (Calculate_D_steps), :360-421
(ProgressBar), :425-543 (Memory_logger), :279-292 (print_monitored_vals);
a copy of neuron_gan_tpu/utils/monitor.py.  ``MemoryLogger`` needs psutil
(and matplotlib for its PNG), which a machine may lack: it is off the
training path and raises only when constructed.
"""

import os
import sys
import time
import threading
from collections import OrderedDict

import numpy as np


def calculate_d_steps(loss_real, loss_fake, n_min, n_max, period):
    """Adaptive critic-step count (reference utils.py:105-120)."""
    loss_real = np.asarray(loss_real)
    loss_fake = np.asarray(loss_fake)
    if loss_real.size and loss_fake.size:
        d_loss_real_std = np.std(loss_real[-period:])
        d_loss_diff = np.mean(np.abs(np.subtract(loss_fake[-period:],
                                                 loss_real[-period:])))
        with np.errstate(divide='ignore', invalid='ignore'):
            n_steps = np.round(d_loss_real_std / d_loss_diff * n_max)
        if not np.isfinite(n_steps):
            n_steps = n_max
        n_steps = int(np.clip(n_steps, n_min, n_max))
    else:
        n_steps = n_max
    return n_steps


def print_monitored_vals(monitor_dict: OrderedDict):
    strings = []
    for prop_str, prop_value in monitor_dict.items():
        if isinstance(prop_value, int):
            format_str = '{}'
        elif isinstance(prop_value, float):
            format_str = '{: >#7.4g}'
        else:
            format_str = '{}'
        strings.append(prop_str + ': ' + format_str.format(prop_value))
    print(', '.join(strings))


class ProgressBar:
    """In-place terminal progress bar with an ETA estimate.

    Same external behavior as reference utils.py:360-421 (constructor
    signature, step() with overrun assert, completion message + newline);
    rendering is a single stateless function of (done, total, elapsed).
    """

    WIDTH = 20

    def __init__(self, n, update_msg='', complete_msg='Complete'):
        self.total = int(n)
        self.done = 0
        self.update_msg = update_msg
        self.complete_msg = complete_msg
        self._t0 = time.monotonic()
        self._render(update_msg)

    def step(self, custom_update_msg=''):
        assert self.done < self.total, \
            'The progress bar has exceeded the total number of iterations'
        self.done += 1
        self._render(custom_update_msg or self.update_msg)
        if self.done == self.total:
            self._render(self.complete_msg)
            sys.stdout.write('\n')

    def _eta(self):
        if self.done == 0:
            return '--:--:--'
        elapsed = time.monotonic() - self._t0
        left = elapsed * (self.total - self.done) / self.done
        minutes, seconds = divmod(int(left), 60)
        hours, minutes = divmod(minutes, 60)
        return f'{hours:02d}:{minutes:02d}:{seconds:02d}'

    def _render(self, label):
        frac = self.done / self.total
        fill = int(frac * self.WIDTH)
        bar = '*' * fill + ' ' * (self.WIDTH - fill)
        sys.stdout.write('\033[K'   # clear the line, redraw in place
                         f'{label}|{bar}| {100 * frac:3.0f}%, '
                         f'Time remaining:{self._eta()}\r')
        sys.stdout.flush()


class MemoryLogger:
    """Daemon-threaded host RAM/SWAP logger with live PNG (utils.py:425-543)."""

    def __init__(self, filename='', verbose=True, log_period=1, print_period=5,
                 save_logs=True, logs_dir=None):
        try:
            import psutil  # noqa: F401  (import check up-front)
        except ImportError as exc:
            raise ImportError('MemoryLogger needs the psutil package, which '
                              'is not installed') from exc
        assert print_period > log_period, \
            'Printing must occur on longer period than logging'
        self.verbose = verbose
        self.save_logs = save_logs
        self.log_period = log_period
        self.print_period = print_period
        self.mem_units_bytes = 1024 ** 3
        self.mem_used = []
        self.swap_used = []
        self.mem_used_time = []
        self.time_start = None

        if logs_dir is None:
            from neuron_gan_tpu_torch.configs import config
            logs_dir = config.logs_dir
        os.makedirs(logs_dir, exist_ok=True)
        if self.save_logs:
            if not filename:
                import datetime
                date_str = datetime.datetime.now().strftime('%Y_%m_%d_%H_%M_%S')
                filename = f'mem_log_{date_str}.png'
            self.filepath = os.path.join(logs_dir, filename)
            print(f'Saving memory logs to:\n{self.filepath}')
        else:
            self.filepath = ''

        self.log_mem()
        self._stop = threading.Event()
        self.log_thread = threading.Thread(target=self._run_log, daemon=True)
        self.print_thread = threading.Thread(target=self._run_print, daemon=True)
        self.log_thread.start()
        self.print_thread.start()

    def stop(self):
        self._stop.set()

    def _run_log(self):
        while not self._stop.is_set():
            start = time.time()
            self.log_mem()
            self._stop.wait(max(0.0, self.log_period - (time.time() - start)))

    def _run_print(self):
        while not self._stop.is_set():
            start = time.time()
            self.print_log()
            self._stop.wait(max(0.0, self.print_period - (time.time() - start)))

    def log_mem(self):
        import psutil
        now = time.time()
        if self.time_start is None:
            self.time_start = now
        mem = psutil.virtual_memory().used / self.mem_units_bytes
        swap = psutil.swap_memory().used / self.mem_units_bytes
        if self.save_logs:
            self.mem_used_time.append(now - self.time_start)
            self.mem_used.append(mem)
            self.swap_used.append(swap)
        else:
            self.mem_used_time = [now - self.time_start]
            self.mem_used = [mem]
            self.swap_used = [swap]

    def print_log(self):
        if self.verbose and self.mem_used:
            print('Memory stats: Time(s):{:.1f}, MEM(GiB): {:.3}, SWAP(GiB): {:.3}'
                  .format(self.mem_used_time[-1], self.mem_used[-1],
                          self.swap_used[-1]))
        if self.save_logs and self.mem_used:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots()
            ax.plot(self.mem_used_time, self.mem_used, lw=2, label='RAM')
            ax.plot(self.mem_used_time, self.swap_used, lw=2, label='SWAP')
            ax.legend(loc='upper left')
            ax.set_xlabel('Time (s)')
            ax.set_ylabel('Memory usage (GiB)')
            fig.savefig(self.filepath)
            plt.close(fig)
