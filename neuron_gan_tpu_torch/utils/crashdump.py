"""Crash forensics: pickle the caller's locals before raising.

Port of reference utils.py:296-342 (a copy of
neuron_gan_tpu/utils/crashdump.py) — invoked by the training CLI's NaN
guard, which checks each chunk's stats on the host (the reference calls it
inline from every loss).
"""

import datetime
import inspect
import os
import pickle
import random
import string


def get_caller_name():
    stack = inspect.stack()
    caller_name = stack[2][3]
    caller_filepath = stack[2][1]
    if caller_name == '<module>':
        return os.path.splitext(os.path.basename(caller_filepath))[0]
    return caller_name


def save_vars(caller_vars, verbose=True, out_dir=None):
    name_of_caller = get_caller_name()
    date_str = datetime.datetime.now().strftime('%Y%m%d_%H%M')
    rand_id = ''.join(random.choices(string.ascii_uppercase, k=4))
    filename = f'saved_vars_{name_of_caller}_{date_str}_{rand_id}.pkl'

    saved_vars_dir = os.path.abspath(out_dir or './saved_vars')
    os.makedirs(saved_vars_dir, exist_ok=True)
    filepath = os.path.join(saved_vars_dir, filename)

    saved_vars = {}
    for var_name, var_val in caller_vars.items():
        try:
            pickle.dumps(var_val)
            saved_vars[var_name] = var_val
        except Exception:
            saved_vars[var_name] = 'ERROR: variable cannot be saved'

    with open(filepath, 'wb') as f:
        pickle.dump(saved_vars, f)

    if verbose:
        print(f'Variables saved in:\n{filepath}')
    return filepath
