"""Architectures, each a module found by its file name: what the benchmark
needs of one model, so that the shared harness (harness.py, calibrate.py,
tests/conftest.py) knows nothing of any model.

A configuration names its architecture (``"architecture": "<name>"`` in
configs/<config>.json); ``architectures/<name>.py`` provides, each function
taking the whole configuration ``cfg`` as loaded:

  inputs     train_inputs(cfg, traffic, seed, device) -> (G weights,
             D weights, stack); make_weights(cfg, gen) -> (G, D weights);
             latent(gen, n, cfg) -> (n, latent) latents;
  draws      reference_steps(cfg, traffic, seed, device, n) -> the first
             ``n`` batch steps' (rows, draws) from the seed the program's
             generator gets; augment_look(cfg, traffic): a context in
             which the program's first augmented batch is held against the
             reference's (calibrate.py's detail);
  reference  generator(p, z, phase, cfg, alpha=None, precision='float32')
             and Trainer(g_w, d_w, cfg, traffic, precision), plain torch,
             importing nothing of the program or of JAX;
  program    port_nets(cfg, g_w, d_w, device) -> (the port's model config,
             G, D or None); port_train(cfg, traffic, g, d) -> (chunk spec,
             train state, the beta1 of Adam's first moment): everything
             between the weights and ``make_epoch_runner``;
  counts     train_step_flops(cfg, traffic); g_forward_flops(cfg, phase,
             batch); kernel_sites(cfg, traffic) -> {(kernel, shape, case):
             launches} of one step; optional KERNELS {name: (trace
             substrings, least_s(shape, case, itemsize, peaks))}, kernels
             of its own beside K1-K4 (trace.py's categories and
             kernels.least_s_per_step take them);
  tests      TINY {section: {key: value}}: the cut the CPU tests apply to
             this architecture's configurations.
"""

import importlib.util
from pathlib import Path

DIR = Path(__file__).resolve().parent
INTERFACE = ('train_inputs', 'make_weights', 'latent', 'reference_steps',
             'augment_look', 'generator', 'Trainer', 'port_nets',
             'port_train', 'train_step_flops', 'g_forward_flops',
             'kernel_sites')


def get(name, root=DIR):
    """The module ``root/<name>.py``; a KeyError names the file looked for
    when there is none or it lacks part of the interface."""
    path = Path(root) / f'{name}.py'
    if not path.is_file():
        raise KeyError(f'no architecture named {name!r} ({path})')
    spec = importlib.util.spec_from_file_location(
        'benchmark_architecture_' + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in INTERFACE + ('TINY',) if not hasattr(mod, k)]
    if missing:
        raise KeyError(f'architecture {name!r} ({path}) lacks {missing}')
    if not hasattr(mod, 'KERNELS'):
        mod.KERNELS = {}
    return mod
