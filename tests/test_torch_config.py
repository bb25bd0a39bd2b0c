"""The port's config module against the JAX package's, on the CPU: the
defaults, the precedence of a user config and CLI overrides, every
validation error (same exception, same message), and the port's mapping
of the JAX package's TPU knobs.  Exact comparisons throughout."""

import os
import sys

import pytest


def _fresh(prefix):
    # the config module is global and mutable by design: a fresh copy
    for mod in list(sys.modules):
        if mod.startswith(prefix):
            del sys.modules[mod]


@pytest.fixture
def configs(tmp_path, monkeypatch):
    """(JAX config, port config), fresh, their directories in tmp_path."""
    _fresh('neuron_gan_tpu.configs')
    _fresh('neuron_gan_tpu_torch.configs')
    from neuron_gan_tpu.configs import config as jc
    from neuron_gan_tpu_torch.configs import config as tc
    for c in (jc, tc):
        for d in ('images_dir', 'weights_dir', 'plots_dir', 'logs_dir'):
            monkeypatch.setattr(c, d, str(tmp_path / d))
        monkeypatch.setattr(c, 'samples_sub_dir', str(tmp_path / 'samples'))
    yield jc, tc
    _fresh('neuron_gan_tpu.configs')
    _fresh('neuron_gan_tpu_torch.configs')


# the JAX package's TPU knobs the port replaces, and the port's own
JAX_ONLY = {'use_pallas', 'pallas_epilogue'}
PORT_ONLY = {'use_kernels', 'architecture', 'beta2', 'mirror_augment'}
# differ by design: the package's own paths, a random ID, the device
# ('default' = the card here), and the speed knobs' docs aside
PATHS = {'root_dir', 'configs_dir', 'data_dir', 'images_dir', 'weights_dir',
         'plots_dir', 'logs_dir', 'dataset_dir', 'samples_sub_dir', 'ID'}


def test_knobs_and_defaults_match_jax(configs):
    jc, tc = configs
    assert set(jc.configs_name) - JAX_ONLY == set(tc.configs_name) - PORT_ONLY
    for name in set(tc.configs_name) - PORT_ONLY - PATHS:
        assert tc.configs_name[name] == jc.configs_name[name], name
    assert tc.use_kernels is True
    assert tc.configs_dir.endswith(os.path.join('neuron_gan_tpu_torch', 'configs'))


def _dirs(tmp_path):
    return ''.join(f'{d} = {str(tmp_path / d)!r}\n' for d in (
        'images_dir', 'weights_dir', 'plots_dir', 'logs_dir'))


def test_user_config_and_cli_precedence(configs, tmp_path):
    user = tmp_path / 'user_config.py'
    user.write_text('ID = "zzzz"\nlatent_dim = 64\nbatch_size = 4\n'
                    'transit_sch = [30, 60, 90, 120, 150]\nalpha_step = 0.1\n'
                    'N_epochs = 200\n' + _dirs(tmp_path))
    for c in configs:
        c.import_configs(str(user), overwritten_configs={'batch_size': 2},
                         interactive=False)
    jc, tc = configs
    for name in ('latent_dim', 'batch_size', 'ID', 'transit_sch', 'N_epochs',
                 'swd_period', 'N_gen_features'):
        assert getattr(tc, name) == getattr(jc, name), name
    assert (tc.latent_dim, tc.batch_size, tc.ID) == (64, 2, 'zzzz')
    assert tc.samples_sub_dir.endswith('zzzz')
    # a second import starts from the defaults, not from the first one's
    second = tmp_path / 'second.py'
    second.write_text('ID = "yyyy"\nN_epochs = 200000\n' + _dirs(tmp_path))
    tc.import_configs(str(second), interactive=False)
    assert (tc.latent_dim, tc.batch_size) == (512, 8)
    assert tc.configs_name['transit_sch'] == [25000, 50000, 75000, 100000, 125000]


def _set(**knobs):
    def apply(c, tmp_path):
        for k, v in knobs.items():
            setattr(c, k, v)
        c.validate_configs(interactive=False)
    return apply


def _import(text, overrides=None):
    def apply(c, tmp_path):
        path = tmp_path / 'bad_config.py'
        path.write_text(text + _dirs(tmp_path))
        c.import_configs(str(path), overwritten_configs=overrides,
                         interactive=False)
    return apply


# every validation error of the JAX package's config module
VALIDATION = {
    'image_size': _set(ID='t', image_size=100),
    'id': _set(ID=''),
    'compute_dtype': _set(ID='t', compute_dtype='float16'),
    'hbm_budget': _set(ID='t', hbm_budget_mb=-1),
    'shear_warp': _set(ID='t', shear_warp='yes'),
    'packed_lanes': _set(ID='t', packed_lanes=32),
    'swd_period': _set(ID='t', swd_period=-1),
    'layer_counts': _set(ID='t', N_gen_features=[16, 16, 16],
                         N_dis_features=[16, 16]),
    'initial_size': _set(ID='t', image_size=16, N_gen_features=[8] * 4,
                         N_dis_features=[8] * 4),
    'n_transitions': _set(ID='t', transit_sch=[100, 200]),
    'n_epochs': _set(ID='t', N_epochs=125000),
    'separation': _set(ID='t', transit_sch=[100, 150, 200, 250, 300]),
    'unknown_knob': _import('not_a_real_knob = 42\n'),
    'unknown_override': _import('ID = "t"\n', {'not_a_flag': 1}),
    'not_py': lambda c, tmp_path: c.import_configs('cfg.txt'),
    'missing_file': lambda c, tmp_path: c.import_configs(
        str(tmp_path / 'absent.py')),
}


@pytest.mark.parametrize('case', sorted(VALIDATION))
def test_validation_errors_match_jax(configs, tmp_path, case):
    raised = []
    for c in configs:
        with pytest.raises((AssertionError, ValueError)) as info:
            VALIDATION[case](c, tmp_path)
        raised.append((info.type, str(info.value)))
    (jtype, jmsg), (ttype, tmsg) = raised
    assert ttype is jtype
    # the messages name the file's own directory where they name one
    jc, tc = configs
    assert tmsg == jmsg.replace(jc.configs_dir, tc.configs_dir)


def test_knob_mapping(configs):
    _, tc = configs
    assert tc.precision_of('default') is None
    assert tc.precision_of('highest') == 'highest'
    with pytest.raises(ValueError, match="matmul_precision='high'.*'default'.*'highest'"):
        tc.precision_of('high')
    refused = {'matmul_precision': ('high', 'matmul_precision'),
               'mesh_shape': ({'model': 2}, "needs a 'data' axis")}
    for knob, (value, named) in refused.items():
        setattr(tc, 'ID', 't')
        setattr(tc, knob, value)
        with pytest.raises(ValueError, match=named):
            tc.validate_configs(interactive=False)
        setattr(tc, knob, tc.configs_name[knob])
    tc.validate_configs(interactive=False)
    assert tc.device == 'cuda'     # 'default' is the card, never the CPU
    # both mesh axes and the legacy WGAN family are taken
    for knob, value in (('mesh_shape', {'data': 8}),
                        ('mesh_shape', {'data': 4, 'model': 2}), ('wgan', True)):
        setattr(tc, knob, value)
        tc.validate_configs(interactive=False)
        setattr(tc, knob, tc.configs_name[knob])


@pytest.mark.parametrize('name', ['config_ex', 'config_fast'])
def test_example_configs_import_and_validate(configs, name):
    jc, tc = configs
    for c in configs:
        c.import_configs(f'{name}.py', overwritten_configs={'ID': 'cf1'},
                         interactive=False)
    for knob in ('batch_size', 'image_size', 'latent_dim', 'N_gen_features',
                 'N_dis_features', 'transit_sch', 'compute_dtype',
                 'gp_reuse_fakes', 'shear_warp', 'packed_lanes'):
        assert getattr(tc, knob) == getattr(jc, knob), knob
    assert tc.use_kernels and tc.precision_of(tc.matmul_precision) is None
