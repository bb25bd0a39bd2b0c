"""The port's tools, utilities and native loader against the JAX package,
on the CPU: the A/B harness (synthetic set, aggregation, one tiny run),
the checkpoint converter, the plotting additions, the samples video, the
native preprocessing library and the profilers' refusal and categoriser.

Every comparison is exact (bit for bit, or pixel for pixel) unless it says
otherwise; the A/B run and the profilers are held to finite values only.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name):
    """A module of the JAX package's tools/ directory (no package there)."""
    spec = importlib.util.spec_from_file_location(
        f'jax_tools_{name}', REPO / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tree_equal(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# (a) the A/B harness's synthetic set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('seed', [1, 4])
def test_synthetic_neurons_are_the_jax_ones(seed):
    from neuron_gan_tpu_torch.tools.precision_ab import make_synthetic_neurons
    want = jax_tool('precision_ab').make_synthetic_neurons(n=3, res=48, seed=seed)
    got = make_synthetic_neurons(n=3, res=48, seed=seed)
    assert len(got) == 3 and all(tree_equal(g, w) for g, w in zip(got, want))


def test_dataset_dir_decodes_to_the_jax_one(tmp_path, monkeypatch):
    from neuron_gan_tpu_torch.data.neuron_dataset import decode_image
    from neuron_gan_tpu_torch.tools import precision_ab as pab
    jax_tool('precision_ab').build_dataset_dir(str(tmp_path / 'j'), 32, seed=2, n=3)
    pab.build_dataset_dir(str(tmp_path / 't'), 32, seed=2, n=3)
    names = sorted(f for f in os.listdir(tmp_path / 'j') if f.endswith('.png'))
    assert names == sorted(f for f in os.listdir(tmp_path / 't') if f.endswith('.png'))
    for f in names:
        assert tree_equal(decode_image(str(tmp_path / 't' / f)),
                          decode_image(str(tmp_path / 'j' / f)))
    # kept for the same key, rebuilt for another
    stamp = os.stat(tmp_path / 't' / names[0]).st_mtime_ns
    pab.build_dataset_dir(str(tmp_path / 't'), 32, seed=2, n=3)
    assert os.stat(tmp_path / 't' / names[0]).st_mtime_ns == stamp
    pab.build_dataset_dir(str(tmp_path / 't'), 32, seed=3, n=3)
    assert not tree_equal(decode_image(str(tmp_path / 't' / names[0])),
                          decode_image(str(tmp_path / 'j' / names[0])))


# ---------------------------------------------------------------------------
# (b) ab_aggregate on every committed A/B log
# ---------------------------------------------------------------------------

AB_LOGS = sorted((REPO / 'logs').glob('*_ab_*.jsonl'))


def arm_tags(path):
    tags = []
    for line in path.read_text().splitlines():
        if line.startswith('{'):
            arm = json.loads(line).get('arm')
            if arm is not None and arm not in tags:
                tags.append(arm)
    return tags


@pytest.mark.parametrize('log', AB_LOGS, ids=[p.name for p in AB_LOGS])
def test_ab_aggregate_decides_as_jax(log, capsys):
    from neuron_gan_tpu_torch.tools import ab_aggregate
    jagg = jax_tool('ab_aggregate')
    base, cand = arm_tags(log)[:2]
    pairs = ab_aggregate.load_pairs([str(log)], base, cand)
    assert pairs and pairs == jagg.load_pairs([str(log)], base, cand)
    assert ab_aggregate.decide(pairs) == jagg.decide(pairs)
    ab_aggregate.main([str(log), '--base', base, '--cand', cand])
    assert json.loads(capsys.readouterr().out) == jagg.decide(pairs)


def test_multiseed_runs_each_seed_and_aggregates(tmp_path, monkeypatch, capsys):
    from neuron_gan_tpu_torch.tools import run_multiseed_ab as rm
    calls = []

    def fake_seed(stem, seed, log, tool_args):
        calls.append((stem, seed, tool_args))
        if seed == 3:
            return 1            # a failed seed: reported, the study goes on
        with open(log, 'a') as fh:
            fh.write(f'[fresh] epochs 1-2\n'
                     f'{json.dumps({"arm": "fresh", "swd_mean": 0.3 + seed / 100})}\n'
                     f'{json.dumps({"arm": "reuse", "swd_mean": 0.31})}\n')
        return 0

    monkeypatch.setattr(rm, 'run_seed', fake_seed)
    log = tmp_path / 'ab.jsonl'
    rm.main(['gp_reuse_ab', 'fresh', str(log), '1', '2', '3', '--', '--device', 'cpu'])
    assert calls == [('gp_reuse_ab', s, ['--device', 'cpu']) for s in (1, 2, 3)]
    verdict = json.loads(capsys.readouterr().out)
    assert verdict['n_seeds'] == 2 and verdict['pairs'] == [[0.31, 0.31], [0.32, 0.31]]


# ---------------------------------------------------------------------------
# (i) run_quality_ab end to end at a tiny geometry
# ---------------------------------------------------------------------------

def test_quality_ab_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    from neuron_gan_tpu_torch.tools import precision_ab as pab
    from neuron_gan_tpu_torch.tools import stacked_ab
    monkeypatch.setattr(pab, 'GEOMETRY', dict(
        n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16), latent_dim=8,
        image_size_init=4, packed_min_res=8))
    results = stacked_ab.main([
        '--epochs', '6', '--transits', '2', '4', '--alpha_step', '0.5',
        '--res', '16', '--n_fake', '16', '--out', str(tmp_path),
        '--device', 'cpu'])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert [ln.get('arm') for ln in lines[:2]] == ['reference', 'shipping']
    assert all(np.isfinite(r['swd_mean']) and r['swd_mean'] > 0
               and r['device'] == 'cpu' for r in results.values())
    verdict = lines[2]
    assert verdict['seed_verdict_hint'] in ('stack_ok', 'stack_worse')
    assert verdict['reference'] == results['reference']['swd_mean']
    assert (tmp_path / 'samples_shipping_s1.png').exists()


def test_ab_arm_launches_are_the_smoke_expectation(tmp_path, monkeypatch, capsys):
    # every kernel call of both stacked_ab arms at a tiny geometry, as
    # chip_smoke.py's tools phase expects the card's launches: the
    # reference arm in float32 (K3/K4 at its 2x2 blocks), the shipping
    # arm in bfloat16 with G run twice a critic step (GP-fake reuse)
    from neuron_gan_tpu_torch.tools import precision_ab as pab
    from neuron_gan_tpu_torch.tools import stacked_ab
    from test_torch_stretch import count_cases
    from test_torch_train_step import load_chip_smoke
    smoke = load_chip_smoke()
    monkeypatch.setattr(pab, 'GEOMETRY', dict(
        n_gen_features=(16, 16, 8), n_dis_features=(8, 16, 16), latent_dim=8,
        image_size_init=4, packed_min_res=8))
    cases = count_cases(monkeypatch)
    argv = ['--epochs', '6', '--transits', '2', '4', '--alpha_step', '0.5',
            '--res', '16', '--n_fake', '4', '--out', str(tmp_path), '--device', 'cpu']
    args = pab.make_quality_ab_parser('stacked_ab').parse_args(argv)
    arms = {}
    real_run_arm = pab.run_arm

    def counted(precision_name, dataset, args_, out_dir, device, tag=None, **kw):
        cases.clear()
        out = real_run_arm(precision_name, dataset, args_, out_dir, device, tag=tag, **kw)
        got = {'k1': {}, 'k2': {}, 'k3': {}, 'k4': {}}
        for (k, dt, _, case), n in cases.items():
            key = smoke.launch_key(dt, case if k in ('k1', 'k2') else None)
            got[k][key] = got[k].get(key, 0) + n
        arms[tag] = (got, smoke.ab_arm_launches(args, len(dataset), precision_name, kw)[0])
        return out

    monkeypatch.setattr(pab, 'run_arm', counted)
    stacked_ab.main(argv)
    for tag, (got, want) in arms.items():
        assert got == {k: want.get(k, {}) for k in got}, tag
    assert arms['reference'][0]['k3'] and 'float32' in arms['reference'][0]['k3']
    assert all(k.startswith('bfloat16') for c in arms['shipping'][0].values() for k in c)


def test_quality_ab_refuses_high_precision_and_needs_cuda_by_default():
    from neuron_gan_tpu_torch.tools import precision_ab as pab
    with pytest.raises(ValueError, match="'high'"):
        pab.arm_config('high')
    assert pab.arm_config('default').precision is None
    if not torch.cuda.is_available():
        args = pab.make_quality_ab_parser('x').parse_args([])
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            pab.run_quality_ab(args, [], 'ok', 'worse')


# ---------------------------------------------------------------------------
# (c) the checkpoint converter against the JAX package's readers
# ---------------------------------------------------------------------------

ARCH = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
            latent_dim=8, image_size_init=4)


def jax_params():
    from neuron_gan_tpu.models import (
        PGConfig as JPGConfig, init_discriminator_pg, init_generator_pg)
    jcfg = JPGConfig(**ARCH)
    kg, kd = jax.random.split(jax.random.PRNGKey(3))
    return jcfg, (jax.tree.map(np.asarray, init_generator_pg(kg, jcfg)),
                  jax.tree.map(np.asarray, init_discriminator_pg(kd, jcfg)))


@pytest.mark.parametrize('res,alpha', [(16, 1.0), (16, 0.5), (8, 1.0)])
def test_port_written_pth_imports_in_jax_exactly(tmp_path, res, alpha):
    from neuron_gan_tpu.checkpoint import (
        import_reference_checkpoint as j_import, save_reference_checkpoint as j_save)
    from neuron_gan_tpu.models import GrowthState as JGrowth
    from neuron_gan_tpu_torch.checkpoint import save_pytree_npz
    from neuron_gan_tpu_torch.tools import convert_checkpoint
    jcfg, (g, d) = jax_params()
    meta = dict(epoch=7, lr=2e-4, image_size=res, alpha=alpha, phase=0,
                image_size_init=4, N_gen_features=[16, 8, 8],
                N_dis_features=[8, 8, 16], latent_dim=8)
    src = str(tmp_path / 'GenDisc_x.npz')
    save_pytree_npz(src, {'state': {'g_params': g, 'd_params': d},
                          'series': {'Loss_D': np.arange(3.0)}}, meta)
    convert_checkpoint.main([src, str(tmp_path / 'port.pth')])
    # the JAX package's own writer on the same trees, at the same growth
    growth = JGrowth(jcfg)
    growth.set_resolution(res, alpha)
    j_save(str(tmp_path / 'jax.pth'), g, d, jcfg, growth, epoch=7, lr=2e-4,
           series={'Loss_D': np.arange(3.0)})
    got = j_import(str(tmp_path / 'port.pth'))
    want = j_import(str(tmp_path / 'jax.pth'))
    for a, b in zip(got[:2], want[:2]):
        assert tree_equal(a, b)
    assert got[2] == want[2] and (got[3].phase, got[3].alpha) == (
        want[3].phase, want[3].alpha)
    assert got[4]['epoch'] == 7 and tree_equal(got[4]['Loss_D'], np.arange(3.0))


def test_jax_written_pth_converts_to_an_npz_jax_reads(tmp_path):
    from neuron_gan_tpu.checkpoint import (
        import_reference_checkpoint as j_import, load_pytree_npz as j_load,
        save_reference_checkpoint as j_save)
    from neuron_gan_tpu.models import GrowthState as JGrowth
    from neuron_gan_tpu_torch.tools import convert_checkpoint
    jcfg, (g, d) = jax_params()
    growth = JGrowth(jcfg)
    growth.set_resolution(16, 1.0)
    pth = str(tmp_path / 'ref.pth')
    j_save(pth, g, d, jcfg, growth, epoch=3, lr=1e-4,
           series={'Loss_G': np.ones(3)})
    convert_checkpoint.main([pth, str(tmp_path / 'port.npz')])
    tree, meta = j_load(str(tmp_path / 'port.npz'))
    jg, jd, _, jgrowth, _ = j_import(pth)
    assert tree_equal(tree['state']['g_params'], jax.tree.map(np.asarray, jg))
    assert tree_equal(tree['state']['d_params'], jax.tree.map(np.asarray, jd))
    assert tree_equal(tree['series']['Loss_G'], np.ones(3))
    assert (meta['epoch'], meta['image_size'], meta['phase']) == (3, 16, jgrowth.phase)
    with pytest.raises(SystemExit, match='expected'):
        convert_checkpoint.main([pth, str(tmp_path / 'x.pth')])


# ---------------------------------------------------------------------------
# (d) plotting additions, (e) the samples video
# ---------------------------------------------------------------------------

def test_n_params_and_plot_dataset_match_jax(tiny_dataset_dir, tmp_path, monkeypatch):
    pytest.importorskip('matplotlib')
    from PIL import Image
    import neuron_gan_tpu.runtime as jax_runtime
    from neuron_gan_tpu.data.neuron_dataset import NeuronDataset as JDataset
    from neuron_gan_tpu.utils.plotting import n_params as j_n, plot_dataset as j_plot
    from neuron_gan_tpu_torch.convert import load_jax_tree
    from neuron_gan_tpu_torch.data.neuron_dataset import NeuronDataset
    from neuron_gan_tpu_torch.models import GeneratorPG, PGConfig
    from neuron_gan_tpu_torch.utils.plotting import n_params, plot_dataset
    _, (g, d) = jax_params()
    net = GeneratorPG(PGConfig(**ARCH), torch.Generator().manual_seed(0), device='cpu')
    load_jax_tree(net, g)
    assert n_params(net) == n_params(g) == j_n(g) and n_params(d) == j_n(d)
    monkeypatch.setattr(jax_runtime, 'native_available', lambda: False)
    want = j_plot(JDataset(tiny_dataset_dir, image_size=16, seed=1), [4, 8, 16],
                  directory=str(tmp_path / 'j'))
    got = plot_dataset(NeuronDataset(tiny_dataset_dir, image_size=16, seed=1),
                       [4, 8, 16], directory=str(tmp_path / 't'))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert tree_equal(np.array(Image.open(a)), np.array(Image.open(b)))


def test_plot_image_and_sample(tiny_dataset_dir, monkeypatch, capsys):
    from neuron_gan_tpu_torch.data.neuron_dataset import NeuronDataset
    from neuron_gan_tpu_torch.utils import plotting
    ds = NeuronDataset(tiny_dataset_dir, image_size=16)
    with pytest.raises(ValueError, match='smaller than 4'):
        plotting.plot_sample(ds, ind=4)
    if plotting.pyplot_or_skip('image') is not None:
        plotting.plot_sample(ds)
    # without matplotlib: said once, nothing drawn
    monkeypatch.setattr(plotting, 'pyplot_or_skip', lambda what: print(
        f'{what} plot skipped: matplotlib is not installed'))
    plotting.plot_sample(ds, ind=1)
    assert 'image plot skipped' in capsys.readouterr().out


def test_samples_video_picks_the_jax_frames(tmp_path, monkeypatch):
    cv2 = pytest.importorskip('cv2')
    from neuron_gan_tpu.utils.video import make_samples_video as j_video
    from neuron_gan_tpu_torch.utils.video import make_samples_video
    rng = np.random.default_rng(0)
    for epoch in rng.permutation(np.arange(10, 250, 10)):
        cv2.imwrite(str(tmp_path / f'Samples_ab_{epoch}.png'),
                    (rng.random((24, 24, 3)) * 255).astype(np.uint8))
    (tmp_path / 'notes.png').write_bytes(b'')       # no epoch: not a frame
    read = []
    real_imread = cv2.imread
    monkeypatch.setattr(cv2, 'imread', lambda p, *a: read.append(
        os.path.basename(p)) or real_imread(p, *a))
    outs = []
    for video in (j_video, make_samples_video):
        read.clear()
        outs.append(video('timelapse.mp4', str(tmp_path), video_length=1,
                          frame_rate=5))
        outs.append(list(read))
    assert outs[1] == outs[3] and len(outs[3]) == 6      # first frame + 5
    epochs = [int(f.split('_')[-1][:-4]) for f in outs[3][1:]]
    assert epochs == sorted(epochs) and epochs[0] == 10 and epochs[-1] == 240
    assert os.path.getsize(outs[2]) > 0
    with pytest.raises(ValueError, match='.mp4'):
        make_samples_video('timelapse.avi', str(tmp_path))


# ---------------------------------------------------------------------------
# (f) the native preprocessing library
# ---------------------------------------------------------------------------

def test_native_library_builds_under_build_and_matches_numpy(monkeypatch):
    from neuron_gan_tpu.data.neuron_dataset import _multiotsu_from_hist as j_dp
    from neuron_gan_tpu.runtime import native as jnative
    from neuron_gan_tpu_torch.runtime import build, native
    if build.compiler() is None and not build.library_path().exists():
        pytest.skip('no g++ on this host')
    assert native.native_available()
    assert build.library_path().parent == REPO / 'build' / 'native'
    rng = np.random.default_rng(5)
    for n_bins in (4, 17, 256):
        hist = rng.integers(0, 50, n_bins).astype(np.float64)
        centers = np.sort(rng.random(n_bins)) * 255
        assert tree_equal(native.multi_otsu_hist(hist, centers), j_dp(hist, centers, 4))
    # too few bins for 4 classes: the numpy DP, as in the JAX package
    assert tree_equal(native.multi_otsu_hist(np.ones(3), np.arange(3.0)),
                      j_dp(np.ones(3), np.arange(3.0), 4))
    assert build.library_path().exists()
    monkeypatch.setattr(jnative, '_load', lambda: None)     # its numpy path
    for shape, lo, hi, thresh in (((37, 53), 0, 256, 90.5),
                                  ((400, 300), 0, 256, 256.0),
                                  ((5,), 0, 1, 10.0)):
        img = rng.integers(lo, hi, shape).astype(np.uint8)
        assert native.noise_stats_u8(img, thresh) == jnative.noise_stats_u8(img, thresh)
    with pytest.raises(TypeError, match='uint8'):
        native.noise_stats_u8(np.zeros(4, np.uint16), 3.0)


def test_native_std_is_the_two_pass_std_at_a_large_mean():
    # values 249..252: the moment identity E[v^2] - E[v]^2 cancels about
    # 1e-12 of the std away; two passes give numpy's std bit for bit
    from neuron_gan_tpu_torch.runtime import build, native
    if build.compiler() is None and not build.library_path().exists():
        pytest.skip('no g++ on this host')
    img = np.random.default_rng(0).integers(249, 253, (700, 700)).astype(np.uint8)
    mean, std = native.noise_stats_u8(img, 256.0)
    v = img.astype(np.float64).ravel()
    moment = np.sqrt((v * v).mean() - v.mean() ** 2)
    assert mean == img.mean() and std == img.std()
    assert moment != img.std()


def test_dataset_takes_the_native_library_with_numpy_numbers(tiny_dataset_dir, monkeypatch):
    from neuron_gan_tpu_torch.data import neuron_dataset as nd
    from neuron_gan_tpu_torch.runtime import build, native
    if build.compiler() is None and not build.library_path().exists():
        pytest.skip('no g++ on this host')
    ds = nd.NeuronDataset(tiny_dataset_dir, image_size=16, seed=3)
    assert ds._stats_impl == 'native' and ds._cache_key(24)['stats'] == 'numpy'
    monkeypatch.setattr(native, 'native_available', lambda: False)
    ds_np = nd.NeuronDataset(tiny_dataset_dir, image_size=16, seed=3)
    assert ds_np._stats_impl == 'numpy'
    assert tree_equal(ds.images, ds_np.images)
    assert tree_equal(ds.images_noise_std, ds_np.images_noise_std)


# ---------------------------------------------------------------------------
# (j) the profilers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('tool', ['step_profile', 'op_trace'])
def test_profilers_need_cuda_or_device_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA')
    mod = importlib.import_module(f'neuron_gan_tpu_torch.tools.{tool}')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        mod.main(['--phase', '0'])


def test_op_trace_categories_sum_to_the_total():
    from neuron_gan_tpu_torch.tools.op_trace import CATEGORIES, category, summarize
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        y = torch.nn.functional.conv2d(x, w, padding=1)
        z = torch.nn.functional.leaky_relu(y, 0.2).permute(0, 2, 3, 1).contiguous()
        (z.sum() + torch.zeros(3).sum()).backward()
        z.to(torch.bfloat16)
    out = summarize(prof, n_steps=2, top=5, cuda=False)
    cats = out['by_category_ms_per_step']
    assert set(cats) <= set(CATEGORIES) and {'conv', 'layout'} <= set(cats)
    assert abs(sum(cats.values()) - out['total_ms_per_step']) <= 1e-9 * out['total_ms_per_step']
    # the contiguous copy: (2, 8, 8, 4) float32 read once and written once
    assert {'shapes': [[2, 8, 8, 4]] * 2, 'dtypes': ['float'] * 2,
            'bytes': 2 * 512 * 4} in [{k: r[k] for k in ('shapes', 'dtypes', 'bytes')}
                                      for r in out['copies']]
    assert {r['dtypes'][0] for r in out['copies']} >= {'float', 'c10::BFloat16'}
    assert category('void lrelu_pn_fwd_kernel<__nv_bfloat16, 8>(...)') == 'k1'
    assert category('nchwToNhwcKernel') == 'layout'
    assert category('sm90_xmma_fprop_implicit_gemm_bf16') == 'conv'
    assert category('sm90_xmma_gemm_f32f32_tf32f32') == 'gemm'


def test_step_profile_and_op_trace_run_on_the_cpu(capsys):
    from neuron_gan_tpu_torch.tools import op_trace, step_profile
    rows = step_profile.main(['--device', 'cpu', '--phase', '0', '--reps', '1'])
    assert rows[0]['device'] == 'cpu' and rows[0]['steps'] == 2
    # the shipping step's spans (fresh GP fakes: step.critic_fakes opens
    # twice a step, in one row), in the order the step opens them
    assert [r['span'] for r in rows[1:]] == [
        'step.draws', 'step.augment', 'step.critic_fakes', 'step.critic_loss',
        'step.grad_penalty', 'step.critic_backward', 'step.critic_adam',
        'step.gen_loss', 'step.gen_backward', 'step.gen_adam']
    assert all(np.isfinite(r['host_ms']) and r['host_ms'] > 0
               and r['idle_ms'] == r['launches'] == r['device_ms']
               == 'not measured' for r in rows[1:])
    assert sum(r['host_ms'] for r in rows[1:]) <= rows[0]['wall_ms_per_step']
    out = op_trace.main(['--device', 'cpu', '--phase', '0', '--epochs', '1'])
    assert out['time'] == 'CPU self time of ATen ops' and out['steps'] == 2
    assert abs(sum(out['by_category_ms_per_step'].values())
               - out['total_ms_per_step']) <= 1e-9 * out['total_ms_per_step']
    assert out['layout_kernels'] and out['copies']
