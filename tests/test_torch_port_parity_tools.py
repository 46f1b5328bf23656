"""The accuracy protocol's tools in the port
(``single_shot_detection_tpu_torch/tools/{parity_run,parity_stats,
ema_ablation,gn_ablation,qat_ablation,hflip_injection}.py``) against the
JAX package's ``tools/`` modules and engine, on the CPU.

The JAX tools' functions called here use numpy and PIL only: no JAX model
is built.  ``hflip_injection``'s draws are held against the JAX
``Pipeline`` itself: the committed flips of seed 23, injected into the
port's ``Trainer.step_draws``, flip exactly the images and boxes JAX's
pipeline flips under the engine's keys of the same steps (pixels within
1e-4, the resample's rounding; boxes and masks equal).  Tolerances: the staged JPEGs and Csv files byte for byte, the
configs' text, each ablation's arm configs, ``results.json`` and printed
table, and ``parity_stats``'s output all exactly equal (the ablations'
training runs stubbed with the same fixed mAPs in both packages).  One
real run of the port's CLI on the CPU trains 8 images for 1 epoch and is
held to the mAP of its own ``log.csv``; the int8 evaluation of its
checkpoint is held to the float mAP, because the int8 gate refuses a
MobileNet at batch 8 (``int8=0.0000``).
"""

import ast
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from single_shot_detection_tpu.data.datasets import Csv as JaxCsv
from single_shot_detection_tpu.data.transforms import Pipeline as JaxPipeline
from single_shot_detection_tpu_torch.data.datasets import Csv
from single_shot_detection_tpu_torch.data.transforms import Pipeline
from single_shot_detection_tpu_torch.tools import (ema_ablation, gn_ablation,
                                                   hflip_injection, parity_run,
                                                   parity_stats, qat_ablation)
from single_shot_detection_tpu_torch.trainer import Trainer
from _torch_port_fixtures import one_torch_thread  # noqa: F401
from _torch_protocol import FLIPS, STEPS, jax_flips

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the root tools/, the JAX package's

from tools import ema_ablation as jax_ema_ablation  # noqa: E402
from tools import gn_ablation as jax_gn_ablation  # noqa: E402
from tools import parity_run as jax_parity_run  # noqa: E402
from tools import parity_stats as jax_parity_stats  # noqa: E402
from tools import qat_ablation as jax_qat_ablation  # noqa: E402

TOOLS = ('parity_run', 'parity_stats', 'ema_ablation', 'gn_ablation',
         'qat_ablation', 'hflip_injection')
ABLATIONS = {'ema': (jax_ema_ablation, ema_ablation, ['--decay', '0.99']),
             'gn': (jax_gn_ablation, gn_ablation, ['--groups', '4']),
             'qat': (jax_qat_ablation, qat_ablation, [])}
LABELS = ['background'] + [f'class_{i}' for i in range(1, 5)]


@pytest.fixture
def small_protocol(monkeypatch):
    """8 train and 4 eval images in both packages' ``parity_run``; the
    tools' ``main`` sets the module's sizes, the fixture puts them back."""
    for module in (jax_parity_run, parity_run):
        monkeypatch.setattr(module, 'TRAIN_N', 8)
        monkeypatch.setattr(module, 'EVAL_N', 4)


def tree(root: str) -> dict:
    """``{path relative to root: bytes}`` of every file under ``root``."""
    out = {}
    for directory, _, files in os.walk(root):
        for name in files:
            path = os.path.join(directory, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize('tool', TOOLS)
def test_tool_imports_only_the_port(tool):
    """No import of JAX, flax, the JAX package or the root tools/."""
    path = os.path.join(REPO, 'single_shot_detection_tpu_torch', 'tools',
                        f'{tool}.py')
    with open(path) as f:
        tree_ = ast.parse(f.read())
    names = []
    for node in ast.walk(tree_):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or '')
    roots = {name.split('.')[0] for name in names}
    assert not roots & {'jax', 'flax', 'optax', 'single_shot_detection_tpu',
                        'tools'}, sorted(roots)


def test_stage_dataset_equals_jax(tmp_path, small_protocol):
    """Every JPEG and all four Csv files byte for byte, and both packages'
    ``Csv`` datasets read the same annotations from them."""
    jax_csvs = jax_parity_run.stage_dataset(str(tmp_path / 'jax'))
    port_csvs = parity_run.stage_dataset(str(tmp_path / 'port'))
    want, got = tree(str(tmp_path / 'jax')), tree(str(tmp_path / 'port'))
    assert sorted(got) == sorted(want)
    assert sum(name.endswith('.jpg') for name in got) == 12
    assert sum(name.endswith('.csv') for name in got) == 4
    for name in want:
        assert got[name] == want[name], name
    assert sorted(port_csvs) == sorted(jax_csvs)
    for split in ('train', 'eval'):
        jax_ds = JaxCsv(jax_csvs[(split, 'ours')], labels=LABELS)
        port_ds = Csv(port_csvs[(split, 'ours')], labels=LABELS)
        assert len(port_ds.annotations) == len(jax_ds.annotations) == {
            'train': 8, 'eval': 4}[split]
        for a, b in zip(port_ds.annotations, jax_ds.annotations):
            assert os.path.basename(a['image_path']) == os.path.basename(
                b['image_path'])
            assert a['boxes'].dtype == b['boxes'].dtype
            assert (a['boxes'] == b['boxes']).all()


@pytest.mark.parametrize('aug', sorted(jax_parity_run.AUG_CHAINS))
@pytest.mark.parametrize('family', sorted(jax_parity_run.FAMILY_SECTIONS))
def test_write_configs_equals_jax(tmp_path, family, aug):
    csvs = {(split, flavor): f'/data/{split}_{flavor}.csv'
            for split in ('train', 'eval') for flavor in ('ours', 'ref')}
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    kwargs = dict(seed=24, milestones='40,52', family=family, lr=1e-3,
                  aug=aug)
    want = jax_parity_run.write_configs(str(tmp_path / 'jax'), csvs, 60,
                                        **kwargs)
    got = parity_run.write_configs(str(tmp_path / 'port'), csvs, 60, **kwargs)
    assert sorted(got) == sorted(want) == ['ours', 'ref']
    for flavor in ('ours', 'ref'):
        assert os.path.basename(got[flavor]) == os.path.basename(want[flavor])
        with open(got[flavor]) as f, open(want[flavor]) as g:
            text = f.read()
            assert text == g.read()
        assert f"'path': r'/data/train_{flavor}.csv'" in text


def fixed_map(workdir: str, int8: bool = False) -> float:
    """A stand-in mAP, fixed by the arm's directory name (``base_23``)."""
    arm, seed = os.path.basename(workdir).split('_')
    return round(0.5 + 0.01 * (int(seed) - 23) + 0.03 * (arm != 'base')
                 - 0.002 * int8, 4)


@pytest.mark.parametrize('kind', sorted(ABLATIONS))
def test_ablation_equals_jax(tmp_path, monkeypatch, capsys, small_protocol,
                             kind):
    """Both packages' ``main`` with the training runs stubbed by the same
    fixed mAPs: the arms' configs, ``results.json`` and everything printed
    (the table included) equal."""
    jax_tool, port_tool, extra = ABLATIONS[kind]

    def run_ours(workdir, cfg_path, cpu=False, matmul_precision=None):
        return {'mAP': fixed_map(workdir), 'minutes': 0.25, 'log': ''}

    def run_int8_eval(workdir, cfg_path, cpu=False):
        return fixed_map(workdir, int8=True)

    for module in (jax_parity_run, parity_run):
        monkeypatch.setattr(module, 'run_ours', run_ours)
    for module in (jax_qat_ablation, qat_ablation):
        monkeypatch.setattr(module, 'run_int8_eval', run_int8_eval)
    outputs = {}
    for label, run in (('jax', lambda argv: (
            monkeypatch.setattr(sys, 'argv', ['ablation'] + argv),
            jax_tool.main())),
            ('port', port_tool.main)):
        workdir = str(tmp_path / label)
        run(['--workdir', workdir, '--seeds', '23', '24', '--train-n', '8',
             '--eval-n', '4', '--epochs', '3', *extra])
        outputs[label] = capsys.readouterr().out.replace(workdir, 'WORKDIR')
    assert outputs['port'] == outputs['jax']
    assert '| mean |' in outputs['port']
    jax_dir, port_dir = tmp_path / 'jax', tmp_path / 'port'
    with open(port_dir / 'results.json') as f, \
            open(jax_dir / 'results.json') as g:
        results = json.load(f)
        assert results == json.load(g)
    arms = sorted(k for k in results)
    assert len(arms) == 4
    for arm in arms:
        want = (jax_dir / arm / 'config_ours.py').read_text().replace(
            str(jax_dir), 'WORKDIR')
        got = (port_dir / arm / 'config_ours.py').read_text().replace(
            str(port_dir), 'WORKDIR')
        assert got == want, arm
    if kind == 'qat':
        assert "train['qat'] = True" in (port_dir / 'qat_23' /
                                         'config_ours.py').read_text()


def stats_workdirs(root):
    """Two complete runs, one with only the port's arm (as
    ``parity_run --skip-reference`` leaves it) and one with no file."""
    entries = {'w1': {'reference': {'self_reported_mAP': 0.733,
                                    'mAP_by_our_metric': 0.7332},
                      'ours': {'mAP': 0.748, 'minutes': 4.0}},
               'w2': {'reference': {'self_reported_mAP': 0.691,
                                    'mAP_by_our_metric': 0.6912},
                      'ours': {'mAP': 0.7011, 'minutes': 4.1}},
               'w3': {'ours': {'mAP': 0.72, 'minutes': 3.9}},
               'w4': None}
    dirs = []
    for name, entry in entries.items():
        path = root / name
        path.mkdir()
        if entry is not None:
            (path / 'results.json').write_text(json.dumps(entry))
        dirs.append(str(path))
    return dirs


@pytest.mark.parametrize('as_json', [True, False], ids=['json', 'text'])
def test_parity_stats_equals_jax(tmp_path, monkeypatch, capsys, as_json):
    dirs = stats_workdirs(tmp_path)
    argv = dirs + ['--extra', '0.748:0.7405', '--extra', '0.72:0.7312']
    argv += ['--json'] if as_json else []
    monkeypatch.setattr(sys, 'argv', ['parity_stats'] + argv)
    jax_parity_stats.main()
    want = capsys.readouterr()
    parity_stats.main(argv)
    got = capsys.readouterr()
    assert got.out == want.out
    assert got.err == want.err
    assert got.err.count('-- skipping') == 2
    if as_json:
        summary = json.loads(got.out)['summary']
        assert summary['n'] == 4


def test_parity_stats_without_complete_run(tmp_path, monkeypatch):
    dirs = stats_workdirs(tmp_path)[2:]
    monkeypatch.setattr(sys, 'argv', ['parity_stats'] + dirs)
    with pytest.raises(SystemExit) as want:
        jax_parity_stats.main()
    with pytest.raises(SystemExit) as got:
        parity_stats.main(dirs)
    assert got.value.code == want.value.code == 'no complete runs found'


def test_parity_run_trains_on_the_cpu(tmp_path, monkeypatch, small_protocol):
    """One real run of the port's CLI through ``parity_run`` (8 images, 1
    epoch), then ``run_int8_eval`` on its checkpoint."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')  # the CLI's processes
    workdir = str(tmp_path / 'p')
    parity_run.main(['--skip-reference', '--ours-cpu', '--train-n', '8',
                     '--eval-n', '4', '--epochs', '1', '--workdir', workdir])
    with open(os.path.join(workdir, 'results.json')) as f:
        results = json.load(f)
    assert sorted(results) == ['ours']
    assert sorted(results['ours']) == ['mAP', 'minutes']
    mAP = results['ours']['mAP']
    assert 0.0 <= mAP <= 1.0
    save = os.path.join(workdir, 'ours_out')
    assert mAP == parity_run.last_eval_map(save)
    (run_dir,) = os.listdir(save)
    assert 'ckpt-1.pt' in os.listdir(os.path.join(save, run_dir))

    int8_map = qat_ablation.run_int8_eval(
        workdir, os.path.join(workdir, 'config_ours.py'), cpu=True)
    with open(os.path.join(workdir, 'int8_eval.log')) as f:
        (line,) = [x for x in f if x.startswith('[eval]')]
    # the gate refuses a MobileNet at batch 8: the evaluation ran in float
    assert line.rstrip().endswith('int8=0.0000')
    assert int8_map == round(mAP, 4)


def test_parity_run_without_skip_reference(tmp_path):
    workdir = tmp_path / 'p'
    with pytest.raises(SystemExit, match='reference arm is not ported'):
        parity_run.main(['--workdir', str(workdir), '--epochs', '1'])
    assert not workdir.exists()


def test_hflip_injection_flips_as_the_jax_engine():
    """The committed flips are the JAX engine's, and injected into the
    port's step draws they flip what JAX's ``Pipeline`` flips."""
    flips = hflip_injection.read_flips(FLIPS, 23)
    assert flips.shape == (STEPS, 8)
    np.testing.assert_array_equal(flips, jax_flips(23, STEPS))
    augs = [{'name': 'RandomHorizontalFlip'}]
    preprocessing = [{'name': 'ToFloatTensor', 'args': {'normalize': True}}]
    size = 24
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (8, size, size, 3)).astype(np.uint8)
    xy = rng.uniform(0, size / 2, (8, 2, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, size / 2, (8, 2, 2)),
                            np.ones((8, 2, 2))], -1).astype(np.float32)
    mask = np.ones((8, 2), bool)
    jax_pipeline = JaxPipeline(augs, preprocessing, (size, size), train=True)
    # the attributes Trainer.step_draws reads, of a one-process trainer
    trainer = types.SimpleNamespace(
        seed=23, pipeline=Pipeline(augs, preprocessing, (size, size)),
        mixup=None, data_count=1, data_index=0)
    original = Trainer.step_draws
    restore = hflip_injection.inject(flips)
    try:
        for step in (0, 1, STEPS - 1):
            assert flips[step].any() and not flips[step].all(), step
            key = jax.random.split(
                jax.random.fold_in(jax.random.PRNGKey(23), step))[0]
            want = [np.asarray(a) for a in jax_pipeline(key, images, boxes,
                                                        mask)]
            draws, mixup = Trainer.step_draws(trainer, step, 8)
            assert mixup is None
            got = trainer.pipeline.apply(draws, *map(torch.from_numpy,
                                                     (images, boxes, mask)))
            np.testing.assert_allclose(got[0].numpy().transpose(0, 2, 3, 1),
                                       want[0], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(got[1].numpy(), want[1][..., :6])
            np.testing.assert_array_equal(got[2].numpy(), want[2])
    finally:
        restore()
    assert Trainer.step_draws is original


def test_hflip_injection_runs_on_the_cpu(tmp_path, small_protocol):
    """The injected arm of one seed, 8 images for 1 epoch, in this process
    (``--one``, what ``run_all`` starts a process for; the own arm is
    ``parity_run``'s, run above); ``Trainer.step_draws`` is put back."""
    original = Trainer.step_draws
    work = tmp_path / 'jax_24'
    result = hflip_injection.main([
        '--one', '--draws', FLIPS, '--seed', '24', '--train-n', '8',
        '--eval-n', '4', '--epochs', '1', '--cpu', '--workdir', str(work)])
    assert Trainer.step_draws is original
    assert 0.0 <= result['mAP'] <= 1.0
    assert result['mAP'] == parity_run.last_eval_map(str(work / 'ours_out'))
    with open(work / 'results.json') as f:
        assert json.load(f)['ours_jax_hflips']['mAP'] == result['mAP']
    assert hflip_injection.summary([0.5, 0.7, 0.55]) == {
        'n': 3, 'mean': pytest.approx(0.5833333), 'median': 0.55,
        'sd': pytest.approx(0.1040833), 'under_0.6': 2}
    assert hflip_injection.seed_list('23-25,30') == [23, 24, 25, 30]
