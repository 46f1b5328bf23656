"""The model axis's last phases on the CPU: the sharded ``Pruner``, the int8
evaluation, the export and the CLI's ``test`` and ``export`` phases of a
tensor-, spatial- or pipeline-sharded run, in two gloo processes
(``_torch_dist.py``), against the JAX package and the port's one-process
run on the same numpy inputs.

Every rank scenario runs in one launch, while this process computes the
JAX side (one JAX detector) and the one-process port run from the same
seeded weights and inputs.  The config is ``samples/synthetic_smoke.py``
cut to one train step and one eval batch, int8 forced.

Tolerances: the sharded ``Pruner``'s dead sets equal JAX
``train/pruning.py::Pruner``'s on the same whole parameters, the pruned
parameters and the gathered mask bit for bit (``MinL1Norm``,
``TaylorExpansion`` on given gradients, ``MeanActivation`` on a batch's
means); the observed means within 1e-5 of JAX ``activation_means`` on the
same batch, absolute, of each vector's largest where it passes 1
(``test_torch_port_pruning.py``'s: two f32 conv libraries round a first
conv's means 1.1e-6 of their largest apart, a BN output's 5e-7 of means
near 1e-2); a local channel index taken as global on a slice (planted)
breaks the equality.  The int8 amax equal to the one-process port's and
within 1e-5 relative of JAX ``export/quantize.py::calibrate`` on the same
images (``test_torch_port_int8.py``'s: a conv input whose largest value
is 1.1e-5 sits 1.0e-6 relative off); the sharded int8 evaluation equal to
one process's; process 0's artifact equal to the one-process artifact of
the gathered checkpoint, bit for bit on the same batch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from _torch_dist import SMOKE, free_port, given_grads, start
from _torch_port_fixtures import jax_train_state
from _torch_port_fixtures import one_torch_thread  # noqa: F401
from single_shot_detection_tpu.export import quantize as jq
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.train import deps as jax_deps
from single_shot_detection_tpu.train import pruning as jax_pruning
from single_shot_detection_tpu_torch.export import export_model, load_exported
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import (_pruning_mask,
                                                           from_jax_variables,
                                                           to_jax_variables)

N = 2
PRUNE_NUM = 4
INCLUDE = ['features', 'extra']
CRITERIA = ('MinL1Norm', 'TaylorExpansion', 'MeanActivation')
MEANS_ATOL = 1e-5
AMAX_RTOL = 1e-5
# the CLI's runs: train overrides and flags
CLI_RUNS = {
    'tensor': ("'tensor_sharding': 2, 'pruner': {'num': 4}", []),
    'spatial': ("'spatial_sharding': 2, 'pruner': {'num': 4}", []),
    'pipeline': ("'pipeline_sharding': 2, 'frozen_bn': True", ['--int8']),
}
FRAMES = 3
GRADS_SEED = 5


def smoke_config(tmp, name: str, train: str = '', export: str = '') -> str:
    """``samples/synthetic_smoke.py`` cut to one step and one eval batch,
    int8 forced, with ``train`` entries and an ``export`` block added."""
    with open(SMOKE) as f:
        text = f.read()
    text += ("\ndataset['eval'] = {**dataset['eval'], 'num_images': 8}\n"
             # int8 past the serving gate, which refuses MobileNet at b8
             "int8 = {}\n"
             "train = {**train, 'epochs': 1, 'eval_every': 1, "
             f"'num_batches_per_epoch': 1, {train}}}\n")
    if export:
        text += f'export = {export}\n'
    path = os.path.join(str(tmp), name, 'config.py')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        f.write(text)
    return path


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The launch's results, and the JAX and one-process sides, computed
    while it runs from the same seeded weights and inputs."""
    tmp = tmp_path_factory.mktemp('axis_phases')
    cfg = smoke_config(tmp, 'base')
    video = tmp / 'video'
    video.mkdir()
    rng = np.random.RandomState(0)
    for i in range(FRAMES):
        Image.fromarray(rng.randint(0, 256, (96, 128, 3), np.uint8)).save(
            video / f'{i}.png')
    cli_runs = []
    for key, (train, flags) in CLI_RUNS.items():
        configs = [smoke_config(tmp, f'cli_{key}_rank{r}', train, (
            "{'path': "
            f"{str(tmp / f'cli_{key}_rank{r}' / 'exported' / 'model')!r}}}"))
            for r in range(N)]
        cli_runs.append((key, free_port(), configs, flags))
    observed = (torch.from_numpy(rng.randint(0, 256, (2, 128, 128, 3),
                                             np.uint8)),
                torch.zeros((2, 8, 6)), torch.zeros((2, 8), dtype=torch.bool))
    images = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.float32)
    finish = start(['axis_pruner', 'axis_cli'], tmp, {
        'smoke': cfg, 'prune_num': PRUNE_NUM, 'include_paths': INCLUDE,
        'grads_seed': GRADS_SEED, 'observed': observed, 'images': images,
        'video': str(video), 'cli': cli_runs}, n=N)

    # the one-process run at the seeded weights the ranks start from
    one = Experiment(cfg, device='cpu', int8=True)
    state = one.model.state_dict()
    grads = given_grads({k: p.shape for k, p in one.model.named_parameters()},
                        GRADS_SEED)
    metrics = one.evaluate()
    calibration = [x.permute(0, 2, 3, 1).numpy()
                   for x in one._calibration_images(2)]
    path = export_model(one, str(tmp / 'one_process'), with_postprocess=True,
                        with_preprocess=True, bake_variables=True,
                        batch_size=2)
    outputs = load_exported(path)(images)
    x = one.eval_pipeline.apply([], *observed)[0]
    model_cfg = dict(load_config(SMOKE).model)
    module = jax_builder.build(
        base=model_cfg['base'], anchor_generator=model_cfg['anchor_generator'],
        input_size=(128, 128), **model_cfg['detector']).module
    variables = jax_variables(state)
    jax_side = {'amax': jq.calibrate(module, variables,
                                     [jnp.asarray(c) for c in calibration]),
                'spaces': jax_deps.analyze_module(module, variables,
                                                  (1, 128, 128, 3))}
    _, tree = jax.jit(lambda v, xx: module.apply(
        v, xx, train=False, capture_intermediates=True,
        mutable=['intermediates']))(
        variables, jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    jax_side['means'] = {k: np.asarray(v) for k, v in jax_pruning.
                         activation_means(tree['intermediates']).items()}
    jax_side['pruned'] = {name: jax_prune(variables, jax_side, name, grads)
                          for name in CRITERIA}
    return {'ranks': finish(), 'state': state, 'jax': jax_side, 'one': {
        'metrics': metrics, 'amax': one._int8_amax, 'outputs': outputs}}


def jax_variables(state: dict) -> dict:
    return jax.tree_util.tree_map(jnp.asarray, to_jax_variables(state))


def jax_prune(variables: dict, jax_side: dict, name: str, grads: dict):
    """JAX's ``Pruner`` over ``variables``' parameters after the
    observation ``name`` takes (``grads``, or JAX's activation means);
    returns its dead sets, parameters and mask as the port names them."""
    params = variables['params']
    pruner = jax_pruning.Pruner(params, {'name': name},
                                include_paths=INCLUDE, num=PRUNE_NUM,
                                spaces=jax_side['spaces'])
    if name == 'TaylorExpansion':
        pruner.observe_grads(params, jax_variables(grads)['params'])
    if name == 'MeanActivation':
        pruner.observe(jax_side['means'])
    state = pruner.prune(jax_train_state(
        {'params': params}, jax_pruning.masked(optax.sgd(1e-2))))
    mask = _pruning_mask({'inner': state.opt_state['inner'],
                          'mask': jax.tree_util.tree_map(
                              np.asarray, state.opt_state['mask'])})
    return ({k: sorted(v) for k, v in pruner.dead.items()},
            from_jax_variables({'params': jax.tree_util.tree_map(
                np.asarray, state.params)}), mask)


def params_equal(got: dict, want: dict) -> bool:
    return all(torch.equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize('mode', ['tensor', 'spatial'])
@pytest.mark.parametrize('name', CRITERIA)
def test_sharded_pruner_matches_jax(runs, mode, name):
    """Each rank's picks, dead set, pruned parameters and gathered mask
    equal JAX's ``Pruner`` on the whole parameters of the same state."""
    dead, params, mask = runs['jax']['pruned'][name]
    assert sum(map(len, dead.values())) >= PRUNE_NUM
    for rank in runs['ranks']:
        got = rank['axis_pruner'][mode]
        assert params_equal(got['whole'], runs['state'])
        got = got[name]
        assert got['dead'] == dead
        assert params_equal(got['state'], params)
        assert got['mask'].keys() == mask.keys()
        for k, m in mask.items():
            assert torch.equal(got['mask'][k], m), k
        if name == 'MeanActivation':
            want = runs['jax']['means']
            assert set(want) <= set(got['means'])
            for k, v in want.items():
                np.testing.assert_allclose(
                    got['means'][k], v, rtol=0,
                    atol=MEANS_ATOL * max(1.0, np.abs(v).max()),
                    err_msg=str(k))


def test_planted_local_index_is_caught(runs):
    """A global channel used as an index into a rank's slice zeroes a
    channel of the wrong block: the comparison with JAX catches it."""
    _, params, _ = runs['jax']['pruned']['MinL1Norm']
    planted = [r['axis_pruner']['tensor']['MinL1Norm_planted']['state']
               for r in runs['ranks']]
    assert not all(params_equal(p, params) for p in planted)


def test_sharded_int8_matches_jax_and_one_process(runs):
    """The tensor-sharded int8 evaluation calibrates as JAX's
    ``calibrate`` and as one process, and evaluates as one process."""
    one, jax_amax = runs['one'], runs['jax']['amax']
    assert one['metrics']['int8'] == 1.0
    for rank in runs['ranks']:
        got = rank['axis_pruner']['tensor']
        assert got['metrics'] == one['metrics']
        assert got['amax'] == one['amax']
    assert set(jax_amax) == set(one['amax']) and len(jax_amax) >= 10
    for key, value in jax_amax.items():
        assert abs(one['amax'][key] - value) <= AMAX_RTOL * value, key


def test_sharded_artifact_equals_the_one_process_one(runs):
    """Process 0 writes the standalone artifact, and it computes what the
    one-process artifact of the gathered checkpoint computes, bit for
    bit (the int8 artifact is held so on the card, ``chip_smoke.py``
    phase 25)."""
    got = [r['axis_pruner']['tensor'] for r in runs['ranks']]
    assert got[0]['written'] and not got[1]['written']
    assert params_equal(got[0]['saved'], runs['state'])
    a, b = got[0]['outputs'], runs['one']['outputs']
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert b[1].any()


@pytest.mark.parametrize('key', list(CLI_RUNS))
def test_cli_runs_every_phase(runs, key):
    """``--phases train eval test export`` of a 2-rank ``--cpu`` run
    completes under each option (with ``--int8`` or ``train.pruner``
    where given): the ranks report one evaluation and one dead set, and
    only process 0 writes its run, frames and artifact."""
    results = [r['axis_cli'][key] for r in runs['ranks']]
    rows = [r['rows'] for r in results]
    assert rows[0] == rows[1] and len(rows[0]) == 1
    row = rows[0][0]
    assert np.isfinite(row['train_loss']) and 0 <= row['eval_mAP'] <= 1
    assert row.get('eval_int8') == (1.0 if CLI_RUNS[key][1] else None)
    assert results[0]['dead'] == results[1]['dead']
    assert bool(results[0]['dead']) == ('pruner' in CLI_RUNS[key][0])
    files = results[0]['files']
    assert 'exported/model.pt2' in files
    assert sum(f.startswith('tmp/ssd_torch_frames/') for f in files) == FRAMES
    assert any(f.endswith('.pt') and f.startswith('runs/') for f in files)
    assert results[1]['files'] == ['config.py']
