"""GPipe pipeline sharding over processes (``train.pipeline_sharding``,
``parallel/pipeline.py``) against the JAX package's ``make_pipeline_apply``
and its stage seams, and against the port's one-process runs, on the CPU.

Four ranks run over gloo (``_torch_dist.py``), one launch for the module:
the 2-stage cases on a (2 data x 2 model) grid, the 4-stage M2Det case on
(1 x 4).  The JAX side (JAX ``test_pipeline.py``'s small M2Det: 4 TUMs, 3
scales, 64 px) runs here meanwhile.

Tolerances, JAX ``test_pipeline.py``'s:
- the pipelined forward against JAX's ``make_pipeline_apply`` on a (2, 2)
  and a (1, 4) mesh: atol 1e-5;
- the pipelined gradient of ``sum(s ** 2) + sum(|l|)``, summed over the
  ranks, against JAX's gradient of the plain forward (which JAX's own test
  holds its pipelined gradient to): atol 1e-4 of the largest gradient;
- stage seams: ``tum_stage_chunks`` equal; the port's staged application
  at 2 and 4 stages bit-equal to its plain forward (JAX's staged
  application is held through ``make_pipeline_apply`` above);
- the 4-rank frozen-BN step against the port's one-process frozen-BN step:
  loss rtol 1e-5, each update within 1e-4 of the largest, the ranks'
  states bit-equal;
- ``Experiment(process_count=4)`` (2 data x 2 stages, batch 4 a model
  group) against one process at batch 8: JAX ``test_engine.py``'s (train
  and eval loss rtol 2e-4, mAP equal), the parameters' digest rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import (SMALL_M2DET, assert_matches_step, axis_step, start)
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.models.detector import \
    tum_stage_chunks as jax_chunks
from single_shot_detection_tpu.parallel import create_mesh, make_pipeline_apply
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.models.detector import tum_stage_chunks
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           to_jax_variables)
from test_torch_port_multiprocess import config
from _torch_port_fixtures import one_torch_thread  # noqa: F401

N = 4
AXIS_CFG = {"'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}":
            "'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}, "
            "'frozen_bn': True, 'pipeline_sharding': 2"}
FROZEN_CFG = {"'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}":
              "'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}, "
              "'frozen_bn': True"}


def m2det_inputs():
    """The small M2Det's seeded weights (BN statistics off their 0/1 init,
    so the frozen BNs normalize) and a global batch of 8 whose first four
    images hold 1 GT box each and the others 3."""
    model = pt_builder.build(**SMALL_M2DET).module
    generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith('running_mean'):
                t.copy_(0.1 * torch.randn(t.shape, generator=generator))
            elif name.endswith('running_var'):
                t.copy_(0.5 + torch.rand(t.shape, generator=generator))
    rng = np.random.RandomState(23)
    gt = np.array([[10, 10, 40, 40, 1, 1], [5, 30, 30, 60, 2, 1],
                   [35, 5, 60, 35, 1, 1]], np.float32)
    mask = np.zeros((8, 3), bool)
    mask[:4, 0] = True
    mask[4:] = True
    return {'state_dict': model.state_dict(),
            'image': rng.rand(8, 64, 64, 3).astype(np.float32),
            'boxes': np.tile(gt, (8, 1, 1)), 'box_mask': mask}


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('pipeline')
    inputs = {'m2det': m2det_inputs(),
              'axis_cfg': config(tmp, 'axis', **AXIS_CFG)}
    finish = start(['pipeline_grads', 'pipeline_step', 'pipeline_planted',
                    'experiment_axis'], tmp, inputs, n=N)
    return finish, inputs, tmp


@pytest.fixture(scope='module')
def jax_side(launched):
    """JAX's pipelined forwards at 2 and 4 stages and its plain
    gradient."""
    _, inputs, _ = launched
    spec = SMALL_M2DET
    bundle = jax_builder.build(
        base=spec['base'], anchor_generator=spec['anchor_generator'],
        num_classes=spec['num_classes'], features=spec['features'],
        input_size=spec['input_size'])
    variables = to_jax_variables(inputs['m2det']['state_dict'])
    images = jnp.asarray(inputs['m2det']['image'])
    out = {}
    for n_data, stages in ((2, 2), (1, 4)):
        mesh = create_mesh(n_data=n_data, n_model=stages,
                           devices=jax.devices()[:n_data * stages])
        papply = jax.jit(make_pipeline_apply(bundle.module, mesh,
                                             microbatches=2))
        s, l = papply(variables, images)
        out[stages] = (np.asarray(s), np.asarray(l))
    params, stats = variables['params'], variables['batch_stats']

    def loss(p):
        s, l = bundle.module.apply({'params': p, 'batch_stats': stats},
                                   images, train=False)
        return jnp.sum(s ** 2) + jnp.sum(jnp.abs(l))

    grads = jax.jit(jax.grad(loss))(params)
    out['grads'] = from_jax_variables({'params': jax.device_get(grads),
                                       'batch_stats': stats})
    return out


@pytest.fixture(scope='module')
def ranks(launched, jax_side):
    finish, inputs, tmp = launched
    return finish(), inputs, tmp


def test_tum_stage_chunks_match_jax():
    for tums, stages in ((8, 4), (8, 3), (2, 3), (1, 3), (4, 4), (4, 2),
                         (8, 2)):
        assert tum_stage_chunks(tums, stages) == jax_chunks(tums, stages)
    for tums, stages in ((0, 2), (4, 1)):
        with pytest.raises(ValueError):
            jax_chunks(tums, stages)
        with pytest.raises(ValueError):
            tum_stage_chunks(tums, stages)


@pytest.mark.parametrize('stages', [2, 4])
def test_staged_application_matches_plain(launched, stages):
    """Stage by stage equals the plain forward, bit for bit; a neck with
    no TUM chain refuses more than 2 stages with JAX's message."""
    _, inputs, _ = launched
    model = pt_builder.build(**SMALL_M2DET).module.eval()
    model.load_state_dict(inputs['m2det']['state_dict'])
    x = torch.from_numpy(inputs['m2det']['image'][:2].transpose(0, 3, 1, 2)
                         .copy())
    with torch.no_grad():
        whole = model(x)
        state = model(x, stage=0, n_stages=stages)
        for k in range(1, stages):
            state = model(None, stage=k, stage_state=state, n_stages=stages)
    assert torch.equal(state[0], whole[0]) and torch.equal(state[1], whole[1])
    if stages > 2:
        plain = pt_builder.build(**{**SMALL_M2DET, 'features': {
            'name': 'Features', 'out_layers': (18,)},
            'anchor_generator': {'type': 'ssd', 'num_scales': 1,
                                 'min_scale': 0.3, 'max_scale': 0.9,
                                 'aspect_ratios': [[1.0]]}}).module
        with pytest.raises(ValueError, match='supports 2 stages'):
            plain(x, stage=0, n_stages=stages)


@pytest.mark.parametrize('stages', [2, 4])
def test_pipelined_forward_and_gradient_match_jax(ranks, jax_side, stages):
    results, _, _ = ranks
    per = [r['pipeline_grads'][stages] for r in results]
    data = N // stages
    scores = np.concatenate([per[d * stages]['forward'][0].numpy()
                             for d in range(data)])
    locs = np.concatenate([per[d * stages]['forward'][1].numpy()
                           for d in range(data)])
    np.testing.assert_allclose(scores, jax_side[stages][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(locs, jax_side[stages][1], rtol=0, atol=1e-5)
    # every rank of a model group holds the outputs
    for r in range(N):
        assert torch.equal(per[r]['forward'][0],
                           per[r // stages * stages]['forward'][0])
    want = jax_side['grads']
    scale = max(float(g.abs().max()) for g in want.values())
    for r in range(N):
        for name, g in per[r]['grads'].items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=name)
    # the boundary buffers the hand-offs sent
    assert per[0]['bytes']['sent_bytes'] > 0


def test_pipelined_step_matches_one_process(ranks):
    results, inputs, _ = ranks
    first = results[0]['pipeline_step']
    for r in range(1, N):
        assert results[r]['pipeline_step']['metrics'] == first['metrics']
        for name, value in first['state_dict'].items():
            assert torch.equal(results[r]['pipeline_step']['state_dict'][name],
                               value), name
    want = axis_step(0, 1, inputs['m2det'], 'pipeline', 1, SMALL_M2DET)
    assert_matches_step(first, want, inputs['m2det']['state_dict'])


def test_world_normaliser_is_caught(ranks):
    """The planted fault: the positive count summed over the world, each
    model group's count twice.  It trains, and the comparison with one
    process fails on it."""
    results, inputs, _ = ranks
    planted = results[0]['pipeline_planted']
    assert np.isfinite(planted['metrics']['loss'])
    want = axis_step(0, 1, inputs['m2det'], 'pipeline', 1, SMALL_M2DET)
    with pytest.raises(AssertionError):
        assert_matches_step(planted, want, inputs['m2det']['state_dict'])


def test_experiment_matches_one_process(ranks):
    results, _, tmp = ranks
    got = [r['experiment_axis'] for r in results]
    assert all(g == got[0] for g in got)
    exp = Experiment(config(tmp, 'single', batch=8, **FROZEN_CFG),
                     device='cpu', debug=True)
    rows_ = exp.train()
    digest = float(sum(p.detach().abs().sum().item()
                       for p in exp.model.parameters()))
    last, want = got[0]['rows'][-1], rows_[-1]
    assert last['train_loss'] == pytest.approx(want['train_loss'], rel=2e-4)
    assert last['eval_loss'] == pytest.approx(want['eval_loss'], rel=2e-4)
    assert last['eval_mAP'] == want['eval_mAP']
    assert got[0]['digest'] == pytest.approx(digest, rel=1e-5)
