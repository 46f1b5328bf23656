"""Spatial (height) sharding over processes (``train.spatial_sharding``,
``parallel/spatial.py``) against the JAX package's height-sharded forward
and against the port's one-process runs, on the CPU.

The rows rule of every op with vertical extent is held in pure torch
against slicing the whole map's output; two ranks run the model over gloo
(``_torch_dist.py``), one launch for the module, while the JAX forward
runs here.

Tolerances:
- the rows rule: each rank's rows from its window equal the whole map's
  rows bit for bit (convs, pools, the nearest resize) or within 1e-5
  (the bilinear resize, whose separable two-tap blend rounds apart from
  the whole map's 2-D resize);
- the 2-rank eval forward of the small detector against JAX's forward with
  the image heights sharded over a ``(1, 2)`` mesh: JAX
  ``test_sharding.py``'s rtol 2e-4, atol 2e-4;
- the 2-rank step against the port's one-process step (which
  ``test_torch_port_train.py`` holds against JAX's): loss rtol 1e-5, each
  update within 1e-4 of the largest, BN statistics atol 1e-5; the ranks'
  states bit-equal;
- ``Experiment(process_count=2)`` against one process: JAX
  ``test_engine.py``'s (train and eval loss rtol 2e-4, mAP equal), the
  parameters' digest rel 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dist import (SMALL, assert_matches_step, axis_step, start)
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.parallel import create_mesh, replicated
from single_shot_detection_tpu_torch.parallel.spatial import (resize_plan,
                                                              resize_rows,
                                                              sliding_plan,
                                                              split)
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.utils.weights import to_jax_variables
from test_torch_port_multiprocess import config
from test_torch_port_tensor_sharding import small_inputs

N = 2
AXIS_CFG = {"'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}":
            "'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}, "
            "'spatial_sharding': 2"}
HEIGHTS = (1, 2, 3, 5, 10, 19, 38, 75, 150)
WEIGHT = torch.randn(3, 2, 3, 1, generator=torch.Generator().manual_seed(0))

# (name, kernel, stride, dilation, rows above, rows below, fill, op)
SLIDING = [
    ('conv3', 3, 1, 1, 1, 1, 0.0, lambda t: F.conv2d(t, WEIGHT)),
    ('conv3_stride2_tf', 3, 2, 1, 0, 1, 0.0,
     lambda t: F.conv2d(t, WEIGHT, stride=(2, 1))),
    ('conv3_stride2_sym', 3, 2, 1, 1, 1, 0.0,
     lambda t: F.conv2d(t, WEIGHT, stride=(2, 1))),
    ('conv3_dilated6', 3, 1, 6, 6, 6, 0.0,
     lambda t: F.conv2d(t, WEIGHT, dilation=(6, 1))),
    ('conv1_stride2', 1, 2, 1, 0, 0, 0.0,
     lambda t: F.conv2d(t, WEIGHT[:, :, :1], stride=(2, 1))),
    ('pool3_stride2_pad1', 3, 2, 1, 1, 1, -np.inf,
     lambda t: F.max_pool2d(t, 3, 2)),
    ('pool2_stride2_valid', 2, 2, 1, 0, 0, -np.inf,
     lambda t: F.max_pool2d(t, 2, 2)),
    ('pool2_dfpn_pad', 2, 2, 1, 0, 1, -np.inf,
     lambda t: F.max_pool2d(t, 2, 2)),
]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('m', [2, 4])
@pytest.mark.parametrize('case', SLIDING, ids=[c[0] for c in SLIDING])
def test_sliding_rows_rule(case, m):
    """Every height of the flagship's chain (empty shards at 1, 2 and 3
    rows over 4 ranks; VGG's 75 -> 37): each rank's output rows from its
    window and edge rows equal the whole map's."""
    _, kernel, stride, dilation, above, below, fill, op = case
    for height in HEIGHTS:
        if height + above + below < dilation * (kernel - 1) + 1:
            continue
        x = torch.randn(2, 2, height, 5, generator=torch.Generator()
                        .manual_seed(height))
        whole = op(F.pad(x, (0, 0, above, below), value=fill))
        out_height, needs, edges = sliding_plan(height, kernel, stride,
                                                dilation, above, below, m)
        assert out_height == whole.shape[2]
        covered = 0
        for j in range(m):
            lo, hi = split(out_height, m, j)
            covered += hi - lo
            if hi <= lo:
                assert needs[j] == (0, 0)
                continue
            a, b = needs[j]
            window = F.pad(x[:, :, a:b], (0, 0) + edges[j], value=fill)
            assert torch.equal(op(window), whole[:, :, lo:hi]), (height, j)
            # edge rows only at the global edges
            assert edges[j][0] == 0 or a == 0
            assert edges[j][1] == 0 or b == height
        assert covered == out_height


@pytest.mark.parametrize('m', [2, 4])
@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_resize_rows_rule(mode, m):
    """Upsampling to a global size (exact multiples, 32 -> 63, 1 -> 2
    over ranks with empty input shares)."""
    for height, out_height in ((1, 2), (3, 5), (5, 10), (10, 19), (19, 38),
                               (32, 63)):
        x = torch.randn(2, 2, height, 4, generator=torch.Generator()
                        .manual_seed(out_height))
        if mode == 'nearest':
            whole = F.interpolate(x, size=(out_height, 7),
                                  mode='nearest-exact')
        else:
            whole = F.interpolate(x, size=(out_height, 7), mode='bilinear',
                                  align_corners=False)
        first, second, weight, needs = resize_plan(height, out_height, mode, m)
        for j in range(m):
            lo, hi = split(out_height, m, j)
            if hi <= lo:
                continue
            a, b = needs[j]
            got = resize_rows(x[:, :, a:b], a, first[lo:hi], second[lo:hi],
                              weight[lo:hi], (out_height, 7), mode)
            if mode == 'nearest':
                assert torch.equal(got, whole[:, :, lo:hi])
            else:
                np.testing.assert_allclose(got.numpy(),
                                           whole[:, :, lo:hi].numpy(),
                                           rtol=0, atol=1e-5)


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('spatial')
    inputs = {**small_inputs(), 'axis_cfg': config(tmp, 'axis', **AXIS_CFG)}
    finish = start(['spatial_step', 'spatial_planted', 'experiment_axis',
                    'spatial_group_norm'], tmp, inputs)
    return finish, inputs, tmp


@pytest.fixture(scope='module')
def jax_forward(launched):
    """JAX's eval forward of the small detector from the port's weights,
    the images' heights sharded over a (1, 2) mesh."""
    _, inputs, _ = launched
    bundle = jax_builder.build(
        base=SMALL['base'], anchor_generator=SMALL['anchor_generator'],
        num_classes=SMALL['num_classes'], features=SMALL['features'],
        input_size=SMALL['input_size'])
    variables = to_jax_variables(inputs['state_dict'])
    mesh = create_mesh(n_data=1, n_model=N, devices=jax.devices()[:N])
    heights = NamedSharding(mesh, P('data', 'model', None, None))
    fn = jax.jit(lambda v, x: bundle.module.apply(v, x, train=False),
                 in_shardings=(replicated(mesh), heights))
    scores, locs = fn(variables, jax.device_put(inputs['image'], heights))
    return np.asarray(scores), np.asarray(locs)


@pytest.fixture(scope='module')
def ranks(launched, jax_forward):
    finish, inputs, tmp = launched
    return finish(), inputs, tmp


def test_two_rank_forward_matches_jax(ranks, jax_forward):
    results, _, _ = ranks
    for r in range(N):
        scores, locs = results[r]['spatial_step']['forward']
        np.testing.assert_allclose(scores.numpy(), jax_forward[0],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(locs.numpy(), jax_forward[1],
                                   rtol=2e-4, atol=2e-4)


def test_two_rank_step_matches_one_process(ranks):
    results, inputs, _ = ranks
    first = results[0]['spatial_step']
    assert results[1]['spatial_step']['metrics'] == first['metrics']
    for name, value in first['state_dict'].items():
        assert torch.equal(results[1]['spatial_step']['state_dict'][name],
                           value), name
    assert_matches_step(first, axis_step(0, 1, inputs, None, 1),
                        inputs['state_dict'])


def test_no_rank_holds_a_whole_activation(ranks):
    """Each op's input on a rank is its own rows (``global_height`` checks
    it); its window adds at most the kernel's reach less one row (two for
    the small detector's 3x3 convs and pools), and only maps of at most 2
    rows (the 3x3 kernels span them) are ever held whole."""
    results, _, _ = ranks
    for r in range(N):
        windows = results[r]['spatial_step']['windows']
        assert 0 < windows['max_extra_rows'] <= 2
        assert windows['largest_whole'] <= 2


def test_world_normaliser_is_caught(ranks):
    """The planted fault: the positive count summed over the world, each
    image's twice.  It trains, and the comparison with one process fails
    on it."""
    results, inputs, _ = ranks
    planted = results[0]['spatial_planted']
    assert np.isfinite(planted['metrics']['loss'])
    with pytest.raises(AssertionError):
        assert_matches_step(planted, axis_step(0, 1, inputs, None, 1),
                            inputs['state_dict'])


def test_experiment_matches_one_process(ranks):
    results, _, tmp = ranks
    got = [r['experiment_axis'] for r in results]
    assert got[0] == got[1]
    exp = Experiment(config(tmp, 'single'), device='cpu', debug=True)
    rows_ = exp.train()
    digest = float(sum(p.detach().abs().sum().item()
                       for p in exp.model.parameters()))
    last, want = got[0]['rows'][-1], rows_[-1]
    assert last['train_loss'] == pytest.approx(want['train_loss'], rel=2e-4)
    assert last['eval_loss'] == pytest.approx(want['eval_loss'], rel=2e-4)
    assert last['eval_mAP'] == want['eval_mAP']
    assert got[0]['digest'] == pytest.approx(digest, rel=1e-5)


def test_group_norm_step_matches_one_process(ranks):
    """``train.group_norm`` under spatial sharding: a group spans channels
    (and rows: its moments summed over the model group); the step
    against the one-process GroupNorm step at the step's tolerances."""
    results, inputs, _ = ranks
    first = results[0]['spatial_group_norm']
    assert results[1]['spatial_group_norm']['metrics'] == first['metrics']
    assert_matches_step(first, axis_step(0, 1, inputs, None, 1, group_norm=8),
                        inputs['state_dict'])
