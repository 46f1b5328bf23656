"""Runs of the port's data-parallel path in several processes on the CPU,
for ``test_torch_port_distributed.py`` and ``test_torch_port_multiprocess.py``.

:func:`launch` starts one process per rank running this file, which joins
a gloo process group (``parallel.initialize_distributed``, a 60 s timeout
on every collective), runs the named scenarios in order and saves each
rank's results; the parent waits under a wall limit of its own, kills
every rank on expiry, and fails on any rank's non-zero exit with its log.
:func:`start_cli` starts the CLI the same way.  The ranks import torch and
the port only: the JAX side of a comparison stays in the test's process.
"""

import logging
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SMOKE = os.path.join(REPO, 'samples', 'synthetic_smoke.py')
CKPT = os.path.join(REPO, 'experiments', '2026-08-16-225820', 'ckpt-1800.msgpack')
COLLECTIVE_TIMEOUT_S = 60
WALL_S = 150

# the small detector of tests/test_sharding.py (64 px, 3 classes)
SMALL = {'base': {'name': 'mobilenet_v2', 'depth_multiplier': 0.35},
         'anchor_generator': {'type': 'ssd', 'num_scales': 1,
                              'min_scale': 0.3, 'max_scale': 0.9,
                              'aspect_ratios': [[1.0]]},
         'num_classes': 3, 'features': {'name': 'Features', 'out_layers': (18,)},
         'input_size': (64, 64)}
SMALL_LR = 1e-2
SGD = {'name': 'SGD', 'lr': 0.01, 'momentum': 0.9, 'weight_decay': 5e-4}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    env['OMP_NUM_THREADS'] = '1'
    env.pop('CUDA_VISIBLE_DEVICES', None)
    return env


def _wait(procs, logs, wall: float) -> None:
    """Wait for every rank under the wall limit; kill them all and fail
    with the logs when one fails or the limit passes."""
    deadline = time.monotonic() + wall
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = '\n'.join(f'--- rank {r} (exit {procs[r].returncode}):\n'
                         + open(logs[r]).read()[-6000:] for r in bad)
        raise AssertionError(f'ranks {bad} failed or passed the {wall} s '
                             f'wall limit:\n{text}')


def launch(scenarios, tmp, inputs=None, n: int = 2, wall: float = WALL_S):
    """Run ``scenarios`` (names in :data:`SCENARIOS`) on ``n`` ranks with
    ``inputs`` (a dict every rank reads); returns each rank's ``{scenario:
    result}``."""
    return start(scenarios, tmp, inputs, n, wall)()


def start(scenarios, tmp, inputs=None, n: int = 2, wall: float = WALL_S):
    """:func:`launch` without the wait: the ranks run while the caller
    works; the returned function waits and returns their results."""
    tmp = str(tmp)
    torch.save(inputs or {}, os.path.join(tmp, 'inputs.pt'))
    port = free_port()
    logs = [os.path.join(tmp, f'rank{r}.log') for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], 'w') as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(r), str(n), str(port), tmp,
                 *scenarios], env=_env(), stdout=log, stderr=subprocess.STDOUT,
                cwd=REPO))
    started = time.monotonic()

    def finish():
        _wait(procs, logs, wall - (time.monotonic() - started))
        return [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                           weights_only=False) for r in range(n)]
    return finish


def start_cli(argv, tmp, n: int = 2, wall: float = WALL_S, env=None):
    """Start ``python -m single_shot_detection_tpu_torch --cpu ARGV`` once
    per rank with the three distributed flags (``env``: variables to set,
    or to remove where None); returns the function that waits for them."""
    env_ = _env()
    for key, value in (env or {}).items():
        if value is None:
            env_.pop(key, None)
        else:
            env_[key] = value
    port = free_port()
    logs = [os.path.join(str(tmp), f'cli{r}.log') for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], 'w') as log:
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'single_shot_detection_tpu_torch',
                 '--cpu', *argv, '--coordinator-address', f'127.0.0.1:{port}',
                 '--num-processes', str(n), '--process-id', str(r)],
                env=env_, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    started = time.monotonic()
    return lambda: _wait(procs, logs, wall - (time.monotonic() - started))


# ------------------------------------------------------------- the ranks

def rows(rank: int, n: int, batch: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``batch``."""
    b = batch // n
    return slice(rank * b, (rank + 1) * b)


def small_step(rank, n, inputs):
    """One SGD step of the small detector on this rank's rows, with the
    global-batch semantics."""
    from single_shot_detection_tpu_torch.models import builder
    from single_shot_detection_tpu_torch.models.layers import (set_group_norm,
                                                               set_sync_bn)
    from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder
    from single_shot_detection_tpu_torch.ops.losses import MultiboxLoss
    from single_shot_detection_tpu_torch.ops.matching import TargetAssigner
    from single_shot_detection_tpu_torch.ops.sampling import naive_sampler
    from single_shot_detection_tpu_torch.train import optimizers
    from single_shot_detection_tpu_torch.train.state import TrainState
    from single_shot_detection_tpu_torch.train.step import make_update_step

    bundle = builder.build(**SMALL)
    model = bundle.module
    model.load_state_dict(inputs['state_dict'])
    set_sync_bn(model, True)
    criterion = MultiboxLoss(naive_sampler, BoxCoder(10.0, 5.0),
                             {'name': 'CrossEntropyLoss'},
                             {'name': 'SmoothL1Loss'})
    anchors = torch.from_numpy(bundle.anchors)
    state = TrainState(model, optimizers.create_optimizer(
        {'name': 'SGD', 'lr': SMALL_LR}, model.named_parameters()))
    update = make_update_step(criterion, TargetAssigner(0.5), anchors,
                              lambda count: SMALL_LR)
    own = rows(rank, n, len(inputs['image']))
    x = torch.from_numpy(inputs['image'][own].transpose(0, 3, 1, 2).copy())
    metrics = update(state, x, torch.from_numpy(inputs['boxes'][own]),
                     torch.from_numpy(inputs['box_mask'][own]))
    return {'metrics': {k: v.item() for k, v in metrics.items()},
            'state_dict': {k: v.clone() for k, v in model.state_dict().items()}}


def smoke_trainer(rank, n, train=None, **overrides):
    """The smoke config's ``Trainer`` from the committed checkpoint's
    weights, rank ``rank`` of ``n``."""
    from single_shot_detection_tpu_torch.train import checkpoint
    from single_shot_detection_tpu_torch.trainer import Trainer
    trainer = Trainer.from_config(
        SMOKE, device='cpu', overrides={
            'train': {'optimizer': SGD, **(train or {})}, **overrides},
        process_count=n, process_index=rank)
    checkpoint.restore_weights_only(CKPT, trainer.state)
    return trainer


def trainer_steps(trainer, inputs, rank, n, steps: int = 1):
    """``steps`` train steps on this rank's rows of the global batch
    ``inputs['smoke']``."""
    smoke = inputs['smoke']
    own = rows(rank, n, len(smoke['image']))
    batch = [smoke[k][own] for k in ('image', 'boxes', 'box_mask')]
    draws = trainer.step_draws(trainer.state.step, len(batch[0]))
    metrics = [trainer.train_step(*batch) for _ in range(steps)]
    return {'draws': draws,
            'metrics': [{k: v.item() for k, v in m.items()} for m in metrics],
            'state_dict': {k: v.clone()
                           for k, v in trainer.model.state_dict().items()},
            'ema': {k: v.clone() for k, v in trainer.state.ema_params.items()}}


def s_vs_jax(rank, n, inputs, tmp):
    return small_step(rank, n, inputs)


def s_planted(rank, n, inputs, tmp):
    """The planted fault: the loss divides by this rank's own positive
    count (the loss module's collectives replaced by the identity)."""
    from single_shot_detection_tpu_torch.ops import losses
    real = losses.parallel
    losses.parallel = types.SimpleNamespace(all_reduce_=lambda t, op='sum': t)
    try:
        return small_step(rank, n, inputs)
    finally:
        losses.parallel = real


def s_augmented(rank, n, inputs, tmp):
    return trainer_steps(smoke_trainer(rank, n), inputs, rank, n)


def s_mixup(rank, n, inputs, tmp):
    trainer = smoke_trainer(rank, n, {'mixup': {'alpha': 0.4, 'p': 0.5}})
    return trainer_steps(trainer, inputs, rank, n)


def s_qat(rank, n, inputs, tmp):
    from single_shot_detection_tpu_torch.export import quantize
    trainer = smoke_trainer(rank, n, {'qat': True}, augmentations=[])
    out = trainer_steps(trainer, inputs, rank, n)
    out['amax'] = quantize.amax_from_batch_stats(trainer.model.state_dict())
    return out


def s_fused_bn(rank, n, inputs, tmp):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    logging.getLogger().addHandler(handler)
    try:
        trainer = smoke_trainer(rank, n, {'fused_bn': True})
    finally:
        logging.getLogger().removeHandler(handler)
    out = trainer_steps(trainer, inputs, rank, n)
    out['log'] = records
    out['fused'] = [m.fused for m in trainer.model.modules()
                    if hasattr(m, 'fused')]
    return out


ZERO_TRAIN = {'optimizer': {'name': 'Adam', 'lr': 1e-3}, 'ema': 0.9,
              'accumulation_steps': 2, 'clip_grad_norm': 1.0}


def s_zero(rank, n, inputs, tmp):
    out = {}
    for key, zero in (('zero', True), ('plain', False)):
        trainer = smoke_trainer(rank, n, {**ZERO_TRAIN, 'zero_sharding': zero},
                                augmentations=[])
        result = trainer_steps(trainer, inputs, rank, n, steps=2)
        optimizer = trainer.state.optimizer
        names = {p: name for name, p in trainer.model.named_parameters()}
        result['buffers'] = {names[p]: {k: v.clone() for k, v in s.items()}
                             for p, s in optimizer.state.items()}
        result['axes'] = dict(trainer.state.zero.axes) if zero else None
        result['full_state'] = optimizer.full_state_dict()
        trainer.gather_shadow()
        result['ema_whole'] = {k: v.clone()
                               for k, v in trainer.state.ema_params.items()}
        out[key] = result
    return out


def digest(model) -> float:
    return float(sum(p.detach().abs().sum().item()
                     for p in model.parameters()))


def experiment(rank, n, cfg, **kwargs):
    from single_shot_detection_tpu_torch.train.engine import Experiment
    return Experiment(cfg, phases=kwargs.pop('phases', ('train', 'eval')),
                      device='cpu', process_count=n, process_index=rank,
                      **kwargs)


def s_experiment(rank, n, inputs, tmp):
    exp = experiment(rank, n, inputs['cfg'], debug=True)
    rows_ = exp.train()
    return {'rows': rows_, 'digest': digest(exp.model),
            'batches': len(exp.loaders['train'])}


def s_device_cache(rank, n, inputs, tmp):
    out = {}
    for key in ('cached', 'streamed'):
        exp = experiment(rank, n, inputs[f'{key}_cfg'], debug=True)
        rows_ = exp.train()
        out[key] = {'rows': rows_, 'digest': digest(exp.model),
                    'ready': bool(exp.device_cache is not None
                                  and exp.device_cache.ready),
                    'state_dict': {k: v.clone() for k, v
                                   in exp.model.state_dict().items()}}
    return out


def s_zero_checkpoint(rank, n, inputs, tmp):
    """A ZeRO run and a plain run save (rank 0 writes); then each restores
    into the other kind of run."""
    out = {}
    dirs = {key: os.path.join(tmp, f'{key}_run') for key in ('zero', 'plain')}
    for key in dirs:
        exp = experiment(rank, n, inputs[f'{key}_cfg'], phases=('train',),
                         checkpoint_dir=dirs[key])
        exp.train()
        out[key] = {'digest': digest(exp.model),
                    'step': exp.trainer.state.step}
    for key, source in (('plain_from_zero', 'zero'), ('zero_from_plain', 'plain')):
        cfg = inputs['plain_cfg' if key.startswith('plain') else 'zero_cfg']
        exp = experiment(rank, n, cfg, phases=('train',),
                         resume_from=dirs[source])
        optimizer = exp.trainer.state.optimizer
        names = {p: name for name, p in exp.model.named_parameters()}
        out[key] = {
            'buffers': {names[p]: {k: v.clone() for k, v in s.items()}
                        for p, s in optimizer.state.items()},
            'axes': (dict(exp.trainer.state.zero.axes)
                     if exp.trainer.state.zero else None),
            'step': exp.trainer.state.step, 'start_epoch': exp.start_epoch,
            'digest': digest(exp.model)}
    return out


def s_rank0_writes(rank, n, inputs, tmp):
    """Each rank gets a directory of its own: only rank 0's is written."""
    directory = os.path.join(tmp, f'writes_rank{rank}')
    exp = experiment(rank, n, inputs['cfg'], checkpoint_dir=directory)
    exp.train()
    return {'dir': directory}


def s_pruner(rank, n, inputs, tmp):
    """``MeanActivation`` pruning, observed every step: each rank's means
    are of its own rows, the criterion's of the global batch."""
    exp = experiment(rank, n, inputs['pruner_cfg'], phases=('train',),
                     debug=True)
    exp.train()
    return {'dead': {k: sorted(v) for k, v in exp.pruner.dead.items()},
            'mask': {k: v.clone() for k, v in exp.trainer.state.mask.items()},
            'ema': dict(exp.pruner.criterion.ema)}


# ------------------------------------------------------------ the model axis
# JAX tests/test_pipeline.py's small M2Det (MLFPN, 4 TUMs, 3 scales)
SMALL_M2DET = {**SMALL,
               'anchor_generator': {'type': 'ssd', 'num_scales': 3,
                                    'min_scale': 0.2, 'max_scale': 0.9,
                                    'aspect_ratios': [[1.0]] * 3},
               'features': {'name': 'MultilevelFeaturePyramid',
                            'out_layers': (13, 18), 'num_scales': 3,
                            'num_tums': 4, 'base_reduced_channels': (64, 128),
                            'reduced_channels': 32,
                            'tum': {'inner_channels': 32, 'out_channels': 16}}}


def whole_state(model, axes=None) -> dict:
    """The model's ``state_dict``, its tensor-sharded entries gathered."""
    from single_shot_detection_tpu_torch.parallel import tensor
    return {k: tensor.gather_leaf(v, (axes or {}).get(k)).clone()
            for k, v in model.state_dict().items()}


def world_normaliser():
    """The planted fault of the model axis: the loss's positive count
    summed over the world (each model group's count ``m`` times) instead
    of the data axis."""
    from single_shot_detection_tpu_torch import parallel
    from single_shot_detection_tpu_torch.ops import losses
    real = losses.parallel
    losses.parallel = types.SimpleNamespace(
        all_reduce_=lambda t, op='sum': parallel.all_reduce_(t, op, 'world'))
    return lambda: setattr(losses, 'parallel', real)


def axis_step(rank, n, inputs, mode, m, spec=SMALL, planted=False,
              microbatches=0, group_norm=None):
    """One SGD step of a small detector from ``inputs``'s weights with
    ``mode`` owning a model axis of ``m`` over ``n`` ranks (None: the data
    axis only), on this data rank's rows of ``inputs``'s global batch;
    the eval-mode forward of those rows first.  Pipeline steps run frozen
    BN, as the option requires; ``group_norm`` makes every BN a GroupNorm
    of that many groups."""
    from single_shot_detection_tpu_torch import parallel
    from single_shot_detection_tpu_torch.models import builder
    from single_shot_detection_tpu_torch.models.layers import (set_group_norm,
                                                               set_sync_bn)
    from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder
    from single_shot_detection_tpu_torch.ops.losses import MultiboxLoss
    from single_shot_detection_tpu_torch.ops.matching import TargetAssigner
    from single_shot_detection_tpu_torch.ops.sampling import naive_sampler
    from single_shot_detection_tpu_torch.parallel import spatial, tensor
    from single_shot_detection_tpu_torch.train import optimizers
    from single_shot_detection_tpu_torch.train.state import TrainState
    from single_shot_detection_tpu_torch.train.step import make_update_step

    bundle = builder.build(**spec)
    model = bundle.module
    model.load_state_dict(inputs['state_dict'])
    parallel.set_model_axis(mode, m)
    set_sync_bn(model, n > 1)
    set_group_norm(model, group_norm)
    state = TrainState(model, optimizers.create_optimizer(
        {'name': 'SGD', 'lr': SMALL_LR}, model.named_parameters()))
    axes = None
    if mode == 'tensor':
        axes = parallel.tensor_state_sharding(model.state_dict().items(), m)
        tensor.shard_state_(state, axes)
        state.tensor = axes
    own = rows(parallel.data_index(), parallel.data_count(),
               len(inputs['image']))
    x = torch.from_numpy(inputs['image'][own].transpose(0, 3, 1, 2).copy())
    out = {'bytes': sum(p.numel() * p.element_size()
                        for p in model.parameters())}
    spatial.STATS.update(max_extra_rows=0, largest_whole=0, rows_received=0,
                         halo_bytes=0)
    if mode != 'pipeline':
        with torch.no_grad():
            scores, locs = model.eval()(x)
        out['forward'] = (scores.clone(), locs.clone())
    criterion = MultiboxLoss(naive_sampler, BoxCoder(10.0, 5.0),
                             {'name': 'CrossEntropyLoss'},
                             {'name': 'SmoothL1Loss'})
    update = make_update_step(
        criterion, TargetAssigner(0.5), torch.from_numpy(bundle.anchors),
        lambda count: SMALL_LR, frozen_bn=mode == 'pipeline',
        grad_axis='world' if mode in ('spatial', 'pipeline') else 'data',
        microbatches=microbatches)
    restore = world_normaliser() if planted else (lambda: None)
    try:
        metrics = update(state, x, torch.from_numpy(inputs['boxes'][own]),
                         torch.from_numpy(inputs['box_mask'][own]))
    finally:
        restore()
    out.update(metrics={k: v.item() for k, v in metrics.items()},
               state_dict=whole_state(model, axes),
               windows=dict(spatial.STATS),
               sliced=sum(a is not None for a in (axes or {}).values()))
    parallel.set_model_axis(None)
    return out


def pipeline_grads(rank, n, inputs, spec, microbatches):
    """The pipelined forward of this data rank's rows and the gradient of
    JAX ``test_pipeline.py``'s ``sum(s ** 2) + sum(|l|)`` over the global
    batch, summed over the world (every rank holds it whole)."""
    from single_shot_detection_tpu_torch import parallel
    from single_shot_detection_tpu_torch.models import builder
    from single_shot_detection_tpu_torch.parallel import pipeline

    model = builder.build(**spec).module
    model.load_state_dict(inputs['state_dict'])
    parallel.set_model_axis('pipeline', inputs['stages'])
    own = rows(parallel.data_index(), parallel.data_count(),
               len(inputs['image']))
    x = torch.from_numpy(inputs['image'][own].transpose(0, 3, 1, 2).copy())
    model.eval()
    scores, locs, backward = pipeline.pipeline_apply(model, x, microbatches)
    loss = (scores ** 2).sum() + locs.abs().sum()
    loss.backward()
    backward()
    params = list(model.parameters())
    parallel.all_reduce_grads(params, 'world')
    grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    parallel.set_model_axis(None)
    return {'forward': (scores.detach().clone(), locs.detach().clone()),
            'grads': grads, 'bytes': dict(pipeline.STATS)}


def assert_matches_step(result, want, before, update_tol=1e-4):
    """``result`` against another port step ``want`` from the same
    weights: the loss, each update as a share of the largest, the BN
    statistics."""
    np.testing.assert_allclose(result['metrics']['loss'],
                               want['metrics']['loss'], rtol=1e-5)
    got, after = result['state_dict'], want['state_dict']
    updates = {name: (after[name] - before[name]).numpy()
               for name in after if name.endswith(('weight', 'bias'))}
    largest = max(np.abs(u).max() for u in updates.values())
    errs = {name: np.abs((got[name] - before[name]).numpy() - u).max()
            for name, u in updates.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= update_tol * largest, (worst, errs[worst], largest)
    for name in after:
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got[name].numpy(),
                                       after[name].numpy(), atol=1e-5)


def s_tensor_step(rank, n, inputs, tmp):
    return axis_step(rank, n, inputs, 'tensor', n)


def s_tensor_planted(rank, n, inputs, tmp):
    return axis_step(rank, n, inputs, 'tensor', n, planted=True)


def s_spatial_step(rank, n, inputs, tmp):
    return axis_step(rank, n, inputs, 'spatial', n)


def s_tensor_group_norm(rank, n, inputs, tmp):
    return axis_step(rank, n, inputs, 'tensor', n, group_norm=8)


def s_spatial_group_norm(rank, n, inputs, tmp):
    return axis_step(rank, n, inputs, 'spatial', n, group_norm=8)


def s_spatial_planted(rank, n, inputs, tmp):
    return axis_step(rank, n, inputs, 'spatial', n, planted=True)


def s_pipeline_grads(rank, n, inputs, tmp):
    """At 2 stages over 2 data ranks, and at 4 over the 4 ranks."""
    out = {}
    for stages, micro in ((2, 2), (4, 2)):
        out[stages] = pipeline_grads(rank, n, {**inputs['m2det'],
                                               'stages': stages},
                                     SMALL_M2DET, micro)
    return out


def s_pipeline_step(rank, n, inputs, tmp):
    return axis_step(rank, n, inputs['m2det'], 'pipeline', 2, SMALL_M2DET,
                     microbatches=2)


def s_pipeline_planted(rank, n, inputs, tmp):
    return axis_step(rank, n, inputs['m2det'], 'pipeline', 2, SMALL_M2DET,
                     planted=True, microbatches=2)


def experiment_result(exp, rows_) -> dict:
    """An experiment's last row and its whole parameters' digest."""
    state = exp.trainer.state
    whole = whole_state(exp.model, state.tensor)
    names = dict(exp.model.named_parameters())
    return {'rows': rows_,
            'digest': float(sum(whole[k].abs().sum().item() for k in names))}


def s_experiment_axis(rank, n, inputs, tmp):
    """``Experiment`` with the file's model-axis option, a short epoch and
    an evaluation."""
    exp = experiment(rank, n, inputs['axis_cfg'], debug=True)
    return experiment_result(exp, exp.train())


def s_tensor_checkpoints(rank, n, inputs, tmp):
    """A tensor-sharded run resumes a one-process run's checkpoint, and
    saves its own (rank 0 writes the whole state)."""
    resumed = experiment(rank, n, inputs['axis_cfg'], phases=('train',),
                         resume_from=inputs['one_process_dir'])
    out = {'resumed': {'step': resumed.trainer.state.step,
                       'state': whole_state(resumed.model,
                                            resumed.trainer.state.tensor)}}
    directory = os.path.join(tmp, 'tensor_run')
    exp = experiment(rank, n, inputs['axis_cfg'], phases=('train',),
                     checkpoint_dir=directory)
    exp.train()
    from single_shot_detection_tpu_torch.train import checkpoint
    saved = checkpoint.gather_for_save(exp.trainer.state)
    out['saved'] = {'dir': directory, 'model': saved['model'],
                    'optimizer': saved['optimizer']['state']}
    return out


SCENARIOS = {name[2:]: fn for name, fn in dict(globals()).items()
             if name.startswith('s_')}


def main(argv) -> None:
    rank, n, port, tmp, *names = argv
    rank, n = int(rank), int(n)
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.INFO, format='%(message)s',
                        stream=sys.stdout)
    from single_shot_detection_tpu_torch import parallel
    parallel.initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu',
                                    timeout=COLLECTIVE_TIMEOUT_S)
    try:
        inputs = torch.load(os.path.join(tmp, 'inputs.pt'), weights_only=False)
        results = {}
        for name in names:
            np.random.seed(0)
            results[name] = SCENARIOS[name](rank, n, inputs, tmp)
        torch.save(results, os.path.join(tmp, f'rank{rank}.pt'))
    finally:
        parallel.destroy()


if __name__ == '__main__':
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
