"""The accuracy protocol's committed inputs for the port's tests and its
card diagnostics (``tools/parity_run.py``'s SSD-MobileNetV2-0.35 at 128
px, b8), and the script that writes them.

    python tests/_torch_protocol.py state CKPT.pt tests/data/protocol_state.npz
    python tests/_torch_protocol.py flips tests/data/protocol_jax_hflips.npz \\
        --seeds 23-32 --steps 3840
    PYTHONPATH=. python tests/_torch_protocol.py bn-error
    PYTHONPATH=. python tests/_torch_protocol.py sensitivity --r 1e-7 --seeds 1

``state`` keeps a ``.pt`` checkpoint's model ``state_dict`` (the port's
names, floating tensors only) as an ``.npz``.  ``flips`` writes the
horizontal flips the JAX engine draws in the protocol: at global step
``s`` of seed ``n`` the engine's key is ``fold_in(PRNGKey(n), s)``
(``train/engine.py``), the step splits it and gives the first half to the
``Pipeline`` (``train/step.py``), which splits that into one key an image
and each image's into one key a stage (``data/transforms.py``); the one
stage, ``RandomHorizontalFlip``, flips where ``uniform(key) < 0.5``.
``flips_<n>`` holds ``np.packbits`` of the ``[steps, batch]`` booleans.
``bn-error`` prints each package's BN arithmetic on the state against
float64 (:func:`bn_errors`), ``sensitivity`` one protocol step of each
package and each package's sensitivity to itself (:func:`step_readings`;
``tests/test_torch_port_protocol_step.py`` asserts its reading at
``r = 1e-6``).
"""

import argparse
import os

import numpy as np

BATCH = 8
STEPS = 3840        # 60 epochs of 512 images at b8
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
STATE = os.path.join(DATA, 'protocol_state.npz')
FLIPS = os.path.join(DATA, 'protocol_jax_hflips.npz')


def jax_flips(seed: int, steps: int, batch: int = BATCH) -> np.ndarray:
    """``[steps, batch]`` bool: the JAX engine's hflip decisions."""
    import jax

    def one(step):
        aug_rng = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), step))[0]
        keys = jax.random.split(aug_rng, batch)
        stage = jax.vmap(lambda k: jax.random.split(k, 1)[0])(keys)
        return jax.vmap(jax.random.uniform)(stage) < 0.5

    return np.asarray(jax.jit(jax.vmap(one))(np.arange(steps)))


def write_flips(path: str, seeds, steps: int = STEPS) -> None:
    np.savez_compressed(path, batch=BATCH, steps=steps, **{
        f'flips_{seed}': np.packbits(jax_flips(seed, steps)) for seed in seeds})


def write_state(ckpt: str, path: str) -> None:
    import torch
    model = torch.load(ckpt, map_location='cpu', weights_only=False)['model']
    np.savez_compressed(path, **{k: v.numpy() for k, v in model.items()
                                 if v.is_floating_point()})


def protocol_inputs(work: str, state: str = STATE):
    """The protocol's config (written under ``work``), ``state``'s JAX
    variables and 8 images of its kind with their boxes and mask
    (``Synthetic`` at seed 23)."""
    import torch

    from single_shot_detection_tpu.data.datasets import Synthetic
    from single_shot_detection_tpu_torch.tools import parity_run
    from single_shot_detection_tpu_torch.utils.weights import to_jax_variables

    csvs = {(a, b): os.path.join(work, f'{a}_{b}.csv')
            for a in ('train', 'eval') for b in ('ours', 'ref')}
    config = parity_run.write_configs(work, csvs, 60, 23, '40,52')['ours']
    with np.load(state) as data:
        variables = to_jax_variables(
            {k: torch.from_numpy(data[k]) for k in data.files})
    data = Synthetic(num_images=BATCH, image_size=parity_run.IMG,
                     num_classes=parity_run.NUM_CLASSES, max_boxes=3, seed=23)
    images = np.stack([a['image'] for a in data.annotations])
    boxes = np.zeros((BATCH, 8, 6), np.float32)
    mask = np.zeros((BATCH, 8), bool)
    for i, a in enumerate(data.annotations):
        boxes[i, :len(a['boxes'])] = a['boxes']
        mask[i, :len(a['boxes'])] = True
    return config, variables, (images, boxes, mask)


def jax_step(config: str):
    """The JAX engine's train step for the protocol (flax's BatchNorm: the
    protocol's JAX run has no ``train.fused_bn``) and its optimizer."""
    from single_shot_detection_tpu.data.transforms import Pipeline
    from single_shot_detection_tpu.models import builder as jax_builder
    from single_shot_detection_tpu.ops import box_coder, losses, matching
    from single_shot_detection_tpu.ops import sampling
    from single_shot_detection_tpu.train import optimizers, schedulers
    from single_shot_detection_tpu.train.step import make_train_step
    from single_shot_detection_tpu.utils.config import load_config

    cfg = load_config(config)
    model = dict(cfg.model)
    det = {k: v for k, v in model['detector'].items()
           if k in ('num_classes', 'use_depthwise', 'features', 'extras')}
    bundle = jax_builder.build(base=model['base'],
                               anchor_generator=model['anchor_generator'],
                               input_size=tuple(cfg.input_size), **det)
    sampler_cfg = dict(cfg.sampler)
    sampler = sampling.build_sampler(sampler_cfg.pop('name'), **sampler_cfg)
    criterion = losses.MultiboxLoss(
        sampler=sampler, box_coder=box_coder.BoxCoder(**cfg.box_coder),
        **cfg.loss)
    assigner = matching.TargetAssigner(**(cfg.target_assigner or {}))
    optimizer = dict(cfg.train['optimizer'])
    schedule = schedulers.create_lr_schedule(
        dict(cfg.train['scheduler']), optimizer['lr'], 64)[0]
    tx = optimizers.create_optimizer(optimizer, lr_schedule=schedule)
    pipeline = Pipeline((), cfg.preprocessing, tuple(cfg.input_size),
                        train=True)
    step = make_train_step(bundle.module, criterion, assigner,
                           bundle.anchors(), tx, pipeline=pipeline,
                           donate=False)
    return step, tx


def step_readings(work: str, r: float, seeds=(1, 2)) -> dict:
    """One protocol step from the state through the JAX package and the
    port (``Trainer.train_step``, its default BN path), no augmentation,
    and each package's step again with every weight multiplied by ``1 + r
    N(0, 1)``, one draw a seed.  Each parameter tensor's update (after -
    before) is compared as a share of its own largest update, or of 1 % of
    the step's largest update where that is larger (a BN bias feeding the
    next BN has a gradient of rounding noise alone).  Returns the shares of
    port against JAX and of each draw against its package's unperturbed
    step (``table``), their largest (``worst``), the unperturbed losses and
    the loss's move under each draw."""
    import jax
    import torch

    from single_shot_detection_tpu_torch.trainer import Trainer
    from single_shot_detection_tpu_torch.utils.weights import \
        from_jax_variables

    from _torch_port_fixtures import jax_train_state

    config, variables, (images, boxes, mask) = protocol_inputs(work)
    step, tx = jax_step(config)
    batch = {'image': images, 'boxes': boxes, 'box_mask': mask}

    start = jax_train_state(variables, tx)  # zero momentum, any weights

    def jax_update(v):
        state = start.replace(params=v['params'], batch_stats=v['batch_stats'])
        after, metrics = step(state, batch, jax.random.PRNGKey(0))
        update = jax.tree_util.tree_map(
            lambda a, b: np.asarray(a) - np.asarray(b), after.params,
            state.params)
        return ({k: u.numpy() for k, u in
                 from_jax_variables({'params': update}).items()},
                float(metrics['loss']))

    def port_update(v):
        trainer = Trainer.from_config(config, variables=v, device='cpu',
                                      overrides={'augmentations': []})
        params = dict(trainer.model.named_parameters())
        before = {k: p.detach().clone() for k, p in params.items()}
        loss = float(trainer.train_step(images, boxes, mask)['loss'])
        return {k: (p.detach() - before[k]).numpy()
                for k, p in params.items()}, loss

    def perturbed(seed):
        rng = np.random.RandomState(seed)
        return jax.tree_util.tree_map(
            lambda a: (a * (1 + r * rng.randn(*a.shape))).astype(a.dtype),
            variables)

    def shares(got, want):
        return {k: float(np.abs(got[k] - want[k]).max()
                         / max(np.abs(want[k]).max(), floor)) for k in want}

    runs = {name: update(variables) for name, update in
            (('jax', jax_update), ('port', port_update))}
    floor = 1e-2 * max(np.abs(u).max() for u in runs['jax'][0].values())
    assert set(runs['port'][0]) == set(runs['jax'][0])
    table = {'port-jax': shares(runs['port'][0], runs['jax'][0])}
    loss_moves = {}
    for name, update in (('jax', jax_update), ('port', port_update)):
        ref, loss = runs[name]
        for seed in seeds:
            got, got_loss = update(perturbed(seed))
            table[f'{name}-{name} {r:g} #{seed}'] = shares(got, ref)
            loss_moves[f'{name} {r:g} #{seed}'] = abs(got_loss - loss)
    return {'table': table,
            'worst': {col: max(v.values()) for col, v in table.items()},
            'loss': {name: runs[name][1] for name in runs},
            'loss_moves': loss_moves}


def print_readings(readings: dict) -> None:
    table = readings['table']
    print(f'\n{"tensor":50s}' + ''.join(f'{c:>20s}' for c in table))
    for k in table['port-jax']:
        print(f'{k:50s}' + ''.join(f'{table[c][k]:20.2e}' for c in table))
    print('largest share', readings['worst'])
    loss = readings['loss']
    print(f'loss jax {loss["jax"]!r} port {loss["port"]!r}; |port - jax| '
          f'{abs(loss["port"] - loss["jax"]):.3g}; move under each draw '
          f'{readings["loss_moves"]}')


def bn_errors(state: str = STATE) -> dict:
    """``{BN name: (JAX, port)}``: each package's train-mode BN output on
    the protocol's 8 images (``Synthetic`` at seed 23, the state of
    ``state``) against float64 BN of that package's own f32 input, as a
    share of the output's largest magnitude: the arithmetic error of each
    package's batch statistics and normalization alone."""
    import tempfile

    import flax.linen as nn
    import jax
    import torch

    from single_shot_detection_tpu.models import builder as jax_builder
    from single_shot_detection_tpu_torch.models.layers import BatchNorm
    from single_shot_detection_tpu_torch.trainer import Trainer
    from single_shot_detection_tpu_torch.utils.config import load_config

    config, variables, (images, _, _) = protocol_inputs(tempfile.mkdtemp(),
                                                        state)
    images = images / 255.0
    x = ((images - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]).astype(
        np.float32)

    def exact(x_in, scale, bias):
        x64 = np.asarray(x_in, np.float64)
        mean = x64.mean((0, 2, 3), keepdims=True)
        var = ((x64 - mean) ** 2).mean((0, 2, 3), keepdims=True)
        return ((x64 - mean) / np.sqrt(var + 1e-5) * scale.reshape(1, -1, 1, 1)
                + bias.reshape(1, -1, 1, 1))

    def share(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    cfg = load_config(config)
    det = {k: v for k, v in dict(cfg.model['detector']).items()
           if k in ('num_classes', 'use_depthwise', 'features', 'extras')}
    bundle = jax_builder.build(base=cfg.model['base'],
                               anchor_generator=cfg.model['anchor_generator'],
                               input_size=tuple(cfg.input_size), **det)

    @jax.jit
    def jax_forward(v, xx):
        captured = {}

        def keep(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.BatchNorm) and \
                    context.method_name == '__call__':
                captured['/'.join(context.module.path)] = (args[0], out)
            return out

        with nn.intercept_methods(keep):
            bundle.module.apply(v, xx, train=True, mutable=['batch_stats'])
        return captured

    jax_seen = jax_forward(variables, x)
    trainer = Trainer.from_config(config, variables=variables, device='cpu',
                                  overrides={'augmentations': []})
    port_seen = {}
    for name, m in trainer.model.named_modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(
                lambda mod, a, out, name=name: port_seen.__setitem__(
                    name, (a[0].detach().numpy(), out.detach().numpy(),
                           mod.weight.detach().numpy(),
                           mod.bias.detach().numpy())))
    trainer.model.train()
    with torch.no_grad():
        trainer.model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    out = {}
    for name, (x_in, z, scale, bias) in port_seen.items():
        jx, jz = (np.asarray(a).transpose(0, 3, 1, 2)
                  for a in jax_seen[name.replace('.', '/')])
        out[name] = (share(jz, exact(jx, scale, bias)),
                     share(z, exact(x_in, scale, bias)))
    return out


def main(argv=None) -> None:
    from single_shot_detection_tpu_torch.tools.hflip_injection import seed_list
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest='what', required=True)
    state = sub.add_parser('state')
    state.add_argument('ckpt')
    state.add_argument('out')
    flips = sub.add_parser('flips')
    flips.add_argument('out')
    flips.add_argument('--seeds', default='23-32')
    flips.add_argument('--steps', type=int, default=STEPS)
    sub.add_parser('bn-error')
    sensitivity = sub.add_parser('sensitivity')
    sensitivity.add_argument('--r', type=float, default=1e-7)
    sensitivity.add_argument('--seeds', default='1')
    args = ap.parse_args(argv)
    if args.what == 'state':
        write_state(args.ckpt, args.out)
    elif args.what == 'flips':
        write_flips(args.out, seed_list(args.seeds), args.steps)
    elif args.what == 'sensitivity':
        import tempfile
        print_readings(step_readings(tempfile.mkdtemp(), args.r,
                                     seed_list(args.seeds)))
    else:
        errors = bn_errors()
        for name, (jax_err, port_err) in errors.items():
            print(f'{name:45s} JAX {jax_err:.2e} port {port_err:.2e}')
        print('largest: JAX', max(e[0] for e in errors.values()),
              'port', max(e[1] for e in errors.values()))


if __name__ == '__main__':
    main()
