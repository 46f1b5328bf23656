"""Shared parts of the model zoo's tests (``test_torch_port_zoo*.py``):
the JAX side of one config at a reduced input size (its detector, its
initializer run as one jit, its eval forward, its train step with flax's
own BatchNorm or another forward such as ``group_norm_apply``), seeded
batches and variables, layout helpers, and the comparisons the files make.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from single_shot_detection_tpu.data.datasets import Synthetic
from single_shot_detection_tpu.data.transforms import Pipeline
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops import box_coder as jax_box_coder
from single_shot_detection_tpu.ops import losses as jax_losses
from single_shot_detection_tpu.ops import matching as jax_matching
from single_shot_detection_tpu.ops import sampling as jax_sampling
from single_shot_detection_tpu.train import optimizers as jax_optimizers
from single_shot_detection_tpu.train import schedulers as jax_schedulers
from single_shot_detection_tpu.train.step import make_train_step
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.models.layers import xavier_normal
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import jax_train_state

OPTIMIZER = {'name': 'SGD', 'lr': 0.01, 'momentum': 0.9, 'weight_decay': 1e-4}
SCHEDULER = {'name': 'MultiStepLR', 'milestones': [10], 'gamma': 0.1}
# MobileNet v1 under the depthwise FPN, on the flagship's anchors: no shipped
# config uses either, so the tests put this ``model`` into
# ``samples/ssd_mb2_voc.py`` (300 px: taps 18 and 9 px, extra levels 5, 3,
# 2, 1, the (0, 1) pad on the odd 9, 5 and 3)
MBV1_DFPN_MODEL = {
    'base': {'name': 'mobilenet_v1'},
    'detector': {
        'num_classes': 21,
        'features': {'name': 'DepthwiseFeaturePyramid', 'out_layers': (11, 13),
                     'pyramid_layers': 6, 'pyramid_channels': 128},
    },
    'anchor_generator': {
        'type': 'ssd', 'num_scales': 6, 'min_scale': 0.1, 'max_scale': 1.05,
        'aspect_ratios': [[1.0, 2.0]] + [[1.0, 2.0, 3.0]] * 3 + [[1.0, 2.0]] * 2,
    },
}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def as_nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def assert_close(got, want, atol=1e-5, rtol=1e-5):
    """rtol, and atol scaled by max(1, the largest reference value)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def random_variables(module, *inputs, rng):
    """A seeded JAX variable tree of ``module`` (shapes from
    ``jax.eval_shape`` of its init, so only the apply compiles): He-scaled
    kernels, non-trivial BN statistics and affine parameters."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))

    def fill(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == 'kernel':
            value = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif key == 'scale':
            value = 1 + rng.randn(*shape) * 0.1
        elif key == 'var':
            value = rng.rand(*shape) + 0.5
        else:  # bias, mean
            value = rng.randn(*shape) * 0.1
        return value.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def to_jax_variables(state_dict) -> dict:
    """A port ``state_dict`` as a JAX ``{'params', 'batch_stats'}`` tree of
    numpy arrays (OIHW -> HWIO): the inverse of ``from_jax_variables``."""
    variables = {'params': {}, 'batch_stats': {}}
    for name, value in state_dict.items():
        *module, leaf = name.split('.')
        if leaf == 'num_batches_tracked':
            continue
        arr = value.detach().numpy()
        coll, key = {'running_mean': ('batch_stats', 'mean'),
                     'running_var': ('batch_stats', 'var'),
                     'bias': ('params', 'bias')}.get(
            leaf, ('params', 'kernel' if arr.ndim == 4 else 'scale'))
        node = variables[coll]
        for part in module:
            node = node.setdefault(part, {})
        node[key] = arr.transpose(2, 3, 1, 0) if key == 'kernel' else arr
    return variables


class JaxSide:
    """One config's JAX detector at ``size`` px, with ``variables`` or,
    without them, variables from its own initializer (one jit).  ``model``
    replaces the config's ``model`` (say, fewer TUMs); ``dtype`` is the
    compute dtype."""

    def __init__(self, config: str, size: int, model=None, variables=None,
                 dtype=jnp.float32):
        self.config, self.size = config, size
        self.cfg = jax_load_config(config)
        if model is not None:
            self.cfg.config.model = model
        model = dict(self.cfg.model)
        self.bundle = jax_builder.build(
            base=model['base'], anchor_generator=model['anchor_generator'],
            input_size=(size, size), dtype=dtype, **dict(model['detector']))
        self.variables = variables or jax.jit(
            lambda key: self.bundle.module.init(
                key, jnp.zeros((1, size, size, 3)), train=False))(
                    jax.random.PRNGKey(0))

    def forward(self, variables, x, apply_fn=None):
        """Eval-mode ``(scores, locs, loc sources)`` of NHWC ``x``, through
        ``apply_fn`` (default: the module's ``apply``)."""
        apply_fn = apply_fn or self.bundle.module.apply
        return jax.jit(lambda v: apply_fn(
            v, jnp.asarray(x), return_sources=True))(variables)

    def train_step(self, apply_fn=None):
        """The JAX engine's train step (preprocessing only; flax's BN, or
        ``apply_fn``'s forward) and a train state of ``self.variables``
        with ``OPTIMIZER``."""
        cfg = self.cfg
        sampler_cfg = dict(cfg.sampler)
        sampler = jax_sampling.build_sampler(sampler_cfg.pop('name'),
                                             **sampler_cfg)
        criterion = jax_losses.MultiboxLoss(
            sampler=sampler, box_coder=jax_box_coder.BoxCoder(**cfg.box_coder),
            **cfg.loss)
        assigner = jax_matching.TargetAssigner(**cfg.target_assigner)
        schedule = jax_schedulers.create_lr_schedule(
            dict(SCHEDULER), OPTIMIZER['lr'], 1)[0]
        tx = jax_optimizers.create_optimizer(dict(OPTIMIZER),
                                             lr_schedule=schedule)
        pipeline = Pipeline((), cfg.preprocessing, (self.size, self.size),
                            train=True)
        step = make_train_step(self.bundle.module, criterion, assigner,
                               self.bundle.anchors(), tx, pipeline=pipeline,
                               donate=False, apply_fn=apply_fn)
        return step, jax_train_state(self.variables, tx)


def port_overrides(size: int, fused_bn: bool = True, model=None,
                   **train) -> dict:
    """``Trainer.from_config`` overrides: ``size`` px, no augmentation,
    ``OPTIMIZER``, and ``model`` in place of the config's."""
    out = {'input_size': (size, size), 'augmentations': [],
           'train': {'fused_bn': fused_bn, 'optimizer': OPTIMIZER,
                     'scheduler': SCHEDULER, **train}}
    if model is not None:
        out['model'] = model
    return out


def port_bundle(config: str, size: int, seed: int = 0, variables=None,
                model=None, dtype=torch.float32):
    """The port's detector of ``config`` at ``size`` px (``model`` in place
    of the config's) in compute ``dtype``: a JAX variable tree loaded with
    ``strict=True``, or its initializers drawn with ``seed``."""
    cfg = load_config(config)
    cfg.override({'input_size': (size, size)})
    if model is not None:
        cfg.override({'model': model})
    return pt_builder.from_config(cfg, variables=variables, seed=seed,
                                  dtype=dtype)


def perturb(variables, rng, score_gain: float = 1.0):
    """Non-trivial BN statistics and affine parameters in a JAX tree, and
    score-head kernels scaled by ``score_gain`` (so that random-init logits
    spread instead of sitting at the head's bias)."""
    def stats(path, v):
        if path[-1].key == 'mean':
            return rng.randn(*v.shape).astype(np.float32) * 0.1
        return rng.rand(*v.shape).astype(np.float32) + 0.5

    def params(path, v):
        v = np.asarray(v)
        names = [p.key for p in path]
        if names[-1] == 'scale':
            return (1 + rng.randn(*v.shape) * 0.1).astype(np.float32)
        if names[-1] == 'bias' and 'score_head' not in names[0]:
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        if names[-1] == 'kernel' and names[0].startswith('score_head'):
            return v * np.float32(score_gain)
        return v
    return {'params': jax.tree_util.tree_map_with_path(params, variables['params']),
            'batch_stats': jax.tree_util.tree_map_with_path(
                stats, variables['batch_stats'])}


def batch(size: int, n: int = 2, seed: int = 1):
    """``n`` synthetic images at ``size`` px with their boxes (classes
    1-20) as the JAX step and ``Trainer.train_step`` take them."""
    data = Synthetic(num_images=n, image_size=size, num_classes=21,
                     max_boxes=3, seed=seed)
    images = np.stack([a['image'] for a in data.annotations])
    boxes = np.zeros((n, 4, 6), np.float32)
    mask = np.zeros((n, 4), bool)
    for i, a in enumerate(data.annotations):
        boxes[i, :len(a['boxes'])] = a['boxes'][:4]
        mask[i, :len(a['boxes'])] = True
    return images, boxes, mask


def assert_init_follows_jax(port_model, jax_variables) -> int:
    """Each conv's std within ``max(3 %, 4 / sqrt(n))`` of JAX's own init
    of it (the standard error of the difference of two sample stds is
    about ``std / sqrt(n)``), and, for convs of 10,000 weights or more, the
    same family of tails: a truncated normal stops at 2 / 0.8796 = 2.27 of
    its std, a plain normal of that many weights reaches past 3.7 (the
    port's ``xavier_normal`` is a plain normal where flax's truncates, so
    its tails are not held).  Biases and BatchNorms as JAX sets them.
    Returns the number of convs."""
    want = from_jax_variables(jax_variables)
    convs = 0
    for name, module in port_model.named_modules():
        if not isinstance(module, torch.nn.Conv2d):
            continue
        convs += 1
        w, j = module.weight.detach(), want[f'{name}.weight']
        n, std, jstd = w.numel(), w.std().item(), j.std().item()
        assert abs(std - jstd) <= max(0.03, 4 / np.sqrt(n)) * jstd, (
            name, n, std, jstd)
        if n >= 10000 and module.kernel_init is not xavier_normal:
            tails = (w.abs().max().item() / std, j.abs().max().item() / jstd)
            assert (tails[0] <= 2.3) == (tails[1] <= 2.3), (name, n, tails)
    for name, value in port_model.state_dict().items():
        if not name.endswith('.weight') or value.ndim == 1:
            assert torch.equal(value, want[name]), name  # biases, BN
    return convs


def assert_step_matches(trainer: Trainer, before, state_j, before_j,
                        head_rel: float, step_rel: float,
                        ulp_floor: bool = False,
                        stats_rel: float = 1e-4) -> None:
    """Each head's update (after - before) within ``head_rel`` of its own
    largest update; every other parameter's within ``step_rel`` of the
    step's largest update.  The heads' gradients are one conv's backward
    from the loss; the rest pass through tens of train-mode BNs, whose
    backward subtracts nearly equal terms at random init, so two correct
    f32 steps differ there by percents of the step (the port's own two BN
    paths do).  BN running statistics (the forward's batch statistics)
    within ``stats_rel`` of max(1, each tensor's largest value).  ``ulp_floor``: no tolerance below one f32 step of the
    parameter's largest value, where both updates round (a head of a level
    where no anchor was sampled moves by weight decay alone, below that).
    """
    after_p = trainer.model.state_dict()
    after_j = from_jax_variables({'params': state_j.params,
                                  'batch_stats': state_j.batch_stats})
    updates = {name: (after_j[name] - value).numpy()
               for name, value in before_j.items()}
    largest = max(np.abs(u).max() for u in updates.values())
    for name, want in updates.items():
        got = (after_p[name] - before[name]).numpy()
        head = name.startswith(('score_head', 'loc_head'))
        atol = (head_rel * np.abs(want).max() if head else step_rel * largest)
        if ulp_floor:
            atol = max(atol, float(np.spacing(np.abs(after_j[name].numpy()).max())))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    for name in after_j:
        if name.endswith(('running_mean', 'running_var')):
            want = after_j[name].numpy()
            np.testing.assert_allclose(
                after_p[name].numpy(), want, rtol=0,
                atol=stats_rel * max(1.0, np.abs(want).max()), err_msg=name)
