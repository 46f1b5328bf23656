"""Port parity for the channel-space analysis (``train/deps.py``): the
port's spaces, read from a ``torch.export`` ATen graph, against the JAX
package's, read from a jaxpr (``jax.make_jaxpr`` only: no init, no jit;
the JAX side takes the port's seeded weights through ``to_jax_variables``).

A port space is translated to JAX's terms before the comparison: the same
variable paths, an OIHW kernel's producer or depthwise axis 0 as HWIO axis
3 and its consumer axis 1 as axis 2.  Equal means the same multiset of
spaces, each with the same width, frozen flag and member set (path, axis,
offset, role), exactly.
"""

import pytest
import torch

from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.train import deps as jax_deps
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.models.layers import ConvBn, conv2d
from single_shot_detection_tpu_torch.train import deps
from single_shot_detection_tpu_torch.utils.weights import (state_name,
                                                           to_jax_variables,
                                                           variable_path)

import test_deps as jax_twins
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SSD2 = {'type': 'ssd', 'num_scales': 2, 'min_scale': 0.2, 'max_scale': 0.9,
        'aspect_ratios': [[1.0, 2.0]] * 2}
SSD3 = {'type': 'ssd', 'num_scales': 3, 'min_scale': 0.2, 'max_scale': 0.9,
        'aspect_ratios': [[1.0, 2.0]] * 3}
# the builders' arguments of each model: tests/test_materialize.py's
# flagship_like, MobileNet v1 under the depthwise FPN, ShuffleNetV2 and a
# small M2Det (tests/test_deps.py's); test_torch_port_materialize.py holds
# the spaces of vgg_like, resnet_like and the ResNet FPN against JAX's
# where it prunes them
MODELS = {
    'flagship_like': dict(
        base={'name': 'mobilenet_v2', 'depth_multiplier': 0.35},
        anchor_generator=SSD3, num_classes=5, use_depthwise=True,
        features={'name': 'Features', 'out_layers': (13, 18)},
        extras={'layers': (('s', 64),)}, input_size=(96, 96)),
    'mbv1_dfpn': dict(
        base={'name': 'mobilenet_v1', 'depth_multiplier': 0.25},
        anchor_generator=SSD3, num_classes=5, use_depthwise=True,
        features={'name': 'DepthwiseFeaturePyramid', 'out_layers': (11, 13),
                  'pyramid_layers': 3, 'pyramid_channels': 32},
        extras=None, input_size=(64, 64)),
    'shufflenet': dict(
        base={'name': 'torchvision_shufflenet_v2_x0_5'}, anchor_generator=SSD2,
        num_classes=5, use_depthwise=False,
        features={'name': 'Features', 'out_layers': (2, 3)},
        extras=None, input_size=(64, 64)),
    'm2det': dict(
        base={'name': 'mobilenet_v2', 'depth_multiplier': 0.35},
        anchor_generator={'type': 'ssd', 'num_scales': 3, 'min_scale': 0.2,
                          'max_scale': 0.9, 'aspect_ratios': [[1.0]] * 3},
        num_classes=5,
        features={'name': 'MultilevelFeaturePyramid',
                  'out_layers': (13, 18), 'num_scales': 3, 'num_tums': 2,
                  'base_reduced_channels': [64, 32], 'reduced_channels': 32,
                  'tum': {'inner_channels': 32, 'out_channels': 16}},
        extras=None, input_size=(64, 64)),
}


def port_canon(spaces):
    return sorted((s.width, s.frozen, tuple(sorted(
        (m.path, deps.jax_axis(m), m.offset, m.role) for m in s.members)))
        for s in spaces)


def jax_canon(spaces):
    return sorted((s.width, s.frozen, tuple(sorted(
        (m.path, m.axis, m.offset, m.role) for m in s.members)))
        for s in spaces)


def both_spaces(model: torch.nn.Module, jax_module, nchw_shape):
    """The port's spaces of ``model`` and JAX's of ``jax_module`` on the
    port's weights."""
    b, c, h, w = nchw_shape
    got = deps.analyze_module(model, nchw_shape)
    want = jax_deps.analyze_module(
        jax_module, to_jax_variables(model.state_dict()), (b, h, w, c))
    return got, want


def writers_cover_every_conv(model, spaces) -> None:
    kernels = {variable_path(n, p.ndim)
               for n, p in model.named_parameters() if p.ndim == 4}
    writers = {m.path for s in spaces for m in s.members
               if m.role in ('producer', 'depthwise')}
    assert not (kernels - writers), kernels - writers


@pytest.mark.parametrize('name', sorted(MODELS))
def test_spaces_match_jax(name):
    """Every model's spaces equal JAX's; every conv writes a space (the
    stages past the last tap, which ``torch.export`` would drop as unused,
    included); ShuffleNetV2's shuffle-fed spaces frozen, not corrupted;
    M2Det's second TUM's segments never a zero-offset alias of the
    first's."""
    kw = MODELS[name]
    bundle = pt_builder.build(**kw)
    bundle.module.reset_parameters(torch.Generator().manual_seed(0))
    w, h = kw['input_size']
    got, want = both_spaces(bundle.module, jax_builder.build(**kw).module,
                            (1, 3, h, w))
    assert port_canon(got) == jax_canon(want)
    writers_cover_every_conv(bundle.module, got)
    assert any(not s.frozen for s in got)
    if name == 'shufflenet':
        shuffled = [s for s in got for m in s.by_role('producer')
                    if m.path[-2] in ('branch1_pw', 'branch2_pw2')]
        assert len(shuffled) >= 10 and all(s.frozen for s in shuffled)
    if name == 'm2det':
        tum1 = [s for s in got if any('tum1' in m.path and 'smooth' in
                                      '/'.join(m.path)
                                      for m in s.by_role('producer'))]
        assert tum1
        for s in tum1:
            assert s.frozen or any(m.offset > 0 for m in s.by_role('consumer'))


class ConcatNet(torch.nn.Module):
    """Torch twin of ``tests/test_deps.py::ConcatNet``."""

    def __init__(self):
        super().__init__()
        self.conv_a = conv2d(2, 4, 1, bias=True)
        self.conv_b = conv2d(2, 6, 1)
        self.conv_out = conv2d(10, 3, 1)

    def forward(self, x):
        return self.conv_out(torch.cat([self.conv_a(x), self.conv_b(x)], 1))


class ResidualNet(torch.nn.Module):
    """Torch twin of ``tests/test_deps.py::ResidualNet``."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv2d(3, 8, 1)
        self.conv2 = conv2d(3, 8, 1)
        self.head = conv2d(8, 2, 1)

    def forward(self, x):
        return self.head(self.conv1(x) + self.conv2(x))


class ReshapeEscape(torch.nn.Module):
    """Torch twin of ``tests/test_deps.py::ReshapeEscape``."""

    def __init__(self):
        super().__init__()
        self.conv = conv2d(3, 6, 1)

    def forward(self, x):
        h = self.conv(x)
        return h.reshape(h.shape[0], -1)  # splits the channel axis


def test_twins_of_the_jax_analyzer_tests():
    """The concat's per-segment consumer offsets and the discovered conv
    bias, the residual union and the output freeze, and the freeze of a
    view that splits the channel axis, each equal to JAX's spaces of the
    flax original."""
    generator = torch.Generator().manual_seed(1)
    traced = {}
    for twin, jax_module, shape in (
            (ConcatNet(), jax_twins.ConcatNet(), (1, 2, 8, 8)),
            (ResidualNet(), jax_twins.ResidualNet(), (1, 3, 4, 4)),
            (ReshapeEscape(), jax_twins.ReshapeEscape(), (1, 3, 4, 4))):
        for m in twin.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.kernel_init(m.weight, generator)
        got, want = both_spaces(twin, jax_module, shape)
        assert port_canon(got) == jax_canon(want), type(twin).__name__
        traced[type(twin).__name__] = got

    # each twin's spaces depend on its architecture only: traced once
    (sb,) = [s for s in traced['ConcatNet'] if any(
        m.path[-2] == 'conv_b' for m in s.by_role('producer'))]
    (cons,) = sb.by_role('consumer')
    assert (cons.path[-2], cons.axis, cons.offset) == ('conv_out', 1, 4)
    (joined,) = [s for s in traced['ResidualNet']
                 if len(s.by_role('producer')) == 2]
    assert joined.width == 8 and not joined.frozen
    (escaped,) = traced['ReshapeEscape']
    assert escaped.frozen


def test_names_translate_both_ways():
    """Every ``state_dict`` entry with a JAX counterpart maps to the JAX
    package's variable path and back (``num_batches_tracked`` has none);
    ``jax_axis`` turns OIHW axes into HWIO ones and leaves vectors alone;
    the analysis traces a plain eval-mode copy (no quantization mode, no
    GroupNorm) and leaves the model's modes and weights as they were."""
    bundle = pt_builder.build(**MODELS['flagship_like'])
    model = bundle.module
    jax_paths = set()
    for name, value in model.state_dict().items():
        path = variable_path(name, value.ndim)
        if name.endswith('num_batches_tracked'):
            assert path is None
            continue
        assert state_name(path) == name
        jax_paths.add(path)
    flat = to_jax_variables(model.state_dict())
    want = set()
    for coll, tree in flat.items():
        stack = [((coll,), tree)]
        while stack:
            prefix, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((prefix + (k,), v))
                else:
                    want.add(prefix + (k,))
    assert jax_paths == want
    kernel = deps.Member(('params', 'conv', 'kernel'), 0, 0, 'producer')
    assert deps.jax_axis(kernel) == 3
    assert deps.jax_axis(kernel.__class__(kernel.path, 1, 0, 'consumer')) == 2
    assert deps.jax_axis(deps.Member(('params', 'bn', 'scale'), 0, 0,
                                     'vector')) == 0

    block = ConvBn(3, 4, kernel_size=3, padding=1)
    block.bn.group_norm = 2
    block.conv.quant = lambda conv, x: conv.float_forward(x) * 0
    before = {k: v.clone() for k, v in block.state_dict().items()}
    block.train()
    (space,) = deps.analyze_module(block, (1, 3, 8, 8))
    assert space.frozen and {m.path[-1] for m in space.members} == {
        'kernel', 'scale', 'bias', 'mean', 'var'}
    assert block.training and block.bn.group_norm == 2
    assert block.conv.quant is not None
    for k, v in block.state_dict().items():
        assert torch.equal(v, before[k]), k
