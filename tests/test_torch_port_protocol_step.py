"""One train step of the accuracy protocol from a trained state: the
port's against the JAX package's, beside each package's sensitivity to
itself.

The protocol is ``tools/parity_run.py``'s (SSD-MobileNetV2-0.35 with
``Features(out_layers=(13, 18))``, 128 px, b8, SGD 2e-3 with momentum), the
config written by the port's ``tools/parity_run.py``, run without
augmentation on 8 synthetic images of its kind (``Synthetic`` at seed 23;
its train split is seed 1).  The state,
``tests/data/protocol_state.npz``, is the port's own run of the protocol
for seed 23 after 10 of its 60 epochs on the CPU (``tests/_torch_protocol.py
state``; the command is in CHANGES.md).  The JAX step is
``make_train_step`` with flax's ``nn.BatchNorm`` (the protocol's JAX run
has no ``train.fused_bn``), the port's ``Trainer.train_step`` with its
default BN path, ``torch.native_batch_norm``.

``_torch_protocol.step_readings`` compares each parameter tensor's update
as a share of its own largest update (or of 1 % of the step's largest,
where that is larger).  A package's sensitivity to itself is the same
share between its step at the state and its step with every weight
multiplied by ``1 + r N(0, 1)``.  The test takes ``r = 1e-6``, three draws a
package: the size at which a perturbation moves the loss about as far as
the two packages' losses lie apart (3-5 ulps of it; ``1e-7`` moves it by
one ulp, and ``python tests/_torch_protocol.py sensitivity --r 1e-7
--seeds 1-3`` prints that reading).  It asserts the loss within rtol 1e-5
and the port's largest share against JAX within the largest share of any
draw of either package against itself: the sensitivity belongs to the
network at this state, and both packages' draws sample it.  On this
state port against JAX is 2.85e-2, at stage 11's ``expand_bn.bias``,
where one ReLU6 input of channel 125, about 1e-6 from 0, lies on the other
side of 0 in the two packages; JAX's third draw and the port's second
move that bias by the same share.

The second test looks at the state for the two causes named for the
protocol's low tail: no BN input channel is degenerate (mean over 100
standard deviations, or variance under ``eps / 100``), the port's BN
backward at stage 11's ``expand_bn`` equals flax's on the same input and
cotangent within 1e-5 of the largest ``dx``, and no BN output lies exactly
at a ReLU6 bound (0 or 6), so neither the fast variance's clip nor the tie
rule moves this step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from single_shot_detection_tpu_torch.models.layers import BatchNorm
from single_shot_detection_tpu_torch.trainer import Trainer
from _torch_port_fixtures import one_torch_thread  # noqa: F401
from _torch_protocol import print_readings, protocol_inputs, step_readings

NO_AUGMENTATION = {'augmentations': []}
FIRST_DIVERGING = 'features.base.stage11.expand_bn'


@pytest.fixture(scope='module')
def protocol(tmp_path_factory):
    """The protocol's config, the state's JAX variables and 8 images."""
    return protocol_inputs(str(tmp_path_factory.mktemp('protocol')))


def test_protocol_step_within_each_packages_own_sensitivity(tmp_path):
    readings = step_readings(str(tmp_path), 1e-6, seeds=(1, 2, 3))
    print_readings(readings)
    loss, worst = readings['loss'], readings['worst']
    np.testing.assert_allclose(loss['port'], loss['jax'], rtol=1e-5)
    own = max(v for col, v in worst.items() if col != 'port-jax')
    assert worst['port-jax'] <= own, worst


def test_protocol_state_has_no_degenerate_bn_or_relu6_tie(protocol):
    config, variables, (images, boxes, mask) = protocol
    trainer = Trainer.from_config(config, variables=variables, device='cpu',
                                  overrides=NO_AUGMENTATION)
    seen, grads = {}, {}

    def keep(name):
        def hook(module, args, out):
            seen[name] = (args[0].detach(), out.detach())
            if name == FIRST_DIVERGING:
                out.register_hook(lambda g: grads.__setitem__(name, g))
        return hook

    bns = {n: m for n, m in trainer.model.named_modules()
           if isinstance(m, BatchNorm)}
    for name, module in bns.items():
        module.register_forward_hook(keep(name))
    trainer.train_step(images, boxes, mask)
    assert len(seen) == len(bns) == 55

    eps = bns[FIRST_DIVERGING].eps
    counts = {'at 0': 0, 'at 6': 0, 'mean over 100 sd': 0,
              'var under eps/100': 0}
    for x, z in seen.values():
        x64 = x.double()
        mean = x64.mean((0, 2, 3))
        var = x64.var((0, 2, 3), unbiased=False)
        counts['at 0'] += int((z == 0).sum())
        counts['at 6'] += int((z == 6).sum())
        counts['mean over 100 sd'] += int((mean.abs() > 100 * var.sqrt()).sum())
        counts['var under eps/100'] += int((var < eps / 100).sum())
    print('\nBN inputs and outputs of the step', counts)
    assert counts == dict.fromkeys(counts, 0), counts

    # the port's BN backward at the first diverging layer against flax's
    x, _ = seen[FIRST_DIVERGING]
    dz = grads[FIRST_DIVERGING]
    bn = bns[FIRST_DIVERGING]
    xt = x.clone().requires_grad_()
    weight = bn.weight.detach().clone().requires_grad_()
    bias = bn.bias.detach().clone().requires_grad_()
    z, _, _ = torch.native_batch_norm(xt, weight, bias, None, None, True, 0.0,
                                      eps)
    z.backward(dz)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=eps)
    c = x.shape[1]

    def flax_apply(x_nhwc, scale, b):
        return flax_bn.apply(
            {'params': {'scale': scale, 'bias': b},
             'batch_stats': {'mean': jnp.zeros(c), 'var': jnp.ones(c)}},
            x_nhwc, mutable=['batch_stats'])[0]

    x_nhwc = x.permute(0, 2, 3, 1).numpy()
    z_flax, vjp = jax.vjp(flax_apply, x_nhwc, weight.detach().numpy(),
                          bias.detach().numpy())
    dx_flax, dscale, dbias = vjp(dz.permute(0, 2, 3, 1).numpy())
    dx_flax = np.asarray(dx_flax).transpose(0, 3, 1, 2)
    scale = np.abs(dx_flax).max()
    print(f'{FIRST_DIVERGING}: |dx port - flax| '
          f'{np.abs(xt.grad.numpy() - dx_flax).max() / scale:.2e} of the '
          f'largest dx; |z port - flax| '
          f'{np.abs(z.detach().permute(0, 2, 3, 1).numpy() - z_flax).max():.2e}')
    np.testing.assert_allclose(xt.grad.numpy(), dx_flax, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(weight.grad.numpy(), dscale, rtol=1e-5,
                               atol=1e-5 * np.abs(dscale).max())
    np.testing.assert_allclose(bias.grad.numpy(), dbias, rtol=1e-5,
                               atol=1e-6 * np.abs(dbias).max())
