"""Port parity at bf16 (docs/DESIGN.md §10): the detector's eval forward with
bfloat16 activations against the JAX package's bundle built with
``dtype=jnp.bfloat16``, and the fused train-mode BatchNorm on bf16
activations against ``bn_pallas.fused_bn_train`` (interpret mode).

Forwards: a MobileNetV2 SSD (``samples/synthetic_smoke.py``, 128 px),
M2Det-512-VGG16 at full width with 2 TUMs at 128 px (the eval forward
has no batch statistics, so a 1x1 deepest level is sound; the trap there
is JAX's SFAM, whose convs take no ``dtype`` and promote the bf16 maps to
f32) and the smoke SSD with ``heads.dtype: 'float32'``.  Weights are the
port's seeded initialization with perturbed BNs, in both packages.
Tolerance: each output (scores, locs and every map the loc heads read)
of the port at bf16 lies within twice the distance from JAX's bf16
output to JAX's own f32 output (max abs over the output; measured 0.97-
1.73 times: both round each conv and BN to bf16, JAX after the conv and
again after its bias, PyTorch once); the dtypes of those outputs equal
JAX's.

``fused_bn_train``: the forward's ``z`` (bf16) and the VJP's ``dx``
(bf16) within one bf16 step (2**-8) of max(1, |largest value|), both
packages computing in f32 and rounding once; the statistics and the
parameter gradients (f32 sums of up to 3200 terms in another order) rtol
1e-5, atol 1e-5 of max(1, |largest value|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_slice import JaxSide, nchw, perturb, port_bundle, to_jax_variables
from single_shot_detection_tpu.ops import bn_pallas
from single_shot_detection_tpu_torch.ops.bn_fused import fused_bn_train
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
M2DET = 'samples/m2det_512_vgg16_voc.py'
SIZE = 128
BF16_STEP = 2.0 ** -8


def m2det_model():
    from single_shot_detection_tpu_torch.utils.config import load_config
    model = dict(load_config(M2DET).model)
    detector = dict(model['detector'])
    detector['features'] = {**dict(detector['features']), 'num_tums': 2}
    return {**model, 'detector': detector}


def smoke_model(heads=None):
    from single_shot_detection_tpu_torch.utils.config import load_config
    model = dict(load_config(SMOKE).model)
    if heads is not None:
        model['detector'] = {**dict(model['detector']), 'heads': heads}
    return model


CASES = {
    'mobilenet_v2 ssd': (SMOKE, smoke_model, 5),
    'm2det sfam': (M2DET, m2det_model, 21),
    'f32 heads': (SMOKE, lambda: smoke_model({'dtype': 'float32'}), 5),
}


def images(n: int = 2, seed: int = 3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, SIZE, SIZE, 3) * 0.8).astype(np.float32)


@pytest.mark.parametrize('case', list(CASES))
def test_bf16_forward_matches_jax(case):
    config, make_model, score_gain = CASES[case]
    model = make_model()
    seeded = port_bundle(config, SIZE, seed=0, model=model).module
    variables = perturb(to_jax_variables(seeded.state_dict()),
                        np.random.RandomState(1), score_gain=score_gain)
    x = images()

    jax_out = {}
    for name, dtype in (('f32', jnp.float32), ('bf16', jnp.bfloat16)):
        side = JaxSide(config, SIZE, model=model, variables=variables,
                       dtype=dtype)
        scores, locs, sources = side.forward(variables, x)
        jax_out[name] = [scores, locs, *sources]

    port = port_bundle(config, SIZE, variables=variables, model=model,
                       dtype=torch.bfloat16).module.eval()
    with torch.no_grad():
        scores, locs, sources = port(nchw(x), return_sources=True)
    got = [scores, locs] + [s.permute(0, 2, 3, 1) for s in sources]

    names = ['scores', 'locs'] + [f'source{i}' for i in range(len(sources))]
    assert len(got) == len(jax_out['bf16'])
    for name, g, want, ref in zip(names, got, jax_out['bf16'], jax_out['f32']):
        want_dtype = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                      jnp.dtype(jnp.float32): torch.float32}[want.dtype]
        assert g.dtype == want_dtype, (name, g.dtype, want.dtype)
        want = np.asarray(want, np.float32)
        bf16_vs_f32 = np.abs(want - np.asarray(ref, np.float32)).max()
        err = np.abs(g.float().numpy() - want).max()
        assert err <= 2 * bf16_vs_f32, (name, err, bf16_vs_f32)
    if case == 'm2det sfam':
        # JAX's SFAM maps are f32 under bf16, and the heads cast back
        assert [s.dtype for s in sources] == [torch.float32] * 6
        assert scores.dtype == locs.dtype == torch.bfloat16
    elif case == 'f32 heads':
        assert scores.dtype == locs.dtype == torch.float32
        assert all(s.dtype == torch.bfloat16 for s in sources)


@pytest.mark.parametrize('shape', [(4, 16, 10, 10), (2, 24, 4, 8),
                                   (16, 32, 1, 1)])
def test_fused_bn_train_bf16_matches_jax(shape):
    rng = np.random.RandomState(0)
    c = shape[1]
    x = (rng.randn(*shape) * 2 + 0.3).astype(np.float32)
    dz = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    x16 = torch.from_numpy(x).bfloat16()
    dz16 = torch.from_numpy(dz).bfloat16()

    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16)
    dz_nhwc = jnp.asarray(dz.transpose(0, 2, 3, 1), jnp.bfloat16)
    bn_pallas._INTERPRET[0] = True
    try:
        (z_j, mean_j, var_j), vjp = jax.vjp(
            lambda x_, s_, b_: bn_pallas.fused_bn_train(x_, s_, b_, 1e-5),
            x_nhwc, jnp.asarray(scale), jnp.asarray(bias))
        dx_j, dscale_j, dbias_j = vjp((dz_nhwc, jnp.zeros_like(mean_j),
                                       jnp.zeros_like(var_j)))
    finally:
        bn_pallas._INTERPRET[0] = False
    assert z_j.dtype == dx_j.dtype == jnp.bfloat16

    xt = x16.clone().requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    z, mean, var = fused_bn_train(xt, st, bt, 1e-5)
    z.backward(dz16)
    assert z.dtype == xt.grad.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32

    def close(got, want, step):
        want = np.asarray(want, np.float32)
        tol = step * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=0 if step == BF16_STEP else 1e-5,
                                   atol=tol)

    close(z.permute(0, 2, 3, 1), z_j, BF16_STEP)
    close(xt.grad.permute(0, 2, 3, 1), dx_j, BF16_STEP)
    for got, want in ((mean, mean_j), (var, var_j), (st.grad, dscale_j),
                      (bt.grad, dbias_j)):
        close(got, want, 1e-5)
