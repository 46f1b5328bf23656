"""Port parity: train-mode BatchNorm (``ops/bn_kernel.py``, ``ops/bn_fused.py``
and ``models/layers.py::BatchNorm``) against the JAX package's Pallas BN
(``ops/bn_pallas.py``, kernels in interpret mode as ``tests/test_bn_pallas.py``
runs them) and flax ``nn.BatchNorm``.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those plain versions on the card by ``chip_smoke.py``.
Inputs are NHWC numpy arrays made from a seed, transposed to NCHW for the
port.

Tolerances: forward z atol 1e-5, mean atol 1e-6, var atol 1e-5 (f32 sums
of a few thousand values, taken in another order); backward dx, d_gamma and
d_beta atol 1e-4 * max(|reference|, 1) (a three-term difference of sums);
bf16 z atol 2e-2 (bf16 rounding of z), statistics in f32 atol 1e-3
(the input itself is bf16); module outputs and running statistics against
flax atol 1e-5 (flax multiplies by ``scale * rsqrt`` first, the Pallas and
port order is ``rsqrt`` then ``scale``: a 1-ulp difference).
"""

import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from single_shot_detection_tpu.ops import bn_pallas
from single_shot_detection_tpu_torch.models.layers import BatchNorm, set_fused_bn
from single_shot_detection_tpu_torch.ops import bn_kernel
from single_shot_detection_tpu_torch.ops.bn_fused import fused_bn_train


@pytest.fixture(autouse=True)
def interpret_mode():
    bn_pallas._INTERPRET[0] = True
    yield
    bn_pallas._INTERPRET[0] = False


@pytest.fixture(autouse=True)
def zero_launch_counts():
    for fn in bn_kernel.KERNELS:
        fn.launches = 0


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def inputs(seed, shape, dtype=np.float32):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.3).astype(dtype)
    g = (rng.rand(c) + 0.5).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, g, b


# ------------------------------------------------- each kernel's plain version

# NHWC shapes: planes (H*W) of 256 and 192, then odd planes and planes
# shorter than a 16-byte vector of f32 (4) or bf16 (8): 25, 9, 1 and 4.  The
# Pallas kernels take [B*H*W, C] in blocks of 16 rows (``_pick_rows``), so
# B*H*W is a multiple of 16.
@pytest.mark.parametrize('shape', [(4, 16, 16, 64), (2, 8, 24, 32),
                                   (16, 5, 5, 24), (16, 3, 3, 8),
                                   (16, 1, 1, 16), (4, 2, 2, 12)])
def test_plain_kernels_match_pallas_kernels(shape):
    """K1-K4 plain versions against the Pallas kernels one by one."""
    x, g, b = inputs(0, shape)
    dz = np.random.RandomState(1).randn(*shape).astype(np.float32)
    c = shape[-1]
    x2d, dz2d = jnp.asarray(x.reshape(-1, c)), jnp.asarray(dz.reshape(-1, c))
    eps = 1e-5

    mean_j, var_j = bn_pallas._bn_stats(x2d)
    rstd_j = jax.lax.rsqrt(var_j + eps)
    mean, var, rstd = bn_kernel.bn_stats(nchw(x), eps)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_j), rtol=1e-5)

    # the same statistics into both sides from here on
    mean, rstd = torch.from_numpy(np.array(mean_j)), torch.from_numpy(np.array(rstd_j))
    z_j = bn_pallas._bn_apply(x2d, mean_j, rstd_j, jnp.asarray(g), jnp.asarray(b),
                              jnp.float32)
    z = bn_kernel.bn_apply(nchw(x), mean, rstd, torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(z), np.asarray(z_j).reshape(shape), rtol=0, atol=1e-5)

    sums_j = bn_pallas._bn_grad_sums(dz2d, x2d, mean_j, rstd_j)
    d_gamma, d_beta, coef = bn_kernel.bn_grad_sums(nchw(dz), nchw(x), mean, rstd,
                                                   torch.from_numpy(g))
    n = x2d.shape[0]
    coef_j = jnp.stack([rstd_j * jnp.asarray(g), sums_j[0] / n, sums_j[1] / n])
    for name, got, want in (('d_beta', d_beta, sums_j[0]),
                            ('d_gamma', d_gamma, sums_j[1]),
                            ('coef', coef, coef_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1.0),
                                   err_msg=name)

    dx_j = bn_pallas._bn_dx(dz2d, x2d, mean_j, rstd_j, coef_j, jnp.float32)
    dx = bn_kernel.bn_dx(nchw(dz), nchw(x), mean, rstd, torch.from_numpy(np.array(coef_j)))
    want = np.asarray(dx_j).reshape(shape)
    np.testing.assert_allclose(nhwc(dx), want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize('out_dtype', ['bfloat16', 'float32'])
def test_plain_apply_matches_pallas_on_bf16_input(out_dtype):
    """K2's plain version on bf16 x (planes of 25) against the Pallas
    ``_bn_apply`` with the same f32 statistics, into a bf16 z (within one
    bf16 step, 2**-8 of the largest value: the two round from f32 values
    computed in the same order, so they should agree) or an f32 z (1e-5)."""
    shape = (16, 5, 5, 24)
    x, g, b = inputs(6, shape)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    c = shape[-1]
    x2d = jnp.asarray(x.reshape(-1, c), jnp.bfloat16)
    mean_j, var_j = bn_pallas._bn_stats(x2d)
    rstd_j = jax.lax.rsqrt(var_j + 1e-5)
    z_j = bn_pallas._bn_apply(x2d, mean_j, rstd_j, jnp.asarray(g),
                              jnp.asarray(b), getattr(jnp, out_dtype))
    z = bn_kernel.bn_apply(nchw(x).to(torch.bfloat16),
                           torch.from_numpy(np.array(mean_j)),
                           torch.from_numpy(np.array(rstd_j)),
                           torch.from_numpy(g), torch.from_numpy(b),
                           getattr(torch, out_dtype))
    assert z.dtype == getattr(torch, out_dtype)
    want = np.asarray(z_j.astype(jnp.float32)).reshape(shape)
    atol = (2.0 ** -8 * np.abs(want).max() if out_dtype == 'bfloat16'
            else 1e-5)
    np.testing.assert_allclose(nhwc(z.float()), want, rtol=0, atol=atol)


# -------------------------------------------------------- fused_bn_train

def test_forward_matches_pallas():
    x, g, b = inputs(0, (4, 16, 16, 64))
    z_j, m_j, v_j = bn_pallas.fused_bn_train(jnp.asarray(x), jnp.asarray(g),
                                             jnp.asarray(b))
    z, m, v = fused_bn_train(nchw(x), torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(z), np.asarray(z_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0, atol=1e-5)


def test_backward_matches_pallas():
    x, g, b = inputs(1, (2, 8, 24, 32))

    def loss_j(args):
        return jnp.sum(jnp.sin(bn_pallas.fused_bn_train(*args)[0]))

    want = jax.grad(loss_j)((jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    xt = nchw(x).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    torch.sin(fused_bn_train(xt, gt, bt)[0]).sum().backward()
    for name, got, ref in (('dx', nhwc(xt.grad), want[0]),
                           ('dgamma', gt.grad.numpy(), want[1]),
                           ('dbeta', bt.grad.numpy(), want[2])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)


def test_bf16_input_gives_f32_statistics():
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, 16, 16, 16), jnp.bfloat16)
    g, b = jnp.ones((16,), jnp.float32), jnp.zeros((16,), jnp.float32)
    z_j, m_j, v_j = bn_pallas.fused_bn_train(x, g, b)
    xt = nchw(np.asarray(x, np.float32)).to(torch.bfloat16)
    z, m, v = fused_bn_train(xt, torch.ones(16), torch.zeros(16))
    assert z.dtype == torch.bfloat16
    assert m.dtype == torch.float32 and v.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=0, atol=1e-3)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0, atol=1e-3)
    np.testing.assert_allclose(nhwc(z.float()), np.asarray(z_j, np.float32),
                               rtol=0, atol=2e-2)


def test_cpu_tensors_launch_no_kernel():
    x, g, b = inputs(3, (2, 4, 4, 8))
    xt = nchw(x).requires_grad_()
    z, _, _ = fused_bn_train(xt, torch.from_numpy(g), torch.from_numpy(b))
    z.sum().backward()
    assert [fn.launches for fn in bn_kernel.KERNELS] == [0, 0, 0, 0]


def test_kernel_wrappers_refuse_other_devices():
    x = torch.empty(2, 4, 3, 3, device='meta')
    with pytest.raises(ValueError, match='no BatchNorm kernel'):
        bn_kernel.bn_stats(x, 1e-5)


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize('fused', [True, False])
def test_layer_matches_flax_batch_norm(fused):
    """Train-mode output, gradients and flax's running-statistic update
    (momentum 0.9, biased batch variance)."""
    rng = np.random.RandomState(4)
    x, g, b = inputs(5, (3, 9, 7, 24))
    ra_mean = (rng.randn(24) * 0.1).astype(np.float32)
    ra_var = (rng.rand(24) + 0.5).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {'params': {'scale': g, 'bias': b},
                 'batch_stats': {'mean': ra_mean, 'var': ra_var}}

    def forward(params, xj):
        y, mutated = flax_bn.apply({'params': params,
                                    'batch_stats': variables['batch_stats']},
                                   xj, mutable=['batch_stats'])
        return jnp.sum(jnp.sin(y)), (y, mutated['batch_stats'])

    (_, (y_j, stats_j)), grads_j = jax.value_and_grad(
        forward, argnums=(0, 1), has_aux=True)(variables['params'], jnp.asarray(x))

    layer = BatchNorm(24)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(g))
        layer.bias.copy_(torch.from_numpy(b))
        layer.running_mean.copy_(torch.from_numpy(ra_mean))
        layer.running_var.copy_(torch.from_numpy(ra_var))
    assert set_fused_bn(layer, fused) == 1
    layer.train()
    xt = nchw(x).requires_grad_()
    y = layer(xt)
    torch.sin(y).sum().backward()

    np.testing.assert_allclose(nhwc(y), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               np.asarray(stats_j['mean']), rtol=0, atol=1e-5)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               np.asarray(stats_j['var']), rtol=0, atol=1e-5)
    for name, got, ref in (('dx', nhwc(xt.grad), grads_j[1]),
                           ('dscale', layer.weight.grad.numpy(), grads_j[0]['scale']),
                           ('dbias', layer.bias.grad.numpy(), grads_j[0]['bias'])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)


def test_layer_eval_mode_uses_running_statistics():
    layer = BatchNorm(8).eval()
    with torch.no_grad():
        layer.running_mean.fill_(0.5)
        layer.running_var.fill_(4.0)
    x = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(layer(x).detach().numpy(),
                               ((x - 0.5) / np.sqrt(4.0 + 1e-5)).numpy(),
                               rtol=0, atol=1e-6)
    assert float(layer.running_mean[0]) == 0.5


# ------------------------------------------- the CUDA source and its callers

REPO = Path(__file__).resolve().parents[1]
BN_CU = REPO / 'single_shot_detection_tpu_torch' / 'kernels' / 'bn.cu'


def _assigned(path: Path, name: str):
    """The value of the module-level assignment ``name = <literal>``."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, 'id', None) == name for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError(f'no {name} in {path}')


def test_every_bn_kernel_is_counted_under_its_wrapper():
    """Each ``__global__`` kernel of bn.cu is one of its wrapper's kernels in
    chip_smoke.py's ``BN_KERNELS`` (the profiled steps sum device time by
    those names), or the launch floor of ``FLOOR_KERNELS``; no name matches
    another wrapper's kernel by substring."""
    kernels = set(re.findall(
        r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(',
        BN_CU.read_text()))
    by_wrapper = {name: names for name, (names, _, _)
                  in _assigned(REPO / 'chip_smoke.py', 'BN_KERNELS').items()}
    floors = {n.split('<')[0] for names in _assigned(
        REPO / 'chip_smoke.py', 'FLOOR_KERNELS').values() for n in names}
    listed = [n for names in by_wrapper.values() for n in names]
    assert len(listed) == len(set(listed))
    assert kernels == set(listed) | floors
    assert set(by_wrapper) == {fn.__name__ for fn in bn_kernel.KERNELS}
    for wrapper, names in by_wrapper.items():
        for name in names:
            for kernel in kernels - set(names):
                assert name not in kernel, (wrapper, name, kernel)


def test_bn_launchers_match_their_argtypes():
    """Each ``extern "C"`` function of bn.cu takes as many parameters as
    ``ops/bn_kernel.py::_library`` declares in its ``argtypes``."""
    declared = {}
    for node in ast.walk(ast.parse(Path(bn_kernel.__file__).read_text())):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr == 'argtypes'):
            declared[node.targets[0].value.attr] = len(node.value.elts)
    source = BN_CU.read_text()
    defined = {name: len([p for p in params.split(',') if p.strip()])
               for name, params in re.findall(
                   r'extern "C" [\w\s\*]*?\b(\w+)\(([^)]*)\)\s*\{', source)}
    assert defined and defined == declared
