"""Post-training int8 quantization and quantization-aware training.

Port of ``single_shot_detection_tpu/export/quantize.py``.  Convolution
weights quantize to int8 per output channel and activations to int8 per
tensor (scales calibrated on sample batches, or learned by QAT), and each
eligible conv runs as an s8 x s8 -> s32 product on ``torch._int_mm``; the
dequantization, bias and everything after the conv stay in the conv's float
compute dtype.

No model rewrite, no quantized module zoo: every conv of the port is a
``models/layers.py::Conv2d``, whose ``quant`` mode stands in for the JAX
package's flax interceptor, so one model object serves f32, bf16, int8 and
QAT.  A conv's key is its flax path (``'/'.join`` of the flax names, which
the port's module names carry), so amax dicts and QAT checkpoints cross
between the packages.  Symmetric quantization keeps the zero point at 0, so
zero padding stays exact in the quantized domain: the port pads the int8
input.

Depthwise and grouped convolutions stay in the float path, as in the JAX
package.

Usage::

    amax = calibrate(model, [batch1, batch2, ...])
    predict = make_quantized_predict_step(model, postprocessor, anchors, amax)
    detections, valid = predict(images)
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.models.layers import Conv2d, spatial_size

QMAX = 127.0

# The JAX package's serving gate, kept as it decides (its constants are the
# JAX package's preset, measured there, not on this port's device):
#   * depthwise-dominated backbones (MobileNet/ShuffleNet) below batch 128
#     are refused;
#   * inputs of 512 px or more get spatial_limit=256 unless the config pins
#     one, keeping the stem float.
DEPTHWISE_BACKBONE_PREFIXES = ('mobilenet', 'shufflenet')
DEPTHWISE_MIN_BATCH = 128
SPATIAL_LIMIT_INPUT = 512
SPATIAL_LIMIT_DEFAULT = 256
# backbones the JAX package's preset serves int8 without being asked
INT8_WIN_BACKBONES = ('vgg',)
QAT_DECAY = 0.99

# cuBLASLt's int8 product (``torch._int_mm`` on CUDA) needs more than 16
# rows and the reduction and output widths in multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def _backbone(cfg) -> str:
    model_cfg = dict(getattr(cfg, 'model', None) or {})
    return str(dict(model_cfg.get('base', {})).get('name', '')).lower()


def resolve_int8_opts(cfg, log=None, batch_size=None):
    """The serving gate on a config's ``int8`` options: ``(enabled,
    opts)``.

    ``enabled`` is False for a MobileNet or ShuffleNet backbone below batch
    128 unless the config opts in with an explicit ``int8 = {...}`` block or
    ``train.qat``; ``opts`` gets ``spatial_limit=256`` for inputs of 512 px
    or more unless the config pins one.  The decisions are the JAX
    package's preset.
    """
    log = log or logging
    # the wrapper defaults a missing attribute to {}: read the raw module to
    # tell an explicit ``int8 = {}`` from an absent key
    raw_cfg = getattr(cfg, 'config', cfg)
    int8_cfg = getattr(raw_cfg, 'int8', None)
    explicit = isinstance(int8_cfg, dict)
    if dict(getattr(cfg, 'train', None) or {}).get('qat'):
        explicit = True  # a QAT run trained for the int8 path
    opts = dict(int8_cfg or {})
    backbone = _backbone(cfg)
    batch = int(batch_size if batch_size is not None
                else getattr(cfg, 'batch_size', None) or 32)
    input_size = max(tuple(getattr(cfg, 'input_size', None) or (300, 300)))

    if (not explicit and batch < DEPTHWISE_MIN_BATCH
            and any(p in backbone for p in DEPTHWISE_BACKBONE_PREFIXES)):
        log.warning(
            f'WW --int8 disabled: {backbone!r} at batch {batch} is refused by '
            f'the JAX package\'s int8 preset (depthwise-dominated backbones '
            f'below batch {DEPTHWISE_MIN_BATCH}). Set an explicit '
            '``int8 = {}`` block in the config to force it.')
        return False, opts

    if input_size >= SPATIAL_LIMIT_INPUT and 'spatial_limit' not in opts:
        opts['spatial_limit'] = SPATIAL_LIMIT_DEFAULT
        log.info(
            f'II int8 preset: spatial_limit={SPATIAL_LIMIT_DEFAULT} for the '
            f'{input_size}-input config (the JAX package\'s preset keeps the '
            'stem float)')
    return True, opts


def preset_int8(cfg, batch_size=None, log=None):
    """Whether to serve this config int8 with no flag: the gate of
    :func:`resolve_int8_opts`, then only the VGG family.  Returns
    ``(use_int8, opts)``."""
    enabled, opts = resolve_int8_opts(cfg, log=log, batch_size=batch_size)
    if not enabled:
        return False, opts
    return any(p in _backbone(cfg) for p in INT8_WIN_BACKBONES), opts


def check_composes(train_cfg: Mapping, int8: bool = False) -> None:
    """Raise ``ValueError`` where the JAX engine does: ``train.qat`` or int8
    with ``train.group_norm``, and ``train.qat`` with ``train.fused_bn``
    (each replaces the same forward)."""
    qat = bool(train_cfg.get('qat'))
    if (qat or int8) and train_cfg.get('group_norm'):
        raise ValueError('train.group_norm does not compose with qat/int8 '
                         '(both override the same forward); pick one')
    if qat and train_cfg.get('fused_bn'):
        raise ValueError('train.fused_bn does not compose with qat/group_norm '
                         '(same forward override)')


# ---------------------------------------------------------------- the convs

def conv_key(name: str) -> str:
    """A module name of the port as its conv's flax path."""
    return name.replace('.', '/')


def _supported(conv: nn.Module) -> bool:
    """Only plain dense convs are quantized; depthwise and grouped convs
    (and dilated ones, which the zoo does not use) stay float."""
    return (isinstance(conv, Conv2d) and conv.groups == 1
            and tuple(conv.dilation) == (1, 1))


def supported_convs(model: nn.Module) -> Iterator[Tuple[str, Conv2d]]:
    """``(key, conv)`` of every conv that quantizes, in module order."""
    for name, module in model.named_modules():
        if _supported(module):
            yield conv_key(name), module


def _over_limit(x: torch.Tensor, spatial_limit: Optional[int]) -> bool:
    """True when ``x``'s (unpadded) spatial extent exceeds the limit: that
    conv stays float (the global extent of a height-sharded map)."""
    return spatial_limit is not None and max(spatial_size(x)) > spatial_limit


@contextlib.contextmanager
def quant_modes(model: nn.Module, modes: Mapping[str, Callable]):
    """Switch the convs named in ``modes`` (by key) to their mode for the
    block; every conv's mode is put back afterwards."""
    convs = dict(supported_convs(model))
    before = {key: conv.quant for key, conv in convs.items()}
    try:
        for key, mode in modes.items():
            convs[key].quant = mode
        yield
    finally:
        for key, conv in convs.items():
            conv.quant = before[key]


def calibrate(model: nn.Module,
              batches: Iterable[torch.Tensor]) -> Dict[str, float]:
    """Each supported conv's input absolute maximum over the calibration
    batches (in eval mode, the float forward): ``{key: amax}``.  A conv
    applied more than once (RetinaNet's shared towers) takes the max over
    every application."""
    amax: Dict[str, torch.Tensor] = {}

    def recorder(key):
        def record(conv, x):
            v = x.detach().to(torch.float32).abs().amax()
            amax[key] = v if key not in amax else torch.maximum(amax[key], v)
            return conv.float_forward(x)
        return record

    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), quant_modes(model, {
                key: recorder(key) for key, _ in supported_convs(model)}):
            for images in batches:
                model(images)
    finally:
        model.train(was_training)
    return {key: float(v) for key, v in amax.items()}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` by IEEE division on every device (CUDA
    divides by a Python number as a product with its reciprocal, which
    lands one f32 step off for some values)."""
    amax = torch.clamp_min(amax, 1e-12)
    return amax / torch.full_like(amax, QMAX)


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An ``[O, I, kh, kw]`` conv weight as int8 per output channel:
    ``(w_q [O, kh, kw, I] int8, w_scale [O] f32)``, ``w_scale = max(amax_c,
    1e-12) / 127``, round half to even, clipped to +-127."""
    kernel = weight.detach().to(torch.float32)
    w_scale = _scale(kernel.abs().amax(dim=(1, 2, 3)))
    w_q = torch.clamp(torch.round(kernel / w_scale[:, None, None, None]),
                      -QMAX, QMAX).to(torch.int8)
    return w_q.permute(0, 2, 3, 1), w_scale


def quantize_input(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """``round(x.f32 / x_scale)`` clipped to +-127, as int8 (x_scale an f32
    0-dim tensor)."""
    q = torch.round(x.to(torch.float32) / x_scale)
    return q.clamp_(-QMAX, QMAX).to(torch.int8)


def im2col(x_q: torch.Tensor, kernel_size: Tuple[int, int],
           stride: Tuple[int, int], padding: Tuple[int, int, int, int],
           k_pad: int) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """An int8 NCHW input as the patch matrix ``[M, K]`` of a conv (rows
    ``(b, ho, wo)``, columns ``(i, j, c)``), zero-padded by ``padding``
    (``F.pad`` order) and its columns padded to ``k_pad``, its rows to at
    least ``_MIN_ROWS``.  Returns it and ``(B, Ho, Wo)``."""
    b, c, h, w = x_q.shape
    left, right, top, bottom = padding
    kh, kw = kernel_size
    sh, sw = stride
    hp, wp = h + top + bottom, w + left + right
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    m, k = b * ho * wo, kh * kw * c
    nhwc = x_q.permute(0, 2, 3, 1)
    if (kh, kw, sh, sw) == (1, 1, 1, 1) and padding == (0, 0, 0, 0) \
            and k == k_pad and m >= _MIN_ROWS:
        return nhwc.reshape(m, k), (b, ho, wo)  # a view when channels-last
    if padding != (0, 0, 0, 0):
        padded = x_q.new_zeros((b, hp, wp, c))
        padded[:, top:top + h, left:left + w] = nhwc
        nhwc = padded
    # [b, ho, wo, c, kh, kw] -> [b, ho, wo, kh, kw, c]
    patches = nhwc.unfold(1, kh, sh).unfold(2, kw, sw).permute(0, 1, 2, 4, 5, 3)
    rows = max(m, _MIN_ROWS)
    if rows == m and k == k_pad:
        a = x_q.new_empty((m, k))
    else:
        a = x_q.new_zeros((rows, k_pad))
    a[:m, :k].view(b, ho, wo, kh, kw, c).copy_(patches)
    return a, (b, ho, wo)


class QuantizedConv:
    """The int8 replacement of one conv (port of ``_quantized_conv``): its
    weight quantized once, here, and its input per call with the
    calibrated ``input_scale`` (amax).  ``spatial_limit`` keeps a call on
    an input of a larger (unpadded) extent float."""

    def __init__(self, conv: Conv2d, input_scale: float,
                 spatial_limit: Optional[int] = None):
        self.spatial_limit = spatial_limit
        w_q, w_scale = quantize_weight(conv.weight)
        n = w_q.shape[0]
        self.kernel_size = tuple(w_q.shape[1:3])
        self.k = w_q[0].numel()
        self.k_pad = _round_up(self.k, _ALIGN)
        self.n = n
        # [N_pad, K_pad] row-major, handed to the product as its transpose
        self.w = w_q.new_zeros((_round_up(n, _ALIGN), self.k_pad))
        self.w[:n, :self.k] = w_q.reshape(n, self.k)
        # the JAX package takes the activation scale in Python floats, then
        # as an f32 constant
        self.x_scale = torch.tensor(max(input_scale, 1e-12) / QMAX,
                                    dtype=torch.float32, device=self.w.device)
        self.scale = w_scale * self.x_scale  # one f32 product, as JAX's
        self.bias = (None if conv.bias is None
                     else conv.bias.detach().to(torch.float32))
        self.stride = tuple(conv.stride)
        ph, pw = conv.padding
        self.padding = (pw, pw, ph, ph)
        if conv.pad is not None:
            pl, pr, pt, pb = conv.pad
            self.padding = (pl + pw, pr + pw, pt + ph, pb + ph)

    @property
    def w_t(self) -> torch.Tensor:
        """The int8 weight ``[K_pad, N_pad]``, column-major, as cuBLASLt
        takes it (a view of ``w``, which an exported program keeps whole)."""
        return self.w.t()

    def accumulator(self, x_q: torch.Tensor) -> torch.Tensor:
        """The conv's s32 accumulator ``[B, Ho, Wo, N]`` of an int8 NCHW
        input."""
        a, (b, ho, wo) = im2col(x_q, self.kernel_size, self.stride,
                                self.padding, self.k_pad)
        # s8 x s8 -> s32; cuBLASLt takes the weight column-major
        y = torch._int_mm(a, self.w_t)
        m = b * ho * wo
        return y[:m, :self.n].reshape(b, ho, wo, self.n)

    def __call__(self, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        if _over_limit(x, self.spatial_limit):
            return conv.float_forward(x)
        y = self.accumulator(quantize_input(x, self.x_scale))
        out = y.to(torch.float32) * self.scale
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype).permute(0, 3, 1, 2)


def make_interceptor(model: nn.Module, amax: Mapping[str, float],
                     spatial_limit: Optional[int] = None
                     ) -> Dict[str, QuantizedConv]:
    """The int8 mode of every supported conv that has an amax (a conv with
    none stays float), its weight quantized now: ``{key: QuantizedConv}``
    for :func:`quant_modes`."""
    return {key: QuantizedConv(conv, amax[key], spatial_limit)
            for key, conv in supported_convs(model) if key in amax}


def quantized_apply(model: nn.Module, amax: Mapping[str, float],
                    spatial_limit: Optional[int] = None) -> Callable:
    """``model``'s call with the calibrated convs in int8 (the weights
    quantized once, here)."""
    modes = make_interceptor(model, amax, spatial_limit)

    def apply(*args, **kwargs):
        with quant_modes(model, modes):
            return model(*args, **kwargs)

    return apply


def make_quantized_predict_step(module: nn.Module, postprocessor: Callable,
                                anchors: torch.Tensor,
                                amax: Mapping[str, float],
                                spatial_limit: Optional[int] = None
                                ) -> Callable:
    """The int8 twin of ``train/step.py::make_predict_step``: the quantized
    forward, then the postprocessor (hard NMS on the CUDA kernel on a
    card)."""
    from single_shot_detection_tpu_torch.train.step import make_predict_step
    modes = make_interceptor(module, amax, spatial_limit)
    predict_step = make_predict_step(module, postprocessor, anchors)

    def quantized_predict_step(images: torch.Tensor):
        with quant_modes(module, modes):
            return predict_step(images)

    return quantized_predict_step


# ---------------------------------------------------------------------------
# Quantization-aware training
# ---------------------------------------------------------------------------
# The forward models int8's rounding and clipping (weights per output
# channel, activations per tensor, the serving path's scales) while the
# gradients pass straight through.  Each supported conv's activation scale
# is an EMA buffer, ``act_amax``, beside its weight (the JAX package keeps it
# in ``batch_stats``): it rides the state_dict and the checkpoints, and
# ``amax_from_batch_stats`` hands the learned scales to int8 serving.


def _fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient."""
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX) * scale
    return x + (q - x).detach()


def _fake_quant_conv(conv: Conv2d, x: torch.Tensor,
                     act_amax: torch.Tensor) -> torch.Tensor:
    """One conv with fake-quantized weight and input, in the input's
    dtype; the input is not quantized while ``act_amax`` is 0."""
    kernel = conv.weight.to(torch.float32)
    w_scale = _scale(kernel.detach().abs().amax(dim=(1, 2, 3)))
    k_fq = _fake_quant(kernel, w_scale[:, None, None, None])
    x_f32 = x.to(torch.float32)
    x_scale = _scale(act_amax)
    x_fq = torch.where(act_amax > 0, _fake_quant(x_f32, x_scale), x_f32)
    y = conv.conv_with(x_fq.to(x.dtype), k_fq.to(x.dtype), None)
    if conv.bias is not None:
        y = y + conv.bias.to(y.dtype)[:, None, None]
    return y


class QatConv:
    """QAT's mode of a conv: in train mode the conv's ``act_amax`` is
    seeded by the first batch's max |input| and then follows an EMA of
    ``decay`` (once per application, in order); in eval mode it is read
    only.  A call on an input beyond ``spatial_limit`` stays float.  In a
    run of several processes the batch's max |input| is over every rank's
    rows, the JAX step's global batch."""

    def __init__(self, decay: float = QAT_DECAY,
                 spatial_limit: Optional[int] = None):
        self.decay = float(decay)
        self.spatial_limit = spatial_limit

    def __call__(self, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        if _over_limit(x, self.spatial_limit):
            return conv.float_forward(x)
        act = conv.act_amax
        if conv.training:
            with torch.no_grad():
                # over the world: the data axis's batch, and under a model
                # axis every rank's rows or channels
                batch_amax = parallel.all_reduce_(
                    x.abs().amax().to(torch.float32).reshape(1), 'max',
                    'world')[0]
                # Python-float factors taken as f32, as JAX takes them
                act.copy_(torch.where(
                    act > 0, self.decay * act + (1.0 - self.decay) * batch_amax,
                    batch_amax))
        return _fake_quant_conv(conv, x, act)


def qat_options(value) -> Optional[dict]:
    """``train.qat`` as ``{'decay', 'spatial_limit'}``: ``True``, a float
    (the decay) or a dict; None when off."""
    if not value:
        return None
    if isinstance(value, dict):
        opts = dict(value)
    elif isinstance(value, bool):
        opts = {}
    else:
        opts = {'decay': float(value)}
    return {'decay': float(opts.get('decay', QAT_DECAY)),
            'spatial_limit': opts.get('spatial_limit')}


def qat_init(model: nn.Module, decay: float = QAT_DECAY,
             spatial_limit: Optional[int] = None) -> int:
    """Give every supported conv a zero ``act_amax`` buffer (the JAX
    package's ``qat_init`` set: every supported conv, whatever the
    ``spatial_limit``) and switch it to QAT's mode.  Returns the count."""
    mode = QatConv(decay, spatial_limit)
    count = 0
    for _, conv in supported_convs(model):
        if 'act_amax' not in conv._buffers:
            conv.register_buffer('act_amax', torch.zeros(
                (), dtype=torch.float32, device=conv.weight.device))
        conv.quant = mode
        count += 1
    return count


def amax_from_batch_stats(state: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """QAT's learned activation scales (the ``act_amax`` entries above 0 of
    a ``state_dict``) as ``{key: amax}``: the handoff to int8 serving in
    place of a calibration."""
    out: Dict[str, float] = {}
    for name, value in state.items():
        if name.endswith('.act_amax'):
            v = float(value)
            if v > 0:
                out[conv_key(name[:-len('.act_amax')])] = v
    return out
