"""Model export: the inference function as a ``torch.export`` artifact.

Port of ``single_shot_detection_tpu/export/__init__.py`` (``make_inference_fn``,
``export_model``, ``load_exported``, ``load_exported_with_spec``); int8
serving and QAT are ``quantize.py`` beside it.

The artifact is an ``ExportedProgram`` saved with ``torch.export.save`` to
``<path>.pt2``: the forward, then f32 softmax scores and decoded corner
boxes with the anchors baked in, or with ``with_postprocess`` the serving
postprocessor, whose hard NMS is the custom op
``ssd_torch::nms_keep_batched`` (``ops/nms_kernel.py``: the CUDA kernel on
a card, its plain version on the CPU).  Its input is JAX's artifact
signature, f32 ``[B, H, W, 3]`` NHWC at a fixed batch, permuted to NCHW
inside.  Where the JAX package's StableHLO stands alone, a ``.pt2`` program
names the op and does not carry it: loading one needs ``ops/nms_kernel.py``
imported, which this module does.

Precision travels in the file.  Torch reads its TF32 flags when a
convolution runs, not when it is traced, so the exporting experiment's
numeric policy (``device.py``) is recorded beside the program
(:data:`META_FILE`) and a loaded artifact runs each call under it,
restoring the caller's flags afterwards.

This module's top level imports only ``torch``, numpy, ``device.py``,
``ops/boxes.py`` and ``ops/nms_kernel.py``, so a consumer that only loads artifacts
(``tools/infer_exported.py``, ``tools/serve.py``) imports no model code.
"""

from __future__ import annotations

import json
import logging
import os
import zipfile
from typing import Any, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from single_shot_detection_tpu_torch.device import NumericPolicy
from single_shot_detection_tpu_torch.ops import boxes as box_ops
# importing nms_kernel registers the NMS op that programs name
from single_shot_detection_tpu_torch.ops import nms_kernel  # noqa: F401

SUFFIX = '.pt2'
META_FILE = 'ssd_torch_export.json'


class InputSpec(NamedTuple):
    """One input of an artifact, as ``jax.export``'s ``in_avals`` give it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _deploy_model(experiment) -> Tuple[nn.Module, dict]:
    """``(model, state_dict)`` to export: the physically narrow rebuild of
    a pruned run (``Experiment.materialize_pruned``,
    ``train/materialize.py``), else the experiment's evaluation model and
    its weights: the EMA shadow under ``train.ema``, as the JAX package
    exports it.  With a model axis the model is whole
    (``Experiment.whole_model``, a collective every rank enters), as the
    JAX package's global arrays are."""
    if getattr(experiment, 'pruner', None) is not None and experiment.pruner.dead:
        bundle, state = experiment.materialize_pruned()
        logging.info('>> exporting the materialized (narrow) pruned model')
        return bundle.module, dict(state)
    model = experiment.whole_model()
    return model, dict(model.state_dict())


class _Forward(nn.Module):
    """The detector's forward as an artifact runs it: the convs float, or
    int8 on ``amax`` (``quantize.make_interceptor``).  With ``quantize_now``
    (a program with its weights baked in) the int8 weights are quantized
    here, once, as constants of the program; otherwise inside the program,
    so a program that takes its weights as an input quantizes those.  A
    ``train.qat`` model exports float without ``int8``, as the JAX
    package's ``module.apply`` does."""

    def __init__(self, model: nn.Module, amax=None, spatial_limit=None,
                 quantize_now: bool = False):
        super().__init__()
        self.model = model
        self.amax = amax
        self.spatial_limit = spatial_limit
        self.modes = self._modes() if quantize_now else None

    def _modes(self) -> dict:
        from single_shot_detection_tpu_torch.export import quantize
        if self.amax is None:
            return {key: None for key, _ in quantize.supported_convs(self.model)}
        return quantize.make_interceptor(self.model, self.amax,
                                         self.spatial_limit)

    def forward(self, x):
        from single_shot_detection_tpu_torch.export import quantize
        modes = self.modes if self.modes is not None else self._modes()
        with quantize.quant_modes(self.model, modes):
            return self.model(x)


class InferenceFn(nn.Module):
    """The inference function: ``forward(images)`` with the weights baked in
    (``bake_variables``), else ``forward(state_dict, images)`` on the
    model's ``state_dict`` (flax names), its weights an input.

    ``images``: f32 ``[B, H, W, 3]``, normalized by the caller or, with
    ``normalize`` (the eval pipeline's ``Preprocess.normalize``), raw
    resized RGB in 0-255.  Returns ``(probs [B, A, C], boxes [B, A, 4])``,
    or the postprocessor's ``(detections, valid)``.
    """

    def __init__(self, net: _Forward, anchors: torch.Tensor, box_coder,
                 postprocessor=None, normalize=None, bake_variables=True):
        super().__init__()
        self.bake_variables = bool(bake_variables)
        if self.bake_variables:
            self.net = net
        else:  # not a submodule: the program takes the weights as an input
            object.__setattr__(self, '_net', net)
        self.register_buffer('anchors', anchors)
        self.box_coder = box_coder
        self.postprocessor = postprocessor
        self.normalize = normalize

    def forward(self, *inputs):
        if self.bake_variables:
            (images,) = inputs
            run = self.net
        else:
            state, images = inputs
            weights = {f'model.{k}': v for k, v in state.items()}

            def run(x):
                return torch.func.functional_call(self._net, weights, (x,),
                                                  strict=True)
        if self.normalize is not None:
            x = self.normalize(images.float())
        else:
            x = images.permute(0, 3, 1, 2).contiguous()
        scores, locs = run(x)
        scores, locs = scores.float(), locs.float()
        if self.postprocessor is not None:
            return self.postprocessor(scores, locs, self.anchors)
        probs = torch.softmax(scores, dim=-1)
        decoded = box_ops.to_corners(self.box_coder.decode(locs, self.anchors))
        return probs, decoded


def make_inference_fn(experiment, with_postprocess: bool = False,
                      int8: bool = False, with_preprocess: bool = False,
                      batch_size: Optional[int] = None) -> InferenceFn:
    """The inference function ``(state_dict, images) -> outputs`` of the
    experiment's model (an :class:`InferenceFn`).

    Default: softmaxed scores and decoded corner boxes.
    ``with_postprocess`` adds the serving postprocessor with its NMS;
    ``int8`` serves the convs in int8 past the serving gate (judged at
    ``batch_size``, else the config's batch), on the experiment's scales at
    its current step, a ``train.qat`` run's learned ones, or a calibration
    on eval batches; ``with_preprocess`` bakes the config's normalization,
    so the function takes raw resized RGB.
    """
    model, _ = _deploy_model(experiment)
    return _make_inference_fn_for(experiment, model, with_postprocess,
                                  int8=int8, with_preprocess=with_preprocess,
                                  batch_size=batch_size, bake_variables=False)


def _int8_amax(experiment, model: nn.Module, batch_size: Optional[int]):
    """``(amax, spatial_limit)`` for an int8 artifact, or ``ValueError``
    when the serving gate refuses the config at ``batch_size``."""
    from single_shot_detection_tpu_torch.export import quantize
    enabled, opts = quantize.resolve_int8_opts(experiment.cfg,
                                               batch_size=batch_size)
    if not enabled:
        gate_batch = (batch_size if batch_size is not None
                      else getattr(experiment.cfg, 'batch_size', None))
        # an artifact quietly falling back to float would ship the wrong
        # program: refuse with the recipe instead
        raise ValueError(
            f'int8 export refused: this backbone at batch {gate_batch} '
            f'{"(the config training batch — pass batch_size to gate on "
               "the serving batch) " if batch_size is None else ""}'
            'is refused by the JAX package\'s int8 preset, where it was '
            'measured to regress (docs/SERVING.md). Set an explicit '
            '``int8 = {...}`` config block to force it.')
    # scales the experiment calibrated at its current step (an --int8
    # evaluation before the export) are valid for these weights
    amax = None
    if (experiment._int8_amax is not None
            and experiment._int8_calib_step == int(experiment.trainer.state.step)):
        amax = experiment._int8_amax
        logging.info(f'>> int8 export: reusing the experiment\'s {len(amax)} '
                     'calibrated conv scales')
    if amax is None:
        amax = quantize.amax_from_batch_stats(model.state_dict()) or None
        if amax:
            logging.info(f'>> int8 export: using {len(amax)} QAT-learned conv '
                         'scales')
    if amax is None:
        amax = experiment.calibrate_int8(
            model, int(opts.get('calibration_batches', 2)))
        logging.info(f'>> int8 export: calibrated {len(amax)} convs')
    return amax, opts.get('spatial_limit')


def _make_inference_fn_for(experiment, model: nn.Module,
                           with_postprocess: bool, int8: bool = False,
                           with_preprocess: bool = False,
                           batch_size: Optional[int] = None,
                           bake_variables: bool = False) -> InferenceFn:
    from single_shot_detection_tpu_torch.models import norm
    # a train.group_norm model runs its GroupNorm forward in eval mode too
    # (models/layers.py::set_group_norm), so the program traces it
    if int8 and norm.groups_from_config(
            dict(experiment.cfg.train or {}).get('group_norm')):
        raise ValueError('int8 export does not compose with '
                         'train.group_norm (same trace-time override)')
    amax, spatial_limit = (_int8_amax(experiment, model, batch_size) if int8
                           else (None, None))
    return InferenceFn(
        _Forward(model, amax, spatial_limit, quantize_now=bake_variables),
        experiment.anchors,
        experiment.postprocessor.box_coder,
        experiment.serving_postprocessor if with_postprocess else None,
        experiment.eval_pipeline.preprocess.normalize if with_preprocess
        else None,
        bake_variables)


def export_model(experiment, path: str, with_postprocess: bool = False,
                 batch_size: int = 1, int8: bool = False,
                 with_preprocess: bool = False,
                 bake_variables: bool = False) -> str:
    """Export the inference function at batch ``batch_size`` to
    ``<path>.pt2`` on the experiment's device; returns the file's path.

    ``bake_variables`` closes over the weights (call signature ``images ->
    outputs``); the default takes ``(state_dict, images)``, so one artifact
    serves many checkpoints of the config.  A standalone artifact (raw
    resized images in, final detections out) is ``with_postprocess=True,
    with_preprocess=True, bake_variables=True``: the ``export =
    {'standalone': True}`` config shorthand, which
    ``tools/infer_exported.py`` and ``tools/serve.py`` consume.

    In a run of several processes every rank builds the inference function
    (the whole model's gather under a model axis, an int8 calibration's
    maximum over the ranks: collectives) and process 0 alone traces and
    writes it; it traces the whole model without the model axis, so the
    program holds no collective and equals one process's export of the
    same state.  Other ranks return the path process 0 writes.
    """
    from single_shot_detection_tpu_torch.parallel import model_axis_off
    model, state = _deploy_model(experiment)
    infer = _make_inference_fn_for(experiment, model, with_postprocess,
                                   int8=int8, with_preprocess=with_preprocess,
                                   batch_size=batch_size,
                                   bake_variables=bake_variables)
    out_path = path + SUFFIX
    if experiment.process_index != 0:
        return out_path
    w, h = experiment.input_size
    images = torch.zeros((batch_size, h, w, 3), dtype=torch.float32,
                         device=experiment.device)
    policy = experiment.policy
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), policy.scope(), model_axis_off():
            program = torch.export.export(
                infer, (images,) if bake_variables else (state, images))
    finally:
        model.train(was_training)
    # the zeros it was traced on (and the weights, when they are an input)
    # would be saved with the program
    program.example_inputs = None
    meta = {'device': experiment.device.type,
            'dtype': str(policy.dtype).replace('torch.', ''),
            'matmul_precision': policy.matmul_precision,
            'flags': list(policy.flags),
            'with_postprocess': bool(with_postprocess),
            'with_preprocess': bool(with_preprocess),
            'bake_variables': bool(bake_variables), 'int8': bool(int8)}
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    torch.export.save(program, out_path,
                      extra_files={META_FILE: json.dumps(meta)})
    logging.info(f'>> Exported the program to {out_path} '
                 f'({os.path.getsize(out_path)} bytes)')
    return out_path


def read_meta(path: str) -> dict:
    """The record :func:`export_model` keeps in an artifact, read without
    loading its program."""
    with zipfile.ZipFile(path) as archive:
        names = [n for n in archive.namelist()
                 if n.endswith(f'extra/{META_FILE}')]
        if not names:
            raise ValueError(f'{path} holds no {META_FILE}: not an artifact '
                             'of export_model')
        return json.loads(archive.read(names[0]))


class ExportedCall:
    """A loaded artifact's call.  Each call runs under the numeric flags
    recorded in the file (and in inference mode) and restores the caller's
    flags afterwards; numpy inputs become tensors on the artifact's device,
    and tensors are taken as they are."""

    def __init__(self, module: nn.Module, meta: dict):
        self.module = module
        self.meta = meta
        self.device = torch.device(meta['device'])
        self.policy = NumericPolicy(getattr(torch, meta['dtype']),
                                    meta['matmul_precision'],
                                    tuple(meta['flags']))

    def _tensor(self, x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if isinstance(x, Mapping):  # a state_dict, as a plain dict
            return {k: self._tensor(v) for k, v in x.items()}
        return x

    def __call__(self, *inputs: Any):
        inputs = [self._tensor(x) for x in inputs]
        with self.policy.scope(), torch.inference_mode():
            return self.module(*inputs)


def load_exported(path: str) -> ExportedCall:
    """Load an artifact; returns its callable."""
    return load_exported_with_spec(path)[0]


def load_exported_with_spec(path: str) -> Tuple[ExportedCall, List[InputSpec]]:
    """Load an artifact; returns ``(callable, input specs)``, the specs of
    the program's flattened inputs (one for a baked artifact: ``[B, H, W,
    3]`` f32), so a consumer can read the expected input from the artifact
    itself.  An artifact exported on a card loads only where CUDA is
    available: nothing is moved between devices."""
    meta = read_meta(path)
    if meta['device'] == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{path} was exported on a CUDA card and CUDA is '
                           'not available here; export it on the CPU to run '
                           'it there')
    program = torch.export.load(path)
    user_inputs = set(program.graph_signature.user_inputs)
    specs = [InputSpec(tuple(node.meta['val'].shape), node.meta['val'].dtype)
             for node in program.graph.nodes
             if node.op == 'placeholder' and node.name in user_inputs]
    return ExportedCall(program.module(), meta), specs
