"""Port parity for deployment: the artifact's consumers
``single_shot_detection_tpu_torch/tools/infer_exported.py`` and
``tools/serve.py`` against the JAX package's tools, the CLI's ``export``
and ``test`` phases, the drawing helpers, and a soft-NMS artifact.  Everything runs on the CPU
at ``samples/synthetic_smoke.py`` (128 px, 5 classes) with the port's
seeded weights and perturbed BN statistics (``test_torch_port_export.py``'s
``perturb_bn``), crossed to JAX by ``utils/weights.py::to_jax_variables``.

Tolerances:
- ``infer_exported`` against the JAX tool on JAX's artifact of the same
  weights: the same header and detection counts, each printed row within
  0.011 of one of JAX's for that image (two decimals, scores three; rows
  whose scores tie to a float step may come in either order);
- the server's answers against the artifact's own call on the same
  decoded image, rescaled and rounded as the server does: within 0.011
  (the artifact runs the request in another batch slot);
- the CLI's artifact and the soft-NMS artifact against the experiment's
  eager predict step, and the test phase's frames against ``draw_boxes``
  of ``Experiment.predict``: equal.
"""

import http.client
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from single_shot_detection_tpu import export as jax_export
from single_shot_detection_tpu.utils import image_utils as jax_image_utils
from single_shot_detection_tpu_torch import cli
from single_shot_detection_tpu_torch import device as device_mod
from single_shot_detection_tpu_torch import export as pt_export
from single_shot_detection_tpu_torch.data.datasets import Synthetic
from single_shot_detection_tpu_torch.tools import infer_exported, serve
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.train.step import make_predict_step
from single_shot_detection_tpu_torch.utils import image_utils
from single_shot_detection_tpu_torch.utils.config import load_config
from test_torch_port_export import SMOKE, eager, jax_stand_in, perturb_bn
from _torch_port_fixtures import one_torch_thread  # noqa: F401

BATCH = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def restore_state():
    """``cli.main`` configures the root logger and entry points write
    torch's precision flags: put both back."""
    import logging
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    flags = device_mod.current_flags()
    last, ambient = device_mod._last_write, device_mod._user_ambient
    yield
    root.handlers[:] = handlers
    root.setLevel(level)
    device_mod.set_flags(flags)
    device_mod._last_write, device_mod._user_ambient = last, ambient


@pytest.fixture(scope='module')
def port_exp():
    exp = Experiment(SMOKE, phases=('eval',), device='cpu')
    perturb_bn(exp.model)
    return exp


@pytest.fixture(scope='module')
def artifact(port_exp, tmp_path_factory):
    """A standalone artifact at batch 4: ``(path, loaded callable)``."""
    path = pt_export.export_model(
        port_exp, str(tmp_path_factory.mktemp('deploy') / 'standalone'),
        with_postprocess=True, with_preprocess=True, bake_variables=True,
        batch_size=BATCH)
    return path, pt_export.load_exported(path)


def png_bytes(w, h, seed):
    arr = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


# ----------------------------------------------------------- infer_exported

def parse_tool_output(text):
    """``(header, {name: rows})`` of an ``infer_exported`` printout; rows
    are ``[x1, y1, x2, y2, score, class]``."""
    lines = text.strip().splitlines()
    blocks, name = {}, None
    for line in lines[1:-1]:
        if line.startswith('  ['):
            box, rest = line.strip()[1:].split(']')
            score, cls = rest.split()
            blocks[name].append([*map(float, box.split()),
                                 float(score.split('=')[1]),
                                 float(cls.split('=')[1])])
        else:
            name, count = line.split(': ')
            blocks[name] = []
            assert count == 'detections' or count.endswith(' detections')
    assert lines[-1].startswith('>> inference: ')
    assert lines[-1].endswith(f'for 1 call of batch {BATCH}')
    return lines[0], blocks


def test_infer_exported_prints_what_the_jax_tool_prints(port_exp, artifact,
                                                        tmp_path, capsys):
    """``python -m single_shot_detection_tpu_torch.tools.infer_exported ART
    --synthetic`` in a fresh process: exit 0, JAX's tool's lines on JAX's
    artifact of the same weights, and neither JAX nor the port's model
    code imported."""
    probe = (
        'import runpy, sys\n'
        'sys.argv = ["infer_exported", sys.argv[1], "--synthetic", '
        '"--min-score", "0.0"]\n'
        'try:\n'
        '    runpy.run_module("single_shot_detection_tpu_torch.tools.'
        'infer_exported", run_name="__main__")\n'
        'except SystemExit as e:\n'
        '    code = e.code\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("jax", "flax", "single_shot_detection_tpu") or m.startswith('
        '("single_shot_detection_tpu_torch.models", '
        '"single_shot_detection_tpu_torch.train", '
        '"single_shot_detection_tpu_torch.utils.config")))\n'
        'print("EXIT", code, "IMPORTED", ",".join(bad))\n')
    env = {**os.environ, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1'}
    proc = subprocess.run([sys.executable, '-c', probe, artifact[0]],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    out, _, status = proc.stdout.rpartition('EXIT ')
    assert status.split() == ['0', 'IMPORTED'], status

    jax_art = jax_export.export_model(
        jax_stand_in(port_exp), str(tmp_path / 'jax'), with_postprocess=True,
        with_preprocess=True, bake_variables=True, batch_size=BATCH)
    spec = importlib.util.spec_from_file_location(
        'jax_infer_exported', os.path.join(REPO, 'tools', 'infer_exported.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    capsys.readouterr()
    assert tool.main([jax_art, '--synthetic', '--min-score', '0.0']) == 0
    want_head, want = parse_tool_output(capsys.readouterr().out)

    head, got = parse_tool_output(out)
    assert head == want_head == (f'>> artifact expects [{BATCH}, 128, 128, 3] '
                                 'raw RGB')
    assert list(got) == list(want) == [f'synthetic[{i}]' for i in range(BATCH)]
    assert sum(map(len, want.values())) > 0
    for name in want:
        assert len(got[name]) == len(want[name]), name
        left = [np.asarray(r) for r in want[name]]
        for row in map(np.asarray, got[name]):
            match = [j for j, r in enumerate(left)
                     if np.abs(r - row).max() <= 0.011]
            assert match, (name, row)
            left.pop(match[0])


def test_infer_exported_refuses_an_artifact_that_takes_weights(monkeypatch):
    """An artifact whose weights are an input (its specs: the state_dict's
    tensors, then the images; ``test_torch_port_export.py`` counts them) is
    not a standalone one."""
    spec = pt_export.InputSpec((4, 128, 128, 3), torch.float32)
    monkeypatch.setattr(infer_exported, 'load_exported_with_spec',
                        lambda path: (None, [spec, spec]))
    with pytest.raises(SystemExit, match='takes 2 inputs — not a standalone '
                                         'artifact'):
        infer_exported.load_artifact('plain.pt2')


def test_infer_exported_reads_image_files(artifact, tmp_path, capsys):
    """Image files of any size are resized into the artifact's batch;
    five images take two calls, the padding slots never printed."""
    names = []
    for i, (w, h) in enumerate([(64, 96), (200, 150), (128, 128), (90, 90),
                                (300, 100)]):
        names.append(str(tmp_path / f'{i}.png'))
        (tmp_path / f'{i}.png').write_bytes(png_bytes(w, h, i))
    assert infer_exported.main([artifact[0], *names, '--min-score', '0.0']) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(':')[0] for line in lines
            if line.endswith('detections')] == names
    assert lines[-1].startswith('>> inference: ')
    assert lines[-1].endswith(f'for 2 calls of batch {BATCH}')
    want = infer_exported.load_images(names[:BATCH], (128, 128), BATCH)
    dets, valid = artifact[1](want)
    n0 = int((valid[0] & (dets[0, :, 5] >= 0.0)).sum())
    assert f'{names[0]}: {n0} detections' in lines


# ------------------------------------------------------- soft-NMS artifact

def test_soft_nms_artifact_equals_eager(artifact, tmp_path):
    """Under ``torch.export`` soft-NMS runs all K rounds (no host read);
    the eager path stops when no row is active, with the same mask.  The
    program holds no NMS op."""
    cfg = load_config(SMOKE, phases=('eval',))
    # 8 candidates a class: the program unrolls that many rounds
    cfg.config.postprocess['nms'].update(soft=True, max_per_class=8)
    exp = Experiment(cfg, phases=('eval',), device='cpu')
    perturb_bn(exp.model)
    path = pt_export.export_model(exp, str(tmp_path / 'soft'),
                                  with_postprocess=True, with_preprocess=True,
                                  bake_variables=True, batch_size=BATCH)
    raw = (np.random.RandomState(3).rand(BATCH, 128, 128, 3) * 255
           ).astype(np.float32)
    call = pt_export.load_exported(path)
    dets, valid = call(raw)
    x = exp.eval_pipeline.preprocess.normalize(torch.from_numpy(raw))
    want = eager(exp, np.ascontiguousarray(x.permute(0, 2, 3, 1).numpy()))
    assert torch.equal(dets, want[0]) and torch.equal(valid, want[1])
    assert valid.sum() > 0
    def nms_ops(module):
        return sum('nms_keep_batched' in str(node.target)
                   for node in module.graph.nodes)
    assert nms_ops(call.module) == 0
    assert nms_ops(artifact[1].module) == 1  # the hard-NMS artifact's op


# -------------------------------------------------------------------- serve

@pytest.fixture(scope='module')
def server(artifact):
    # a generous latency budget so the concurrent test requests always
    # coalesce on a loaded host
    srv, batcher = serve.make_server(artifact[0], port=0, max_delay_ms=1000.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address, batcher
    finally:
        srv.shutdown()
        batcher.stop()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def test_healthz(server):
    addr, _ = server
    assert request(addr, 'GET', '/healthz') == (
        200, {'status': 'ok', 'batch': BATCH, 'input_hw': [128, 128]})


def expected_answer(call, body, min_score):
    """The artifact's own answer to one uploaded image, as the server
    computes it (the image alone in slot 0 of a batch)."""
    with Image.open(io.BytesIO(body)) as im:
        src_w, src_h = im.size
        img = np.asarray(im.convert('RGB').resize((128, 128), Image.BILINEAR),
                         np.float32)
    batch = np.zeros((BATCH, 128, 128, 3), np.float32)
    batch[0] = img
    dets, valid = (t.numpy() for t in call(batch))
    rows = dets[0][valid[0] & (dets[0][:, 5] >= min_score)].astype(np.float64)
    rows[:, (0, 2)] *= src_w / 128
    rows[:, (1, 3)] *= src_h / 128
    return [src_w, src_h], rows


def test_concurrent_requests_coalesce_and_answer_as_the_artifact(server,
                                                                 artifact):
    addr, batcher = server
    before = batcher.stats()
    sizes = [(64, 96), (256, 200), (128, 128)]
    bodies = [png_bytes(w, h, seed=i) for i, (w, h) in enumerate(sizes)]
    results = [None] * len(sizes)

    def post(i):
        results[i] = request(addr, 'POST', '/detect?min_score=0.15', bodies[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)

    for body, (status, payload) in zip(bodies, results):
        assert status == 200
        size, want = expected_answer(artifact[1], body, 0.15)
        assert payload['size'] == size
        got = np.asarray(payload['detections'], np.float64).reshape(-1, 6)
        assert len(got) == len(want) > 0
        left = list(want)
        for row in got:
            match = [j for j, r in enumerate(left)
                     if np.abs(r - row).max() <= 0.011]
            assert match, row
            left.pop(match[0])

    after = batcher.stats()
    new_requests = after['requests'] - before['requests']
    new_batches = after['batches'] - before['batches']
    assert new_requests == 3
    assert new_batches < new_requests  # concurrent requests share calls
    assert request(addr, 'GET', '/stats') == (200, after)


@pytest.mark.parametrize('path, body, status, message', [
    ('/detect', b'not an image', 400, 'bad image'),
    ('/detect?min_score=abc', png_bytes(32, 32, 0), 400, 'min_score'),
    ('/nope', b'', 404, 'unknown path'),
], ids=['bad image', 'bad min_score', 'unknown path'])
def test_bad_requests(server, path, body, status, message):
    addr, _ = server
    got_status, payload = request(addr, 'POST', path, body)
    assert got_status == status and message in payload['error']


def test_failing_device_call_does_not_kill_the_batcher():
    """A failing call fails its group (RuntimeError to the submitters) and
    leaves the consumer thread serving later requests."""
    calls = {'n': 0}

    def flaky_call(imgs):
        calls['n'] += 1
        if calls['n'] == 1:
            raise ValueError('device error')
        b = imgs.shape[0]
        return torch.zeros(b, 3, 6), torch.zeros(b, 3, dtype=torch.bool)

    batcher = serve.DynamicBatcher(flaky_call, batch=2, in_hw=(8, 8),
                                   max_delay_ms=1.0)
    try:
        img = np.zeros((8, 8, 3), np.float32)
        with pytest.raises(RuntimeError, match='device error'):
            batcher.submit(img)
        dets, valid = batcher.submit(img)
        assert dets.shape == (3, 6) and not valid.any()
        assert batcher.stats()['requests'] == 1
    finally:
        batcher.stop()


# ---------------------------------------------------------------- the CLI

def export_config(tmp_path, block):
    path = tmp_path / 'smoke_export.py'
    path.write_text(open(SMOKE).read() + f'\nexport = {block!r}\n')
    return str(path)


def test_cli_export_phase_writes_the_standalone_artifact(tmp_path):
    """``--phases export`` with ``export = {'standalone': True, ...}``: a
    baked artifact at the block's path and batch whose detections equal the
    experiment's eager serving path on synthetic images."""
    out = tmp_path / 'exported' / 'model'
    config = export_config(tmp_path, {'standalone': True, 'path': str(out),
                                      'batch_size': 2})
    exp, result = cli.main(['--cpu', '--config', config, '--phases',
                            'export'])
    assert result is None
    path = str(out) + '.pt2'
    meta = pt_export.read_meta(path)
    assert (meta['bake_variables'], meta['with_postprocess'],
            meta['with_preprocess'], meta['int8']) == (True, True, True, False)
    call, specs = pt_export.load_exported_with_spec(path)
    assert specs == [pt_export.InputSpec((2, 128, 128, 3), torch.float32)]
    data = Synthetic(num_images=2, image_size=128, num_classes=5, max_boxes=3,
                     seed=2)
    staged = np.stack([a['image'] for a in data.annotations])
    dets, valid = call(staged.astype(np.float32))
    exp.model.eval()
    x = exp.eval_pipeline.preprocess(torch.from_numpy(staged))
    want = make_predict_step(exp.model, exp.serving_postprocessor,
                             exp.anchors)(x)
    assert torch.equal(dets, want[0]) and torch.equal(valid, want[1])


def test_cli_export_block_refuses_an_unknown_key(tmp_path):
    config = export_config(tmp_path, {'standalone': True, 'pth': 'x'})
    with pytest.raises(SystemExit, match=r"unknown key\(s\) \['pth'\]"):
        cli.main(['--cpu', '--config', config, '--phases', 'export'])
    assert not os.path.exists('x.pt2')


def test_cli_test_phase_saves_frames_headless(tmp_path, monkeypatch):
    """``--phases test --video DIR`` with no display: each image of the
    folder goes through ``Experiment.predict`` and ``draw_boxes`` and is
    saved as a PNG in the temporary directory."""
    folder = tmp_path / 'frames_in'
    (folder / 'sub').mkdir(parents=True)
    (folder / 'a.png').write_bytes(png_bytes(160, 120, 1))
    (folder / 'sub' / 'b.jpg').write_bytes(b'')
    Image.fromarray((np.random.RandomState(2).rand(90, 70, 3) * 255)
                    .astype(np.uint8)).save(folder / 'sub' / 'b.jpg')
    monkeypatch.delenv('DISPLAY', raising=False)
    monkeypatch.delenv('WAYLAND_DISPLAY', raising=False)
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path / 'tmp'))
    (tmp_path / 'tmp').mkdir()
    exp, _ = cli.main(['--cpu', '--config', SMOKE, '--phases', 'test',
                       '--video', str(folder)])
    out = tmp_path / 'tmp' / 'ssd_torch_frames'
    assert sorted(os.listdir(out)) == ['00000.png', '00001.png']
    for i, src in enumerate([folder / 'a.png', folder / 'sub' / 'b.jpg']):
        with Image.open(src) as im:
            frame = np.asarray(im.convert('RGB'))
        dets = exp.predict(frame)
        assert len(dets) > 0
        with Image.open(out / f'{i:05d}.png') as im:
            saved = np.asarray(im)
        np.testing.assert_array_equal(saved, image_utils.draw_boxes(frame, dets))
        assert (saved != frame).any()


def test_draw_boxes_matches_jax():
    rng = np.random.RandomState(4)
    img = (rng.rand(80, 100, 3) * 255).astype(np.uint8)
    boxes = np.concatenate([rng.rand(6, 2) * 50, rng.rand(6, 2) * 50 + 40,
                            rng.randint(1, 6, (6, 1)), rng.rand(6, 1)], 1)
    labels = ['bg', 'a', 'b', 'c', 'd', 'e']
    for lab in (None, labels):
        np.testing.assert_array_equal(
            image_utils.draw_boxes(img, boxes, lab),
            jax_image_utils.draw_boxes(img, boxes, lab))


def test_display_headless_saves_a_png(tmp_path, monkeypatch):
    monkeypatch.delenv('DISPLAY', raising=False)
    monkeypatch.delenv('WAYLAND_DISPLAY', raising=False)
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    img = np.zeros((40, 40, 3), np.uint8)
    image_utils.display(img, np.array([[5, 5, 30, 30, 1, 0.9]]))
    with Image.open(tmp_path / 'ssd_torch_display.png') as im:
        assert im.size == (40, 40)
