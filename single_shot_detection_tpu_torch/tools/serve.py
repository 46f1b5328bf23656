"""Dynamic-batching HTTP inference server for standalone export artifacts.

Port of the JAX package's ``tools/serve.py``, with the same endpoints and
JSON.  It loads an ``export = {'standalone': True}`` artifact (weights,
normalization and NMS in one ``.pt2`` program, signature raw resized RGB ->
detections; ``export/__init__.py``) and serves it over HTTP with dynamic
batching: concurrent requests are coalesced into one device call, up to the
artifact's batch or a latency budget, whichever comes first.  Like
``infer_exported``, it imports no model code or config; PIL decodes the
uploads and is imported when the server is made.

Usage:
    python -m single_shot_detection_tpu_torch.tools.serve \
        exported/model.pt2 --port 8700 --max-delay-ms 5

Endpoints:
    GET  /healthz   -> {"status": "ok", "batch": B, "input_hw": [H, W]}
    GET  /stats     -> {"requests": N, "batches": M, "mean_batch_fill": F}
    POST /detect[?min_score=S]
        body: image bytes (any PIL-decodable format)
        -> {"size": [width, height],
            "detections": [[x1, y1, x2, y2, class, score], ...]}
        box coordinates are rescaled to the ORIGINAL image's pixels
        (parity with DetectorWrapper.predict_single's rescale,
        reference detection/detector_wrapper.py:62-63).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_SENTINEL = object()


def _numpy(x) -> np.ndarray:
    """An output of the artifact (a tensor on its device) as numpy."""
    return x.cpu().numpy() if hasattr(x, 'cpu') else np.asarray(x)


class _Request:
    __slots__ = ('img', 'event', 'dets', 'valid', 'error')

    def __init__(self, img):
        self.img = img
        self.event = threading.Event()
        self.dets = None
        self.valid = None
        self.error = None


class DynamicBatcher:
    """Coalesces concurrent single-image requests into device batches.

    One consumer thread owns the artifact call: it blocks on the first
    request, then drains the queue until the batch is full or
    ``max_delay_ms`` has elapsed since the first request — so a lone
    request pays at most the latency budget, and a loaded server runs
    full batches with no budget spent at all.
    """

    def __init__(self, call, batch: int, in_hw, max_delay_ms: float = 5.0):
        self._call = call
        self.batch = batch
        self.in_hw = tuple(in_hw)
        self._max_delay = max_delay_ms / 1e3
        self._q = queue.Queue()
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def warmup(self):
        h, w = self.in_hw
        self._call(np.zeros((self.batch, h, w, 3), np.float32))

    def submit(self, img: np.ndarray):
        """img: float32 [H, W, 3] raw 0-255 RGB at the artifact's size.
        Blocks until the batch containing it has run; returns
        (dets [N, 6], valid [N]) numpy rows for this image.  Raises
        RuntimeError if the device call for its batch failed."""
        req = _Request(img)
        self._q.put(req)
        req.event.wait()
        if req.error is not None:
            raise RuntimeError(f'device call failed: {req.error}')
        return req.dets, req.valid

    def _loop(self):
        while not self._stop:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is _SENTINEL:
                break
            group = [first]
            deadline = time.monotonic() + self._max_delay
            while len(group) < self.batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    self._stop = True
                    break
                group.append(nxt)
            # Any failure (a device error, a malformed image shape) must
            # fail THIS group's requests, not kill the consumer thread: a
            # dead consumer would hang every later request while /healthz
            # still answered.
            try:
                h, w = self.in_hw
                imgs = np.zeros((self.batch, h, w, 3), np.float32)
                for i, req in enumerate(group):
                    imgs[i] = req.img
                out = self._call(imgs)
                dets, valid = _numpy(out[0]), _numpy(out[1])
            except Exception as e:
                for req in group:
                    req.error = e
                    req.event.set()
                continue
            with self._lock:
                self.requests += len(group)
                self.batches += 1
            for i, req in enumerate(group):
                req.dets, req.valid = dets[i], valid[i]
                req.event.set()

    def stats(self):
        with self._lock:
            n, m = self.requests, self.batches
        return {'requests': n, 'batches': m,
                'mean_batch_fill': round(n / m, 3) if m else 0.0}

    def stop(self):
        self._q.put(_SENTINEL)
        self._thread.join(timeout=5.0)


def _make_handler(batcher: DynamicBatcher):
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default; HTTP is the API
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == '/healthz':
                h, w = batcher.in_hw
                self._json(200, {'status': 'ok', 'batch': batcher.batch,
                                 'input_hw': [h, w]})
            elif path == '/stats':
                self._json(200, batcher.stats())
            else:
                self._json(404, {'error': f'unknown path {path}'})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != '/detect':
                self._json(404, {'error': f'unknown path {url.path}'})
                return
            try:
                min_score = float(
                    parse_qs(url.query).get('min_score', ['0.3'])[0])
            except ValueError as e:
                self._json(400, {'error': f'bad min_score: {e}'})
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                raw = self.rfile.read(length)
                with Image.open(io.BytesIO(raw)) as im:
                    src_w, src_h = im.size
                    h, w = batcher.in_hw
                    img = np.asarray(
                        im.convert('RGB').resize((w, h), Image.BILINEAR),
                        np.float32)
            except Exception as e:  # malformed upload
                self._json(400, {'error': f'bad image: {e}'})
                return
            try:
                dets, valid = batcher.submit(img)
            except RuntimeError as e:
                self._json(503, {'error': str(e)})
                return
            keep = valid & (dets[:, 5] >= min_score)
            rows = dets[keep].astype(np.float64)
            # rescale from artifact input pixels to source pixels
            rows[:, (0, 2)] *= src_w / w
            rows[:, (1, 3)] *= src_h / h
            self._json(200, {
                'size': [src_w, src_h],
                'detections': [
                    [round(x1, 2), round(y1, 2), round(x2, 2), round(y2, 2),
                     int(cls), round(float(score), 4)]
                    for x1, y1, x2, y2, cls, score in rows],
            })

    return Handler


def make_server(artifact: str, host: str = '127.0.0.1', port: int = 8700,
                max_delay_ms: float = 5.0):
    """Returns (ThreadingHTTPServer, DynamicBatcher), artifact warmed up."""
    from single_shot_detection_tpu_torch.export import load_exported_with_spec
    call, specs = load_exported_with_spec(artifact)
    if len(specs) != 1:
        raise SystemExit(
            f'{artifact} takes {len(specs)} inputs — not a standalone '
            "artifact (re-export with export = {'standalone': True})")
    b, h, w, _ = specs[0].shape
    batcher = DynamicBatcher(call, b, (h, w), max_delay_ms=max_delay_ms)
    batcher.warmup()
    server = ThreadingHTTPServer((host, port), _make_handler(batcher))
    return server, batcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('artifact', help='path to a standalone .pt2 file')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8700)
    ap.add_argument('--max-delay-ms', type=float, default=5.0,
                    help='batching latency budget per request')
    args = ap.parse_args(argv)

    server, batcher = make_server(args.artifact, args.host, args.port,
                                  args.max_delay_ms)
    h, w = batcher.in_hw
    print(f'>> serving {args.artifact} on http://{args.host}:{args.port}  '
          f'(batch {batcher.batch}, input {h}x{w}, '
          f'delay budget {args.max_delay_ms} ms)', flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.stop()
    return 0


if __name__ == '__main__':
    sys.exit(main())
