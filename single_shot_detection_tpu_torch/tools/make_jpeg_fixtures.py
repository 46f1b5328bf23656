"""Write the small Pascal VOC-style JPEG fixture set, from a fixed seed.

    python -m single_shot_detection_tpu_torch.tools.make_jpeg_fixtures [DIR]
    python -m single_shot_detection_tpu_torch.tools.make_jpeg_fixtures \
        --digest native/libssd_decode.so

writes (by default into ``single_shot_detection_tpu_torch/data/
jpeg_fixtures``) ``VOC2007/JPEGImages/fx00.jpg`` .. ``fx15.jpg`` at
VOC-like sizes (one of them grayscale), PIL quality 80, band-limited
colour noise with one to four textured rectangles each;
``VOC2007/Annotations/fxNN.xml`` with those rectangles as objects of
VOC classes (some marked difficult); and ``VOC2007/ImageSets/Main/``
``all.txt`` (the 16 ids), ``train256.txt`` and ``eval64.txt`` (the ids
repeated in seeded orders, 256 and 64 entries).  The ``Voc`` dataset reads
the tree as it reads Pascal VOC: ``{'name': 'Voc', 'root': DIR,
'image_sets': [(2007, 'train256')]}``.  The files are committed, so a
machine without an encoder needs none; PIL's encoder may differ between
versions, so the committed bytes, not this script's output elsewhere,
are the fixtures.

``--digest LIB`` stages the committed fixtures with the decoder library
``LIB`` (the C interface of ``native/decode.cpp``; the JAX package's
``native/libssd_decode.so`` wrote the committed file) and writes the
sha256 of each staged batch to ``jpeg_fixtures/staged_sha256.json``
(:func:`staged_digests`): every build of the decoder must reproduce it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

DEFAULT_DIR = Path(__file__).resolve().parent.parent / 'data' / 'jpeg_fixtures'
DIGEST_FILE = DEFAULT_DIR / 'staged_sha256.json'
# the square staging sizes of the digest: libjpeg's 1, 1/2, 1/4 and 1/8
# DCT scales over the fixtures' 240-640 px sides
DIGEST_SIZES = (300, 150, 64, 38)
SEED = 15
QUALITY = 80
# (width, height, grayscale)
SIZES = ((500, 375, False), (375, 500, False), (500, 333, False),
         (333, 500, False), (500, 500, False), (480, 360, False),
         (640, 480, False), (353, 500, False), (500, 281, False),
         (300, 300, False), (500, 400, False), (442, 500, False),
         (500, 375, True), (400, 300, False), (500, 366, False),
         (320, 240, False))
CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car',
           'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike',
           'person', 'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')


def _image(rng: np.random.RandomState, w: int, h: int):
    from PIL import Image
    small = rng.randint(0, 256, (rng.randint(8, 24), rng.randint(8, 24), 3),
                        dtype=np.uint8)
    img = np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR)).copy()
    objects = []
    for _ in range(rng.randint(1, 5)):
        bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)
        x0, y0 = rng.randint(0, w - bw), rng.randint(0, h - bh)
        patch = rng.randint(0, 256, (max(bh // 16, 2), max(bw // 16, 2), 3),
                            dtype=np.uint8)
        img[y0:y0 + bh, x0:x0 + bw] = np.asarray(
            Image.fromarray(patch).resize((bw, bh), Image.BILINEAR))
        objects.append((CLASSES[rng.randint(len(CLASSES))], x0 + 1, y0 + 1,
                        x0 + bw, y0 + bh, int(rng.rand() < 0.15)))
    return img, objects


def _annotation(name: str, w: int, h: int, depth: int, objects) -> str:
    rows = ''.join(
        f'  <object><name>{cls}</name><difficult>{difficult}</difficult>'
        f'<bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax>'
        f'<ymax>{y1}</ymax></bndbox></object>\n'
        for cls, x0, y0, x1, y1, difficult in objects)
    return (f'<annotation>\n  <folder>VOC2007</folder>\n'
            f'  <filename>{name}.jpg</filename>\n'
            f'  <size><width>{w}</width><height>{h}</height>'
            f'<depth>{depth}</depth></size>\n{rows}</annotation>\n')


def write_fixtures(root: Path) -> list:
    """Write the tree under ``root``; returns the image paths."""
    from PIL import Image
    voc = Path(root) / 'VOC2007'
    for sub in ('JPEGImages', 'Annotations', 'ImageSets/Main'):
        os.makedirs(voc / sub, exist_ok=True)
    rng = np.random.RandomState(SEED)
    ids, paths = [], []
    for k, (w, h, gray) in enumerate(SIZES):
        name = f'fx{k:02d}'
        img, objects = _image(rng, w, h)
        pil = Image.fromarray(img)
        if gray:
            pil = pil.convert('L')
        path = voc / 'JPEGImages' / f'{name}.jpg'
        pil.save(path, quality=QUALITY)
        (voc / 'Annotations' / f'{name}.xml').write_text(
            _annotation(name, w, h, 1 if gray else 3, objects))
        ids.append(name)
        paths.append(str(path))
    sets = {'all': ids,
            'train256': [ids[i] for i in rng.randint(0, len(ids), 256)],
            'eval64': [ids[i] for i in rng.randint(0, len(ids), 64)]}
    for name, entries in sets.items():
        (voc / 'ImageSets' / 'Main' / f'{name}.txt').write_text(
            ''.join(f'{e}\n' for e in entries))
    return paths


def staged_digests(lib: ctypes.CDLL) -> dict:
    """``{'rgb_300': sha256, ..., 'yuv420_38': ...}``: the committed
    fixtures staged by ``lib``'s ``decode_batch`` (``[16, s, s, 3]``) and
    ``decode_batch_yuv420`` (``[16, s*s*3/2]``) at each of
    :data:`DIGEST_SIZES`, at the smallest covering DCT scale, with the
    images' original sizes.  ``lib``'s argument types must be set
    (``data/native.py::load``)."""
    paths = sorted(str(p) for p in
                   (DEFAULT_DIR / 'VOC2007' / 'JPEGImages').glob('*.jpg'))
    names = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    out = {}
    for kind, fn, row in (('rgb', lib.decode_batch, lambda s: s * s * 3),
                          ('yuv420', lib.decode_batch_yuv420,
                           lambda s: s * s * 3 // 2)):
        for s in DIGEST_SIZES:
            staged = np.zeros((len(paths), row(s)), np.uint8)
            sizes = np.zeros((len(paths), 2), np.int32)
            # 4 threads; fast_scale 1, as the loader passes it
            rc = fn(names, len(paths),
                    staged.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), s, s,
                    sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 4, 1)
            if rc < 0 or not sizes.all():
                raise RuntimeError(f'{kind} staging at {s} px failed (rc {rc}, '
                                   f'sizes {sizes.tolist()})')
            out[f'{kind}_{s}'] = hashlib.sha256(
                staged.tobytes() + sizes.tobytes()).hexdigest()
    return out


def write_digest(library: str) -> dict:
    from single_shot_detection_tpu_torch.data import native
    lib = ctypes.CDLL(os.path.abspath(library))
    native.set_argtypes(lib)
    digests = staged_digests(lib)
    DIGEST_FILE.write_text(json.dumps(digests, indent=1, sort_keys=True) + '\n')
    return digests


if __name__ == '__main__':
    if sys.argv[1:2] == ['--digest']:
        print(json.dumps(write_digest(sys.argv[2]), indent=1))
    else:
        write_fixtures(Path(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT_DIR)
