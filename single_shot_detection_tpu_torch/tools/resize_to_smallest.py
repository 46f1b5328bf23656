"""Shrink a VOC-layout dataset offline so each image's smallest side is a
target, rewriting its XML annotation to the new geometry.

    python -m single_shot_detection_tpu_torch.tools.resize_to_smallest \
        --root VOCdevkit --size 300 --output VOC300

Port of the JAX package's ``tools/resize_to_smallest.py``, with its flags
and its behaviour: every ``*.xml`` under ``--root`` (recursively) names its
image in ``<filename>``, which is looked up in the XML's own directory; an
image whose smallest side is at or under ``--size``, or that is not
there, is left alone; otherwise PIL's ``BILINEAR`` resizes it to
``round(side * size / smallest)`` and it is saved, with its XML, under
``--output`` by its base name, each box coordinate
``int(round(v * scale))``.  A thread pool of ``--workers`` does the files.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence
from xml.etree import ElementTree


def resize_one(xml_path: str, target: int, output: str) -> bool:
    """Resize one annotation's image and rewrite the annotation into
    ``output``; False when it was left alone."""
    tree = ElementTree.parse(xml_path)
    root = tree.getroot()
    size = root.find('size')
    width = int(size.findtext('width'))
    height = int(size.findtext('height'))
    smallest = min(width, height)
    if smallest <= target:
        return False
    scale = target / smallest
    new_w, new_h = round(width * scale), round(height * scale)

    image_path = os.path.join(os.path.dirname(xml_path),
                              root.findtext('filename'))
    if not os.path.exists(image_path):
        return False

    from PIL import Image
    with Image.open(image_path) as im:
        im = im.resize((new_w, new_h), Image.BILINEAR)
        os.makedirs(output, exist_ok=True)
        im.save(os.path.join(output, os.path.basename(image_path)))

    size.find('width').text = str(new_w)
    size.find('height').text = str(new_h)
    for obj in root.iter('object'):
        bb = obj.find('bndbox')
        for tag in ('xmin', 'ymin', 'xmax', 'ymax'):
            el = bb.find(tag)
            el.text = str(int(round(float(el.text) * scale)))
    tree.write(os.path.join(output, os.path.basename(xml_path)))
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m single_shot_detection_tpu_torch.tools.resize_to_smallest')
    parser.add_argument('--root', required=True,
                        help='Directory searched recursively for *.xml')
    parser.add_argument('--size', type=int, required=True,
                        help='Target smallest-side size')
    parser.add_argument('--output', required=True)
    parser.add_argument('--workers', type=int, default=8)
    args = parser.parse_args(argv)

    xmls = glob.glob(os.path.join(args.root, '**', '*.xml'), recursive=True)
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        results = list(pool.map(
            lambda p: resize_one(p, args.size, args.output), xmls))
    print(f'resized {sum(results)}/{len(xmls)} images')
    return 0


if __name__ == '__main__':
    sys.exit(main())
