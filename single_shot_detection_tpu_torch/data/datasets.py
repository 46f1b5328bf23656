"""Host-side dataset catalogs: VOC / COCO / CustomVoc / Csv / Txt / Concat /
Synthetic.

Port of the JAX package's ``data/datasets.py`` (plain numpy there too, kept
as the port's own copy).  Each dataset parses annotations into a uniform
in-memory catalog; images decode lazily.

Ground-truth row format (framework-wide contract): ``[xmin, ymin, xmax,
ymax, class, score, (difficult)]``, ``NEGATIVE_CLASS = 0`` (class 0 is
background).

Datasets only *catalog* and *decode*: the augmentation runs on the device
(``data/transforms.py``) and the loader pads variable-length ground truth
(``data/loader.py``).  Decoding an image file needs PIL or OpenCV, imported
only when a file is decoded; ``Synthetic`` holds its images in memory and
needs neither.
"""

from __future__ import annotations

import csv as csv_module
import glob
import json
import logging
import os
from typing import Dict, List, Optional, Sequence
from xml.etree import ElementTree

import numpy as np

LOC_INDEX_START = 0
LOC_INDEX_END = 4
CLASS_INDEX = 4
SCORE_INDEX = 5
DIFFICULT_INDEX = 6

NEGATIVE_CLASS = 0


def _decode_image(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 HWC with PIL, or OpenCV when PIL is
    absent; raises ``ImportError`` when neither is installed."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert('RGB'))
    try:
        import cv2
    except ImportError:
        raise ImportError(
            f'decoding {path!r} needs PIL (pillow) or OpenCV (cv2), and '
            f'neither is installed; the Synthetic dataset needs no '
            f'decoding') from None
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class DetectionDataset:
    """Catalog base (parity: detection_dataset.py:20-48)."""

    class_labels: Sequence[str] = ()
    annotations: List[dict]

    def __len__(self):
        return len(self.annotations)

    @property
    def num_classes(self):
        return len(self.class_labels)

    def load_image(self, index: int) -> np.ndarray:
        ann = self.annotations[index]
        if 'image' in ann:
            return ann['image']
        return _decode_image(ann['image_path'])

    def boxes(self, index: int) -> np.ndarray:
        return self.annotations[index]['boxes']


class Voc(DetectionDataset):
    """Pascal VOC (parity: voc.py:11-62)."""

    class_labels = ('background',
                    'aeroplane', 'bicycle', 'bird', 'boat',
                    'bottle', 'bus', 'car', 'cat', 'chair',
                    'cow', 'diningtable', 'dog', 'horse',
                    'motorbike', 'person', 'pottedplant',
                    'sheep', 'sofa', 'train', 'tvmonitor')

    def __init__(self, root: str, image_sets, **_):
        self.annotations = []
        for year, image_set in image_sets:
            list_file = os.path.join(root, f'VOC{year}', 'ImageSets', 'Main',
                                     f'{image_set}.txt')
            logging.info(f'===> Loading {list_file}')
            with open(list_file) as f:
                ids = [line.strip() for line in f if line.strip()]
            for image_id in ids:
                ann_file = os.path.join(root, f'VOC{year}', 'Annotations',
                                        f'{image_id}.xml')
                self.annotations.append(self._parse_annotation(root, year, ann_file))
        logging.info(f'===> Pascal VOC {image_sets} loaded. '
                     f'{len(self)} images total')

    def _parse_annotation(self, root, year, ann_file):
        tree = ElementTree.parse(ann_file).getroot()
        size = tree.find('size')
        width = int(size.findtext('width'))
        height = int(size.findtext('height'))
        rows = []
        for obj in tree.iter('object'):
            bb = obj.find('bndbox')
            rows.append([
                max(int(float(bb.findtext('xmin'))), 0),
                max(int(float(bb.findtext('ymin'))), 0),
                min(int(float(bb.findtext('xmax'))), width - 1),
                min(int(float(bb.findtext('ymax'))), height - 1),
                self.class_labels.index(obj.findtext('name')),
                1.0,
                int(obj.findtext('difficult') or 0),
            ])
        return {
            'image_path': os.path.join(root, f'VOC{year}', 'JPEGImages',
                                       tree.findtext('filename')),
            'width': width,
            'height': height,
            'boxes': np.asarray(rows, dtype=np.float32).reshape(-1, 7),
        }


class Coco(DetectionDataset):
    """COCO instances json, parsed directly without pycocotools
    (parity: coco.py:11-80)."""

    class_labels = ('background',
                    'person', 'bicycle', 'car', 'motorcycle', 'airplane',
                    'bus', 'train', 'truck', 'boat', 'traffic light',
                    'fire hydrant', 'stop sign', 'parking meter', 'bench',
                    'bird', 'cat', 'dog', 'horse', 'sheep', 'cow', 'elephant',
                    'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
                    'handbag', 'tie', 'suitcase', 'frisbee', 'skis',
                    'snowboard', 'sports ball', 'kite', 'baseball bat',
                    'baseball glove', 'skateboard', 'surfboard',
                    'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
                    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich',
                    'orange', 'broccoli', 'carrot', 'hot dog', 'pizza',
                    'donut', 'cake', 'chair', 'couch', 'potted plant', 'bed',
                    'dining table', 'toilet', 'tv', 'laptop', 'mouse',
                    'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
                    'toaster', 'sink', 'refrigerator', 'book', 'clock',
                    'vase', 'scissors', 'teddy bear', 'hair drier',
                    'toothbrush')

    def __init__(self, root: str, image_set: Optional[str] = None,
                 year: int = 2017, val: bool = False,
                 with_crowd: bool = True, **_):
        if image_set is None:
            image_set = 'val' if val else 'train'  # parity: coco.py:42
        ann_path = os.path.join(root, 'annotations',
                                f'instances_{image_set}{year}.json')
        logging.info(f'===> Loading {ann_path}')
        with open(ann_path) as f:
            payload = json.load(f)

        # remap sparse COCO category ids -> contiguous 1..80
        cat_ids = sorted(c['id'] for c in payload['categories'])
        cat_remap = {cid: i + 1 for i, cid in enumerate(cat_ids)}

        images = {img['id']: img for img in payload['images']}
        by_image: Dict[int, list] = {img_id: [] for img_id in images}
        for ann in payload['annotations']:
            if ann.get('iscrowd', 0) and not with_crowd:
                continue
            x, y, w, h = ann['bbox']
            img = images[ann['image_id']]
            # xywh -> xyxy + clip (parity: coco.py:67-80 _fix_boxes)
            x0 = min(max(x, 0), img['width'] - 1)
            y0 = min(max(y, 0), img['height'] - 1)
            x1 = min(max(x + w, 0), img['width'] - 1)
            y1 = min(max(y + h, 0), img['height'] - 1)
            if x1 <= x0 or y1 <= y0:
                continue
            by_image[ann['image_id']].append(
                [x0, y0, x1, y1, cat_remap[ann['category_id']], 1.0])

        self.annotations = []
        for img_id, rows in by_image.items():
            if not rows:
                continue
            img = images[img_id]
            self.annotations.append({
                'image_path': os.path.join(root, f'{image_set}{year}',
                                           img['file_name']),
                'width': img['width'],
                'height': img['height'],
                'boxes': np.asarray(rows, dtype=np.float32).reshape(-1, 6),
            })
        logging.info(f'===> COCO {image_set}{year} loaded. '
                     f'{len(self)} images total')


class CustomVoc(DetectionDataset):
    """Recursive glob of VOC-style XMLs with a user label list
    (parity: custom_voc.py:17-71)."""

    def __init__(self, root: str, labels: Sequence[str],
                 label_map: Optional[dict] = None, **_):
        label_map = label_map or {}
        self.class_labels = tuple(labels)
        self.annotations = []
        skipped = 0
        for ann_file in sorted(glob.glob(os.path.join(root, '**', '*.xml'),
                                         recursive=True)):
            tree = ElementTree.parse(ann_file).getroot()
            size = tree.find('size')
            if size is None:
                skipped += 1
                continue
            width = int(size.findtext('width'))
            height = int(size.findtext('height'))
            rows = []
            for obj in tree.iter('object'):
                name = obj.findtext('name')
                name = label_map.get(name, name)
                if name not in self.class_labels:
                    continue
                bb = obj.find('bndbox')
                rows.append([
                    max(float(bb.findtext('xmin')), 0),
                    max(float(bb.findtext('ymin')), 0),
                    min(float(bb.findtext('xmax')), width - 1),
                    min(float(bb.findtext('ymax')), height - 1),
                    self.class_labels.index(name),
                    1.0,
                ])
            if not rows:
                skipped += 1
                continue
            folder = os.path.dirname(ann_file)
            filename = tree.findtext('filename')
            image_path = os.path.join(folder, filename)
            if not os.path.exists(image_path):
                candidates = glob.glob(os.path.splitext(ann_file)[0] + '.*')
                candidates = [c for c in candidates if not c.endswith('.xml')]
                if not candidates:
                    skipped += 1
                    continue
                image_path = candidates[0]
            self.annotations.append({
                'image_path': image_path,
                'width': width,
                'height': height,
                'boxes': np.asarray(rows, dtype=np.float32).reshape(-1, 6),
            })
        if skipped:
            logging.warning(f'WW CustomVoc: skipped {skipped} annotations')
        logging.info(f'===> CustomVoc loaded. {len(self)} images total')


class Csv(DetectionDataset):
    """``image,xmin,ymin,xmax,ymax[,label[,score]]`` rows grouped by image
    (parity: csv.py:14-41)."""

    def __init__(self, path: str, labels: Sequence[str],
                 label_map: Optional[dict] = None, default_label: int = 1, **_):
        label_map = label_map or {}
        self.class_labels = tuple(labels)
        grouped: Dict[str, list] = {}
        root = os.path.dirname(os.path.abspath(path))
        with open(path) as f:
            for row in csv_module.reader(f):
                if not row or row[0].startswith('#'):
                    continue
                image = row[0]
                coords = [float(v) for v in row[1:5]]
                label = default_label
                if len(row) > 5:
                    name = label_map.get(row[5], row[5])
                    label = (self.class_labels.index(name)
                             if name in self.class_labels else int(row[5]))
                score = float(row[6]) if len(row) > 6 else 1.0
                grouped.setdefault(image, []).append(coords + [label, score])
        self.annotations = [{
            'image_path': image if os.path.isabs(image)
            else os.path.join(root, image),
            'boxes': np.asarray(rows, dtype=np.float32).reshape(-1, 6),
        } for image, rows in grouped.items()]
        logging.info(f'===> Csv {path} loaded. {len(self)} images total')


class Txt(DetectionDataset):
    """One ``.txt`` per image with ``x1 y1 x2 y2 [label [score]]`` lines
    (parity: txt.py:15-63)."""

    def __init__(self, root: str, labels: Sequence[str],
                 label_map: Optional[dict] = None, default_label: int = 1, **_):
        del label_map
        self.class_labels = tuple(labels)
        self.annotations = []
        for txt_file in sorted(glob.glob(os.path.join(root, '**', '*.txt'),
                                         recursive=True)):
            rows = []
            with open(txt_file) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 4:
                        continue
                    coords = [float(v) for v in parts[:4]]
                    label = int(parts[4]) if len(parts) > 4 else default_label
                    score = float(parts[5]) if len(parts) > 5 else 1.0
                    rows.append(coords + [label, score])
            candidates = [c for c in glob.glob(os.path.splitext(txt_file)[0] + '.*')
                          if not c.endswith('.txt')]
            if not candidates or not rows:
                continue
            self.annotations.append({
                'image_path': candidates[0],
                'boxes': np.asarray(rows, dtype=np.float32).reshape(-1, 6),
            })
        logging.info(f'===> Txt {root} loaded. {len(self)} images total')


class ConcatDataset(DetectionDataset):
    """Concatenates datasets under one label set (parity: concat_dataset.py)."""

    def __init__(self, datasets: Sequence[DetectionDataset], **_):
        assert datasets
        labels = datasets[0].class_labels
        for d in datasets[1:]:
            assert d.class_labels == labels, 'label sets must match'
        self.class_labels = labels
        self.annotations = [a for d in datasets for a in d.annotations]
        self._sources = list(datasets)


class Synthetic(DetectionDataset):
    """Procedural dataset: colored rectangles on noise — for tests, smoke
    runs and benchmarks (the reference has no equivalent; our test strategy
    requires data that ships with the repo)."""

    def __init__(self, num_images: int = 64, image_size: int = 300,
                 num_classes: int = 21, max_boxes: int = 6, seed: int = 23,
                 labels: Optional[Sequence[str]] = None, **_):
        rng = np.random.RandomState(seed)
        self.class_labels = (tuple(labels) if labels else
                             tuple(['background'] +
                                   [f'class_{i}' for i in range(1, num_classes)]))
        self.annotations = []
        # class appearance must be split-independent (train and eval share
        # the class->color mapping), so the palette has its own fixed seed
        palette = np.random.RandomState(1234).randint(
            64, 255, size=(num_classes, 3))
        for _ in range(num_images):
            img = rng.randint(0, 48, size=(image_size, image_size, 3),
                              dtype=np.uint8)
            n = rng.randint(1, max_boxes + 1)
            rows = []
            for _ in range(n):
                w = rng.randint(image_size // 8, image_size // 2)
                h = rng.randint(image_size // 8, image_size // 2)
                x0 = rng.randint(0, image_size - w)
                y0 = rng.randint(0, image_size - h)
                cls = rng.randint(1, num_classes)
                img[y0:y0 + h, x0:x0 + w] = palette[cls]
                rows.append([x0, y0, x0 + w - 1, y0 + h - 1, cls, 1.0])
            self.annotations.append({
                'image': img,
                'width': image_size,
                'height': image_size,
                'boxes': np.asarray(rows, dtype=np.float32).reshape(-1, 6),
            })


DATASETS = {
    'Voc': Voc,
    'Coco': Coco,
    'CustomVoc': CustomVoc,
    'Csv': Csv,
    'Txt': Txt,
    'ConcatDataset': ConcatDataset,
    'Synthetic': Synthetic,
}
