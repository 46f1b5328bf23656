"""Port parity for the data path: the dataset catalogs and the loader,
against the JAX package on the same inputs.

Tolerances: catalogs, decoded images, ``Synthetic`` arrays and loader
batches (order, staged pixels, padding, ids) exactly equal.
"""

import json

import numpy as np
import pytest

from single_shot_detection_tpu.data import datasets as jax_datasets
from single_shot_detection_tpu.data.loader import Loader as JaxLoader
from single_shot_detection_tpu.data.loader import create_loaders as jax_create_loaders
from single_shot_detection_tpu_torch.data import datasets as pt_datasets
from single_shot_detection_tpu_torch.data.loader import Loader, create_loaders
from _torch_port_fixtures import one_torch_thread  # noqa: F401


# ------------------------------------------------------------ datasets

@pytest.mark.parametrize('kwargs', [
    dict(num_images=5, image_size=64, num_classes=5, max_boxes=3, seed=1),
    dict(num_images=3, image_size=500, num_classes=21, max_boxes=6, seed=2),
])
def test_synthetic_arrays_equal(kwargs):
    want = jax_datasets.Synthetic(**kwargs)
    got = pt_datasets.Synthetic(**kwargs)
    assert got.class_labels == want.class_labels and len(got) == len(want)
    for a, b in zip(got.annotations, want.annotations):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


VOC_XML = """<annotation>
  <filename>{name}.png</filename>
  <size><width>100</width><height>80</height><depth>3</depth></size>
  <object>
    <name>{cls}</name><difficult>0</difficult>
    <bndbox><xmin>10</xmin><ymin>20</ymin><xmax>50.7</xmax><ymax>60</ymax></bndbox>
  </object>
  <object>
    <name>car</name><difficult>1</difficult>
    <bndbox><xmin>-5</xmin><ymin>5</ymin><xmax>200</xmax><ymax>70</ymax></bndbox>
  </object>
</annotation>"""


def write_png(path, seed, w=100, h=80):
    from PIL import Image
    pixels = np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(path)


def write_tree(root, kind):
    """A tiny dataset of ``kind`` with PNG images; returns the dataset
    constructor's keyword arguments."""
    labels = ['background', 'dog', 'car']
    if kind == 'Voc':
        for sub in ('ImageSets/Main', 'Annotations', 'JPEGImages'):
            (root / 'VOC2007' / sub).mkdir(parents=True)
        ids = ['000001', '000002', '000003']
        (root / 'VOC2007/ImageSets/Main/trainval.txt').write_text('\n'.join(ids))
        for n, i in enumerate(ids):
            (root / 'VOC2007/Annotations' / f'{i}.xml').write_text(
                VOC_XML.format(name=i, cls=('dog', 'cat', 'bus')[n]))
            write_png(root / 'VOC2007/JPEGImages' / f'{i}.png', n)
        return {'root': str(root), 'image_sets': [(2007, 'trainval')]}
    if kind == 'Coco':
        (root / 'annotations').mkdir(parents=True)
        (root / 'val2017').mkdir()
        payload = {
            'images': [{'id': 1, 'file_name': 'a.png', 'width': 100, 'height': 80},
                       {'id': 7, 'file_name': 'b.png', 'width': 100, 'height': 80},
                       {'id': 9, 'file_name': 'c.png', 'width': 100, 'height': 80}],
            'annotations': [
                {'image_id': 1, 'category_id': 18, 'bbox': [10, 20, 30, 30], 'iscrowd': 0},
                {'image_id': 1, 'category_id': 18, 'bbox': [0, 0, 5, 5], 'iscrowd': 1},
                {'image_id': 7, 'category_id': 1, 'bbox': [90, 70, 40, 40], 'iscrowd': 0},
                {'image_id': 9, 'category_id': 1, 'bbox': [50, 50, 0, 10], 'iscrowd': 0},
            ],
            'categories': [{'id': 18, 'name': 'dog'}, {'id': 1, 'name': 'person'}],
        }
        (root / 'annotations/instances_val2017.json').write_text(json.dumps(payload))
        for n, name in enumerate('abc'):
            write_png(root / f'val2017/{name}.png', n)
        return {'root': str(root), 'val': True, 'with_crowd': False}
    root.mkdir()
    if kind == 'CustomVoc':
        for n, cls in enumerate(('doggo', 'car')):
            (root / f'img{n}.xml').write_text(VOC_XML.format(name=f'img{n}', cls=cls))
            write_png(root / f'img{n}.png', n)
        return {'root': str(root), 'labels': labels, 'label_map': {'doggo': 'dog'}}
    if kind == 'Csv':
        write_png(root / 'i.png', 0)
        write_png(root / 'j.png', 1)
        (root / 'data.csv').write_text('i.png,1,2,30,40,dog\ni.png,5,6,20,22,car,0.5\n'
                                       '# a comment\nj.png,3,3,9,9,2\n')
        return {'path': str(root / 'data.csv'), 'labels': labels}
    assert kind == 'Txt'
    write_png(root / 'x.png', 0)
    (root / 'x.txt').write_text('1 2 30 40 2\n3 4 10 12\n')
    return {'root': str(root), 'labels': labels}


@pytest.mark.parametrize('kind', ['Voc', 'Coco', 'CustomVoc', 'Csv', 'Txt'])
def test_catalogs_and_loader_batches_equal(tmp_path, kind):
    """Equal catalogs and decoded images; for VOC and COCO also equal loader
    batches (PNG files take the JAX loader's Python decode path)."""
    kwargs = write_tree(tmp_path / kind.lower(), kind)
    want = jax_datasets.DATASETS[kind](**kwargs)
    got = pt_datasets.DATASETS[kind](**kwargs)
    assert got.class_labels == want.class_labels and len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got.annotations, want.annotations)):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f'{kind} {i} {key}')
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
    if kind in ('Voc', 'Coco'):
        kw = dict(batch_size=2, staging_size=(64, 64), max_gt=3, num_workers=2)
        assert_batches_equal(Loader(got, **kw), JaxLoader(want, **kw))


def test_package_imports_without_cv2_and_pil(tmp_path):
    """cv2 and PIL are imported only inside ``_decode_image``, which names
    both when neither is there."""
    import subprocess
    import sys
    write_png(tmp_path / 'a.png', 0)
    code = (
        "import sys\n"
        "for name in ('cv2', 'PIL', 'jax', 'flax'):\n"
        "    sys.modules[name] = None\n"
        "from single_shot_detection_tpu_torch.train.engine import Experiment\n"
        "from single_shot_detection_tpu_torch.data import datasets\n"
        f"datasets.Synthetic(num_images=1, image_size=32).load_image(0)\n"
        "try:\n"
        f"    datasets._decode_image({str(tmp_path / 'a.png')!r})\n"
        "except ImportError as exc:\n"
        "    assert 'PIL' in str(exc) and 'cv2' in str(exc), exc\n"
        "    print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


# -------------------------------------------------------------- loader

def assert_batches_equal(got_loader, want_loader, epochs=(0,)):
    assert len(got_loader) == len(want_loader)
    for epoch in epochs:
        got_loader.epoch = want_loader.epoch = epoch
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(want_loader)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize('image_size', [64, 100])
def test_loader_batches_equal_jax(image_size):
    """Order, padding, ids and staged pixels bit for bit, with a partial eval
    batch, over two shuffled epochs; 100 px stages a real resize to 64."""
    kw = dict(num_images=13, image_size=image_size, num_classes=5, max_boxes=4,
              seed=3)
    want_ds, got_ds = jax_datasets.Synthetic(**kw), pt_datasets.Synthetic(**kw)
    args = dict(batch_size=4, staging_size=(64, 64), shuffle=True, max_gt=3,
                seed=5, num_workers=2)
    want, got = jax_create_loaders({'train': want_ds, 'eval': want_ds}, **args), \
        create_loaders({'train': got_ds, 'eval': got_ds}, **args)
    assert (len(got['train']), len(got['eval'])) == (3, 2)
    assert_batches_equal(got['train'], want['train'], epochs=(0, 1))
    assert_batches_equal(got['eval'], want['eval'])
    last = list(got['eval'])[-1]
    assert (last['ids'] == -1).sum() == 3 and not last['box_mask'][-3:].any()


def test_loader_reraises_errors_and_raises_on_unported(tmp_path):
    """A decode error reaches the consumer.  The YUV420 staging and the
    staging cache, which raised before they were ported, run: their parity
    with the JAX loader is in ``test_torch_port_data_extras.py``."""
    class Broken(pt_datasets.Synthetic):
        def load_image(self, index):
            raise OSError(f'cannot read {index}')

    loader = Loader(Broken(num_images=4, image_size=32), batch_size=2,
                    staging_size=(32, 32))
    with pytest.raises(OSError, match='cannot read'):
        list(loader)
    ds = pt_datasets.Synthetic(num_images=2, image_size=32)
    batch = next(iter(Loader(ds, 2, (32, 32), staging_colorspace='yuv420')))
    assert batch['image'].shape == (2, 32 * 32 * 3 // 2)
    loaders = create_loaders({'train': ds}, 2, (32, 32),
                             cache_dir=str(tmp_path / 'x'))
    list(loaders['train'])
    assert loaders['train'].cache.complete
    assert (tmp_path / 'x' / 'train' / 'meta.json').exists()
