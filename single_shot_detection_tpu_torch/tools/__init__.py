"""Command-line tools of the port: the consumers of exported artifacts
(``infer_exported``, ``serve``), which load a standalone ``.pt2`` artifact
through ``export/__init__.py``'s loader and import ``torch`` and
``ops/nms_kernel.py`` (the NMS op the program names) and no model code or
config; ``stage_dataset``, which fills the on-disk staging cache of a
config's datasets; ``resize_to_smallest``, which shrinks a VOC-layout
dataset offline; ``export_torch_ckpt``, which writes a checkpoint as the
reference's torch checkpoint; ``make_jpeg_fixtures``, which wrote the
JPEG fixtures under ``data/jpeg_fixtures`` and their staged digest; and
the accuracy protocol: ``parity_run``, which stages synthetic data, trains
the port on it from scratch through the CLI and reads the held-out mAP,
``parity_stats``, which pools such runs, and ``ema_ablation``,
``gn_ablation`` and ``qat_ablation``, which train each seed with and
without an option.
"""
