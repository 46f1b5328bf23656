"""Command-line tools of the port: the consumers of exported artifacts
(``infer_exported``, ``serve``), which load a standalone ``.pt2`` artifact
through ``export/__init__.py``'s loader and import ``torch`` and
``ops/nms_kernel.py`` (the NMS op the program names) and no model code or
config; ``stage_dataset``, which fills the on-disk staging cache of a
config's datasets; and ``make_jpeg_fixtures``, which wrote the JPEG
fixtures under ``data/jpeg_fixtures``.
"""
