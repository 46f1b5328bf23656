"""Consumers of exported artifacts: ``infer_exported`` and ``serve``.

They load a standalone ``.pt2`` artifact through ``export/__init__.py``'s
loader, which imports ``torch`` and ``ops/nms_kernel.py`` (the NMS op the
program names), and no model code or config.
"""
