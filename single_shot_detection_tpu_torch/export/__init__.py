"""Int8 serving and quantization-aware training (``quantize.py``).

Port of the JAX package's ``export/`` for its ``quantize`` module; the model
export (``export/__init__.py``'s ``make_inference_fn``, ``export_model``) is
not ported yet.
"""
