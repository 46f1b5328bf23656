"""Serving-side preprocessing of staged uint8 images."""
