"""Host utilities of the PyTorch port (see livingscenes_tpu_torch/__init__.py)."""
