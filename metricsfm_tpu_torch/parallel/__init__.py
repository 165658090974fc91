"""parallel of the PyTorch port (see metricsfm_tpu_torch/__init__.py)."""
