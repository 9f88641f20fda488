"""See the package docstring (ampnet_tpu_torch/__init__.py)."""
