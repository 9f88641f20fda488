"""Offline preprocessing of LAS tiles, the port's own copy of
``ampnet_tpu/preproc``: window split, height above ground, filter and
normalise, the geometric eigenfeature columns, balanced k-means tiling and
split lists (``pipeline.py`` chains them per tile)."""
