"""Data parallelism over processes (``mesh``), the window-axis forward
(``window_shard``) and the multi-process check (``multihost_check``):
counterparts of ``ampnet_tpu/parallel/``."""
