"""The benchmark of ``vuke_tpu_torch``, the PyTorch and CUDA port: one
command a cell (``python3 -m portbench.run``), each cell's configuration,
traffic and per-layer metrics in files of their own.  See README.md."""
