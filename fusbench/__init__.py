"""The benchmark of the PyTorch/CUDA port: one cell a run (``python3 -m fusbench.run``)."""
