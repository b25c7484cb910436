"""PyTorch/CUDA port of the ``repro`` package (Assise session state on an
NVIDIA H100).

The layout mirrors ``repro``: ``core`` (the simulated Assise cluster),
``configs``, ``ckpt`` (checkpoints through the cluster), ``kernels``
(hand-written CUDA kernels plus their plain PyTorch versions), ``models``
and ``launch``. Nothing here imports JAX or any module of ``repro``.
"""
