"""Hand-written CUDA kernels for sm_90a (``csrc/``), their wrappers, and
the plain PyTorch versions they are held against (``ref.py``)."""
