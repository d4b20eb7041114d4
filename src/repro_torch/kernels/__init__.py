"""Hand-written CUDA kernels of the serving path (``csrc/``), their plain
PyTorch versions (``ref``) and the device-dispatching wrappers (``ops``)."""
