"""Build and binding of the port's hand-written CUDA kernels (``csrc/``):
see :mod:`medt_tpu_torch.kernels.build`."""
