"""Layers and the serving path's kernels, each kernel beside its plain
PyTorch version (``*_reference``)."""
