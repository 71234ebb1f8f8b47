"""Tensor ops: distances and top-k, scalar codecs, k-means, and the IVF-Flat
list scan (CUDA kernel + plain PyTorch version)."""
