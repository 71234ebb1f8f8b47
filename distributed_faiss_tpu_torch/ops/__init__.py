"""Tensor ops: distances and top-k, scalar codecs, k-means, product
quantization, the OPQ rotation, and the scans that run as CUDA kernels
beside their plain PyTorch versions: the IVF-Flat list scan and the PQ ADC
scans (per-pair lists and one shared list)."""
