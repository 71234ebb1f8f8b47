"""Tensor ops: distances and top-k, scalar codecs, k-means, product
quantization, and the two scans that run as CUDA kernels beside their
plain PyTorch versions: the IVF-Flat list scan and the PQ ADC scan."""
