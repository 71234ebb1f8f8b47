#!/usr/bin/env python3
"""Packaging (parity: reference setup.py; deps swapped for the TPU stack)."""

from setuptools import find_packages, setup

with open("README.md") as f:
    readme = f.read()

setup(
    name="distributed_faiss_tpu",
    version="0.1.0",
    description="TPU-native distributed approximate nearest-neighbor search",
    long_description=readme,
    long_description_content_type="text/markdown",
    license="MIT",
    python_requires=">=3.10",
    packages=find_packages(exclude=("tests", "scripts")),
    # the PyTorch/CUDA port builds its kernels from these sources at first use
    package_data={"distributed_faiss_tpu_torch": ["csrc/*.cu"]},
    install_requires=[
        "jax",
        "numpy",
    ],
    extras_require={
        "slurm": ["submitit>=1.1.5"],
        "dev": ["pytest"],
        "torch": ["torch"],
    },
)
