"""distributed_faiss_tpu_torch — the PyTorch/CUDA port of distributed_faiss_tpu.

The JAX package beside it stays the reference. This package carries the
same layout and names (``ops/``, ``models/``, ``engine.py``,
``serving/``, ``parallel/``, ``utils/``) so each module has an obvious
counterpart, but speaks PyTorch inside: plain functions on tensors, an
explicit ``device`` on models, the engine and ``IndexServer``, and explicit
``torch.Generator``s. Entry points default to ``device="cuda"`` and raise
when CUDA is absent; tests pass ``device="cpu"``.

The IVF-Flat list scan and the ADC scans of IVF-PQ and flat PQ run as
hand-written CUDA kernels for ``sm_90a`` (``csrc/flat_scan.cu``,
``csrc/adc_scan.cu``, built with nvcc at first use into
``build/torch_kernels/``). On CPU tensors the same wrappers run their
plain PyTorch versions.

Nothing here imports jax or the JAX package. Imports are lazy (PEP 562).
"""

__version__ = "0.1.0"

_LAZY = {
    "IndexCfg": ("distributed_faiss_tpu_torch.utils.config", "IndexCfg"),
    "IndexState": ("distributed_faiss_tpu_torch.utils.state", "IndexState"),
    "SchedulerCfg": ("distributed_faiss_tpu_torch.utils.config", "SchedulerCfg"),
    "WireCfg": ("distributed_faiss_tpu_torch.utils.config", "WireCfg"),
    "Index": ("distributed_faiss_tpu_torch.engine", "Index"),
    "IndexServer": ("distributed_faiss_tpu_torch.parallel.server", "IndexServer"),
    "IndexClient": ("distributed_faiss_tpu_torch.parallel.client", "IndexClient"),
    "MultiRankError": ("distributed_faiss_tpu_torch.parallel.client", "MultiRankError"),
    "QuorumError": ("distributed_faiss_tpu_torch.parallel.client", "QuorumError"),
    "ReplicationCfg": ("distributed_faiss_tpu_torch.utils.config", "ReplicationCfg"),
    "AntiEntropyCfg": ("distributed_faiss_tpu_torch.utils.config", "AntiEntropyCfg"),
    "TracingCfg": ("distributed_faiss_tpu_torch.utils.config", "TracingCfg"),
    "RetryPolicy": ("distributed_faiss_tpu_torch.parallel.rpc", "RetryPolicy"),
    "BusyError": ("distributed_faiss_tpu_torch.parallel.rpc", "BusyError"),
    "DeadlineExceeded": ("distributed_faiss_tpu_torch.parallel.rpc", "DeadlineExceeded"),
    "SearchScheduler": ("distributed_faiss_tpu_torch.serving.scheduler",
                        "SearchScheduler"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
