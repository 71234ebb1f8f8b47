"""The benchmark of distributed_faiss_tpu_torch on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything a cell needs is
found by name under this folder: ``configs/<config>.json``,
``traffic/<mix>.json``, ``cells/<cell>.json`` (the operating point) and
``metrics/<metric>.py`` (one reader a per-layer metric).
"""
