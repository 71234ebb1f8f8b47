"""Nothing the harness runs imports JAX or the JAX package (top-level
names compared whole), the reference takes nothing of the port, and no
file under portbench/ reads benchmarks/."""

import ast
import os
import subprocess
import sys

from portbench import spec
from portbench.rank import FORBIDDEN, forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["distributed_faiss_tpu_torch", "distributed_faiss_tpu_torch.ops",
                              "opt_einsum.backends.jax", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["distributed_faiss_tpu.ops.kmeans", "jax.numpy", "jaxlib",
                              "flax.linen"]) == ["distributed_faiss_tpu", "flax", "jax",
                                                 "jaxlib"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "distributed_faiss_tpu"}


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, {root!r});"
            "import portbench.run, portbench.harness, portbench.rank, portbench.control,"
            " portbench.sweep, portbench.readings;"
            "from distributed_faiss_tpu_torch.parallel import client, server;"
            "import glob, importlib.util as u;"
            "[u.spec_from_file_location('m', p).loader.exec_module("
            "u.module_from_spec(u.spec_from_file_location('m', p)))"
            " for p in glob.glob({root!r} + '/portbench/metrics/*.py')];"
            "from portbench.rank import forbidden_modules; print(forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code.format(root=spec.ROOT)],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def imports_of(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_the_reference_takes_nothing_of_the_port():
    for name in ("reference.py", "roofline.py", "corpus.py"):
        tops = {n.split(".")[0] for n in imports_of(os.path.join(spec.HERE, name))}
        assert tops <= {"numpy", "torch"}, (name, tops)


def test_nothing_reads_benchmarks():
    for dirpath, _dirs, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith((".py", ".json")) and "tests" not in dirpath:
                text = open(os.path.join(dirpath, f)).read()
                assert "benchmarks/" not in text.replace("benchmarks/baseline_configs.py", ""), f
                tops = {n.split(".")[0] for n in imports_of(os.path.join(dirpath, f))} \
                    if f.endswith(".py") else set()
                assert not tops & set(FORBIDDEN) | {"benchmarks"} & tops, f


def test_run_without_a_card_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
                          "sift1m-ivfsq.r95", "--seed", str(2**33), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=str(tmp_path),
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
