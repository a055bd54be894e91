"""Nothing the benchmark runs imports JAX or the JAX package, comparing
top-level module names whole (`vectorx_tpu_torch` begins with
`vectorx_tpu`), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "vectorx_tpu"}
BENCH = os.path.join(ROOT, "prover_bench")


def sources(under: str):
    for d, _dirs, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        assert not top_level_imports(path) & BANNED, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        names = top_level_imports(path)
        assert not names & (BANNED | {"vectorx_tpu_torch", "prover_bench"}), \
            path
        assert "vectorx_tpu_torch" not in open(path).read().replace(
            "`vectorx_tpu_torch`", ""), path


DRY_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from prover_bench import harness
root, spec = {tiny!r}, json.loads({spec!r})
r = harness.run_cell(root, spec, {cell!r}, 11, 0.0, {trace}, "cpu",
                     time.perf_counter())
assert r["correct"], r
print(json.dumps(sorted(sys.modules)))
"""


@pytest.mark.parametrize("cell", ["header_range_256.roots",
                                  "rotate_300.machine_fri"])
def test_a_dry_run_loads_no_jax(tiny, cell):
    """A CPU run of each cell, traced (every reader and span loaded), in a
    process of its own: no module of JAX or of the JAX package."""
    root, s = tiny
    code = DRY_RUN.format(root=ROOT, tiny=root, spec=json.dumps(s), cell=cell,
                          trace=True)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {m for m in loaded if m.split(".")[0] in BANNED}
    assert "prover_bench.reference" in loaded


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import prover_bench.reference as r; "
            "from prover_bench.reference import prover, fri, sha256_air; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('vectorx_tpu_torch', 'vectorx_tpu', 'jax')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
