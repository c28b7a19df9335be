"""Nothing of the benchmark loads JAX or the JAX package, and the reference
imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from flowbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_optical_flow_2_tpu"}
PORT = "cuda_optical_flow_2_torch"


def _top_levels_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=spec.ROOT.parent, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_dry_import_of_every_module_loads_no_jax():
    files = sorted(p for p in spec.ROOT.rglob("*.py") if "tests" not in p.parts)
    code = "\n".join([
        "import torch, importlib",
        "from flowbench import spec",
        "from flowbench.port import Port",
        *[f"spec.module_at(spec.ROOT / {str(p.relative_to(spec.ROOT))!r})" for p in files],
        "bench = spec.load_benchmark()",
        "for w in bench['workloads']:",
        "    c = spec.load_cell(w['name'])",
        "    Port(c.config)",
    ])
    loaded = _top_levels_after(code)
    assert PORT in loaded  # the port itself was imported too
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_neither_port_nor_jax():
    for path in (spec.ROOT / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {PORT}, (path, name)
    loaded = _top_levels_after(
        "import flowbench.reference.lk, flowbench.reference.tvl1, flowbench.reference.ops")
    assert not loaded & (FORBIDDEN | {PORT})


def test_top_level_names_compare_whole():
    from flowbench.run import forbidden_modules

    sys.modules.setdefault("jaxfake_module_for_test", sys)
    try:
        assert "jaxfake_module_for_test" not in forbidden_modules()
    finally:
        del sys.modules["jaxfake_module_for_test"]
