"""Nothing a run loads is JAX, jaxlib, flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""
import ast
import subprocess
import sys

from portbench.bench import harness

BLOCK = """
import importlib.abc, sys
FORBIDDEN = {"jax", "jaxlib", "flax", "livingscenes_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
"""


def run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", BLOCK % str(harness.ROOT) + code],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_names_compared_whole():
    mods = ["livingscenes_tpu_torch", "livingscenes_tpu_torch.ops", "jax.numpy", "jaxlib",
            "livingscenes_tpu.models", "flaxen", "jaxtyping", "flax"]
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib",
                                               "livingscenes_tpu.models"]


def test_a_run_loads_nothing_forbidden():
    out = run("""
import json, pathlib
import portbench.bench.harness as h
import portbench.bench.relocalize, portbench.bench.readings, portbench.bench.faults
import livingscenes_tpu_torch.models.shape_prior, livingscenes_tpu_torch.solver.pipeline
m = json.loads((h.ROOT / "BENCHMARK.json").read_text())
for w in m["workloads"]:
    parts = h.cell_parts(m, w["name"])
    __import__("portbench.bench." + parts["traffic"]["driver"])
for p in (h.BENCH / "metrics").glob("*.py"):
    import importlib.util
    spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(h.forbidden_modules(sys.modules))
""")
    assert out.strip() == "[]"


def test_reference_imports_nothing_of_the_port():
    for path in (harness.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("livingscenes_tpu_torch", "livingscenes_tpu",
                                                  "jax", "jaxlib", "flax"), (path, name)
    out = run("""
import portbench.reference.relocalize, portbench.reference.encoders
print(sorted({m.split(".")[0] for m in sys.modules} & {"livingscenes_tpu_torch"}))
""")
    assert out.strip() == "[]"
