"""What the benchmark imports: nothing of JAX, the JAX package, its harness
or its benchmarks (compared by whole top-level name), and, in the
reference and the yardstick, nothing of the port."""

import ast
import pathlib
import subprocess
import sys

from portbench import harness

HERE = pathlib.Path(__file__).resolve().parent
# Modules that decide `correct` or compute the yardstick: they may import
# torch, numpy and each other, never the program.
YARDSTICK = ("reference/*.py", "counts/*.py", "compare.py", "flops.py",
             "hamiltonian.py", "roofline.py", "traffic.py")
YARDSTICK_LOCAL = {"portbench.compare", "portbench.flops",
                   "portbench.hamiltonian", "portbench.roofline",
                   "portbench.traffic"}


def imports(path: pathlib.Path):
  """Every name an `import` or `from ... import` in the file names, the
  latter as module.name (a relative import as portbench's)."""
  names = set()
  for node in ast.walk(ast.parse(path.read_text())):
    if isinstance(node, ast.Import):
      names.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom):
      module = node.module if not node.level else "portbench"
      names.update(f"{module}.{a.name}" for a in node.names)
  return names


def test_no_file_imports_jax_or_the_jax_package():
  for path in HERE.rglob("*.py"):
    tops = {n.split(".")[0] for n in imports(path)}
    assert not tops & harness.FORBIDDEN, (path, tops & harness.FORBIDDEN)


def test_the_yardstick_imports_nothing_of_the_port():
  files = {p for pattern in YARDSTICK for p in HERE.glob(pattern)}
  assert len(files) >= 10
  for path in files:
    for name in imports(path):
      top = name.split(".")[0]
      assert top in {"__future__", "torch", "numpy", "portbench", "math",
                     "contextlib", "importlib", "typing", "dataclasses"}, (
                         path, name)
      if top == "portbench":
        assert (name.startswith("portbench.reference") or
                name in YARDSTICK_LOCAL), (path, name)


def test_a_run_loads_no_forbidden_module():
  code = ("import sys\n"
          "import portbench.run, portbench.harness, portbench.calibrate\n"
          "import portbench.faults, portbench.program.vqt\n"
          "import portbench.program.hea, portbench.program.qaia\n"
          "import portbench.program.bernoulli, portbench.counts.vqt\n"
          "from portbench import registry, trace\n"
          "trace.load_kernels(registry.kernel_names())\n"
          "for p in __import__('pathlib').Path('portbench/metrics').glob("
          "'*.py'):\n"
          "  registry.metric(p.stem)\n"
          "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=HERE.parent, timeout=300)
  assert out.returncode == 0, out.stderr
  loaded = set(eval(out.stdout.strip().splitlines()[-1]))
  assert not loaded & harness.FORBIDDEN, loaded & harness.FORBIDDEN
  assert "qhbmlib_tpu_torch" in loaded


def test_forbidden_names_are_compared_whole():
  assert harness.forbidden_modules(
      ["qhbmlib_tpu_torch.ops", "torch", "jaxtyping", "flaxen"]) == []
  assert harness.forbidden_modules(
      ["qhbmlib_tpu.ops.statevector", "jax._src", "benchmarks.x"]) == [
          "benchmarks", "jax", "qhbmlib_tpu"]
