"""The port stands on its own: nothing under hipstr_tpu_torch/, and not
chip_smoke.py, imports JAX or any module of the JAX package (hipstr_tpu),
not even lazily inside a function, and importing the port's entry points
loads neither.
"""

import ast
import os
import subprocess
import sys

import pytest

from test_torch_slice import ONE_THREAD, ROOT, one_torch_thread  # noqa: F401

FORBIDDEN = ("jax", "hipstr_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "hipstr_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def _forbidden_imports(path):
    """(line, module) of every import of a FORBIDDEN package in `path`: import
    statements anywhere in the file, and importlib.import_module /
    __import__ calls with a literal name."""
    tree = ast.parse(open(path).read(), path)
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if fname in ("import_module", "__import__"):
                names = [node.args[0].value]
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return found


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 40          # the copied host layers are scanned too
    bad = {os.path.relpath(f, ROOT): hits for f in files
           if (hits := _forbidden_imports(f))}
    assert not bad, bad


def test_the_scan_sees_lazy_imports(tmp_path):
    """The scan finds an import inside a function and a literal
    import_module call (a check of the check above)."""
    src = tmp_path / "m.py"
    src.write_text("import importlib\n"
                   "def f():\n"
                   "    from hipstr_tpu.io import bam\n"
                   "    return importlib.import_module('jax.numpy')\n")
    assert _forbidden_imports(str(src)) == [(3, "hipstr_tpu.io"),
                                            (4, "jax.numpy")]


@pytest.mark.parametrize("modules", [
    ["hipstr_tpu_torch.cli", "hipstr_tpu_torch.pipeline.sequential",
     "hipstr_tpu_torch.parallel.executor", "hipstr_tpu_torch.utils.simdata",
     "hipstr_tpu_torch.ops.em_batched", "hipstr_tpu_torch.parallel.workers"],
    ["hipstr_tpu_torch.denovo_finder", "hipstr_tpu_torch.phasing_checker",
     "hipstr_tpu_torch.scripts.annotate_denovo"],
    ["hipstr_tpu_torch.parallel.distributed", "hipstr_tpu_torch.pipeline.pdf",
     "hipstr_tpu_torch.scripts.filter_vcf",
     "hipstr_tpu_torch.scripts.get_stutter_models"],
    ["hipstr_tpu_torch.bench", "hipstr_tpu_torch.tools.soak",
     "hipstr_tpu_torch.tools.profile_host",
     "hipstr_tpu_torch.tools.decode_bench"],
    ["hipstr_tpu_torch.graft_entry"]],
    ids=["entry-points", "denovo-entry-points", "scale-out-and-scripts",
         "measuring-entry-points", "graft-entry"])
def test_importing_the_port_loads_no_jax(modules):
    script = ("import importlib, sys\n"
              f"for m in {modules!r}:\n"
              "    importlib.import_module(m)\n"
              "bad = sorted(m for m in sys.modules if sys.modules[m] is not "
              "None and m.split('.')[0] in ('jax', 'hipstr_tpu'))\n"
              "assert not bad, bad\n"
              "print('loaded', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("loaded")
