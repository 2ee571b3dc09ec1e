"""The PyTorch port imports neither JAX nor the JAX package nor the
benchmark: it keeps its own host layer and f64 oracle.

The test process has imported jax and the JAX package already
(tests/conftest.py, tests/_torch_port.py), so the import is checked in a
fresh interpreter; the sources are scanned for such imports too."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "markovmodels_tpu_torch"

# what a module of the port (or chip_smoke.py) may not bring into
# sys.modules: jax, the JAX package (any module but the port's own) and
# the benchmark
_FORBIDDEN = (
    "bad = sorted(m for m in sys.modules if m == 'jax' "
    "or m.startswith(('jax.', 'jaxlib')) or m == 'bench' "
    "or m == 'markovmodels_tpu' or m.startswith('markovmodels_tpu.'))\n"
    "assert not bad, bad\n"
)


@pytest.mark.parametrize("module", [
    "markovmodels_tpu_torch",
    "markovmodels_tpu_torch.ops.block_scan",
    "markovmodels_tpu_torch.ops.banded_scan",
    "markovmodels_tpu_torch.ops.dense_scan",
    "markovmodels_tpu_torch.ops._build",
    "markovmodels_tpu_torch.ops.vit_scan",
    "markovmodels_tpu_torch.viterbi",
    "markovmodels_tpu_torch.oracle",
    "markovmodels_tpu_torch.workloads",
    "chip_smoke",
])
def test_port_imports_without_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "import markovmodels_tpu_torch as mt\n"
        "assert callable(mt.pdfposteriors) and callable(mt.compile_fsm)\n"
        "assert callable(mt.lfmmi_loss) and callable(mt.stack)\n"
        "assert callable(mt.viterbi) and mt.best_path is mt.viterbi\n"
        + _FORBIDDEN
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_every_port_module_imports_without_jax():
    """Every module file of the package, imported in one fresh
    interpreter."""
    mods = sorted(
        ".".join(f.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for f in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n" + _FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


_BAD_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b"
    r"|import\s+markovmodels_tpu(?!_torch)\b|from\s+markovmodels_tpu(?!_torch)\b"
    r"|import\s+bench\b|from\s+bench\b)")


def test_no_jax_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            assert not _BAD_IMPORT.match(line), (f, line)
            assert "markovmodels_tpu.inference" not in line, (f, line)


def test_the_source_scan_catches_each_form():
    for line in ("import jax", "from jax import numpy", "import bench",
                 "    from bench import host_oracle",
                 "import markovmodels_tpu as mm",
                 "from markovmodels_tpu import hostsparse",
                 "from markovmodels_tpu.fsm import FSM"):
        assert _BAD_IMPORT.match(line), line
    for line in ("import markovmodels_tpu_torch as mt",
                 "from markovmodels_tpu_torch import oracle",
                 "import benchmark_tools", "# import jax"):
        assert not _BAD_IMPORT.match(line), line
