"""The PyTorch port imports without JAX.

The test process has imported jax already (tests/conftest.py), so the
import is checked in a fresh interpreter."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "markovmodels_tpu_torch"


@pytest.mark.parametrize("module", [
    "markovmodels_tpu_torch",
    "markovmodels_tpu_torch.ops.block_scan",
    "markovmodels_tpu_torch.ops.banded_scan",
    "markovmodels_tpu_torch.ops.dense_scan",
    "markovmodels_tpu_torch.ops._build",
])
def test_port_imports_without_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "import markovmodels_tpu_torch as mt\n"
        "assert callable(mt.pdfposteriors) and callable(mt.compile_fsm)\n"
        "assert callable(mt.lfmmi_loss) and callable(mt.stack)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'markovmodels_tpu.inference')\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_port_sources():
    files = sorted(PKG.rglob("*.py"))
    assert files
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, line)
            assert "markovmodels_tpu.inference" not in s, (f, line)
