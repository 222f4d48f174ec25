"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the card
tests (tests/test_torch_cuda.py, run on the card's machine) import neither
JAX nor anything of the reference package ``repro``."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
BLOCKED = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tests", "test_torch_cuda.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path} imports {bad}"


def test_port_runs_with_jax_and_repro_blocked():
    script = textwrap.dedent('''
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        from repro_torch import hiframes as hf
        from repro_torch.data import synth
        t = synth.relational_tables(500, 20, seed=0)
        df = hf.table(t)
        out = hf.aggregate(df[df.x < 0.5], "id", s=hf.sum_(df["y"]),
                           n=hf.count()).collect(hf.ExecConfig(device="cpu"))
        got = out.to_numpy()
        m = t["x"] < np.float32(0.5)
        assert got["n"].sum() == m.sum()
        assert not [k for k in sys.modules
                    if k.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("ISOLATED_OK")
    ''')
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ISOLATED_OK" in res.stdout
