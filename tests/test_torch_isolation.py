"""The port stands alone: ``repro_torch`` (its LM serving path too),
``chip_smoke.py``, the card-side scripts under ``tools/``, the card tests
(tests/test_torch_cuda.py) and the query modules they and chip_smoke.py
read (tests/torch_*_queries.py), all run on the card's machine, import neither
JAX (nor ``ml_dtypes``) nor anything of the reference package ``repro``."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    # query sources kept as strings (FRAME_SRC, SEG_SRC) are code too
    trees = [tree] + [
        ast.parse(n.value.value, path) for n in tree.body
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
        and isinstance(n.value.value, str)
        and any(getattr(t, "id", "").endswith("_SRC") for t in n.targets)]
    for node in (x for t in trees for x in ast.walk(t)):
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
    tools = os.path.join(ROOT, "tools")
    for f in sorted(os.listdir(tools)):
        if f.endswith(".py"):
            yield os.path.join(tools, f)
    for f in ("test_torch_cuda.py", "torch_frame_queries.py",
              "torch_segmentation_queries.py"):
        yield os.path.join(ROOT, "tests", f)


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
                if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"):
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

        import torch
        from repro_torch.configs import get_reduced
        from repro_torch.launch import steps
        from repro_torch.models import lm
        cfg = get_reduced("qwen3-0.6b")
        model = lm.init_params(cfg, seed=0, device="cpu")
        tokens = torch.zeros((2, 4), dtype=torch.int32)
        logits, caches = steps.make_prefill_step(cfg, 5)(model, {"tokens": tokens})
        logits, caches = steps.make_decode_step(cfg)(
            model, logits.argmax(-1)[:, None].to(torch.int32), caches)
        assert logits.shape == (2, cfg.vocab) and caches["host_index"] == 5
        assert bool(torch.isfinite(logits.float()).all())
        assert not [k for k in sys.modules
                    if k.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")]
        print("ISOLATED_OK")
    ''')
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ISOLATED_OK" in res.stdout
