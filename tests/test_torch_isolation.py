"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no source of it (or chip_smoke.py) imports them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                       r"(?!_torch)|from\s+repro\b(?!_torch))", re.M)


def test_import_loads_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.calibrate, repro_torch.optim, repro_torch.runtime, "
            "repro_torch.launch.train, repro_torch.launch.mesh, "
            "repro_torch.parallel\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("module", ["repro_torch.core.comm",
                                    "repro_torch.core.dfft",
                                    "repro_torch.core.api",
                                    "repro_torch.core.fftconv",
                                    "repro_torch.models.blocks",
                                    "repro_torch.models.ssm",
                                    "repro_torch.models.frontend",
                                    "repro_torch.optim.compress",
                                    "repro_torch.models.lm",
                                    "repro_torch.launch.serve",
                                    "repro_torch.configs",
                                    "repro_torch.optim.adamw",
                                    "repro_torch.data.pipeline",
                                    "repro_torch.checkpoint.manager",
                                    "repro_torch.runtime.trainer",
                                    "repro_torch.launch.train",
                                    "repro_torch.parallel.rules",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.parallel.pipeline",
                                    "repro_torch.parallel.pipelined_lm",
                                    "repro_torch.launch.specs",
                                    "repro_torch.launch.dryrun"])
def test_the_distributed_modules_load_neither_jax_nor_the_reference(module):
    """Each module of the distributed layer and of the model stack,
    imported alone with torch.distributed, pulls in no JAX and nothing of
    the JAX package."""
    code = (f"import sys, torch.distributed, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_of_the_port_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              ROOT / "examples" / "fft2d_distributed_torch.py",
              ROOT / "examples" / "quickstart_torch.py",
              ROOT / "examples" / "train_lm_torch.py",
              ROOT / "examples" / "fftconv_lm_torch.py",
              ROOT / "examples" / "serve_lm_torch.py",
              ROOT / "examples" / "pipeline_lm_torch.py",
              ROOT / "scripts" / "dist_times.py",
              ROOT / "scripts" / "dist_train.py",
              ROOT / "scripts" / "dist_serve.py"]
    assert {"comm.py", "dfft.py", "api.py", "fftconv.py", "compress.py",
            "lm.py", "serve.py", "olmo_1b.py", "ssm.py",
            "frontend.py", "adamw.py", "pipeline.py", "manager.py",
            "trainer.py", "train.py", "train_lm_torch.py",
            "fftconv_lm_torch.py", "rules.py", "mesh.py",
            "serve_lm_torch.py", "dist_train.py", "specs.py",
            "dist_serve.py", "pipelined_lm.py", "dryrun.py",
            "pipeline_lm_torch.py"} <= {
                f.name for f in files}
    assert {"parallel/pipeline.py", "data/pipeline.py"} <= {
        f"{f.parent.name}/{f.name}" for f in files}
    assert len(files) > 10
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f}: {hits}"
    assert FORBIDDEN.search("from repro.core import algo")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch import fftn")
