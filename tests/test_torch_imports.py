"""The port stands alone: importing every module of ``repro_torch`` loads no
JAX, no ``ml_dtypes`` and no module of the reference ``repro``; nor does
``chip_smoke.py``, which refuses to run without a GPU or outside a checkout.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_reference_code():
    mods = list(_modules())
    assert "repro_torch.kernels.scale_search.kernel" in mods
    assert "repro_torch.engine.prefix" in mods
    assert "repro_torch.engine.spec" in mods
    assert "repro_torch.data.synthetic" in mods
    assert "repro_torch.quantize.equalize" in mods
    for m in ("repro_torch.telemetry.metrics", "repro_torch.telemetry.trace",
              "repro_torch.engine.legacy", "repro_torch.checkpoint.store",
              "repro_torch.launch.serve", "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.compress", "repro_torch.launch.steps",
              "repro_torch.launch.train", "repro_torch.pipeline",
              "repro_torch.pipeline.daq_study", "repro_torch.models.ssm",
              "repro_torch.configs.mamba2_780m"):
        assert m in mods, m
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            f"print(bad)\n"
            f"sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_of_the_port_or_the_smoke_script_imports_reference_code():
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_chip_smoke_fails_without_a_gpu_and_outside_a_checkout(tmp_path):
    """The script exits non-zero and prints no result line when CUDA is
    unavailable, and in a directory holding only itself."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd,
                             env=_env(), capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
