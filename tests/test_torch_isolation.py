"""The PyTorch port stands alone: importing any of its modules (or
chip_smoke.py) pulls in neither JAX nor the JAX package, and no source
file names either."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print(len(names), bad)
"""


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"),
                                             root=str(ROOT))],
        capture_output=True, text=True, check=True, timeout=300,
        cwd=str(ROOT)).stdout.split("\n")[-2]
    count, bad = out.split(" ", 1)
    assert int(count) >= 30, out
    assert bad == "[]", out


def test_no_port_source_names_jax_or_the_reference_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip())
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_importing_the_kernels_builds_nothing():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from repro_torch.kernels import build, fused, ops\n"
            "print(build._LIB is None)" % str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout.strip()
    assert out == "True"
