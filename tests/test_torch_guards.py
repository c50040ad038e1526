"""What the PyTorch port must never do: import jax or the JAX package,
fall back from a kernel to its plain version, or have chip_smoke.py
report success without a card or without the repository around it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from afesp_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "afesp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "afesp_tpu"), f"{path.name} imports {name}"


def test_guard_covers_the_read_in_engine_and_utilities():
    """The import guard scans the read-in, the integral engine and the
    utilities along with everything else of the port."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("io/dat.py", "io/fastparse.py", "ops/packed_eri.py",
                "integrals/__init__.py", "integrals/engine.py", "integrals/generate.py",
                "integrals/basis_data.py", "integrals/fixture_basis.py",
                "utils/__init__.py", "utils/wrapper.py"):
        assert f"afesp_tpu_torch/{mod}" in names, mod


def test_port_runs_with_jax_unimportable():
    """A fresh interpreter in which `import jax` fails imports every port
    module, parses a config and builds a Config of every calc_type."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT_FILES if p.name != "chip_smoke.py"
    )
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['afesp_tpu'] = None",
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m.replace('.__init__', ''))",
        "import chip_smoke",
        "from afesp_tpu_torch.config import parse_els_in, _CALC_TABLE",
        "for c in _CALC_TABLE:",
        "    assert parse_els_in(f'&elsinput\\ncalc_type=\"{c}\",\\n/\\n').calc_type_str == c",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """chip_smoke.py in a directory without the rest of the repository
    exits nonzero and prints no result, card or no card."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_build_raises_without_nvcc(monkeypatch):
    """No compiler, no silent success: the build raises and writes
    nothing into the package."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", Path("/nonexistent/nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", REPO / "afesp_tpu_torch" / "_build_probe")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["triples_fused"])
    assert not (REPO / "afesp_tpu_torch" / "_build_probe").exists()


def test_build_names_track_the_sources():
    names = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert names == {"triples_fused", "triples_finale", "triples_fused_spatial",
                     "triples_tiled_spatial", "triples_finale_spatial"}
    paths = {_build.lib_path(n) for n in names}
    assert len(paths) == 5 and all(p.parent == _build.BUILD_DIR for p in paths)
    assert all(_build._source_hash() in p.name for p in paths)
