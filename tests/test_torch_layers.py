"""PyTorch port: the layers import downwards only.

An AST walk over every module of `basisu_rs_tpu_torch/` (imports inside
functions included, relative imports resolved): no module under `ops/`,
`tables/`, `utils/`, `parallel/` or `container/` imports the entry module
`api.py` or `models/`; no module under `ops/` imports `parallel/` or
`container/`; and `base.py`, the names every layer shares, imports nothing
of the package but `utils/profiling.py`.  One case a module."""

import ast
from pathlib import Path

import pytest

PKG = "basisu_rs_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent / PKG

# layer -> the package's subpackages and modules it must not import
FORBIDDEN = {
    "ops": ("api", "models", "parallel", "container"),
    "tables": ("api", "models"),
    "utils": ("api", "models"),
    "parallel": ("api", "models"),
    "container": ("api", "models"),
}


def _module_name(path: Path, root: Path = ROOT) -> str:
    parts = path.relative_to(root.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def imported_modules(path: Path, root: Path = ROOT) -> set:
    """Every module of the package that `path` (a file under `root`)
    imports, as dotted names below the package (`from x import y` counts x
    and x.y)."""
    package = list(path.relative_to(root.parent).parent.parts)  # where relative imports start
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            module = node.module
            if node.level:
                module = ".".join(package[: len(package) - node.level + 1] + ([module] if module else []))
            names.add(module)
            names.update(f"{module}.{alias.name}" for alias in node.names)
    return {n[len(PKG) + 1 :] for n in names if n.startswith(PKG + ".")}


def _reaches(imported: set, target: str) -> bool:
    return any(n == target or n.startswith(target + ".") for n in imported)


MODULES = [ROOT / "base.py"] + sorted(p for layer in FORBIDDEN for p in (ROOT / layer).rglob("*.py"))


def test_the_walk_sees_relative_absolute_and_nested_imports(tmp_path):
    src = tmp_path / PKG / "ops" / "probe.py"
    src.parent.mkdir(parents=True)
    src.write_text("from ..api import x\nfrom . import kernels\nimport basisu_rs_tpu_torch.models\n"
                   "def f():\n    from ..parallel.mesh import y\n")
    assert imported_modules(src, tmp_path / PKG) == {"api", "api.x", "ops", "ops.kernels", "models", "parallel.mesh",
                                                     "parallel.mesh.y"}


@pytest.mark.parametrize("path", MODULES, ids=_module_name)
def test_module_imports_only_layers_below_it(path):
    imported = imported_modules(path)
    if path == ROOT / "base.py":
        assert all(n.startswith("utils.profiling") or n == "utils" for n in imported), imported
        return
    layer = path.relative_to(ROOT).parts[0]
    bad = sorted(t for t in FORBIDDEN[layer] if _reaches(imported, t))
    assert not bad, f"{_module_name(path)} imports {bad}"
