"""No module of the benchmark or of the port imports jax, jaxlib or the JAX
package varden_tpu (top-level names compared whole: varden_tpu_torch is
not varden_tpu), and the reference imports nothing of the port."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "varden_tpu"}


def imported_tops(path):
    """Top-level names of every absolute import in a Python file."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def python_files(top):
    for d, _, files in os.walk(os.path.join(ROOT, top)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("top", ["portbench", "varden_tpu_torch"])
def test_no_jax_import(top):
    files = list(python_files(top))
    assert files
    bad = {f: imported_tops(f) & FORBIDDEN for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_reference_imports_nothing_of_the_port():
    files = list(python_files(os.path.join("portbench", "reference")))
    assert files
    bad = {f: imported_tops(f) & (FORBIDDEN | {"varden_tpu_torch", "portbench"})
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_import_check_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import varden_tpu_torch.driver\nfrom jax import numpy\n"
                 "import jaxlib as j\nfrom . import varden_tpu\n")
    assert imported_tops(str(p)) == {"varden_tpu_torch", "jax", "jaxlib"}
