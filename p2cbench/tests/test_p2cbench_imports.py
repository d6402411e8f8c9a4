"""Nothing the run loads is JAX or the JAX package, and the reference
imports neither them nor the program; names are compared by their whole
top-level part."""

import ast
import subprocess
import sys
import textwrap

from p2cbench import run
from p2cbench.spec import HERE

NOT_IN_REFERENCE = {"jax", "jaxlib", "flax", "point2cyl_tpu", "point2cyl_torch"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


def test_p2cbench_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").glob("*.py"))
    assert files
    for path in files:
        assert not _top_level_imports(path) & NOT_IN_REFERENCE, path


def test_p2cbench_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "point2cyl_tpu_extra", sys)
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m.split(".", 1)[0] in run.FORBIDDEN]
    assert "jaxfoo" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()


def test_p2cbench_run_process_loads_no_jax(tiny_root):
    code = textwrap.dedent(f"""
        import torch
        from p2cbench.run import execute, forbidden_modules
        from p2cbench.spec import Bench
        execute(Bench({str(tiny_root)!r}), "tiny-joint-train", 1, 0.2, False,
                torch.device("cpu"))
        print(forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(HERE.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
