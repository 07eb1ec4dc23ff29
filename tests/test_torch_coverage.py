"""The port is complete: every module of the JAX package has its port,
and every public top-level function or class, and every public method
or field of such a class, has a name in it.

The reference is read with ``ast``, never imported. A name the port
module defines, assigns or imports counts as present. The renames are
the table below, each with the name or module that stands in for it."""
import ast
import os

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REF = os.path.join(SRC, "repro")
PORT = os.path.join(SRC, "repro_torch")

#: reference module -> the port's module of another name
MODULE_RENAMES = {
    # no HLO text in PyTorch: the executed step is counted instead
    "runtime/hlo_analysis.py": "runtime/op_analysis.py",
}

#: (reference module, name or "*" for every name of the module) ->
#: (the port's module, the name that stands in for it)
NAME_RENAMES = {
    ("core/federation.py", "FederationConfig.pallas_group_mean"):
        ("core/federation.py", "FederationConfig.kernel_group_mean"),
    ("runtime/roofline.py", "memory_analysis_dict"):
        ("runtime/roofline.py", "memory_dict"),
    # the HLO-text parsers: the op analysis counts the step as it runs
    ("runtime/roofline.py", "collective_bytes"):
        ("runtime/op_analysis.py", "OpAnalysis"),
    ("runtime/hlo_analysis.py", "*"):
        ("runtime/op_analysis.py", "OpAnalysis"),
}


def _stand_in(module, name):
    """(port module, port name) for the reference's ``module.name``."""
    return NAME_RENAMES.get(
        (module, name), NAME_RENAMES.get(
            (module, "*"), (MODULE_RENAMES.get(module, module), name)))


def _modules(root):
    for d, _, files in os.walk(root):
        if "_build" in d or "__pycache__" in d:
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), root)


def _public(path):
    """Public top-level functions and classes, and ``Class.member`` for
    each public method and annotated field of a public class."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for b in node.body:
                    name = (b.name if isinstance(
                        b, (ast.FunctionDef, ast.AsyncFunctionDef))
                        else b.target.id if isinstance(b, ast.AnnAssign)
                        and isinstance(b.target, ast.Name) else None)
                    if name and not name.startswith("_"):
                        out.add(f"{node.name}.{name}")
    return out


def _defined(path):
    """Every name a module binds at top level, and ``Class.member`` for
    each member of its classes."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        out.add(f"{node.name}.{b.name}")
                    elif isinstance(b, ast.AnnAssign) \
                            and isinstance(b.target, ast.Name):
                        out.add(f"{node.name}.{b.target.id}")
                    elif isinstance(b, ast.Assign):
                        out |= {f"{node.name}.{t.id}" for t in b.targets
                                if isinstance(t, ast.Name)}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


REF_MODULES = list(_modules(REF))


def test_every_reference_module_has_its_port():
    missing = [m for m in REF_MODULES if not os.path.exists(
        os.path.join(PORT, MODULE_RENAMES.get(m, m)))]
    assert missing == []
    assert len(REF_MODULES) > 70


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_name_has_its_port(module):
    missing = []
    for name in sorted(_public(os.path.join(REF, module))):
        port, new = _stand_in(module, name)
        if new not in _defined(os.path.join(PORT, port)):
            missing.append(name)
    assert missing == []


def test_renames_name_what_exists():
    """Each rename's reference name exists and its stand-in does too (a
    stale row would hide a real gap)."""
    for (module, name), (port, new) in NAME_RENAMES.items():
        assert name == "*" or name in _public(os.path.join(REF, module))
        assert new in _defined(os.path.join(PORT, port)), (port, new)
