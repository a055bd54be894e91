"""The port's public surface against the JAX package's, read from both
source trees with `ast` (neither package is imported).

Every public top-level name of each module of `vectorx_tpu/` (functions,
classes, constants; a package's re-exports and lazy `__getattr__` names)
and every public method and field of its classes must have a counterpart of the same
name in the module of the same path in `vectorx_tpu_torch/`, unless the
module is mapped to another module of the port (`MAPPED`) or the name is in
`NO_COUNTERPART` with the reason it has none.  One case per module.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "vectorx_tpu"
PORT = ROOT / "vectorx_tpu_torch"

# Reference modules whose surface is another module of the port.
MAPPED = {
    "ntt/pallas_ntt.py": (
        "ntt/cuda_ntt.py",
        "the Pallas NTT: its CUDA kernels K1/K3/K4 (csrc/ntt.cu) and plans"),
    "hash/poseidon_np.py": (
        "hash/poseidon.py",
        "the numpy host Poseidon: the port's Poseidon on CPU tensors "
        "(merkle._two_to_one_host/_hash_host)"),
}

_LIMBS = ("the uint32 limb-pair representation: the port keeps int64 "
          "tensors of u64 bit patterns")
_JIT = "a JAX compile cache: torch runs eagerly, nvcc builds the kernels once"

# Reference names with no counterpart in the port, by module ("*": the
# whole module; "Class.member": a method or field).
NO_COUNTERPART = {
    "jaxcache.py": {"*": "JAX's persistent compile cache: the port compiles "
                         "its kernels once with nvcc"},
    "stark/stages.py": {"cached_jit": _JIT, "clear_caches": _JIT,
                        "env_key": _JIT},
    "stark/air.py": {"scalar_attrs_cache_key": _JIT},
    "ntt/ntt.py": {"PALLAS_MIN_LOG_N": "the Pallas kernel's size gate: "
                                       "cuda_ntt's plans take every size"},
    "field/goldilocks.py": {name: _LIMBS for name in (
        "P_LO", "P_HI", "MASK16", "U32_ZERO", "U32_ONE", "add64", "sub64",
        "mul32", "mul64_wide", "reduce128")},
    "parallel/comm_model.py": {
        "DEFAULT_ICI_GBPS": "a TPU link rate: the port takes the link rate "
                            "as an argument",
        "collective_op_defs": "parses XLA HLO: the port counts collectives "
                              "by the mesh's counters (collective_counts)",
        "NttCommModel.total_ici_bytes": "named total_bytes: ICI is the "
                                        "TPU's interconnect"},
}
# Methods with no counterpart in any class.
NO_COUNTERPART_METHODS = {"comp_cache_key": _JIT}


def _lazy_names(fn: ast.FunctionDef) -> set:
    """Names a module-level `__getattr__` answers (`name == "X"`)."""
    return {node.comparators[0].value for node in ast.walk(fn)
            if isinstance(node, ast.Compare)
            and isinstance(node.left, ast.Name) and node.left.id == "name"
            and isinstance(node.comparators[0], ast.Constant)}


def _targets(node) -> set:
    tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
    return {n.id for t in tgts for n in ast.walk(t) if isinstance(n, ast.Name)}


def _members(cls: ast.ClassDef) -> set:
    """A class's methods and fields: its defs, class-level assignments,
    `__slots__` and the `self.X` its methods assign."""
    out = set()
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(item.name)
            out |= {t.attr for n in ast.walk(item)
                    if isinstance(n, (ast.Assign, ast.AnnAssign))
                    for t in (n.targets if isinstance(n, ast.Assign)
                              else [n.target])
                    if isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name) and t.value.id == "self"}
        elif isinstance(item, (ast.Assign, ast.AnnAssign)):
            names = _targets(item)
            out |= names
            if "__slots__" in names and item.value is not None:
                out |= {n.value for n in ast.walk(item.value)
                        if isinstance(n, ast.Constant)}
    return out


def _module_path(root: Path, module: str) -> Path:
    rel = Path(*module.split(".")[1:])
    pkg = root / rel / "__init__.py"
    return pkg if pkg.is_file() else root / rel.with_suffix(".py")


def _surface(root: Path, path: Path, imports: bool):
    """(top-level names, {class: members}) of a module.  Imported names
    count where `imports` is set; a class has its bases' members (bases of
    the same module) and a name bound to a class has the class's members
    (`X = Cls`, `Cls` of this module or imported from the package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, classes, bases, aliases, imported = set(), {}, {}, {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            if node.name == "__getattr__":
                names |= _lazy_names(node)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            classes[node.name] = _members(node)
            bases[node.name] = [b.id for b in node.bases
                                if isinstance(b, ast.Name)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= _targets(node)
            if isinstance(node.value, ast.Name):
                for t in _targets(node):
                    aliases[t] = node.value.id
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.split(".")[0] == root.name:
                for a in node.names:
                    imported[a.asname or a.name] = (node.module, a.name)
    for cls in classes:
        todo = list(bases[cls])
        while todo:
            base = todo.pop()
            if base in classes:
                classes[cls] |= classes[base]
                todo += bases[base]
    for alias, target in aliases.items():
        if target in classes:
            classes[alias] = classes[target]
        elif target in imported:
            module, name = imported[target]
            src = _module_path(root, module)
            if src.is_file():
                found = _surface(root, src, imports=False)[1]
                if name in found:
                    classes[alias] = found[name]
    return names, classes


def _public(names) -> set:
    return {n for n in names if not n.startswith("_")}


def _reference(rel: str):
    path = REF / rel
    names, classes = _surface(REF, path, imports=path.name == "__init__.py")
    want = _public(names)
    for cls, members in classes.items():
        if not cls.startswith("_"):
            want |= {f"{cls}.{m}" for m in _public(members)
                     if m not in NO_COUNTERPART_METHODS}
    return want


def _port(rel: str):
    names, classes = _surface(PORT, PORT / rel, imports=True)
    have = set(names)
    for cls, members in classes.items():
        have |= {f"{cls}.{m}" for m in members}
    return have


MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def test_reference_tree_is_read():
    assert len(MODULES) > 90 and "fri/fri.py" in MODULES
    assert set(MAPPED) | set(NO_COUNTERPART) <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_counterpart(rel):
    reasons = NO_COUNTERPART.get(rel, {})
    if rel in MAPPED:
        target, _ = MAPPED[rel]
        assert (PORT / target).is_file(), f"{rel} maps to a missing {target}"
        assert not (PORT / rel).exists(), f"{rel} is ported: unmap it"
        return
    if "*" in reasons:
        assert not (PORT / rel).exists(), f"{rel} is ported: drop its entry"
        return
    assert (PORT / rel).is_file(), f"no module {rel} in the port"
    want, have = _reference(rel), _port(rel)
    missing = sorted(want - have - set(reasons))
    assert not missing, f"{rel}: no counterpart in the port for {missing}"
    # the table holds only names the reference has and the port lacks
    stale = sorted(n for n in reasons if n not in want or n in have)
    assert not stale, f"{rel}: stale NO_COUNTERPART entries {stale}"
