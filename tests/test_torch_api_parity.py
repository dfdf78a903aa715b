"""The port has every public name of the reference.

Each module of `spim_registration_tpu/` is read with `ast` (nothing of it
runs): its public functions, classes and module-level constants, the
names its `__init__.py` re-exports, each function's parameters, each
class's constructor parameters (an `__init__` or the dataclass fields)
and each public method with its parameters. The port module of the same
path (`spim_registration_tpu_torch/...`) must have every name, and each
signature must accept every parameter name of the reference's. One case
per reference module.

The differences by design are the tables below, each with its reason;
a table entry that the port no longer needs fails the test too.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_api_parity.py -q
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "spim_registration_tpu"
PORT = "spim_registration_tpu_torch"

_PALLAS = ("the Pallas kernels; their hand-written CUDA counterparts are "
           "csrc/*.cu with wrappers in ops/kernels/")

# reference modules with no counterpart of the same path
MODULES_BY_DESIGN = {
    "ops/pallas/__init__.py": _PALLAS,
    "ops/pallas/dog.py": _PALLAS,
    "ops/pallas/lowrank_conv.py": _PALLAS,
    "ops/pallas/segtopk.py": _PALLAS,
    "utils/backend.py": "the JAX platform query; the port decides by the "
                        "device of its tensors (utils/device.py)",
    "utils/compile_cache.py": "JAX's persistent compilation cache",
    "utils/staticleaf.py": "JAX pytree machinery (static dataclass leaves)",
}

_BATCH = ("a jax.vmap of the fit; the port's fits take leading batch "
          "dimensions themselves")
_HOT = ("the reference's device-to-host transfer-size trick; the results "
        "are exact either way (reference ops/extrema.py:221-226)")

# (module, name): public names of the reference that the port lacks
NAMES_BY_DESIGN = {
    ("utils/profiling.py", "xla_trace"):
        "an XLA trace; the port's is `trace`, a torch.profiler trace "
        "(--profile)",
    ("utils/log.py", "Metrics"):
        "a wall-clock stage timer with no device fence that no code of the "
        "port called; stages are timed by `utils/profiling.stage_timer` "
        "and its spans",
    ("models/affine.py", "fit_translation_batch"): _BATCH,
    ("models/affine.py", "fit_rigid_batch"): _BATCH,
    ("models/affine.py", "fit_similarity_batch"): _BATCH,
    ("models/affine.py", "fit_affine_batch"): _BATCH,
    ("detect/dog.py", "HOT_ROWS"): _HOT,
}

# (module, function or Class.method, parameter): parameters of the
# reference that the port's signature does not take
PARAMS_BY_DESIGN = {
    ("ops/extrema.py", "find_peaks", "hot_k"): _HOT,
    ("ops/extrema.py", "find_peaks_localized", "hot_k"): _HOT,
    ("models/ransac.py", "filter_ransac", "key"):
        "renamed `seed`: an integer seed takes the place of a JAX PRNG key",
    ("parallel/halo.py", "halo_exchange_z", "x"):
        "renamed `xs` (one shard a mesh position) beside a new `mesh`: "
        "the port's shards are a list, not one sharded array",
    ("utils/profiling.py", "stage_timer", "fence"):
        "the setter that the context yields takes its place",
    ("core/zarr_store.py", "TSVolume", "store"):
        "the reference's class wraps an open TensorStore handle; the "
        "port's reads zarr and n5 itself and opens `path` with `driver` "
        "(open_volume / create_volume build it in both packages)",
    ("deconv/blocked.py", "BlockedDeconvolutionRunner", "axis_name"):
        "the reference shards a group of blocks along the named mesh "
        "axis; the port runs block k on mesh position k % mesh.size "
        "whatever the axes (port deconv/blocked.py)",
}


def _ref_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def _port_name(rel: str) -> str:
    parts = [p for p in Path(rel).with_suffix("").parts if p != "__init__"]
    return ".".join([PORT] + parts)


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def _is_dataclass(node: ast.ClassDef) -> bool:
    return any("dataclass" in ast.unparse(d).split("(")[0]
               for d in node.decorator_list)


def _fields(node: ast.ClassDef) -> list:
    return [s.target.id for s in node.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
            and "ClassVar" not in ast.unparse(s.annotation)]


def _public(rel: str) -> dict:
    """name -> (kind, node) of the module's public top-level names;
    `__init__.py` re-exports count as its own."""
    tree = ast.parse((REF / rel).read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("function", node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ("class", node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ("constant", node)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = ("constant", node)
        elif isinstance(node, ast.ImportFrom) and rel.endswith("__init__.py"):
            for a in node.names:
                out[a.asname or a.name] = ("re-export", node)
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _missing_params(obj, wanted) -> list:
    sig = _signature(obj)
    assert sig is not None, f"{obj!r} has no signature"
    if any(p.kind is p.VAR_KEYWORD for p in sig.parameters.values()):
        return []
    return [n for n in wanted if n not in sig.parameters]


def _differences(rel: str) -> set:
    """What the port lacks of the reference module `rel`: ("name", n) and
    ("param", qualname, p) entries."""
    mod = importlib.import_module(_port_name(rel))
    out = set()
    for name, (kind, node) in _public(rel).items():
        if not hasattr(mod, name):
            out.add(("name", name))
            continue
        obj = getattr(mod, name)
        if kind == "function":
            out |= {("param", name, p)
                    for p in _missing_params(obj, _params(node))}
        elif kind == "class":
            init = [s for s in node.body if isinstance(s, ast.FunctionDef)
                    and s.name == "__init__"]
            want = (_params(init[0]) if init
                    else _fields(node) if _is_dataclass(node) else [])
            out |= {("param", name, p) for p in _missing_params(obj, want)}
            for sub in node.body:
                if not (isinstance(sub, ast.FunctionDef)
                        and not sub.name.startswith("_")):
                    continue
                qual = f"{name}.{sub.name}"
                if not hasattr(obj, sub.name):
                    out.add(("name", qual))
                    continue
                meth = inspect.getattr_static(obj, sub.name)
                if isinstance(meth, property):
                    continue
                out |= {("param", qual, p) for p in _missing_params(
                    getattr(obj, sub.name), _params(sub))}
    return out


@pytest.mark.parametrize("rel", _ref_modules())
def test_port_has_every_public_name(rel):
    if rel in MODULES_BY_DESIGN:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port_name(rel))
        return
    allowed = ({("name", n) for (m, n) in NAMES_BY_DESIGN if m == rel}
               | {("param", f, p) for (m, f, p) in PARAMS_BY_DESIGN
                  if m == rel})
    found = _differences(rel)
    assert found - allowed == set(), (
        f"{rel}: the port lacks {sorted(found - allowed)}")
    assert allowed - found == set(), (
        f"{rel}: no longer different, take out of the tables: "
        f"{sorted(allowed - found)}")


def test_exception_tables_name_the_reference():
    """Each entry names a module, name or parameter that the reference
    has, and carries its reason."""
    mods = set(_ref_modules())
    assert set(MODULES_BY_DESIGN) <= mods
    for (rel, name), why in NAMES_BY_DESIGN.items():
        assert name in _public(rel) and why
    for (rel, qual, param), why in PARAMS_BY_DESIGN.items():
        assert why
        name, _, meth = qual.partition(".")
        kind, node = _public(rel)[name]
        if meth:
            node = next(s for s in node.body
                        if isinstance(s, ast.FunctionDef) and s.name == meth)
        elif kind == "class":
            node = next(s for s in node.body
                        if isinstance(s, ast.FunctionDef)
                        and s.name == "__init__")
        assert param in _params(node)
