"""The port's completeness: an AST diff of public names, module pair by
module pair (tfhe_tpu/<path> against tfhe_tpu_torch/<path>): every public
top-level function, class and assigned name of tfhe_tpu, and every public
method of its classes, must be in the port (defined there, or imported
under that name), except the names below, which are JAX or Pallas paths
(the TPU kernels, whose Hopper counterparts live in ops/kernels.py, and
the MXU path's key preparation, ops/bsk_prep.py) or ops/ntt.py's
array-generic helpers, which the port's numpy and torch halves replace
under their own names.  The list is the claim that nothing else is left to
port; a public name added to tfhe_tpu without a counterpart fails here."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
REF = REPO / "tfhe_tpu"
PORT = REPO / "tfhe_tpu_torch"

# modules the port has no file for: the Pallas kernels and the MXU path
JAX_ONLY_MODULES = {"ops/mxu.py", "ops/pallas_mxu.py", "ops/pallas_ntt.py"}

# names of ported modules that the port does not have
JAX_ONLY_NAMES = {
    "core/cm.py": {"U64"},
    "core/experimental.py": {"U64"},
    "parallel/poly_shard.py": {"U64"},
    "ops/ntt.py": {"PrimePlan", "add_mod_all", "forward_small", "inverse_all",
                   "lazy_reduce_stacked", "ntt_forward_stacked", "ntt_inverse_stacked",
                   "pointwise_mul_mont_stacked", "to_residues"},
    "ops/server.py": {"U64", "blind_rotate_pallas", "blind_rotate_pallas_v2",
                      "external_product_ntt", "ks_pbs_batch_mxu", "ks_pbs_batch_mxu_multibit",
                      "pbs_from_switched_batch_mxu"},
    "ops/server128.py": {"U64", "blind_rotate128_pallas"},
}

# public methods of ported classes that pick a JAX interpreter or an MXU path
JAX_ONLY_METHODS = {
    ("shortint/compression.py", "DecompressionKey"): {"ensure_mxu"},
    ("shortint/noise_squashing.py", "NoiseSquashingKey"): {"use_pallas"},
    ("shortint/server_key.py", "ServerKey"): {"use_mxu", "use_mxu_multibit", "use_pallas"},
}


def _public_names(path: pathlib.Path, with_imports: bool) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {n.id for tgt in node.targets for n in ast.walk(tgt)
                    if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not n.startswith("_")}


def _methods(path: pathlib.Path) -> dict:
    return {node.name: {n.name for n in node.body
                        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not n.name.startswith("_")}
            for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ClassDef) and not node.name.startswith("_")}


def _modules(package: str) -> list:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                  if str(p.relative_to(REF)).split("/")[0].removesuffix(".py") == package)


PACKAGES = sorted({str(p.relative_to(REF)).split("/")[0].removesuffix(".py")
                   for p in REF.rglob("*.py")})


@pytest.mark.parametrize("package", PACKAGES)
def test_port_lacks_only_jax_and_pallas_names(package):
    for rel in _modules(package):
        port = PORT / rel
        if rel in JAX_ONLY_MODULES:
            assert not port.exists(), f"{rel} is ported: take it off the JAX-only list"
            continue
        assert port.exists(), f"tfhe_tpu/{rel} has no counterpart"
        missing = _public_names(REF / rel, False) - _public_names(port, True)
        assert missing == JAX_ONLY_NAMES.get(rel, set()), rel
        ref_methods, port_methods = _methods(REF / rel), _methods(port)
        for cls, names in ref_methods.items():
            lacking = names - port_methods.get(cls, set())
            assert lacking == JAX_ONLY_METHODS.get((rel, cls), set()), (rel, cls)


def test_jax_only_list_names_jax_paths():
    """The modules on the list import JAX (or Pallas) themselves, and every
    name on the list exists in tfhe_tpu."""
    for rel in JAX_ONLY_MODULES:
        text = (REF / rel).read_text()
        assert "import jax" in text or "from jax" in text, rel
    for rel, names in JAX_ONLY_NAMES.items():
        assert names <= _public_names(REF / rel, False), rel
    for (rel, cls), names in JAX_ONLY_METHODS.items():
        assert names <= _methods(REF / rel)[cls], (rel, cls)
