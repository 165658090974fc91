"""Every public top-level name of the JAX package exists in the port.

Both packages are parsed with `ast` (nothing is imported): each function,
class or assigned name defined at the top level of a module of
`metricsfm_tpu/`, not starting with "_", must be defined at the top level
of the port's module of the same path, apart from the two lists below.
"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "metricsfm_tpu")
PORT_ROOT = os.path.join(REPO, "metricsfm_tpu_torch")

# ROADMAP.md, "Not to port": the XLA compile cache, the JAX package's
# unused helpers and the XLA SGM path.  ops/pallas/* are the TPU kernels,
# whose counterparts are the CUDA kernels in ops/csrc with their wrappers
# in ops/matching.py and ops/sgm_kernel.py.
NOT_TO_PORT = {
    "utils/cache.py": {"enable_compilation_cache"},
    "io/store.py": {"write_matches", "read_matches", "has_matches"},
    "ops/ransac.py": {"fundamental_ransac_pairs"},
    "ops/triangulation.py": {"triangulate_two_view"},
    "ops/sgm.py": {"census_transform", "matching_cost_volume",
                   "speed_of_light_mps"},
    "utils/synth.py": {"aerial_fixture"},
}
NOT_TO_PORT_DIRS = ("ops/pallas/",)

# Still to port: ROADMAP item 10, multi-GPU.  Later slices shrink it.
PENDING = {
    "parallel/mesh.py": {"initialize_distributed", "make_global_mesh",
                         "make_mesh", "pad_to_multiple", "shard_tracks"},
    "parallel/sharded_ba.py": {"make_sharded_lm", "solve_lm_sharded"},
    "parallel/sharded_matching.py": {"make_sharded_matcher",
                                     "match_pairs_sharded"},
}


def public_names(path):
    """Public names defined at the top level of a Python source file."""
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def jax_modules():
    mods = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_ROOT)
                mods.append(rel.replace(os.sep, "/"))
    return sorted(mods)


def missing(rel):
    want = public_names(os.path.join(JAX_ROOT, rel))
    have = public_names(os.path.join(PORT_ROOT, rel))
    return want - have - NOT_TO_PORT.get(rel, set()) - PENDING.get(rel, set())


@pytest.mark.parametrize("rel", [m for m in jax_modules()
                                 if not m.startswith(NOT_TO_PORT_DIRS)])
def test_port_defines_every_public_name(rel):
    assert not missing(rel), f"{rel}: not in the port: {sorted(missing(rel))}"


def test_lists_name_only_what_the_port_lacks():
    """Every listed name exists in the JAX module and is absent from the
    port: a name that gets ported must leave PENDING."""
    for table in (NOT_TO_PORT, PENDING):
        for rel, names in table.items():
            assert names <= public_names(os.path.join(JAX_ROOT, rel)), rel
            assert not names & public_names(os.path.join(PORT_ROOT, rel)), rel
    assert set(PENDING) <= {"parallel/mesh.py", "parallel/sharded_ba.py",
                            "parallel/sharded_matching.py"}
