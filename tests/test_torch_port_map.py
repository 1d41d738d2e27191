"""``docs/PORT.md`` maps every public name of the JAX package: each public
top-level name of ``src/repro/**/*.py``, and each name a package's
``__init__.py`` re-exports, exists under the same name in the same module
of ``src/repro_torch/`` or has a row in the document's table of names
without a same-named counterpart."""

import ast
import importlib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_SRC = ROOT / "src" / "repro"
PORT_DOC = ROOT / "docs" / "PORT.md"
NAMES_SECTION = "## 3. Names without a same-named counterpart"

# the names known to have no same-named counterpart when the map was
# written: the check must find every one of them, so that it cannot pass
# by finding nothing
KNOWN_UNMATCHED = {
    "core/mcop.py:mcop_jax", "core/__init__.py:mcop_jax",
    "core/mcop_shard.py:sharded_fused_solver", "core/mcop_shard.py:sharded_solve_envs_call",
    "kernels/flash_attention.py:NEG_INF", "kernels/mcop_phase.py:default_block_graphs",
    "kernels/ops.py:default_interpret", "kernels/ops.py:on_tpu",
    "kernels/__init__.py:default_interpret", "kernels/__init__.py:on_tpu",
    "kernels/__init__.py:flash_attention", "kernels/__init__.py:mamba_chunk_scan",
    "kernels/__init__.py:ref",
    "kernels/ref.py:flash_reference", "kernels/ref.py:mamba_chunk_scan_reference",
    "kernels/ref.py:mcop_phase_reference",
    "launch/dryrun.py:ICI_BW", "launch/dryrun.py:collective_bytes",
    "launch/mesh.py:use_mesh", "models/attention.py:set_decode_flash_partitioning",
    "models/common.py:Params", "models/common.py:make_rope_cache",
    "models/transformer.py:REMAT_POLICY", "models/transformer.py:set_layer_scan_unroll",
    "runtime/sharding.py:set_expert_sharding", "runtime/sharding.py:solve_batch_spec",
    "runtime/pipeline.py:shard_map",
}


def bound_names(path: pathlib.Path, *, imports: bool) -> set[str]:
    """Names a module binds at its top level (also inside a top-level
    ``if`` or ``try``): functions, classes, assignments and, with
    ``imports``, the names it imports."""
    names = set()
    body = list(ast.parse(path.read_text()).body)
    while body:
        node = body.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and imports:
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.If, ast.Try)):
            body.extend(node.body + node.orelse + getattr(node, "finalbody", [])
                        + [s for h in getattr(node, "handlers", []) for s in h.body])
    return names


def public_names(path: pathlib.Path) -> set[str]:
    """A JAX module's public names: what it defines, not starting with
    ``_``, and in an ``__init__.py`` also what it imports (re-exports)."""
    names = bound_names(path, imports=path.name == "__init__.py")
    return {n for n in names if not n.startswith("_")}


def port_module(rel: pathlib.Path):
    parts = ("repro_torch",) + rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(parts))


def jax_modules() -> list[pathlib.Path]:
    return sorted(p.relative_to(JAX_SRC) for p in JAX_SRC.rglob("*.py"))


@pytest.fixture(scope="module")
def unmatched() -> set[str]:
    """``path:name`` of every public name of ``src/repro/`` that the port's
    module of the same path does not bind (a submodule that a package's
    ``__init__`` does not import is no re-export)."""
    out = set()
    for rel in jax_modules():
        have = bound_names(ROOT / "src" / "repro_torch" / rel, imports=True)
        out.update(f"{rel.as_posix()}:{name}" for name in public_names(JAX_SRC / rel)
                   if name not in have)
    return out


@pytest.fixture(scope="module")
def mapped() -> dict[str, str]:
    """The table of section 3 of ``docs/PORT.md``: key -> the port's name."""
    text = PORT_DOC.read_text()
    assert NAMES_SECTION in text
    section = text.split(NAMES_SECTION, 1)[1].split("\n## ", 1)[0]
    rows = {}
    for line in section.splitlines():
        m = re.match(r"^\| `([^`]+\.py:[A-Za-z_][A-Za-z0-9_]*)` \| (.+?) \| (.+?) \|$", line)
        if m:
            assert m.group(1) not in rows, f"two rows for {m.group(1)}"
            rows[m.group(1)] = m.group(2)
            assert m.group(3).strip(), f"{m.group(1)}: no reason given"
    return rows


@pytest.mark.parametrize("rel", jax_modules(), ids=lambda p: p.as_posix())
def test_every_module_has_its_counterpart(rel):
    assert (ROOT / "src" / "repro_torch" / rel).is_file()


def test_the_check_finds_the_known_renames(unmatched):
    assert KNOWN_UNMATCHED <= unmatched


def test_every_unmatched_name_has_a_row(unmatched, mapped):
    missing = sorted(unmatched - set(mapped))
    assert not missing, f"public names of repro with no counterpart and no row in docs/PORT.md: {missing}"


def test_every_row_names_a_name_still_unmatched(unmatched, mapped):
    """A row for a name that now has its counterpart, or that the JAX
    package no longer has, is stale."""
    stale = sorted(set(mapped) - unmatched)
    assert not stale, f"rows of docs/PORT.md for names that need none: {stale}"


def test_each_counterpart_named_in_a_row_exists(mapped):
    """Where a row names the port's ``path:name``, that name exists."""
    for key, port in mapped.items():
        m = re.fullmatch(r"`([a-z_/]+\.py):([A-Za-z_][A-Za-z0-9_.]*)`.*", port)
        if m is None:
            continue
        obj = port_module(pathlib.Path(m.group(1)))
        for attr in m.group(2).split("."):
            assert hasattr(obj, attr), f"{key}: {port} does not exist"
            obj = getattr(obj, attr)


def test_the_examples_and_tools_are_in_the_map():
    text = PORT_DOC.read_text()
    for name in ("quickstart", "adaptive_offload", "serve_lm", "train_lm"):
        assert f"`examples/{name}.py` | `examples/torch_{name}.py`" in text
        assert (ROOT / "examples" / f"torch_{name}.py").is_file()
    for name in ("chaos_trace", "ipc_smoke"):
        assert f"`tools/{name}.py` | `tools/torch_{name}.py`" in text
        assert (ROOT / "tools" / f"torch_{name}.py").is_file()
