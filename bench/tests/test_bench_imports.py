"""What the harness loads: no module whose whole top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package; ``repro_torch``, the
port, is not ``repro``), and the plain reference loads nothing of the port
at all.  Each check imports in a fresh process."""

import json
import subprocess
import sys

import pytest

from bench.harness.cell import BENCH, ROOT

HARNESS = sorted(f"bench.{p.parent.name}.{p.stem}" for d in ("harness", "drivers", "reference",
                                                           "families", "controls")
                 for p in (BENCH / d).glob("*.py") if p.stem != "__init__")
LOADED = ("import importlib, json, sys\n"
          "for name in sys.argv[1:]:\n"
          "    importlib.import_module(name)\n"
          "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")


def top_level_modules(*modules, code: str = LOADED) -> set:
    p = subprocess.run([sys.executable, "-c", code, *modules], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    loaded = top_level_modules(*HARNESS)
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded


def test_a_whole_run_loads_no_jax():
    """A tiny run of a serving and a training cell through the harness, on
    the CPU: the port's modules load, JAX's do not."""
    code = ("import json, sys, time\n"
            "from bench.tests.tiny import tiny_cell\n"
            "from bench.harness.main import execute, forbidden_modules\n"
            "for w in ('qwen2-7b.docqa-8k', 'zamba2-1.2b.train-8k'):\n"
            "    execute(tiny_cell(w), 5, 0.1, False, 'cpu', time.perf_counter())\n"
            "assert not forbidden_modules()\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    loaded = top_level_modules(code=code)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded


@pytest.mark.parametrize("module", ["bench.reference.common", "bench.reference.dense",
                                    "bench.reference.hybrid", "bench.reference.train",
                                    "bench.reference.serve"])
def test_the_reference_loads_nothing_of_the_port(module):
    loaded = top_level_modules(module)
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, loaded
