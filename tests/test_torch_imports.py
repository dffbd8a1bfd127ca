"""The port stands alone: neither ringo_tpu_torch nor chip_smoke.py
imports JAX or anything of the JAX package (only the tests import both)."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|ringo_tpu)(?:\.\S*)?(?:\s|$|,)",
    re.M)


def _port_sources():
    pkg = os.path.join(ROOT, "ringo_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_import_no_jax_and_no_reference_package():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "from ringo_tpu.fields import limb", "import ringo_tpu",
                 "    from ringo_tpu import backend"):
        assert FORBIDDEN.search(line), line
    for line in ("import ringo_tpu_torch", "from ringo_tpu_torch import backend",
                 "from .. import backend", "# see ringo_tpu.ops"):
        assert not FORBIDDEN.search(line), line


def test_importing_the_port_loads_neither():
    code = ("import sys, ringo_tpu_torch.jindo, ringo_tpu_torch.backend, "
            "ringo_tpu_torch.buckler, ringo_tpu_torch.circuits, "
            "ringo_tpu_torch.schemes, ringo_tpu_torch.examples.bfv, "
            "ringo_tpu_torch.examples.mult, ringo_tpu_torch.fields.modulus, "
            "ringo_tpu_torch.parallel, ringo_tpu_torch.entry, "
            "ringo_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ringo_tpu')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
