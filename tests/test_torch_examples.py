"""The port's example twins against the reference's examples.

Each twin under ``examples/torch_port/`` runs as a real subprocess on the
CPU beside its reference under ``examples/``, and their standard output
must be identical (the reference runs on JAX's CPU backend, as
``tests/test_examples.py`` runs it).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
TWINS = os.path.join(EXAMPLES, "torch_port")


def _run(path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    r = subprocess.run([sys.executable, path], env=env,
                       cwd=os.path.dirname(path), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(TWINS) if f.endswith(".py")))
def test_twin_prints_what_the_reference_prints(name):
    got = _run(os.path.join(TWINS, name))
    assert got and got == _run(os.path.join(EXAMPLES, name))
