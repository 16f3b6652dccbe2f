"""A run loads neither JAX nor the JAX package, and the reference loads
nothing of the program."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

ENV = dict(os.environ, PYTHONPATH=harness.ROOT)


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=ENV, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import json\n"
        "from portbench import harness, run\n"
        "ctx = harness.Context('rtow.frame', 2**40 + 3, 0.2, 0, device='cpu',"
        " overrides={'res_x': 16, 'res_y': 12})\n"
        "out = run.run_cell(ctx)\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    assert json.loads(_python(code)) == []


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import portbench.control, portbench.roofline\n"
        "import portbench.reference.invert, portbench.reference.png\n"
        "import portbench.reference.scene, portbench.reference.viewer\n"
        "import portbench.reference.whitted\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules"
        " if m.split('.')[0].startswith(('distributionraytracer', 'jax',"
        " 'flax'))})))\n")
    assert json.loads(_python(code)) == []


def test_without_a_card_the_runner_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "rtow.frame",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=ENV, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
