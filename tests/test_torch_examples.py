"""The port's examples (``examples/torch_*.py``) run on the CPU at small
sizes, each checking its own errors against its stated bounds (exit 0),
and refuse to run without a card unless ``--device cpu`` is given."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = {
    "torch_quickstart.py": [],
    "torch_trsm_demo.py": [],
    "torch_serve_lm.py": ["--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "4", "--requests", "3",
                          "--solve-n", "64"],
    "torch_train_lm.py": ["--arch", "smollm-360m", "--smoke", "--steps", "4",
                          "--ckpt-every", "2", "--batch", "2", "--seq", "16",
                          "--log-every", "2"],
}


def _run(name, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    extra = ["--ckpt", str(tmp_path / "ckpt")] \
        if name == "torch_train_lm.py" else []
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name), *args,
         *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)


@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory):
    """Every example on the CPU, started together."""
    procs = {name: _run(name, args + ["--device", "cpu"],
                        tmp_path_factory.mktemp(name[:-3]))
             for name, args in EXAMPLES.items()}
    return {name: (p.wait(timeout=300), p.stdout.read())
            for name, p in procs.items()}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_passes_its_checks_on_the_cpu(cpu_runs, name):
    rc, out = cpu_runs[name]
    assert rc == 0, out[-4000:]


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_trsm_demo.py"])
def test_example_refuses_to_run_without_a_card(tmp_path, name):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(name, [], tmp_path)
    rc, out = p.wait(timeout=120), p.stdout.read()
    assert rc != 0 and "no CUDA device" in out, out[-2000:]
