"""The README's PyTorch-port snippets, each executed on its own.

Only the python blocks between ``## PyTorch port`` and the next ``## ``
heading: tests/test_docs.py runs every README block in order and stops
at the first of the reference's that raises, so a port snippet that
rotted would not show there.  Each block runs in a fresh namespace on
the CPU (``device="cpu"``) and holds itself to its own asserts; a block
that starts a ``torch.distributed`` process group runs in each of four
processes, as ``torchrun`` would run it.
"""

import os
import pathlib
import re
import socket
import subprocess
import sys

import pytest

README = pathlib.Path(__file__).resolve().parents[1] / "README.md"


def _port_blocks() -> list:
    text = README.read_text()
    start = text.index("\n## PyTorch port")
    end = text.find("\n## ", start + 1)
    section = text[start:] if end == -1 else text[start:end]
    return re.findall(r"```python\n(.*?)```", section, re.S)


BLOCKS = _port_blocks()


def test_port_section_keeps_its_snippets():
    """Eight snippets (fleet, structure, churn, async, producers and
    K-FAC, structure and a producer over p > 1 ranks, the serving tier
    over p > 1 ranks, each on the port's front door; the LM, on its
    model), none importing JAX or the reference."""
    assert len(BLOCKS) == 8
    for block in BLOCKS[:7]:
        assert "from repro_torch import api" in block
    assert "from repro_torch.models import lm" in BLOCKS[7]
    for block in BLOCKS:
        assert 'device="cpu"' in block
        assert not re.search(r"^\s*(import jax|from jax|import repro\b"
                             r"|from repro[ .])", block, re.M)


# a block that starts a process group runs as the script of each of
# WORLD processes, torchrun's environment set by hand; each process
# leaves with os._exit once the block has run, so gloo's threads cannot
# abort it in the interpreter's teardown
WORLD = 4
RANK_MAIN = (
    "import os, sys\n"
    "exec(compile(open(sys.argv[1]).read(), sys.argv[1], 'exec'), {})\n"
    "sys.stdout.flush(); sys.stderr.flush(); os._exit(0)\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_in_ranks(block: str, where: str, tmp_path) -> None:
    script = tmp_path / "block.py"
    script.write_text(block)
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=str(README.parent / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, str(script)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs)
              if p.returncode != 0]
    assert not failed, f"{where}: ranks {failed}\n" + "\n".join(
        o[-3000:] for o in outs)


@pytest.mark.parametrize("i", range(len(BLOCKS)))
def test_port_readme_snippet_executes(i, tmp_path):
    where = f"README.md:pytorch-port[{i}]"
    if "init_process_group" in BLOCKS[i]:
        _run_in_ranks(BLOCKS[i], where, tmp_path)
        return
    ns: dict = {}
    exec(compile(BLOCKS[i], where, "exec"), ns)
