"""The README's PyTorch-port snippets, each executed on its own.

Only the python blocks between ``## PyTorch port`` and the next ``## ``
heading: tests/test_docs.py runs every README block in order and stops
at the first of the reference's that raises, so a port snippet that
rotted would not show there.  Each block runs in a fresh namespace on
the CPU (``device="cpu"``) and holds itself to its own asserts.
"""

import pathlib
import re

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
    """Five snippets (fleet, structure, churn, async, producers and
    K-FAC), each on the port's front door and none importing JAX or the
    reference."""
    assert len(BLOCKS) == 5
    for block in BLOCKS:
        assert "from repro_torch import api" in block
        assert 'device="cpu"' in block
        assert not re.search(r"^\s*(import jax|from jax|import repro\b"
                             r"|from repro[ .])", block, re.M)


@pytest.mark.parametrize("i", range(len(BLOCKS)))
def test_port_readme_snippet_executes(i):
    ns: dict = {}
    exec(compile(BLOCKS[i], f"README.md:pytorch-port[{i}]", "exec"), ns)
