"""examples/torch_port/ stays runnable.

Each port example is a user-facing entry point
(examples/torch_port/README.md); running them as real subprocesses with
``--device cpu`` (the kernels' plain versions) catches import breaks, API
drift and the invariants each script asserts (duration match, checkpoint
bit-identity, sync == asyncio, graph replay == eager).  Every JAX example
has its twin here, and a script asked for the card without one exits
with an error instead of running on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
PORT = EXAMPLES / "torch_port"

SCRIPTS = sorted(p.name for p in PORT.glob("*.py"))
# the JAX example each port script replaces under another name
RENAMED = {"jax_pipeline.py": "torch_pipeline.py"}


def test_every_jax_example_has_a_port_twin():
    jax_scripts = sorted(p.name for p in EXAMPLES.glob("*.py"))
    assert len(jax_scripts) >= 7
    assert sorted(RENAMED.get(s, s) for s in jax_scripts) == SCRIPTS
    table = (PORT / "README.md").read_text()
    assert all(f"`{s}`" in table for s in SCRIPTS)


def _run(script, *args):
    return subprocess.run([sys.executable, str(PORT / script), *args],
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs(script):
    proc = _run(script, "--device", "cpu")
    assert proc.returncode == 0, (
        f"{script} failed:\n{proc.stdout}\n{proc.stderr}")
    assert proc.stdout.strip().splitlines()[-1] == "ok", proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the no-card refusal needs a machine without one")
def test_example_without_a_card_refuses_cuda():
    proc = _run("torch_pipeline.py")
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "ok" not in proc.stdout
