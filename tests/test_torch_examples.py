"""The torch examples (examples/quickstart_torch.py and
examples/full_workflow_torch.py, the counterparts of the JAX package's
examples) run on the CPU at their small size, each in a fresh interpreter
in a temporary directory: they print the lines tests/test_examples.py
holds the JAX examples to, write their files into ``--out`` (names of
their own, never the tracked quickstart_* files), and import neither jax
nor clonealign_tpu. Without ``--device cpu`` they ask for the card and
stop where there is none."""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run the example as a script, then report the foreign modules it imported
_RUN = ("import runpy, sys; path = sys.argv[1]; sys.argv = [path, *sys.argv[2:]]; "
        "runpy.run_path(path, run_name='__main__'); "
        "print('FOREIGN', sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'clonealign_tpu')))")


def _run_example(name, tmp_path, *args):
    env = dict(os.environ, MPLBACKEND="Agg")
    env["PYTHONPATH"] = _REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-c", _RUN, os.path.join(_REPO, "examples", name), *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_full_workflow_torch_example(tmp_path):
    proc = _run_example("full_workflow_torch.py", tmp_path, "--device", "cpu", "--small",
                        "--out", str(tmp_path / "out"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "served 200 new cells" in out
    # both cohorts recover the ground truth on this easy config
    assert "accuracy vs ground truth: 1.000" in out
    assert "accuracy 1.000" in out
    assert (tmp_path / "out" / "full_workflow_torch_fit.npz").exists()
    assert "FOREIGN []" in out
    assert sorted(os.listdir(tmp_path)) == ["out"]


def test_quickstart_torch_example(tmp_path):
    proc = _run_example("quickstart_torch.py", tmp_path, "--device", "cpu", "--small",
                        "--out", str(tmp_path / "out"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "assignment accuracy vs ground truth" in proc.stdout
    assert sorted(os.listdir(tmp_path / "out")) == [
        "quickstart_torch_elbo.png", "quickstart_torch_fit.npz", "quickstart_torch_tracks.png"]
    assert "FOREIGN []" in proc.stdout
    assert sorted(os.listdir(tmp_path)) == ["out"]


@pytest.mark.parametrize("name", ["quickstart_torch.py", "full_workflow_torch.py"])
def test_torch_examples_ask_for_the_card_by_default(tmp_path, name, monkeypatch):
    """``--device`` defaults to "cuda": without a card the example stops
    before any work, naming the request."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    proc = _run_example(name, tmp_path, "--small", "--out", str(tmp_path / "out"))
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert not (tmp_path / "out").exists()
