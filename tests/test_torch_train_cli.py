"""The port's training entry point (``python -m repro_torch.launch.train``)
on the CPU (``--device cpu``), run in-process through ``main(argv)``:

* without ``--smoke`` on fewer than 256 devices it prints the
  reference's fallback line and runs the SMOKE config; each step prints
  ``[train] step N loss L (S s)`` and the run ends with ``[train] done``;
* ``--steps 3 --ckpt-dir D`` then ``--steps 5`` with the same directory
  prints ``resumed from step 2`` and ends on the bits of an uninterrupted
  5-step run (every leaf of the final checkpoint, and the printed
  losses of steps 3 and 4);
* the LM and GNN train cells run through it too, a non-train shape is
  refused, and without ``--device cpu`` it raises on a host without
  CUDA."""

import os

import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.train import checkpoint as ckpt

FALLBACK = ("[train] 1 device(s) available; full config needs a pod -- "
            "falling back to --smoke")


def run(capsys, *argv):
    assert train.main(list(argv) + ["--device", "cpu"]) == 0
    return capsys.readouterr().out.splitlines()


def final_arrays(path):
    step = ckpt.latest_step(path)
    with np.load(os.path.join(path, f"step_{step:09d}", "arrays.npz")) as z:
        return step, [z[k] for k in sorted(z.files, key=int)]


def test_smoke_fallback_line_and_step_lines(capsys):
    lines = run(capsys, "--arch", "dien", "--steps", "2")
    assert lines[0] == FALLBACK
    assert [ln.split("loss")[0] for ln in lines[1:3]] == \
        ["[train] step    0 ", "[train] step    1 "]
    assert lines[-1] == "[train] done"
    assert FALLBACK not in run(capsys, "--arch", "dien", "--steps", "1",
                               "--smoke")


def test_resume_equals_an_uninterrupted_run_bit_for_bit(capsys, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first = run(capsys, "--arch", "dien", "--steps", "3", "--ckpt-dir", a)
    second = run(capsys, "--arch", "dien", "--steps", "5", "--ckpt-dir", a)
    whole = run(capsys, "--arch", "dien", "--steps", "5", "--ckpt-dir", b)
    assert "[train] resumed from step 2" in second
    assert not any("resumed" in ln for ln in first + whole)

    def losses(lines):
        return [ln.split("(")[0] for ln in lines if "loss" in ln]

    assert losses(first) + losses(second) == losses(whole)
    (sa, xa), (sb, xb) = final_arrays(a), final_arrays(b)
    assert sa == sb == 4 and len(xa) == len(xb) > 10
    for x, y in zip(xa, xb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "egnn"])
def test_lm_and_gnn_train_cells_run(capsys, arch):
    lines = run(capsys, "--arch", arch, "--steps", "2", "--smoke")
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines
              if "loss" in ln]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_refuses_non_train_shapes_and_needs_cuda_by_default(capsys):
    with pytest.raises(SystemExit, match="not a train step"):
        train.main(["--arch", "dien", "--shape", "serve_p99", "--smoke",
                    "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--arch", "dien", "--steps", "1"])
