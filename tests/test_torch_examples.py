"""The port's eight examples (``python -m repro_torch.examples.<name>``)
on the CPU (``--device cpu``) at the reference's CI settings (``--fast``
where the reference has it), run in-process through ``main(argv)``.

* The DSPC examples print the reference example's answers at the same
  arguments, exactly: ``quickstart`` all of its output;
  ``dynamic_stream`` every chunk's events, query and version and the
  update stats; ``serve_spc`` the read-your-writes read, the update
  stats, the front door's coalesced pairs and the writing session's
  read of its own write; ``analytics_spc`` every line but the timings
  and the re-rank's scores (its PNA weights and embedding table come
  from ``torch.Generator``s, not ``jax.random``).
* Each example's own checks hold: the answers against BFS counting, the
  restored replica's answers, ``gnn_molecule``'s learning and rotation
  invariance, ``serve_lm``'s decode / prefill agreement, ``train_lm``'s
  falling loss; ``fleet_spc`` (an updater process and a replica, marked
  ``slow`` as multi-process tests are) stays oracle-correct through the
  updater's death, a behind restart and a resumed stream.
* Without ``--device cpu`` an example raises on a host without CUDA."""

import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import (analytics_spc, dynamic_stream,
                                  gnn_molecule, quickstart, serve_lm,
                                  serve_spc, train_lm)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_output(name, argv, capsys, monkeypatch):
    """The reference's ``examples/<name>.py`` run in-process: its
    stdout lines."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [path] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def port_output(module, argv, capsys):
    capsys.readouterr()
    result = module.main(argv + ["--device", "cpu"])
    return result, capsys.readouterr().out.splitlines()


def matching(lines, pattern):
    return [m.group(0) for m in map(re.compile(pattern).search, lines) if m]


def test_quickstart_prints_the_reference_output(capsys, monkeypatch):
    ok, got = port_output(quickstart, [], capsys)
    assert ok and not any("MISMATCH" in ln for ln in got)
    assert got == reference_output("quickstart", [], capsys, monkeypatch)


def test_dynamic_stream_answers_equal_reference(capsys, monkeypatch):
    _, got = port_output(dynamic_stream, ["--fast"], capsys)
    want = reference_output("dynamic_stream", ["--fast"], capsys,
                            monkeypatch)
    def chunks(lines):        # each chunk's line, its timing taken out
        return [re.sub(r"acc=\d+\.\d+s ", "", ln) for ln in lines
                if ln.startswith("  events[")]

    assert chunks(got) == chunks(want) and chunks(got)
    assert matching(got, r"\d+ entries") == matching(want, r"\d+ entries")
    assert "  restored replica answers identically: OK" in got
    assert matching(got, r"UpdateStatsView\(.*\)") == \
        matching(want, r"UpdateStatsView\(.*\)")


def test_serve_spc_answers_equal_reference(capsys, monkeypatch):
    _, got = port_output(serve_spc, ["--fast"], capsys)
    want = reference_output("serve_spc", ["--fast"], capsys, monkeypatch)
    for pattern in (r"read_your_writes pinned .*", r"update stats: .*",
                    r"coalesced \d+ pairs", r"writer session: .*",
                    r"replayed \d+ events in \d+ submits"):
        assert matching(got, pattern) == matching(want, pattern), pattern
        assert matching(got, pattern), pattern


def test_analytics_spc_answers_equal_reference(capsys, monkeypatch):
    _, got = port_output(analytics_spc, ["--fast"], capsys)
    want = reference_output("analytics_spc", ["--fast"], capsys,
                            monkeypatch)

    def answers(lines):
        out = []
        for ln in lines:
            ln = re.sub(r"\d+\.\d+s", "<s>", ln)       # timings
            ln = re.sub(r"embeddings\): .*", "embeddings)", ln)  # scores
            out.append(ln)
        return out

    assert answers(got) == answers(want)
    assert any(ln.startswith("model re-rank") for ln in got)


def test_gnn_molecule_learns_and_is_rotation_invariant(capsys):
    _, got = port_output(gnn_molecule, [], capsys)
    assert got[-1] == "done."
    err = float(got[-2].split(":")[1])
    assert err < 1e-3


def test_serve_lm_decode_agrees_with_prefill(capsys):
    (agree, batch), got = port_output(serve_lm, [], capsys)
    assert agree == batch == 4 and got[-1] == "done."


def test_train_lm_loss_falls(capsys, tmp_path):
    (first, last), got = port_output(
        train_lm, ["--ckpt-dir", str(tmp_path)], capsys)
    assert last < first and "improved" in got[-1]
    assert len([ln for ln in got if "step-loss" in ln]) == 30


def test_examples_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for module, argv in ((quickstart, []), (dynamic_stream, ["--fast"]),
                         (serve_spc, ["--fast"]), (analytics_spc, ["--fast"]),
                         (gnn_molecule, []), (serve_lm, []),
                         (train_lm, ["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(argv)


@pytest.mark.slow
def test_fleet_spc_stays_oracle_correct_across_processes(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.fleet_spc", "--fast",
         "--device", "cpu", "--dir", str(tmp_path / "pub")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    assert "fleet demo OK" in proc.stdout
    assert "refusing to publish" in proc.stdout
