"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU, each against the reference's script where both print the same
quantities: the simulator's and the search's lines are the reference's
to the character (the port's simulator is bit-identical to it); the
model's losses differ (torch draws other weights than jax), so those
scripts are held to their own checks.
"""
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import test_torch_ranks as ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(cmd, **env):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=ranks.child_env(**env), cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout.splitlines()


def _port(name, *args):
    return _run([sys.executable, "-m", f"repro_torch.examples.{name}",
                 "--device", "cpu", *args])


def _reference(name, *args):
    return _run([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                 *args], JAX_PLATFORMS="cpu")


def test_quickstart_prints_the_references_lines():
    got = _port("quickstart")
    want = _reference("quickstart")
    assert got[:len(want)] == want
    assert got[len(want):] == [got[-1]] and "bit-identical" in got[-1]


def _untimed(lines):
    """The lines, the search's wall-clock figures cut off."""
    return [ln.split(" in ")[0] if ln.startswith("searched ") else ln
            for ln in lines]


def test_strategy_search_prints_the_references_report():
    args = ("--devices", "8", "--global-batch", "8", "--arch",
            "bert_large")
    got = _port("strategy_search", *args)
    assert _untimed(got) == _untimed(_reference("strategy_search", *args))
    assert any(ln.startswith("searched 60 candidates") for ln in got)


def test_elastic_recovery_resumes_and_replans_as_the_reference():
    got = _port("elastic_recovery")
    want = _reference("elastic_recovery")
    resumed = [ln for ln in got if ln.startswith("real run:")]
    assert resumed and "resumed from step 10" in resumed[0]
    # the recovery count and the re-plan are the reference's lines
    assert got[:3] == want[:3]
    replan = got.index("== elastic re-plan: 256 devices, 13 fail ==")
    assert got[replan:] == want[want.index(got[replan]):]


def test_serve_batched_decodes_what_the_forward_computes():
    out = _port("serve_batched", "--requests", "2", "--gen", "8")
    assert "forward vs decode on the prompt's last token: agree (2e-3)" \
        in out
    assert any(ln.startswith("decode : p50=") for ln in out)


def test_train_100m_trains_and_resumes(tmp_path):
    """60 steps (a checkpoint at 50), then the same command again, which
    resumes from it."""
    args = ("--steps", "60", "--tiny", "--seq", "32", "--batch", "2",
            "--ckpt-dir", str(tmp_path))
    assert "done: 60 steps (resumed from None)" in _port("train_100m", *args)
    assert "done: 60 steps (resumed from 50)" in _port("train_100m", *args)
