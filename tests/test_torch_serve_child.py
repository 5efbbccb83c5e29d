"""``chip_smoke.moe_serve_child`` on the CPU, with the child process faked:
the serve line handed back on its ``SERVE_RESULT`` line is returned and not
printed, every other line of the child is printed as it came, then one
``serve_child`` line, and a child that fails or hands back nothing fails
the phase.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

ARCH = "jamba-1.5-large-398b"
SERVE = {"phase": "serve", "model": ARCH, "ticks": 40,
         "serve_launches": {"crossbar_matmul": 1200}}
SPEC = {"phase": "spec", "model": ARCH, "launches": {"crossbar_matmul": 90}}


@pytest.fixture
def child(monkeypatch):
    """Replaces ``subprocess.run`` in ``chip_smoke``: the child prints
    ``out`` and ``err`` and exits with ``rc``; ``calls`` keeps each
    command."""
    state = {"out": [], "err": "", "rc": 0, "calls": []}

    def run(cmd, **kw):
        state["calls"].append((cmd, kw))
        return subprocess.CompletedProcess(
            cmd, state["rc"], "\n".join(state["out"]) + "\n", state["err"])

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    return state


def _result_line(result):
    return chip_smoke.SERVE_RESULT + json.dumps(result)


def test_the_child_runs_this_script_with_the_serve_flag(child):
    child["out"] = [_result_line(SERVE)]
    chip_smoke.moe_serve_child(ARCH)
    [(cmd, kw)] = child["calls"]
    assert cmd[0] == sys.executable
    assert Path(cmd[1]) == ROOT / "chip_smoke.py"
    assert cmd[2:] == [chip_smoke.SERVE_FLAG, ARCH]
    assert kw["capture_output"] and kw["text"] and kw["timeout"] > 0


def test_the_serve_line_comes_back_and_the_other_lines_are_printed(
        child, capsys):
    full = dict(SERVE, spec_launches=SPEC["launches"])
    child["out"] = [json.dumps(SERVE), json.dumps(SPEC), _result_line(full)]
    assert chip_smoke.moe_serve_child(ARCH) == full
    printed = capsys.readouterr().out.splitlines()
    assert printed[:2] == [json.dumps(SERVE), json.dumps(SPEC)]
    tail = json.loads(printed[2])
    assert tail["phase"] == "serve_child" and tail["model"] == ARCH
    assert tail["seconds"] >= 0 and tail["main_process_reserved_gb"] == 0
    assert len(printed) == 3
    assert not any(ln.startswith(chip_smoke.SERVE_RESULT) for ln in printed)


@pytest.mark.parametrize("rc, hand_back", [(1, True), (1, False), (0, False)],
                         ids=["failed", "failed-silent", "no-result"])
def test_a_child_that_fails_or_hands_back_nothing_fails(child, rc, hand_back):
    child["out"] = [json.dumps(SERVE)] + ([_result_line(SERVE)]
                                          if hand_back else [])
    child["rc"], child["err"] = rc, "AssertionError: the trace holds ..."
    with pytest.raises(AssertionError, match=f"the {ARCH} serve failed "
                       f"\\(rc {rc}\\).*the trace holds"):
        chip_smoke.moe_serve_child(ARCH)


def test_the_result_line_is_not_json_for_log_readers():
    line = _result_line(SERVE)
    with pytest.raises(json.JSONDecodeError):
        json.loads(line)
    assert not line.startswith("{")


def test_the_train_child_runs_this_script_with_the_train_flag(child, capsys):
    """``moe_train_child`` runs the same way with ``TRAIN_FLAG``: its train
    line comes back from its own ``TRAIN_RESULT`` line, then one
    ``train_child`` line."""
    arch = "llama4-scout-17b-a16e"
    train = {"phase": "train", "model": arch, "run_launches": {
        "grouped_crossbar_matmul_t": 960}}
    child["out"] = [json.dumps(SERVE), chip_smoke.TRAIN_RESULT
                    + json.dumps(train)]
    assert chip_smoke.moe_train_child(arch) == train
    [(cmd, _)] = child["calls"]
    assert cmd[2:] == [chip_smoke.TRAIN_FLAG, arch]
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == json.dumps(SERVE)
    assert json.loads(printed[1])["phase"] == "train_child"
    assert len(printed) == 2
