"""The port's benchmark driver (``benchmarks/torch_run.py``) on the CPU:
its names are the JAX driver's, each script runs under it with
``--device cpu`` and lands in ``TORCH_BENCH_SUMMARY.json`` (never in the
JAX driver's ``BENCH_SUMMARY.json``), and a failing script makes it exit
1. The figure scripts that take minutes on the CPU (Figs. 9 and 13, the
serving workloads) are left to the card."""
import json
import pathlib
import re

import pytest

from benchmarks import torch_common, torch_run

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_names_and_scripts_mirror_the_jax_driver():
    src = (ROOT / "benchmarks" / "run.py").read_text()
    jax_mods = re.findall(r'\("(\w+)", (bench_\w+)\)', src)
    assert [n for n, _ in jax_mods] == [n for n, _, _ in torch_run.MODULES]
    for (_, bench), (_, script, _) in zip(jax_mods, torch_run.MODULES):
        assert script == "torch_" + bench[len("bench_"):]
        assert (ROOT / "benchmarks" / f"{script}.py").exists()


@pytest.fixture
def out(tmp_path, monkeypatch):
    monkeypatch.setattr(torch_common, "OUT", tmp_path)
    monkeypatch.setattr(torch_common, "ROWS", [])
    # the driver's --smoke sets the variable; the test's end restores it
    monkeypatch.setenv("BENCH_SMOKE", "0")
    return tmp_path


@pytest.mark.parametrize("name", ["kernels", "tableII", "fig7_breakdown",
                                  "fig6_systolic", "fig8_noc",
                                  "fig10_pipeline", "fig11_15_end2end",
                                  "fig12_14_quant_energy"])
def test_each_script_runs_under_the_driver_on_the_cpu(out, name, capsys):
    torch_run.main(["--smoke", "--device", "cpu", "--only", name])
    summary = json.loads((out / "TORCH_BENCH_SUMMARY.json").read_text())
    assert summary["smoke"] and summary["device"] == "cpu"
    assert summary["failures"] == 0 and summary["rows"]
    assert not (out / "BENCH_SUMMARY.json").exists()
    assert capsys.readouterr().out.startswith("name,us_per_call,derived")
    if name == "kernels":
        payload = json.loads((out / "torch_kernel_micro.json").read_text())
        assert set(payload) == {
            "device", "crossbar_int8", "crossbar_t_int8", "crossbar_int4",
            "crossbar_t_int4", "flash_attention", "flash_attention_bwd",
            "rwkv6_wkv", "rwkv6_wkv_bwd"}
        # the CPU wrappers run the plain versions themselves
        assert all(v["err"] == 0 for k, v in payload.items()
                   if k != "device")


def test_a_failing_script_makes_the_driver_exit_1(out, monkeypatch, capsys):
    from benchmarks import torch_noc

    def boom():
        raise RuntimeError("injected")

    monkeypatch.setattr(torch_noc, "run", boom)
    with pytest.raises(SystemExit) as exc:
        torch_run.main(["--only", "fig8_noc"])
    assert exc.value.code == 1
    assert "fig8_noc,nan,FAILED" in capsys.readouterr().out
    summary = json.loads((out / "TORCH_BENCH_SUMMARY.json").read_text())
    assert summary["failures"] == 1
    with pytest.raises(SystemExit, match="unknown benchmark"):
        torch_run.main(["--only", "nope"])
