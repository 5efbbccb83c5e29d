"""The port's five examples (``examples/torch_*.py``) run to the end on the
CPU at a small step count, each through its own command line with
``--device cpu``; the two figure examples with their benchmark's step
constants cut."""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import torch_noise  # noqa: E402
from benchmarks import torch_quant_perplexity as qppl  # noqa: E402

torch.set_num_threads(2)
EXAMPLES = ROOT / "examples"


def _run(monkeypatch, name, *argv):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return runpy.run_path(str(EXAMPLES / name), run_name="__main__")


def test_quickstart(monkeypatch, capsys):
    _run(monkeypatch, "torch_quickstart.py", "--device", "cpu")
    out = capsys.readouterr().out
    assert "loss:" in out and "generated:" in out


def test_serve_multiadapter(monkeypatch, capsys):
    g = _run(monkeypatch, "torch_serve_multiadapter.py", "--device", "cpu")
    assert sorted(g["done"]) == list(range(10))
    assert all(c.n_tokens == 12 for c in g["done"].values())
    assert g["stats"].prefix_cache.hit_tokens > 0
    g = _run(monkeypatch, "torch_serve_multiadapter.py", "--device", "cpu",
             "--spec-decode", "--draft", "ngram", "--spec-k", "2")
    assert sorted(g["done"]) == list(range(10))
    assert all(c.n_tokens == 12 for c in g["done"].values())
    assert g["stats"].spec.enabled and g["stats"].spec.k == 2
    assert "spec decode [ngram k=2]" in capsys.readouterr().out
    # the self-drafter takes no quantized base (nor does the JAX example's)
    with pytest.raises(ValueError, match="QuantizedTensor"):
        _run(monkeypatch, "torch_serve_multiadapter.py", "--device", "cpu",
             "--spec-decode", "--draft", "selfdraft")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        _run(monkeypatch, "torch_serve_multiadapter.py", "--device", "cpu",
             "--tp", "2")


def test_finetune_qlora_resumes_from_its_checkpoint(tmp_path):
    """The 10m preset, M8F8 with weight noise (the defaults), 50 steps at a
    tiny batch into a checkpoint directory (one checkpoint, at step 50); a
    second run of 52 steps resumes there. The 100m preset's model is the
    JAX example's (~92M parameters)."""
    g = runpy.run_path(str(EXAMPLES / "torch_finetune_qlora.py"))
    flags = ["--device", "cpu", "--batch", "2", "--seq", "8", "--ckpt-dir",
             str(tmp_path)]
    log, ppl = g["main"](flags + ["--steps", "50"])
    assert log[-1]["step"] == 50 and np.isfinite(ppl)
    assert any(tmp_path.iterdir())
    log, ppl = g["main"](flags + ["--steps", "52"])
    assert [r["step"] for r in log] == [51, 52] and np.isfinite(ppl)
    p = g["PRESETS"]["100m"]
    assert (p["n_layers"], p["d_model"], p["vocab_size"]) == (12, 512, 32000)


def test_noise_aware_finetune(monkeypatch, capsys):
    monkeypatch.setattr(torch_noise, "STEPS", 2)
    _run(monkeypatch, "torch_noise_aware_finetune.py", "--device", "cpu")
    out = capsys.readouterr().out
    assert "noise-aware" in out and "sigma = 0.03" in out


def test_quantization_sweep(monkeypatch, capsys):
    monkeypatch.setattr(qppl, "PRETRAIN_STEPS", 2)
    monkeypatch.setattr(qppl, "FT_STEPS", 1)
    _run(monkeypatch, "torch_quantization_sweep.py", "--device", "cpu")
    out = capsys.readouterr().out
    assert all(tag in out for tag in ("bf16", "M8F8", "M8F4", "M4F8",
                                      "M4F4"))
