"""Shared utilities of the port's benchmark scripts (``benchmarks/torch_*.py``):
one CSV line per result and the JSON payload under ``experiments/paper/``
(the directory is made when a payload is first written), and the paper's
four models' dimensions. The port's own copy of what it needs from the JAX
package's ``benchmarks/common.py``, which it does not import."""
import json
import pathlib

OUT = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "paper"

# the paper's four models: layers, model width, sequence length
PAPER_MODELS = {
    "roberta-base": dict(n_layers=12, d_model=768, n=512),
    "bert-large": dict(n_layers=24, d_model=1024, n=512),
    "gpt2-medium": dict(n_layers=24, d_model=1024, n=1024),
    "bloom-560m": dict(n_layers=24, d_model=1024, n=2048),
}


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")


def save_json(name: str, payload) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.json").write_text(json.dumps(payload, indent=1,
                                                 default=str))
