"""Shared utilities of the port's benchmark scripts (``benchmarks/torch_*.py``):
one CSV line per result (kept in ``ROWS`` for ``torch_run.py``'s summary),
a host timer, the JSON payload under ``experiments/paper/`` (the
directory is made when a payload is first written), and the paper's four
models' dimensions. The port's own copy of what it needs from the JAX
package's ``benchmarks/common.py``, which it does not import."""
import json
import pathlib
import time

import torch

OUT = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "paper"

ROWS = []

# the paper's four models: layers, model width, sequence length
PAPER_MODELS = {
    "roberta-base": dict(n_layers=12, d_model=768, n=512),
    "bert-large": dict(n_layers=24, d_model=1024, n=512),
    "gpt2-medium": dict(n_layers=24, d_model=1024, n=1024),
    "bloom-560m": dict(n_layers=24, d_model=1024, n=2048),
}


def emit(name: str, us_per_call: float, derived: str) -> None:
    ROWS.append((name, us_per_call, derived))
    print(f"{name},{us_per_call:.1f},{derived}")


def timed(fn, *args, n=3, **kw):
    """(the last output, host microseconds per call) of ``fn`` over ``n``
    calls after one warm-up; each call ends in a synchronisation of the
    card where one is in use, so the time is the call's, not its
    enqueue's."""
    def call():
        out = fn(*args, **kw)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out

    call()
    t0 = time.perf_counter()
    for _ in range(n):
        out = call()
    return out, (time.perf_counter() - t0) / n * 1e6


def save_json(name: str, payload) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.json").write_text(json.dumps(payload, indent=1,
                                                 default=str))
