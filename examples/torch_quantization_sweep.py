"""MnFm quantization sweep on the port (paper Fig. 13; counterpart of
``examples/quantization_sweep.py``): pretrain a small base, quantize it
crossbar-wise at every MnFm config, LoRA-fine-tune, report perplexity.
Runs ``benchmarks/torch_quant_perplexity.py``.

    PYTHONPATH=src:. python examples/torch_quantization_sweep.py [--device cpu]
"""
import argparse

from benchmarks import torch_quant_perplexity

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
payload = torch_quant_perplexity.run(ap.parse_args().device)
print()
print("perplexity by quantization config (lower is better):")
for tag, ppl in payload["ppl"].items():
    print(f"  {tag:6s} {ppl:.3f}")
print("expected ordering (paper Fig. 13): bf16 ~ M8F8 <= M8F4 < M4F4")
