"""Noise-aware fine-tuning on the port (paper SS V.E / Fig. 9; counterpart
of ``examples/noise_aware_finetune.py``): train LoRA adapters with Gaussian
noise injected into the frozen base so deployment on non-ideal crossbars
doesn't cost accuracy. Runs ``benchmarks/torch_noise.py``.

    PYTHONPATH=src:. python examples/torch_noise_aware_finetune.py [--device cpu]
"""
import argparse

from benchmarks import torch_noise

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
payload = torch_noise.run(ap.parse_args().device)
print()
print(f"sigma = {payload['sigma_rel']} x absmax")
print(f"ideal accuracy        : {payload['ideal_acc']:.4f}")
print(f"naive  (clean-trained): {payload['naive_acc']:.4f}  "
      f"(gap {payload['gap_naive_pct']:.2f}pp)")
print(f"noise-aware           : {payload['noise_aware_acc']:.4f}  "
      f"(gap {payload['gap_aware_pct']:.2f}pp)")
print("paper claim: noise-aware recovers to <0.5% of ideal")
