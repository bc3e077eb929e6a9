"""Serve a small model with batched requests on the PyTorch/CUDA port:
prefill (through the `flash_attention` kernel on a card) + KV-cache greedy
decode, the twin of `examples/serve_lm.py`.

Runs on the CUDA card unless `--cpu` is given (without a card and without
`--cpu` it raises):

  PYTHONPATH=src python examples/serve_lm_torch.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args()
    tps = serve_main(["--arch", "llama3.2-1b", "--smoke", "--batch", "4",
                      "--prompt-len", "32", "--gen", "16"]
                     + (["--device", "cpu"] if args.cpu else []))
    assert tps > 0
    print("OK")
