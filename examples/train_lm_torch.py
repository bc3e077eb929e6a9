"""Train a reduced LM for a few hundred steps on the PyTorch/CUDA port with
the full loop (the train step through the `flash_attention` kernel and its
backward on a card, checkpoints written on a thread, an injected failure
and the restart from the last checkpoint, the straggler monitor) and check
that the loss drops: the twin of `examples/train_lm.py`.

Runs on the CUDA card unless `--cpu` is given (without a card and without
`--cpu` it raises):

  PYTHONPATH=src python examples/train_lm_torch.py [--cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        loss, report = train_main([
            "--arch", "llama3.2-1b", "--smoke", "--steps", "200",
            "--batch", "8", "--seq", "64", "--lr", "3e-3",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "50", "--chaos",
        ] + (["--device", "cpu"] if args.cpu else []))
    assert report["restarts"] == 1, "chaos restart must have happened"
    assert loss < 4.0, f"planted bigram structure not learned: {loss}"
    print(f"OK: trained through an injected failure to eval loss {loss:.3f}")
