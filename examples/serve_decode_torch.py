"""Continuous-batching serving through the PyTorch port across three
model families (dense GQA, Mamba2 SSD, hybrid Hymba): slot-cache decode
with on-device sampling, plus a node failure injected mid-traffic on the
dense arch — every request still completes
(``repro_torch/runtime/serve_exec.py``).  The counterpart of
``examples/serve_decode.py``.

    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

Runs on the card by default.
"""
import argparse

from repro_torch.launch.serve import main as serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for arch in ("qwen3-1.7b", "mamba2-780m", "hymba-1.5b"):
        print(f"\n=== {arch} ===")
        fail = ["--fail-at", "3"] if arch == "qwen3-1.7b" else []
        serve(["--arch", arch, "--batch", "2", "--prompt-len", "8",
               "--decode-steps", "8", "--layers", "2", "--requests", "4",
               "--device", args.device, *fail])


if __name__ == "__main__":
    main()
