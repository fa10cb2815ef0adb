"""Serve a small model with batched requests (prefill + decode loop), on
the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2_370m
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse

from repro_torch.launch import serve as serve_launch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_370m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="default: CUDA; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    extra = ["--device", args.device] if args.device else []
    return serve_launch.main(["--arch", args.arch, "--reduced",
                              "--batch", str(args.batch),
                              "--max-new", str(args.max_new), *extra])


if __name__ == "__main__":
    main()
