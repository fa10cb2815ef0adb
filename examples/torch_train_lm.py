"""Train an assigned-architecture LM on the streaming token pipeline, on
the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_train_lm.py --arch llama3_2_3b --steps 100
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 4

Uses the reduced config of any of the ported architectures but
``whisper_base`` (the launcher has no audio frames to feed it); the ETL
layer is the SigridHash token pipeline (``--etl-backend cuda``: the
hand-written kernels on the card, their plain versions with ``--device
cpu``), overlapped with training exactly like the recommender path.
"""

import argparse

from repro_torch.launch import train as train_launch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="default: CUDA; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    extra = ["--device", args.device] if args.device else []
    return train_launch.main([
        "--arch", args.arch, "--reduced", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir, *extra])


if __name__ == "__main__":
    main()
