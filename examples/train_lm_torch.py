"""Train a ~130M Mamba2 LM on synthetic data with checkpoints, in the
PyTorch port (the twin of examples/train_lm.py).

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
      [--device cpu] [--smoke] [--lr 3e-4]

Uses the real launcher (repro_torch.launch.train), the same code path as
a sharded run, on one device (the CUDA card unless told otherwise), at
the full mamba2-130m config reduced in sequence length only (8 x 256).
Checkpoints go to a temporary directory, removed at the end.
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--smoke", action="store_true",
                    help="use reduced config instead of the full 130M")
    ap.add_argument("--lr", type=float, default=None,
                    help="peak learning rate (default: the launcher's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        argv = [
            "--arch", args.arch,
            "--steps", str(args.steps),
            "--batch", "8",
            "--seq", "256",
            "--ckpt-every", "100",
            "--log-every", "10",
            "--ckpt-dir", tmp,
        ]
        if args.smoke:
            argv.append("--smoke")
        if args.lr is not None:
            argv += ["--lr", str(args.lr)]
        if args.device:
            argv += ["--device", args.device]
        summary = train_main(argv)
    if not summary["loss_improved"]:
        raise SystemExit("loss did not improve over training")
    print("loss improved:", summary["loss_first"], "->", summary["loss_last"])
    return summary


if __name__ == "__main__":
    main()
