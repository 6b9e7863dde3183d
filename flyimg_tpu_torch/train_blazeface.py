"""Train the BlazeFace face detector on the synthetic ellipse-face task.

    python -m flyimg_tpu_torch.train_blazeface [--steps 800] [--batch 16]
        [--seed 0] [--out build/blazeface-trained.npz] [--log-every 50]
        [--device cuda]

The PyTorch package's counterpart of ``tools/train_blazeface.py`` in its
synthetic mode: ``models/blazeface_train.py train_synthetic`` (kernels
K9-K14 on the card) from a fresh initialisation, then the weights as the
``.npz`` that ``models/blazeface.py load_weights`` and the service's
``face_checkpoint`` read. The JAX tool's real-photo mode (``--photos``,
``--real-fraction``) waits for the package's JPEG codec.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models import blazeface_train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flyimg_tpu_torch.train_blazeface",
        description="Train BlazeFace on synthetic ellipse faces. Synthetic mode "
                    "only: the JAX tool's --photos and --real-fraction wait for "
                    "a JPEG codec in this package.")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/blazeface-trained.npz",
                    help=".npz of the trained weights (flax tree paths, HWIO)")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    model, loss = blazeface_train.train_synthetic(
        steps=args.steps, batch=args.batch, seed=args.seed,
        log_every=args.log_every, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    took = time.perf_counter() - t0
    blazeface_train.save_weights(model, args.out)
    rate = args.steps / took if took > 0 else float("nan")
    print(f"{args.steps} steps of batch {args.batch} on {dev} in {took:.2f} s "
          f"({rate:.2f} steps/s, host data included); final loss {loss:.4f}; "
          f"weights in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
