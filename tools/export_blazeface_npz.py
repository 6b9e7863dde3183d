"""Export the packaged BlazeFace checkpoint to the PyTorch package's .npz.

    python tools/export_blazeface_npz.py [--checkpoint DIR] [--out FILE]

Restores the orbax checkpoint of the JAX package
(``flyimg_tpu/models/weights/blazeface`` by default) with
``flyimg_tpu.models.blazeface.load_checkpoint`` and writes every array, as
stored (flax HWIO kernels, float32), into one ``.npz`` whose keys are the
tree paths joined by ``/`` (``params/BlazeBlock_0/Conv_0/kernel``). The
PyTorch package loads that file with numpy alone
(``flyimg_tpu_torch.models.blazeface.load_weights``): orbax and JAX are
needed here, once, and never where the port runs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CKPT = os.path.join(ROOT, "flyimg_tpu", "models", "weights", "blazeface")
DEFAULT_OUT = os.path.join(
    ROOT, "flyimg_tpu_torch", "models", "weights", "blazeface.npz"
)


def flatten(tree, prefix=""):
    """{"a/b/c": ndarray} of a nested dict of arrays, keys sorted."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        value = tree[key]
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="export_blazeface_npz")
    parser.add_argument("--checkpoint", default=DEFAULT_CKPT)
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from flyimg_tpu.models.blazeface import load_checkpoint

    arrays = flatten(load_checkpoint(args.checkpoint))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    total = sum(a.size for a in arrays.values())
    print(f"{args.out}: {len(arrays)} arrays, {total} values")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
