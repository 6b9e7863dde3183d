"""The PyTorch package stands alone: importing every module of
flyimg_tpu_torch (and chip_smoke.py) loads neither jax nor the JAX package;
its entry points default to CUDA and raise on a host without it instead of
running on the CPU; chip_smoke.py fails, printing no result, without a card
and without the package beside it."""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import flyimg_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            flyimg_tpu_torch.__path__, prefix="flyimg_tpu_torch."
        )
    )


def test_every_module_imports_without_jax_or_the_jax_package(tmp_path):
    mods = _all_modules()
    assert "flyimg_tpu_torch.service.app" in mods
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'flyimg_tpu' or n.startswith('flyimg_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the CPU-only behaviour "
                    "is what is pinned here")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    _no_cuda()
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.entry import entry
    from flyimg_tpu_torch.models import smartcrop
    from flyimg_tpu_torch.ops.compose import run_plan
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.service.app import make_server
    from flyimg_tpu_torch.service.handler import ImageHandler
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan

    img = np.zeros((64, 64, 3), np.uint8)
    plan = build_plan(OptionsBag("w_32"), 64, 64)
    params = AppParameters({"upload_dir": str(tmp_path / "u"),
                            "tmp_dir": str(tmp_path / "t")})
    calls = [
        lambda: entry(batch=1),
        lambda: run_plan(img, plan),
        lambda: smartcrop.find_best_crops_batched([smartcrop.prepare_work(img)]),
        lambda: smartcrop.smart_crop_image(img),
        lambda: BatchController(),
        lambda: ImageHandler(params),
        lambda: make_server(params),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    _no_cuda()
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
