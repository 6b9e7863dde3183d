"""flyimg-tpu on PyTorch and CUDA.

The second implementation of the flyimg-tpu service, beside the JAX
package ``flyimg_tpu`` (the reference, which it never imports). The
device work of the main path — the windowed resample of
``GET /upload/w_300,h_250,c_1[,smc_1]/{src}`` and the smart-crop
saliency and candidate scoring — runs in PyTorch on an NVIDIA Hopper card,
with the banded resample, the saliency field and the scoring correlation
as CUDA kernels written for ``sm_90a`` (``csrc/``). Every entry point takes
a ``device`` that defaults to ``"cuda"``; pass ``"cpu"`` to run the plain
PyTorch twins of the kernels.
"""
