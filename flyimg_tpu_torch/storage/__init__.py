"""Output stores: the port of ``flyimg_tpu/storage/__init__.py``.

``make_storage`` picks the backend by the ``storage_system`` parameter and
arms its retry policy, hedged reads and metrics. Only ``local`` is ported;
``s3``, ``gcs`` and the tiered L1/L2 store (``l2_enable``) raise
``NotPortedException`` when the server is made.
"""

from flyimg_tpu_torch.exceptions import NotPortedException
from flyimg_tpu_torch.storage.base import Storage, StorageStat  # noqa: F401
from flyimg_tpu_torch.storage.local import LocalStorage  # noqa: F401


def make_storage(params, metrics=None) -> Storage:
    from flyimg_tpu_torch.runtime.resilience import RetryPolicy

    system = str(params.by_key("storage_system", "local"))
    if system != "local":
        raise NotPortedException(
            f"storage_system {system!r} is not ported to the PyTorch package "
            "yet (local only)")
    if bool(params.by_key("l2_enable", False)):
        raise NotPortedException(
            "the tiered L1/L2 store (l2_enable) is not ported to the PyTorch "
            "package yet")
    storage = LocalStorage(params)
    storage.retry_policy = RetryPolicy.from_params(params, metrics=metrics)
    storage.hedge_delay_s = (
        float(params.by_key("storage_hedge_delay_ms", 0.0) or 0.0) / 1000.0
    )
    storage.metrics = metrics
    return storage
