"""Output stores: the port of ``flyimg_tpu/storage/__init__.py``.

``make_storage`` picks the backend by the ``storage_system`` parameter
(local, s3 or gcs) and arms its retry policy, hedged reads and metrics.
With ``l2_enable`` on, that backend becomes the per-replica L1 of a
``TieredStorage`` over the fleet-shared L2 (``l2_storage_system``: a
local directory at ``l2_upload_dir``, or S3 or GCS on the same config
dicts). Off, it is the plain single-tier store.
"""

from flyimg_tpu_torch.storage.base import Storage, StorageStat  # noqa: F401
from flyimg_tpu_torch.storage.local import LocalStorage  # noqa: F401


def _make_backend(system: str, params) -> Storage:
    """One tier's backend by system name (local | s3 | gcs)."""
    if system == "s3":
        from flyimg_tpu_torch.storage.s3 import S3Storage

        return S3Storage(params)
    if system == "gcs":
        from flyimg_tpu_torch.storage.gcs import GCSStorage

        return GCSStorage(params)
    return LocalStorage(params)


def make_storage(params, metrics=None) -> Storage:
    from flyimg_tpu_torch.runtime.resilience import RetryPolicy

    retry = RetryPolicy.from_params(params, metrics=metrics)
    storage = _make_backend(str(params.by_key("storage_system", "local")), params)
    storage.retry_policy = retry
    if bool(params.by_key("l2_enable", False)):
        from flyimg_tpu_torch.appconfig import AppParameters
        from flyimg_tpu_torch.storage.tiered import TieredStorage

        # the local L2 roots at its own (shared) directory; S3 and GCS read
        # the same config dicts as the single-tier stores
        l2_params = AppParameters({
            **params.as_dict(),
            "upload_dir": str(params.by_key("l2_upload_dir", "web/l2")),
        })
        l2 = _make_backend(str(params.by_key("l2_storage_system", "local")), l2_params)
        l2.retry_policy = retry
        l2.metrics = metrics
        storage.metrics = metrics
        storage = TieredStorage(
            storage, l2, metrics=metrics,
            # blake2b sidecars beside each L2 write, which the scrubber
            # verifies (runtime/tiersupervisor.py)
            checksum_enable=bool(params.by_key("l2_checksum_enable", False)),
        )
    storage.hedge_delay_s = (
        float(params.by_key("storage_hedge_delay_ms", 0.0) or 0.0) / 1000.0
    )
    storage.metrics = metrics
    return storage
