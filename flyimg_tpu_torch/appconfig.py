"""Server parameters: the keys this package reads, with the JAX package's
defaults, loaded from a dict or a JSON file (no YAML dependency)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from flyimg_tpu_torch.spec.options import DEFAULT_OPTIONS, OPTIONS_KEYS

SERVER_DEFAULTS: Dict[str, Any] = {
    "application_name": "flyimg-tpu",
    "header_cache_days": 365,
    "options_separator": ",",
    "header_extra_options": (
        "User-Agent: Mozilla/5.0 (Windows; U; Windows NT 6.1; rv:2.2) "
        "Gecko/20110201"
    ),
    "options_keys": dict(OPTIONS_KEYS),
    "default_options": dict(DEFAULT_OPTIONS),
    "upload_dir": "web/uploads",
    "tmp_dir": "var/tmp",
    "batch_max_size": 64,
    "batch_deadline_ms": 4.0,
    # dense | banded | auto (ops/resample.py); the env var seeds it as in
    # the JAX package
    "resample_kernel": os.environ.get("FLYIMG_RESAMPLE_KERNEL", "dense"),
    # auto | haar | blazeface | facefind | none (models/faces.py)
    "face_backend": "auto",
    # an .npz of BlazeFace weights (tools/export_blazeface_npz.py); None
    # is the packaged one
    "face_checkpoint": None,
}


class AppParameters:
    """Defaults overlaid with the given parameters."""

    def __init__(self, params: Optional[Dict[str, Any]] = None) -> None:
        self.params: Dict[str, Any] = dict(SERVER_DEFAULTS)
        if params:
            self.params.update(params)

    @classmethod
    def from_json(cls, path: str) -> "AppParameters":
        with open(path, "r", encoding="utf-8") as fh:
            return cls(json.load(fh) or {})

    def by_key(self, key: str, default: Any = None) -> Any:
        return self.params.get(key, default)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.params)
