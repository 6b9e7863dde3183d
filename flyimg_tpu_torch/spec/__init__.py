"""The behavioral contract: URL option grammar + ImageMagick geometry semantics.

Everything in this package is pure Python with no JAX dependency — it is the
single source of truth both for the device pipeline and for the conformance
tests (ported from the reference's geometry oracle,
tests/Core/Processor/ImageProcessorTest.php).
"""

from flyimg_tpu_torch.spec.options import (  # noqa: F401
    DEFAULT_OPTIONS,
    OPTIONS_KEYS,
    OptionsBag,
)
from flyimg_tpu_torch.spec.geometry import (  # noqa: F401
    GeometryPlan,
    fit_dimensions,
    fill_dimensions,
    gravity_offset,
    resolve_geometry,
)
from flyimg_tpu_torch.spec.plan import TransformPlan, build_plan  # noqa: F401
