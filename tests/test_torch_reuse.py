"""The PyTorch package's derivative reuse (flyimg_tpu_torch/runtime/
variantindex.py, ``spec.plan.rewrite_for_reuse``, ``reuse_frame_key``,
``lossy_output`` and the handler's ``_try_reuse`` / ``_record_variant``)
held against the JAX package's on the CPU:

- the rewriter gives the JAX plan, target box and reason for every reason
  case of tests/test_reuse.py (and the widened floor), ``reuse_frame_key``
  and ``lossy_output`` the JAX answers;
- ``VariantIndex``: a manifest written by either package reads in the
  other (the same JSON layout), and the TTL, the bounds, the cold rebuild,
  the discard and the cold record behave as the JAX index's;
- the handlers, the JAX ``ImageHandler`` against the port's
  ``ImageHandler(device="cpu")`` on the same seeded source: after a
  ``w_128`` ancestor, each derivative reuse-hits the same ancestor in both,
  renders with the source and its origin cache gone, and is within 2 u8
  levels (the JAX package's reuse bound, tests/test_reuse.py) of the same
  URL rendered from the source and of the JAX reuse answer; each unsafe
  case falls back with the same outcome counted; a torn or pruned ancestor
  falls back and leaves the index; with reuse off nothing is indexed and
  the answers are the default ones.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.runtime.metrics import MetricsRegistry as JMetricsRegistry
from flyimg_tpu.runtime.variantindex import VariantFacts as JVariantFacts
from flyimg_tpu.runtime.variantindex import VariantIndex as JVariantIndex
from flyimg_tpu.service.handler import ImageHandler as JImageHandler
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import lossy_output as jlossy_output
from flyimg_tpu.spec.plan import reuse_frame_key as jreuse_frame_key
from flyimg_tpu.spec.plan import rewrite_for_reuse as jrewrite_for_reuse
from flyimg_tpu.storage.local import LocalStorage as JLocalStorage
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.exceptions import ReadFileException
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry
from flyimg_tpu_torch.runtime.variantindex import VariantFacts, VariantIndex, manifest_name
from flyimg_tpu_torch.service.handler import ImageHandler
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import (
    REUSE_MAX_GENERATIONS,
    REUSE_MIN_SCALE,
    lossy_output,
    reuse_frame_key,
    rewrite_for_reuse,
)
from flyimg_tpu_torch.storage.local import LocalStorage
from flyimg_tpu_torch.testing import faults

torch.set_num_threads(1)

#: a reuse answer against the same URL from the source (tests/test_reuse.py)
REUSE_TOL = 2

ANCESTOR = "w_128,o_png"


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.clear()


def _gradient(w=256, h=192):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([xx * (255.0 / (w - 1)), yy * (255.0 / (h - 1)),
                     (xx + yy) * (255.0 / (w + h - 2))], -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# the rewriter


def _facts(cls, **over):
    base = dict(name="anc.png", out_w=128, out_h=96, extension="png", quality=90,
                lossy=False, pure=True, colorspace=None, monochrome=False,
                background=None, generations=0, src_w=256, src_h=192,
                frame_key=reuse_frame_key(OptionsBag("")), stored_at=0.0)
    base.update(over)
    return cls(**base)


REWRITE_CASES = [
    ({}, "w_40,o_png", "png"),
    ({"pure": False}, "w_40,o_png", "png"),
    ({}, "w_40,e_1,p1x_0,p1y_0,p2x_50,p2y_50,o_png", "png"),
    ({}, "w_40,fc_1,o_png", "png"),
    ({}, "w_40,fb_1,o_png", "png"),
    ({}, "w_40,smc_1,o_png", "png"),
    ({}, "w_40,st_0,o_png", "png"),
    ({"frame_key": "2||00:00:01|0"}, "w_40,o_png", "png"),
    ({"colorspace": "gray"}, "w_40,o_png", "png"),
    ({"monochrome": True}, "w_40,o_png", "png"),
    ({"generations": 1}, "w_40,o_png", "png"),
    ({"lossy": True, "extension": "jpg"}, "w_40,o_png", "png"),
    ({"lossy": True, "extension": "jpg"}, "w_40,o_webp,webpl_1", "webp"),
    ({"lossy": True, "extension": "jpg", "quality": 70}, "w_40,q_90,o_jpg", "jpg"),
    ({"lossy": True, "extension": "jpg", "quality": 95}, "w_40,q_90,o_jpg", "jpg"),
    ({}, "w_40,bg_red,o_png", "png"),
    ({}, "w_100,o_png", "png"),
    ({}, "w_64,h_48,c_1,o_png", "png"),
    ({}, "w_60,h_40,c_1,g_North,o_png", "png"),
    ({}, "r_90,w_40,clsp_gray,o_png", "png"),
    ({}, "w_40,h_40,pns_0,o_png", "png"),
    ({}, "h_30,par_0,o_png", "png"),
    ({"out_w": 90, "out_h": 60}, "w_60,h_45,c_1,o_png", "png"),
]


@pytest.mark.parametrize("over,opts,ext", REWRITE_CASES)
@pytest.mark.parametrize("widened", [False, True])
def test_rewrite_for_reuse_matches_jax(over, opts, ext, widened):
    kw = dict(min_scale=1.3, max_generations=REUSE_MAX_GENERATIONS + 1) if widened else {}
    plan, box, why = rewrite_for_reuse(OptionsBag(opts), ext, _facts(VariantFacts, **over), **kw)
    jplan, jbox, jwhy = jrewrite_for_reuse(JOptionsBag(opts), ext,
                                           _facts(JVariantFacts, **over), **kw)
    assert why == jwhy
    assert box == jbox
    assert repr(plan) == repr(jplan)


@pytest.mark.parametrize("opts", ["", "gf_0", "gf_2", "pg_1", "pg_3,dnst_150", "tm_00:00:05",
                                  "o_jpg", "o_webp", "o_webp,webpl_1", "o_png"])
def test_frame_key_and_lossy_output_match_jax(opts):
    assert reuse_frame_key(OptionsBag(opts)) == jreuse_frame_key(JOptionsBag(opts))
    for ext in ("jpg", "png", "webp", "gif"):
        assert lossy_output(ext, OptionsBag(opts)) == jlossy_output(ext, JOptionsBag(opts))
    assert (REUSE_MIN_SCALE, REUSE_MAX_GENERATIONS) == (2.0, 1)


# ---------------------------------------------------------------------------
# the index and its manifests


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_written_by_either_package_reads_in_the_other(tmp_path, writer):
    ours_store = LocalStorage(AppParameters({"upload_dir": str(tmp_path / "u")}))
    their_store = JLocalStorage(JAppParameters({"upload_dir": str(tmp_path / "u")}))
    facts = [dict(name="a.png"), dict(name="b.jpg", extension="jpg", lossy=True, quality=85,
                                      out_w=200, out_h=150, generations=1,
                                      background=(255, 0, 0))]
    ours, theirs = VariantIndex(storage=ours_store), JVariantIndex(storage=their_store)
    write, read = (theirs, ours) if writer == "jax" else (ours, theirs)
    cls = JVariantFacts if writer == "jax" else VariantFacts
    for f in facts:
        write.record("original-x", "image/png", _facts(cls, **f))
    entry = read.lookup("original-x")
    assert entry is not None and entry.source_mime == "image/png"
    got = {v.name: v for v in entry.variants}
    for f in facts:
        want = _facts(cls, **f)
        row = got[want.name]
        assert [getattr(row, k) for k in want.__dataclass_fields__] == [
            getattr(want, k) for k in want.__dataclass_fields__]
    assert [v.name for v in entry.candidates()] == ["b.jpg", "a.png"]
    # the same document, byte for byte, from the same facts
    pair = []
    for index_cls, facts_cls, store_cls, params_cls, sub in (
            (VariantIndex, VariantFacts, LocalStorage, AppParameters, "bt"),
            (JVariantIndex, JVariantFacts, JLocalStorage, JAppParameters, "bj")):
        store = store_cls(params_cls({"upload_dir": str(tmp_path / sub)}))
        index = index_cls(storage=store)
        for f in facts:
            index.record("original-x", "image/png", _facts(facts_cls, **f))
        pair.append(store.read(manifest_name("original-x")))
    assert pair[0] == pair[1]


def _index_script(mod_index, mod_facts, storage, clock):
    """The JAX index tests' steps; returns what each answered."""
    out = []
    index = mod_index(ttl_s=10.0, max_sources=2, max_variants=2, storage=storage, clock=clock)
    index.record("original-x", "image/png", _facts(mod_facts))
    out.append(index.lookup("original-x") is not None)
    storage.delete(manifest_name("original-x"))
    out.append(index.lookup("original-x") is not None)
    clock.now += 11.0
    out.append(index.lookup("original-x") is None)
    for i in range(3):
        index.record(f"original-{i}", "image/png", _facts(mod_facts, name=f"v{i}.png"))
    out.append(index.lookup("original-0") is None)
    index.record("original-2", "image/png", _facts(mod_facts, name="big.png", out_w=512,
                                                   out_h=384))
    index.record("original-2", "image/png", _facts(mod_facts, name="mid.png", out_w=256,
                                                   out_h=192))
    entry = index.lookup("original-2")
    out.append(sorted(v.name for v in entry.variants))
    out.append(entry.candidates()[0].name)
    index.discard("original-2", "big.png")
    out.append(sorted(v.name for v in index.lookup("original-2").variants))
    out.append(len(index))
    index.record("original-z", "image/png", _facts(mod_facts, pure=False))
    out.append(len(index))
    storage.write(manifest_name("original-y"), b"not json{")
    out.append(mod_index(storage=storage).lookup("original-y") is None)
    cold = mod_index(storage=storage)
    cold.record("original-2", "", _facts(mod_facts, name="d.png", out_w=200, out_h=150))
    doc = json.loads(storage.read(manifest_name("original-2")))
    out.append((sorted(doc["variants"]), doc["source_mime"], doc["v"]))
    return out


def test_index_behaves_as_jax(tmp_path):
    ours = _index_script(VariantIndex, VariantFacts,
                         LocalStorage(AppParameters({"upload_dir": str(tmp_path / "t")})),
                         _Clock())
    theirs = _index_script(JVariantIndex, JVariantFacts,
                           JLocalStorage(JAppParameters({"upload_dir": str(tmp_path / "j")})),
                           _Clock())
    assert ours == theirs


# ---------------------------------------------------------------------------
# the handlers


@pytest.fixture()
def env(tmp_path):
    """The port's reuse-on and reuse-off handlers and the JAX reuse-on
    handler, each with its own store and origin cache, and the source."""
    src = tmp_path / "src.png"
    Image.fromarray(_gradient()).save(src, "PNG")

    def ours(sub, **extra):
        metrics = MetricsRegistry()
        params = AppParameters({"upload_dir": str(tmp_path / sub / "u"),
                                "tmp_dir": str(tmp_path / sub / "t"), **extra})
        return ImageHandler(params, device="cpu", metrics=metrics)

    jparams = JAppParameters({"upload_dir": str(tmp_path / "jax" / "u"),
                              "tmp_dir": str(tmp_path / "jax" / "t"), "reuse_enable": True})
    theirs = JImageHandler(JLocalStorage(jparams), jparams, metrics=JMetricsRegistry())
    return ours("on", reuse_enable=True), ours("off"), theirs, str(src), tmp_path


def _pixels(content):
    return np.asarray(Image.open(io.BytesIO(content)).convert("RGB")).astype(int)


def _outcome(metrics, outcome):
    return metrics.summary().get(f'flyimg_reuse_hits_total{{outcome="{outcome}"}}', 0)


DERIVATIVES = [
    "w_48,h_36,c_1,o_png", "w_40,o_png", "w_60,h_40,c_1,g_North,o_png",
    "w_32,h_32,c_1,o_png", "w_44,h_33,c_1,q_85,o_png", "w_40,clsp_gray,o_png",
    "r_90,w_40,o_png",
]


def test_derivatives_reuse_the_ancestor_as_jax(env):
    on, off, theirs, src, _root = env
    for handler in (on, theirs):
        seeded = handler.process_image(ANCESTOR, src)
        assert seeded.reused_from is None
    for opts in DERIVATIVES:
        got, want = on.process_image(opts, src), theirs.process_image(opts, src)
        assert got.reused_from == want.reused_from and got.reused_from is not None, opts
        assert got.from_cache is want.from_cache is False
        direct = off.process_image(opts, src)
        assert direct.reused_from is None
        a, b, c = _pixels(got.content), _pixels(want.content), _pixels(direct.content)
        assert a.shape == b.shape == c.shape, opts
        assert np.abs(a - c).max() <= REUSE_TOL, opts
        assert np.abs(a - b).max() <= REUSE_TOL, opts
        assert got.timings["reuse_hit"] == got.timings["total"]
    assert _outcome(on.metrics, "hit") == _outcome(theirs.metrics, "hit") == len(DERIVATIVES)
    assert len(on.variants) == len(theirs.variants)
    assert len(off.variants) == 0
    uploads = os.listdir(os.path.dirname(off.storage._path("x")))
    assert not [n for n in uploads if n.endswith(".variants.json")]


def test_reuse_renders_with_the_origin_gone(env):
    on, _off, theirs, src, root = env
    on.process_image(ANCESTOR, src)
    theirs.process_image(ANCESTOR, src)
    os.remove(src)
    for sub in ("on", "jax"):
        for name in os.listdir(root / sub / "t"):
            os.remove(root / sub / "t" / name)
    got, want = (on.process_image("w_48,h_36,c_1,o_png", src),
                 theirs.process_image("w_48,h_36,c_1,o_png", src))
    assert got.reused_from == want.reused_from is not None
    with pytest.raises(ReadFileException):
        on.process_image("w_200,o_png", src)


UNSAFE = [
    (ANCESTOR, "w_100,o_png", "unsafe"),
    (ANCESTOR, "e_1,p1x_100,p1y_50,p2x_200,p2y_150,w_40,o_png", "unsafe"),
    (ANCESTOR, "w_40,fb_1,o_png", "unsafe"),
    (ANCESTOR, "w_40,h_40,smc_1,o_png", "unsafe"),
    (ANCESTOR, "w_40,bg_red,o_png", "unsafe"),
    (ANCESTOR, "w_40,st_0,o_png", "unsafe"),
    ("w_128,o_jpg,q_70", "w_40,o_jpg,q_90", "unsafe"),
    ("w_128,o_jpg,q_95", "w_40,o_png", "unsafe"),
    ("w_128,clsp_gray,o_png", "w_40,o_png", "miss"),
]


@pytest.mark.parametrize("ancestor,opts,outcome", UNSAFE)
def test_unsafe_requests_fall_back_as_jax(env, ancestor, opts, outcome):
    on, _off, theirs, src, _root = env
    for handler in (on, theirs):
        handler.process_image(ancestor, src)
    before = (_outcome(on.metrics, outcome), _outcome(theirs.metrics, outcome))
    got, want = on.process_image(opts, src), theirs.process_image(opts, src)
    assert got.reused_from is None and want.reused_from is None
    assert (_outcome(on.metrics, outcome) - before[0]
            == _outcome(theirs.metrics, outcome) - before[1] == 1)
    assert _pixels(got.content).shape == _pixels(want.content).shape


@pytest.mark.parametrize("damage", ["pruned", "torn", "fault"])
def test_damaged_ancestor_falls_back_and_leaves_the_index(env, damage):
    on, _off, _theirs, src, _root = env
    seeded = on.process_image(ANCESTOR, src)
    before = len(on.variants)
    if damage == "pruned":
        on.storage.delete(seeded.spec.name)
    elif damage == "torn":
        on.storage.write(seeded.spec.name, b"\x89PNG\r\n\x1a\n" + b"\xde\xad" * 64)
    else:
        faults.install(faults.FaultInjector()).plan(
            "reuse.ancestor", lambda **_: (_ for _ in ()).throw(OSError("pruned")))
    got = on.process_image("w_48,h_36,c_1,o_png", src)
    assert got.reused_from is None
    assert _pixels(got.content).shape == (36, 48, 3)
    assert _outcome(on.metrics, "hit") == 0 and _outcome(on.metrics, "unsafe") == 1
    assert len(on.variants) < before


def test_chain_generations_and_refresh_as_jax(env):
    on, _off, theirs, src, _root = env
    rows = []
    for handler in (on, theirs):
        handler.process_image("w_128,o_jpg,q_95", src)
        child = handler.process_image("w_60,o_jpg,q_90", src)
        key = OptionsBag.hash_original_image_url(src)
        facts = {v.name: v for v in handler.variants.lookup(key).variants}
        refreshed = handler.process_image("w_128,o_jpg,q_95,rf_1", src)
        rows.append((child.reused_from is not None, facts[child.spec.name].generations,
                     (facts[child.spec.name].src_w, facts[child.spec.name].src_h),
                     refreshed.reused_from, len(handler.variants)))
    assert rows[0] == rows[1] == (True, 1, (256, 192), None, 2)


def test_degraded_level_widens_reuse_as_jax(env, tmp_path):
    from flyimg_tpu.runtime import brownout as jbrownout
    from flyimg_tpu.testing import faults as jfaults
    from flyimg_tpu_torch.runtime import brownout

    on, _off, theirs, src, _root = env
    on.brownout = brownout.BrownoutEngine(enabled=True, min_dwell_s=0.0)
    theirs.brownout = jbrownout.BrownoutEngine(enabled=True, min_dwell_s=0.0)
    rows = []
    for handler, mod in ((on, faults), (theirs, jfaults)):
        handler.process_image("w_96,o_png", src)
        normal = handler.process_image("w_60,h_45,c_1,o_png", src)
        mod.install(mod.FaultInjector()).plan("brownout.signal", lambda **_: 0.7)
        try:
            assert handler.brownout.evaluate() == brownout.DEGRADED
            widened = handler.process_image("w_60,h_45,c_1,q_80,o_png", src)
        finally:
            mod.clear()
        rows.append((normal.reused_from, widened.reused_from is not None))
    assert rows[0] == rows[1] == (None, True)
