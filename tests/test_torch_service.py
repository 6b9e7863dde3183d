"""The PyTorch package's HTTP service on the CPU, end to end: GET
/upload/{options}/{local png} through the standard-library server, the
batcher and the handler, held against the JAX package's run_plan +
find_best_crops_batched + apply_crop on the same source (bound: 1 u8
level, equal dimensions), with the reference's headers, a repeat served
from storage, and the reference's error statuses."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.models import smartcrop as js
from flyimg_tpu.ops.compose import run_plan as jrun_plan
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.service.app import make_server, serve_in_thread

torch.set_num_threads(1)

LONG_CACHE = 365 * 24 * 3600


def source_image(h=330, w=420, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        128 + 80 * np.sin(yy / 37.0 + c) * np.cos(xx / 53.0 - c)
        for c in range(3)
    ], -1)
    cy, cx = 0.3 * h, 0.7 * w
    blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 30.0 ** 2))[..., None]
    img = img * (1 - blob) + np.array([200.0, 146.0, 112.0]) * blob
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_service")
    src = root / "source.png"
    img = source_image()
    Image.fromarray(img).save(src, "PNG")
    params = AppParameters({
        "upload_dir": str(root / "uploads"), "tmp_dir": str(root / "tmp"),
        "resample_kernel": "dense",
    })
    server = make_server(params, device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield server, base, str(src), img
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def reference(img, opts):
    h, w = img.shape[:2]
    plan = jbuild_plan(JOptionsBag(opts), w, h)
    out = jrun_plan(img, plan)
    if plan.smart_crop:
        crop = js.find_best_crops_batched([js.prepare_work(out)])[0]
        out = js.apply_crop(out, crop)
    return out


@pytest.mark.parametrize("opts", ["w_300,h_250,c_1", "w_300,h_250,c_1,smc_1"])
def test_upload_matches_jax_pipeline(service, opts):
    server, base, src, img = service
    status, headers, body = get(f"{base}/upload/{opts}/{src}")
    assert status == 200, body
    assert headers["Content-Type"] == "image/png"
    assert headers["Cache-Control"] == (
        f"max-age={LONG_CACHE}, public, s-maxage={LONG_CACHE}"
    )
    assert headers["Vary"] == "Accept"
    got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    ref = reference(img, opts)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1

    # a repeat is served from storage: same bytes, no device launch
    launches = len(server.batcher.launch_log)
    status2, headers2, body2 = get(f"{base}/upload/{opts}/{src}")
    assert status2 == 200 and body2 == body
    assert len(server.batcher.launch_log) == launches
    assert headers2["ETag"] == headers["ETag"]


def test_error_statuses(service):
    _server, base, src, _img = service
    assert get(f"{base}/upload/w_100/{src}.missing")[0] == 404
    status, _h, body = get(f"{base}/upload/w_100,r_90/{src}")
    assert status == 501 and b"rotate" in body
    assert get(f"{base}/upload/w_100,o_jpg/{src}")[0] == 415
    assert get(f"{base}/upload/w_100,o_bmp/{src}")[0] == 400
    assert get(f"{base}/nothing/here")[0] == 404


def test_healthz(service):
    _server, base, _src, _img = service
    status, _h, body = get(f"{base}/healthz")
    assert status == 200
    assert json.loads(body)["devices"] == ["cpu"]


def test_alpha_source_flattens_over_background(service, tmp_path):
    _server, base, _src, _img = service
    rgba = np.zeros((120, 160, 4), np.uint8)
    rgba[..., 0] = 200
    rgba[..., 3] = np.linspace(0, 255, 160).astype(np.uint8)[None, :]
    path = tmp_path / "alpha.png"
    path.write_bytes(png.encode(rgba[..., :3], rgba[..., 3]))
    status, _h, body = get(f"{base}/upload/w_80,h_60,c_1/{path}")
    assert status == 200
    out = np.asarray(Image.open(io.BytesIO(body)))
    assert out.shape == (60, 80, 3)
    # left edge transparent over white, right edge opaque red
    assert out[30, 0].tolist()[1] > 200 and out[30, -1].tolist()[1] < 30


def test_http_source_through_urllib(service, tmp_path):
    """An http(s) source is fetched with urllib (here from a localhost
    origin) and cached as an original."""
    import functools
    import threading
    from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

    _server, base, src, img = service
    (tmp_path / "origin.png").write_bytes(open(src, "rb").read())
    handler = functools.partial(SimpleHTTPRequestHandler, directory=str(tmp_path))
    origin = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=origin.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{origin.server_address[1]}/origin.png"
        status, headers, body = get(f"{base}/upload/w_300,h_250,c_1/{url}")
        missing = get(f"{base}/upload/w_300,h_250,c_1/{url}.gone")[0]
    finally:
        origin.shutdown()
        origin.server_close()
        thread.join(timeout=10)
    assert status == 200 and headers["Content-Type"] == "image/png"
    got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    ref = reference(img, "w_300,h_250,c_1")
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert missing == 404
