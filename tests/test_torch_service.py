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
    status, _h, body = get(f"{base}/upload/w_100,fb_1/{src}")
    assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    assert get(f"{base}/upload/w_100,o_jpg/{src}")[0] == 415
    assert get(f"{base}/upload/w_100,o_bmp/{src}")[0] == 400
    assert get(f"{base}/nothing/here")[0] == 404


@pytest.mark.parametrize("opts", [
    "w_100,r_90", "w_120,r_-30,bg_%23336699", "w_200,h_150,c_1,clsp_Gray,sh_2x1",
    "w_150,mnchr_1", "w_160,ett_220x140,bg_red,blr_0x1",
])
def test_staged_options_match_jax_pipeline(service, opts):
    """Options that reach the device after the resample answer 200 and
    match the JAX package's run_plan within 1 u8 level (a dithered value
    may differ only where the JAX-side luma lies within 1e-3 of its
    threshold: none does on this source)."""
    _server, base, src, img = service
    status, headers, body = get(f"{base}/upload/{opts}/{src}")
    assert status == 200, body
    assert headers["Content-Type"] == "image/png"
    got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    ref = reference(img, opts)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_face_option_is_refused_not_ignored(service, tmp_path):
    """fb_1/fc_1 run the face pass (face_backend facefind: the source's
    skin blob is pixelated, or cropped to), matching the JAX package's
    handler with the same backend within 1 u8 level and in size; a server
    whose detector fails answers 500 naming the face stage, never the image
    with the faces left in. The JAX handler runs its face pass on the same
    URL."""
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage

    _server, base0, src, _img = service
    params = AppParameters({"upload_dir": str(tmp_path / "tu"),
                            "tmp_dir": str(tmp_path / "tt"),
                            "face_backend": "facefind"})
    server = make_server(params, device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    jparams = JAppParameters({"upload_dir": str(tmp_path / "ju"),
                              "tmp_dir": str(tmp_path / "jt"),
                              "face_backend": "facefind"})
    jhandler = JImageHandler(make_storage(jparams), jparams)
    try:
        _s, _h, plain = get(f"{base0}/upload/w_300,h_250,c_1/{src}")
        for opts in ("w_300,h_250,c_1,fb_1", "w_300,h_250,c_1,fc_1"):
            status, _h, body = get(f"{base}/upload/{opts}/{src}")
            assert status == 200, body
            assert body != plain
            got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
            ref = np.asarray(Image.open(io.BytesIO(
                jhandler.process_image(opts + ",o_png", src).content)).convert("RGB"))
            assert got.shape == ref.shape
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1

        class Broken:
            def detect_faces(self, image):
                raise RuntimeError("detector down")

        server.handler._face_backend = Broken()
        status, _h, body = get(f"{base}/upload/w_300,h_250,c_1,fb_1,rf_1/{src}")
        assert status == 500 and b"face-blur" in body
        status, _h, body = get(f"{base}/upload/w_300,h_250,c_1,fc_1,rf_1/{src}")
        assert status == 500 and b"face-crop" in body
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)

    class RecordingFaces:
        calls = []

        def detect_faces(self, image):
            self.calls.append(("detect", image.shape))
            return [(10, 10, 40, 40)]

        def blur_faces(self, image, faces):
            self.calls.append(("blur", len(faces)))
            return image

    jp = JAppParameters({"upload_dir": str(tmp_path / "u"),
                         "tmp_dir": str(tmp_path / "t")})
    faces = RecordingFaces()
    handler = JImageHandler(make_storage(jp), jp, face_backend=faces)
    handler.process_image("w_300,h_250,c_1,fb_1,o_png", src)
    assert faces.calls == [("detect", (250, 300, 3)), ("blur", 1)]


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


@pytest.mark.parametrize("opts", ["fb_1,o_png", "fc_1,o_png"])
def test_face_options_on_alpha_source_match_jax_handler(tmp_path, opts):
    """A face option on an RGBA source flattens over the background, as
    the JAX handler does (the crop answers a smaller frame than the alpha
    plane): the same mode, the same size and pixels within 1 u8 level."""
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage
    from flyimg_tpu_torch.entry import skin_ellipse_image

    rgb = skin_ellipse_image(np.random.default_rng(31), 240, 320, faces=1)
    alpha = np.full((240, 320), 200, np.uint8)
    src = tmp_path / "alpha_face.png"
    src.write_bytes(png.encode(rgb, alpha))
    params = AppParameters({"upload_dir": str(tmp_path / "tu"),
                            "tmp_dir": str(tmp_path / "tt"),
                            "face_backend": "facefind"})
    server = make_server(params, device="cpu")
    thread = serve_in_thread(server)
    try:
        status, _h, body = get(
            f"http://127.0.0.1:{server.server_address[1]}/upload/{opts}/{src}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    jparams = JAppParameters({"upload_dir": str(tmp_path / "ju"),
                              "tmp_dir": str(tmp_path / "jt"),
                              "face_backend": "facefind"})
    jhandler = JImageHandler(make_storage(jparams), jparams)
    ref_img = Image.open(io.BytesIO(jhandler.process_image(opts, str(src)).content))
    assert status == 200, body
    got_img = Image.open(io.BytesIO(body))
    assert got_img.mode == ref_img.mode == "RGB"
    got, ref = np.asarray(got_img), np.asarray(ref_img)
    assert got.shape == ref.shape
    if opts.startswith("fc_1"):
        assert got.shape[:2] != (240, 320)  # a crop, not the whole frame
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_unexpected_exception_answers_500(service, monkeypatch):
    """An exception that is not an AppException still gets an HTTP answer:
    500 with a plain-text body, not a closed connection."""
    server, base, src, _img = service

    def boom(options, source):
        raise RuntimeError("unexpected")

    monkeypatch.setattr(server.handler, "process_image", boom)
    status, headers, body = get(f"{base}/upload/w_100/{src}")
    assert status == 500
    assert headers["Content-Type"].startswith("text/plain")
    assert body == b"500 Internal Server Error"
    monkeypatch.undo()
    assert get(f"{base}/upload/w_100/{src}")[0] == 200
