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
import torch_jpeg_stand_in as stand_in
from PIL import Image

from jax_fastcodec import fastcodec, use_in_jax  # noqa: F401

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


def test_error_statuses(service, tmp_path, monkeypatch, fastcodec):
    _server, base, src, _img = service
    assert get(f"{base}/upload/w_100/{src}.missing")[0] == 404
    status, _h, body = get(f"{base}/upload/w_100,fb_1/{src}")
    assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    # o_jpg: the port's JPEG encoder runs its kernels' plain versions on a
    # server on the CPU (nvJPEG refused it here before the port had its
    # own) and answers as the JAX handler does with its native library
    # (status, type, size; decoded pixels within JPEG_LEVELS of its
    # answer's)
    use_in_jax(monkeypatch, fastcodec)
    status, headers, body = get(f"{base}/upload/w_100,o_jpg,rf_1/{src}")
    ref = _jax_handler(tmp_path).process_image("w_100,o_jpg", src)
    assert status == 200 and headers["Content-Type"] == ref.spec.mime == "image/jpeg"
    got, want = (np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
                 for b in (body, ref.content))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= JPEG_LEVELS
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


@pytest.fixture(scope="module")
def tall_handlers(tmp_path_factory):
    """The port's handler with a virtual 8-rank CPU "sp" mesh and the JAX
    handler with the conftest's 8-device "sp" mesh, a 2048x256 seeded PNG
    (tests/test_handler.py's tall source) and a 2047-row one."""
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.parallel.mesh import make_mesh as jmake_mesh
    from flyimg_tpu.runtime.metrics import MetricsRegistry
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage
    from flyimg_tpu_torch.parallel.mesh import virtual_mesh
    from flyimg_tpu_torch.service.handler import ImageHandler

    root = tmp_path_factory.mktemp("tall")
    rng = np.random.default_rng(21)
    srcs = {}
    for rows in (2048, 2047):
        path = root / f"tall{rows}.png"
        Image.fromarray(rng.integers(0, 256, (rows, 256, 3), dtype=np.uint8)).save(path)
        srcs[rows] = str(path)
    handler = ImageHandler(AppParameters({"upload_dir": str(root / "tu"),
                                          "tmp_dir": str(root / "tt")}),
                           device="cpu", sp_mesh=virtual_mesh(8, "cpu"))
    jparams = JAppParameters({"upload_dir": str(root / "ju"), "tmp_dir": str(root / "jt")})
    metrics = MetricsRegistry()
    jhandler = JImageHandler(make_storage(jparams), jparams, metrics=metrics,
                             sp_mesh=jmake_mesh(axis_names=("sp",)))
    return handler, jhandler, metrics, srcs


def _tiled_counts(handler, metrics):
    summary = metrics.summary()
    return ((handler.tiled_resamples, handler.tiled_single_ops),
            (int(summary.get("flyimg_tiled_resamples_total", 0)),
             int(summary.get("flyimg_tiled_single_ops_total", 0))))


@pytest.mark.parametrize("opts,rows,taken", [
    ("w_128,o_png", 2048, (1, 0)),       # the halo-exchange resample
    ("r_-37,o_png", 2048, (0, 1)),       # the ring rotate
    ("blr_0x1.5,o_png", 2048, (0, 1)),   # the halo-exchange filter
    ("w_128,o_png", 2047, (0, 0)),       # one row short of TILE_MIN_ROWS
    ("w_128,h_200,c_1,o_png", 2048, (0, 0)),  # a crop: not the full frame
])
def test_tall_inputs_take_the_tiled_route_as_the_jax_handler(tall_handlers, opts, rows,
                                                             taken):
    """The port's handler takes the tiled route for exactly the plans the
    JAX handler's allowlists take, and answers within 1 u8 level of it."""
    handler, jhandler, metrics, srcs = tall_handlers
    before = _tiled_counts(handler, metrics)
    got = np.asarray(Image.open(io.BytesIO(handler.process_image(opts, srcs[rows]).content)))
    want = np.asarray(Image.open(io.BytesIO(jhandler.process_image(opts, srcs[rows]).content)))
    after = _tiled_counts(handler, metrics)
    moved = [tuple(a - b for a, b in zip(after[i], before[i])) for i in range(2)]
    assert moved == [taken, taken]
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _jax_handler(root):
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage

    jparams = JAppParameters({"upload_dir": str(root / "ju"), "tmp_dir": str(root / "jt")})
    return JImageHandler(make_storage(jparams), jparams)


def _small_source(root):
    """A 40x30 seeded PNG: w_40 leaves its pixels as they are, so both
    packages encode the same pixels."""
    img = np.random.default_rng(5).integers(0, 255, (30, 40, 3), dtype=np.uint8)
    path = root / "small.png"
    Image.fromarray(img).save(path, "PNG")
    return str(path)


@pytest.mark.parametrize("opts", ["clsp_CMYK,o_png", "clsp_CMYK", "w_200,clsp_CMYK,o_png",
                                  "clsp_CMYK,o_webp", "w_200,clsp_CMYK,o_gif"])
def test_cmyk_outside_jpeg_is_refused_as_the_jax_handler(service, tmp_path, opts):
    """clsp_CMYK with a PNG, WebP or GIF output (asked for, or the PNG
    source's own) answers 400 with the JAX handler's exception and
    message; a JPEG container passes the rule and answers a four-component
    Adobe JPEG equal to the JAX handler's (a 415 before the port wrote
    CMYK JPEGs)."""
    _server, base, src, _img = service
    with pytest.raises(Exception) as exc:
        _jax_handler(tmp_path).process_image(opts, src)
    assert type(exc.value).__name__ == "InvalidArgumentException"
    status, headers, body = get(f"{base}/upload/{opts}/{src}")
    assert status == 400
    assert body.decode() == f"{type(exc.value).__name__}: {exc.value}"
    small = _small_source(tmp_path)
    status, headers, body = get(f"{base}/upload/w_40,clsp_CMYK,o_jpg/{small}")
    assert status == 200 and headers["Content-Type"] == "image/jpeg"
    assert body[2:18] == b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    assert b"\xff\xc0\x00\x14\x08\x00\x1e\x00\x28\x04" in body   # 40x30, 4 components
    assert body == _jax_handler(tmp_path).process_image("w_40,clsp_CMYK,o_jpg", small).content


def _request(url, method):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, method=method),
                                    timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def _reference_app_head(root, path):
    """(status, headers, body) of HEAD ``path`` on the JAX package's app."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.app import make_app

    async def go():
        app = make_app(JAppParameters({"upload_dir": str(root / "ru"),
                                       "tmp_dir": str(root / "rt"),
                                       "batch_deadline_ms": 1.0}))
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.head(path)
            return resp.status, dict(resp.headers), await resp.read()
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


@pytest.mark.parametrize("opts", ["w_40,o_png", "w_100,o_bmp"])
def test_head_answers_the_get_without_a_body(service, tmp_path, opts):
    """HEAD on an /upload URL: the GET's status, Content-Type and
    Content-Length, an empty body, and the reference app's answer."""
    _server, base, _src, _img = service
    src = _small_source(tmp_path)
    url = f"{base}/upload/{opts}/{src}"
    got = _request(url, "GET")
    head = _request(url, "HEAD")
    assert head[0] == got[0]
    for key in ("Content-Type", "Content-Length"):
        assert head[1][key] == got[1][key]
    assert int(head[1]["Content-Length"]) == len(got[2]) > 0
    assert head[2] == b""
    ref = _reference_app_head(tmp_path, f"/upload/{opts}/{src}")
    assert ref[0] == head[0]
    assert ref[2] == b""
    if ref[0] == 200:
        for key in ("Content-Type", "Content-Length"):
            assert ref[1][key] == head[1][key]


def test_refresh_headers_match_the_jax_handler(service, tmp_path):
    """rf_1: the reference's debug headers, im-identify included, equal to
    the JAX handler's; only the timings and the stored file's mtime (in
    ETag and Last-Modified) may differ."""
    from flyimg_tpu.service.response import image_headers as jimage_headers

    _server, base, _src, _img = service
    src = _small_source(tmp_path)
    opts = "w_40,rf_1,o_png"
    status, headers, body = get(f"{base}/upload/{opts}/{src}")
    ref = jimage_headers(_jax_handler(tmp_path).process_image(opts, src), 365)
    assert status == 200
    assert "im-identify" in ref
    for key, value in ref.items():
        if key == "ETag":
            assert headers[key].rsplit("-", 1)[0] == value.rsplit("-", 1)[0]
        elif key not in ("x-flyimg-timings", "Last-Modified"):
            assert headers[key] == value, key
    assert headers["im-identify"].endswith(f" {len(body)}B")


#: JPEG answers of the two handlers, decoded: their pixels differ by at most
#: one level before the encode (the bound of every test above), and a
#: lossy encode can turn that into a few levels
JPEG_LEVELS = 6
#: a lossy WebP answer of the port against the JAX handler's, both measured
#: against the JAX handler's PNG answer of the same URL: the PSNR the
#: port's answer may lose. It catches a broken encode, not an encoder's
#: trade: these sources are 40x30 (six macroblocks), where two encoders at
#: one quality land up to about 2 dB apart either way and neither's PSNR
#: rises monotonically with quality (tools/webp_rd.py's smooth 40x30
#: image: -1.85 dB at 0.81x libwebp's bytes at q75; PERF.md, PR 15). The
#: encoder's own bound on frames of photo size, 0.75 dB at no more than
#: 1.3x the bytes, is tests/test_torch_webp.py's.
WEBP_PSNR_LOSS_DB = 3.0


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _decoded(data, mode="RGB"):
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


@pytest.fixture(scope="module")
def jpeg_source(tmp_path_factory):
    """A 1920x1080 q90 JPEG (4:2:0) of the seeded source image: at
    w_300,h_250 both handlers decode it at half scale."""
    root = tmp_path_factory.mktemp("torch_jpeg")
    img = np.asarray(Image.fromarray(source_image()).resize((1920, 1080), Image.BILINEAR))
    path = root / "photo.jpg"
    Image.fromarray(img).save(path, "JPEG", quality=90)
    return str(path)


def get_accepting(url, accept):
    req = urllib.request.Request(url, headers={"Accept": accept})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


@pytest.mark.parametrize("opts", ["w_300,h_250,c_1", "w_300,h_250,c_1,smc_1"])
@pytest.mark.parametrize("out,accept,mime", [
    ("", "*/*", "image/jpeg"),                    # o_auto, the JPEG source's own type
    # o_auto for a client that accepts WebP: lossy WebP, as the JAX handler
    # answers it
    (",o_auto", "image/webp,*/*", "image/webp"),
    (",o_webp,webpl_1", "*/*", "image/webp"),
    (",o_jpg,q_75,sf_2x2", "*/*", "image/jpeg"),
])
def test_jpeg_source_answers_match_the_jax_handler(service, jpeg_source, tmp_path,
                                                   monkeypatch, request, opts, out, accept,
                                                   mime):
    """A JPEG upload through the port's server (its nvJPEG decode by the
    stand-in) and the JAX handler: the same status, type, storage name and
    size; a lossless WebP answer's pixels are within 1 level of the JAX
    handler's PNG answer of the same URL, a lossy one's PSNR against that
    PNG answer at least the JAX handler's WebP answer's less
    WEBP_PSNR_LOSS_DB; a JPEG answer's decoded pixels are within
    JPEG_LEVELS of the JAX handler's with its native library in place
    (both trellis encodes). The source decodes at the scale the target
    hint picks (4 of 8)."""
    _server, base, _src, _img = service
    stand_in.install(monkeypatch)
    if mime == "image/jpeg":
        use_in_jax(monkeypatch, request.getfixturevalue("fastcodec"))
    # rf_1: render anew (o_auto and o_webp name one stored output)
    status, headers, body = get_accepting(f"{base}/upload/{opts}{out},rf_1/{jpeg_source}",
                                          accept)
    assert status == 200, body
    assert stand_in.decode.calls and stand_in.decode.calls[0]["scale_num"] == 4
    jhandler = _jax_handler(tmp_path)
    ref = jhandler.process_image(opts + out + ",rf_1", jpeg_source,
                                 accepts_webp="image/webp" in accept)
    assert headers["Content-Type"] == ref.spec.mime == mime
    assert headers["im-identify"].split(" ", 1)[0] == ref.spec.name
    got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    want = np.asarray(Image.open(io.BytesIO(ref.content)).convert("RGB"))
    assert got.shape == want.shape
    if mime == "image/webp":
        exact = jhandler.process_image(opts + ",o_png", jpeg_source).content
        exact = np.asarray(Image.open(io.BytesIO(exact)).convert("RGB"))
        if "webpl_1" in out:
            assert np.abs(got.astype(int) - exact.astype(int)).max() <= 1
        else:
            assert _psnr(got, exact) >= _psnr(want, exact) - WEBP_PSNR_LOSS_DB
    else:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= JPEG_LEVELS
        call = stand_in.encode.calls[-1]
        assert call["encoder"] == "encode_trellis" and call["progressive"]
        assert call["quality"] == (75 if "q_75" in out else 90)
        assert call["sampling"] == ((2, 2) if "sf_2x2" in out else (1, 1))


@pytest.mark.parametrize("opts", ["w_40,o_webp,webpl_1,rf_1", "w_40,o_jpg,rf_1",
                                  "w_40,o_webp,rf_1"])
def test_refresh_identify_of_jpeg_and_webp_matches_the_jax_handler(service, tmp_path,
                                                                    monkeypatch, opts):
    """rf_1's im-identify line of a JPEG and a WebP answer names the
    container and size as the JAX handler's does (the byte counts differ
    with the encoders)."""
    from flyimg_tpu.service.response import image_headers as jimage_headers

    _server, base, _src, _img = service
    stand_in.install(monkeypatch)
    src = _small_source(tmp_path)
    status, headers, body = get(f"{base}/upload/{opts}/{src}")
    ref = jimage_headers(_jax_handler(tmp_path).process_image(opts, src), 365)
    assert status == 200
    assert headers["Content-Type"] == ref["Content-Type"]
    assert headers["im-identify"].rsplit(" ", 1)[0] == ref["im-identify"].rsplit(" ", 1)[0]
    assert headers["im-identify"].endswith(f" {len(body)}B")


@pytest.mark.parametrize("opts", ["w_40,o_webp", "w_40,o_webp,webpl_0"])
def test_lossy_webp_output_is_refused_where_the_jax_handler_encodes(service, tmp_path,
                                                                   opts):
    """o_webp without webpl_1 answers lossy WebP, as the JAX handler does
    (the name is the test's from before the port had a VP8 encoder): the
    same type, storage name, im-identify up to the byte count and size,
    and a PSNR against the JAX handler's PNG answer at least the JAX
    handler's WebP answer's less WEBP_PSNR_LOSS_DB."""
    _assert_webp_answer_matches(service, tmp_path, opts, "*/*", "image/webp")


def _webp_source(root, alpha=False):
    """A lossy WebP of the seeded source image (40x30 with w_40 as it is)."""
    img = source_image(30, 40, seed=9)
    if alpha:
        img = np.dstack([img, np.linspace(0, 255, 30 * 40).reshape(30, 40).astype(np.uint8)])
    path = root / ("alpha.webp" if alpha else "lossy.webp")
    Image.fromarray(img).save(path, "WEBP", quality=80)
    return str(path)


def _rgba_png_source(root):
    img = np.dstack([source_image(30, 40, seed=11),
                     np.tile(np.arange(0, 240, 6, dtype=np.uint8), (30, 1))])
    path = root / "rgba.png"
    Image.fromarray(img, "RGBA").save(path, "PNG")
    return str(path)


def _assert_webp_answer_matches(service, tmp_path, opts, accept, mime, src=None):
    """The port's answer of ``opts`` for a client sending ``accept``
    against the JAX handler's: status, Content-Type, storage name,
    im-identify up to its byte count, size; a WebP answer's PSNR against
    the JAX handler's PNG answer at least the JAX handler's WebP answer's
    less WEBP_PSNR_LOSS_DB, its alpha (if any) the JAX answer's exactly."""
    _server, base, _src, _img = service
    src = src or _small_source(tmp_path)
    status, headers, body = get_accepting(f"{base}/upload/{opts},rf_1/{src}", accept)
    jhandler = _jax_handler(tmp_path)
    ref = jhandler.process_image(opts + ",rf_1", src, accepts_webp="image/webp" in accept)
    assert status == 200, body
    assert headers["Content-Type"] == ref.spec.mime == mime
    assert headers["im-identify"].split(" ", 1)[0] == ref.spec.name
    assert headers["im-identify"].rsplit(" ", 1)[0] == ref.spec.identify_repr.rsplit(" ", 1)[0]
    assert headers["im-identify"].endswith(f" {len(body)}B")
    got, want = _decoded(body, "RGBA"), _decoded(ref.content, "RGBA")
    assert got.shape == want.shape
    if mime == "image/webp":
        exact = _decoded(jhandler.process_image(opts + ",o_png", src).content, "RGBA")
        assert _psnr(got[..., :3], exact[..., :3]) >= \
            _psnr(want[..., :3], exact[..., :3]) - WEBP_PSNR_LOSS_DB
        np.testing.assert_array_equal(got[..., 3], want[..., 3])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("accept,mime", [
    ("image/avif,image/webp,image/apng,*/*;q=0.8", "image/webp"),  # a browser's
    ("image/webp", "image/webp"),
    ("*/*", "image/png"),
    ("image/png,image/*;q=0.8", "image/png"),
])
@pytest.mark.parametrize("opts", ["w_40", "w_40,o_auto"])
def test_o_auto_negotiates_webp_as_the_jax_handler(service, tmp_path, accept, mime, opts):
    """o_auto (the default) answers lossy WebP to a client whose Accept
    names image/webp and the PNG source's own type to any other, with the
    JAX handler's storage name (``.webp`` for a negotiated answer)."""
    _assert_webp_answer_matches(service, tmp_path, opts, accept, mime)


@pytest.mark.parametrize("accept,mime", [("*/*", "image/webp"),
                                         ("image/webp,*/*", "image/webp")])
@pytest.mark.parametrize("alpha", [False, True])
def test_lossy_webp_source_is_served_as_the_jax_handler(service, tmp_path, accept, mime,
                                                        alpha):
    """A lossy WebP source (with and without an ALPH chunk) is served:
    o_auto answers WebP, as the JAX handler does."""
    _assert_webp_answer_matches(service, tmp_path, "w_40", accept, mime,
                                src=_webp_source(tmp_path, alpha))


@pytest.mark.parametrize("opts", ["w_40,o_webp", "w_40,o_webp,q_50", "w_40"])
def test_rgba_png_source_answers_webp_with_its_alpha(service, tmp_path, opts):
    """An RGBA PNG source answered as lossy WebP keeps its alpha exactly
    (an ALPH chunk), as the JAX handler's answer does."""
    _assert_webp_answer_matches(service, tmp_path, opts, "image/webp,*/*", "image/webp",
                                src=_rgba_png_source(tmp_path))


@pytest.mark.parametrize("sf", ["1x4", "3x1"])
def test_sampling_factor_nvjpeg_lacks_is_refused_where_the_jax_handler_encodes(
        service, tmp_path, monkeypatch, fastcodec, sf):
    """A JPEG answer with sampling factors nvJPEG cannot subsample to
    answered 415 until the port had its own encoder (the test keeps its
    name): it now answers 200 image/jpeg with the JAX handler's bytes (its
    native library in place), and a factor that does not parse still
    answers 400 before any decode or encode."""
    _server, base, _src, _img = service
    stand_in.install(monkeypatch)
    use_in_jax(monkeypatch, fastcodec)
    src = _small_source(tmp_path)
    opts = f"w_40,o_jpg,sf_{sf}"
    status, headers, body = get(f"{base}/upload/{opts}/{src}")
    assert status == 200 and headers["Content-Type"] == "image/jpeg"
    assert [c["sampling"] for c in stand_in.encode.calls] == \
        [tuple(int(f) for f in sf.split("x"))]
    assert body == _jax_handler(tmp_path).process_image(opts, src).content
    stand_in.encode.calls.clear()
    status, _h, body = get(f"{base}/upload/w_40,o_jpg,sf_{sf}x1/{src}")
    assert status == 400 and b"invalid sampling factor" in body
    assert stand_in.encode.calls == [] and stand_in.decode.calls == []


def test_gif_output_is_still_refused(service, tmp_path):
    """o_gif was refused until the port wrote GIF (codecs/gif.py): over HTTP
    it now answers 200 with a GIF body, the JAX handler's size and pixels
    within 30 dB of its answer."""
    _server, base, src, _img = service
    status, headers, body = get(f"{base}/upload/w_40,o_gif/{src}")
    assert status == 200 and headers["Content-Type"] == "image/gif"
    assert body[:6] in (b"GIF87a", b"GIF89a")
    want = _jax_handler(tmp_path).process_image("w_40,o_gif", src).content
    got, ref = (np.asarray(Image.open(io.BytesIO(b)).convert("RGB")).astype(np.float64)
                for b in (body, want))
    assert got.shape == ref.shape
    mse = np.mean((got - ref) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 30.0
