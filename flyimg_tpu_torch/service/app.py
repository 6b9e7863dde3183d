"""HTTP service of the PyTorch package, on the standard library.

The port of ``flyimg_tpu/service/app.py`` for the main path: a
``ThreadingHTTPServer`` with

- ``GET /upload/{options}/{imageSrc}`` — render (or serve from the output
  cache) and answer the image bytes with the reference's headers; ``o_auto``
  answers WebP when the request's Accept header names image/webp;
- ``GET /healthz`` — liveness plus the device it serves on;
- ``HEAD`` on either — the GET's status and headers, no body.

Errors map to the status codes of the JAX app's ``_error_response``; a
plan stage the port does not carry yet answers 501, and any other
exception 500. A 503 (a full batch queue past ``batch_max_queue_depth``,
an open upstream breaker, a launch that does not fit the card at one
member, a full host byte budget) carries Retry-After. Run it with

    python -m flyimg_tpu_torch.service.app serve --port 8080 [--params p.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple, Union

import torch

from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.exceptions import (
    AppException,
    DeadlineExceededException,
    ExecFailedException,
    InvalidArgumentException,
    MissingParamsException,
    NotPortedException,
    OriginUnavailableException,
    PayloadTooLargeException,
    ReadFileException,
    SecurityException,
    ServiceUnavailableException,
    UnsupportedMediaException,
)
from flyimg_tpu_torch.ops.resample import set_kernel_mode
from flyimg_tpu_torch.parallel.mesh import Mesh, make_mesh
from flyimg_tpu_torch.runtime.batcher import BatchController, containment_params
from flyimg_tpu_torch.runtime.memgovernor import MemoryGovernor
from flyimg_tpu_torch.testing import faults
from flyimg_tpu_torch.service.handler import ImageHandler
from flyimg_tpu_torch.service.response import image_headers, is_not_modified

_ERROR_STATUS = {
    SecurityException: 403,
    ReadFileException: 404,
    InvalidArgumentException: 400,
    UnsupportedMediaException: 415,
    DeadlineExceededException: 504,
    OriginUnavailableException: 502,
    ServiceUnavailableException: 503,
    PayloadTooLargeException: 413,
    NotPortedException: 501,
    ExecFailedException: 500,
    MissingParamsException: 500,
}

UPLOAD_PREFIX = "/upload/"


def error_status(exc: AppException) -> int:
    for cls, code in _ERROR_STATUS.items():
        if isinstance(exc, cls):
            return code
    return 500


def split_upload_path(path: str) -> Optional[Tuple[str, str]]:
    """``/upload/{options}/{imageSrc}`` -> (options, imageSrc), the source
    keeping its own slashes (the reference's ``imageSrc: .+`` route), or
    None for another path."""
    path = urllib.parse.unquote(urllib.parse.urlsplit(path).path)
    if not path.startswith(UPLOAD_PREFIX):
        return None
    options, sep, src = path[len(UPLOAD_PREFIX):].partition("/")
    if not sep or not options or not src:
        return None
    return options, src


def local_sp_mesh(device: torch.device) -> Optional[Mesh]:
    """The spatial-tiling mesh over this host's cards when there is more
    than one (serving meshes span local devices only), else None."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return make_mesh(axis_names=("sp",))


class FlyimgServer(ThreadingHTTPServer):
    """The HTTP server, its handler and its batcher."""

    daemon_threads = True

    def __init__(self, address, params: AppParameters,
                 device: Union[str, torch.device] = "cuda",
                 sp_mesh: Optional[Mesh] = None) -> None:
        set_kernel_mode(str(params.by_key("resample_kernel", "dense")))
        self.params = params
        injector = params.by_key("fault_injector")
        if injector is not None:
            faults.install(injector)
        governor = MemoryGovernor.from_params(params)
        self.batcher = BatchController(
            max_batch=int(params.by_key("batch_max_size", 64)),
            deadline_ms=float(params.by_key("batch_deadline_ms", 4.0)),
            device=device,
            governor=governor if governor.enabled else None,
            **containment_params(params),
        )
        if sp_mesh is None:
            sp_mesh = local_sp_mesh(self.batcher.device)
        self.handler = ImageHandler(
            params, device=self.batcher.device, batcher=self.batcher,
            sp_mesh=sp_mesh,
        )
        super().__init__(address, _RequestHandler)

    def server_close(self) -> None:
        super().server_close()
        self.batcher.close()


class _RequestHandler(BaseHTTPRequestHandler):
    server: FlyimgServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args) -> None:  # quiet by default
        pass

    def _send(self, status: int, body: bytes, headers=None) -> None:
        self.send_response(status)
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def do_HEAD(self) -> None:  # noqa: N802
        """The GET's status and headers, Content-Length included, and no
        body (the reference's aiohttp routes answer HEAD with their GET)."""
        self.do_GET()

    def do_GET(self) -> None:  # noqa: N802 (http.server's name)
        if self.path == "/healthz":
            dev = self.server.batcher.device
            body = {
                "status": "ok",
                "app": self.server.params.by_key("application_name"),
                "devices": [str(dev)],
            }
            self._send(200, json.dumps(body).encode(),
                       {"Content-Type": "application/json"})
            return
        parts = split_upload_path(self.path)
        if parts is None:
            self._send(404, b"Not Found", {"Content-Type": "text/plain"})
            return
        options, src = parts
        try:
            result = self.server.handler.process_image(
                options, src,
                accepts_webp="image/webp" in (self.headers.get("Accept") or ""))
        except AppException as exc:
            status = error_status(exc)
            headers = {"Content-Type": "text/plain; charset=utf-8"}
            if status == 503:
                headers["Retry-After"] = str(
                    max(1, int(getattr(exc, "retry_after_s", 1) or 1))
                )
            self._send(status, f"{type(exc).__name__}: {exc}".encode(), headers)
            return
        except Exception:
            # anything else is the server's fault: answer 500, as the
            # reference's app does, instead of dropping the connection
            traceback.print_exc(file=sys.stderr)
            self._send(500, b"500 Internal Server Error",
                       {"Content-Type": "text/plain; charset=utf-8"})
            return
        headers = image_headers(
            result, self.server.params.by_key("header_cache_days", 365)
        )
        if is_not_modified(self.headers, headers):
            self._send(304, b"", {
                k: v for k, v in headers.items()
                if k in ("ETag", "Cache-Control", "Expires",
                         "Last-Modified", "Vary")
            })
            return
        self._send(200, result.content, headers)


def make_server(
    params: Optional[AppParameters] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    device: Union[str, torch.device] = "cuda",
    sp_mesh: Optional[Mesh] = None,
) -> FlyimgServer:
    """A bound, not yet serving server (port 0 picks a free port).
    ``sp_mesh`` is the handler's tiling mesh (for example a virtual one);
    None takes the local cards' when there are more than one."""
    return FlyimgServer((host, port), params or AppParameters(), device, sp_mesh)


def serve_in_thread(server: FlyimgServer) -> threading.Thread:
    thread = threading.Thread(
        target=server.serve_forever, name="flyimg-torch-http", daemon=True
    )
    thread.start()
    return thread


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flyimg-tpu-torch")
    sub = parser.add_subparsers(dest="cmd")
    srv = sub.add_parser("serve", help="run the HTTP service")
    srv.add_argument("--host", default="0.0.0.0")
    srv.add_argument("--port", type=int, default=8080)
    srv.add_argument("--params", default=None, help="JSON parameters file")
    srv.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.cmd != "serve":
        parser.print_help()
        return 2
    params = (
        AppParameters.from_json(args.params) if args.params else AppParameters()
    )
    server = make_server(params, args.host, args.port, args.device)
    print(f"flyimg-tpu-torch serving on {args.host}:{server.server_address[1]} "
          f"({server.batcher.device})", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
