"""Spatial tiling of the PyTorch package (flyimg_tpu_torch/parallel/) held
against the JAX package's (flyimg_tpu/parallel/) on the CPU: the same
seeded images through the JAX tiled program on the conftest's virtual CPU
devices and through the port on a virtual CPU mesh of the same n ranks
(n = 2, 4, 8).

Bounds (PERF.md section 2):
- tiled_transform within 1e-3 of JAX's (f32; sums in another order), the
  filter within 1e-4, required_halo equal, the halo exchange equal;
- tiled_rotate within 1e-4 of JAX's untiled rotate (in fact equal: the
  port follows the written arithmetic). Against JAX's jitted ring program
  it is held to one rounding of the sample position: XLA on the CPU fuses
  some of the ring's products and sums into multiply-adds, which ones
  changing with n and the angle, so xs and ys may differ by an ulp, which
  moves a bilinear blend of u8 values by at most 2 * 255 * ulp; values
  whose position lies within 2 ulp of the inside test's edge are skipped;
- tiled against untiled (the JAX tests' own bounds): resample 0.75,
  rotate 0.51, filter 1e-3.
"""

import socket
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flyimg_tpu.ops.rotate import rotate_image as jrotate_image
from flyimg_tpu.parallel import tiling as jt
from flyimg_tpu.parallel.mesh import make_mesh as jmake_mesh
from flyimg_tpu_torch.entry import dryrun_multichip
from flyimg_tpu_torch.ops import filters as tfilters
from flyimg_tpu_torch.ops.resample import resample_image
from flyimg_tpu_torch.ops.rotate import (
    ring_geometry,
    ring_rotate_step,
    ring_rotate_step_plain,
    rotate_image,
)
from flyimg_tpu_torch.parallel import dist, tiling
from flyimg_tpu_torch.parallel.mesh import Mesh, default_mesh, make_mesh, virtual_mesh
from flyimg_tpu_torch.spec.plan import rotated_bounds

torch.set_num_threads(1)

RESAMPLE_TOL = 1e-3
FILTER_TOL = 1e-4
ROTATE_TOL = 1e-4


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@lru_cache(maxsize=None)
def _jmesh(n):
    return jmake_mesh((n,), ("sp",), jax.devices()[:n])


def _tmesh(n):
    return virtual_mesh(n, "cpu")


def _untiled_resample(img, out_hw, method):
    h, w = img.shape[:2]

    def rows(v):
        return torch.tensor([v], dtype=torch.float32)

    return resample_image(
        torch.from_numpy(img)[None].float(), out_hw, rows([0.0, float(h)]),
        rows([0.0, float(w)]), rows([float(v) for v in out_hw]),
        rows([float(h), float(w)]), method,
    )[0].numpy()


# ---------------------------------------------------------------------------
# halo-exchange resample
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _jax_transform(shape, out_hw, n, method, seed):
    img = _image(shape, seed)
    return img, np.asarray(jt.tiled_transform(jnp.asarray(img), out_hw, _jmesh(n),
                                              method=method))


_GEOMETRIES = [
    ((512, 384, 3), (128, 96)),     # divisible heights
    ((515, 96, 3), (123, 64)),      # indivisible: padded rows and drift
    ((256, 90, 3), (400, 61)),      # an upscale; a width no multiple of 4
]


@pytest.mark.parametrize("kernel", ["dense", "banded"])
@pytest.mark.parametrize("n,shape,out_hw,method", [
    (n, shape, out_hw, "lanczos3") for n in (2, 4, 8) for shape, out_hw in _GEOMETRIES
] + [(4, shape, out_hw, "triangle") for shape, out_hw in _GEOMETRIES])
def test_tiled_transform_matches_jax(n, shape, out_hw, method, kernel):
    img, want = _jax_transform(shape, out_hw, n, method, seed=n + shape[0])
    got = tiling.tiled_transform(torch.from_numpy(img), out_hw, _tmesh(n),
                                 method=method, kernel=kernel)
    assert got.dtype == torch.float32 and tuple(got.shape) == out_hw + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=RESAMPLE_TOL)
    if out_hw[0] <= shape[0]:
        # the tiled path against the untiled one (tests/test_parallel.py's
        # bound, which holds downscales; at an upscale rank 0's first rows
        # sample above row 0 unclamped in the reference's tiled program)
        np.testing.assert_allclose(got.numpy(), _untiled_resample(img, out_hw, method),
                                   atol=0.75)
    # the handler's u8 store is the program epilogue of the f32 result
    u8 = tiling.tiled_transform(torch.from_numpy(img), out_hw, _tmesh(n),
                                method=method, kernel=kernel, out_u8=True)
    assert u8.dtype == torch.uint8
    assert int((u8.int() - torch.clamp(torch.round(got), 0, 255).int()).abs().max()) == 0


@pytest.mark.parametrize("n,out_h", [(8, 33), (4, 9)])
def test_tiled_transform_infeasible_halo_raises(n, out_h):
    img = np.zeros((4001, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="infeasible"):
        jt.tiled_transform(jnp.asarray(img), (out_h, 64), _jmesh(n))
    with pytest.raises(tiling.TilingInfeasible, match="infeasible"):
        tiling.tiled_transform(torch.from_numpy(img), (out_h, 64), _tmesh(n))
    assert issubclass(tiling.TilingInfeasible, ValueError)


def test_tiled_transform_banded_takes_u8_only():
    img = torch.zeros((64, 16, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="u8"):
        tiling.tiled_transform(img, (16, 8), _tmesh(2), kernel="banded")


# ---------------------------------------------------------------------------
# halo-exchange filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,kwargs", [
    ("blur", {}),
    ("sharpen", {}),
    ("unsharp", {"gain": 1.5, "threshold": 0.02}),
])
@pytest.mark.parametrize("n,shape", [
    (2, (256, 96, 3)), (4, (256, 96, 3)), (8, (256, 96, 3)),
    (8, (201, 64, 3)),  # indivisible: edge-padded rows
])
def test_tiled_filter_matches_jax(n, shape, op, kwargs):
    x = _image(shape, seed=n + shape[0]).astype(np.float32)
    want = np.asarray(jt.tiled_filter(jnp.asarray(x), _jmesh(n), op, 0.0, 2.0, **kwargs))
    got = tiling.tiled_filter(torch.from_numpy(x), _tmesh(n), op, 0.0, 2.0, **kwargs)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=FILTER_TOL)
    xt = torch.from_numpy(x)[None]
    if op == "blur":
        untiled = tfilters.gaussian_blur(xt, 0.0, 2.0)
    elif op == "sharpen":
        untiled = tfilters.sharpen(xt, 0.0, 2.0)
    else:
        untiled = tfilters.unsharp_mask(xt, 0.0, 2.0, **kwargs)
    np.testing.assert_allclose(got.numpy(), untiled[0].numpy(), atol=1e-3)


def test_tiled_filter_infeasible_kernel_raises():
    img = np.zeros((16, 16, 3), np.float32)  # tile_h = 2, sigma 8 -> half 24
    with pytest.raises(ValueError, match="infeasible"):
        jt.tiled_filter(jnp.asarray(img), _jmesh(8), "blur", 0.0, 8.0)
    with pytest.raises(tiling.TilingInfeasible, match="infeasible"):
        tiling.tiled_filter(torch.from_numpy(img), _tmesh(8), "blur", 0.0, 8.0)
    with pytest.raises(ValueError, match="unknown"):
        tiling.tiled_filter(torch.from_numpy(img), _tmesh(8), "emboss", 0.0, 1.0)


def test_separable_filter_halo_form_reads_the_halo_rows():
    """K5's tiled form (its plain version here) filters the middle rows of
    an extended tile as the whole-image filter filters them, for halos of 0
    to K // 2 (rows beyond the given halo replicate the edge)."""
    x = torch.from_numpy(_image((1, 40, 23, 3), 5).astype(np.float32))
    kern = tfilters.gaussian_kernel(0.0, 1.0)
    half = kern.shape[0] // 2
    whole = tfilters.separable_filter(x, kern, tfilters.MODE_UNSHARP, 1.5, 0.02)
    ext = tfilters.separable_filter(x, kern, tfilters.MODE_UNSHARP, 1.5, 0.02, halo=half)
    assert torch.equal(ext[0], whole[0, half:-half])
    for halo in range(half + 1):
        given = x[:, 10 - halo:30 + halo]
        part = tfilters.separable_filter(given, kern, halo=halo)
        pad = half - halo
        ref = tfilters.separable_filter(
            torch.cat([given[:, :1].expand(1, pad, 23, 3), given,
                       given[:, -1:].expand(1, pad, 23, 3)], dim=1), kern, halo=half)
        assert torch.equal(part, ref)
    with pytest.raises(ValueError, match="halo"):
        tfilters.separable_filter(x, kern, halo=half + 1)


# ---------------------------------------------------------------------------
# ring rotate
# ---------------------------------------------------------------------------


def _position_bound(shape, degrees):
    """2 * 255 * ulp of the largest sample coordinate (one rounding of xs
    or ys moves a bilinear blend of [0, 255] values by at most that)."""
    h, w = shape[:2]
    rw, rh = rotated_bounds(w, h, degrees)
    return 2 * 255 * float(np.spacing(np.float32(max(h, w, rh, rw)))) + ROTATE_TOL


def _inside_knife(shape, degrees, ulps):
    """[rh, rw] mask of output pixels whose sample position lies within
    ``ulps`` ulps of the inside test's edge."""
    h, w = shape[:2]
    rw, rh = rotated_bounds(w, h, degrees)
    g = ring_geometry((h, w), (rh, rw), degrees % 360.0)
    yo = torch.arange(rh, dtype=torch.float32)[:, None]
    xo = torch.arange(rw, dtype=torch.float32)[None, :]
    dx, dy = xo - g.cx_out, yo - g.cy_out
    xs = g.cos_t * dx + g.sin_t * dy + g.cx_in
    ys = -g.sin_t * dx + g.cos_t * dy + g.cy_in
    margin = torch.minimum(torch.minimum(xs + 0.5, g.tw - 0.5 - xs),
                           torch.minimum(ys + 0.5, g.th - 0.5 - ys)).abs()
    return (margin <= ulps * float(np.spacing(np.float32(max(h, w, rh, rw))))).numpy()


def _check_rotate(img, degrees, n, background=None):
    bg = background or (255, 255, 255)
    got = tiling.tiled_rotate(torch.from_numpy(img), degrees, _tmesh(n),
                              background=background).numpy()
    untiled_j = np.asarray(jrotate_image(jnp.asarray(img, jnp.float32), degrees,
                                         background=bg))
    assert got.shape == untiled_j.shape
    np.testing.assert_allclose(got, untiled_j, atol=ROTATE_TOL)
    tiled_j = np.asarray(jt.tiled_rotate(jnp.asarray(img), degrees, _jmesh(n),
                                         background=background))
    knife = _inside_knife(img.shape, degrees, 2)[..., None]
    diff = np.where(knife, 0.0, np.abs(got - tiled_j))
    assert diff.max() <= _position_bound(img.shape, degrees), diff.max()
    # against the port's untiled rotate (tests/test_parallel.py's bound 0.51)
    untiled_t = rotate_image(torch.from_numpy(img)[None].float(), degrees, background)[0]
    np.testing.assert_allclose(got, untiled_t.numpy(), atol=0.51)
    return got


@pytest.mark.parametrize("n,degrees", [
    (4, -45.0), (4, 30.0), (4, 90.0), (4, 180.0), (2, 12.5), (8, -37.0),
])
def test_tiled_rotate_matches_jax(n, degrees):
    _check_rotate(_image((256, 192, 3), 99 + n), degrees, n)


def test_tiled_rotate_indivisible_height_and_background():
    got = _check_rotate(_image((203, 97, 3), 7), -30.0, 8, background=(10, 200, 30))
    assert tuple(np.round(got[0, 0]).astype(int)) == (10, 200, 30)


def test_tiled_rotate_tall_image():
    """The firehose case of tests/test_parallel.py: a tall image rides the
    ring with per-rank tiles."""
    _check_rotate(_image((1024, 64, 3), 3), 45.0, 8)


def test_tiled_rotate_zero_degrees_is_identity():
    img = torch.from_numpy(_image((64, 48, 3), 1))
    assert tiling.tiled_rotate(img, 0.0, _tmesh(8)) is img
    assert tiling.tiled_rotate(img, 360.0, _tmesh(8)) is img


def test_tiled_rotate_u8_store_rounds_the_f32_result():
    img = torch.from_numpy(_image((120, 50, 3), 2))
    f32 = tiling.tiled_rotate(img, -37.0, _tmesh(4), background=(1, 2, 3))
    u8 = tiling.tiled_rotate(img, -37.0, _tmesh(4), background=(1, 2, 3), out_u8=True)
    assert u8.dtype == torch.uint8
    assert torch.equal(u8, torch.clamp(torch.round(f32), 0, 255).to(torch.uint8))


@pytest.mark.parametrize("src_k,last", [(0, False), (1, False), (2, True)])
def test_ring_rotate_step_plain_matches_jax_tap_rows(src_k, last):
    """One ring step: the port's plain version against JAX's tap_rows
    (flyimg_tpu/parallel/tiling.py:423-441) and inside test (:461-465)
    evaluated eagerly on the same visiting tile, rank and geometry."""
    n, in_h, in_w, degrees = 3, 90, 70, -37.0
    img = _image((in_h, in_w, 3), 11).astype(np.float32)
    rw, rh = rotated_bounds(in_w, in_h, degrees)
    out_h = rh + (-rh) % n
    tile_h, out_tile_h, idx = in_h // n, out_h // n, 1
    visit = img[src_k * tile_h:(src_k + 1) * tile_h]
    acc0 = np.random.default_rng(4).random((out_tile_h, rw, 3)).astype(np.float32) * 50
    # JAX, eagerly, as written in the reference's kernel body
    th, tw = float(in_h), float(in_w)
    theta = np.radians(degrees % 360.0)
    cos_t, sin_t = float(np.cos(theta)), float(np.sin(theta))
    yo, xo = jnp.meshgrid(jnp.arange(out_tile_h, dtype=jnp.float32)
                          + jnp.float32(idx) * out_tile_h,
                          jnp.arange(rw, dtype=jnp.float32), indexing="ij")
    dx, dy = xo - (rw - 1.0) / 2.0, yo - (rh - 1.0) / 2.0
    xs = cos_t * dx + sin_t * dy + (tw - 1.0) / 2.0
    ys = -sin_t * dx + cos_t * dy + (th - 1.0) / 2.0
    x0, y0 = jnp.floor(xs), jnp.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    xc0 = jnp.clip(x0, 0.0, tw - 1.0).astype(jnp.int32)
    xc1 = jnp.clip(x0 + 1.0, 0.0, tw - 1.0).astype(jnp.int32)
    jvisit, src0 = jnp.asarray(visit), src_k * tile_h

    def tap_rows(yc, wrow):
        local = yc - src0
        owned = ((local >= 0) & (local < tile_h))[..., None]
        lc = jnp.clip(local, 0, tile_h - 1)
        val = jvisit[lc, xc0] * (1.0 - fx) + jvisit[lc, xc1] * fx
        return jnp.where(owned, val * wrow, 0.0)

    want = jnp.asarray(acc0)
    want = want + tap_rows(jnp.clip(y0, 0.0, th - 1.0).astype(jnp.int32), 1.0 - fy)
    want = want + tap_rows(jnp.clip(y0 + 1.0, 0.0, th - 1.0).astype(jnp.int32), fy)
    if last:
        inside = ((xs >= -0.5) & (xs <= tw - 0.5) & (ys >= -0.5) & (ys <= th - 0.5))[..., None]
        want = jnp.where(inside, want, jnp.array([9.0, 8.0, 7.0], jnp.float32))
    geom = ring_geometry((in_h, in_w), (rh, rw), degrees)
    acc = torch.from_numpy(acc0.copy())
    got = ring_rotate_step_plain(torch.from_numpy(visit), src0, idx * out_tile_h, acc,
                                 geom, last, (9, 8, 7))
    assert got is acc  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    # the wrapper takes the plain version on a CPU tensor and counts nothing
    before = ring_rotate_step.launches
    acc2 = torch.from_numpy(acc0.copy())
    ring_rotate_step(torch.from_numpy(visit), src0, idx * out_tile_h, acc2, geom, last,
                     (9, 8, 7))
    assert torch.equal(acc2, got) and ring_rotate_step.launches == before


def test_ring_rotate_step_refuses_bad_arguments():
    geom = ring_geometry((8, 8), (8, 8), 30.0)
    acc = torch.zeros((4, 8, 3))
    with pytest.raises(ValueError, match="f32"):
        ring_rotate_step(torch.zeros((4, 8, 3), dtype=torch.uint8), 0, 0, acc, geom)
    with pytest.raises(ValueError, match="last step"):
        ring_rotate_step(torch.zeros((4, 8, 3)), 0, 0, acc, geom, out_u8=True)


# ---------------------------------------------------------------------------
# halo exchange and halo size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fill", ["zero", "edge"])
@pytest.mark.parametrize("n,halo", [(2, 3), (4, 5), (8, 1)])
def test_halo_exchange_matches_jax(n, halo, fill):
    tile_h = 6
    x = np.random.default_rng(n).random((n * tile_h, 5, 3)).astype(np.float32)
    prog = jax.jit(jt._shard_map(
        lambda t: jt._halo_exchange(t, halo, "sp", fill), mesh=_jmesh(n),
        in_specs=P("sp", None, None), out_specs=P("sp", None, None)))
    want = np.asarray(prog(jnp.asarray(x)))
    tiles = tiling._split(torch.from_numpy(x), _tmesh(n).axis_devices("sp"))
    got = torch.cat(tiling._halo_exchange(tiles, halo, fill)).numpy()
    np.testing.assert_array_equal(got, want)


def test_required_halo_matches_jax_over_a_grid():
    for n in (1, 2, 3, 4, 8):
        for src_h in (515, 2048, 2161, 3840, 4001):
            for dst_h in (33, 123, 256, 455, 1000, 3000, 5000):
                in_pad, out_pad = src_h + (-src_h) % n, dst_h + (-dst_h) % n
                assert tiling.required_halo(in_pad, out_pad, src_h, dst_h, n) == \
                    jt.required_halo(in_pad, out_pad, src_h, dst_h, n)


# ---------------------------------------------------------------------------
# meshes, the dry run, process groups
# ---------------------------------------------------------------------------


def test_make_mesh_virtual_and_too_many_devices():
    mesh = make_mesh((4, 2), ("data", "sp"), ["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 4, "sp": 2}
    assert mesh.axis_devices("sp") == (torch.device("cpu"),) * 2
    assert len(mesh.axis_devices("data")) == 4
    assert hash(mesh) == hash(make_mesh((4, 2), ("data", "sp"), ["cpu"] * 8))
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3}
    with pytest.raises(ValueError, match="wants 16 devices"):
        make_mesh((16,), ("sp",), ["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            default_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            virtual_mesh(2)


def test_dryrun_multichip_four_ranks(capsys):
    dryrun_multichip(4)
    assert "dryrun_multichip ok: sp=4" in capsys.readouterr().out


def test_initialize_multihost_without_configuration_is_a_no_op(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert dist.initialize_multihost() is False
    assert dist.local_batch_slice(8) == slice(0, 8)
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize_multihost(device="cpu")


def _gloo_rank(rank, port, results):
    import torch.distributed as tdist

    try:
        ok = dist.initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu",
                                       timeout_s=20)
        t = torch.tensor([rank + 1.0])
        tdist.all_reduce(t)
        results.put((rank, ok, dist.local_batch_slice(8), float(t)))
        tdist.destroy_process_group()
    except Exception as exc:  # reported to the parent
        results.put((rank, repr(exc)))


def test_initialize_multihost_two_gloo_ranks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, results)) for r in range(2)]
    for p in procs:
        p.start()
    got = sorted(results.get(timeout=60) for _ in procs)
    for p in procs:
        p.join(timeout=30)
        assert p.exitcode == 0
    assert got == [(0, True, slice(0, 4), 3.0), (1, True, slice(4, 8), 3.0)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_k15_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py on the H100)")
    dev = torch.device("cuda")
    img = torch.from_numpy(_image((401, 203, 3), 8)).to(dev)
    mesh = virtual_mesh(4, dev)
    for degrees in (-37.0, 90.0, 12.5):
        got = tiling.tiled_rotate(img, degrees, mesh, background=(5, 6, 7))
        ref = tiling.tiled_rotate(img, degrees, mesh, background=(5, 6, 7), plain=True)
        assert float((got - ref).abs().max()) <= ROTATE_TOL
