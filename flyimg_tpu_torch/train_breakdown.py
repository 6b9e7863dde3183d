"""Where K11's, K12's and K13's time goes on the card, layer by layer.

    python3 -m flyimg_tpu_torch.train_breakdown [--iters 50] [--batches 16,64]

The training counterpart of ``face_breakdown``. For each batch, a fresh
model (``init_params(0)``) and a seeded synthetic batch give the train
step's backward calls on the plain path: K11 (``conv5x5_backward``) at the
stem and each block's depthwise 5x5 (17 calls), K12
(``pointwise_backward``) at each block's 1x1 and the four heads (20 calls),
each with an output gradient drawn from a seeded generator. One JSON line a
call, with the card's name and power limit:

- the single call by CUDA events (ms), on the host clock with no sync
  (the wrapper's host microseconds), and its device time and kernel
  launches from a ``torch.profiler`` window (ms and launches a call);
- the layer's byte bound (each input read once, each output written once,
  at 3.35 TB/s; K12's residual read only at stride 2);
- the library yardstick for the same layer, by events and device time:
  cuDNN's ``conv2d_weight`` + ``conv2d_input`` (K11; the input gradient of
  depthwise layers only) or the ``torch.matmul`` pair g . W^T, y^T . g
  (K12);
- the launch plan (``k11_plan`` / ``k12_plan``).

Then one line a batch with the sums, and one for K13 (``head_loss``, the
heads, the loss and its gradient) at that batch: events, host, device time
and launches a call, the byte bound (as ``chip_smoke.py`` counts it), the
train step's device time and launches from a profiler window, K13's share
of that device time, and ``k13_plan``. ``chip_smoke.py`` phase 3 prints
the K11 and K12 readings at batch 16.

First, one line for K14 (``adam_update`` over the model's flat parameters,
which no batch changes): events, the wrapper's host microseconds, device
time and launches a call, the byte bound, and ``torch.optim.Adam(fused=True)``
on the same buffer (events, device time). ``k14_row`` calls public
functions only, so it can time an older tree's K14 too.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from flyimg_tpu_torch.face_breakdown import (
    H100_BYTES_PER_S,
    _event_ms as event_ms,
    _host_us as host_us,
    card_line,
)


def device_window(fn, iters: int):
    """(device ms, kernel launches) a call of ``fn`` from a
    ``torch.profiler`` window of ``iters`` calls (a window that caught no
    kernel, which happens, is taken again, up to three times)."""
    from flyimg_tpu_torch.profile_entry import profiler_window

    for _ in range(3):
        window = profiler_window(fn, (), iters)
        if window["launches_per_batch"] > 0:
            break
    return window["device_ms_per_batch"], window["launches_per_batch"]


def backward_calls(model, images, gen):
    """The train step's K11 and K12 calls on the plain path: [(kind, layer,
    kwargs)], each with an output gradient drawn from ``gen``."""
    from flyimg_tpu_torch.models import blazeface as bf

    def grad_like(t, shape=None):
        return torch.randn(t.shape if shape is None else shape, generator=gen,
                           device=t.device)

    calls = []
    x = bf.conv5x5_plain(images, model.stem.kernel, model.stem.bias, 2, True)
    calls.append(("K11", "stem", dict(g=grad_like(x), x=images, kernel=model.stem.kernel,
                                      out=x, stride=2, has_bias=True, need_dx=False)))
    maps = []
    for i, block in enumerate(model.blocks):
        y = bf.conv5x5_plain(x, block.dw_kernel, None, block.stride, False)
        calls.append(("K11", f"block {i}", dict(g=grad_like(y), x=x, kernel=block.dw_kernel,
                                                 out=None, stride=block.stride, has_bias=False,
                                                 need_dx=True)))
        out = bf.pointwise_plain(y, block.pw.kernel, block.pw.bias, x, block.stride)
        calls.append(("K12", f"block {i}", dict(g=grad_like(out), y=y, kernel=block.pw.kernel,
                                                 out=out, res=x, stride=block.stride)))
        x = out
        if i == bf.X16_BLOCK:
            maps.append(x)
    maps.append(x)
    for fmap, (cls, reg, _off), label in zip(maps, model._heads(), ("16x16", "8x8")):
        for conv, part in ((cls, "class"), (reg, "offsets")):
            shape = fmap.shape[:3] + (conv.kernel.shape[3],)
            calls.append(("K12", f"head {label} {part}",
                          dict(g=grad_like(fmap, shape), y=fmap, kernel=conv.kernel)))
    return calls


def k11_bytes(a) -> float:
    """K11's least bytes: x, g, the saved output and the kernel read, dx
    (depthwise) and the kernel's and bias's gradients written."""
    x, g, kernel = a["x"], a["g"], a["kernel"]
    return 4.0 * (x.numel() + g.numel() + 2 * kernel.numel()
                  + (g.numel() if a["out"] is not None else 0)
                  + (x.numel() if a["need_dx"] else 0)
                  + (kernel.shape[3] if a["has_bias"] else 0))


def k11_flops(a) -> float:
    g, kernel = a["g"], a["kernel"]
    taps = 25 * (1 if kernel.shape[2] == 1 else a["x"].shape[3])
    return 2.0 * g.numel() * taps * (2 if a["need_dx"] else 1)


def k12_bytes(a) -> float:
    """K12's least bytes: y, g, out and the kernel read, dy, dW and db
    written; dres written, res read only at stride 2 (the 2x2 argmax; at
    stride 1 dres is a slice of g)."""
    y, g, kernel = a["y"], a["g"], a["kernel"]
    res, out = a.get("res"), a.get("out")
    pooled = a.get("stride", 1) == 2
    return 4.0 * (2 * y.numel() + g.numel() + 2 * kernel.numel() + kernel.shape[3]
                  + (out.numel() if out is not None else 0)
                  + ((2 if pooled else 1) * res.numel() if res is not None else 0))


def k12_flops(a) -> float:
    y, kernel = a["y"], a["kernel"]
    pixels = y.numel() // y.shape[3]
    return 4.0 * pixels * kernel.shape[2] * kernel.shape[3] + pixels * kernel.shape[3]


def library_call(kind, a):
    """The PyTorch yardstick for one call: cuDNN's conv2d_weight (+
    conv2d_input of depthwise layers) for K11, the torch.matmul pair for
    K12; its operands laid out beforehand."""
    from flyimg_tpu_torch.models import blazeface as bf

    if kind == "K12":
        cin, cout = a["kernel"].shape[2], a["kernel"].shape[3]
        g2 = a["g"].reshape(-1, cout)
        y2 = a["y"].reshape(-1, cin)
        w2 = a["kernel"].reshape(cin, cout)

        def matmuls():
            torch.matmul(g2, w2.t())
            torch.matmul(y2.t(), g2)

        return matmuls
    x, g, kern = a["x"], a["g"], a["kernel"]
    n, h, w, cin = x.shape
    depthwise = kern.shape[2] == 1
    pt, pb, _ = bf.same_pads(h, a["stride"])
    pl, pr, _ = bf.same_pads(w, a["stride"])
    gn = g.permute(0, 3, 1, 2).contiguous()
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous()
    wn = kern.permute(3, 2, 0, 1).contiguous()
    groups, stride, need_dx = (cin if depthwise else 1), a["stride"], a["need_dx"]

    def cudnn():
        torch.nn.grad.conv2d_weight(xp, wn.shape, gn, stride=stride, groups=groups)
        if need_dx:
            torch.nn.grad.conv2d_input(xp.shape, wn, gn, stride=stride, groups=groups)

    return cudnn


def layer_rows(batch: int, iters: int, dev, card: str):
    """One dict a K11 or K12 call of the train step at ``batch``."""
    import numpy as np

    from flyimg_tpu_torch.models import blazeface as bf
    from flyimg_tpu_torch.models import blazeface_train as bt

    model = bt.init_params(0, dev)
    images = bt.batch_to(bt.synthetic_batch(np.random.default_rng(0), batch), dev)[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = bf._sm_count(dev.index)
    with torch.no_grad():
        calls = backward_calls(model, images, gen)
        for kind, layer, a in calls:
            if kind == "K11":
                call = lambda a=a: bt.conv5x5_backward(**a)  # noqa: E731
                x, kern = a["x"], a["kernel"]
                n, h, w, cin = x.shape
                depthwise = kern.shape[2] == 1
                plan = bt.k11_plan(n, h, w, cin, kern.shape[3], a["stride"], depthwise,
                                   a["out"] is not None, sms)
                nbytes, flops = k11_bytes(a), k11_flops(a)
                shape = dict(n=n, h=h, w=w, cin=cin, cout=kern.shape[3], stride=a["stride"])
                lib_name = "cuDNN conv2d_weight + conv2d_input" if a["need_dx"] \
                    else "cuDNN conv2d_weight"
            else:
                call = lambda a=a: bt.pointwise_backward(**a)  # noqa: E731
                y, kern = a["y"], a["kernel"]
                n, h, w, cin = y.shape
                plan = bt.k12_plan(n, h, w, cin, kern.shape[3], a.get("out") is not None, sms)
                nbytes, flops = k12_bytes(a), k12_flops(a)
                shape = dict(n=n, h=h, w=w, cin=cin, cout=kern.shape[3],
                             stride=a.get("stride", 1))
                lib_name = "torch.matmul pair"
            lib = library_call(kind, a)
            device_ms, launches = device_window(call, iters)
            lib_device_ms, lib_launches = device_window(lib, iters)
            yield {
                "kernel": kind, "layer": layer, "batch": batch, **shape,
                "ms": event_ms(call, iters), "host_us": host_us(call, iters),
                "device_ms": device_ms, "launches": launches,
                "bound_ms": max(nbytes / H100_BYTES_PER_S, flops / 67e12) * 1e3,
                "library": lib_name, "library_ms": event_ms(lib, iters),
                "library_device_ms": lib_device_ms, "library_launches": lib_launches,
                "plan": plan._asdict(), "card": card,
            }


def k13_row(batch: int, iters: int, dev, card: str) -> dict:
    """K13 at ``batch`` (a fresh model, the seeded synthetic batch) and its
    share of the train step's device time."""
    import numpy as np

    from flyimg_tpu_torch.models import blazeface as bf
    from flyimg_tpu_torch.models import blazeface_train as bt
    from flyimg_tpu_torch.profile_entry import profiler_window

    model = bt.init_params(0, dev)
    arrays = bt.batch_to(bt.synthetic_batch(np.random.default_rng(0), batch), dev)
    images, tp, tboxes, mask = arrays
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        maps = [a["y"] for _kind, layer, a in backward_calls(model, images, gen)
                if layer.endswith("class")]
    heads = tuple((c.kernel, c.bias, r.kernel, r.bias) for c, r, _ in model._heads())
    args = (maps[0], maps[1], heads, tp, tboxes, mask)
    call = lambda: bt.head_loss(*args)  # noqa: E731
    device_ms, launches = device_window(call, iters)
    params = sum(t.numel() for h in heads for t in h)
    nbytes = 4.0 * (maps[0].numel() + maps[1].numel() + params + 3 * tp.numel()
                    + 2 * tboxes.numel() + 1)
    flops = 2.0 * sum(m.numel() * 5 * h[0].shape[3] for m, h in zip(maps, heads)) \
        + 40.0 * batch * bf.NUM_ANCHORS
    step = bt.make_train_step(model)[1]
    window = {"launches_per_batch": 0}
    for _ in range(3):
        window = profiler_window(step, arrays, iters)
        if window["launches_per_batch"] > 0:
            break
    plan = bt.k13_plan(batch, maps[0].shape[1] * maps[0].shape[2], heads[0][0].shape[3],
                       maps[1].shape[1] * maps[1].shape[2], heads[1][0].shape[3],
                       bf._sm_count(dev.index))
    return {
        "kernel": "K13", "batch": batch, "ms": event_ms(call, iters),
        "host_us": host_us(call, iters), "device_ms": device_ms, "launches": launches,
        "bound_ms": max(nbytes / H100_BYTES_PER_S, flops / 67e12) * 1e3,
        "step_device_ms": window["device_ms_per_batch"],
        "step_launches": window["launches_per_batch"],
        "share_of_step": (device_ms / window["device_ms_per_batch"]
                          if window["device_ms_per_batch"] else None),
        "plan": plan._asdict(), "card": card,
    }


def k14_tensors(dev):
    """(params, grads, mu, nu): a fresh model's flat parameters with seeded
    gradients and moments of a training step's scale."""
    from flyimg_tpu_torch.models import blazeface_train as bt

    params = bt.init_params(0, dev).flat_params
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = torch.randn(params.shape, generator=gen, device=dev) * 1e-3
    mu = grads * 0.1
    nu = grads * grads * 1e-3
    return params, grads, mu, nu


def k14_row(iters: int, dev, card: str) -> dict:
    """K14 on the model's flat parameters, against the fused Adam call."""
    from flyimg_tpu_torch.models import blazeface_train as bt

    params, grads, mu, nu = k14_tensors(dev)
    call = lambda: bt.adam_update(params, grads, mu, nu, 4)  # noqa: E731
    device_ms, launches = device_window(call, iters)
    lib_p = torch.nn.Parameter(params.detach().clone())
    lib_p.grad = grads.clone()
    fused = torch.optim.Adam([lib_p], lr=1e-3, eps=1e-8, fused=True)
    lib_device_ms, lib_launches = device_window(fused.step, iters)
    return {
        "kernel": "K14", "values": params.numel(), "ms": event_ms(call, iters),
        "host_us": host_us(call, iters), "device_ms": device_ms, "launches": launches,
        "bound_ms": 4.0 * 7 * params.numel() / H100_BYTES_PER_S * 1e3,
        "library": "torch.optim.Adam(fused=True)", "library_ms": event_ms(fused.step, iters),
        "library_device_ms": lib_device_ms, "library_launches": lib_launches, "card": card,
    }


def summary(rows) -> dict:
    """Sums by kernel of a batch's rows."""
    out = {}
    for kind in ("K11", "K12"):
        mine = [r for r in rows if r["kernel"] == kind]
        out[kind] = {key: sum(r[key] for r in mine)
                     for key in ("ms", "host_us", "device_ms", "launches", "bound_ms",
                                 "library_ms", "library_device_ms")}
        out[kind]["calls"] = len(mine)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--batches", default="16,64")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_breakdown needs a CUDA card")
    from flyimg_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    print(json.dumps(k14_row(args.iters, dev, card)), flush=True)
    for batch in (int(b) for b in args.batches.split(",")):
        rows = []
        for row in layer_rows(batch, args.iters, dev, card):
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(json.dumps({"batch": batch, "sums": summary(rows), "card": card}), flush=True)
        print(json.dumps(k13_row(batch, args.iters, dev, card)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
