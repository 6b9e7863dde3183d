"""The PyTorch package's BlazeFace training against the JAX package's, on
the CPU at full width and batch 2-4.

On a CPU tensor K11 (``conv5x5_backward``), K12 (``pointwise_backward``),
K13 (``head_loss``) and K14 (``adam_update``) run their plain versions, so
the autograd path here is the kernels' path with the plain twins in their
place; chip_smoke.py and the ``cuda``-marked test hold the kernels to the
twins on the card.

Bounds, each stated where it is checked:
- ``synthetic_batch``: equal arrays;
- the loss: within 1e-5 relative of ``jax`` (sums in another order);
- each gradient leaf: within 1e-4 of that leaf's max |value| (a
  pre-activation within float noise of 0 can flip a ReLU between the two
  packages, so not elementwise);
- the twins against torch autograd of the plain forward: within 1e-5 of
  each output's max |value| (the same sums, in other orders); the pooled
  residual's gradient equal to JAX's on tied windows;
- Adam fed JAX's gradients: parameters within 1e-6 absolute, moments
  within 1e-6 relative of ``optax.adam(1e-3)`` over three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flyimg_tpu.models import blazeface as jbf
from flyimg_tpu_torch.entry import train_entry
from flyimg_tpu_torch.models import blazeface as tbf
from flyimg_tpu_torch.models import blazeface_train as bt

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TWIN_RTOL = 1e-5
CPU = torch.device("cpu")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def trainable(jparams):
    """A trainable port model holding JAX's parameters."""
    model = tbf.BlazeFace()
    model.load_state_dict(tbf.params_from_flax(jax.tree.map(np.asarray, jparams)))
    return bt.flatten_parameters(model)


@pytest.fixture(scope="module")
def jparams():
    """JAX's init_params(PRNGKey(5)) (jitted: the same values, in a third
    of the time)."""
    return jax.jit(jbf.init_params)(jax.random.PRNGKey(5))


@pytest.fixture(scope="module")
def case(jparams):
    """JAX's init_params(PRNGKey(5)) and a seed-5 batch of 3, with the
    loss and gradients of ``jax.value_and_grad(loss_fn)`` as written
    (eager): under ``jit`` XLA's fusion moves the last bits of
    ``sigmoid`` near 1, and at this initialisation (logits up to ~60) the
    saturated ``log(1 - p + 1e-7)`` terms turn that into a 3e-4 relative
    change of the loss and up to 1.2e-2 of a gradient leaf."""
    arrays = bt.synthetic_batch(np.random.default_rng(5), 3)
    loss, grads = jax.value_and_grad(jbf.loss_fn)(
        jparams, *(jnp.asarray(a) for a in arrays))
    return jparams, arrays, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("seed,batch", [(0, 1), (5, 4), (77, 2)])
def test_synthetic_batch_equals_jax(seed, batch):
    got = bt.synthetic_batch(np.random.default_rng(seed), batch)
    ref = jbf.synthetic_batch(np.random.default_rng(seed), batch)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("path", ["kernels", "plain"])
def test_loss_and_gradients_match_jax(case, path):
    """The loss through the kernels' autograd Functions (their twins here)
    and through torch autograd of the plain forward, from JAX's own
    initial parameters, against ``jax.value_and_grad(loss_fn)``."""
    jparams, arrays, jloss, jgrads = case
    model = trainable(jparams)
    loss_of = bt.loss_fn if path == "kernels" else bt.loss_fn_plain
    loss = loss_of(model, *bt.batch_to(arrays, CPU))
    assert loss.shape == ()
    assert abs(loss.item() - jloss) <= LOSS_RTOL * abs(jloss)
    loss.backward()
    ref = tbf.params_from_flax(jgrads)
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.shape == ref[name].shape, name
        assert rel(p.grad.numpy(), ref[name].numpy()) <= GRAD_RTOL, name


def test_one_step_reduces_loss(jparams):
    """One optimisation step on one batch lowers the loss (the JAX
    package's own check, tests/test_blazeface.py), from JAX's initial
    parameters; the step's loss is the loss before the update."""
    arrays = bt.batch_to(bt.synthetic_batch(np.random.default_rng(5), 4), CPU)
    model = trainable(jparams)
    optimizer, train_step = bt.make_train_step(model)
    with torch.no_grad():
        before = float(bt.loss_fn_plain(model, *arrays))
    loss = train_step(*arrays)
    assert float(loss) == pytest.approx(before, rel=LOSS_RTOL)
    assert optimizer.count == 1
    with torch.no_grad():
        after = float(bt.loss_fn_plain(model, *arrays))
    assert after < before


def test_train_step_writes_gradients_into_the_flat_buffer(jparams):
    """The step's backward writes every gradient into ``flat_grads``, which
    K14 reads (each ``.grad`` a view of it, not a copy), and two steps
    equal ``loss_fn`` + ``backward`` + the concatenated gradients through
    ``adam_update``: no gradient is added to the last step's."""
    arrays = bt.batch_to(bt.synthetic_batch(np.random.default_rng(6), 2), CPU)
    model, ref = trainable(jparams), trainable(jparams)
    _optimizer, train_step = bt.make_train_step(model)
    mu, nu = torch.zeros_like(ref.flat_params), torch.zeros_like(ref.flat_params)
    for step in (1, 2):
        loss = train_step(*arrays)
        for p in ref.parameters():
            p.grad = None
        ref_loss = bt.loss_fn(ref, *arrays)
        ref_loss.backward()
        grads = torch.cat([p.grad.reshape(-1) for p in ref.parameters()])
        bt.adam_update(ref.flat_params, grads, mu, nu, step)
        assert float(loss) == float(ref_loss.detach())
        assert torch.equal(model.flat_grads, grads)
        assert torch.equal(model.flat_params, ref.flat_params)
        for p in model.parameters():
            assert p.grad is model.grad_views[p]


def test_plain_train_step_is_the_kernel_step_in_torch_autograd(jparams):
    """``profile_entry.plain_train_step``, the yardstick of the train step,
    takes the same steps: the losses of two steps within 1e-5 relative
    (Adam's first step is a sign function, so parameters are not held)."""
    from flyimg_tpu_torch.profile_entry import plain_train_step

    arrays = bt.batch_to(bt.synthetic_batch(np.random.default_rng(7), 2), CPU)
    kernel_step = bt.make_train_step(trainable(jparams))[1]
    plain_step = plain_train_step(trainable(jparams))
    for _ in range(2):
        a, b = float(kernel_step(*arrays)), float(plain_step(*arrays))
        assert abs(a - b) <= LOSS_RTOL * abs(b)


@pytest.mark.parametrize("wrapper", ["K11", "K12", "K13", "K14"])
def test_wrappers_refuse_tensors_on_another_device(wrapper):
    """Every tensor a wrapper takes must lie on its first tensor's device
    (no host pointer reaches a kernel); the error names the tensor."""
    rng = np.random.default_rng(3)
    meta = torch.device("meta")
    if wrapper == "K11":
        x, kernel = _rand(rng, 1, 8, 8, 4), _rand(rng, 5, 5, 1, 4)
        call = lambda: bt.conv5x5_backward(torch.zeros(1, 8, 8, 4, device=meta), x, kernel)
        name = "g"
    elif wrapper == "K12":
        y, kernel = _rand(rng, 1, 4, 4, 6), _rand(rng, 1, 1, 6, 8)
        call = lambda: bt.pointwise_backward(_rand(rng, 1, 4, 4, 8), y, kernel,
                                             res=torch.zeros(1, 8, 8, 6, device=meta),
                                             stride=2)
        name = "res"
    elif wrapper == "K13":
        model = bt.init_params(0, CPU)
        heads = (bt._head_params(model)[:4], bt._head_params(model)[4:])
        tp, tb, mask = bt.batch_to(bt.synthetic_batch(np.random.default_rng(0), 1), CPU)[1:]
        call = lambda: bt.head_loss(_rand(rng, 1, 16, 16, 88), _rand(rng, 1, 8, 8, 96), heads,
                                    tp, tb.to(meta), mask)
        name = "target_boxes"
    else:
        p = torch.zeros(5)
        call = lambda: bt.adam_update(p, torch.zeros(5, device=meta), torch.zeros(5),
                                      torch.zeros(5), 1)
        name = "grads"
    with pytest.raises(ValueError, match=f"{name} is on meta"):
        call()


def test_adam_matches_optax_on_jax_gradients(case):
    """Three optax.adam(1e-3) steps fed JAX's gradients (scaled per step),
    against the port's Adam on the flat buffer fed the same gradients."""
    jparams, _arrays, _loss, jgrads = case
    opt = optax.adam(1e-3)
    update = jax.jit(opt.update)
    state = opt.init(jparams)
    params = jparams
    model = trainable(jparams)
    port = bt.Adam(model.flat_params)
    names = [n for n, _p in model.named_parameters()]
    for step, scale in enumerate((1.0, -0.5, 3.0), start=1):
        g = jax.tree.map(lambda a: jnp.asarray(a * np.float32(scale)), jgrads)
        updates, state = update(g, state, params)
        params = jax.jit(optax.apply_updates)(params, updates)
        flat_g = tbf.params_from_flax(jax.tree.map(np.asarray, g))
        port.step(torch.cat([flat_g[n].reshape(-1) for n in names]))
        assert port.count == step
    ref_p = tbf.params_from_flax(jax.tree.map(np.asarray, params))
    adam_state = state[0]
    ref_mu = tbf.params_from_flax(jax.tree.map(np.asarray, adam_state.mu))
    ref_nu = tbf.params_from_flax(jax.tree.map(np.asarray, adam_state.nu))
    state_dict = model.state_dict()
    off = 0
    for n in names:
        k = ref_p[n].numel()
        assert float((state_dict[n] - ref_p[n]).abs().max()) <= 1e-6, n
        for got, ref in ((port.mu, ref_mu[n]), (port.nu, ref_nu[n])):
            got = got[off:off + k].reshape(ref.shape)
            assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max()), n
        off += k


def test_adam_places_eps_outside_the_square_root():
    """At t = 1 the update is lr g / (|g| + eps) (up to the f32 bias
    corrections, 7e-6 relative): with g = 1e-8 that is half of lr, where
    eps inside the root would give ~1e-4 of it."""
    p = torch.zeros(3)
    g = torch.tensor([1e-8, -1.0, 0.0])
    mu, nu = torch.zeros(3), torch.zeros(3)
    bt.adam_update(p, g, mu, nu, 1)
    assert float(p[0]) == pytest.approx(-0.5e-3, rel=1e-4)
    assert float(p[1]) == pytest.approx(1e-3, rel=1e-5)
    assert float(p[2]) == 0.0


def test_init_is_lecun_normal_with_zero_biases():
    model = bt.init_params(3, CPU)
    again = bt.init_params(3, CPU)
    assert torch.equal(model.flat_params, again.flat_params)
    assert not torch.equal(model.flat_params, bt.init_params(4, CPU).flat_params)
    assert model.flat_params.numel() == 106940
    for name, p in model.named_parameters():
        assert p.requires_grad
        assert p.data_ptr() >= model.flat_params.data_ptr()
        if name.endswith("bias"):
            assert not p.detach().any(), name
            continue
        fan_in = p.shape[0] * p.shape[1] * p.shape[2]
        std = fan_in ** -0.5
        v = p.detach().double()
        # the truncated normal's bound and, for enough samples, its moments
        assert float(v.abs().max()) <= 2 * std / bt._TRUNC_STD * (1 + 1e-6), name
        if v.numel() >= 1000:
            assert abs(float(v.std()) / std - 1) < 0.08, name
            assert abs(float(v.mean())) < 0.1 * std, name


def test_npz_round_trip_through_load_weights(tmp_path):
    model = bt.init_params(1, CPU)
    path = tmp_path / "bf.npz"
    bt.save_weights(model, str(path))
    with np.load(path) as z, np.load(tbf.PACKAGED_WEIGHTS) as packaged:
        assert sorted(z.files) == sorted(packaged.files)
        for key in z.files:
            assert z[key].dtype == np.float32
            assert z[key].shape == packaged[key].shape
    loaded = tbf.load_weights(str(path), device="cpu")
    for name, value in loaded.state_dict().items():
        assert torch.equal(value, model.state_dict()[name]), name
    views = np.random.default_rng(2).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        a = model.forward_plain(torch.from_numpy(views))
    b = loaded.forward_plain(torch.from_numpy(views))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.train_synthetic(steps=1, batch=1)
    fn, args = train_entry(device="cpu", batch=2)
    first = float(fn(*args))
    assert np.isfinite(first) and float(fn(*args)) < first
    model, loss = bt.train_synthetic(steps=2, batch=2, seed=1, device="cpu")
    assert np.isfinite(loss) and model.flat_params.device.type == "cpu"
    assert tbf.train_synthetic is bt.train_synthetic
    assert tbf.init_params is bt.init_params and tbf.loss_fn is bt.loss_fn
    assert tbf.make_train_step is bt.make_train_step
    assert tbf.synthetic_batch is bt.synthetic_batch

    from flyimg_tpu_torch import train_blazeface

    out = tmp_path / "cli.npz"
    assert train_blazeface.main(["--steps", "1", "--batch", "1", "--device", "cpu",
                                 "--out", str(out), "--log-every", "0"]) == 0
    assert tbf.load_weights(str(out), device="cpu").anchors.shape == (896, 4)


# ---------------------------------------------------------------------------
# the twins against torch autograd of the plain forward
# ---------------------------------------------------------------------------


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


@pytest.mark.parametrize("size,c,stride,stem", [
    (16, 24, 1, False), (16, 28, 2, False), (9, 8, 2, False), (7, 5, 1, False),
    (32, 3, 2, True), (13, 3, 2, True),
])
def test_k11_twin_matches_autograd(size, c, stride, stem):
    rng = np.random.default_rng(size * 10 + c)
    x = _rand(rng, 2, size, size, c).requires_grad_(True)
    cout = 24 if stem else c
    kernel = _rand(rng, 5, 5, c if stem else 1, cout, scale=0.2).requires_grad_(True)
    bias = _rand(rng, cout, scale=0.1).requires_grad_(True) if stem else None
    out = tbf.conv5x5_plain(x, kernel, bias, stride, relu=stem)
    g = _rand(rng, *out.shape)
    wants = [x, kernel] + ([bias] if stem else [])
    ref = torch.autograd.grad(out, wants, g)
    dx, dk, db = bt.conv5x5_backward(g, x.detach(), kernel.detach(),
                                     out.detach() if stem else None, stride,
                                     has_bias=stem, need_dx=not stem)
    got = [dx, dk] + ([db] if stem else [])
    for a, r in zip(got, ref):
        if a is None:  # the stem's input gradient is not taken
            continue
        assert a.shape == r.shape
        assert rel(a.numpy(), r.numpy()) <= TWIN_RTOL
    if stem:
        assert dx is None
        with pytest.raises(ValueError, match="depthwise"):
            bt.conv5x5_backward(g, x.detach(), kernel.detach(), None, stride, True, True)


def _relu_input(rng, n, h, w, c, ties):
    """ReLU outputs (many exact zeros); with ``ties`` also repeated positive
    values within 2x2 windows."""
    x = torch.relu(_rand(rng, n, h, w, c))
    if ties:
        x[:, ::2, 1::2] = x[:, ::2, ::2]          # a tie in the top row
        x[:, 1::2, ::2] = torch.where(x[:, 1::2, ::2] > 0.5, x[:, ::2, ::2],
                                      x[:, 1::2, ::2])
        x[:, :2] = 0.0                            # whole windows of zeros
    return x


@pytest.mark.parametrize("h,cin,cout,stride,ties", [
    (8, 24, 28, 1, False), (8, 28, 32, 2, True), (4, 48, 56, 2, False),
    (6, 96, 96, 2, True), (6, 16, 16, 1, True), (5, 16, 16, 1, False),
])
def test_k12_twin_matches_autograd(h, cin, cout, stride, ties):
    rng = np.random.default_rng(h * 100 + cin)
    cres = cin
    res = _relu_input(rng, 2, stride * h, stride * h, cres, ties).requires_grad_(True)
    y = _rand(rng, 2, h, h, cin).requires_grad_(True)
    kernel = _rand(rng, 1, 1, cin, cout, scale=0.2).requires_grad_(True)
    bias = _rand(rng, cout, scale=0.1).requires_grad_(True)
    out = tbf.pointwise_plain(y, kernel, bias, res, stride)
    g = _rand(rng, *out.shape)
    ref = torch.autograd.grad(out, (y, kernel, bias, res), g)
    got = bt.pointwise_backward(g, y.detach(), kernel.detach(), out.detach(),
                                res.detach(), stride)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert rel(a.numpy(), r.numpy()) <= TWIN_RTOL
    if stride == 2 and ties:
        # every window sends its gradient to one place: its first maximum
        dres = got[3]
        g_masked = torch.where(out > 0, g, torch.zeros_like(g))[..., :cres]
        assert torch.equal(dres.reshape(2, h, 2, h, 2, cres).sum(dim=(2, 4)), g_masked)


def test_k12_pool_backward_matches_jax_on_ties():
    """The stride-2 residual's gradient goes where JAX's max_pool VJP
    sends it, on windows of equal zeros and equal positives."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    res = _relu_input(rng, 2, 8, 8, 6, ties=True)
    g = _rand(rng, 2, 4, 4, 6)
    _, vjp = jax.vjp(lambda r: nn.max_pool(r, (2, 2), strides=(2, 2)),
                     jnp.asarray(res.numpy()))
    ref = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    np.testing.assert_array_equal(bt._pool_backward(g, res).numpy(), ref)


def test_k12_head_form_with_strided_gradient():
    """No ReLU and no residual, the gradient a head's slice of [N, 896],
    scaled by the loss's cotangent and added into dy."""
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 8, 8, 96).requires_grad_(True)
    kernel = _rand(rng, 1, 1, 96, 6, scale=0.1).requires_grad_(True)
    bias = _rand(rng, 6).requires_grad_(True)
    full = _rand(rng, 2, 896)
    g = full[:, 512:].view(2, 8, 8, 6)
    scale = torch.tensor(0.75)
    cls = torch.matmul(x, kernel.reshape(96, 6)) + bias
    ref = torch.autograd.grad(cls, (x, kernel, bias), g * scale)
    base = _rand(rng, 2, 8, 8, 96)
    dy, dk, db, dres = bt.pointwise_backward(g, x.detach(), kernel.detach(),
                                             gscale=scale, dy=base.clone())
    assert dres is None
    assert rel((dy - base).numpy(), ref[0].numpy()) <= TWIN_RTOL
    assert rel(dk.numpy(), ref[1].numpy()) <= TWIN_RTOL
    assert rel(db.numpy(), ref[2].numpy()) <= TWIN_RTOL


def test_k13_twin_matches_jax_loss_gradient():
    """The loss and its gradient in the logits and raw offsets, against
    JAX's grad of the written expression on the same logits."""
    rng = np.random.default_rng(11)
    x16, x8 = _rand(rng, 2, 16, 16, 88), _rand(rng, 2, 8, 8, 96)
    heads = ((_rand(rng, 1, 1, 88, 2, scale=0.3), _rand(rng, 2),
              _rand(rng, 1, 1, 88, 8, scale=0.3), _rand(rng, 8)),
             (_rand(rng, 1, 1, 96, 6, scale=0.3), _rand(rng, 6),
              _rand(rng, 1, 1, 96, 24, scale=0.3), _rand(rng, 24)))
    _i, tp, tb, mask = bt.batch_to(bt.synthetic_batch(np.random.default_rng(4), 2), CPU)
    loss, dlogits, draw = bt.head_loss(x16, x8, heads, tp, tb, mask)
    parts = [tbf.head_plain(x, *h) for x, h in zip((x16, x8), heads)]
    logits = torch.cat([p[0] for p in parts], 1).numpy()
    raw = torch.cat([p[1] for p in parts], 1).numpy()

    def jloss(s, r):
        probs = jax.nn.sigmoid(s)
        t = jnp.asarray(tp.numpy())
        bce = -(t * jnp.log(probs + 1e-7) + (1.0 - t) * jnp.log(1.0 - probs + 1e-7))
        diff = r - jnp.asarray(tb.numpy())
        l1 = jnp.where(jnp.abs(diff) < 1.0, 0.5 * diff * diff, jnp.abs(diff) - 0.5)
        m = jnp.asarray(mask.numpy())
        return jnp.mean(bce * (0.25 + 0.75 * t)) + jnp.sum(l1 * m[..., None]) / (
            jnp.sum(m) * 4.0 + 1e-6)

    ref_loss, (ref_dl, ref_dr) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(raw))
    assert abs(float(loss) - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    assert rel(dlogits.numpy(), np.asarray(ref_dl)) <= TWIN_RTOL
    assert rel(draw.numpy(), np.asarray(ref_dr)) <= TWIN_RTOL
    with pytest.raises(ValueError, match="anchors"):
        bt.head_loss(x16[:, :8], x8, heads, tp, tb, mask)


@pytest.mark.cuda
def test_k11_to_k14_match_twins_on_card():
    """K11-K14 on the card against their plain twins at a small batch of
    the full-width network (the kernels' order of summation differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py on the H100)")
    dev = torch.device("cuda")
    model = bt.init_params(2, dev)
    arrays = bt.batch_to(bt.synthetic_batch(np.random.default_rng(2), 4), dev)
    loss = bt.loss_fn(model, *arrays)
    loss.backward()
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    ref_loss = bt.loss_fn_plain(model, *arrays)
    ref_loss.backward()
    assert abs(float(loss) - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    for n, p in model.named_parameters():
        assert rel(got[n].cpu().numpy(), p.grad.cpu().numpy()) <= GRAD_RTOL, n
    flat = model.flat_params
    g = torch.randn(flat.shape, device=dev)
    a = [flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)]
    b = [t.clone() for t in a]
    for step in (1, 2):
        bt.adam_update(a[0], g, a[1], a[2], step)
        bt.adam_update_plain(b[0], g, b[1], b[2], step)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# K11's and K12's launch plans (the kernels' index math, mirrored)
# ---------------------------------------------------------------------------


def _k11_calls():
    """(n-less) K11 calls of the train step: (h, w, cin, cout, stride,
    depthwise, masked) for the stem and each block's depthwise 5x5."""
    calls = [(128, 128, 3, 24, 2, False, True)]
    size, c = 64, tbf.STEM_FEATURES
    for feat, stride in tbf.BLOCKS:
        calls.append((size, size, c, c, stride, True, False))
        size, c = -(-size // stride), feat
    return calls


def _k12_calls():
    """K12 calls of the train step: (h, w, cin, cout, masked) for each
    block's 1x1 and the four heads."""
    calls, size, c = [], 64, tbf.STEM_FEATURES
    for feat, stride in tbf.BLOCKS:
        size = -(-size // stride)
        calls.append((size, size, c, feat, True))
        c = feat
    return calls + [(16, 16, 88, 2, False), (16, 16, 88, 8, False), (8, 8, 96, 6, False),
                    (8, 8, 96, 24, False)]


#: edge shapes of chip_smoke.py train_edges and of the new plans' edges:
#: (n, h, w, c, stride) depthwise, (n, h, w) stems
K11_EDGES = [(1, 17, 17, 5, 2), (3, 9, 9, 24, 1), (2, 1, 1, 7, 2), (1, 2, 2, 96, 2),
             (2, 33, 33, 28, 2), (1, 6, 6, 3, 1), (1, 13, 13, 42, 1), (2, 33, 33, 42, 2),
             (1, 11, 6, 8, 2), (1, 10, 7, 12, 1), (64, 64, 64, 24, 1), (1, 64, 64, 28, 2)]
K11_STEM_EDGES = [(1, 13, 13), (3, 8, 8), (1, 1, 1), (64, 128, 128)]
K12_EDGES = [(1, 5, 5, 24, 28), (3, 3, 3, 28, 32), (2, 7, 7, 96, 96), (1, 1, 1, 5, 9),
             (2, 4, 4, 42, 48), (1, 33, 33, 42, 48), (64, 8, 8, 96, 96), (1, 9, 9, 7, 13)]


def _k11_dx_outputs(h, w, stride, plan, oy0):
    """The (iy, ix) K11's dx items write for the band at oy0, by the
    kernel's decomposition (csrc dw_backward_kernel), with the staged g
    window's row and column reads each item makes."""
    pt, _, oh = tbf.same_pads(h, stride)
    pl, _, _ = tbf.same_pads(w, stride)
    run, gw = bt.K11_RUN, plan.gp // plan.cs
    out, reads = [], []
    if stride == 1:
        runs = -(-w // run)
        for ty in range(min(plan.tho, oh - oy0)):
            for k in range(runs):
                for s in range(5):
                    reads.append((ty + 4 - s, k * run, k * run + run + 3))
                out += [(oy0 + ty, k * run + r) for r in range(run) if k * run + r < w]
        return out, reads
    iy_lo, iy_hi = 2 * oy0, min(h, 2 * oy0 + 2 * plan.tho)
    for py in (0, 1):
        m_lo = (iy_lo + pt - py + 1) // 2
        m_hi = (iy_hi - 1 + pt - py) // 2
        for px in (0, 1):
            n_lo, n_hi = (pl - px + 1) // 2, (w - 1 + pl - px) // 2
            ty_n, tx_n = 3 - py, 3 - px
            for m in range(m_lo, m_hi + 1):
                for k in range(-(-max(0, n_hi - n_lo + 1) // run)):
                    n0 = n_lo + k * run
                    for s in range(ty_n):
                        reads.append((m - s - oy0 + 2, n0 + 2 - (tx_n - 1),
                                      n0 + 2 + run - 1))
                    out += [(2 * m + py - pt, 2 * (n0 + r) + px - pl)
                            for r in range(run) if n0 + r <= n_hi]
    assert gw >= max(c1 for _r, _c0, c1 in reads) + 1
    return out, reads


def _check_k11_plan(n, h, w, cin, cout, stride, depthwise, masked):
    plan = bt.k11_plan(n, h, w, cin, cout, stride, depthwise, masked)
    pt, _, oh = tbf.same_pads(h, stride)
    _, _, ow = tbf.same_pads(w, stride)
    c = cin if depthwise else cout
    assert plan.smem_bytes <= tbf.SMEM_BLOCK_MAX
    qn = 5 * plan.cs // 4 * (1 if depthwise else cin)
    assert plan.lanes >= 1 and qn * plan.lanes <= bt.TRAIN_THREADS
    assert plan.cs % 4 == 0 and (plan.slices - 1) * plan.cs < c <= plan.slices * plan.cs
    assert (plan.bands - 1) * plan.tho < oh <= plan.bands * plan.tho
    tiles = n * plan.bands
    tpc = plan.tiles_per_chunk
    assert (plan.chunks - 1) * tpc < tiles <= plan.chunks * tpc
    assert plan.stages == (2 if tpc > 1 else 1)
    # dk: each band's runs of 4 cover its output-gradient columns once, and
    # the staged x rows and columns they read exist
    run = bt.K11_RUN
    runs = -(-ow // run)
    assert (runs - 1) * run < ow <= runs * run
    assert plan.x_rows == (plan.tho - 1) * stride + 5
    x_cols = (runs * run - 1) * stride + 5
    assert plan.xp >= (x_cols * plan.cs if depthwise else 3 + x_cols * cin)
    g_cols = plan.gp // plan.cs
    assert g_cols >= (runs * run + 2 if depthwise else runs * run)
    if not depthwise:
        assert plan.g_rows == plan.tho
        return
    assert plan.g_rows == plan.tho + (4 if stride == 1 else 3)
    # dx: the bands' items write every input pixel exactly once and read
    # only staged rows
    written = np.zeros((h, w), np.int64)
    for band in range(plan.bands):
        out, reads = _k11_dx_outputs(h, w, stride, plan, band * plan.tho)
        for iy, ix in out:
            written[iy, ix] += 1
        assert all(0 <= r < plan.g_rows and c0 >= 0 for r, c0, _c1 in reads)
    assert (written == 1).all()


@pytest.mark.parametrize("batch", [1, 16, 64])
@pytest.mark.parametrize("call", range(17))
def test_k11_plan_covers_every_row_once(batch, call):
    """At every K11 call of the train step: the slices cover the channels,
    the bands the rows, the chunks the tiles, each once; dx items write
    every input pixel once from staged rows; shared memory and the dk
    lanes fit a block."""
    h, w, cin, cout, stride, depthwise, masked = _k11_calls()[call]
    _check_k11_plan(batch, h, w, cin, cout, stride, depthwise, masked)


@pytest.mark.parametrize("shape", K11_EDGES + [("stem",) + s for s in K11_STEM_EDGES])
def test_k11_plan_covers_edge_shapes(shape):
    if shape[0] == "stem":
        n, h, w = shape[1:]
        _check_k11_plan(n, h, w, 3, 24, 2, False, True)
    else:
        n, h, w, c, stride = shape
        _check_k11_plan(n, h, w, c, c, stride, True, False)
        _check_k11_plan(n, h, w, c, c, stride, True, True)


def _check_k12_plan(n, h, w, cin, cout, masked):
    plan = bt.k12_plan(n, h, w, cin, cout, masked)
    pixels = n * h * w
    assert plan.smem_bytes <= tbf.SMEM_BLOCK_MAX
    assert plan.dy_tile in (16, 32, 64)
    assert (plan.dy_blocks - 1) * plan.dy_tile < pixels <= plan.dy_blocks * plan.dy_tile
    for t, c, tiles in ((plan.tci, cin, plan.ci_tiles), (plan.tco, cout, plan.co_tiles)):
        assert t % 4 == 0 and t <= bt.K12_MAX_TILE
        assert (tiles - 1) * t < c <= tiles * t
    pairs = plan.tci // 4 * (plan.tco // 4)
    assert 1 <= pairs <= bt.TRAIN_THREADS
    assert plan.chunk_px % bt.K12_SUB_PX == 0
    assert (plan.chunks - 1) * plan.chunk_px < pixels <= plan.chunks * plan.chunk_px
    assert plan.chunks * (plan.tci * plan.tco + plan.tco) <= max(
        bt.K12_PARTIAL_CAP, plan.tci * plan.tco + plan.tco)
    # the chunks' partials and the groups' sums; each group sums at most
    # `group` chunks, the last block of a tile its groups' sums
    groups = -(-plan.chunks // plan.group)
    assert (groups - 1) * plan.group < plan.chunks <= groups * plan.group
    if plan.chunks <= bt.K12_ONE_LEVEL:
        assert plan.group == plan.chunks
    else:
        assert plan.group <= 2 * int(plan.chunks ** 0.5) and groups <= plan.group
    tiles = plan.ci_tiles * plan.co_tiles
    assert plan.partial_floats == tiles * (plan.chunks + groups) * (plan.tci * plan.tco + plan.tco)
    assert plan.counters == tiles * (groups + 1)


@pytest.mark.parametrize("batch", [1, 16, 64])
@pytest.mark.parametrize("call", range(20))
def test_k12_plan_covers_every_pixel_once(batch, call):
    """At every K12 call of the train step: dy blocks cover the pixels, dW
    tiles the (ci, co) pairs, each tile's chunks the pixels, each once;
    shared memory and the 4 x 4 register tiles of a dW tile fit a block."""
    h, w, cin, cout, masked = _k12_calls()[call]
    _check_k12_plan(batch, h, w, cin, cout, masked)


@pytest.mark.parametrize("shape", K12_EDGES)
def test_k12_plan_covers_edge_shapes(shape):
    n, h, w, cin, cout = shape
    for masked in (True, False):
        _check_k12_plan(n, h, w, cin, cout, masked)


#: the two anchor maps' (pixels, channels, anchors a pixel) at full width
K13_MAPS = ((16 * 16, 88, 2), (8 * 8, 96, 6))


@pytest.mark.parametrize("n", range(1, 65))
def test_k13_plan_covers_every_anchor_once(n):
    """K13's tiles, walked as the kernel walks them (tile t of the 16x16
    map below ``tiles16``, of the 8x8 map past it; a thread an anchor),
    cover each of the n x 896 anchors exactly once; a block's threads hold
    a tile's anchors, and its staged rows and weights fit 48 KB."""
    (hw16, c16, na16), (hw8, c8, na8) = K13_MAPS
    plan = bt.k13_plan(n, hw16, na16, hw8, na8)
    assert plan.partial_floats == 2 * plan.tiles
    hits = np.zeros(n * tbf.NUM_ANCHORS, np.int64)
    for t in range(plan.tiles):
        second = t >= plan.tiles16
        hw, cin, na = K13_MAPS[1] if second else K13_MAPS[0]
        tile = plan.tile8 if second else plan.tile16
        per = -(-hw // tile)
        tt = t - plan.tiles16 if second else t
        b, p0 = tt // per, (tt % per) * tile
        px = min(tile, hw - p0)
        assert b < n and px > 0 and px * na <= bt.K13_THREADS
        base = hw16 * na16 if second else 0
        first = b * tbf.NUM_ANCHORS + base + p0 * na
        hits[first:first + px * na] += 1
    assert (hits == 1).all()
    assert plan.tiles16 == n * -(-hw16 // plan.tile16)
    assert plan.tiles == plan.tiles16 + n * -(-hw8 // plan.tile8)
    # x rows at a 16-byte pitch 4 floats past the channels, the class
    # weights to a 16-byte end, the offset weights
    smem = 4 * max(tile * (-(-c // 4) * 4 + 4) + -(-c * na // 4) * 4 + 4 * c * na
                   for tile, (_hw, c, na) in ((plan.tile16, K13_MAPS[0]), (plan.tile8, K13_MAPS[1])))
    assert smem <= 48 * 1024
    # the largest tiles that still fill the card's SMs (132), else the smallest
    filling = [(t16, t8) for t16, t8 in bt.K13_TILES
               if n * (-(-hw16 // t16) + -(-hw8 // t8)) >= 132]
    assert (plan.tile16, plan.tile8) == (filling[0] if filling else bt.K13_TILES[-1])


@pytest.mark.parametrize("stride", [1, 2])
def test_conv5x5_backward_dx_into_is_autograds_sum(stride):
    """The plain path of ``conv5x5_backward(..., dx_into=)`` adds the input
    gradient into K12's residual gradient in place: bit-equal to
    autograd's ``dres + dx`` of the block input."""
    rng = np.random.default_rng(40 + stride)
    x = _rand(rng, 3, 9, 9, 12).requires_grad_(True)
    kernel = _rand(rng, 5, 5, 1, 12, scale=0.2)
    y = tbf.conv5x5_plain(x, kernel, None, stride, False)
    g = _rand(rng, *y.shape)
    dres = _rand(rng, *x.shape)
    ref = torch.autograd.grad((y * g).sum() + (x * dres).sum(), x)[0]
    into = dres.clone()
    dx, _dk, _db = bt.conv5x5_backward(g, x.detach(), kernel, None, stride, False, True,
                                       dx_into=into)
    assert dx is into
    assert torch.equal(dx, dres + bt.conv5x5_backward(g, x.detach(), kernel, None, stride)[0])
    assert torch.equal(dx, ref)
    with pytest.raises(ValueError, match="dx_into"):
        bt.conv5x5_backward(g, x.detach(), kernel, None, stride, dx_into=into[:1])


@pytest.mark.parametrize("features,stride", [(28, 1), (32, 2)])
def test_block_gradients_match_jax(features, stride):
    """``_Block`` (K9 + K10 forward, K12 + K11 backward; their twins here)
    at batch 3 against ``jax.value_and_grad`` of the JAX package's
    BlazeBlock under a fixed output cotangent: the loss within 1e-5, every
    gradient (the input's one, summed from the depthwise path and the
    residual, and the three parameters') within 1e-4 of its max."""
    rng = np.random.default_rng(features + stride)
    x = rng.uniform(0, 1, (3, 16, 16, 24)).astype(np.float32)
    block = jbf.BlazeBlock(features, stride)
    jp = block.init(jax.random.PRNGKey(features), jnp.asarray(x))
    out_shape = block.apply(jp, jnp.asarray(x)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    def jloss(p, xin):
        return jnp.sum(block.apply(p, xin) * cot)

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    pp = jax.tree.map(np.array, jp)["params"]
    jgp = jax.tree.map(np.asarray, jg)["params"]
    tx = torch.from_numpy(x).requires_grad_(True)
    params = [torch.from_numpy(pp["Conv_0"]["kernel"]).requires_grad_(True),
              torch.from_numpy(pp["Conv_1"]["kernel"]).requires_grad_(True),
              torch.from_numpy(pp["Conv_1"]["bias"]).requires_grad_(True)]
    out = bt._Block.apply(tx, *params, stride, None)
    loss = (out * torch.from_numpy(cot)).sum()
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    loss.backward()
    refs = [jgp["Conv_0"]["kernel"], jgp["Conv_1"]["kernel"], jgp["Conv_1"]["bias"]]
    assert rel(tx.grad.numpy(), np.asarray(jgx)) <= GRAD_RTOL
    for p, r in zip(params, refs):
        assert p.grad.shape == r.shape
        assert rel(p.grad.numpy(), r) <= GRAD_RTOL
