"""The DP x TP BlazeFace training step of the PyTorch package
(``models/blazeface_train.py make_sharded_train_step``) against its
unsharded step and the JAX package's, on the CPU at full width.

The step runs on virtual CPU meshes (every rank on the CPU), where each
kernel wrapper runs its plain version; ``chip_smoke.py`` phase 21 runs it
through the kernels on the card. Part 1 of ``__graft_entry__``'s
``dryrun_multichip`` is the JAX counterpart: ``shard_param`` places the
parameters over ``model``, the batch over ``data``.

Bounds, each stated where it is checked:
- the placement: the same leaves sharded, with the same shard shapes, as
  ``shard_param`` gives the JAX parameters;
- the (dp 4, tp 2) step against the unsharded step from the same
  parameters: the loss within 1e-6 relative (the same terms summed in
  another order); each gradient leaf within 1e-5 of that leaf's max
  |value| (per-shard sums added in rank order); the parameters after
  Adam's first update within ``adam_first_step_bound`` of each other;
- both steps' loss and gradients against ``jax.value_and_grad(loss_fn)``
  (eager) with ``test_torch_blazeface_train.py``'s LOSS_RTOL and
  GRAD_RTOL;
- K13's plain version with the global normalisers: the shards' losses
  summed within 1e-6 relative of the whole batch's, their dlogits and draw
  within 1e-6 of its max |value|.

Each runs on ``synthetic_batch`` (8 positives an image: every data shard
has the same mask sum) and on a mask whose positives differ between
shards, one shard having none: a shard normalising by its own mask would
fail there (and on the synthetic mask too: a shard's own count and mask sum
are a quarter of the global ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from flyimg_tpu.models import blazeface as jbf
from flyimg_tpu.parallel.mesh import make_mesh as jmake_mesh
from flyimg_tpu_torch.entry import dryrun_multichip
from flyimg_tpu_torch.models import blazeface as tbf
from flyimg_tpu_torch.models import blazeface_train as bt
from flyimg_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5        # against JAX (test_torch_blazeface_train.py)
GRAD_RTOL = 1e-4        # against JAX, of each leaf's max |value|
SHARD_LOSS_RTOL = 1e-6  # sharded against unsharded
SHARD_GRAD_RTOL = 1e-5  # sharded against unsharded, of each leaf's max |value|
BATCH = 8
#: the batch's seed: ``test_torch_blazeface_train.py``'s. At this fresh
#: initialisation (logits up to ~60) the saturated ``log(1 - p + 1e-7)``
#: terms make the f32 gradient ill-conditioned (ROADMAP C6): on seed 1's
#: batch of 8 the port's two forms agree to 1e-6 but sit 2e-3 from JAX's
#: stem gradient, and both packages' f32 cls8 gradients 5e-2 from a float64
#: one, past GRAD_RTOL whatever the sharding.
SEED = 5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def adam_first_step_bound(g1, g2, p):
    """How far apart Adam's first update leaves two parameters that start
    equal, from their two gradients. At step 1 ``mu_hat = g`` and
    ``nu_hat = g^2``, so the update is ``-lr g / (|g| + eps)``: a
    monotone function of g with slope ``eps / (|g| + eps)^2``. Between g1
    and g2 of one sign the updates differ by at most ``lr |g1 - g2| eps /
    (min(|g1|, |g2|) + eps)^2``, across zero by at most ``lr |g1 - g2| /
    eps``, and never by more than ``2 lr``; plus the f32 rounding of the
    update (1e-6 of ``lr``) and of the sum ``p + update`` (one ulp of
    ``p``)."""
    g1, g2, p = (np.asarray(t, np.float64) for t in (g1, g2, p))
    lr, eps = bt.LEARNING_RATE, bt.ADAM_EPS
    same = np.sign(g1) == np.sign(g2)
    m = np.where(same, np.minimum(np.abs(g1), np.abs(g2)), 0.0)
    slope = eps / (m + eps) ** 2
    return lr * (np.minimum(2.0, np.abs(g1 - g2) * slope) + 1e-6) + 2.0 ** -23 * np.abs(p)


def shard_param(leaf, mesh, tp):
    """``__graft_entry__.dryrun_multichip``'s rule, as written there."""
    if leaf.ndim == 4 and leaf.shape[-1] % tp == 0 and leaf.shape[-1] >= tp:
        return NamedSharding(mesh, P(None, None, None, "model"))
    if leaf.ndim == 1 and leaf.shape[0] % tp == 0 and leaf.shape[0] >= 8:
        return NamedSharding(mesh, P("model"))
    return NamedSharding(mesh, P())


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(jbf.init_params)(jax.random.PRNGKey(5))


def trainable(jparams):
    model = tbf.BlazeFace()
    model.load_state_dict(tbf.params_from_flax(jax.tree.map(np.asarray, jparams)))
    return bt.flatten_parameters(model)


def unequal_mask(mask):
    """``mask`` with image i keeping max(i - 1, 0) of its positives: at
    batch 8 over 4 data ranks, 0, 3, 7 and 11 positives a rank."""
    out = mask.copy()
    for i in range(out.shape[0]):
        pos = np.flatnonzero(out[i])
        out[i, pos[max(i - 1, 0):]] = 0.0
    return out


@pytest.fixture(scope="module", params=["synthetic", "unequal"])
def batch(request):
    images, probs, boxes, mask = bt.synthetic_batch(np.random.default_rng(SEED), BATCH)
    if request.param == "unequal":
        mask = unequal_mask(mask)
        assert mask.reshape(4, 2, -1).sum(axis=(1, 2)).tolist() == [0.0, 3.0, 7.0, 11.0]
    return images, probs, boxes, mask


@pytest.mark.parametrize("tp", [2, 4])
def test_placement_matches_jax_shard_param(jparams, tp):
    """The port's placement of the carried-across parameters against
    ``shard_param``'s on the JAX side: the same leaves sharded, with equal
    shard shapes; at tp 2 every leaf but the two class biases is sharded
    (106,932 of 106,940 values)."""
    dp = 8 // tp
    jmesh = jmake_mesh((dp, tp), ("data", "model"))
    placed = jax.device_put(jparams, jax.tree.map(lambda x: shard_param(x, jmesh, tp),
                                                  jparams))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(placed)[0]}
    flat = {k[len("params/"):] if k.startswith("params/") else k: v for k, v in flat.items()}
    names = tbf.flax_names()
    places = bt.placement(trainable(jparams), tp)
    assert len(places) == len(flat)
    for pl in places:
        leaf = flat[names[pl.name]]
        assert pl.shape == leaf.shape, pl.name
        assert pl.sharded == (not leaf.sharding.is_fully_replicated), pl.name
        assert pl.shard_shape == leaf.addressable_shards[0].data.shape, pl.name
    if tp == 2:
        assert sum(np.prod(pl.shape) for pl in places if pl.sharded) == 106932
        assert [pl.name for pl in places if not pl.sharded] == ["cls16.bias", "cls8.bias"]


def test_shard_index_covers_each_value_once():
    """Model rank m's positions cut every sharded leaf's last axis into tp
    equal slices and repeat every replicated leaf whole."""
    model = bt.init_params(0, CPU)
    places = bt.placement(model, 2)
    total = sum(int(np.prod(pl.shape)) for pl in places)
    idx = [bt.shard_index(places, 2, m) for m in range(2)]
    seen = torch.zeros(total, dtype=torch.int64)
    for i in idx:
        seen.index_add_(0, i, torch.ones_like(i))
    replicated = sum(int(np.prod(pl.shape)) for pl in places if not pl.sharded)
    assert int((seen == 2).sum()) == replicated and int((seen == 1).sum()) == total - replicated
    flat = model.flat_params.detach()
    stem = places[0]
    got = flat.index_select(0, idx[1])[:int(np.prod(stem.shard_shape))].view(stem.shard_shape)
    assert torch.equal(got, model.stem.kernel.detach()[..., 12:])


@pytest.fixture(scope="module")
def steps(jparams, batch):
    """One unsharded step and one (dp 4, tp 2) step from JAX's parameters
    on ``batch``, and JAX's eager ``value_and_grad`` of it."""
    arrays = bt.batch_to(batch, CPU)
    ref = trainable(jparams)
    _opt, step = bt.make_train_step(ref)
    ref_loss = float(step(*arrays))
    mesh = make_mesh((4, 2), ("data", "model"), [CPU] * 8)
    trainer, sharded_step = bt.make_sharded_train_step(trainable(jparams), mesh)
    loss = float(sharded_step(*arrays))
    jloss, jgrads = jax.value_and_grad(jbf.loss_fn)(jparams, *(jnp.asarray(a) for a in batch))
    return ref, ref_loss, trainer, loss, float(jloss), tbf.params_from_flax(
        jax.tree.map(np.asarray, jgrads))


def _leaves(model, flat):
    """``flat`` (the full flat layout) cut into the model's leaves by name."""
    out, off = {}, 0
    for name, p in model.named_parameters():
        out[name] = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return out


def test_sharded_step_equals_unsharded(steps):
    ref, ref_loss, trainer, loss, _jloss, _jgrads = steps
    assert trainer.count == 1
    assert abs(loss - ref_loss) <= SHARD_LOSS_RTOL * abs(ref_loss)
    ours = _leaves(ref, trainer.grads)
    theirs = _leaves(ref, ref.flat_grads)
    for name in theirs:
        assert rel(ours[name].numpy(), theirs[name].numpy()) <= SHARD_GRAD_RTOL, name
    got = trainer.full_params().numpy()
    want = ref.flat_params.detach().numpy()
    bound = adam_first_step_bound(trainer.grads.numpy(), ref.flat_grads.numpy(), want)
    excess = np.abs(got.astype(np.float64) - want) - bound
    assert excess.max() <= 0.0, float(excess.max())
    # every data rank holds the same parameters and moments
    for d in range(1, trainer.dp):
        for m in range(trainer.tp):
            assert torch.equal(trainer.params[d][m], trainer.params[0][m])
            assert torch.equal(trainer.nu[d][m], trainer.nu[0][m])


def test_both_steps_match_jax(steps):
    ref, ref_loss, trainer, loss, jloss, jgrads = steps
    for value in (ref_loss, loss):
        assert abs(value - jloss) <= LOSS_RTOL * abs(jloss)
    for flat in (ref.flat_grads, trainer.grads):
        ours = _leaves(ref, flat)
        for name, want in jgrads.items():
            assert rel(ours[name].numpy(), want.numpy()) <= GRAD_RTOL, name


def test_k13_plain_takes_the_global_normalisers(jparams, batch):
    """The heads' loss of the whole batch equals its four shards' losses
    summed when each shard gets the global mask, with the same gradients
    in the logits and offsets; with its own mask a shard's loss differs."""
    model = trainable(jparams)
    images, probs, boxes, mask = bt.batch_to(batch, CPU)
    with torch.no_grad():
        x16, x8 = _maps(model, images)
    heads = [(h.kernel, h.bias, r.kernel, r.bias) for h, r in
             ((model.cls16, model.reg16), (model.cls8, model.reg8))]
    loss, dlogits, draw = bt.head_loss(x16, x8, heads, probs, boxes, mask)
    parts = [bt.head_loss(x16[c], x8[c], heads, probs[c], boxes[c], mask[c], mask)
             for c in (slice(2 * d, 2 * d + 2) for d in range(4))]
    total = sum(float(p[0]) for p in parts)
    assert abs(total - float(loss)) <= SHARD_LOSS_RTOL * abs(float(loss))
    assert rel(torch.cat([p[1] for p in parts]).numpy(), dlogits.numpy()) <= 1e-6
    assert rel(torch.cat([p[2] for p in parts]).numpy(), draw.numpy()) <= 1e-6
    local = sum(float(bt.head_loss(x16[c], x8[c], heads, probs[c], boxes[c], mask[c])[0])
                for c in (slice(2 * d, 2 * d + 2) for d in range(4)))
    assert abs(local - float(loss)) > 1e-3 * abs(float(loss))


def _maps(model, images):
    """The two maps the heads read (the 16x16 after block X16_BLOCK, the
    8x8 after the last), through the plain layers."""
    x = tbf.conv5x5_plain(images, model.stem.kernel, model.stem.bias, 2, relu=True)
    maps = []
    for i, block in enumerate(model.blocks):
        x = block.forward_plain(x)
        if i == tbf.X16_BLOCK:
            maps.append(x)
    return maps[0], x


def test_sharded_step_refuses_other_meshes_and_batches():
    model = bt.init_params(0, CPU)
    with pytest.raises(ValueError, match="data"):
        bt.make_sharded_train_step(model, make_mesh((4,), ("data",), [CPU] * 4))
    _trainer, step = bt.make_sharded_train_step(model, make_mesh((3, 1), ("data", "model"),
                                                                 [CPU] * 3))
    arrays = bt.batch_to(bt.synthetic_batch(np.random.default_rng(2), 4), CPU)
    with pytest.raises(ValueError, match="shard"):
        step(*arrays)


def test_dryrun_multichip_eight_ranks(capsys):
    """``entry.dryrun_multichip(8)``: parts 1-3 on a virtual 8-rank CPU mesh
    with the JAX line's fields (dp 4, tp 2; the serving batch repeated 8
    times)."""
    dryrun_multichip(8)
    line = capsys.readouterr().out
    assert "dryrun_multichip ok: dp=4 tp=2 sp=8, train loss " in line
    assert "tiled (64, 48, 3)" in line and "serve batch (32, 250, 300, 3)" in line
