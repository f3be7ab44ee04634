"""The port's RAFT (basic and small) against vpd_tpu's, on the CPU.

Weights are drawn with numpy from a seed into vpd_tpu's variable tree
and moved into the port through the flax bridge
(`models/flax_weights.load_raft_from_flax`); inputs are numpy arrays
from a seed. Bars:
- `state_dict()` keys are `export_torch_raft`'s, the flax round trip is
  exact, and an official-layout checkpoint (DataParallel's `module.`,
  BatchNorm counters, the strided blocks' `norm3` aliases) loads as it
  is;
- the units (correlation pyramid, lookup, convex and bilinear
  upsampling, `sequence_loss`) at 1e-5;
- the whole forward in float32 at 64 and 128 px, 2 iterations: atol
  1e-3, the bar of `tests/test_raft_torch_parity.py`;
- bf16: the port's mean absolute error against its float32 flow within
  2x of vpd_tpu's own bf16-against-f32 error (the CPU conv libraries
  round differently);
- `train=True`: every iteration's prediction and the BatchNorm running
  statistics against vpd_tpu's (atol 1e-3 and 1e-5), finite gradients;
- `compute_flow --model <ckpt.pth>` in float32 writes vpd_tpu's PNGs
  (within one step, equal on >= 99.9%).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flow import read_outputs, write_pair_tree
from vpd_tpu.models import raft as jraft
from vpd_tpu.tools import compute_flow as jcli
from vpd_tpu_torch.models import flax_weights as tfw
from vpd_tpu_torch.models import raft as traft
from vpd_tpu_torch.models.torch_compat import load_torch_state_dict
from vpd_tpu_torch.tools import compute_flow as tcli

torch.set_num_threads(2)

FWD_ATOL = 1e-3
UNIT_ATOL = 1e-5
ARCHS = ['basic', 'small']


@functools.lru_cache(maxsize=None)
def jax_variables(arch):
    """Weights in vpd_tpu's variable tree (its structure from
    `jax.eval_shape` of `init`), drawn with numpy: lecun-normal kernels,
    small biases, BatchNorm affines and statistics off 1 and 0 so that
    eval mode differs from train mode."""
    small = arch == 'small'
    z = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jraft.RAFT(small=small).init(
        jax.random.key(0), z, z, iters=1))
    rng = np.random.default_rng(3 + small)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ('bias', 'mean'):
            x = rng.normal(0., .1, shape)
        else:  # BatchNorm scale, running var
            x = rng.uniform(.5, 1.5, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


@functools.partial(jax.jit, static_argnames=('small', 'dtype', 'iters',
                                             'train'))
def _jax_apply(variables, im1, im2, small, dtype, iters, train=False):
    model = jraft.RAFT(small=small, dtype=dtype)
    if train:
        return model.apply(variables, im1, im2, iters=iters, train=True,
                           mutable=['batch_stats'])
    return model.apply(variables, im1, im2, iters=iters)


def port_model(arch):
    model = traft.RAFT(small=arch == 'small')
    return tfw.load_raft_from_flax(model, jax_variables(arch)).eval()


def images(size, b=2, seed=5):
    rng = np.random.default_rng(seed)
    im1 = rng.integers(0, 255, (b, size, size, 3)).astype(np.float32)
    im2 = np.roll(im1, 2, axis=2) + rng.normal(
        scale=2., size=im1.shape).astype(np.float32)
    return im1, im2


def leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


# ------------------------------------------------------------ weights

@pytest.mark.parametrize('arch', ARCHS)
def test_state_dict_keys_and_flax_round_trip(arch):
    v = jax_variables(arch)
    ref_sd = jraft.export_torch_raft(v)
    model = port_model(arch)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref_sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), ref_sd[k], err_msg=k)
    back = tfw.raft_to_flax(model)
    a, b = leaves(back), leaves(v)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    # the port's copies of the bridge are vpd_tpu's
    port_sd = tfw.export_torch_raft(v)
    assert sorted(port_sd) == sorted(ref_sd)
    ja, ta = (leaves(jraft.import_torch_raft(ref_sd)),
              leaves(tfw.import_torch_raft(ref_sd)))
    assert sorted(ja) == sorted(ta)
    assert traft.is_small_state_dict(sd) == (arch == 'small')
    n = sum(t.numel() for t in model.parameters())
    assert n == sum(x.size for x in leaves(v['params']).values())
    if arch == 'basic':
        assert n == 5257536  # the official basic RAFT


@pytest.mark.parametrize('arch', ARCHS)
def test_official_checkpoint_loads(arch, tmp_path):
    """The layout princeton-vl's checkpoints have: DataParallel's
    `module.` prefix, BatchNorm's counters, and (basic) each strided
    cnet block's BatchNorm under `norm3` as well as `downsample.1`."""
    ref_sd = jraft.export_torch_raft(jax_variables(arch))
    official = {'module.' + k: torch.from_numpy(np.array(v))
                for k, v in ref_sd.items()}
    for k in list(official):
        if k.endswith('.running_var'):
            official[k[:-len('running_var')] + 'num_batches_tracked'] = \
                torch.tensor(7)
        if '.downsample.1.' in k:
            official[k.replace('.downsample.1.', '.norm3.')] = official[k]
    if arch == 'basic':
        assert 'module.cnet.layer2.0.norm3.weight' in official
    path = str(tmp_path / 'raft.pth')
    torch.save(official, path)
    model = traft.build_raft(load_torch_state_dict(path))
    assert model.small == (arch == 'small') and not model.training
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref_sd[k], err_msg=k)
    strict = traft.RAFT(small=arch == 'small')
    strict.load_state_dict(dict(official))  # strict by default
    # random init is seeded: the same weights every build
    a, b = traft.build_raft(small=True), traft.build_raft(small=True)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


# -------------------------------------------------------------- units

def test_units_match_vpd_tpu():
    rng = np.random.default_rng(0)
    f1, f2 = (rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
              for _ in range(2))
    jp = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    tp = traft.corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    assert [t.shape[1:] for t in tp] == [(8, 8), (4, 4), (2, 2), (1, 1)]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=UNIT_ATOL)
    grid = traft.coords_grid(2, 8, 8)
    np.testing.assert_array_equal(grid.numpy(),
                                  np.asarray(jraft.coords_grid(2, 8, 8)))
    # centres inside, fractional, and past every border (zero padding)
    coords = grid.numpy() + rng.uniform(-6, 6, (2, 8, 8, 2)).astype(
        np.float32)
    for radius in (3, 4):
        a = traft.corr_lookup(tp, torch.from_numpy(coords), radius).numpy()
        b = np.asarray(jraft.corr_lookup(jp, jnp.asarray(coords), radius))
        assert a.shape == b.shape == (2, 8, 8, 4 * (2 * radius + 1) ** 2)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=UNIT_ATOL)
    flow = rng.normal(size=(2, 3, 5, 2)).astype(np.float32)
    mask = rng.normal(scale=3., size=(2, 3, 5, 576)).astype(np.float32)
    np.testing.assert_allclose(
        traft.upsample_flow_convex(torch.from_numpy(flow),
                                   torch.from_numpy(mask)).numpy(),
        np.asarray(jraft.upsample_flow_convex(jnp.asarray(flow),
                                              jnp.asarray(mask))),
        atol=UNIT_ATOL)
    for shape in ((2, 3, 5, 2), (1, 1, 4, 2)):
        f = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_allclose(
            traft.upsample_flow_bilinear8(torch.from_numpy(f)).numpy(),
            np.asarray(jraft.upsample_flow_bilinear8(jnp.asarray(f))),
            atol=UNIT_ATOL)
    preds = [rng.normal(scale=3., size=(2, 8, 8, 2)).astype(np.float32)
             for _ in range(3)]
    gt = rng.normal(scale=200., size=(2, 8, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(
        float(traft.sequence_loss([torch.from_numpy(p) for p in preds],
                                  torch.from_numpy(gt))),
        float(jraft.sequence_loss([jnp.asarray(p) for p in preds],
                                  jnp.asarray(gt))), rtol=UNIT_ATOL)


# ------------------------------------------------------------ forward

@functools.lru_cache(maxsize=None)
def jax_flow(arch, size, dtype='float32', iters=2):
    im1, im2 = images(size)
    return np.asarray(_jax_apply(jax_variables(arch), im1, im2,
                                 arch == 'small', getattr(jnp, dtype),
                                 iters))


def port_flow(arch, size, dtype=None, iters=2):
    im1, im2 = images(size)
    with torch.no_grad():
        return port_model(arch)(torch.from_numpy(im1), torch.from_numpy(im2),
                                iters=iters, dtype=dtype).numpy()


@pytest.mark.parametrize('size', [64, 128])
@pytest.mark.parametrize('arch', ARCHS)
def test_forward_f32_matches_vpd_tpu(arch, size):
    ref = jax_flow(arch, size)
    got = port_flow(arch, size)
    assert got.shape == ref.shape == (2, size, size, 2)
    assert np.isfinite(got).all() and np.abs(ref).max() > 1.
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL)


@pytest.mark.parametrize('arch', ARCHS)
def test_bf16_error_within_2x_of_vpd_tpu(arch):
    ref_err = np.abs(jax_flow(arch, 64, 'bfloat16') - jax_flow(arch, 64))
    err = np.abs(port_flow(arch, 64, torch.bfloat16) - port_flow(arch, 64))
    assert 0 < err.mean() <= 2 * ref_err.mean(), (err.mean(),
                                                  ref_err.mean())
    assert err.max() <= 2 * ref_err.max(), (err.max(), ref_err.max())


@pytest.mark.parametrize('arch', ARCHS)
def test_train_mode_matches_vpd_tpu(arch):
    """train=True: one prediction an iteration; the context BatchNorm on
    batch statistics with flax's running-statistics update; gradients
    reach every parameter through the detached coordinates."""
    small = arch == 'small'
    v = jax_variables(arch)
    im1, im2 = images(64, seed=6)
    preds, new_state = _jax_apply(v, im1, im2, small, jnp.float32, 2,
                                  train=True)
    model = port_model(arch).train()
    got = model(torch.from_numpy(im1), torch.from_numpy(im2), iters=2,
                train=True)
    assert len(got) == len(preds) == 2
    for a, b in zip(got, preds):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=FWD_ATOL)
    stats = tfw.raft_to_flax(model)['batch_stats']
    a, b = leaves(stats), leaves(jax.tree_util.tree_map(
        np.asarray, dict(new_state).get('batch_stats', {})))
    assert sorted(a) == sorted(b) and (small or len(a) > 0)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=UNIT_ATOL,
                                   err_msg=str(k))
    loss = traft.sequence_loss(got, torch.zeros(2, 64, 64, 2))
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert all(float(g.abs().sum()) > 0 for g in grads)


def test_flow_fn_takes_uint8_pairs():
    im1, im2 = (x.astype(np.uint8) for x in images(64))
    model = port_model('basic')
    fn = traft.raft_flow_fn(model, iters=2)
    got = fn(torch.from_numpy(im1), torch.from_numpy(im2))
    with torch.no_grad():
        want = model(torch.from_numpy(im1.astype(np.float32)),
                     torch.from_numpy(im2.astype(np.float32)), iters=2)
    assert torch.equal(got, want) and got.dtype == torch.float32


def test_cli_checkpoint_pngs_match_vpd_tpu(tmp_path):
    """`--model <ckpt.pth>` (the reference's argv) in float32, 2
    iterations, in both packages on one checkpoint and tree."""
    root = str(tmp_path / 'pairs')
    write_pair_tree(root, n_videos=1, frames=3, size=64, seed=21)
    ckpt = str(tmp_path / 'raft-things.pth')
    torch.save({'module.' + k: torch.from_numpy(np.array(v)) for k, v in
                jraft.export_torch_raft(jax_variables('basic')).items()},
               ckpt)
    kw = dict(clip=20, img_dim=64, batch_size=2, overwrite=False,
              model=ckpt, raft_iters=2, mixed_precision=False)
    jcli.main(root, 'jr', **kw)
    assert tcli.main(root, 'tr', device='cpu', **kw) == 3
    ref, got = read_outputs(root, 'jr'), read_outputs(root, 'tr')
    assert list(got) == list(ref) and len(got) == 3
    a = np.stack(list(got.values())).astype(int)
    b = np.stack(list(ref.values())).astype(int)
    assert (a[..., 2] == 128).all() and np.abs(a - b).max() <= 1
    assert (a == b).mean() >= 0.999, (a == b).mean()
    # random init (no weights) is a smoke path: it runs, bf16 included
    assert tcli.main(root, 'rand', model='raft', raft_iters=1,
                     device='cpu', **{k: kw[k] for k in (
                         'clip', 'img_dim', 'batch_size',
                         'overwrite')}) == 3
    assert os.path.exists(os.path.join(root, 'v0', '0.rand.png'))
