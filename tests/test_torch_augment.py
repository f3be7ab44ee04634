"""The port's training augmentation against vpd_tpu's, on vpd_tpu's draws.

JAX's threefry and torch's Philox never give the same stream, so each
case draws vpd_tpu's random values from a JAX key exactly as
`vpd_tpu.data.augment` splits it (`jax_jitter_draws`, `jax_draws`), runs
vpd_tpu's function with that key, and feeds the same values to the port's
function. Bars: float32 max abs error <= 1e-5; bfloat16 within 2 bf16
steps on at least 99.9% of the elements (both packages round each op to
bf16, but XLA may keep a fused chain in float32, and the products sum in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpd_tpu.data import augment as jaug
from vpd_tpu_torch.data import augment as taug

torch.set_num_threads(2)

B, S = 4, 16
MEAN, STD = taug.RGB_MEAN_STD['fs']
F32_ATOL = 1e-5
BF16_STEPS, BF16_SHARE = 2, 0.999
DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def to_torch(x):
    """JAX/numpy array -> torch tensor of the same dtype (bf16 via f32,
    which is exact)."""
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def jax_jitter_draws(key, b, per_sample=False):
    """What `jaug.batch_color_jitter(x, key)` draws, in the port's layout
    (`taug.sample_color_jitter`)."""
    kb, kc, ks, kh, ko = jax.random.split(key, 5)
    d = {name: jax.random.uniform(k, (b,), minval=1 - a, maxval=1 + a)
         for name, k, a in (('fb', kb, 0.2), ('fc', kc, 0.2),
                            ('fs', ks, 0.05))}
    d['fh'] = jax.random.uniform(kh, (b,), minval=-0.05, maxval=0.05)
    if per_sample:
        d['perms'] = jax.vmap(lambda k: jax.random.permutation(k, 4))(
            jax.random.split(ko, b))
    else:
        d['order'] = int(jax.random.randint(ko, (), 0, 24))
    return {k: v if isinstance(v, int) else to_torch(v)
            for k, v in d.items()}


def jax_draws(key, b, h, w, dtype=jnp.float32, per_sample=False):
    """What `jaug.train_augment_batch(key, ...)` draws when it is given
    the flips, in the port's layout (`taug.sample_train_augment`)."""
    d = jax_jitter_draws(jax.random.fold_in(key, 2), b, per_sample)

    def one(k):
        _, kn, kcrop, kp = jax.random.split(k, 4)
        k1, k2, k3, k4 = jax.random.split(kcrop, 4)
        area = h * w * jax.random.uniform(k1, (), minval=0.5, maxval=1.0)
        log_ratio = jax.random.uniform(k2, (), minval=jnp.log(0.9),
                                       maxval=jnp.log(1.1))
        aspect = jnp.exp(log_ratio)
        crop_w = jnp.clip(jnp.sqrt(area * aspect), 1., w)
        crop_h = jnp.clip(jnp.sqrt(area / aspect), 1., h)
        top = jax.random.uniform(k3, ()) * (h - crop_h)
        left = jax.random.uniform(k4, ()) * (w - crop_w)
        noise = jax.random.normal(kn, (h, w, 3), dtype)
        apply = jax.random.uniform(kp, ()) <= 0.5
        return top, left, crop_h, crop_w, noise, apply

    names = ('top', 'left', 'crop_h', 'crop_w', 'noise', 'apply_noise')
    per = jax.vmap(one)(jax.random.split(key, b))
    d.update({n: to_torch(v) for n, v in zip(names, per)})
    return d


def bf16_steps(a, b):
    """Distance in bf16 steps between two bf16 tensors (ordered bits)."""
    def ordered(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7fff), bits)
    return (ordered(a) - ordered(b)).abs()


def assert_close(ours, ref, dtype):
    """f32: max abs <= F32_ATOL; bf16: within BF16_STEPS steps on a
    BF16_SHARE of the elements."""
    ref = to_torch(ref)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    if dtype == torch.float32:
        err = (ours - ref).abs().max().item()
        assert err <= F32_ATOL, err
    else:
        steps = bf16_steps(ours, ref)
        share = (steps <= BF16_STEPS).float().mean().item()
        assert share >= BF16_SHARE, (share, steps.max().item())


def inputs(seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    flow = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    mask = ((rng.random((b, s, s)) > 0.5) * 255).astype(np.uint8)
    flip = rng.random(b) < 0.5
    flip[:2] = [False, True]
    return rgb, flow, mask, flip


def rgb01(seed, dtype):
    """The same [0, 1] batch in both packages, divided in `dtype`."""
    rgb = inputs(seed)[0]
    return (jnp.asarray(rgb).astype(DTYPES[dtype][0]) / 255.,
            torch.from_numpy(rgb).to(DTYPES[dtype][1]) / 255.)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('op', [0, 1, 2, 3],
                         ids=['brightness', 'contrast', 'saturation', 'hue'])
def test_jitter_op_matches_vpd_tpu(op, dtype):
    key = jax.random.key(op)
    x_j, x_t = rgb01(op, dtype)
    ref = jaug.batch_color_jitter(x_j, key, order=(op,))
    ours = taug.batch_color_jitter(x_t, jax_jitter_draws(key, B),
                                   order=(op,))
    assert_close(ours, ref, DTYPES[dtype][1])


@pytest.mark.parametrize('index', range(24))
def test_jitter_order_matches_vpd_tpu(index):
    """Each of the 24 orders, forced in vpd_tpu and picked by index in
    the port (so JITTER_ORDERS is vpd_tpu's list, in its order)."""
    key = jax.random.key(100 + index)
    x_j, x_t = rgb01(index, 'f32')
    ref = jaug.batch_color_jitter(x_j, key, order=jaug._JITTER_ORDERS[index])
    draws = dict(jax_jitter_draws(key, B), order=index)
    assert taug.JITTER_ORDERS == jaug._JITTER_ORDERS
    assert_close(taug.batch_color_jitter(x_t, draws), ref, torch.float32)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('per_sample', [False, True],
                         ids=['batch_order', 'per_sample_order'])
def test_sampled_jitter_matches_vpd_tpu(per_sample, dtype):
    """The order vpd_tpu samples itself: one for the batch, or one per
    sample (12 samples, so that the orders differ)."""
    key = jax.random.key(7)
    rgb = np.random.default_rng(3).integers(0, 256, (12, S, S, 3), np.uint8)
    x_j = jnp.asarray(rgb).astype(DTYPES[dtype][0]) / 255.
    x_t = torch.from_numpy(rgb).to(DTYPES[dtype][1]) / 255.
    ref = jaug.batch_color_jitter(x_j, key, per_sample_order=per_sample)
    draws = jax_jitter_draws(key, 12, per_sample)
    if per_sample:
        assert len({tuple(p) for p in draws['perms'].tolist()}) > 1
    assert_close(taug.batch_color_jitter(x_t, draws), ref,
                 DTYPES[dtype][1])


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('out', [S, 12])
def test_bilinear_resample_matches_vpd_tpu(out, dtype):
    rng = np.random.default_rng(4)
    img = rng.normal(0, 1, (B, S, S + 4, 5)).astype(np.float32)
    # the clamps: a full frame, a crop on the far border, small boxes
    top = np.array([0., 6.5, 0.2, 15.], np.float32)
    left = np.array([0., 10.25, 19., 3.], np.float32)
    ch = np.array([S, 9.5, 1., 1.], np.float32)
    cw = np.array([S + 4, 9.75, 1.5, 20.], np.float32)
    img_j = jnp.asarray(img).astype(DTYPES[dtype][0])
    ref = jax.vmap(jaug.bilinear_resample, (0, 0, 0, 0, 0, None, None))(
        img_j, top, left, ch, cw, out, out)
    ours = taug.bilinear_resample(
        to_torch(img_j), *map(torch.from_numpy, (top, left, ch, cw)), out,
        out)
    assert_close(ours, ref, DTYPES[dtype][1])


# (flow, mask, jitter, per-sample order): the whole chain, and with
# jitter off the mask noise alone and the flip alone (with the crop)
CHAINS = {'whole': (True, True, True, False),
          'whole_per_sample': (True, True, True, True),
          'rgb_only': (False, False, True, False),
          'mask_noise': (False, True, False, False),
          'flip_flow': (True, False, False, False)}


def jax_chain(chain, dtype, rgb, flow, mask, flip, key, out):
    use_flow, use_mask, jitter, per_sample = CHAINS[chain]
    # device arrays, as in vpd_tpu's step (numpy uint8 / 255. would
    # promote its bf16 chain to float32)
    return jaug.train_augment_batch(
        key, jnp.asarray(rgb), MEAN, STD,
        flow_u8=jnp.asarray(flow) if use_flow else None,
        mask_u8=jnp.asarray(mask) if use_mask else None, flip=flip,
        out_size=out, jitter=jitter, dtype=dtype,
        jitter_order='per_sample' if per_sample else 'batch')


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('chain', sorted(CHAINS))
def test_train_augment_batch_matches_vpd_tpu(chain, dtype):
    """The whole chain. In bf16 the reference runs op by op (XLA off), so
    that each op rounds to bf16 as in the port: compiled, XLA keeps the
    intermediates of its fused jitter branch in float32. Against that
    compiled run the port's bf16 error from the float32 chain (mean abs)
    may be at most 1.25 times vpd_tpu's own."""
    use_flow, use_mask, jitter, per_sample = CHAINS[chain]
    jdt, tdt = DTYPES[dtype]
    rgb, flow, mask, flip = inputs(11)
    key = jax.random.key(21)
    out = 12
    if dtype == 'bf16':
        with jax.disable_jit():
            ref, ref_flip = jax_chain(chain, jdt, rgb, flow, mask, flip,
                                      key, out)
    else:
        ref, ref_flip = jax_chain(chain, jdt, rgb, flow, mask, flip, key,
                                  out)
    draws = jax_draws(key, B, S, S, jdt, per_sample)
    draws['flip'] = torch.from_numpy(flip)
    ours = taug.train_augment_batch(
        torch.from_numpy(rgb), draws, MEAN, STD,
        flow_u8=torch.from_numpy(flow) if use_flow else None,
        mask_u8=torch.from_numpy(mask) if use_mask else None,
        out_size=out, jitter=jitter, dtype=tdt)
    assert ours.shape == (B, out, out, 5 if use_flow else 3)
    np.testing.assert_array_equal(np.asarray(ref_flip), flip)
    assert_close(ours, ref, tdt)
    if dtype == 'bf16':
        f32 = to_torch(jax_chain(chain, jnp.float32, rgb, flow, mask, flip,
                                 key, out)[0])
        compiled = to_torch(jax_chain(chain, jdt, rgb, flow, mask, flip,
                                      key, out)[0])
        jax_err = (compiled.float() - f32).abs().mean().item()
        port_err = (ours.float() - f32).abs().mean().item()
        assert port_err <= 1.25 * jax_err, (port_err, jax_err)


def test_flip_negates_x_flow_of_flipped_samples_only():
    x = torch.randn(3, 4, 6, 5)
    flip = torch.tensor([True, False, True])
    y = taug.flip_samples(x, flip, has_flow=True)
    assert torch.equal(y[1], x[1])
    for i in (0, 2):
        assert torch.equal(y[i, ..., [0, 1, 2, 4]],
                           x[i].flip(1)[..., [0, 1, 2, 4]])
        assert torch.equal(y[i, ..., 3], -x[i].flip(1)[..., 3])


def test_mask_noise_on_person_pixels_of_chosen_samples():
    x = torch.zeros(2, 4, 4, 3)
    mask = torch.zeros(2, 4, 4, dtype=torch.uint8)
    mask[:, :2] = 255
    noise = torch.ones(2, 4, 4, 3)
    y = taug.add_mask_noise(x, mask, noise, torch.tensor([True, False]))
    assert torch.allclose(y[0, :2], torch.full((2, 4, 3),
                                               taug.RANDOM_NOISE_SD))
    assert (y[0, 2:] == 0).all() and (y[1] == 0).all()


def test_sampler_draws_on_the_generators_device_and_is_seeded():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        host = torch.Generator().manual_seed(seed)
        return taug.sample_train_augment(gen, host, 5, 20, 24, flip=True,
                                         noise_dtype=torch.bfloat16)

    a, b, c = draw(0), draw(0), draw(1)
    assert set(a) == {'fb', 'fc', 'fs', 'fh', 'order', 'noise',
                      'apply_noise', 'top', 'left', 'crop_h', 'crop_w',
                      'flip'}
    assert all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
               else a[k] == b[k] for k in a)
    assert not torch.equal(a['fb'], c['fb'])
    assert a['noise'].shape == (5, 20, 24, 3)
    assert a['noise'].dtype == torch.bfloat16
    assert 0 <= a['order'] < 24
    assert ((a['crop_h'] >= 1) & (a['crop_h'] <= 20)).all()
    assert ((a['top'] >= 0) & (a['top'] + a['crop_h'] <= 20 + 1e-4)).all()
    assert ((a['fb'] >= 0.8) & (a['fb'] <= 1.2)).all()
    per = taug.sample_color_jitter(torch.Generator().manual_seed(0),
                                   torch.Generator(), 6,
                                   per_sample_order=True)
    assert sorted(per['perms'][0].tolist()) == [0, 1, 2, 3]
