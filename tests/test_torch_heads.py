"""The port's recognition heads against vpd_tpu's, on the CPU.

Weights go across with `models/flax_weights` (`load_seq_head_from_flax` /
`seq_head_to_flax`); inputs are made with numpy from seeds.

- `BiRNN` (gru, lstm; depth 2; ragged lengths incl. 1 and the bucket):
  outputs and `last_state` within 1e-5 in float32, also with two members
  stacked on the member axis.
- `SeqClassifier` (gru / lstm x attention / max x input batch norm) and
  `CNNClassifier` (depth 1, 2): eval logits, and train-mode logits on
  flax's own dropout masks (read from its Dropout outputs and fed to the
  port) with a partial batch, and the updated batch statistics, within
  1e-5.
- `MaskedBatchNorm` / `TorchBatchNorm` with padded rows and with n <= 1.
- `SeqModelTrainer` in float64 against vpd_tpu's under `jax.enable_x64`
  (three epochs, partial batches, a validation set, the cyclic schedule,
  dropout 0): logged losses to rel 1e-9, parameters and batch statistics
  to 1e-7 of how far they moved. vpd_tpu keeps flax Dense/Conv kernels
  in float32 and pads inputs in float32 even under x64, so its trainer
  is fed float64 weights and inputs (its `make_model` and
  `pad_sequences` wrapped here; vpd_tpu itself is unchanged).
- Heads saved by either package load in the other and predict the same
  classes; the files are byte-equal where both save the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from vpd_tpu.core import schedule as jsched
from vpd_tpu.models import gru as jg
from vpd_tpu.train import classifier as jc
from vpd_tpu_torch.core import schedule as tsched
from vpd_tpu_torch.models import gru as tg
from vpd_tpu_torch.models.fc import set_dropout_draw
from vpd_tpu_torch.models.flax_weights import (load_seq_head_from_flax,
                                               seq_head_to_flax)
from vpd_tpu_torch.train import classifier as tc

torch.set_num_threads(2)

D, H, C = 4, 8, 3
FWD_TOL = 1e-5
LOSS_RTOL = 1e-9
PARAM_TOL = 1e-7


def ragged(rng, lengths, t=16, d=D):
    x = rng.normal(size=(len(lengths), t, d)).astype(np.float32)
    x *= (np.arange(t)[None, :, None] < np.asarray(lengths)[:, None, None])
    return x, np.asarray(lengths, np.int32)


def perturbed(tree, rng, scale=0.1):
    """A copy of a flax tree with noise added (init's zeros and ones would
    hide a mapping error); variances stay positive."""
    def f(path, a):
        a = np.asarray(a)
        out = a + rng.normal(0, scale, a.shape).astype(a.dtype)
        return np.abs(out) + 0.5 if path[-1].key == 'var' else out
    return jax.tree_util.tree_map_with_path(f, tree)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def to_t(*arrays):
    """numpy -> torch with a member axis of 1."""
    return [torch.from_numpy(np.asarray(a))[None] for a in arrays]


def assert_trees_close(got, want, rtol=FWD_TOL, atol=FWD_TOL):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg='/'.join(k))


def jax_variables(module, x, lengths, rng):
    v = module.init({'params': jax.random.key(1)}, jnp.asarray(x),
                    jnp.asarray(lengths))
    return perturbed({'params': v['params'],
                      'batch_stats': v.get('batch_stats', {})}, rng)


def port_head(cell, **kw):
    if cell == 'cnn':
        return tg.CNNClassifier(D, H, C, **kw)
    return tg.SeqClassifier(cell, D, H, C, **kw)


def jax_head(cell, **kw):
    if cell == 'cnn':
        return jg.CNNClassifier(H, C, **kw)
    return jg.SeqClassifier(cell, H, C, **kw)


# ------------------------------------------------------------------ BiRNN

@pytest.mark.parametrize('cell', ['gru', 'lstm'])
def test_birnn_matches_vpd_tpu(cell):
    """Two members, each with its own weights and inputs."""
    rng = np.random.default_rng(0)
    jm = jg.SeqClassifier(cell, H, C)
    model = tg.SeqClassifier(cell, D, H, C, num_members=2)
    xs, ls, want = [], [], []
    for m, lengths in enumerate(([1, 16, 7, 3, 12, 2], [16, 2, 1, 9, 5, 16])):
        x, lengths = ragged(rng, lengths)
        v = jax_variables(jm, x, lengths, rng)
        load_seq_head_from_flax(model, v, member=m)
        want.append(jg.BiRNN(cell, H, 2).apply(
            {'params': v['params']['BiRNN_0']}, x, lengths))
        xs.append(x)
        ls.append(lengths)
    with torch.no_grad():
        out, last = model.rnn(torch.from_numpy(np.stack(xs)),
                              torch.from_numpy(np.stack(ls)))
    assert out.shape == (2, 6, 16, 2 * H) and last.shape == (2, 4, 6, H)
    for m, (o, s) in enumerate(want):
        np.testing.assert_allclose(out[m].numpy(), np.asarray(o),
                                   atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(last[m].numpy(), np.asarray(s),
                                   atol=FWD_TOL, rtol=FWD_TOL)
    # padding is zeroed after the last layer
    assert not out[0, 0, 1:].any()


# ------------------------------------------------------------------ heads

def _dropout_masks(intermediates, n):
    """flax's keep masks in call order (Dropout_0, 1, 2): nonzero outputs.
    An input that is exactly 0 (padding) hides its mask, which is
    harmless: the port's output is 0 there whatever the mask."""
    return [np.asarray(intermediates['Dropout_{}'.format(i)]['__call__'][0])
            != 0 for i in range(n)]


def _feed(model, masks):
    fed = iter(masks)

    def draw(shape, keep, device):
        mask = torch.from_numpy(next(fed))[None]
        assert tuple(mask.shape) == tuple(shape)
        return mask
    set_dropout_draw(model, draw)


HEADS = [('gru', dict(use_attention=True, input_batchnorm=False)),
         ('gru', dict(use_attention=False, input_batchnorm=True)),
         ('lstm', dict(use_attention=True, input_batchnorm=True)),
         ('lstm', dict(use_attention=False, input_batchnorm=False)),
         ('gru', dict(use_attention=True, input_batchnorm=True)),
         ('lstm', dict(use_attention=False, input_batchnorm=True)),
         ('cnn', dict(depth=1)), ('cnn', dict(depth=2))]


@pytest.mark.parametrize('cell,kw', HEADS)
def test_head_matches_vpd_tpu_in_eval_and_train(cell, kw):
    rng = np.random.default_rng(len(kw) + len(cell))
    x, lengths = ragged(rng, [5, 16, 1, 9, 12, 3])
    valid = np.array([1, 1, 1, 1, 0, 0], bool)   # a padded partial batch
    jm = jax_head(cell, **kw)
    v = jax_variables(jm, x, lengths, rng)
    model = port_head(cell, **kw)
    load_seq_head_from_flax(model, v)
    assert_trees_close(seq_head_to_flax(model), v, rtol=0, atol=0)

    want = jm.apply(v, x, lengths)
    with torch.no_grad():
        got = model.eval()(*to_t(x, lengths))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)

    out, mut = jm.apply(
        v, x, lengths, train=True, valid=valid,
        rngs={'dropout': jax.random.key(3)},
        mutable=['batch_stats', 'intermediates'],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    masks = _dropout_masks(mut['intermediates'], 3)
    assert 0.3 < np.mean([m.mean() for m in masks[1:]]) < 0.7
    _feed(model, masks)
    with torch.no_grad():
        got = model.train()(*to_t(x, lengths, valid))[0]
    set_dropout_draw(model, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=FWD_TOL,
                               atol=FWD_TOL)
    if cell != 'cnn':
        assert_trees_close(seq_head_to_flax(model)['batch_stats'],
                           mut['batch_stats'])


# ------------------------------------------------------------ batch norms

@pytest.mark.parametrize('lengths,valid', [
    ([5, 16, 1, 9], [1, 1, 1, 0]),      # padded steps and a padded row
    ([1, 4, 2, 3], [1, 0, 0, 0]),       # n = 1: running statistics only
    ([3, 2, 1, 1], [0, 0, 0, 0])])      # n = 0
def test_masked_batchnorm_matches_vpd_tpu(lengths, valid):
    rng = np.random.default_rng(sum(lengths))
    x, lengths = ragged(rng, lengths)
    valid = np.asarray(valid, bool)
    jm = jg.MaskedBatchNorm()
    v = perturbed(jm.init(jax.random.key(0), x, lengths), rng)
    want, mut = jm.apply(v, x, lengths, train=True, valid=valid,
                         mutable=['batch_stats'])
    bn = tg.MaskedBatchNorm(1, D)
    _load_bn(bn, v)
    got = bn.train()(*to_t(x, lengths, valid))[0].detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    _check_stats(bn, mut['batch_stats'])


@pytest.mark.parametrize('valid', [[1, 1, 0, 1, 0], [0, 1, 0, 0, 0], None])
def test_torch_batchnorm_matches_vpd_tpu(valid):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 2 * H)).astype(np.float32)
    valid = None if valid is None else np.asarray(valid, bool)
    jm = jg.TorchBatchNorm()
    v = perturbed(jm.init(jax.random.key(0), x), rng)
    want, mut = jm.apply(v, x, train=True, valid=valid,
                         mutable=['batch_stats'])
    bn = tg.TorchBatchNorm(1, 2 * H)
    _load_bn(bn, v)
    args = to_t(x) + ([] if valid is None else to_t(valid))
    got = bn.train()(*args)[0].detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    _check_stats(bn, mut['batch_stats'])
    # eval mode normalizes with the running statistics
    np.testing.assert_allclose(
        bn.eval()(*to_t(x))[0].detach().numpy(),
        np.asarray(jm.apply({'params': v['params'],
                             'batch_stats': mut['batch_stats']}, x)),
        rtol=FWD_TOL, atol=FWD_TOL)


def _load_bn(bn, v):
    with torch.no_grad():
        bn.weight[0] = torch.from_numpy(np.asarray(v['params']['scale']))
        bn.bias[0] = torch.from_numpy(np.asarray(v['params']['bias']))
        bn.running_mean[0] = torch.from_numpy(
            np.asarray(v['batch_stats']['mean']))
        bn.running_var[0] = torch.from_numpy(
            np.asarray(v['batch_stats']['var']))


def _check_stats(bn, stats):
    np.testing.assert_allclose(bn.running_mean[0].numpy(),
                               np.asarray(stats['mean']), rtol=FWD_TOL,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var[0].numpy(),
                               np.asarray(stats['var']), rtol=FWD_TOL,
                               atol=1e-6)


# -------------------------------------------------------------- training

def pool(n=6, classes=C, seed=0, lo=3, hi=14):
    """Sequences around one prototype per class."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (classes, D))
    X, y = [], []
    for c in range(classes):
        for _ in range(n):
            t = int(rng.integers(lo, hi + 1))
            X.append((protos[c] + rng.normal(0, .4, (t, D))).astype(
                np.float32))
            y.append(c)
    return X, np.array(y)


class _F64Init:
    """Wraps vpd_tpu's `make_model`: the module's `init` returns float64
    variables (flax keeps Dense/Conv kernels in float32 otherwise), and
    they are kept in `self.variables` for the port."""

    def __init__(self, make_model):
        self.make_model = make_model
        self.variables = None

    def __call__(self, *args, **kwargs):
        base = self.make_model(*args, **kwargs)
        owner = self

        class F64(type(base)):
            def init(self, *a, **k):
                v = super().init(*a, **k)
                v = jax.tree_util.tree_map(
                    lambda z: jnp.asarray(z, jnp.float64), v)
                owner.variables = jax.tree_util.tree_map(np.asarray, v)
                return v

        fields = {f: getattr(base, f) for f in base.__dataclass_fields__
                  if f not in ('parent', 'name')}
        return F64(**fields)


def port_from(variables, make_model):
    """Wraps the port's `make_model`: start from `variables` in float64."""
    def make(*args, **kwargs):
        model = make_model(*args, **kwargs).double()
        return load_seq_head_from_flax(model, variables)
    return make


TRAJ = [('gru', dict(use_attention=True, input_batchnorm=True)),
        ('lstm', dict(use_attention=False, input_batchnorm=False)),
        ('cnn', dict(depth=2))]


@pytest.mark.parametrize('cell,kw', TRAJ)
def test_f64_trainer_trajectory_matches_vpd_tpu(cell, kw, monkeypatch):
    X, y = pool()
    Xv, yv = pool(2, seed=1)
    common = dict(hidden_dim=H, batch_size=4, num_epochs=3, min_epochs=0,
                  wr_count=2, val_freq=1, learning_rate=0.01, dropout=0.,
                  input_dropout=0., **kw)
    jmake = _F64Init(jc.make_model)
    monkeypatch.setattr(jc, 'make_model', jmake)
    pad = jc.pad_sequences
    monkeypatch.setattr(jc, 'pad_sequences', lambda X, max_len=None: (
        lambda a: (a[0].astype(np.float64), a[1]))(pad(X, max_len)))
    # the epoch metrics as they are, not cast to float32 for the log
    import vpd_tpu.core.metrics as jmetrics
    monkeypatch.setattr(jmetrics, 'fetch_metrics', lambda t: (
        jax.tree_util.tree_map(np.asarray, t)))
    jlog, tlog = [], []
    with jax.enable_x64():
        jt = jc.SeqModelTrainer(cell, X, y, X_val=Xv, y_val=yv,
                                log=lambda *a: jlog.append(a[1:]), **common)
        want = {'params': jax.tree_util.tree_map(np.asarray, jt.params),
                'batch_stats': jax.tree_util.tree_map(np.asarray,
                                                      jt.batch_stats)}
    init = jmake.variables
    monkeypatch.setattr(tc, 'make_model', port_from(init, tc.make_model))
    tt = tc.SeqModelTrainer(cell, X, y, X_val=Xv, y_val=yv, device='cpu',
                            dtype=torch.float64,
                            log=lambda *a: tlog.append(a[1:]), **common)
    assert len(tlog) == len(jlog) == 3
    np.testing.assert_allclose(np.array(tlog), np.array(jlog),
                               rtol=LOSS_RTOL)
    got, want, init = flat(tt.variables()), flat(want), flat(init)
    assert sorted(got) == sorted(want)
    for k in want:
        moved = np.linalg.norm(want[k] - init[k])
        assert np.linalg.norm(got[k] - want[k]) <= PARAM_TOL * moved + 1e-12,\
            k
    # the best (validation) epoch's state: predictions agree
    probs = tt.predict_probs(Xv)
    with jax.enable_x64():
        want_p = np.stack([jt.predict(x, full=True) for x in Xv])
    np.testing.assert_allclose(probs, want_p, rtol=1e-9, atol=1e-12)


def test_trainer_raises_on_labels_out_of_range():
    X, y = pool(2)
    with pytest.raises(ValueError, match='out of range'):
        tc.SeqModelTrainer('gru', X, y + 1, hidden_dim=H, num_epochs=1,
                           device='cpu')


def test_schedule_is_vpd_tpus():
    a = jsched.CyclicCosineRestarts(1e-3, 0.01, 4, 18, restart_period=2)
    b = tsched.CyclicCosineRestarts(1e-3, 0.01, 4, 18, restart_period=2)
    for epoch in range(7):
        a.epoch_start()
        b.epoch_start()
        for _ in range(5):
            assert (a.lr, a.weight_decay) == (b.lr, b.weight_decay)
            a.batch_step()
            b.batch_step()


# ---------------------------------------------------------- head files

@pytest.mark.parametrize('cell,kw', [
    ('gru', dict(use_attention=True)), ('cnn', dict())])
def test_head_files_load_across_packages(cell, kw, tmp_path):
    X, y = pool(seed=3)
    Xq, _ = pool(2, seed=4)
    common = dict(hidden_dim=H, batch_size=4, num_epochs=2, min_epochs=0,
                  **kw)
    # vpd_tpu's head in the port
    jt = jc.SeqModelTrainer(cell, X, y, **common)
    jpath = str(tmp_path / 'jax.ckpt')
    jt.save(jpath)
    tt = tc.SeqModelTrainer(cell, X, y, load_weights=jpath, device='cpu',
                            **common)
    want = [jt.predict(x)[0] for x in Xq]
    assert [int(np.argmax(p)) for p in tt.predict_probs(Xq)] == want
    np.testing.assert_allclose(
        tt.predict_probs(Xq), [jt.predict(x, full=True) for x in Xq],
        rtol=1e-5, atol=1e-6)
    # the same weights, saved by the port: byte-equal
    tpath = str(tmp_path / 'port.ckpt')
    tt.save(tpath)
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        assert a.read() == b.read()

    # the port's trained head in vpd_tpu
    tt2 = tc.SeqModelTrainer(cell, X, y, device='cpu', seed=5, **common)
    tt2.save(tpath)
    jt2 = jc.SeqModelTrainer(cell, X, y, load_weights=tpath, **common)
    assert [jt2.predict(x)[0] for x in Xq] == [
        int(np.argmax(p)) for p in tt2.predict_probs(Xq)]
    jt2.save(jpath)
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        assert a.read() == b.read()


def test_seq_model_scores_flip_variants_as_an_ensemble():
    """`SeqModel` (tasks/recognize.py): flip columns are variants whose
    probabilities are averaged, only the first without `ensemble`, and an
    action without embeddings gets the most common class."""
    from vpd_tpu_torch.tasks.recognize import SeqModel

    rng = np.random.default_rng(9)
    X, y = pool(n=4, seed=9)
    embs = {'a{}'.format(i): np.stack([x, x + rng.normal(0, .1, x.shape)],
                                      1).astype(np.float32)
            for i, x in enumerate(X)}
    labels = {'a{}'.format(i): int(c) + 10 for i, c in enumerate(y)}
    model = SeqModel('gru', embs, labels, H, num_epochs=2, min_epochs=0,
                     batch_size=4, device='cpu')
    assert model.classes == [10, 11, 12] and model.top_class == 10
    test = dict(list(embs.items())[:5], none=None)
    got = model.predict_actions(test)
    assert got['none'] == (10, None)
    for action, x in list(test.items())[:5]:
        probs = model.model.predict_probs([x[:, 0], x[:, 1]])
        assert got[action] == (model.classes[int(np.argmax(
            probs.mean(0)))], None) == model.predict(x)
        first = model.model.predict_probs([x[:, 0]])[0]
        assert model.predict(x, ensemble=False)[0] == \
            model.classes[int(np.argmax(first))]
