"""The port's torch import/export tools against vpd_tpu's on the CPU.

Reference-layout torch models are built in the test from random init
(torchvision-style ResNets and the FCResNet from tests/test_torch_compat.py,
the reference FCNet / FCPoseDecoder below), with random BN statistics, and
saved as the reference saves a model dir (`config.json` + `{name}.
{component}.pt`).

- Import: the port's `import_torch_model` writes the `.ckpt` files (and
  config.json / loss.json) of vpd_tpu's `import_torch_model.main`, byte
  for byte, and prints the same lines: resnet18 and resnet50 students
  with a motion `decoder.pt`; a VIPE* FCResNet with `decoder-3d.pt` and a
  torch AdamW `optimizer.pt` whose state misses one parameter (it never
  had a gradient); a non-AdamW `optimizer.pt` (skipped).
- Export: the port's `export_torch_model` writes `.pt` files whose
  tensors (names, dtypes, values; a state_dict in torch's registration
  order, where vpd_tpu's ResNet export lists a block's convs first) and
  optimizer param_groups are exactly vpd_tpu's.
- Round trips: export then import gives the source `.ckpt` bytes.
- Resume: `train_vipe --resume` (the trainers' `resume`) from the imported
  dir takes the same first step in float64 (dropout 0) in both packages:
  loss to rel 1e-9, parameters to 1e-7 of how far they moved.
- Refusals: an effnet student, a config of neither schema and an
  optimizer of the wrong size give vpd_tpu's SystemExit text.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from test_torch_compat import (TorchBasicBlock, TorchBottleneck,
                               TorchFCResNet, TorchResNet,
                               _randomize_bn_stats)
from test_torch_vipe import (DEC, EMB, HID, IN_DIM, PARAM_TOL, _feeds_bn,
                             jax_model, make_batcher, to_torch)
from vpd_tpu.core import checkpoint as jckpt
from vpd_tpu.tools import export_torch_model as jexport
from vpd_tpu.tools import import_torch_model as jimport
from vpd_tpu.train import vipe as jvipe
from vpd_tpu.train import vipe_loop as jloop
from vpd_tpu_torch.models.fc import FlaxDropout
from vpd_tpu_torch.tools import export_torch_model as texport
from vpd_tpu_torch.tools import import_torch_model as timport
from vpd_tpu_torch.train import vipe as tvipe
from vpd_tpu_torch.train import vipe_loop as tloop
from vpd_tpu_torch.train.vpd_loop import default_config as vpd_config

torch.set_num_threads(2)

LOSS_RTOL = 1e-9


class TorchFCNet(tnn.Module):
    """Reference models/module.py:133-153 (batch_norm off)."""

    def __init__(self, input_dim, hidden_dims, output_dim, dropout=0.3):
        super().__init__()
        layers = [tnn.Linear(input_dim, hidden_dims[0])]
        for i in range(len(hidden_dims)):
            layers.append(tnn.ReLU())
            layers.append(tnn.Linear(hidden_dims[i], hidden_dims[i + 1]
                                     if i + 1 < len(hidden_dims)
                                     else output_dim))
            if i + 1 < len(hidden_dims):
                layers.append(tnn.Dropout(dropout))
        self.layers = tnn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class TorchFCPoseDecoder(tnn.Module):
    """Reference models/module.py:211-227: an FCNet trunk, then one linear
    head a 3D dataset."""

    def __init__(self, emb_dim, hidden_dims, targets):
        super().__init__()
        self.fcn = TorchFCNet(emb_dim, hidden_dims[:-1], hidden_dims[-1])
        self.targets = targets
        for name, dim in targets:
            setattr(self, 'fc_' + name, tnn.Linear(hidden_dims[-1], dim))

    def forward(self, x, name):
        return getattr(self, 'fc_' + name)(torch.relu(self.fcn(x)))


def _save(sd, path):
    torch.save({k: v.detach().clone() for k, v in sd.items()}, path)


def _vpd_dir(root, arch, seed):
    """A reference VPD student dir: best_epoch's encoder (under 'resnet.')
    and motion decoder. (One checkpoint: each file either package writes
    is fsynced, and a ResNet-50 is 94 MB.)"""
    block, layers, flow = {
        'resnet18': (TorchBasicBlock, (2, 2, 2, 2), True),
        'resnet50': (TorchBottleneck, (3, 4, 6, 3), False)}[arch]
    cfg = vpd_config('fs', EMB, img_dim=32, use_flow=flow, motion=True,
                     encoder_arch=arch)
    os.makedirs(root)
    with open(os.path.join(root, 'config.json'), 'w') as fp:
        json.dump(cfg, fp)
    with open(os.path.join(root, 'loss.json'), 'w') as fp:
        json.dump([{'epoch': 1, 'train': 1.5, 'val': 2.5}], fp)
    torch.manual_seed(seed)
    enc = TorchResNet(block, layers, 5 if flow else 3, EMB)
    with torch.no_grad():
        _randomize_bn_stats(enc, seed)
    _save({'resnet.' + k: v for k, v in enc.state_dict().items()},
          os.path.join(root, 'best_epoch.encoder.pt'))
    _save(TorchFCNet(EMB, [128, 128], 2 * EMB, dropout=0.).state_dict(),
          os.path.join(root, 'best_epoch.decoder.pt'))
    return root


def vipe_reference(kp_dims):
    """The reference VIPE* modules for test_torch_vipe's batcher, and the
    config.json of such a run."""
    names = ['human36m', 'amass', '3dpeople']
    cfg = tloop.default_config(
        names, [(d,) if d else None for d in kp_dims],
        [np.ones(3) if d else None for d in kp_dims], embedding_dim=EMB,
        encoder_arch=(2, HID), decoder_arch=(2, DEC))
    enc = TorchFCResNet(IN_DIM, EMB, 2, HID)
    dec = TorchFCPoseDecoder(EMB, [DEC, DEC],
                             [(n, d) for n, d in zip(names, kp_dims) if d])
    return cfg, enc, dec


def _vipe_dir(root, optimizer='adamw'):
    """A reference VIPE* dir: best_epoch (encoder only) and epoch0003
    (encoder, decoder-3d and an optimizer after two steps in which the
    amass head had no gradient)."""
    batcher = make_batcher(8)
    cfg, enc, dec = vipe_reference(batcher.kp_dims)
    torch.manual_seed(1)
    with torch.no_grad():
        _randomize_bn_stats(enc, 1)
    params = list(enc.parameters()) + list(dec.parameters())
    opt = (torch.optim.AdamW(params, lr=cfg['learning_rate'])
           if optimizer == 'adamw' else
           torch.optim.SGD(params, lr=0.1, momentum=0.9))
    for _ in range(2):
        batch = batcher.next_batch()
        x = torch.from_numpy(batch['pose1'].reshape(8, -1))
        opt.zero_grad()
        (enc(x).square().sum() + dec(enc(x), 'human36m').square().sum()
         ).backward()
        opt.step()
    os.makedirs(root)
    with open(os.path.join(root, 'config.json'), 'w') as fp:
        json.dump(cfg, fp)
    _save(enc.state_dict(), os.path.join(root, 'best_epoch.encoder.pt'))
    _save(enc.state_dict(), os.path.join(root, 'epoch0003.encoder.pt'))
    _save(dec.state_dict(), os.path.join(root, 'epoch0003.decoder-3d.pt'))
    torch.save(opt.state_dict(), os.path.join(root,
                                              'epoch0003.optimizer.pt'))
    return root, batcher, cfg


def _files_equal(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), 'rb') as x, \
                open(os.path.join(b, f), 'rb') as y:
            assert x.read() == y.read(), f


def _import_both(src, root, capsys):
    jdir, tdir = os.path.join(root, 'jax'), os.path.join(root, 'port')
    jimport.main(src, jdir)
    jout = capsys.readouterr().out
    timport.main(src, tdir)
    assert capsys.readouterr().out == jout.replace(jdir, tdir)
    _files_equal(jdir, tdir)
    return jdir, tdir, jout


@pytest.mark.parametrize('arch', ['resnet18', 'resnet50'])
def test_student_import_is_vpd_tpu_bytes(arch, tmp_path, capsys):
    src = _vpd_dir(str(tmp_path / 'ref'), arch, seed=3)
    _, _, out = _import_both(src, tmp_path, capsys)
    assert 'converted best_epoch (vpd encoder+decoder)' in out


@pytest.mark.parametrize('optimizer', ['adamw', 'sgd'])
def test_teacher_import_is_vpd_tpu_bytes(optimizer, tmp_path, capsys):
    src, _, _ = _vipe_dir(str(tmp_path / 'ref'), optimizer)
    jdir, _, out = _import_both(src, tmp_path, capsys)
    assert 'converted best_epoch (vipe encoder)' in out
    if optimizer == 'adamw':
        assert 'converted epoch0003 (vipe encoder+decoder-3d+optimizer)' \
            in out
        opt = jckpt.load_component(jdir, 'epoch0003', 'optimizer', None)
        assert int(opt['0']['count']) == 2
        # the amass head had no gradient: zero moments in its columns
        assert not np.asarray(opt['0']['mu']['decoder']['_MultiHead_0'][
            'kernel'])[1].any()
    else:
        assert 'skipping epoch0003.optimizer.pt: not a torch AdamW state ' \
            'dict' in out
        assert not os.path.exists(os.path.join(jdir,
                                               'epoch0003.optimizer.ckpt'))


def _pt_equal(a, b):
    x = torch.load(a, weights_only=True)
    y = torch.load(b, weights_only=True)
    if 'param_groups' in x:
        assert x['param_groups'] == y['param_groups']
        x, y = x['state'], y['state']
        assert x.keys() == y.keys()
        x = {(i, k): v for i in x for k, v in x[i].items()}
        y = {(i, k): v for i in y for k, v in y[i].items()}
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k


@pytest.mark.parametrize('kind', ['vpd', 'vipe'])
def test_export_is_vpd_tpu_tensors_and_round_trips(kind, tmp_path, capsys):
    if kind == 'vpd':
        src = _vpd_dir(str(tmp_path / 'ref'), 'resnet18', seed=4)
    else:
        src, _, _ = _vipe_dir(str(tmp_path / 'ref'))
    model_dir = os.path.join(tmp_path, 'model')
    timport.main(src, model_dir)
    jout, tout = str(tmp_path / 'jexp'), str(tmp_path / 'texp')
    capsys.readouterr()
    jexport.main(model_dir, jout)
    want = capsys.readouterr().out
    texport.main(model_dir, tout)
    assert capsys.readouterr().out == want.replace(jout, tout)
    assert sorted(os.listdir(jout)) == sorted(os.listdir(tout))
    for f in os.listdir(jout):
        if f.endswith('.pt'):
            _pt_equal(os.path.join(jout, f), os.path.join(tout, f))
    # and back: the source checkpoints, byte for byte
    back = str(tmp_path / 'back')
    timport.main(tout, back)
    for f in os.listdir(model_dir):
        if kind == 'vpd' and f.endswith('decoder.ckpt'):
            continue  # the motion head is not exported (as vpd_tpu)
        with open(os.path.join(model_dir, f), 'rb') as a, \
                open(os.path.join(back, f), 'rb') as b:
            assert a.read() == b.read(), f


def test_resume_from_import_takes_vpd_tpu_step(tmp_path, capsys):
    """Both packages' teacher trainers resume the imported dir (moments,
    count 2, a head without state); one float64 step at dropout 0 on the
    same batch follows."""
    src, batcher, cfg = _vipe_dir(str(tmp_path / 'ref'))
    model_dir = str(tmp_path / 'model')
    timport.main(src, model_dir)
    batch = batcher.next_batch()
    kp_mask = batcher.kp_mask()

    jt = jloop.VIPETrainer(make_batcher(8), None, cfg, save_dir=model_dir)
    assert jt.resume() == 4
    with jax.enable_x64():
        state = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, jt.state)
        step = jvipe.make_train_step(jax_model(batcher.kp_dims,
                                               dtype=jnp.float64),
                                     kp_mask.astype(np.float64))
        state, m = step(state, {k: v.astype(np.float64)
                                if v.dtype == np.float32 else v
                                for k, v in batch.items()},
                        jax.random.key(0))
        jloss = float(m['loss_sum'])
        jparams = jax.tree_util.tree_map(np.asarray, state.params)

    tt = tloop.VIPETrainer(make_batcher(8), None, cfg, save_dir=model_dir,
                           device='cpu')
    try:
        assert tt.resume() == 4 and tt.state.step == 2
    finally:
        tt.close()
    model = tt.model.double()
    for mod in model.modules():
        if isinstance(mod, FlaxDropout):
            mod.rate = 0.
    for st in tt.state.optimizer.state.values():
        for k in ('exp_avg', 'exp_avg_sq'):
            st[k] = st[k].double()
    init = {k: v.clone() for k, v in model.named_parameters()}
    loss = float(tvipe.make_train_step(kp_mask)(
        tt.state, to_torch(batch, torch.float64), 0)['loss_sum'])
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)

    ref = tloop.build_model(cfg, batcher.kp_dims).double()
    from vpd_tpu_torch.models.flax_weights import vipe_params_from_flax
    want = vipe_params_from_flax(ref, jparams)
    for name, p in model.named_parameters():
        err = (p - want[name]).norm().item()
        if _feeds_bn(name):
            assert err <= 1e-5 * cfg['learning_rate'], name
        else:
            delta = (want[name] - init[name]).norm().item()
            assert err <= PARAM_TOL * delta + 1e-9, (name, err, delta)


def _refusal(tmp_path, tool, cfg, files=()):
    root = str(tmp_path / 'in')
    os.makedirs(root)
    with open(os.path.join(root, 'config.json'), 'w') as fp:
        json.dump(cfg, fp)
    for f in files:
        open(os.path.join(root, f), 'wb').close()
    msgs = []
    for pkg in ({'import': jimport, 'export': jexport}[tool],
                {'import': timport, 'export': texport}[tool]):
        with pytest.raises(SystemExit) as e:
            pkg.main(root, str(tmp_path / 'out'))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


@pytest.mark.parametrize('tool', ['import', 'export'])
@pytest.mark.parametrize('case', ['effnet', 'neither', 'empty'])
def test_refusals_match_vpd_tpu(tool, case, tmp_path):
    cfg = {'effnet': vpd_config('fs', EMB, encoder_arch='effnet0'),
           'neither': {'dataset': 'fs'},
           'empty': vpd_config('fs', EMB)}[case]
    msg = _refusal(tmp_path, tool, cfg)
    assert {'effnet': 'effnet', 'neither': 'neither the VIPE',
            'empty': 'checkpoints in'}[case] in msg


def test_optimizer_of_another_model_is_refused(tmp_path):
    """An AdamW over the encoder alone beside a decoder-3d: vpd_tpu's
    count-mismatch SystemExit."""
    src, _, cfg = _vipe_dir(str(tmp_path / 'ref'))
    enc = TorchFCResNet(IN_DIM, EMB, 2, HID)
    opt = torch.optim.AdamW(enc.parameters())
    enc(torch.ones(2, IN_DIM)).sum().backward()
    opt.step()
    torch.save(opt.state_dict(), os.path.join(src, 'epoch0003.optimizer.pt'))
    msgs = []
    for pkg in (jimport, timport):
        with pytest.raises(SystemExit) as e:
            pkg.main(src, str(tmp_path / pkg.__name__.split('.')[0]))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and 'component mismatch' in msgs[0]
