#!/usr/bin/env python3
"""Convert a reference (PyTorch) model directory into vpd_tpu's checkpoint
format, so the pre-trained VIPE*/VPD models distributed with jhong93/vpd
serve through `apply_vipe` / `apply_vpd` and resume training, in either
package.

Counterpart of `python -m vpd_tpu.tools.import_torch_model`, with the
same flags and printed lines; it runs on the host and needs no GPU:

    python -m vpd_tpu_torch.tools.import_torch_model <reference dir> \\
        -o <out dir>

The reference saves per-component torch state_dicts, `{name}.encoder.pt`
with name in {best_epoch, epochNNNN} (`train_vipe_model.py:171-183`,
`train_vpd_model.py:107-112`), beside a `config.json` manifest whose
schema the packages share. The manifest (and `loss.json`) are copied and
every checkpoint converted: reference layout -> the port's modules
(`models/torch_compat.py`) -> flax trees (`models/flax_weights.py`), so
the `.ckpt` files are the ones vpd_tpu's tool writes, byte for byte.
Training state converts too: `{name}.decoder-3d.pt` VIPE decoders onto
the padded multi-head, `{name}.decoder.pt` VPD motion heads onto the
motion FCNet, and a VIPE `{name}.optimizer.pt` (torch AdamW: exp_avg,
exp_avg_sq and step, indexed in `get_model_params` order, encoder then
decoder, `train_vipe_model.py:164-169`) into optax's AdamW layout, each
moment mapped as its parameter is; a parameter torch holds no state for
(it never had a gradient) resumes with zero moments. Files are read with
`weights_only`, so they run no code.
"""

import argparse
import os
import re

import numpy as np
import torch

# {:04d} widens past 9999, so epochs need 4-or-more digits
CKPT_RE = re.compile(r'^(best_epoch|epoch\d{4,})\.encoder\.pt$')


def dataset_targets(config):
    """[(dataset name, flattened 3D target dim or 0)] of a VIPE config."""
    return [(d['name'], int(np.prod(d['3d_pose_shape']))
             if d['3d_pose_shape'] else 0) for d in config['datasets']]


def vipe_model(config, with_decoder):
    """The port's `VIPEModel` for `config` on the meta device (with its
    3D decoder when `with_decoder`)."""
    from ..train.vipe_loop import build_model

    dims = [d if with_decoder else 0 for _, d in dataset_targets(config)]
    with torch.device('meta'):
        return build_model(config, dims)


def _motion_state_dict(sd):
    """Reference VPD `fcn_time` state_dict (a plain FCNet's Linears) -> the
    port's `MotionHead` state_dict."""
    idx = sorted(int(k.split('.')[1]) for k in sd if k.endswith('.weight'))
    return {'net.layers.{}.{}'.format(i, leaf):
            sd['layers.{}.{}'.format(j, leaf)]
            for i, j in enumerate(idx) for leaf in ('weight', 'bias')}


def _convert_vipe_optimizer(opt_path, comps, model, config):
    """A torch AdamW state_dict -> optax's AdamW state as vpd_tpu's VIPE
    trainer saves it, through the port's `optimizer_to_flax`.

    comps: [(part of `model`, reference state_dict, reference -> port
    state_dict)] in the reference's `get_model_params` order. Each moment
    maps through its parameter's converter, so it lands where its
    parameter does. Returns None (and says so) for a file that is not a
    torch AdamW state_dict."""
    from ..models.flax_weights import vipe_params_to_flax
    from ..models.torch_compat import torch_param_names
    from ..train.vpd import create_state, optimizer_to_flax

    raw = torch.load(opt_path, map_location='cpu', weights_only=True)
    if not (isinstance(raw, dict) and 'param_groups' in raw
            and 'state' in raw and raw['state']
            and all(k in next(iter(raw['state'].values()))
                    for k in ('step', 'exp_avg', 'exp_avg_sq'))):
        print('skipping {}: not a torch AdamW state dict'.format(
            os.path.basename(opt_path)))
        return None
    flat = [i for g in raw['param_groups'] for i in g['params']]
    n_params = sum(len(torch_param_names(sd)) for _, sd, _ in comps)
    if len(flat) != n_params:
        raise SystemExit(
            'optimizer state covers {} params but the checkpoints have '
            '{} — component mismatch'.format(len(flat), n_params))

    moments = {'exp_avg': {}, 'exp_avg_sq': {}}
    pos = 0
    for part, sd, to_port in comps:
        pseudo = {field: dict(sd) for field in moments}
        for k in torch_param_names(sd):
            ps = raw['state'].get(flat[pos])
            pos += 1
            for field in moments:
                pseudo[field][k] = (ps[field] if ps is not None else
                                    torch.zeros_like(torch.as_tensor(sd[k])))
        for field in moments:
            moments[field].update(
                ('{}.{}'.format(part, k), v)
                for k, v in to_port(pseudo[field]).items())
    step = torch.tensor(float(next(iter(raw['state'].values()))['step']))
    state = create_state(model, config['learning_rate'])
    for name, p in model.named_parameters():
        state.optimizer.state[p] = {'step': step.clone(),
                                    **{f: moments[f][name] for f in moments}}
    return optimizer_to_flax(state, vipe_params_to_flax)


def main(model_dir, out_dir):
    from ..core import checkpoint as ckpt
    from ..core.io import load_json, store_json
    from ..models.flax_weights import (encoder_to_flax, motion_to_flax,
                                       vipe_to_flax)
    from ..models.torch_compat import (
        convert_fcposedecoder_state_dict, convert_fcresnet_state_dict,
        convert_resnet_state_dict, load_converted, load_torch_state_dict)
    from ..train.vpd import MotionHead
    from ..train.vpd_loop import build_student

    config = load_json(os.path.join(model_dir, 'config.json'))
    if 'embedding_dim' in config:  # train_vipe_model.py:330-344 schema
        kind = 'vipe'
        targets = dataset_targets(config)

        def convert(sd):
            return convert_fcresnet_state_dict(sd, config['encoder_arch'][0])
    elif 'use_flow' in config:  # train_vpd_model.py:222-228 schema
        kind = 'vpd'
        arch = config['encoder_arch']
        if 'resnet' not in arch:
            raise SystemExit(
                'only resnet student imports are supported (got {!r}): '
                'the reference effnet students use efficientnet_pytorch '
                'from_name (random init, models/rgb.py:62-66) so there '
                'are no published weights to import'.format(arch))

        def convert(sd):
            return convert_resnet_state_dict(sd, arch)
    else:
        raise SystemExit(
            'config.json matches neither the VIPE nor the VPD schema')

    names = sorted(m.group(1) for f in os.listdir(model_dir)
                   if (m := CKPT_RE.match(f)))
    if not names:
        raise SystemExit('no {name}.encoder.pt checkpoints in ' + model_dir)

    os.makedirs(out_dir, exist_ok=True)
    store_json(os.path.join(out_dir, 'config.json'), config)
    loss_file = os.path.join(model_dir, 'loss.json')
    if os.path.exists(loss_file):  # keeps plot_losses working + resume
        store_json(os.path.join(out_dir, 'loss.json'),
                   load_json(loss_file))

    def path(name, comp):
        return os.path.join(model_dir, '{}.{}.pt'.format(name, comp))

    for name in names:
        enc_sd = load_torch_state_dict(path(name, 'encoder'))
        done = ['encoder']
        if kind == 'vipe':
            dec_sd = (load_torch_state_dict(path(name, 'decoder-3d'))
                      if os.path.exists(path(name, 'decoder-3d')) else None)
            model = vipe_model(config, dec_sd is not None)
            comps = [('encoder', enc_sd, convert)]
            if dec_sd is not None:
                comps.append(('decoder', dec_sd, lambda sd:
                              convert_fcposedecoder_state_dict(sd, targets)))
            for part, sd, to_port in comps:
                load_converted(getattr(model, part), to_port(sd))
            tree = vipe_to_flax(model)
            ckpt.save_component(out_dir, name, 'encoder', {
                'params': tree['params']['encoder'],
                'batch_stats': tree['batch_stats']['encoder']})
            if dec_sd is not None:
                ckpt.save_component(out_dir, name, 'decoder-3d', {
                    'params': tree['params']['decoder'], 'batch_stats': {}})
                done.append('decoder-3d')
            if os.path.exists(path(name, 'optimizer')):
                opt_state = _convert_vipe_optimizer(
                    path(name, 'optimizer'), comps, model, config)
                if opt_state is not None:
                    ckpt.save_component(out_dir, name, 'optimizer',
                                        opt_state)
                    done.append('optimizer')
        else:
            with torch.device('meta'):
                student = build_student(config, dtype=torch.float32)
            ckpt.save_component(out_dir, name, 'encoder', encoder_to_flax(
                load_converted(student.encoder, convert(enc_sd))))
            if os.path.exists(path(name, 'decoder')):
                dec_sd = load_torch_state_dict(path(name, 'decoder'))
                with torch.device('meta'):
                    head = MotionHead(config['emb_dim'])
                ckpt.save_component(out_dir, name, 'decoder', motion_to_flax(
                    load_converted(head, _motion_state_dict(dec_sd))))
                done.append('decoder')
        print('converted {} ({} {})'.format(name, kind, '+'.join(done)))
    print('imported {} checkpoint(s) -> {}'.format(len(names), out_dir))


if __name__ == '__main__':
    parser = argparse.ArgumentParser(
        description=__doc__.split('\n')[0])
    parser.add_argument('model_dir',
                        help='reference save_dir (config.json + *.pt)')
    parser.add_argument('-o', '--out_dir', required=True,
                        help='converted model dir for apply_vipe/apply_vpd')
    main(**vars(parser.parse_args()))
