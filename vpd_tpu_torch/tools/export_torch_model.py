#!/usr/bin/env python3
"""Convert a model directory trained by vpd_tpu or this port into the
reference's (PyTorch) checkpoint format, so its VIPE*/VPD encoders serve
in jhong93/vpd (`apply_vipe_model.py` / `apply_vpd_model.py` load
`{name}.encoder.pt` beside `config.json`, whose schema the packages
share).

Counterpart of `python -m vpd_tpu.tools.export_torch_model`, with the
same flags and printed lines; it runs on the host and needs no GPU:

    python -m vpd_tpu_torch.tools.export_torch_model <model dir> \\
        -o <out dir>

The inverse of `tools/import_torch_model`: every `{name}.encoder.ckpt`
loads into the port's module (`models/flax_weights.py`) and leaves in the
reference's layout (`models/torch_compat.py`), BatchNorms with a
`num_batches_tracked` counter at 0. VIPE training state exports too:
`decoder-3d` heads are cut out of the padded multi-head, and optax's
AdamW moments become a torch `{name}.optimizer.pt` in `get_model_params`
order (`train_vipe_model.py:164-169`), so a run trained here resumes in
the reference through its own `--resume` (`train_vipe_model.py:
186-209`). VPD encoders take the reference's 'resnet.' prefix
(`models/rgb.py:61`); EfficientNet students are refused (the reference
builds them with efficientnet_pytorch `from_name`, `models/rgb.py:62-66`,
whose layout is not mirrored).
"""

import argparse
import os
import re

import numpy as np
import torch

from .import_torch_model import dataset_targets, vipe_model

CKPT_RE = re.compile(r'^(best_epoch|epoch\d{4,})\.encoder\.ckpt$')


def _export_vipe_optimizer(raw, model, comps, config, out_path):
    """Serialized optax AdamW state -> a torch AdamW state_dict file.

    raw: the 'optimizer' component as flax serializes the chain,
    {'0': {'count', 'mu', 'nu'}, '1': {}, '2': {}}. comps: [(part of
    `model`, its exported reference state_dict, port -> reference
    state_dict)] in `get_model_params` order. Each moment exports through
    its parameter's converter; a real torch AdamW over tensors of the
    moments' shapes supplies the whole param_groups entry, so the
    reference's strict `optimizer.load_state_dict` finds every field."""
    from ..models.flax_weights import vipe_params_from_flax
    from ..models.torch_compat import torch_param_names

    adam = raw['0']
    step = int(np.asarray(adam['count']))
    flat = {}
    for field in ('mu', 'nu'):
        values = vipe_params_from_flax(model, adam[field])
        flat[field] = []
        for part, exported, to_ref in comps:
            pseudo = dict(getattr(model, part).state_dict())
            pseudo.update((k[len(part) + 1:], v) for k, v in values.items()
                          if k.startswith(part + '.'))
            msd = to_ref(pseudo)
            flat[field] += [msd[k] for k in torch_param_names(exported)]

    dummies = [torch.nn.Parameter(torch.zeros(tuple(m.shape)))
               for m in flat['mu']]
    state = torch.optim.AdamW(dummies, lr=config['learning_rate']).state_dict()
    state['state'] = {
        i: {'step': torch.tensor(float(step)),
            'exp_avg': m.contiguous().clone(),
            'exp_avg_sq': v.contiguous().clone()}
        for i, (m, v) in enumerate(zip(flat['mu'], flat['nu']))}
    torch.save(state, out_path)


def main(model_dir, out_dir):
    from ..core import checkpoint as ckpt
    from ..core.io import load_json, store_json
    from ..models.flax_weights import load_encoder_from_flax
    from ..models.torch_compat import (
        export_fcposedecoder_state_dict, export_fcresnet_state_dict,
        export_resnet_state_dict, save_torch_state_dict)
    from ..train.vipe_loop import load_vipe_components
    from ..train.vpd_loop import build_student

    config = load_json(os.path.join(model_dir, 'config.json'))
    if 'embedding_dim' in config:  # VIPE schema
        kind = 'vipe'
        targets = dataset_targets(config)
    elif 'use_flow' in config:  # VPD schema
        kind = 'vpd'
        arch = config['encoder_arch']
        if 'resnet' not in arch:
            raise SystemExit(
                'only resnet student exports are supported (got {!r}): '
                'the reference effnet layout (efficientnet_pytorch) has '
                'no counterpart here'.format(arch))
    else:
        raise SystemExit(
            'config.json matches neither the VIPE nor the VPD schema')

    names = sorted(m.group(1) for f in os.listdir(model_dir)
                   if (m := CKPT_RE.match(f)))
    if not names:
        raise SystemExit(
            'no {name}.encoder.ckpt checkpoints in ' + model_dir)

    os.makedirs(out_dir, exist_ok=True)
    store_json(os.path.join(out_dir, 'config.json'), config)
    loss_file = os.path.join(model_dir, 'loss.json')
    if os.path.exists(loss_file):
        store_json(os.path.join(out_dir, 'loss.json'),
                   load_json(loss_file))

    def out(name, comp):
        return os.path.join(out_dir, '{}.{}.pt'.format(name, comp))

    for name in names:
        done = ['encoder']
        if kind == 'vipe':
            with_decoder = os.path.exists(ckpt.component_path(
                model_dir, name, 'decoder-3d'))
            model = vipe_model(config, with_decoder).to_empty(device='cpu')
            load_vipe_components(model, model_dir, name)
            comps = [('encoder', export_fcresnet_state_dict(
                model.encoder.state_dict()), export_fcresnet_state_dict)]
            if with_decoder:
                def to_ref(sd):
                    return export_fcposedecoder_state_dict(sd, targets)
                comps.append(('decoder', to_ref(model.decoder.state_dict()),
                              to_ref))
            save_torch_state_dict(out(name, 'encoder'), comps[0][1])
            if with_decoder:
                save_torch_state_dict(out(name, 'decoder-3d'), comps[1][1])
                done.append('decoder-3d')
            if os.path.exists(ckpt.component_path(model_dir, name,
                                                  'optimizer')):
                _export_vipe_optimizer(
                    ckpt.load_component(model_dir, name, 'optimizer'),
                    model, comps, config, out(name, 'optimizer'))
                done.append('optimizer')
        else:
            with torch.device('meta'):
                encoder = build_student(config, dtype=torch.float32).encoder
            encoder = encoder.to_empty(device='cpu')
            load_encoder_from_flax(encoder, ckpt.load_component(
                model_dir, name, 'encoder'))
            save_torch_state_dict(out(name, 'encoder'),
                                  export_resnet_state_dict(
                                      encoder.state_dict()))
        print('exported {} ({} {})'.format(name, kind, '+'.join(done)))
    print('exported {} checkpoint(s) -> {}'.format(len(names), out_dir))


if __name__ == '__main__':
    parser = argparse.ArgumentParser(
        description=__doc__.split('\n')[0])
    parser.add_argument('model_dir',
                        help='vpd-tpu save_dir (config.json + *.ckpt)')
    parser.add_argument('-o', '--out_dir', required=True,
                        help='reference-format model dir '
                             '(config.json + {name}.encoder.pt)')
    main(**vars(parser.parse_args()))
