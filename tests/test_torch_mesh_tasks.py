"""The port's data-parallel tasks on two gloo ranks against vpd_tpu's on a
2-device mesh (and against the port's own one-process runs).

- `apply_vpd` with the mesh: the ranks split the chunks (each launching
  kernel B1's twin on its own), rank 0 writes every `.emb.pkl`: cos
  > 1 - 1e-4 against vpd_tpu's mesh extraction in float32 and byte-equal
  to the port's one-process run; the CLI refuses a batch the world does
  not divide.
- `compute_flow --data_parallel` (LK): the ranks split the chunks and
  write their PNGs; within one quantization level of vpd_tpu's mesh run
  and byte-equal to the port's one-process run.
- `run_action_recognition` with the mesh (its fused sweep's trials split
  over the ranks) writes the one-process run's `test_pred.csv` files,
  rank 0 alone. tests/test_torch_mesh_ensembles.py holds the split
  sweep and ensemble against vpd_tpu.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from test_torch_apply_vpd import (assert_same_extraction, load_out,
                                  write_crop_tree, write_jax_student)
from test_torch_flow import read_outputs, write_pair_tree
from test_torch_recognize import CATS, assert_same_csvs, corpus
from vpd_tpu.core import mesh as jmesh
from vpd_tpu.infer import apply_vpd as japply
from vpd_tpu.tools import compute_flow as jflow_cli
from vpd_tpu_torch.core import mesh as tmesh
from vpd_tpu_torch.infer import apply_vpd as tapply
from vpd_tpu_torch.tasks import recognize as trec
from vpd_tpu_torch.tools import compute_flow as tflow_cli

torch.set_num_threads(2)


def _jax_mesh():
    return jmesh.get_mesh(jax.devices()[:2])




def test_apply_vpd_data_parallel(tmp_path):
    crop_dir = str(tmp_path / 'crops')
    write_crop_tree(crop_dir)
    model_dir = str(tmp_path / 'student')
    write_jax_student(model_dir, True, seed=1)
    videos, tasks = tapply.scan_crop_dir(crop_dir)
    # 12 crops in chunks of 4: rank 0 takes chunks 0 and 2, rank 1 chunk 1
    ref = str(tmp_path / 'jax')
    japply.apply_vpd(videos, tasks, model_dir, ref, flow_img_name='flow',
                     batch_size=4, mesh=_jax_mesh(), log=lambda *a: None,
                     prepared=japply.load_student_dir(model_dir,
                                                      dtype=jnp.float32))
    one = str(tmp_path / 'one')
    tapply.apply_vpd(videos, tasks, model_dir, one, flow_img_name='flow',
                     batch_size=4, device='cpu', log=lambda *a: None,
                     prepared=tapply.load_student_dir(
                         model_dir, dtype=torch.float32, device='cpu'))
    out = str(tmp_path / 'ranks')
    cli = dict(model_dir=model_dir, dataset='fs', out_dir=str(tmp_path / 'x'),
               model_epoch=None, jitter=0, no_flip=False, flow_img='flow',
               batch_size=5)
    ranks = W.run_ranks(W.apply_vpd_dp, 2, tmp_path / 'r', videos, tasks,
                        model_dir, out, 4, flow_img_name='flow', cli=cli)
    assert [r['chunks'] for r in ranks] == [[4, 4], [4]]
    assert all('divisible by the 2 ranks' in r['refusal'] for r in ranks)
    assert not os.path.exists(tmp_path / 'x')
    assert_same_extraction(load_out(out), load_out(ref), 1 - 1e-4)
    for v in videos:
        with open(os.path.join(out, v + '.emb.pkl'), 'rb') as a, \
                open(os.path.join(one, v + '.emb.pkl'), 'rb') as b:
            assert a.read() == b.read(), v


def test_compute_flow_data_parallel(tmp_path):
    root = str(tmp_path / 'pairs')
    write_pair_tree(root, n_videos=2, frames=4)
    jflow_cli.main(root, 'j', 20, 32, 4, False, mesh=_jax_mesh())
    tflow_cli.main(root, 'one', 20, 32, 4, False, device='cpu')
    ranks = W.run_ranks(W.compute_flow_dp, 2, tmp_path / 'r', root, 't', 4)
    assert [r['count'] for r in ranks] == [8, 8]
    written = [r['written'] for r in ranks]
    assert len(written[0]) == len(written[1]) == 4
    assert not set(written[0]) & set(written[1])
    ref, got, one = (read_outputs(root, n) for n in ('j', 't', 'one'))
    assert list(got) == list(ref) == list(one) and len(got) == 8
    a = np.stack(list(got.values())).astype(int)
    assert np.abs(a - np.stack(list(ref.values())).astype(int)).max() <= 1
    np.testing.assert_array_equal(a, np.stack(list(one.values())))


def test_recognition_with_the_mesh_writes_the_one_process_csvs(tmp_path):
    train_embs, train_labels, test_embs, test_labels, ids = corpus(8)
    cats = {i: types.SimpleNamespace(name=c.name) for i, c in CATS.items()}
    args = (cats, train_embs, train_labels, None, None, test_embs,
            test_labels)
    kw = dict(k=1, num_train_examples=[2], few_shot_template='ids_{}_{}',
              hidden_dim=8, attn=True, num_epochs=2, val_freq=1, n_trials=2,
              no_test_flip=False, load_action_ids_fn=ids.get)
    one = str(tmp_path / 'one')
    want = trec.run_action_recognition(*args, one, 'gru', fused_sweep=True,
                                       device='cpu', log=lambda *a: None,
                                       **kw)
    out = str(tmp_path / 'ranks')
    ranks = W.run_ranks(W.recognition_dp, 2, tmp_path / 'r', args, out, kw)
    assert ranks[0] == ranks[1] == want
    assert_same_csvs(out, one)


def test_world_one_mesh_runs_the_one_process_path():
    mesh = tmesh.get_mesh('cpu')
    assert (mesh.world, mesh.data_size, mesh.batch_part) == (1, 1, (0, 1))
    assert tmesh.member_axis_placement(mesh, [1])[0] is None
    assert tmesh.is_primary()
    assert tmesh.all_reduce_sum([1., 2.], mesh) == [1., 2.]
    assert tmesh.all_gather_object('x') == ['x']
    with pytest.raises(ValueError, match='model groups of 2'):
        tmesh.get_mesh_2d(2, device='cpu')
