"""The slice as a whole, on the CPU: from video to embeddings in the port
against the same chain in vpd_tpu, on the same inputs.

`chip_smoke.write_prep_corpus` (tiny: 2 videos x 10 frames at 96x64)
goes through `extract_square_crops` (trees byte-equal), `compute_flow
--model lk` (PNG values within one quantization step, equal on >= 99.9%,
the bar of `tests/test_torch_flow.py`), `pack_crops --flow_img` and
`apply_vpd` with one float32 student (vpd_tpu's, written as
`tests/test_torch_apply_vpd.py` writes it): one row per boxed frame in
both, row cosines >= 1 - 1e-4, that file's bar for float32 students on
identical crops.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_apply_vpd import load_out, write_jax_student
from vpd_tpu.data.shards import ShardReader as JShardReader
from vpd_tpu.infer import apply_vpd as japply
from vpd_tpu.tools import compute_flow as jflow
from vpd_tpu.tools import extract_square_crops as jesc
from vpd_tpu.tools import pack_crops as jpack
from vpd_tpu_torch.data.shards import ShardReader
from vpd_tpu_torch.infer import apply_vpd as tapply
from vpd_tpu_torch.tools import compute_flow as tflow
from vpd_tpu_torch.tools import extract_square_crops as tesc
from vpd_tpu_torch.tools import pack_crops as tpack

torch.set_num_threads(2)

DIM, EMB = 32, 8
COS_BAR = 1 - 1e-4


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp('chain')
    pose_dir, video_dir, expected = chip_smoke.write_prep_corpus(
        str(root), np.random.default_rng(9), videos=2, frames=10,
        size=(96, 64), fps=10.)
    student = str(root / 'student')
    write_jax_student(student, use_flow=True, seed=1)
    out = {}
    for name, esc, flow, pack in (('jax', jesc, jflow, jpack),
                                  ('port', tesc, tflow, tpack)):
        tree = str(root / name / 'crops')
        esc.main(pose_dir, video_dir, tree, DIM, None, 1, False, 1)
        kw = dict(clip=20, img_dim=DIM, batch_size=8, overwrite=False)
        if name == 'port':
            kw['device'] = 'cpu'
        flow.main(tree, 'flow', **kw)
        shards = str(root / name / 'shards')
        pack.main(tree, shards, DIM, 'flow', False, 16, 'raw')
        out[name] = (tree, shards)
    return root, expected, student, out


def test_trees_and_flow_agree(chain):
    _, expected, _, out = chain
    trees = {n: chip_smoke._file_tree(t) for n, (t, _) in out.items()}
    crops = {n: {k: v for k, v in t.items() if not k.endswith('.flow.png')}
             for n, t in trees.items()}
    assert crops['port'] == crops['jax']
    flows = sorted(k for k in trees['jax'] if k.endswith('.flow.png'))
    assert flows == sorted(k for k in trees['port']
                           if k.endswith('.flow.png'))
    assert len(flows) == sum(map(len, expected.values()))
    a, b = (np.stack([cv2.imdecode(np.frombuffer(trees[n][k], np.uint8),
                                   cv2.IMREAD_UNCHANGED) for k in flows])
            .astype(int) for n in ('port', 'jax'))
    assert a.shape == (len(flows), DIM, DIM, 3)
    assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999


def test_embeddings_agree(chain):
    root, expected, student, out = chain
    embs = {}
    for name, (tree, shards) in out.items():
        dest = str(root / name / 'embs')
        if name == 'jax':
            videos, tasks = japply.scan_crop_dir(tree)
            japply.apply_vpd(
                videos, tasks, student, dest, flow_img_name='flow',
                batch_size=8, shard_reader=JShardReader(shards,
                                                        crop_root=tree),
                prepared=japply.load_student_dir(student, dtype=jnp.float32),
                log=lambda *a: None)
        else:
            videos, tasks = tapply.scan_crop_dir(tree)
            tapply.apply_vpd(
                videos, tasks, student, dest, flow_img_name='flow',
                batch_size=8, shard_reader=ShardReader(shards,
                                                       crop_root=tree),
                prepared=tapply.load_student_dir(student, dtype=torch.float32,
                                                 device='cpu'),
                log=lambda *a: None, device='cpu')
        embs[name] = load_out(dest)
    assert list(embs['port']) == list(embs['jax']) == sorted(expected)
    for video, rows in embs['port'].items():
        assert [r[0] for r in rows] == sorted(expected[video])
        a = np.stack([r[1] for r in rows]).reshape(-1, EMB).astype(np.float64)
        b = np.stack([r[1] for r in embs['jax'][video]]).reshape(-1, EMB)
        assert a.shape == b.shape == (len(rows) * 2, EMB)
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                 * np.linalg.norm(b, axis=-1))
        assert cos.min() >= COS_BAR, cos.min()
