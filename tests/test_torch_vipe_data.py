"""The port's teacher geometry and samplers against vpd_tpu's on the CPU.

- The numpy copies (skeleton specs, normalizers, 3D features, camera
  projections, raw skeleton loaders) give vpd_tpu's values byte for byte.
- `normalize_2d_batch_torch` against vpd_tpu's jax `normalize_2d_batch`
  within 1e-6, with flips, zeroed confidences and bone features.
- `FusedBatcher` over the four mocap families plus `3dpeople_pair` draws
  vpd_tpu's batches byte for byte from the same seeds; the samplers
  pickle (spawned workers need that).
- The on-disk loaders read chip_smoke's synthetic mocap layout into
  vpd_tpu's sequences and 3D poses.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from synth import make_synth_family
from vpd_tpu.data import vipe_sampler as jvs
from vpd_tpu.geometry import (amass as jamass, camera as jcamera,
                              coco as jcoco, features3d as jfeat,
                              human36m as jh36m, nba2k as jnba,
                              people3d as jp3d)
from vpd_tpu_torch.data import vipe_sampler as tvs
from vpd_tpu_torch.geometry import (amass as tamass, camera as tcamera,
                                    coco as tcoco, features3d as tfeat,
                                    human36m as th36m, nba2k as tnba,
                                    people3d as tp3d)

torch.set_num_threads(2)

FAMILY_MODULES = [(jh36m, th36m), (jp3d, tp3d), (jnba, tnba),
                  (jamass, tamass)]
FAMS = ['human36m', '3dpeople', 'nba2k', 'amass']


def assert_same(a, b):
    """Equal structure, equal numpy arrays byte for byte (dtype too)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize('jmod,tmod', FAMILY_MODULES,
                         ids=[j.SPEC.name for j, _ in FAMILY_MODULES])
def test_skeleton_specs_equal_vpd_tpu(jmod, tmod):
    js, ts = jmod.SPEC, tmod.SPEC
    for f in dataclasses.fields(js):
        assert_same(getattr(js, f.name), getattr(ts, f.name))
    for prop in ('child_idx', 'parent_idx', 'root_edge', 'pred_edge',
                 'path_matrix', 'xflip_rows', 'coco_avg_matrix'):
        assert_same(np.asarray(getattr(js, prop)),
                    np.asarray(getattr(ts, prop)))
    rng = np.random.default_rng(0)
    offsets = rng.normal(size=(5, js.num_edges, 3)).astype(np.float32)
    for fn in ('decode_positions', 'decode_all_positions', 'flip_offsets',
               'project_coco'):
        assert_same(getattr(js, fn)(offsets), getattr(ts, fn)(offsets))
    for include in (False, True):
        assert_same(jfeat.get_3d_features(offsets, js, include, include),
                    tfeat.get_3d_features(offsets, ts, include, include))


def test_raw_skeleton_loaders_equal_vpd_tpu(tmp_path):
    """Raw mocap -> (root, theta, offsets), the root `.copy()` of
    QUIRKS.md kept (the root is not zeroed)."""
    rng = np.random.default_rng(1)
    for jmod, tmod, pose in (
            (jh36m, th36m, rng.normal(0, 50, 96)),
            (jnba, tnba, rng.normal(0, 0.5, (35, 3))),
            (jamass, tamass, rng.normal(0, 0.5, (24, 3)))):
        got = tmod.load_raw_skeleton(pose)
        assert_same(jmod.load_raw_skeleton(pose), got)
        assert np.abs(got[0]).sum() > 0
    txt = tmp_path / 'frame.txt'
    np.savetxt(txt, rng.normal(0, 0.5, (67, 6)))
    assert_same(jp3d.load_raw_skeleton(str(txt)),
                tp3d.load_raw_skeleton(str(txt)))


def test_numpy_normalizers_and_projections_equal_vpd_tpu():
    rng = np.random.default_rng(2)
    kps = rng.uniform(0, 100, (16, 17, 3)).astype(np.float32)
    kps[3, [5, 6, 11, 12], :2] = 7.  # zero torso: the guard
    flips = rng.random(16) < 0.5
    for zero_confs in (False, True):
        for bones in (False, True):
            assert_same(jcoco.normalize_2d_skeleton_batch(
                kps, flips, zero_confs, bones),
                tcoco.normalize_2d_skeleton_batch(kps, flips, zero_confs,
                                                  bones))
            for i in (0, 3, 5):
                assert_same(jcoco.normalize_2d_skeleton(
                    kps[i], flips[i], zero_confs, bones),
                    tcoco.normalize_2d_skeleton(kps[i], flips[i],
                                                zero_confs, bones))
    assert tcoco.pose_input_dim(True) == jcoco.pose_input_dim(True) == 75
    for jmod, tmod in FAMILY_MODULES:
        offsets = rng.normal(size=(6, jmod.SPEC.num_edges, 3))
        r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
        assert_same(jcamera.random_project_offsets_batch(jmod.SPEC, offsets,
                                                         r1),
                    tcamera.random_project_offsets_batch(tmod.SPEC, offsets,
                                                         r2))
        assert_same(jcamera.random_project_offsets(jmod.SPEC, offsets[0],
                                                   r1),
                    tcamera.random_project_offsets(tmod.SPEC, offsets[0],
                                                   r2))
        a, b = jfeat.normalize_3d_offsets(offsets)[0], \
            tfeat.normalize_3d_offsets(offsets)[0]
        assert_same(jfeat.neg_sample_valid_batch(a, a[::-1]),
                    tfeat.neg_sample_valid_batch(b, b[::-1]))
        assert_same(jfeat.mean_offset_norms(offsets),
                    tfeat.mean_offset_norms(offsets))


@pytest.mark.parametrize('zero_confs', [False, True])
@pytest.mark.parametrize('bones', [False, True])
def test_torch_normalizer_matches_vpd_tpu_jax(zero_confs, bones):
    rng = np.random.default_rng(4)
    kps = rng.uniform(0, 200, (64, 17, 3)).astype(np.float32)
    kps[7, [5, 6, 11, 12], :2] = 3.  # zero torso distance
    flips = rng.random(64) < 0.5
    want = np.asarray(jcoco.normalize_2d_batch(kps, flips, zero_confs,
                                               bones))
    got = tcoco.normalize_2d_batch_torch(torch.from_numpy(kps),
                                         torch.from_numpy(flips),
                                         zero_confs, bones)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), jcoco.normalize_2d_skeleton_batch(kps, flips,
                                                       zero_confs, bones),
        rtol=0, atol=1e-6)


def _samplers(pkg, embed_bones, seed0=0):
    """Samplers of `pkg` over the same synthetic families: the four mocap
    families and a pairwise 3dpeople one."""
    out = []
    for i, fam in enumerate(FAMS):
        seqs, poses = make_synth_family(fam, seed=i)
        out.append(pkg.VIPESampler(pkg.FAMILIES[fam], seqs, poses,
                                   embed_bones=embed_bones, target_len=40,
                                   seed=seed0 + i))
    seqs, _ = make_synth_family('3dpeople', seed=9)
    out.append(pkg.PairwiseSampler(seqs, embed_bones=embed_bones,
                                   target_len=20, seed=seed0 + 4))
    return out


@pytest.mark.parametrize('embed_bones', [False, True])
def test_fused_batches_equal_vpd_tpu(embed_bones):
    ref = jvs.FusedBatcher(_samplers(jvs, embed_bones), 24)
    got = tvs.FusedBatcher(_samplers(tvs, embed_bones), 24)
    assert got.rows == ref.rows and got.kp_dims == ref.kp_dims
    assert got.num_batches == ref.num_batches
    assert_same(ref.kp_mask(), got.kp_mask())
    for _ in range(3):
        a, b = ref.next_batch(), got.next_batch()
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    assert got.batch_size == a['pose1'].shape[0]
    assert (a['has_3d'] == [1] * sum(got.rows[:4]) + [0] * got.rows[4]).all()
    # per-row sample() and the preview sequences too
    jsmp, tsmp = ref.samplers[0], got.samplers[0]
    assert_same(jsmp.sample(), tsmp.sample())
    assert_same(jsmp.get_sequence(1, stride=2), tsmp.get_sequence(1,
                                                                  stride=2))


def test_samplers_pickle():
    """Spawned workers receive the samplers pickled: the family's index
    map is a module-level function, not a lambda."""
    for smp in _samplers(tvs, False):
        back = pickle.loads(pickle.dumps(smp))
        assert_same(back.sample(), smp.sample())
    assert tvs.FAMILIES['amass'].pose3d_index(50) == 2
    assert tvs.FAMILIES['3dpeople'].pose3d_index(1) == 0


def test_loaders_read_the_mocap_layout_as_vpd_tpu(tmp_path):
    root = tmp_path / 'vipe'
    n = chip_smoke.write_mocap_corpus(str(root), np.random.default_rng(5),
                                      frames=6, cameras=2)
    assert n == (3 * 8 + 4) * 6 * 2
    loaders = [('human36m', 'human3.6m', 'load_human36m'),
               ('3dpeople', '3dpeople', 'load_3dpeople'),
               ('nba2k', 'nba2k', 'load_nba2k'),
               ('amass', 'amass', 'load_amass')]
    for fam, dirname, fn in loaders:
        args = (str(root / dirname / 'cocopose'),
                str(root / dirname / 'ground_truth_3d_pose.pkl'))
        (jtrain, jval), jposes = getattr(jvs, fn)(*args)
        (ttrain, tval), tposes = getattr(tvs, fn)(*args)
        n_val = sum(p in jvs.VAL_PEOPLE[fam]
                    for p in chip_smoke.MOCAP_PEOPLE[fam])
        per_person = 1 if fam == 'nba2k' else 2
        assert (len(jtrain), len(jval)) == (per_person * (4 - n_val),
                                            per_person * n_val), fam
        assert_same(jtrain, ttrain)
        assert_same(jval, tval)
        assert_same(jposes, tposes)
        # every 2D frame finds its 3D pose through the family's index
        fam_cfg = tvs.FAMILIES[fam]
        for key, frames in ttrain + tval:
            assert len(frames) == 6 and len(frames[0][1]) == 2
            assert all(0 <= fam_cfg.pose3d_index(f) < 6 for f, _ in frames)
    (train, val), _ = tvs.load_keyed(str(root / '3dpeople' / 'cocopose'),
                                     None, '3dpeople', tvs.people3d_key)
    assert [k for k, _ in train] == [('man05', 'jump'), ('man05', 'walk'),
                                     ('woman05', 'jump'), ('woman05', 'walk')]
    assert [k for k, _ in val] == [('man01', 'jump'), ('man01', 'walk'),
                                   ('woman01', 'jump'), ('woman01', 'walk')]
