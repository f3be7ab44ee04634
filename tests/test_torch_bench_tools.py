"""The port's measurement tools (`vpd_tpu_torch/tools/bench_*`) against
vpd_tpu's, on the CPU.

- The corpus generators give byte-equal files (`bench_extract_e2e.
  make_corpus` with and without flow, `bench_pipeline_e2e.make_corpus`:
  crops, masks, teacher `.emb.pkl`, the action layout; the mp4 stubs by
  their decoded frames) and equal arrays (`bench_ensemble_train.
  _synth_videos`).
- The slice as a whole: a student dir made by either package's
  `make_model_dir`, read by both, and both packages' `apply_vpd` on one
  generated corpus in float32: every `.emb.pkl` row at cosine >= 1 - 1e-4.
- Each tool runs to its end with `--device cpu` at a tiny size, and its
  last JSON line has vpd_tpu's keys under the port's names (plus the
  device it ran on).
- `bench_pipeline_e2e` with `run_stage` replaced in both packages by a
  recorder that writes the stages' outputs: equal stage command lines
  (`vpd_tpu.` -> `vpd_tpu_torch.`, the port's `--device` aside) and equal
  result keys. The real chain trains 24,000 samples an epoch: it runs on
  the card (chip_smoke's `bench` phase).
"""

import filecmp
import json
import os
import pickle
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vpd_tpu.infer import apply_vpd as japply
from vpd_tpu.tools import bench_ensemble_train as jens
from vpd_tpu.tools import bench_extract_e2e as jext
from vpd_tpu.tools import bench_pipeline_e2e as jpipe
from vpd_tpu_torch.infer import apply_vpd as tapply
from vpd_tpu_torch.tools import bench_ensemble_train as tens
from vpd_tpu_torch.tools import bench_extract_e2e as text
from vpd_tpu_torch.tools import bench_pipeline_e2e as tpipe
from vpd_tpu_torch.tools import bench_preprocess as tpre
from vpd_tpu_torch.tools import bench_train_e2e as ttrain

torch.set_num_threads(2)

IMG, EMB = 32, 8
COS_BAR = 1 - 1e-4
TINY = ['--device', 'cpu', '--img_dim', str(IMG), '--emb_dim', str(EMB),
        '--arch', 'resnet18', '--num_videos', '2', '--num_crops', '8',
        '--batch_size', '4']

# the keys of each vpd_tpu tool's last JSON line
VPD_TPU_KEYS = {
    # vpd_tpu/tools/bench_extract_e2e.py:228-245 (pack_rate with --shards)
    'bench_extract_e2e': {
        'metric', 'value', 'unit', 'decode_only_rate', 'chip_only_rate',
        'chip_busy_fraction', 'batch_size', 'num_crops', 'flow',
        'native_loader', 'host_cores', 'shards', 'upload_codec',
        'shard_codec'},
    # vpd_tpu/tools/bench_train_e2e.py:129-140 (cache_stage_s with the cache)
    'bench_train_e2e': {
        'metric', 'value', 'unit', 'mode', 'batch_size', 'num_crops',
        'arch', 'host_cores'},
    # vpd_tpu/tools/bench_pallas_preprocess.py:145-147, the verdict line
    'bench_pallas_preprocess': {'verdict'},
    # vpd_tpu/tools/bench_ensemble_train.py:79-86
    'bench_ensemble_train': {
        'stage', 'fused_median_s', 'sequential_median_s', 'fused_times',
        'sequential_times', 'speedup'},
    # vpd_tpu/tools/bench_pipeline_e2e.py:319-330, with a
    # recognize_<run>_acc key for each recognize run
    'bench_pipeline_e2e': {
        'metric', 'value', 'unit', 'stages', 'n_crops',
        'train_crops_per_sec', 'extract_crops_per_sec', 'mode',
        'detect_ap_max'},
}
# vpd_tpu/tools/bench_pallas_preprocess.py:116-121,131-136, a timing row
VPD_TPU_PREPROCESS_ROW = {'batch', 'stage', 'xla_crops_per_s',
                          'pallas_crops_per_s', 'pallas_block_b',
                          'pallas_vs_xla'}
PORT_NAMES = {'bench_pallas_preprocess': 'bench_preprocess',
              'xla_crops_per_s': 'plain_crops_per_s',
              'pallas_crops_per_s': 'kernel_crops_per_s',
              'pallas_block_b': 'kernel_variant',
              'pallas_vs_xla': 'kernel_vs_plain'}
PORT_ONLY_KEYS = {'device'}


def ported(keys):
    return {PORT_NAMES.get(k, k) for k in keys} | PORT_ONLY_KEYS


def files_of(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_trees_equal(a, b, skip_ext=()):
    names = files_of(a)
    assert names == files_of(b)
    assert names
    for n in names:
        if not n.endswith(skip_ext):
            assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                               shallow=False), n


def run_tool(module, argv, monkeypatch, capsys):
    """module.main() on argv; its printed JSON lines."""
    monkeypatch.setattr(sys, 'argv', [module.__name__] + argv)
    module.main()
    lines = capsys.readouterr().out.splitlines()
    return [json.loads(line) for line in lines if line.startswith('{')]


# ---------------------------------------------------------------- generators

@pytest.mark.parametrize('flow,crops,size', [
    (False, 9, 24), (True, 9, 24),
    (True, 512, 8)])  # 1,024 files: written by two spawned processes
def test_extract_corpus_is_byte_equal(tmp_path, flow, crops, size):
    for name, mod in (('jax', jext), ('port', text)):
        mod.make_corpus(str(tmp_path / name), 3, crops, size, flow,
                        lambda *a: None)
    assert_trees_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    per_video = crops // 3
    assert len(files_of(str(tmp_path / 'port'))) == \
        3 * per_video * (2 if flow else 1)


def test_ensemble_videos_are_equal():
    jx, jy = jens._synth_videos(np.random.default_rng(0))
    tx, ty = tens._synth_videos(np.random.default_rng(0))
    assert len(tx) == len(jx) == 24
    for a, b in zip(jx + jy, tx + ty):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(frame)
        ok, frame = cap.read()
    cap.release()
    return frames


def test_pipeline_corpus_is_byte_equal(tmp_path):
    outs = {}
    for name, mod in (('jax', jpipe), ('port', tpipe)):
        work = str(tmp_path / name)
        sports, teacher, action, n = mod.make_corpus(
            work, 2, 1, 130, 16, EMB, 2, log=lambda *a: None)
        outs[name] = work, [os.path.relpath(p, work)
                            for p in (sports, teacher, action)], n
    (jwork, jrel, jn), (twork, trel, tn) = outs['jax'], outs['port']
    assert (jrel, jn) == (trel, tn) == (
        ['sports', 'teacher_embs', 'action_dataset'], 3 * 130)
    # crops, masks, teacher pickles, labels and splits: byte for byte
    assert_trees_equal(jwork, twork, skip_ext=('.mp4',))
    names = files_of(twork)
    assert sum(n.endswith('.mask.png') for n in names) == 3 * 130
    assert sum(n.endswith('.emb.pkl') for n in names) == 3
    assert any(n.endswith('train_2_1.ids.txt') for n in names)
    with open(os.path.join(twork, 'teacher_embs',
                           'fs_train_video_00.emb.pkl'), 'rb') as fp:
        rows = pickle.load(fp)
    assert len(rows) == 130 and rows[0][1].shape == (EMB,)
    # the mp4 stubs: the same decoded frames
    for n in names:
        if n.endswith('.mp4'):
            a, b = (_frames(os.path.join(w, n)) for w in (jwork, twork))
            assert len(a) == len(b) == 3
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- the slice

@pytest.mark.parametrize('maker', ['vpd_tpu', 'port'])
def test_model_dir_extracts_alike_in_both_packages(tmp_path, maker):
    """The student dir of either package's make_model_dir, read by both;
    both packages' apply_vpd on one generated corpus, float32."""
    crops = str(tmp_path / 'crops')
    text.make_corpus(crops, 2, 6, IMG, True, lambda *a: None)
    model_dir = str(tmp_path / 'model')
    (jext if maker == 'vpd_tpu' else text).make_model_dir(
        model_dir, 'resnet18', EMB, IMG, True)

    videos, tasks = tapply.scan_crop_dir(crops)
    assert (videos, tasks) == japply.scan_crop_dir(crops)
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'port')
    japply.apply_vpd(videos, tasks, model_dir, jout, flow_img_name='flow',
                     batch_size=4, log=lambda *a: None,
                     prepared=japply.load_student_dir(model_dir,
                                                      dtype=jnp.float32))
    tapply.apply_vpd(videos, tasks, model_dir, tout, flow_img_name='flow',
                     batch_size=4, log=lambda *a: None, device='cpu',
                     prepared=tapply.load_student_dir(
                         model_dir, dtype=torch.float32, device='cpu'))
    assert sorted(os.listdir(jout)) == sorted(os.listdir(tout)) == [
        'video000.emb.pkl', 'video001.emb.pkl']
    for f in os.listdir(jout):
        with open(os.path.join(jout, f), 'rb') as fp:
            want = pickle.load(fp)
        with open(os.path.join(tout, f), 'rb') as fp:
            got = pickle.load(fp)
        assert [r[0] for r in got] == [r[0] for r in want] == [0, 1, 2]
        for (_, g, _), (_, w, _) in zip(got, want):
            assert g.shape == w.shape == (2, EMB) and g.dtype == np.float32
            cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                                     * np.linalg.norm(w, axis=-1))
            assert cos.min() >= COS_BAR, cos


# ---------------------------------------------------------------- the tools

@pytest.mark.parametrize('extra', [['--flow'], ['--shards']])
def test_extract_bench_runs_on_the_cpu(tmp_path, monkeypatch, capsys, extra):
    lines = run_tool(text, TINY + extra + ['--corpus_dir',
                                           str(tmp_path / 'c')],
                     monkeypatch, capsys)
    result = lines[-1]
    want = ported(VPD_TPU_KEYS['bench_extract_e2e'])
    if '--shards' in extra:
        want.add('pack_rate')
    assert set(result) == want
    assert result['num_crops'] == 8 and result['device'] == 'cpu'
    assert result['flow'] == ('--flow' in extra)
    assert 0 < result['chip_busy_fraction'] and result['value'] > 0
    assert sorted(os.listdir(tmp_path / 'c')) == ['video000', 'video001']


@pytest.mark.parametrize('mode', ['png', 'shards'])
def test_train_bench_runs_on_the_cpu(tmp_path, monkeypatch, capsys, mode):
    argv = TINY + ['--batches_per_epoch', '2', '--epochs', '2']
    if mode == 'shards':
        argv.append('--shards')
    result = run_tool(ttrain, argv, monkeypatch, capsys)[-1]
    assert set(result) == ported(VPD_TPU_KEYS['bench_train_e2e'])
    assert result['mode'] == mode and result['value'] > 0


def test_train_bench_needs_two_epochs(monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['x', '--epochs', '1'])
    with pytest.raises(SystemExit, match='epochs must be >= 2'):
        ttrain.main()


def test_preprocess_bench_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, 'argv', ['x', '--device', 'cpu', '--batches',
                                      '2,3', '--rounds', '1', '--img_dim',
                                      '16'])
    tpre.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == '# equality ok on cpu: max|diff|=0.0000'
    rows = [json.loads(line) for line in out[1:]]
    assert [(r['batch'], r['stage']) for r in rows[:-1]] == [
        (2, 'preprocess_only'), (2, 'preprocess_embed'),
        (3, 'preprocess_only'), (3, 'preprocess_embed')]
    for r in rows[:-1]:
        assert set(r) == ported(VPD_TPU_PREPROCESS_ROW)
        assert r['kernel_variant'] is None  # no kernel runs on the CPU
    assert set(rows[-1]) == ported(VPD_TPU_KEYS['bench_pallas_preprocess'])
    assert rows[-1]['verdict'] in ('kernel_wins', 'plain_wins')


def test_ensemble_bench_runs_on_the_cpu(monkeypatch, capsys):
    lines = run_tool(tens, ['--device', 'cpu', '--rounds', '1', '--epochs',
                            '1', '--samples_per_epoch', '100', '--members',
                            '1'], monkeypatch, capsys)
    assert [line.get('stage', line.get('mode')) for line in lines] == [
        'cold', 'fused', 'sequential', 'warm_medians']
    result = lines[-1]
    assert set(result) == ported(VPD_TPU_KEYS['bench_ensemble_train'])
    assert len(result['fused_times']) == len(result['sequential_times']) == 1


def test_chip_smoke_checks_the_ported_keys():
    assert set(chip_smoke.BENCH_KEYS) == {PORT_NAMES.get(t, t)
                                          for t in VPD_TPU_KEYS}
    for tool, keys in VPD_TPU_KEYS.items():
        assert chip_smoke.BENCH_KEYS[PORT_NAMES.get(tool, tool)] == \
            ported(keys), tool
    assert chip_smoke.BENCH_PREPROCESS_ROW_KEYS == ported(
        VPD_TPU_PREPROCESS_ROW)


# ---------------------------------------------------------------- pipeline

def _recorder(calls, work):
    """A run_stage that records the stage's argv (the work dir as WORK)
    and writes what the summary reads: a test_pred.csv per recognize
    run and the detector's AP table."""

    def run_stage(name, argv, env_extra, log=print):
        calls.append((name, [a.replace(work, 'WORK') for a in argv],
                      {k: v.replace(work, 'WORK')
                       for k, v in env_extra.items()}))
        out = argv[argv.index('-o') + 1] if '-o' in argv else None
        if name == 'recognize':
            os.makedirs(out)
            for n, acc in (('trial0_2_dtw', 0.5), ('trial0_full_dtw', 0.75)):
                with open(os.path.join(out, n + '.test_pred.csv'),
                          'w') as fp:
                    fp.write('video,label (acc={})\n'.format(acc))
        elif name == 'detect':
            os.makedirs(out)
            np.save(os.path.join(out, 'ap_table.npy'),
                    np.array([[0.25, 0.5]]))
        return 2.0

    return run_stage


def _port_argv(argv):
    """The port's stage argv without its `--device` pair."""
    out = list(argv)
    if '--device' in out:
        i = out.index('--device')
        del out[i:i + 2]
    return out


@pytest.mark.parametrize('mode', [[], ['--shards'], ['--hbm_cache']])
def test_pipeline_stages_match_vpd_tpu(tmp_path, monkeypatch, capsys, mode):
    common = ['--num_train_videos', '2', '--num_test_videos', '1',
              '--frames', '120', '--img_dim', '8', '--num_epochs', '1',
              '--loc_epochs', '1', '--samples_per_epoch', '8',
              '--seq_len', '32'] + mode
    calls, results = {}, {}
    for name, mod, extra in (('jax', jpipe, []),
                             ('port', tpipe, ['--device', 'cpu'])):
        work = str(tmp_path / name)
        calls[name] = []
        monkeypatch.setattr(mod, 'run_stage', _recorder(calls[name], work))
        monkeypatch.setattr(sys, 'argv', ['x', '--work_dir', work] + common
                            + extra)
        mod.main()
        results[name] = json.loads(capsys.readouterr().out.splitlines()[-1])
    want = [(n, [a.replace('vpd_tpu.', 'vpd_tpu_torch.', 1) for a in argv],
             env) for n, argv, env in calls['jax']]
    got = [(n, _port_argv(argv), env) for n, argv, env in calls['port']]
    assert got == want
    stages = ['train_vpd', 'apply_vpd', 'recognize', 'detect']
    assert [c[0] for c in got] == (['pack_crops'] if mode else []) + stages
    devices = [argv[argv.index('--device') + 1]
               for n, argv, _ in calls['port'] if '--device' in argv]
    assert devices == ['cpu'] * 4  # every stage on a device
    accs = {'recognize_trial0_2_dtw_acc', 'recognize_trial0_full_dtw_acc'}
    assert set(results['jax']) == VPD_TPU_KEYS['bench_pipeline_e2e'] | accs
    assert set(results['port']) == set(results['jax']) | PORT_ONLY_KEYS
    for key in ('n_crops', 'train_crops_per_sec', 'extract_crops_per_sec',
                'mode', 'detect_ap_max', *accs):
        assert results['port'][key] == results['jax'][key], key
    recorded = {k: v for k, v in results['port']['stages'].items()
                if k != 'corpus_s'}
    assert set(results['port']['stages']) == set(results['jax']['stages'])
    assert recorded == {k: 2.0 for k in recorded}
    assert results['port']['device'] == 'cpu'
