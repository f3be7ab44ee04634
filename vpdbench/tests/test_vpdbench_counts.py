"""The FLOP and byte counts against hand counts, and the trace arithmetic
on a small synthetic trace."""

import json
import os

import pytest

from vpdbench import flops
from vpdbench.tests.tiny import REPO
from vpdbench.trace import WINDOW_SPAN, summarize


def config(name, **kw):
    with open(os.path.join(REPO, 'vpdbench', 'configs', name + '.json')) as fp:
        return dict(json.load(fp), **kw)


def resnet34_macs(size, cin, emb):
    """ResNet-34 by hand: a 7x7/2 stem, a 3x3/2 pool, four stages."""
    side = size // 2
    macs = 7 * 7 * cin * 64 * side * side
    side //= 2
    c = 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        out = 64 * 2 ** stage
        if stage:
            side //= 2
        for i in range(blocks):
            first_in = c if i == 0 else out
            macs += 9 * first_in * out * side * side + 9 * out * out * side \
                * side
            if i == 0 and stage:
                macs += first_in * out * side * side  # the projection
        c = out
    return macs + 512 * emb


def b0_macs(size, cin, emb):
    """EfficientNet-b0 by hand from the paper's table (k, n, in, out, e,
    s): expansion, depthwise, squeeze-excite, projection; stem and head."""
    side = size // 2
    macs = 9 * cin * 32 * side * side
    table = [(3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2), (5, 2, 24, 40, 6, 2),
             (3, 3, 40, 80, 6, 2), (5, 3, 80, 112, 6, 1),
             (5, 4, 112, 192, 6, 2), (3, 1, 192, 320, 6, 1)]
    for k, n, cin_, cout, e, s in table:
        for i in range(n):
            c_in = cin_ if i == 0 else cout
            mid = c_in * e
            if e != 1:
                macs += c_in * mid * side * side
            if i == 0 and s == 2:
                side //= 2
            se = max(1, c_in // 4)
            macs += k * k * mid * side * side + 2 * mid * se \
                + mid * cout * side * side
    return macs + 320 * 1280 * side * side + 1280 * emb


MOTION = 32 * 128 + 128 * 128 + 128 * 64


@pytest.mark.parametrize('name,hand', [('vpd-r34-flow-motion', resnet34_macs),
                                       ('vpd-b0-flow-motion', b0_macs)])
def test_forward_flops_match_a_hand_count(name, hand):
    c = config(name)
    assert flops.forward_flops(c, with_motion=False) == 2 * hand(128, 5, 32)
    assert flops.forward_flops(c) == 2 * (hand(128, 5, 32) + MOTION)
    assert flops.train_flops_per_sample(c) == 3 * flops.forward_flops(c)
    assert flops.infer_flops_per_sample(c) == 4 * hand(128, 5, 32)


def test_published_imagenet_counts():
    """At 224 x 224 x 3 with 1,000 classes the counts are the published
    ones: 3.6 G multiply-adds for ResNet-34, 0.39 G for b0."""
    r34 = config('vpd-r34-flow-motion', img_dim=224, in_channels=3,
                 emb_dim=1000, motion=False)
    b0 = config('vpd-b0-flow-motion', img_dim=224, in_channels=3,
                emb_dim=1000, motion=False)
    assert flops.forward_flops(r34) / 2 == pytest.approx(3.66e9, rel=0.01)
    assert flops.forward_flops(b0) / 2 == pytest.approx(0.39e9, rel=0.02)


def test_b1_bytes():
    # 512 crops of 128 x 128: 3 + 3 uint8 channels in, 2 x 5 bf16 out
    assert flops.b1_bytes(512, 128, 3) == 512 * 16384 * (6 + 20)
    assert flops.b1_bytes(512, 128, 3) == 218103808
    assert flops.b1_bytes(4, 16, 2, pair=False, out_channels=3) == \
        4 * 256 * (5 + 6)


def ev(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


def test_trace_summary_on_a_synthetic_trace():
    events = [
        ev('profiler start', 'cpu_op', 0, 5),  # outside the window
        ev(WINDOW_SPAN, 'user_annotation', 100, 100),
        ev('vpdbench.sampler', 'user_annotation', 100, 30),
        ev('vpdbench.step', 'user_annotation', 130, 70),
        ev('k1', 'kernel', 90, 30),  # clipped to [100, 120)
        ev('k2', 'kernel', 110, 20),  # overlaps k1: the union counts once
        ev('Memcpy HtoD', 'gpu_memcpy', 150, 10),
        ev('k1', 'kernel', 170, 20),
        ev('k3', 'kernel', 250, 10),  # after the window
    ]
    s = summarize(events)
    assert s['window_us'] == 100
    assert s['busy_us'] == 30 + 10 + 20
    assert s['kernels'] == {'k1': [2, 40.], 'k2': [1, 20.]}
    assert s['device_ops'][0] == ['k1', 40.]
    # gaps: [130, 150) and [160, 170) in the step, [190, 200) at the end
    assert s['idle_gaps'] == [['vpdbench.step', 20.],
                              ['vpdbench.step', 10.],
                              ['vpdbench.step', 10.]]
    assert summarize(events[2:]) is None
