"""Per-frame action proposal model for temporal detection.

Counterpart of `vpd_tpu/train/proposal.py` (reference `util/proposal.py`):
a 2-layer BiGRU/BiLSTM scores every frame as action or background, trained
on random fixed-length windows sampled length-weighted across videos
(5000 virtual samples an epoch), AdamW (lr 1e-3, weight decay 0.01), a
validation-best snapshot and early termination; `get_proposals`
thresholds scores into runs, merges gaps <= 1 and drops runs of <= 3
frames; `EnsembleProposal` trains k models over KFold(5) splits (the flip
copies of a video stay in one fold via `custom_split`) and averages the
per-frame scores over models x flip variants.

`ProposalTrainer` (one member) and `FusedEnsembleTrainer` (the KFold
members of one batched model, `models/gru.py`) share one loop,
`train_proposal_members`: each member keeps its own initial weights (from
its seed), window samplers (seeds `seed` and `seed + 1`, numpy streams as
vpd_tpu's), dropout stream (`fold_in(seed + 2, step)`), best snapshot and
early stop, decided on the host from the epoch's metrics, read back once;
a stopped member's weights, moments and statistics stay frozen.

Prediction runs the members stacked in one model: one forward per video
scores every member x flip variant. The time axis is not padded to a
bucket: vpd_tpu pads to keep compiled shapes stable, and padding changes
no valid frame's score here (the backward direction flips within each
row's length, and the proposal head pools nothing over time).
"""

import copy

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..core.mesh import all_gather_object, member_axis_placement
from ..models.fc import FlaxDropout, set_dropout_draw
from ..models.flax_weights import proposal_to_flax
from ..models.gru import (BiRNN, FlaxBatchNorm, MemberDense, graphed_rnn,
                          init_member, init_members, member_dropout_draw)
from .classifier import (B1, B2, StackedAdamW, keep_members, restore,
                         snapshot, take_members)
from .vpd import fold_in

NUM_TRAIN_EPOCHS = 25
MIN_TRAIN_EPOCHS = 10
LEARNING_RATE = 1e-3
WEIGHT_DECAY = 0.01


class ProposalSeq(nn.Module):
    """BiRNN -> per-frame 2-class head (`util/proposal.py:16-54`), for M
    members: (M, B, T, D) -> (M, B, T, 2) logits."""

    def __init__(self, cell_type, input_dim, hidden_dim, depth=2,
                 dropout=0.5, input_dropout=0.2, num_members=1, seed=0):
        super().__init__()
        m, h2 = num_members, 2 * hidden_dim
        self.input_dropout = FlaxDropout(input_dropout)
        self.rnn = BiRNN(cell_type, input_dim, hidden_dim, depth, m)
        self.bn0 = FlaxBatchNorm(m, h2)
        self.dense = MemberDense(m, h2, h2)
        self.bn1 = FlaxBatchNorm(m, h2)
        self.out = MemberDense(m, h2, 2)
        self.dropout = FlaxDropout(dropout)
        init_members(self, seed)

    def forward(self, x, lengths):
        x = self.input_dropout(x)
        outputs, _ = self.rnn(x, lengths)
        m, b, t, h2 = outputs.shape
        flat = self.dropout(self.bn0(outputs.reshape(m, b * t, h2)))
        flat = self.dropout(self.bn1(torch.relu(self.dense(flat))))
        return self.out(flat).view(m, b, t, 2)


class _WindowSampler:
    """Random fixed-length windows, videos weighted by spare length
    (`util/proposal.py:56-75`); vpd_tpu's draws, call for call."""

    def __init__(self, X, y, seq_len=250, n=5000, seed=0):
        self.X = X
        self.y = y
        weights = np.array([max(0, len(z) - seq_len) for z in y],
                           dtype=np.float64)
        assert weights.max() > 0, 'All sequences are too short!'
        self.p = weights / weights.sum()
        self.seq_len = seq_len
        self.n = n
        self.rng = np.random.default_rng(seed)

    def batch(self, batch_size):
        xs, ys = [], []
        for _ in range(batch_size):
            idx = self.rng.choice(len(self.y), p=self.p)
            start = self.rng.integers(
                0, len(self.y[idx]) - self.seq_len)
            xs.append(self.X[idx][start:start + self.seq_len])
            ys.append(self.y[idx][start:start + self.seq_len])
        return (np.stack(xs).astype(np.float32),
                np.stack(ys).astype(np.int32))


def frame_losses(logits, y):
    """Per-member mean cross-entropy over the B * T frames of (M, B, T, 2)
    logits, and the correct count: (M,) each."""
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, y[..., None])[..., 0]
    return nll.mean((1, 2)), (logits.argmax(-1) == y).sum((1, 2))


def proposal_step(model, opt, x, lengths, y, lr, wd, bc, live):
    """One train step of M members on window batches x (M, B, T, D), frame
    labels y (M, B, T): forward, per-member mean frame cross-entropy,
    backward and AdamW (lr, wd (M,); bc (2, M) bias corrections; live
    (M,) bool: the others keep their weights, moments and statistics).
    Returns the (M,) losses and correct counts, on the device."""
    buffers = list(model.buffers())
    old = [b.clone() for b in buffers]
    loss, correct = frame_losses(model(x, lengths), y)
    for p in model.parameters():
        p.grad = None
    loss.sum().backward()
    keep_members(buffers, old, live)
    opt.step(lr, wd, bc[0], bc[1], live)
    return loss.detach(), correct


def _batches(samplers, live, batch_size, seq_len, dim):
    """One window batch per live member, (M, B, T, D) and (M, B, T); a
    member that stopped gets zeros (its step is masked)."""
    x = np.zeros((len(samplers), batch_size, seq_len, dim), np.float32)
    y = np.zeros((len(samplers), batch_size, seq_len), np.int64)
    for mi in np.flatnonzero(live):
        x[mi], y[mi] = samplers[mi].batch(batch_size)
    return x, y


def train_proposal_members(model, device, members, batch_size=100,
                           num_epochs=NUM_TRAIN_EPOCHS,
                           min_epochs=MIN_TRAIN_EPOCHS, early_term_acc=1,
                           early_term_no_val_improvement=50, seq_len=250,
                           samples_per_epoch=5000, log=None):
    """Train the M members of a `ProposalSeq` on `device`; members are
    (X_train, y_train, X_val, y_val, seed) specs (X_val None: no
    validation, the member keeps its final state). Each member ends in its
    validation-best state. On CUDA the RNN's train steps run as CUDA
    graphs (`models/gru.graphed_rnn`). `log(epoch, metrics)` gets each
    epoch's per-member sums of step losses and accuracies ('loss', 'acc',
    and with validation 'val_loss', 'val_acc')."""
    m = len(members)
    dim = members[0][0][0].shape[-1]
    dt = next(model.parameters()).dtype
    for mi, spec in enumerate(members):
        init_member(model, mi, spec[4])
    samplers = [_WindowSampler(X, y, seq_len, samples_per_epoch, seed)
                for X, y, _, _, seed in members]
    has_val = members[0][2] is not None
    val_samplers = [_WindowSampler(Xv, yv, seq_len, samples_per_epoch,
                                   seed + 1)
                    for _, _, Xv, yv, seed in members] if has_val else None
    opt = StackedAdamW(model.parameters())
    gens = [torch.Generator(device=device) for _ in range(m)]
    lengths = torch.full((m, batch_size), seq_len, dtype=torch.long,
                         device=device)
    lr = torch.full((m,), LEARNING_RATE, dtype=dt, device=device)
    wd = torch.full((m,), WEIGHT_DECAY, dtype=dt, device=device)
    to_dev = lambda a, t: torch.from_numpy(a).to(  # noqa: E731
        device, t, non_blocking=True)

    best = snapshot(model)
    best_err_loss = [(1., float('inf'))] * m
    best_epoch = np.zeros(m, np.int64)
    live = np.ones(m, bool)
    count = np.zeros(m, np.int64)
    steps_per_epoch = samples_per_epoch // batch_size
    step_i = 0
    with graphed_rnn(model, (m, batch_size, seq_len, dim)):
        for epoch in range(num_epochs):
            live_d = to_dev(live, torch.bool)
            model.train()
            set_dropout_draw(model, member_dropout_draw(gens))
            outs, losses = [], []
            try:
                for _ in range(steps_per_epoch):
                    xb, yb = _batches(samplers, live, batch_size, seq_len,
                                      dim)
                    step_i += 1
                    count += live
                    for g, spec in zip(gens, members):
                        g.manual_seed(fold_in(spec[4] + 2, step_i))
                    bc = to_dev(np.stack([1 - B1 ** count,
                                          1 - B2 ** count]), dt)
                    loss, correct = proposal_step(
                        model, opt, to_dev(xb, dt), lengths,
                        to_dev(yb, torch.long), lr, wd, bc, live_d)
                    outs.append(correct)
                    losses.append(loss)
            finally:
                set_dropout_draw(model, None)
            sums = torch.stack([torch.stack(losses).sum(0), torch.stack(
                outs).sum(0).to(dt)]).cpu().numpy()
            acc = sums[1] / (steps_per_epoch * batch_size * seq_len)
            metrics = {'loss': sums[0], 'acc': acc}

            update = np.zeros(m, bool)
            if has_val:
                model.eval()
                v_outs = []
                with torch.no_grad():
                    # a full virtual val epoch (`util/proposal.py:94-96`)
                    for _ in range(steps_per_epoch):
                        xb, yb = _batches(val_samplers, live, batch_size,
                                          seq_len, dim)
                        loss, correct = frame_losses(
                            model(to_dev(xb, dt), lengths),
                            to_dev(yb, torch.long))
                        v_outs.append(torch.stack([loss, correct.to(dt)]))
                v = torch.stack(v_outs).sum(0).cpu().numpy()
                v_loss, val_acc = v[0], v[1] / (steps_per_epoch * batch_size
                                                * seq_len)
                metrics.update(val_loss=v_loss, val_acc=val_acc)
            if log is not None:
                log(epoch, metrics)
            for mi in np.flatnonzero(live):
                if has_val:
                    if (1 - val_acc[mi], v_loss[mi]) <= best_err_loss[mi]:
                        best_epoch[mi] = epoch
                        best_err_loss[mi] = (1 - val_acc[mi], v_loss[mi])
                        update[mi] = True
                        if 1 - best_err_loss[mi][0] >= early_term_acc \
                                and epoch > min_epochs:
                            live[mi] = False
                    elif (epoch - best_epoch[mi]
                          >= early_term_no_val_improvement
                          and epoch > min_epochs):
                        live[mi] = False
                if live[mi] and epoch >= min_epochs \
                        and acc[mi] > early_term_acc:
                    live[mi] = False
            if update.any():
                take_members(model, best, update)
            if not live.any():
                break
    if has_val:
        restore(model, best)
    return model


def _build(arch_type, members, hidden_dim, device, dtype, **kwargs):
    model = ProposalSeq(arch_type, members[0][0][0].shape[-1], hidden_dim,
                        num_members=len(members), **kwargs)
    return model.to(device, dtype)


def _split_kwargs(kwargs):
    train_keys = ('batch_size', 'num_epochs', 'min_epochs',
                  'early_term_acc', 'early_term_no_val_improvement',
                  'seq_len', 'samples_per_epoch', 'log')
    train = {k: kwargs.pop(k) for k in train_keys if k in kwargs}
    return train, kwargs


class FusedEnsembleTrainer:
    """Train every KFold ensemble member as one batched model. `members`
    is a list of (X_train, y_train, X_val, y_val, seed) fold specs; each
    member matches a `ProposalTrainer` of its spec. `mesh` splits the
    members over its ranks (`core.mesh.member_axis_placement`: padded
    with copies of member 0, a block a rank, no collective while they
    train); at the end every rank gathers every member's state, and
    `model` holds all the real members on each rank."""

    def __init__(self, arch_type, members, hidden_dim, mesh=None,
                 device=None, dtype=torch.float32, **kwargs):
        real_m = len(members)
        mesh, members, put_m, _ = member_axis_placement(mesh, members)
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        train, model_kw = _split_kwargs(dict(kwargs))
        local = put_m(members)
        self.model = train_proposal_members(
            _build(arch_type, local, hidden_dim, self.device, dtype,
                   **model_kw), self.device, local, **train)
        if mesh is not None:
            states = all_gather_object(
                {k: v.cpu() for k, v in self.model.state_dict().items()},
                mesh.data_group)
            self.model = _build(arch_type, members[:real_m], hidden_dim,
                                self.device, dtype, **model_kw)
            self.model.load_state_dict({
                k: torch.cat([st[k] for st in states])[:real_m]
                for k in states[0]})
        self.num_members = real_m

    def member(self, mi):
        tree = proposal_to_flax(self.model, mi)
        return tree['params'], tree['batch_stats']


class ProposalTrainer:
    """Train one proposal model (reference BaseProposalModel)."""

    def __init__(self, arch_type, X, y, hidden_dim, X_val=None, y_val=None,
                 seed=0, device=None, dtype=torch.float32, **kwargs):
        self.device = resolve_device(device)
        train, model_kw = _split_kwargs(dict(kwargs))
        members = [(X, y, X_val, y_val, seed)]
        self.model = train_proposal_members(
            _build(arch_type, members, hidden_dim, self.device, dtype,
                   **model_kw), self.device, members, **train)

    def predict(self, x):
        """Per-frame P(action) for one (T, D) sequence."""
        return ensemble_scores(self.model, [x])[0, 0]


def ensemble_scores(model, xs):
    """P(action) per member, variant and frame, (M, n, T), of variants xs
    of one length (flip copies of one video), in one eval forward."""
    t = len(xs[0])
    assert all(len(x) == t for x in xs), [len(x) for x in xs]
    p = next(model.parameters())
    m = p.shape[0]
    x = torch.from_numpy(np.stack(xs).astype(np.float32)).to(p.device,
                                                             p.dtype)
    lengths = torch.full((m, len(xs)), t, dtype=torch.long, device=p.device)
    with torch.no_grad():
        logits = model.eval()(x[None].expand(m, *x.shape), lengths)
    return torch.softmax(logits, -1)[..., 1].cpu().numpy()


def stack_members(models):
    """One M-member model holding the single members of `models`."""
    stacked = copy.deepcopy(models[0])
    with torch.no_grad():
        for name, t in stacked.state_dict(keep_vars=True).items():
            t.data = torch.cat([x.state_dict()[name] for x in models])
    return stacked


def get_proposals(scores, activation_thresh, min_prop_len=3,
                  merge_thresh=1):
    """Threshold -> runs -> merge gaps -> min length; score = mean
    (`util/proposal.py:175-209`)."""
    props = []
    curr = None
    for i in range(len(scores)):
        if scores[i] >= activation_thresh:
            curr = (i, i) if curr is None else (curr[0], i)
        else:
            if curr is not None:
                props.append(curr)
                curr = None
    if curr is not None:
        props.append(curr)

    merged = []
    for p in props:
        if merged and p[0] - merged[-1][1] <= merge_thresh:
            merged[-1] = (merged[-1][0], p[1])
        else:
            merged.append(p)

    return [(p, float(np.mean(scores[p[0]:p[1] + 1]))) for p in merged
            if p[1] - p[0] > min_prop_len]


class EnsembleProposal:
    """KFold(5) ensemble (`util/proposal.py:212-256`).

    `fused=True` (the default) trains all folds as the members of one
    batched model (`FusedEnsembleTrainer`); `fused=False` trains them one
    by one (`ProposalTrainer`, `--sequential_ensemble` on the CLI). Both
    give the same members. Runs on `device` (None: CUDA)."""

    def __init__(self, arch_type, X, y, hidden_dim, ensemble_size=3,
                 splits=5, custom_split=None, seed=0, fused=True,
                 mesh=None, **kwargs):
        if custom_split is None:
            custom_split = np.arange(len(X))
        unique_idxs = np.array(sorted(set(custom_split)))
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(unique_idxs))

        folds = np.array_split(order, splits)
        specs = []
        for f in range(splits):
            val_set = set(unique_idxs[folds[f]].tolist())
            X_train, y_train, X_val, y_val = [], [], [], []
            for j in range(len(X)):
                if custom_split[j] in val_set:
                    X_val.append(X[j])
                    y_val.append(y[j])
                else:
                    X_train.append(X[j])
                    y_train.append(y[j])
            specs.append((X_train, y_train, X_val, y_val, seed + f))
            if len(specs) >= ensemble_size:
                break

        if fused:
            self.model = FusedEnsembleTrainer(
                arch_type, specs, hidden_dim, mesh=mesh, **kwargs).model
            return
        self.models = [ProposalTrainer(
            arch_type, Xt, yt, hidden_dim, X_val=Xv, y_val=yv, seed=s,
            **kwargs) for Xt, yt, Xv, yv, s in specs]
        self.model = stack_members([t.model for t in self.models])

    def predict_n(self, *xs):
        """Mean per-frame P(action) over members x variants; variants
        must share a length (flip copies of one video)."""
        return ensemble_scores(self.model, xs).mean(axis=(0, 1))

    def predict(self, x):
        return self.predict_n(x)
