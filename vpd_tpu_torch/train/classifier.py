"""Few-shot sequence-classifier training (the recognition heads).

Counterpart of `vpd_tpu/train/classifier.py` (reference `BaseSeqModel`,
`util/classifier.py:185-298`): AdamW with cyclic cosine restarts
(restart period = epochs / 10), cross-entropy over padded sequence
batches, a validation-best snapshot, early termination on train accuracy
or stalled validation.

`SeqModelTrainer` and the fused sweep (`train/fused_sweep.py`) share one
epoch loop, `train_members`, over a model of M members (M = 1 here). Its
semantics are vpd_tpu's, member by member:

* the time axis is padded to a power-of-two bucket (`bucket_len`, min 16)
  of the longest sequence (and a sweep-wide `bucket_floor`): attention
  pooling runs over the padded steps too, so trained weights depend on
  the bucket;
* each epoch draws its permutation from the member's
  `np.random.default_rng(seed)`; a partial batch is padded with the
  member's row 0 and a `valid` mask, which masks the loss and the
  accuracy and reaches the batch norms;
* AdamW (`StackedAdamW`, optax.adamw's arithmetic) takes each step's lr
  and weight decay from `CyclicCosineRestarts` and decays every
  parameter, biases and BN scales included;
* dropout masks come from a generator seeded `fold_in(seed + 1, step)`
  (`train/vpd.fold_in`), as vpd_tpu keys its dropout;
* the metrics of an epoch are read back once, after its last step; an
  epoch's index schedule, lr, weight decay and bias corrections go to
  the device once, before its first, so a step reads nothing back;
* the validation loss is `_evaluate`'s: a mean of per-chunk (batch_size)
  mean losses, the log-softmax computed in numpy; the best epoch is the
  lexicographic `(1 - val_acc, val_loss) <=` minimum; the val-stall break
  fires only on epochs that did not improve; then the train-accuracy
  break.

vpd_tpu's `prewarm_seq_model` only overlaps an XLA compile with the
sweep's host work; the port compiles nothing, so it has no counterpart.
Initial weights come from the port's own generator seeded `seed`
(`models/gru.init_member`); tests carry weights across with
`models/flax_weights`.
"""

import math

import numpy as np
import torch

from ..core.checkpoint import unpackb, variables_to_bytes
from ..core.schedule import CyclicCosineRestarts
from ..models.flax_weights import load_seq_head_from_flax, seq_head_to_flax
from ..models.fc import set_dropout_draw
from ..models.gru import (CNNClassifier, SeqClassifier, graphed_rnn,
                          member_dropout_draw)
from .vpd import fold_in

B1, B2, EPS = 0.9, 0.999, 1e-8


def bucket_len(n):
    """Power-of-two time-axis bucket (min 16). Attention pools over the
    padded steps, so every trainer of a sweep must share one bucket."""
    return max(16, 1 << int(math.ceil(math.log2(max(int(n), 1)))))


def pad_sequences(X, max_len=None):
    """list of (T_i, D) -> (N, T_max, D) float32 + lengths (N,)."""
    lengths = np.array([len(x) for x in X], dtype=np.int32)
    t = int(max_len or lengths.max())
    d = X[0].shape[-1]
    out = np.zeros((len(X), t, d), dtype=np.float32)
    for i, x in enumerate(X):
        n = min(len(x), t)
        out[i, :n] = x[:n]
    return out, np.minimum(lengths, t)


def make_model(arch_type, input_dim, num_classes, hidden_dim, num_members=1,
               seed=0, **kwargs):
    if arch_type == 'cnn':
        return CNNClassifier(input_dim, hidden_dim, num_classes,
                             num_members=num_members, seed=seed, **kwargs)
    return SeqClassifier(arch_type, input_dim, hidden_dim, num_classes,
                         num_members=num_members, seed=seed, **kwargs)


def check_labels(y):
    """The class count of integer labels y, which must be 0..n-1: a label
    past the count (a class whose every sequence lacks embeddings) would
    train a corrupt head, where the reference's cross-entropy fails."""
    num_classes = int(np.unique(np.asarray(y)).shape[0])
    if int(np.max(y)) >= num_classes:
        raise ValueError('label {} out of range for {} classes'.format(
            int(np.max(y)), num_classes))
    return num_classes


def _member_view(t):
    return t.view(t.shape[0], -1)


class StackedAdamW:
    """optax.adamw (b1 0.9, b2 0.999, eps 1e-8, no mask) over parameters
    that carry M members on their leading axis: each member has its own
    lr, weight decay and step count (its bias corrections), and a member
    that is not live keeps its parameters and moments. The update is
    optax's: u = mu_hat / (sqrt(nu_hat) + eps) + wd * p, p += -lr * u."""

    def __init__(self, params):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr, wd, bc1, bc2, live):
        """lr, wd, bc1 = 1 - b1^count, bc2 = 1 - b2^count: (M,) tensors of
        the parameters' dtype; live: (M,) bool."""
        col = lambda t: t[:, None]  # noqa: E731
        keep = col(live)
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            p2, g = _member_view(p), _member_view(p.grad)
            mu2, nu2 = _member_view(mu), _member_view(nu)
            new_mu = (1 - B1) * g + B1 * mu2
            new_nu = (1 - B2) * (g * g) + B2 * nu2
            u = (new_mu / col(bc1)) / (torch.sqrt(new_nu / col(bc2)) + EPS)
            u = u + col(wd) * p2
            p2.copy_(torch.where(keep, p2 + (-col(lr)) * u, p2))
            mu2.copy_(torch.where(keep, new_mu, mu2))
            nu2.copy_(torch.where(keep, new_nu, nu2))


def member_losses(logits, y, valid):
    """Per-member masked mean cross-entropy and correct count of
    (M, B, C) logits: (M,) each."""
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, y[..., None])[..., 0]
    w = valid.to(logits.dtype)
    loss = (nll * w).sum(1) / w.sum(1).clamp(min=1)
    correct = ((logits.argmax(-1) == y) & valid).sum(1)
    return loss, correct


def evaluate_logits(logits, y, batch_size):
    """`_evaluate` of vpd_tpu's trainer on host logits (N, C): the mean of
    per-chunk mean losses (log-softmax in numpy) and the accuracy."""
    total_loss, correct = 0., 0
    for i in range(0, len(logits), batch_size):
        out, ys = logits[i:i + batch_size], y[i:i + batch_size]
        logp = out - np.log(np.sum(np.exp(
            out - out.max(1, keepdims=True)), 1, keepdims=True)) \
            - out.max(1, keepdims=True)
        total_loss += float(-np.mean(logp[np.arange(len(ys)), ys]))
        correct += int(np.sum(np.argmax(out, 1) == ys))
    num_batches = math.ceil(len(logits) / batch_size)
    return total_loss / max(num_batches, 1), correct / len(logits)


def predict_logits(model, xs, lengths):
    """Eval-mode logits (M, N, C) of (N, T, D) inputs shared by every
    member, as a host array."""
    m = model.out.kernel.shape[0]
    with torch.no_grad():
        out = model.eval()(xs[None].expand(m, *xs.shape),
                           lengths[None].expand(m, -1))
    return out.cpu().numpy()


def snapshot(model):
    """A copy of every tensor of `model` (a best-epoch snapshot)."""
    return [t.detach().clone() for t in model.state_dict().values()]


@torch.no_grad()
def take_members(model, best, update):
    """Copy the members in `update` (host bool (M,)) of `model` into the
    snapshot `best`."""
    keep = torch.from_numpy(update).to(best[0].device)[:, None]
    for b, t in zip(best, model.state_dict().values()):
        _member_view(b).copy_(torch.where(keep, _member_view(t),
                                          _member_view(b)))


@torch.no_grad()
def restore(model, best):
    for b, t in zip(best, model.state_dict().values()):
        t.copy_(b)


@torch.no_grad()
def keep_members(tensors, old, live):
    """Put back `old` values of the members that are not `live` ((M,)
    bool on the device): their statistics must not move either."""
    for t, o in zip(tensors, old):
        _member_view(t).copy_(torch.where(live[:, None], _member_view(t),
                                          _member_view(o)))


class _Epochs:
    """Host state of M members (schedules, RNG streams, step counts, which
    are live) and their epoch on the device."""

    def __init__(self, model, device, pool, member_rows, batch_size,
                 num_epochs, wr_count, learning_rate, seed):
        self.model, self.device = model, device
        self.pool_x, self.pool_len, self.pool_y = pool
        self.rows = [np.asarray(r, np.int64) for r in member_rows]
        m = len(self.rows)
        self.n = np.array([len(r) for r in self.rows], np.int64)
        self.batch_size = batch_size
        self.scheds = [CyclicCosineRestarts(
            learning_rate, 0.01, batch_size, int(n),
            restart_period=max(1, num_epochs // wr_count)) for n in self.n]
        self.rngs = [np.random.default_rng(seed) for _ in range(m)]
        # steps taken: the dropout stream's position and AdamW's count
        self.count = np.zeros(m, np.int64)
        self.live = np.ones(m, bool)
        self.dropout_seed = seed + 1
        self.opt = StackedAdamW(model.parameters())
        self.gens = [torch.Generator(device=device) for _ in range(m)]

    def schedule(self):
        """This epoch's steps for every live member: indices (S, M, B),
        valid (S, M, B), dropout seeds (S, M) and per-step scalars
        (S, 5, M): lr, wd, bc1, bc2, live."""
        m, b = len(self.rows), self.batch_size
        steps = np.where(self.live, np.ceil(self.n / b), 0).astype(int)
        s_max = max(int(steps.max()), 1)
        idx = np.zeros((s_max, m, b), np.int64)
        valid = np.zeros((s_max, m, b), bool)
        seeds = np.zeros((s_max, m), np.int64)
        # lr and weight decay go in as float32, as vpd_tpu's step gets them
        lr = np.ones((s_max, m), np.float32)
        wd = np.zeros((s_max, m), np.float32)
        bc = np.ones((s_max, 2, m))
        live = np.zeros((s_max, m), bool)
        for mi in np.flatnonzero(self.live):
            sched = self.scheds[mi]
            sched.epoch_start()
            order = self.rngs[mi].permutation(self.n[mi])
            for s, i in enumerate(range(0, self.n[mi], b)):
                sel = order[i:i + b]
                idx[s, mi, :len(sel)] = self.rows[mi][sel]
                idx[s, mi, len(sel):] = self.rows[mi][0]
                valid[s, mi, :len(sel)] = True
                self.count[mi] += 1
                seeds[s, mi] = fold_in(self.dropout_seed, self.count[mi])
                lr[s, mi], wd[s, mi] = sched.lr, sched.weight_decay
                bc[s, :, mi] = (1 - B1 ** self.count[mi],
                                1 - B2 ** self.count[mi])
                live[s, mi] = True
                sched.batch_step()
        scalars = np.concatenate([lr[:, None], wd[:, None], bc,
                                  live[:, None]], 1)
        return idx, valid, seeds, scalars

    def device_epoch(self):
        """Train every live member one epoch: the host schedule goes to
        the device first, then the steps run without reading anything
        back. Returns the (2, M) loss sums and correct counts, on the
        device."""
        idx, valid, seeds, scalars = self.schedule()
        dt = self.pool_x.dtype
        to_dev = lambda a, t: torch.from_numpy(a).to(  # noqa: E731
            self.device, t, non_blocking=True)
        idx_d, valid_d = to_dev(idx, torch.long), to_dev(valid, torch.bool)
        scal_d = to_dev(scalars, dt)
        model = self.model.train()
        set_dropout_draw(model, member_dropout_draw(self.gens))
        losses, corrects = [], []
        try:
            for s in range(len(idx)):
                for g, sd in zip(self.gens, seeds[s].tolist()):
                    g.manual_seed(sd)
                rows = idx_d[s]
                loss, correct = train_step(
                    model, self.opt, self.pool_x[rows], self.pool_len[rows],
                    self.pool_y[rows], valid_d[s], scal_d[s])
                live = scal_d[s, 4] > 0
                losses.append(torch.where(live, loss, 0.))
                corrects.append(torch.where(live, correct, 0))
        finally:
            set_dropout_draw(model, None)
        return torch.stack([torch.stack(losses).sum(0),
                            torch.stack(corrects).sum(0).to(dt)])

    def run_epoch(self):
        """`device_epoch`, read back once: (loss sums, correct counts)."""
        out = self.device_epoch().cpu().numpy()
        return out[0], out[1]


def train_step(model, opt, x, lengths, y, valid, scalars):
    """One step of M members in train mode: forward, per-member masked
    cross-entropy, backward and `StackedAdamW`. scalars: (5, M) lr, wd,
    bc1, bc2 and live (> 0). A member that is not live keeps its weights,
    moments and running statistics. Returns the (M,) losses and correct
    counts, on the device."""
    buffers = list(model.buffers())
    old = [b.clone() for b in buffers]
    logits = model(x, lengths, valid)
    loss, correct = member_losses(logits, y, valid)
    for p in model.parameters():
        p.grad = None
    loss.sum().backward()
    live = scalars[4] > 0
    keep_members(buffers, old, live)
    opt.step(*scalars[:4], live)
    return loss.detach(), correct


def train_members(model, device, pool, member_rows, batch_size=50,
                  num_epochs=500, min_epochs=10, wr_count=10,
                  early_term_acc=1, val=None, val_freq=1,
                  early_term_val_num_epochs=200, learning_rate=0.001,
                  seed=0, log=None):
    """Train the M members of `model` (on `device`) on their rows of the
    pool; each member keeps the validation-best state when `val` is given,
    else its final one. pool: (X (N, T, D), lengths (N,), y (N,)) tensors
    on `device`; member_rows: M index lists into the pool; val: (X, lengths,
    y numpy) tensors and labels of the validation set. `log(epoch, losses,
    accs)` gets each epoch's per-member mean loss and accuracy (NaN for a
    member that did not train or stalled in it). On CUDA the RNN's train
    steps run as CUDA graphs (`models/gru.graphed_rnn`): the same
    arithmetic, launched at once. Returns (best_epoch, stopped) per
    member."""
    ep = _Epochs(model, device, pool, member_rows, batch_size, num_epochs,
                 wr_count, learning_rate, seed)
    m = len(member_rows)
    best = None
    best_err_loss = [(1., float('inf'))] * m
    best_epoch = np.zeros(m, np.int64)
    improved_ever = np.zeros(m, bool)
    shape = (m, batch_size) + tuple(pool[0].shape[1:])
    input_grad = getattr(model, 'input_bn', None) is not None
    with graphed_rnn(model, shape, input_grad):
        for epoch in range(num_epochs):
            live = ep.live.copy()
            loss_sum, correct = ep.run_epoch()
            acc = correct / ep.n
            stall = np.zeros(m, bool)
            if val is not None and epoch % val_freq == 0:
                if best is None:
                    best = snapshot(model)
                logits = predict_logits(model, val[0], val[1])
                update = np.zeros(m, bool)
                for mi in np.flatnonzero(live):
                    v_loss, v_acc = evaluate_logits(logits[mi], val[2],
                                                    batch_size)
                    if (1 - v_acc, v_loss) <= best_err_loss[mi]:
                        best_epoch[mi] = epoch
                        best_err_loss[mi] = (1 - v_acc, v_loss)
                        update[mi] = improved_ever[mi] = True
                    elif (early_term_val_num_epochs > 0 and
                          epoch - early_term_val_num_epochs > best_epoch[mi]):
                        stall[mi] = True
                if update.any():
                    take_members(model, best, update)
            if log is not None:
                # a member that stalled stops before its epoch is logged
                log(epoch, np.where(live & ~stall, loss_sum / ep.n, np.nan),
                    np.where(live & ~stall, acc, np.nan))
            ep.live = live & ~stall & ~((epoch >= min_epochs)
                                        & (acc > early_term_acc))
            if not ep.live.any():
                break
    if best is not None and improved_ever.any():
        # a member never improved (NaN losses) keeps its final state
        take_members(model, best, ~improved_ever)
        restore(model, best)
    return best_epoch, ~ep.live


def to_pool(X, y, max_len, device, dtype):
    Xp, lens = pad_sequences(X, max_len)
    return (torch.from_numpy(Xp).to(device, dtype),
            torch.from_numpy(lens).to(device, torch.long),
            torch.from_numpy(np.asarray(y, np.int64)).to(device))


class SeqModelTrainer:
    """Train + predict wrapper (reference BaseSeqModel semantics).

    Runs on `device` (None: CUDA) in `dtype` (float32; float64 for
    parity tests). `preset` is a (params, batch_stats) pair of flax trees
    trained elsewhere
    (`FusedSweepTrainer.member`) and `load_weights` a saved head file:
    both skip training."""

    def __init__(self, arch_type, X, y, hidden_dim, batch_size=50,
                 num_epochs=500, min_epochs=10, wr_count=10,
                 early_term_acc=1, X_val=None, y_val=None, val_freq=1,
                 early_term_val_num_epochs=200, learning_rate=0.001,
                 load_weights=None, preset=None, seed=0, log=None,
                 bucket_floor=None, device=None, dtype=torch.float32,
                 **kwargs):
        from .. import resolve_device

        self.device = resolve_device(device)
        self.num_classes = check_labels(y)
        self.batch_size = batch_size
        self.model = make_model(arch_type, X[0].shape[-1], self.num_classes,
                                hidden_dim, seed=seed, **kwargs).to(
                                    self.device, dtype)
        if load_weights is not None:
            self.load(load_weights)
            return
        if preset is not None:
            params, batch_stats = preset
            load_seq_head_from_flax(self.model, {'params': params,
                                                 'batch_stats': batch_stats})
            return

        max_len = bucket_len(max(
            max(len(x) for x in X),
            max((len(x) for x in (X_val or [])), default=0),
            bucket_floor or 0))
        pool = to_pool(X, y, max_len, self.device, dtype)
        val = None
        if X_val is not None:
            xv, lv, _ = to_pool(X_val, y_val, max_len, self.device, dtype)
            val = (xv, lv, np.asarray(y_val, np.int64))
        train_members(
            self.model, self.device, pool, [np.arange(len(X))],
            batch_size=batch_size, num_epochs=num_epochs,
            min_epochs=min_epochs, wr_count=wr_count,
            early_term_acc=early_term_acc, val=val, val_freq=val_freq,
            early_term_val_num_epochs=early_term_val_num_epochs,
            learning_rate=learning_rate, seed=seed,
            log=None if log is None else (
                lambda e, loss, acc: np.isnan(loss[0]) or log(
                    e, float(loss[0]), float(acc[0]))))

    # -- prediction (reference predict/predict_n) ---------------------------

    def predict_probs(self, xs):
        """Class probabilities (N, C) of a list of (T_i, D) sequences, each
        padded to its own bucket (as `predict` pads one), one batched
        forward per bucket."""
        dt = self.model.out.kernel.dtype
        probs = np.zeros((len(xs), self.num_classes))
        groups = {}
        for i, x in enumerate(xs):
            groups.setdefault(bucket_len(len(x)), []).append(i)
        for bucket, ids in sorted(groups.items()):
            xp, lens = pad_sequences([np.asarray(xs[i]) for i in ids],
                                     max_len=bucket)
            out = predict_logits(
                self.model, torch.from_numpy(xp).to(self.device, dt),
                torch.from_numpy(lens).to(self.device, torch.long))[0]
            p = np.exp(out - out.max(1, keepdims=True))
            probs[ids] = p / p.sum(1, keepdims=True)
        return probs

    def predict(self, x, full=False):
        probs = self.predict_probs([x])[0]
        if full:
            return probs
        cls = int(np.argmax(probs))
        return cls, float(probs[cls])

    def predict_n(self, *xs):
        scores = self.predict_probs(xs).mean(0)
        cls = int(np.argmax(scores))
        return cls, float(scores[cls])

    # -- persistence (reference BaseSeqModel.save / load_weights) ----------

    def variables(self):
        """The head as flax `{'params', 'batch_stats'}`."""
        return seq_head_to_flax(self.model)

    def save(self, out_path):
        with open(out_path, 'wb') as fp:
            fp.write(variables_to_bytes(self.variables()))

    def load(self, path):
        with open(path, 'rb') as fp:
            load_seq_head_from_flax(self.model, unpackb(fp.read()))
