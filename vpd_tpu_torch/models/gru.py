"""Recurrent and convolutional heads on frozen embeddings: recognition
(`SeqClassifier`, `CNNClassifier`) and, through `BiRNN`, the per-frame
proposal model of `train/proposal.py`.

Counterpart of `vpd_tpu/models/gru.py` (reference `util/classifier.py:
29-134`). Every module here holds M independent copies of its weights
along a leading member axis and runs them as one batch: inputs are
(M, B, T, D) with lengths (M, B), and each matrix product is a batched
`baddbmm` over the M members. The sequential trainers use M = 1 and the
fused ones (the few-shot sweep, the KFold proposal ensemble) M > 1, so
both run the same arithmetic. `torch.func.vmap` has no batching rule for
cuDNN's RNN kernels, hence the explicit cells.

`BiRNN` runs both directions of a layer as one (2M, B, ·) batch in a time
loop over an explicit cell: the input projections of every step are one
batched product before the loop; each step is one `baddbmm` for the
recurrent projections and the gate arithmetic. The loop is bound by its
launches, so the trainers run its train forward and backward on the card
as two CUDA graphs (`graphed_rnn`). GRU and LSTM cells carry
torch's double bias (an input and a recurrent bias per gate, QUIRKS.md),
and the GRU's recurrent `n` bias sits inside `r * (...)`, as in torch. The
backward direction flips each row within its own length (flax's
`flip_sequences`: the padding stays at the end), so it starts at the last
valid step; each direction's carry is read at the row's last valid step,
and the outputs are zeroed at padding after the last layer only.
`last_state` is (M, 2 * depth, B, H), layer-major and direction-minor, and
holds an LSTM's h, not its c.

Parity quirks kept on purpose, since trained heads depend on them:
attention pooling is a softmax over ALL bucket steps, padded ones
included (their outputs are zero, so their logits are exactly 0;
QUIRKS.md), max pooling masks padding with -inf, and the CNN's max over
time masks nothing.

Three batch-norm semantics, all with flax's momentum convention (0.9
keeps the old value):
* `MaskedBatchNorm` (the optional input BN) normalises with the biased
  variance over valid steps of valid rows and updates its running
  statistics with the unbiased one, and only when more than one element
  counts;
* `TorchBatchNorm` (the classifier's FC head) keeps torch's unbiased
  running variance, weighted by the `valid` rows;
* `FlaxBatchNorm` (the proposal head) is flax's `nn.BatchNorm`: biased
  running variance.

Weights start as flax's initializers draw them (truncated lecun normal
kernels, orthogonal recurrent kernels, zero biases) from a generator
seeded per member (`init_member`); `models/flax_weights.py` maps them to
and from vpd_tpu's flax trees. Dropout is `models/fc.FlaxDropout`; its
mask source draws each member's mask from that member's generator.
"""

import contextlib
import gc
import math

import torch
import torch.nn.functional as F
from torch import nn

from .fc import FlaxDropout

FLAX_MOMENTUM = 0.9
BN_EPS = 1e-5


def length_mask(lengths, max_len):
    """(..., B) lengths -> (..., B, T) bool validity mask."""
    return torch.arange(max_len, device=lengths.device) < lengths[..., None]


# ------------------------------------------------------------ initializers

def lecun_normal(shape, fan_in):
    """flax's lecun_normal: a normal truncated at 2 standard deviations,
    rescaled to variance 1 / fan_in."""
    std = fan_in ** -0.5 / .87962566103423978

    def init(gen):
        lo, hi = torch.special.ndtr(torch.tensor([-2., 2.],
                                                 dtype=torch.float64))
        u = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                        dtype=torch.float64)
        return torch.special.ndtri(u) * std
    return init


def orthogonal(shape):
    """flax's orthogonal initializer (column axis last)."""
    cols = shape[-1]
    rows = math.prod(shape) // cols

    def init(gen):
        a = torch.randn(max(rows, cols), min(rows, cols), generator=gen,
                        dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        return (q.T if rows < cols else q).reshape(shape)
    return init


def constant(shape, value):
    return lambda gen: torch.full(shape, float(value), dtype=torch.float64)


def init_member(model, member, seed):
    """Draw member `member`'s weights of `model` from a generator seeded
    `seed` (the same seed gives the same member at any M), and reset its
    running statistics."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            for name, init in getattr(mod, 'member_inits', {}).items():
                t = getattr(mod, name)
                t.view(t.shape[0], -1)[member] = init(gen).reshape(-1).to(t)
    return model


def init_members(model, seed):
    """Every member of `model` from the same seed."""
    for m in range(next(model.parameters()).shape[0]):
        init_member(model, m, seed)
    return model


def member_dropout_draw(generators):
    """A `FlaxDropout` mask source for stacked inputs (M, ...): member m's
    keep mask comes from `generators[m]`, so it is the mask a model of one
    member would draw from that generator."""
    def draw(shape, keep, device):
        return torch.stack([torch.rand(shape[1:], generator=g, device=device)
                            < keep for g in generators])
    return draw


# ----------------------------------------------------------------- layers

class MemberDense(nn.Module):
    """flax's Dense for M members: kernel (M, I, O), bias (M, O)."""

    def __init__(self, num_members, in_dim, out_dim):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(num_members, in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(num_members, out_dim))
        self.member_inits = {'kernel': lecun_normal((in_dim, out_dim), in_dim),
                             'bias': constant((out_dim,), 0)}

    def forward(self, x):
        m, o = self.kernel.shape[0], self.kernel.shape[2]
        y = torch.baddbmm(self.bias[:, None], x.reshape(m, -1, x.shape[-1]),
                          self.kernel)
        return y.view(*x.shape[:-1], o)


class MemberConv1d(nn.Module):
    """flax's `Conv` over (B, T, D) with VALID padding, for M members as one
    grouped `conv1d` on (B, M * D, T). The weight is (M, H, D, k), torch's
    layout per member (flax's kernel is (k, D, H))."""

    def __init__(self, num_members, in_dim, out_dim, kernel, stride=1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            torch.zeros(num_members, out_dim, in_dim, kernel))
        self.bias = nn.Parameter(torch.zeros(num_members, out_dim))
        flax_init = lecun_normal((kernel, in_dim, out_dim), kernel * in_dim)
        self.member_inits = {
            'weight': lambda gen: flax_init(gen).permute(2, 1, 0),
            'bias': constant((out_dim,), 0)}

    def forward(self, x):
        """(B, M * D, T) -> (B, M * H, T')."""
        m, h, d, k = self.weight.shape
        return F.conv1d(x, self.weight.reshape(m * h, d, k),
                        self.bias.reshape(-1), stride=self.stride, groups=m)


class _MemberBatchNorm(nn.Module):
    """Scale/bias (M, D) and running mean/var (M, D) of M members."""

    def __init__(self, num_members, dim, momentum=FLAX_MOMENTUM, eps=BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_members, dim))
        self.bias = nn.Parameter(torch.zeros(num_members, dim))
        self.register_buffer('running_mean', torch.zeros(num_members, dim))
        self.register_buffer('running_var', torch.ones(num_members, dim))
        self.member_inits = {'weight': constant((dim,), 1),
                             'bias': constant((dim,), 0),
                             'running_mean': constant((dim,), 0),
                             'running_var': constant((dim,), 1)}

    def _stats_shape(self, x, t):
        """(M, D) statistics broadcast against x of (M, ..., D)."""
        return t.view(t.shape[0], *[1] * (x.dim() - 2), t.shape[1])

    def _normalize(self, x, mean, var):
        view = lambda t: self._stats_shape(x, t)  # noqa: E731
        return (x - view(mean)) / torch.sqrt(view(var) + self.eps) \
            * view(self.weight) + view(self.bias)

    def _eval(self, x):
        return self._normalize(x, self.running_mean, self.running_var)

    @torch.no_grad()
    def _update(self, mean, var, use=None):
        m = self.momentum
        new_mean = m * self.running_mean + (1 - m) * mean
        new_var = m * self.running_var + (1 - m) * var
        if use is not None:
            new_mean = torch.where(use, new_mean, self.running_mean)
            new_var = torch.where(use, new_var, self.running_var)
        self.running_mean.copy_(new_mean)
        self.running_var.copy_(new_var)


class MaskedBatchNorm(_MemberBatchNorm):
    """BatchNorm over (M, B, T, D) counting only valid steps of valid rows
    (reference `util/torch/batchnorm1d.py:29-93`)."""

    def forward(self, x, lengths, valid=None):
        if not self.training:
            return self._eval(x)
        mask = length_mask(lengths, x.shape[2])
        if valid is not None:
            # rows padded onto a partial batch must not count
            mask = mask & valid[..., None]
        mask = mask[..., None].to(x.dtype)
        n = mask.sum((1, 2))                                   # (M, 1)
        nc = n.clamp(min=1)
        bmean = (x * mask).sum((1, 2)) / nc
        bvar = (torch.square(x - bmean[:, None, None]) * mask).sum((1, 2)) / nc
        # batch statistics apply (and update the running ones) only when
        # n > 1; the running variance takes the UNBIASED one
        use = n > 1
        old_mean = self.running_mean.clone()
        old_var = self.running_var.clone()
        self._update(bmean, bvar * (n / (n - 1).clamp(min=1)), use)
        return self._normalize(x, torch.where(use, bmean, old_mean),
                               torch.where(use, bvar, old_var))


class TorchBatchNorm(_MemberBatchNorm):
    """BatchNorm over (M, B, D) with torch's running statistics: the
    unbiased variance (factor n / (n - 1)) over the `valid` rows."""

    def forward(self, x, valid=None):
        if not self.training:
            return self._eval(x)
        if valid is None:
            n = x.shape[1]
            unbias = n / max(n - 1, 1)
            mean = x.mean(1)
            var = torch.square(x - mean[:, None]).mean(1)
        else:
            # partial batches are padded with duplicate rows: statistics
            # cover the real rows only, as torch sees the true-sized batch
            w = valid.to(x.dtype)[..., None]
            n = w.sum(1)
            unbias = n / (n - 1).clamp(min=1)
            mean = (x * w).sum(1) / n
            var = (torch.square(x - mean[:, None]) * w).sum(1) / n
        self._update(mean, var * unbias)
        return self._normalize(x, mean, var)


class FlaxBatchNorm(_MemberBatchNorm):
    """flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over (M, N, D):
    the biased batch variance, in the running statistics too."""

    def forward(self, x):
        if not self.training:
            return self._eval(x)
        mean = x.mean(1)
        var = torch.square(x - mean[:, None]).mean(1)
        self._update(mean, var)
        return self._normalize(x, mean, var)


# -------------------------------------------------------------------- RNN

# gate blocks of the fused projections, in flax's parameter names
GATES = {'gru': (('ir', 'hr'), ('iz', 'hz'), ('in', 'hn')),
         # sigmoid gates first, then the tanh one
         'lstm': (('ii', 'hi'), ('if', 'hf'), ('io', 'ho'), ('ig', 'hg'))}


class BiRNNLayer(nn.Module):
    """Both directions of one layer for M members: w_i (M, 2, Din, G * H),
    w_h (M, 2, H, G * H), biases (M, 2, G * H), the gates in `GATES`
    order."""

    def __init__(self, cell_type, num_members, in_dim, hidden_dim):
        super().__init__()
        self.cell_type = cell_type
        self.hidden_dim = h = hidden_dim
        g = len(GATES[cell_type])
        self.w_i = nn.Parameter(torch.zeros(num_members, 2, in_dim, g * h))
        self.b_i = nn.Parameter(torch.zeros(num_members, 2, g * h))
        self.w_h = nn.Parameter(torch.zeros(num_members, 2, h, g * h))
        self.b_h = nn.Parameter(torch.zeros(num_members, 2, g * h))
        w_i = lecun_normal((in_dim, h), in_dim)
        w_h = orthogonal((h, h))
        self.member_inits = {
            'w_i': lambda gen: torch.stack([torch.cat(
                [w_i(gen) for _ in range(g)], 1) for _ in range(2)]),
            'b_i': constant((2, g * h), 0),
            'w_h': lambda gen: torch.stack([torch.cat(
                [w_h(gen) for _ in range(g)], 1) for _ in range(2)]),
            'b_h': constant((2, g * h), 0)}

    def forward(self, x):
        """(2M, B, T, Din), directions member-minor -> outputs (2M, B, T, H)
        in processing order."""
        m2, b, t, d = x.shape
        h = self.hidden_dim
        gh_w = self.w_h.reshape(m2, h, -1)
        gh_b = self.b_h.reshape(m2, 1, -1)
        gi = torch.baddbmm(self.b_i.reshape(m2, 1, -1),
                           x.reshape(m2, b * t, d),
                           self.w_i.reshape(m2, d, -1))
        gi = gi.view(m2, b, t, -1).permute(2, 0, 1, 3)     # (T, 2M, B, G*H)
        # one view a step (unbind's backward stacks the steps' gradients
        # once, where indexing would add a full-size tensor a step)
        sig, tan = (gi[..., :-h].unbind(0), gi[..., -h:].unbind(0))
        state = x.new_zeros(m2, b, h)
        c = x.new_zeros(m2, b, h)
        outs = []
        for step in range(t):
            gh_sig, gh_tan = torch.baddbmm(gh_b, state, gh_w).split(
                [gh_w.shape[-1] - h, h], -1)
            if self.cell_type == 'gru':
                r, z = torch.sigmoid(sig[step] + gh_sig).split(h, -1)
                n = torch.tanh(torch.addcmul(tan[step], r, gh_tan))
                state = torch.lerp(n, state, z)     # (1 - z) * n + z * h
            else:
                i, f, o = torch.sigmoid(sig[step] + gh_sig).split(h, -1)
                c = torch.addcmul(f * c, i, torch.tanh(tan[step] + gh_tan))
                state = o * torch.tanh(c)
            outs.append(state)
        return torch.stack(outs, 2)


class BiRNN(nn.Module):
    """Multi-layer bidirectional GRU/LSTM over padded (M, B, T, D) inputs.

    Returns (outputs (M, B, T, 2H) zeroed at padding, last_state
    (M, 2 * depth, B, H)), torch's h_n layout per member."""

    def __init__(self, cell_type, input_dim, hidden_dim, depth=2,
                 num_members=1):
        super().__init__()
        if cell_type not in GATES:
            raise NotImplementedError(cell_type)
        self.cell_type = cell_type
        self.hidden_dim = hidden_dim
        self.layers = nn.ModuleList(
            BiRNNLayer(cell_type, num_members,
                       input_dim if i == 0 else 2 * hidden_dim, hidden_dim)
            for i in range(depth))

    def forward(self, x, lengths):
        m, b, t, _ = x.shape
        lengths = lengths.to(torch.long)
        steps = torch.arange(t, device=x.device)
        # flax's flip_sequences: reverse each row within its length
        flip = ((t - 1 - steps + lengths[..., None]) % t)[..., None]
        # the carry of a row is the output at its last valid step
        last = ((lengths - 1) % t)[:, None, :, None, None].expand(
            m, 2, b, 1, 1).reshape(2 * m, b, 1, 1)
        states = []
        for layer in self.layers:
            both = torch.stack([x, torch.take_along_dim(x, flip, 2)], 1)
            out = layer(both.reshape(2 * m, b, t, -1))        # (2M, B, T, H)
            states.append(torch.take_along_dim(
                out, last.expand(-1, -1, 1, out.shape[-1]), 2).view(
                    m, 2, b, -1))
            out = out.view(m, 2, b, t, -1)
            x = torch.cat([out[:, 0],
                           torch.take_along_dim(out[:, 1], flip, 2)], -1)
        outputs = x * length_mask(lengths, t)[..., None].to(x.dtype)
        last_state = torch.stack(states, 1).view(m, -1, b, self.hidden_dim)
        return outputs, last_state


@contextlib.contextmanager
def graphed_rnn(model, shape, input_grad=False):
    """While inside, run the train-mode forward and backward of
    `model.rnn` on the card as two CUDA graphs for inputs of `shape`
    (M, B, T, D): each a single replay in place of thousands of small
    kernels launched from Python (the time loop is bound by their
    launches). Eval mode, and every other shape in train mode's place,
    must not reach the graphed module: eval runs the module as written.
    On exit the module's own forward comes back, so the model leaves as
    it came (a copy of it runs its own weights). On the CPU, or for a
    model without an RNN, nothing changes. `input_grad`: whether the
    RNN's input needs a gradient (an input batch norm before it)."""
    rnn = getattr(model, 'rnn', None)
    p = None if rnn is None else next(rnn.parameters())
    if p is None or p.device.type != 'cuda':
        yield model
        return
    x = torch.zeros(shape, dtype=p.dtype, device=p.device,
                    requires_grad=input_grad)
    lengths = torch.full(shape[:2], shape[2], dtype=torch.long,
                         device=p.device)
    rnn.train()
    # A cyclic collection during the captures can run a finalizer whose
    # CUDA call a capture forbids, which invalidates it (the sixth
    # capture of a proposal ensemble's run failed so on an H100): collect
    # now and keep the collector off until both graphs are captured.
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        # sets an instance attribute `forward` that replays the graphs
        torch.cuda.make_graphed_callables(rnn, (x, lengths),
                                          num_warmup_iters=2)
    finally:
        if collecting:
            gc.enable()
    try:
        yield model
    finally:
        del rnn.forward


# ------------------------------------------------------------------ heads

class SeqClassifier(nn.Module):
    """BiRNN + (attention | max) pooling + BN/dropout FC head
    (`_ABCSeqModel.Seq`, reference `util/classifier.py:29-101`)."""

    def __init__(self, cell_type, input_dim, hidden_dim, num_classes,
                 depth=2, dropout=0.5, input_dropout=0.2,
                 input_batchnorm=False, use_attention=True, num_members=1,
                 seed=0):
        super().__init__()
        m, h2 = num_members, 2 * hidden_dim
        self.use_attention = use_attention
        self.input_dropout = FlaxDropout(input_dropout)
        self.input_bn = (MaskedBatchNorm(m, input_dim) if input_batchnorm
                         else None)
        self.rnn = BiRNN(cell_type, input_dim, hidden_dim, depth, m)
        self.attn = (MemberDense(m, 2 * depth * hidden_dim, h2)
                     if use_attention else None)
        self.bn0 = TorchBatchNorm(m, h2)
        self.dense = MemberDense(m, h2, h2)
        self.bn1 = TorchBatchNorm(m, h2)
        self.out = MemberDense(m, h2, num_classes)
        self.dropout = FlaxDropout(dropout)
        init_members(self, seed)

    def forward(self, x, lengths, valid=None):
        x = self.input_dropout(x)
        if self.input_bn is not None:
            x = self.input_bn(x, lengths, valid)
        outputs, last_state = self.rnn(x, lengths)
        m, b, t, h2 = outputs.shape
        if self.use_attention:
            flat = last_state.permute(0, 2, 1, 3).reshape(m, b, -1)
            attn_vec = torch.relu(self.attn(flat))                # (M, B, 2H)
            seq = outputs.reshape(m * b, t, h2)
            # parity: softmax over ALL steps incl. padding (logit 0 there)
            logits = torch.bmm(seq, attn_vec.reshape(m * b, h2, 1))
            attn = torch.softmax(logits, dim=1)
            pooled = torch.bmm(attn.transpose(1, 2), seq).view(m, b, h2)
        else:
            mask = length_mask(lengths.to(torch.long), t)[..., None]
            pooled = outputs.masked_fill(~mask, -math.inf).amax(2)
        pooled = self.dropout(self.bn0(pooled, valid))
        pooled = torch.relu(self.dense(pooled))
        pooled = self.dropout(self.bn1(pooled, valid))
        return self.out(pooled)


class CNNClassifier(nn.Module):
    """Multi-kernel 1D-conv text-CNN head (reference
    `util/classifier.py:103-134`); no batch statistics, so `valid` is
    unused."""

    def __init__(self, input_dim, hidden_dim, num_classes,
                 kernel_sizes=(3, 5, 7), depth=1, dropout=0.5,
                 input_dropout=0.2, num_members=1, seed=0):
        super().__init__()
        assert depth <= 2, depth
        m = num_members
        self.input_dropout = FlaxDropout(input_dropout)
        self.convs = nn.ModuleList()
        for k in kernel_sizes:
            branch = [MemberConv1d(m, input_dim, hidden_dim, k)]
            if depth > 1:
                branch.append(MemberConv1d(m, hidden_dim, hidden_dim, 7,
                                           stride=k // 2))
            self.convs.append(nn.ModuleList(branch))
        self.dense = MemberDense(m, hidden_dim * len(kernel_sizes),
                                 hidden_dim)
        self.out = MemberDense(m, hidden_dim, num_classes)
        self.dropout = FlaxDropout(dropout)
        init_members(self, seed)

    def forward(self, x, lengths=None, valid=None):
        del lengths, valid
        x = self.input_dropout(x)
        m, b, t, d = x.shape
        x = x.permute(1, 0, 3, 2).reshape(b, m * d, t)
        feats = []
        for branch in self.convs:
            h = x
            for conv in branch:
                h = torch.relu(conv(h))
            # max over time; masks nothing (the reference CNN also pools
            # over zero-padded steps)
            feats.append(h.amax(2).view(b, m, -1))
        x = torch.cat(feats, 2).transpose(0, 1)                  # (M, B, F)
        x = self.dropout(x)
        x = self.dropout(torch.relu(self.dense(x)))
        return self.out(x)
