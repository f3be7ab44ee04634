"""Few-shot action recognition and retrieval on frozen embeddings.

Counterpart of `vpd_tpu/tasks/recognize.py`. Parity with reference
`recognize.py:68-199, 453-649`: SeqModel (GRU/LSTM/CNN heads, flip rows
become extra training sequences, flip-ensemble prediction), KnnModel (DTW
symmetricP2 with symmetric2 fallback, most-common-class fallback),
few-shot trials over premade id files, accuracy / confusion / CSV
outputs, and DTW retrieval with hit@k / prec@k.

In the port the DTW kNN and retrieval always run as one batched sweep on
the chosen device (kernel B2 on CUDA, its plain twin on the CPU): the
test x train matrix is computed once and every trial selects its
columns. The host `KnnModel` stays for parity tests. The sequence heads
train on the device (`train/classifier.py`); with `fused_sweep` every
trial of a few-shot size trains as one member of one batched model
(`train/fused_sweep.py`), and a head scores all test actions in one
forward per length bucket. On a data mesh (`mesh`, several ranks under
torchrun) the fused sweep splits its trials over the ranks
(`train/fused_sweep.py`); every rank runs the rest of the protocol on
the gathered members, and only the primary rank writes `out_dir`. The
DTW sweeps are not sharded, as in vpd_tpu.
"""

import csv
import os
import time
from collections import Counter, defaultdict

import numpy as np

from ..train.classifier import SeqModelTrainer
from .eval import save_confusion_matrix
from .neighbors import KNearestNeighbors, batch_distances, make_dtw_fns

KNN_MODELS = ['dtw']
SEQ_MODELS = ['lstm', 'gru', 'cnn']


def _expand_flip_rows(all_embs, labels, class_index=None):
    """(T, k, D) flip rows -> k separate training sequences.

    Returns (X, y, seqs): the per-variant sequence list, the label per
    variant (mapped through `class_index` when given, raw otherwise),
    and the source sequence id per variant. Actions with no embeddings
    (None) are dropped.
    """
    X, y, seqs = [], [], []
    for seq, embs in all_embs.items():
        if embs is None:
            continue
        n_variants = embs.shape[1] if embs.ndim == 3 else 1
        variants = ([embs[:, j, :] for j in range(n_variants)]
                    if embs.ndim == 3 else [embs])
        X.extend(variants)
        tgt = labels[seq] if class_index is None else class_index(labels[seq])
        y.extend([tgt] * n_variants)
        seqs.extend([seq] * n_variants)
    return X, np.array(y), seqs


class SeqModel:
    """Sequence-head recognizer (`recognize.py:68-122`)."""

    def __init__(self, arch_type, train_embs, train_labels, hidden_dim,
                 val_embs=None, val_labels=None, **kwargs):
        classes = Counter(train_labels[seq] for seq in train_embs)
        self.classes = sorted(classes.keys())
        self.top_class = classes.most_common()[0][0]

        cidx = self.classes.index
        X, y, _ = _expand_flip_rows(train_embs, train_labels, cidx)
        X_val, y_val = (None, None)
        if val_embs:
            X_val, y_val, _ = _expand_flip_rows(val_embs, val_labels, cidx)

        self.model = SeqModelTrainer(
            arch_type, X, y, hidden_dim, X_val=X_val, y_val=y_val, **kwargs)

    def predict_actions(self, embs, ensemble=True):
        """{action: (class, None)} for a dict of (T, [k,] D) embeddings;
        (T, k, D) flip columns are ensemble variants (only the first
        without `ensemble`), an action without embeddings gets the most
        common class. Every variant of every action is scored in one
        batched forward per length bucket."""
        seqs, owner = [], []
        for action, x in embs.items():
            if x is None:
                continue
            variants = ([x[:, j, :] for j in range(x.shape[1])]
                        if x.ndim == 3 else [x])
            if not ensemble:
                variants = variants[:1]
            seqs.extend(variants)
            owner.extend([action] * len(variants))
        probs = self.model.predict_probs(seqs) if seqs else None
        out = {action: (self.top_class, None) for action in embs}
        by_action = defaultdict(list)
        for i, action in enumerate(owner):
            by_action[action].append(i)
        for action, rows in by_action.items():
            out[action] = (self.classes[int(np.argmax(
                probs[rows].mean(0)))], None)
        return out

    def predict(self, x, ensemble=True):
        return self.predict_actions({None: x}, ensemble)[None]

    def save_model(self, out_path):
        self.model.save(out_path)


class KnnModel:
    """Host DTW k-NN recognizer (`recognize.py:125-184`).

    Two indices share the expanded variant rows: symmetricP2 is scored
    first; symmetric2 answers only when the P2 step pattern is
    infeasible for the query (the DTW fns raise / yield no neighbor).
    Both failing falls back to the most common training class.
    """

    def __init__(self, dist_type, train_embs, train_labels, k):
        assert dist_type == 'dtw', dist_type
        counts = Counter(train_labels[seq] for seq in train_embs)
        self.top_class = counts.most_common()[0][0]
        X, y, self.val = _expand_flip_rows(train_embs, train_labels)
        self.models = [KNearestNeighbors(X, y, fn, k=k)
                       for fn in make_dtw_fns()]

    @staticmethod
    def _variants(x, ensemble):
        if x.ndim != 3:
            return [x]
        cols = range(x.shape[1]) if ensemble else range(1)
        return [x[:, j, :] for j in cols]

    def predict(self, x, ensemble=True):
        if x is None:
            return self.top_class, None
        variants = self._variants(x, ensemble)
        for model in self.models:
            try:
                pred, i = (model.predict_n(*variants) if len(variants) > 1
                           else model.predict(variants[0]))
            except Exception as e:  # infeasible step pattern -> next
                print(e)
                continue
            if i is not None:
                return pred, self.val[i]
        return self.top_class, None


class DeviceKnnIndex:
    """Precomputed test x train DTW distances for kNN.

    The FULL test x train variant distance matrix is computed once by one
    sweep (`batch_distances`, sequences cut to max_len) and every
    few-shot trial selects its train columns. The symmetric2 matrix is
    swept only when needed: its fallback fires only when EVERY (variant,
    train-column) symmetricP2 distance of an action is infeasible, as in
    the host KnnModel path.
    """

    def __init__(self, train_embs, test_embs, train_labels, max_len=128,
                 device=None, log=print):
        def expand(embs_dict):
            entries, arrays = [], []
            for seq in sorted(embs_dict):
                embs = embs_dict[seq]
                if embs is None:
                    continue
                if len(embs.shape) == 3:
                    for i in range(embs.shape[1]):
                        entries.append((seq, i))
                        arrays.append(embs[:, i, :])
                else:
                    entries.append((seq, 0))
                    arrays.append(embs)
            return entries, arrays

        self.train_entries, self.train_arrays = expand(train_embs)
        self.test_entries, self.test_arrays = expand(test_embs)
        self.train_labels = train_labels
        self.test_rows = defaultdict(list)
        for r, (seq, _) in enumerate(self.test_entries):
            self.test_rows[seq].append(r)
        self.max_len = max_len
        self.device = device
        self.log = log

        log('Device kNN: {} test x {} train variant distances'.format(
            len(self.test_arrays), len(self.train_arrays)))
        self.d1 = self._sweep('symmetricP2')
        self._d2 = None

    def _sweep(self, step_pattern):
        return batch_distances(self.test_arrays, self.train_arrays,
                               max_len=self.max_len,
                               step_pattern=step_pattern,
                               device=self.device, log=self.log)

    @property
    def d2(self):
        if self._d2 is None:
            if not np.isinf(self.d1).any():
                # unreachable via predict_action (its all-inf branch
                # implies d1 has inf entries); loud for direct readers
                raise RuntimeError(
                    'd2 requested but d1 has no infeasible entries')
            self._d2 = self._sweep('symmetric2')
        return self._d2


class DeviceKnnModel:
    """Per-trial view over a DeviceKnnIndex (KnnModel interface)."""

    def __init__(self, index, subset_seqs, k):
        self.index = index
        self.k = k
        self.cols = [c for c, (seq, _) in enumerate(index.train_entries)
                     if seq in subset_seqs]
        self.y = [index.train_labels[index.train_entries[c][0]]
                  for c in self.cols]
        classes = Counter(self.y)
        self.top_class = classes.most_common()[0][0]

    def predict_action(self, action_id, ensemble=True):
        rows = self.index.test_rows.get(action_id)
        if not rows:
            return self.top_class, None
        if not ensemble:
            rows = rows[:1]
        dist = self.index.d1[np.ix_(rows, self.cols)]
        if np.isinf(dist).all():  # symmetricP2 infeasible -> fallback
            dist = self.index.d2[np.ix_(rows, self.cols)]
        # identical heap/majority/tiebreak semantics via matrix lookup
        knn = KNearestNeighbors(
            list(range(len(self.cols))), self.y,
            lambda r, c: float(dist[r, c]), k=self.k)
        try:
            pred, i = knn.predict_n(*range(len(rows)))
        except TypeError as e:
            # the vote's majority class has only +inf distances: y[None]
            # (most-common fallback, KnnModel parity)
            print(e)
            return self.top_class, None
        if i is None:
            return self.top_class, None
        return pred, self.index.train_entries[self.cols[i]][0]


def sample_embeddings(embs, labels, n, keep_ratio=False, seed=None):
    """Per-class subsampling to n examples (or, with keep_ratio, to a
    quota proportional to the class size relative to the smallest
    class). Behavioral parity with `recognize.py:187-199`, incl. the
    rng.choice draw order (one draw per oversized class, in insertion
    order)."""
    rng = np.random.default_rng(seed)
    by_label = defaultdict(list)
    for seq in embs:
        by_label[labels[seq]].append(seq)
    smallest = min(map(len, by_label.values()))

    keep = []
    for seqs in by_label.values():
        quota = round(len(seqs) / smallest * n) if keep_ratio else n
        keep.extend(seqs if len(seqs) <= quota
                    else rng.choice(seqs, quota, replace=False))
    return {s: embs[s] for s in keep}


def _train_fused_sweep(subsets, train_embs, train_labels, val_embs,
                       val_labels, algorithm, trainer_kwargs, log,
                       mesh=None):
    """Train every trial of one few-shot size as the members of one model
    (`train/fused_sweep.py`). Returns per-trial (params, batch_stats)
    presets, or None when the subsets are not fusable: a trial that does
    not see every class would get a smaller classifier head in the
    sequential path, so such sizes fall back to per-trial training
    (identical results, just slower)."""
    from ..train.fused_sweep import FusedSweepTrainer

    classes = sorted(set(train_labels[s] for s in train_embs))
    for sub in subsets:
        if sorted(set(train_labels[s] for s in sub)) != classes:
            return None
    cidx = classes.index
    X_pool, y_pool, row_seq = _expand_flip_rows(train_embs, train_labels,
                                                cidx)
    member_rows = [[r for r, s in enumerate(row_seq) if s in sub]
                   for sub in subsets]
    if any(not rows for rows in member_rows):
        return None
    X_val = y_val = None
    if val_embs:
        X_val, y_val, _ = _expand_flip_rows(val_embs, val_labels, cidx)
    try:
        fused = FusedSweepTrainer(
            algorithm, X_pool, y_pool, member_rows, X_val=X_val,
            y_val=y_val, log=log, mesh=mesh, **trainer_kwargs)
    except ValueError as exc:
        log('fused sweep fallback to sequential trials: {}'.format(exc))
        return None
    return [fused.member(i) for i in range(len(subsets))]


def run_action_recognition(
        categories, train_embs, train_labels, val_embs, val_labels,
        test_embs, test_labels, out_dir, algorithm, k, num_train_examples,
        few_shot_template, hidden_dim, attn, num_epochs, val_freq,
        n_trials, no_test_flip, load_action_ids_fn=None, load_weights=None,
        device_knn=False, device_max_len=128, fused_sweep=False, mesh=None,
        log=print, device=None, stats=None):
    """Few-shot evaluation protocol (`recognize.py:453-577`).

    DTW kNN: the full test x train DTW matrix is computed once on `device`
    (None means CUDA; sequences cut to device_max_len) and reused across
    every few-shot size and trial; `device_knn` is accepted for parity
    with vpd_tpu: the sweep is always on. Sequence heads (lstm / gru /
    cnn) train on `device`, one per trial, or with `fused_sweep` all
    trials of a few-shot size as one batched model (sizes that are not
    fusable fall back to sequential trials); `load_weights` loads one
    saved head for every trial instead of training. `mesh` splits the
    fused sweep's trials over its ranks; only its primary rank writes
    `out_dir`. When `stats` is a dict it receives,
    for DTW, the index (`index`), the seconds spent building it
    (`index_seconds`) and the host voting seconds per few-shot size
    (`vote_seconds`); for a sequence head, the training seconds
    (`train_seconds`), whether the fused sweep ran (`fused`) and the
    prediction seconds (`predict_seconds`) per few-shot size. Returns
    {ne: [trial accs]}.
    """
    del device_knn
    if algorithm not in KNN_MODELS + SEQ_MODELS:
        raise ValueError('unknown algorithm {!r}'.format(algorithm))
    from .. import resolve_device
    from ..core.mesh import is_primary
    from ..datasets.load import load_action_ids
    if load_action_ids_fn is None:
        load_action_ids_fn = load_action_ids
    device = resolve_device(device if mesh is None else mesh.device)
    if not is_primary():
        out_dir = None
    seq_model = algorithm in SEQ_MODELS
    if seq_model and k != 1:
        raise ValueError('sequence heads vote with k = 1, got k = {}'
                         .format(k))

    knn_index = None
    if not seq_model:
        t0 = time.perf_counter()
        knn_index = DeviceKnnIndex(train_embs, test_embs, train_labels,
                                   max_len=device_max_len, device=device,
                                   log=log)
        if stats is not None:
            stats.update(index=knn_index,
                         index_seconds=time.perf_counter() - t0,
                         vote_seconds={})
    elif stats is not None:
        stats.update(train_seconds={}, fused={}, predict_seconds={})

    if seq_model:
        seq_kwargs = {'hidden_dim': hidden_dim, 'num_epochs': num_epochs,
                      'val_freq': val_freq,
                      'early_term_val_num_epochs': num_epochs // 3,
                      'device': device}
        if algorithm in ('gru', 'lstm'):
            seq_kwargs['use_attention'] = attn
        seqs = [v for v in train_embs.values() if v is not None]
        seqs += [v for v in (val_embs or {}).values() if v is not None]
    if seq_model and seqs:
        # every trial's trainer (and the fused sweep) pads to this one
        # bucket, so fused and sequential trials train on the same shapes
        seq_kwargs['bucket_floor'] = max(len(v) for v in seqs)

    def build_model(embs, preset=None):
        if not seq_model:
            return DeviceKnnModel(knn_index, set(embs), k)
        kwargs = dict(seq_kwargs)
        if load_weights is not None:
            kwargs['load_weights'] = load_weights
        if preset is not None:
            kwargs['preset'] = preset
        return SeqModel(algorithm, embs, train_labels, val_embs=val_embs,
                        val_labels=val_labels, **kwargs)

    def run_trial(trial, embs, ne, preset=None):
        t0 = time.perf_counter()
        model = build_model(embs, preset)
        t1 = time.perf_counter()
        if seq_model:
            preds = model.predict_actions(test_embs, not no_test_flip)
        results = []
        errors = 0
        for action_id in test_embs:
            pred, neighbor = (preds[action_id] if seq_model else
                              model.predict_action(action_id,
                                                   not no_test_flip))
            actual = test_labels[action_id]
            if pred != actual:
                errors += 1
            pred_name = (categories[pred].name if pred in categories
                         else '')
            results.append((action_id, actual, categories[actual].name,
                            pred, pred_name, neighbor))
        acc = 1 - errors / len(results)
        log('Trial {}: accuracy {:0.4f}'.format(trial, acc))
        if stats is not None and seq_model:
            stats['train_seconds'][ne] += t1 - t0
            stats['predict_seconds'][ne] += time.perf_counter() - t1

        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            trial_str = 'trial{}_{}_{}'.format(
                trial, ne if ne > 0 else 'full', algorithm)
            for norm in ('true', 'pred'):
                save_confusion_matrix(
                    [r[2] for r in results], [r[4] for r in results],
                    os.path.join(out_dir, '{}.test_conf.norm_{}.pdf'.format(
                        trial_str, norm)), norm=norm)
            with open(os.path.join(
                    out_dir, '{}.test_pred.csv'.format(trial_str)),
                    'w') as fp:
                writer = csv.writer(fp)
                writer.writerow([
                    'sequence', 'actual', 'actual_name',
                    'pred (acc={})'.format(acc), 'pred_name', 'neighbor'])
                writer.writerows(results)
            if seq_model and load_weights is None:
                # with pretrained weights the trial model is a copy of
                # the input; don't re-serialize it (`recognize.py:511`)
                model.save_model(os.path.join(
                    out_dir, '{}.model.ckpt'.format(trial_str)))
        return acc

    accs = {}
    for ne in num_train_examples:
        t0 = time.perf_counter()
        subsets = []
        for i in range(n_trials):
            if ne > 0:
                ids = load_action_ids_fn(few_shot_template.format(ne, i))
                subsets.append({a: b for a, b in train_embs.items()
                                if a in ids})
            else:
                subsets.append(train_embs)
        presets = None
        if (fused_sweep and seq_model and load_weights is None
                and n_trials > 1):
            presets = _train_fused_sweep(
                subsets, train_embs, train_labels, val_embs, val_labels,
                algorithm, seq_kwargs, log, mesh=mesh)
        if stats is not None and seq_model:
            stats['fused'][ne] = presets is not None
            stats['train_seconds'][ne] = time.perf_counter() - t0
            stats['predict_seconds'][ne] = 0.
        trial_accs = []
        for i in range(n_trials):
            trial_accs.append(run_trial(
                i, subsets[i], ne, preset=presets[i] if presets else None))
        log('{}-shot mean accuracy: {:0.3f} +/- {:0.3f}'.format(
            ne if ne > 0 else 'full',
            np.mean(trial_accs) * 100, np.std(trial_accs) * 100))
        accs[ne] = trial_accs
        if stats is not None and not seq_model:
            stats['vote_seconds'][ne] = time.perf_counter() - t0
    return accs


def run_action_retrieval(emb_dict, label_dict, hit_t, queryset=None,
                         device=None, device_max_len=128, log=print,
                         stats=None):
    """DTW leave-query retrieval; returns (hit@k, prec@k) dicts
    (`recognize.py:580-649`).

    The full query x target distance matrix is one sweep on `device`
    (None means CUDA; sequences cut to `device_max_len`), as vpd_tpu's
    `run_action_retrieval(device=True)`; the ranking protocol is the
    same. When `stats` is a dict it receives the distance matrix
    (`dist`), the sweep's query and target sequences (`sweep_inputs`)
    and its seconds (`sweep_seconds`).
    """
    hit_t = sorted(hit_t)

    def get_embs(a):
        embs = emb_dict[a]
        if embs is not None and len(embs.shape) == 3:
            embs = embs.reshape((embs.shape[0], -1))
        return embs

    actions = sorted(emb_dict.keys())
    all_embs = [get_embs(a) for a in actions]

    hit_counts = defaultdict(int)
    hit_precs = defaultdict(list)
    queries = list(enumerate(actions))
    if queryset is not None:
        queries = [q for q in queries if q[1] in queryset]

    max_hit = max(hit_t) + 1

    t0 = time.perf_counter()
    valid_t = [i for i, e in enumerate(all_embs)
               if e is not None and e.shape[0] >= 1]
    valid_q = [qi for qi, _ in queries if all_embs[qi] is not None]
    dist = np.full((len(actions), len(actions)), np.inf, np.float32)
    sweep_inputs = ([all_embs[i] for i in valid_q],
                    [all_embs[i] for i in valid_t])
    if valid_q and valid_t:
        sub = batch_distances(*sweep_inputs, max_len=device_max_len,
                              device=device, log=log)
        for a, qi in enumerate(valid_q):
            dist[qi, valid_t] = sub[a]
    if stats is not None:
        stats.update(dist=dist, sweep_inputs=sweep_inputs,
                     sweep_seconds=time.perf_counter() - t0)

    valid_t_arr = np.asarray(valid_t, dtype=np.int64)

    def find_neighbors(q_idx, k):
        # rank only valid targets: the host Neighbors.find never
        # considers embedding-less actions, and returns FEWER than k
        # neighbors when fewer valid targets exist — inf-padded
        # invalid columns must not leak into hit@k/prec@k
        row = dist[q_idx, valid_t_arr]
        order = np.argsort(row, kind='stable')[:k]
        return [(int(valid_t_arr[r]), float(row[r])) for r in order]

    for q_idx, q in queries:
        ranks = np.empty(0, np.int64)  # ranks of correct-label neighbors
        if all_embs[q_idx] is not None:
            found = find_neighbors(q_idx, max_hit)
            r = np.fromiter((ri for ri, _ in found), np.int64, len(found))
            is_self = r == q_idx
            # a neighbor listed before the query itself ranks one later
            # than its list position; at/after the query, position = rank
            ofs = (np.cumsum(is_self) == 0).astype(np.int64)
            match = np.fromiter(
                (label_dict[actions[ri]] == label_dict[q] for ri in r),
                bool, len(r))
            ranks = (np.arange(len(r)) + ofs)[match & ~is_self]

        first = int(ranks.min()) if ranks.size else None
        for h in hit_t:
            if first is not None and h >= first:
                hit_counts[h] += 1
            hit_precs[h].append(
                int((ranks <= h).sum()) / h if ranks.size else 0)

    hit_rates = {h: hit_counts[h] / len(queries) * 100 for h in hit_t}
    precs = {h: float(np.mean(hit_precs[h])) * 100 for h in hit_t}
    log('hit@: {}'.format({h: round(v, 2) for h, v in hit_rates.items()}))
    log('prec@: {}'.format({h: round(v, 2) for h, v in precs.items()}))
    return hit_rates, precs
