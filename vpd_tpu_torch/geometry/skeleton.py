"""Declarative skeleton trees with derived geometry.

The port's copy of `vpd_tpu/geometry/skeleton.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Behavioral parity with the reference's four hand-unrolled skeleton modules
(`vipe_dataset/human36m.py:101-162`, `people3d.py:124-210`, `nba2k.py:108-196`,
`amass.py:84-164`), but re-designed around a single tree description:

* a skeleton is ``joints`` (root first) plus an ordered list of ``edges``
  ``(child, parent)``. The edge order is the canonical row order of the
  per-joint "offset" encoding used throughout the pipeline.
* encode  = gather + subtract                 (``offsets[e] = P[child] - P[parent]``)
* decode  = one constant (J-1, E) path-matrix matmul — MXU-friendly and
  identical for every skeleton family, instead of per-dataset unrolled chains.
* parent-edge cosine rows, horizontal-flip row permutation, and COCO-17
  projection targets are all *derived* from the edge list (verified against
  the reference's hardcoded tables by golden tests).
"""

import dataclasses
from functools import cached_property

import numpy as np


def _mirror_name(name, names):
    """Return the left/right mirrored joint name, or `name` if unsided."""
    for a, b in (('left', 'right'), ('l_', 'r_'), ('l', 'r')):
        if name.startswith(a):
            cand = b + name[len(a):]
            if cand in names:
                return cand
        if name.startswith(b):
            cand = a + name[len(b):]
            if cand in names:
                return cand
    return name


@dataclasses.dataclass(frozen=True)
class SkeletonSpec:
    """A kinematic tree: joints (root first) + ordered (child, parent) edges.

    ``extremity_rows`` are edge rows zeroed in the 3D feature encoding
    (distal joints whose 2D detections are unreliable).
    ``coco_map`` lists, for each of the 17 COCO keypoints, the joint names
    averaged to produce that keypoint's synthetic-camera 3D position.
    """
    name: str
    joints: tuple
    edges: tuple
    extremity_rows: tuple
    coco_map: tuple = ()
    # Explicit predecessor-edge overrides {edge: pred_edge} for families whose
    # reference cossim table deviates from the tree structure (human36m pairs
    # neck-children with the nose edge, `vipe_dataset/human36m.py:90-91`).
    pred_overrides: tuple = ()

    def __post_init__(self):
        assert len(self.edges) == len(self.joints) - 1, self.name
        joint_set = set(self.joints)
        for child, parent in self.edges:
            assert child in joint_set and parent in joint_set, (child, parent)
        children = [c for c, _ in self.edges]
        assert len(set(children)) == len(children), 'edge per non-root joint'
        if self.coco_map:
            assert len(self.coco_map) == 17

    @property
    def root(self):
        return self.joints[0]

    @property
    def num_joints(self):
        return len(self.joints)

    @property
    def num_edges(self):
        return len(self.edges)

    @cached_property
    def _joint_index(self):
        return {j: i for i, j in enumerate(self.joints)}

    @cached_property
    def child_idx(self):
        return np.array([self._joint_index[c] for c, _ in self.edges])

    @cached_property
    def parent_idx(self):
        return np.array([self._joint_index[p] for _, p in self.edges])

    @cached_property
    def _edge_by_child(self):
        return {c: e for e, (c, _) in enumerate(self.edges)}

    @cached_property
    def root_edge(self):
        """The root's spine-ward edge; anchors parent-cossim for root edges."""
        for e, (child, parent) in enumerate(self.edges):
            if parent == self.root and 'spine' in child:
                return e
        raise ValueError('no spine edge at root of {}'.format(self.name))

    @cached_property
    def pred_edge(self):
        """For edge e, the edge ending at e's parent joint (root edges map to
        the spine edge; the spine edge maps to itself, giving cossim 1)."""
        overrides = dict(self.pred_overrides)
        return np.array([
            overrides.get(e, self._edge_by_child.get(parent, self.root_edge))
            for e, (_, parent) in enumerate(self.edges)
        ])

    @cached_property
    def path_matrix(self):
        """(J-1, E) 0/1 matrix: decode = path_matrix @ offsets.

        Row j-1 marks every edge on the root→joints[j] path, so
        ``path_matrix @ offsets`` reproduces the positions of joints[1:]
        relative to the root.
        """
        parent_of = {c: p for c, p in self.edges}
        mat = np.zeros((self.num_joints - 1, self.num_edges))
        for j, joint in enumerate(self.joints[1:]):
            node = joint
            while node != self.root:
                mat[j, self._edge_by_child[node]] = 1.
                node = parent_of[node]
        return mat

    @cached_property
    def xflip_rows(self):
        """Edge-row permutation for a left/right mirror of the skeleton."""
        names = set(j for j, _ in self.edges)
        rows = []
        for child, _ in self.edges:
            rows.append(self._edge_by_child[_mirror_name(child, names)])
        assert sorted(rows) == list(range(self.num_edges))
        return rows

    @cached_property
    def coco_avg_matrix(self):
        """(17, J) averaging matrix mapping joint positions → COCO keypoints."""
        assert self.coco_map, 'no coco_map for {}'.format(self.name)
        mat = np.zeros((17, self.num_joints))
        for row, sources in enumerate(self.coco_map):
            for s in sources:
                mat[row, self._joint_index[s]] += 1. / len(sources)
        return mat

    # ---- geometry ops (numpy; all accept an optional leading batch dim,
    # i.e. (..., E, 3) stacks, for the vectorized host sampler) ----

    def encode_offsets(self, positions):
        """(..., J, 3) joint positions → (..., E, 3) parent-relative
        offsets."""
        positions = np.asarray(positions)
        return (positions[..., self.child_idx, :]
                - positions[..., self.parent_idx, :])

    def decode_positions(self, offsets):
        """(..., E, 3) offsets → (..., J-1, 3) root-relative positions of
        joints[1:] (matmul broadcasts over leading dims)."""
        return self.path_matrix @ np.asarray(offsets)

    def decode_all_positions(self, offsets):
        """(..., E, 3) offsets → (..., J, 3) positions incl. root at zero."""
        offsets = np.asarray(offsets)
        out = np.zeros(offsets.shape[:-2]
                       + (self.num_joints, offsets.shape[-1]))
        out[..., 1:, :] = self.decode_positions(offsets)
        return out

    def parent_cossim(self, normed_offsets):
        """Cosine similarity of each (unit) edge offset with its predecessor
        edge; the spine edge pairs with itself, yielding exactly 1."""
        normed_offsets = np.asarray(normed_offsets)
        return np.sum(normed_offsets[..., self.pred_edge, :]
                      * normed_offsets, axis=-1)

    def flip_offsets(self, offsets):
        """Mirror a (..., E, 3) offset stack: permute rows, negate x."""
        flipped = np.asarray(offsets)[..., self.xflip_rows, :].copy()
        flipped[..., 0] = -flipped[..., 0]
        return flipped

    def project_coco(self, offsets):
        """(..., E, 3) offsets → (..., 17, 3) COCO joint positions for
        synthetic views."""
        return self.coco_avg_matrix @ self.decode_all_positions(offsets)
