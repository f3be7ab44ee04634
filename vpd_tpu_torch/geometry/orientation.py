"""Canonical (view-independent) orientation of a 3D skeleton.

The port's copy of `vpd_tpu/geometry/orientation.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Behavioral parity with reference `vipe_dataset/util.py:57-85`
(re-derived: sign-aligned principal axes + one clipped interpolation
expression instead of the reference's five-way branch; differential-
tested in test_reference_oracle.py::test_canonical_orientation_oracle).
The geometry: SVD of the torso point cloud gives forward/up axes; when
the torso pitches past 45 degrees the forward vector blends toward the
(sign-corrected) spine axis so lying-down poses stay well-defined.
"""

import numpy as np

Z_UNIT = np.array([0., 0., 1.])


def _align_sign(axis, hint):
    """Flip `axis` so it points into the same half-space as `hint`."""
    return axis if axis @ hint >= 0 else -axis


def get_canonical_orientation(X, torso_forward_vec, spine_up_vec,
                              interp_start=45, interp_range=30):
    V = np.linalg.svd(X - X.mean(axis=0))[2]
    up = _align_sign(V[0], spine_up_vec)
    fwd = _align_sign(V[2], torso_forward_vec)

    pitch = np.degrees(np.arcsin(fwd[2]))
    # Blend weight ramps 0 -> 1 over [interp_start, interp_start +
    # interp_range] degrees of |pitch|; the blend target is the spine
    # axis oriented against the pitch direction.
    t = np.clip((abs(pitch) - interp_start) / interp_range, 0.0, 1.0)
    if t == 0.0:
        return fwd
    target = -up if pitch > 0 else up
    return t * target + (1. - t) * fwd


def canonicalize(xyz, torso_rows, left_row, right_row, neck_vec):
    """Root-center + yaw-align a raw (N, 3) mocap pose.

    Returns ``(xyz_rotated, theta_degrees)`` where theta is the original yaw.
    ``xyz`` must already be root-centered. Mirrors the shared tail of the
    reference loaders (e.g. `vipe_dataset/human36m.py:176-190`).
    """
    forward_vec = get_canonical_orientation(
        xyz[torso_rows, :],
        np.cross(xyz[left_row, :], xyz[right_row, :]),
        neck_vec)
    forward_vec[2] = 0
    forward_vec /= np.linalg.norm(forward_vec)
    lateral_vec = np.cross(Z_UNIT, forward_vec)

    rot_mat = np.array([lateral_vec, forward_vec, Z_UNIT]).T
    theta = np.degrees(np.arccos(lateral_vec[0]))
    if lateral_vec[1] < 0:
        theta = -theta
    return xyz.dot(rot_mat), theta
