"""The benchmark's synthetic SMPL-topology body, in numpy: a frozen copy
of the port's procedural body at the real SMPL's scale (11 rings × 28
segments a bone: 7,084 vertices, 12,880 faces), so the benchmark makes
its own body and hands the same arrays to the program and to the
reference. ``lwg_bench/tests`` holds it equal to the port's
``assets.bench_assets()`` array for array."""

from __future__ import annotations

import numpy as np

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

NUM_JOINTS = 24
NUM_BETAS = 10
NUM_POSE_BASIS = 207
THETA_DIM = 85

# cocoplus joint k -> nearest SMPL joint, used by the synthetic regressor.
# Order follows the cocoplus convention the reference relies on
# (NECK_IDS == 12 marks the neck; 13.. are head/face — impersonator_trainer.py:93).
_COCOPLUS_FROM_SMPL = np.array(
    [8, 5, 2, 1, 4, 7, 21, 19, 17, 16, 18, 20, 12, 15, 15, 15, 15, 15, 15],
    dtype=np.int32,
)

# Canonical 10-part segmentation (same granularity as the reference's
# smpl_part_info.json: par map dim = 10 + 1 bg, mesh.py:288-318).
PART_NAMES = (
    "01_head",
    "02_torso",
    "03_left_upper_arm",
    "04_left_lower_arm",
    "05_right_upper_arm",
    "06_right_lower_arm",
    "07_left_upper_leg",
    "08_left_lower_leg",
    "09_right_upper_leg",
    "10_right_lower_leg",
)

# bone (child joint id) -> part name for the synthetic body.
_BONE_TO_PART = {
    1: "07_left_upper_leg", 4: "07_left_upper_leg",
    7: "08_left_lower_leg", 10: "08_left_lower_leg",
    2: "09_right_upper_leg", 5: "09_right_upper_leg",
    8: "10_right_lower_leg", 11: "10_right_lower_leg",
    3: "02_torso", 6: "02_torso", 9: "02_torso", 13: "02_torso", 14: "02_torso",
    12: "01_head", 15: "01_head",
    16: "03_left_upper_arm", 18: "03_left_upper_arm",
    20: "04_left_lower_arm", 22: "04_left_lower_arm",
    17: "05_right_upper_arm", 19: "05_right_upper_arm",
    21: "06_right_lower_arm", 23: "06_right_lower_arm",
}

_JOINT_POS = np.array([
    [0.00, 0.00, 0.00],    # 0 pelvis
    [0.09, -0.08, 0.00],   # 1 L hip
    [-0.09, -0.08, 0.00],  # 2 R hip
    [0.00, 0.12, 0.00],    # 3 spine1
    [0.10, -0.48, 0.00],   # 4 L knee
    [-0.10, -0.48, 0.00],  # 5 R knee
    [0.00, 0.25, 0.00],    # 6 spine2
    [0.10, -0.85, 0.00],   # 7 L ankle
    [-0.10, -0.85, 0.00],  # 8 R ankle
    [0.00, 0.33, 0.00],    # 9 spine3
    [0.11, -0.93, 0.08],   # 10 L foot
    [-0.11, -0.93, 0.08],  # 11 R foot
    [0.00, 0.45, 0.00],    # 12 neck
    [0.08, 0.40, 0.00],    # 13 L collar
    [-0.08, 0.40, 0.00],   # 14 R collar
    [0.00, 0.58, 0.02],    # 15 head
    [0.18, 0.40, 0.00],    # 16 L shoulder
    [-0.18, 0.40, 0.00],   # 17 R shoulder
    [0.32, 0.18, 0.00],    # 18 L elbow
    [-0.32, 0.18, 0.00],   # 19 R elbow
    [0.42, -0.03, 0.00],   # 20 L wrist
    [-0.42, -0.03, 0.00],  # 21 R wrist
    [0.46, -0.10, 0.00],   # 22 L hand
    [-0.46, -0.10, 0.00],  # 23 R hand
], np.float32)

_BONE_RADIUS = {
    1: 0.07, 2: 0.07, 3: 0.11, 4: 0.055, 5: 0.055, 6: 0.12, 7: 0.045,
    8: 0.045, 9: 0.12, 10: 0.04, 11: 0.04, 12: 0.05, 13: 0.09, 14: 0.09,
    15: 0.09, 16: 0.05, 17: 0.05, 18: 0.04, 19: 0.04, 20: 0.035,
    21: 0.035, 22: 0.03, 23: 0.03,
}


def body_arrays(rings: int = 11, segments: int = 28, seed: int = 0) -> dict:
    """The procedural body's arrays, keyed as the port's ``SMPLAssets``
    fields: one open tube of ``rings``×``segments`` vertices per bone of
    the SMPL kinematic tree, blendshape bases, dense regressors, LBS
    weights summing to 1, a UV strip per bone, a 10-part face table and
    head / front face sets; deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    bones = [(j, int(SMPL_PARENTS[j])) for j in range(1, NUM_JOINTS)]

    verts, faces, uvs = [], [], []
    lbs = []
    part_faces = {p: [] for p in PART_NAMES}
    v_off = 0
    n_bones = len(bones)
    for b_i, (child, parent) in enumerate(bones):
        p0, p1 = _JOINT_POS[parent], _JOINT_POS[child]
        axis = p1 - p0
        length = np.linalg.norm(axis)
        if length < 1e-6:
            axis = np.array([0, 1e-3, 0], np.float32)
            length = 1e-3
        d = axis / length
        # orthonormal frame around the bone
        up = np.array([1.0, 0, 0]) if abs(d[1]) > 0.9 else np.array([0, 1.0, 0])
        e1 = np.cross(d, up); e1 /= np.linalg.norm(e1)
        e2 = np.cross(d, e1)
        r = _BONE_RADIUS[child]

        for ri in range(rings):
            t = ri / (rings - 1)
            center = p0 + t * axis
            for si in range(segments):
                ang = 2 * np.pi * si / segments
                verts.append(center + r * (np.cos(ang) * e1 + np.sin(ang) * e2))
                # UV atlas: each bone gets a horizontal strip
                u = (b_i + si / segments * 0.95) / n_bones
                uvs.append([u, t * 0.95 + 0.025])
                w = np.zeros(NUM_JOINTS, np.float32)
                w[parent] = 1.0 - t
                w[child] = t
                lbs.append(w)
        for ri in range(rings - 1):
            for si in range(segments):
                a = v_off + ri * segments + si
                b = v_off + ri * segments + (si + 1) % segments
                c = a + segments
                dd_ = b + segments
                faces.append([a, c, b])
                faces.append([b, c, dd_])
                part = _BONE_TO_PART[child]
                fi = len(faces)
                part_faces[part].extend([fi - 2, fi - 1])
        v_off += rings * segments

    v_template = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    uvs = np.asarray(uvs, np.float32)
    nv = v_template.shape[0]

    # J regressor: average of the vertices whose dominant weight is the joint.
    j_regressor = np.zeros((nv, NUM_JOINTS), np.float32)
    lbs = np.asarray(lbs, np.float32)
    for j in range(NUM_JOINTS):
        sel = lbs[:, j] > 0.5
        if not sel.any():
            sel = lbs[:, j] > 0.0
        if sel.any():
            j_regressor[sel, j] = 1.0 / sel.sum()
    # cocoplus regressor: reuse the joint rows through the fixed mapping.
    joint_regressor = j_regressor[:, _COCOPLUS_FROM_SMPL].copy()

    # Smooth random blendshape bases, small enough to keep the mesh sane.
    shapedirs = (rng.standard_normal((NUM_BETAS, nv * 3)) * 0.01).astype(np.float32)
    posedirs = (rng.standard_normal((NUM_POSE_BASIS, nv * 3)) * 0.001).astype(np.float32)

    f2uvs = uvs[faces]  # (nf, 3, 2), already in [0,1] with v "flipped" convention

    head_faces = np.asarray(
        sorted(part_faces["01_head"]), np.int64)
    # facial region: front half (z >= bone axis) of the head tube faces
    face_centroids = v_template[faces].mean(axis=1)
    front_mask = np.zeros(faces.shape[0], bool)
    front_mask[head_faces] = face_centroids[head_faces, 2] < 0  # camera looks from -z
    front_faces = np.nonzero(front_mask)[0].astype(np.int64)

    mean_theta = np.zeros(THETA_DIM, np.float32)
    mean_theta[0] = 0.9
    return dict(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=j_regressor, lbs_weights=lbs,
        joint_regressor=joint_regressor, parents=SMPL_PARENTS.copy(),
        faces=faces, f2uvs=f2uvs.astype(np.float32),
        part_faces={k: np.asarray(sorted(v), np.int64)
                    for k, v in part_faces.items() if v},
        head_faces=head_faces, front_faces=front_faces,
        mean_theta=mean_theta)


def uv_seg_table(f2uvs: np.ndarray) -> np.ndarray:
    """The ``uv_seg`` conditioning table (nf + 1, 3): each face's UV
    barycentre and 0, then the background row (0, 0, 1)."""
    v2 = f2uvs[:, 2]
    fbc = (v2 + 0.5 * (f2uvs[:, 0] - v2)
           + 0.5 * (f2uvs[:, 1] - v2)).astype(np.float32)
    body = np.concatenate([fbc, np.zeros((len(fbc), 1), np.float32)], 1)
    return np.concatenate([body, np.array([[0.0, 0.0, 1.0]], np.float32)])
