"""SMPL body-model constants, UV mappings and part tables, as numpy.

The port's own copy of the JAX package's framework-free asset registry
(``impersonator_tpu/assets.py``), so that the port loads nothing of that
package. It must stay equal to it array for array
(``tests/test_torch_assets.py`` holds the two together):

* :class:`SMPLAssets` — an immutable numpy container with everything the
  device pipeline needs (template, blendshapes, regressors, skinning
  weights, faces, per-face UV coordinates, map-function encodings and
  part→face tables, HMR's mean theta);
* :func:`load_smpl_assets` — loader for the real asset files
  (``smpl_model.pkl``, the UV mapper OBJ, the part/front/head JSONs);
* :func:`synthetic_assets` — a deterministic procedurally-generated body
  (articulated tubes over the SMPL kinematic tree) with the same shapes
  and invariants, so every test and benchmark runs without the
  non-redistributable SMPL download; :func:`bench_assets` is the one at
  the real SMPL's scale.

All arrays are plain numpy; device code converts once at model build.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from functools import lru_cache

import numpy as np

# The SMPL kinematic tree (24 joints). parents[0] is a sentinel (root).
# Matches reference kintree_table[0] (batch_smpl.py:274).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

NUM_JOINTS = 24
NUM_BETAS = 10
NUM_POSE_BASIS = 207  # 23 * 9
NUM_COCOPLUS = 19
THETA_DIM = 85  # 3 cam + 72 pose + 10 shape

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


@dataclasses.dataclass(frozen=True)
class SMPLAssets:
    """Everything the device pipeline needs, as numpy arrays."""

    # --- body model (batch_smpl.py:244-283) ---
    v_template: np.ndarray      # (nv, 3)
    shapedirs: np.ndarray       # (10, nv*3)
    posedirs: np.ndarray        # (207, nv*3)
    j_regressor: np.ndarray     # (nv, 24)
    lbs_weights: np.ndarray     # (nv, 24)
    joint_regressor: np.ndarray  # (nv, 19) cocoplus
    parents: np.ndarray         # (24,)
    faces: np.ndarray           # (nf, 3) int32

    # --- UV / mapping layer (utils/mesh.py) ---
    f2uvs: np.ndarray           # (nf, 3, 2) per-face UV verts, v already flipped (1-v)
    part_faces: dict            # part name -> np.ndarray of face ids
    head_faces: np.ndarray      # face ids of the whole head
    front_faces: np.ndarray     # face ids of the facial (front head) region

    # --- HMR regressor init ---
    mean_theta: np.ndarray      # (85,)

    @property
    def nv(self) -> int:
        return int(self.v_template.shape[0])

    @property
    def nf(self) -> int:
        return int(self.faces.shape[0])

    # ----- map-function encodings (reference mesh.create_mapping, mesh.py:368-421).
    # Row nf is the appended background row; rasterized fim==-1 indexes it.

    def uv_barycenter(self) -> np.ndarray:
        """Per-face UV barycenter, (nf, 2). mesh.compute_barycenter (mesh.py:156-170)."""
        f = self.f2uvs
        v2 = f[:, 2]
        return v2 + 0.5 * (f[:, 0] - v2) + 0.5 * (f[:, 1] - v2)

    def map_fn(self, name: str) -> np.ndarray:
        """Build a (nf+1, C) face→code table. Mirrors mesh.create_mapping."""
        nf = self.nf
        if name == "uv":
            body = self.uv_barycenter().astype(np.float32)
            bg = np.array([[-1.0, -1.0]], np.float32)
        elif name == "seg":
            body = np.ones((nf, 1), np.float32)
            bg = np.array([[0.0]], np.float32)
        elif name == "uv_seg":
            fbc = self.uv_barycenter().astype(np.float32)
            body = np.concatenate([fbc, np.zeros((nf, 1), np.float32)], axis=1)
            bg = np.array([[0.0, 0.0, 1.0]], np.float32)
        elif name == "par":
            ndim = len(PART_NAMES) + 1
            body = np.zeros((nf, ndim), np.float32)
            for i, part in enumerate(sorted(self.part_faces.keys())):
                body[self.part_faces[part], i] = 1.0
            bg = np.zeros((1, ndim), np.float32)
            bg[0, -1] = 1.0
        elif name == "front":
            body = np.zeros((nf, 1), np.float32)
            body[self.front_faces] = 1.0
            bg = np.zeros((1, 1), np.float32)
        elif name == "head":
            body = np.zeros((nf, 1), np.float32)
            body[self.head_faces] = 1.0
            bg = np.zeros((1, 1), np.float32)
        elif name == "back":  # head minus facial region (mesh.py:344-365)
            body = np.zeros((nf, 1), np.float32)
            back = sorted(set(self.head_faces.tolist()) - set(self.front_faces.tolist()))
            body[np.asarray(back, np.int64)] = 1.0
            bg = np.zeros((1, 1), np.float32)
        elif name == "ids":
            body = np.arange(0, 1, 1.0 / nf, dtype=np.float32)[:nf, None]
            bg = np.array([[-1.0]], np.float32)
        elif name == "binary":
            width = len(np.binary_repr(nf))
            body = np.stack([
                np.array(list(np.binary_repr(i, width=width)), np.float32)
                for i in range(nf)])
            bg = np.zeros((1, width), np.float32) - 1.0
        else:
            raise ValueError(f"unknown map name: {name}")
        return np.concatenate([body, bg], axis=0).astype(np.float32)

    def part_face_ids(self, part_type: str):
        """Mirror of mesh.get_part_face_ids (mesh.py:424-443)."""
        if part_type == "head_front":
            return self.front_faces
        if part_type == "head_back":
            back = sorted(set(self.head_faces.tolist()) - set(self.front_faces.tolist()))
            return np.asarray(back, np.int64)
        if part_type == "par":
            return dict(self.part_faces)
        raise ValueError(f"unknown part type: {part_type}")


def map_fn_dim(map_name: str) -> int:
    """Channel count of each encoding (mesh.get_map_fn_dim, mesh.py:446-473)."""
    # 'binary' is len(bin(nf))+1 = 15 for the real SMPL's 13776 faces
    dims = {"seg": 1, "uv": 2, "uv_seg": 3, "par": 11, "ids": 1,
            "front": 1, "head": 1, "back": 1, "binary": 15}
    if map_name not in dims:
        raise ValueError(f"map name error {map_name}")
    return dims[map_name]


# --------------------------------------------------------------------------
# Real-asset loaders
# --------------------------------------------------------------------------

def _dense(x):
    return np.asarray(x.todense()) if hasattr(x, "todense") else np.asarray(x)


def load_obj_uv(path: str):
    """Parse the UV-mapper OBJ (mesh.load_obj, mesh.py:28-77); returns
    (vts (n,2) with v flipped, faces_vts (nf,3))."""
    vts, faces_vts = [], []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "vt":
                vts.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "f":
                faces_vts.append([int(p.split("/")[1]) - 1 for p in parts[1:4]])
    vts = np.asarray(vts, np.float32)
    vts[:, 1] = 1.0 - vts[:, 1]  # mesh.get_f2vts flips v (mesh.py:181)
    return vts, np.asarray(faces_vts, np.int32)


def load_smpl_assets(
    smpl_pkl: str,
    uv_mapper: str,
    part_info: str | None = None,
    front_info: str | None = None,
    head_info: str | None = None,
) -> SMPLAssets:
    """Load the real SMPL + mapping assets (file layout per reference
    README.md:48-68). Converts everything to dense float32 numpy."""
    with open(smpl_pkl, "rb") as f:
        try:
            dd = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            dd = pickle.load(f, encoding="latin1")

    v_template = np.asarray(dd["v_template"], np.float32)
    nv = v_template.shape[0]
    shapedirs = np.asarray(dd["shapedirs"], np.float32).reshape(-1, NUM_BETAS).T
    posedirs = np.asarray(dd["posedirs"], np.float32).reshape(-1, NUM_POSE_BASIS).T
    j_regressor = _dense(dd["J_regressor"]).astype(np.float32).T.reshape(nv, NUM_JOINTS)
    lbs_weights = np.asarray(dd["weights"], np.float32)
    joint_regressor = _dense(dd["cocoplus_regressor"]).astype(np.float32).T.reshape(nv, NUM_COCOPLUS)
    parents = np.asarray(dd["kintree_table"], np.int64)[0].astype(np.int32)
    parents[0] = -1
    faces = np.asarray(dd["f"], np.int32)

    vts, faces_vts = load_obj_uv(uv_mapper)
    f2uvs = vts[faces_vts]

    def _load_face_set(path):
        with open(path) as fp:
            return np.asarray(json.load(fp)["face"], np.int64)

    nf = faces.shape[0]
    if part_info and os.path.exists(part_info):
        with open(part_info) as fp:
            part_data = json.load(fp)
        part_faces = {k: np.asarray(v["face"], np.int64) for k, v in part_data.items()}
    else:
        part_faces = {PART_NAMES[0]: np.arange(nf, dtype=np.int64)}
    head_faces = _load_face_set(head_info) if head_info and os.path.exists(head_info) else np.arange(0)
    front_faces = _load_face_set(front_info) if front_info and os.path.exists(front_info) else np.arange(0)

    mean_theta = np.zeros(THETA_DIM, np.float32)
    mean_theta[0] = 0.9  # hmr.load_mean_theta inits scale 0.9 (hmr.py:201-208)

    return SMPLAssets(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=j_regressor, lbs_weights=lbs_weights,
        joint_regressor=joint_regressor, parents=parents, faces=faces,
        f2uvs=f2uvs.astype(np.float32), part_faces=part_faces,
        head_faces=head_faces, front_faces=front_faces, mean_theta=mean_theta,
    )


# --------------------------------------------------------------------------
# Synthetic assets (tests / benchmarks; no downloads required)
# --------------------------------------------------------------------------

# Rest-pose joint positions of a ~1.7-unit figure, y-up, origin at pelvis.
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


@lru_cache(maxsize=4)
def synthetic_assets(rings: int = 3, segments: int = 6, seed: int = 0) -> SMPLAssets:
    """Procedural articulated body over the SMPL kinematic tree.

    One open tube of ``rings``×``segments`` vertices per bone (23 bones).
    Shapes/invariants match the real model: blendshape bases, dense
    regressors, LBS weights summing to 1, UV atlas per bone, 10-part
    face table, head/front face sets. Deterministic in ``seed``.

    rings=3, segments=6  -> 414 verts / 552 faces   (test size)
    rings=11, segments=28 -> 7084 verts / 12880 faces (bench size ~ real 6890/13776)
    """
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

    return SMPLAssets(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        lbs_weights=lbs,
        joint_regressor=joint_regressor,
        parents=SMPL_PARENTS.copy(),
        faces=faces,
        f2uvs=f2uvs.astype(np.float32),
        part_faces={k: np.asarray(sorted(v), np.int64) for k, v in part_faces.items() if v},
        head_faces=head_faces,
        front_faces=front_faces,
        mean_theta=mean_theta,
    )


def bench_assets() -> SMPLAssets:
    """Synthetic body at the real SMPL's scale (≈6890 verts / 13776 faces)."""
    return synthetic_assets(rings=11, segments=28)
