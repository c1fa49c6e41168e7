"""3D box geometry: corner construction and IoU.

A copy (numpy only) of ``pointcontrast_tpu/detect/box_util.py``.

Behavioral mirror of
reference downstream/votenet_det_new/lib/utils/box_util.py:16-305
(get_3d_box / box3d_iou and helpers), vectorized numpy where the reference
loops.  Boxes use the VoteNet upright-camera convention: heading is a
rotation about +Y, box dims are (l, w, h) along (x, z, y), corners ordered
so that corners[0:4] is the top face and corners[4:8] the bottom.
"""
from __future__ import annotations

import numpy as np


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def roty_batch(t: np.ndarray) -> np.ndarray:
    """[...,] angles -> [..., 3, 3] rotation matrices about +Y."""
    t = np.asarray(t)
    out = np.zeros(t.shape + (3, 3))
    c, s = np.cos(t), np.sin(t)
    out[..., 0, 0] = c
    out[..., 0, 2] = s
    out[..., 1, 1] = 1
    out[..., 2, 0] = -s
    out[..., 2, 2] = c
    return out


def get_3d_box(box_size, heading_angle, center) -> np.ndarray:
    """(l, w, h), heading, center -> [8, 3] corners (box_util.py get_3d_box)."""
    l, w, h = box_size
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2.0
    y = np.array([h, h, h, h, -h, -h, -h, -h]) / 2.0
    z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    r = roty_batch(np.asarray(heading_angle))
    corners = np.stack([x, y, z], axis=0)  # [3, 8]
    return (r @ corners).T + np.asarray(center)


def get_3d_box_batch(box_size, heading_angle, center) -> np.ndarray:
    """Batched corner construction: [..., 3], [...], [..., 3] -> [..., 8, 3]."""
    box_size = np.asarray(box_size)
    center = np.asarray(center)
    l, w, h = box_size[..., 0], box_size[..., 1], box_size[..., 2]
    tmpl = np.array(
        [
            [1, 1, 1], [1, 1, -1], [-1, 1, -1], [-1, 1, 1],
            [1, -1, 1], [1, -1, -1], [-1, -1, -1], [-1, -1, 1],
        ],
        dtype=np.float64,
    )  # signs for (x=l, y=h, z=w)
    dims = np.stack([l, h, w], axis=-1)[..., None, :] / 2.0  # [..., 1, 3]
    corners = tmpl * dims  # [..., 8, 3]
    r = roty_batch(heading_angle)  # [..., 3, 3]
    corners = np.einsum("...ij,...kj->...ki", r, corners)
    return corners + center[..., None, :]


def polygon_clip(subject: np.ndarray, clip: np.ndarray):
    """Sutherland–Hodgman convex polygon clipping; vertices [N, 2] CCW or CW
    consistently.  Returns the clipped polygon or None if empty."""
    def inside(p, a, b):
        # non-strict: points exactly on the clip edge count as inside, so
        # identical polygons clip to themselves instead of vanishing
        return (b[0] - a[0]) * (p[1] - a[1]) >= (b[1] - a[1]) * (p[0] - a[0])

    def intersection(p1, p2, a, b):
        dc = (a[0] - b[0], a[1] - b[1])
        dp = (p1[0] - p2[0], p1[1] - p2[1])
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p1[0] * p2[1] - p1[1] * p2[0]
        denom = dc[0] * dp[1] - dc[1] * dp[0]
        if abs(denom) < 1e-12:
            return p2
        return (
            (n1 * dp[0] - n2 * dc[0]) / denom,
            (n1 * dp[1] - n2 * dc[1]) / denom,
        )

    output = [tuple(p) for p in subject]
    a = tuple(clip[-1])
    for b in clip:
        b = tuple(b)
        if not output:
            return None
        input_list = output
        output = []
        s = input_list[-1]
        for p in input_list:
            if inside(p, a, b):
                if not inside(s, a, b):
                    output.append(intersection(s, p, a, b))
                output.append(p)
            elif inside(s, a, b):
                output.append(intersection(s, p, a, b))
            s = p
        a = b
    return np.array(output) if output else None


def poly_area(poly: np.ndarray) -> float:
    """Shoelace area of a [N, 2] polygon."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def convex_hull_intersection(p1: np.ndarray, p2: np.ndarray):
    inter = polygon_clip(p1, p2)
    if inter is None or len(inter) < 3:
        return None, 0.0
    return inter, poly_area(inter)


def box3d_vol(corners: np.ndarray) -> float:
    a = np.linalg.norm(corners[0] - corners[1])
    b = np.linalg.norm(corners[1] - corners[2])
    c = np.linalg.norm(corners[0] - corners[4])
    return a * b * c


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray):
    """3D IoU of two [8, 3] corner boxes (top face first) -> (iou3d, iou2d).

    BEV overlap via convex polygon intersection in the x-z plane, times the
    y-extent overlap (box_util.py box3d_iou)."""
    # top-face corners reversed to counter-clockwise order in the x-z plane
    # (Sutherland-Hodgman needs a consistent CCW winding)
    rect1 = corners1[3::-1, [0, 2]]
    rect2 = corners2[3::-1, [0, 2]]
    area1 = poly_area(rect1)
    area2 = poly_area(rect2)
    _, inter_area = convex_hull_intersection(rect1, rect2)
    iou_2d = inter_area / max(area1 + area2 - inter_area, 1e-12)
    ymax = min(corners1[:, 1].max(), corners2[:, 1].max())
    ymin = max(corners1[:, 1].min(), corners2[:, 1].min())
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1 = box3d_vol(corners1)
    vol2 = box3d_vol(corners2)
    return inter_vol / max(vol1 + vol2 - inter_vol, 1e-12), iou_2d


def get_iou_obb(bb1: np.ndarray, bb2: np.ndarray) -> float:
    iou3d, _ = box3d_iou(bb1, bb2)
    return iou3d


def flip_axis_to_camera(pc: np.ndarray) -> np.ndarray:
    """X-right,Y-forward,Z-up -> X-right,Y-down,Z-forward
    (ap_helper.py:18-25)."""
    pc2 = np.copy(pc)
    pc2[..., [0, 1, 2]] = pc2[..., [0, 2, 1]]
    pc2[..., 1] *= -1
    return pc2


def flip_axis_to_depth(pc: np.ndarray) -> np.ndarray:
    pc2 = np.copy(pc)
    pc2[..., [0, 1, 2]] = pc2[..., [0, 2, 1]]
    pc2[..., 2] *= -1
    return pc2


def extract_pc_in_box3d(pc: np.ndarray, box3d: np.ndarray):
    """Points inside an upright (axis-aligned in x,y + z-extent) rotated box:
    BEV point-in-polygon + height range (sunrgbd_utils.extract_pc_in_box3d)."""
    poly = box3d[:4, :2]
    zmin, zmax = box3d[:, 2].min(), box3d[:, 2].max()
    inside = _points_in_poly(pc[:, :2], poly)
    inside &= (pc[:, 2] >= zmin) & (pc[:, 2] <= zmax)
    return pc[inside], inside


def _points_in_poly(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized ray-casting point-in-polygon."""
    n = len(poly)
    inside = np.zeros(len(pts), dtype=bool)
    x, y = pts[:, 0], pts[:, 1]
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        crosses = ((yi > y) != (yj > y)) & (
            x < (xj - xi) * (y - yi) / (yj - yi + 1e-12) + xi
        )
        inside ^= crosses
        j = i
    return inside
