"""LOAM-style plane/edge feature extraction (`give_feature`).

Faithful host-side re-implementation of the reference's feature path
(reference: src/preprocess.cpp:466-935): per-ring sequential scan
classifying each point as plane (Poss_Plane/Real_Plane), edge
(Edge_Jump/Edge_Plane), Wire or normal, then emitting decimated /
averaged surf points and raw corner points. Disabled in every shipped
config (`feature_extract_enable: 0`), so this runs host-side in plain
numpy/python — parity first, speed later.

Per-vendor conventions (kept exactly):
  - AVIA: ring `range` is the SQUARED cylindrical radius x^2+y^2
    (:126; `blind` therefore acts in m^2 on this path) and the tag
    filter accepts ONLY (tag & 0x30) == 0x10 (:101; the non-feature
    path also accepts 0x00).
  - OUST64 / VELO16: `range` = sqrt(x^2+y^2) (:218, :364).
  - `dista` is the squared distance to the next point in the ring.

Reference quirks kept: `disA` is assigned twice (0.01 then 0.1,
preprocess.cpp:12-13) so the intended `disB` stays 0 — group distance is
0.1*range (+0).

The port's copy of the JAX package's features.py, with its C++ ring pass
(native/ingest.cpp::give_feature_ring, through the port's native.py).
"""
from __future__ import annotations

import math

import numpy as np

from . import native

# Feature enum (preprocess.h:14)
NOR, POSS_PLANE, REAL_PLANE, EDGE_JUMP, EDGE_PLANE, WIRE, ZERO_POINT = range(7)
# E_jump enum (preprocess.h:16)
NR_NOR, NR_ZERO, NR_180, NR_INF, NR_BLIND = range(5)
PREV, NEXT = 0, 1

# constants (preprocess.cpp:9-30)
INF_BOUND = 10.0
GROUP_SIZE = 8
DIS_A = 0.1  # double-assignment quirk: effective slope
DIS_B = 0.0  # never assigned in the reference
P2L_RATIO = 225.0
LIMIT_MAXMID = 6.25
LIMIT_MIDMIN = 6.25
LIMIT_MAXMIN = 3.24
JUMP_UP_LIMIT = math.cos(170.0 / 180.0 * math.pi)
JUMP_DOWN_LIMIT = math.cos(8.0 / 180.0 * math.pi)
COS160 = math.cos(160.0 / 180.0 * math.pi)
EDGE_A = 2.0
EDGE_B = 0.1
SMALLP_INTERSECT = math.cos(172.5 / 180.0 * math.pi)
SMALLP_RATIO = 1.2


def _plane_judge(pl, rng, dista, blind, i_cur, is_avia):
    """plane_judge (preprocess.cpp:784-882). Returns
    (plane_type, i_nex, curr_direct)."""
    n = len(pl)
    group_dis = DIS_A * rng[i_cur] + DIS_B
    group_dis = group_dis * group_dis
    disarr = []
    i_nex = i_cur
    for i_nex in range(i_cur, i_cur + GROUP_SIZE):
        if i_nex >= n or rng[i_nex] < blind:
            return 2, i_nex, np.zeros(3)
        disarr.append(dista[i_nex])
    i_nex = i_cur + GROUP_SIZE
    vx = vy = vz = 0.0
    while True:
        if i_cur >= n or i_nex >= n:
            break
        if rng[i_nex] < blind:
            return 2, i_nex, np.zeros(3)
        vx = pl[i_nex, 0] - pl[i_cur, 0]
        vy = pl[i_nex, 1] - pl[i_cur, 1]
        vz = pl[i_nex, 2] - pl[i_cur, 2]
        two_dis = vx * vx + vy * vy + vz * vz
        if two_dis >= group_dis:
            break
        disarr.append(dista[i_nex])
        i_nex += 1
    two_dis = vx * vx + vy * vy + vz * vz

    # max squared cross-product vs the chord = width of the group
    leng_wid = 0.0
    seg = pl[i_cur + 1 : i_nex] - pl[i_cur]
    if len(seg):
        v2 = np.cross(seg, np.array([vx, vy, vz]))
        lw = np.sum(v2 * v2, axis=1)
        if len(lw):
            leng_wid = float(np.max(lw))

    # the reference divides by zero for exactly-collinear groups:
    # two_dis^2 / 0 = inf >= P2L_RATIO, so such groups PROCEED to the
    # plane classification (preprocess.cpp:848) — an early return-0
    # guard here inverted that (review r5)
    if leng_wid > 0.0 and (two_dis * two_dis / leng_wid) < P2L_RATIO:
        return 0, i_nex, np.zeros(3)

    disarr_s = sorted(disarr, reverse=True)
    if disarr_s[-2] < 1e-16:
        return 0, i_nex, np.zeros(3)
    m = len(disarr_s)
    if is_avia:
        dismax_mid = disarr_s[0] / disarr_s[m // 2]
        dismid_min = disarr_s[m // 2] / disarr_s[m - 2]
        if dismax_mid >= LIMIT_MAXMID or dismid_min >= LIMIT_MIDMIN:
            return 0, i_nex, np.zeros(3)
    else:
        dismax_min = disarr_s[0] / disarr_s[m - 2]
        if dismax_min >= LIMIT_MAXMIN:
            return 0, i_nex, np.zeros(3)

    d = np.array([vx, vy, vz])
    nrm = np.linalg.norm(d)
    return 1, i_nex, (d / nrm if nrm > 0 else d)


def _edge_jump_judge(rng, dista, blind, i, nor_dir):
    """edge_jump_judge (preprocess.cpp:900-934)."""
    n = len(rng)
    if nor_dir == PREV:
        if i < 2 or rng[i - 1] < blind or rng[i - 2] < blind:
            return False
    else:
        if i + 2 >= n or rng[i + 1] < blind or rng[i + 2] < blind:
            return False
    d1 = dista[i + nor_dir - 1]
    d2 = dista[i + 3 * nor_dir - 2]
    if d1 < d2:
        d1, d2 = d2, d1
    d1, d2 = math.sqrt(d1), math.sqrt(d2)
    if d1 > EDGE_A * d2 or (d1 - d2) > EDGE_B:
        return False
    return True


def give_feature(pl, curvature, rng, dista, blind, point_filter_num,
                 is_avia=True):
    """The full give_feature pass over ONE ring (preprocess.cpp:466-782).

    Args:
      pl: (N, 3) ring points in scan order; curvature: (N,) per-point
      times (ms); rng/dista: the vendor's range and squared-step arrays;
      blind: the vendor's blind threshold (same units as rng).

    Returns (surf (S, 4) [x y z curvature], corn (C, 4)).
    """
    pl = np.asarray(pl, np.float64)
    n = len(pl)
    if n == 0:
        return np.zeros((0, 4)), np.zeros((0, 4))
    ftype = np.full(n, NOR, np.int32)
    edj = np.full((n, 2), NR_NOR, np.int32)
    intersect = np.full(n, 2.0)

    head = 0
    while head < n and rng[head] < blind:
        head += 1

    # --- pass 1: plane groups (:483-589) --------------------------------
    plsize2 = n - GROUP_SIZE if n > GROUP_SIZE else 0
    last_state = 0
    last_direct = np.zeros(3)
    i = head
    while i < plsize2:
        if rng[i] < blind:
            i += 1
            continue
        plane_type, i_nex, curr_direct = _plane_judge(
            pl, rng, dista, blind, i, is_avia
        )
        if plane_type == 1:
            for j in range(i, min(i_nex, n - 1) + 1):
                if j != i and j != i_nex:
                    ftype[j] = REAL_PLANE
                else:
                    ftype[j] = POSS_PLANE
            if last_state == 1 and np.linalg.norm(last_direct) > 0.1:
                mod = float(last_direct @ curr_direct)
                if -0.707 < mod < 0.707:
                    ftype[i] = EDGE_PLANE
                else:
                    ftype[i] = REAL_PLANE
            i = i_nex - 1
            last_state = 1
        else:
            i = i_nex
            last_state = 0
        last_direct = curr_direct
        i += 1

    # --- pass 2: edge jumps (:590-686) ----------------------------------
    plsize2 = n - 3 if n > 3 else 0
    for i in range(head + 3, plsize2):
        if rng[i] < blind or ftype[i] >= REAL_PLANE:
            continue
        if dista[i - 1] < 1e-16 or dista[i] < 1e-16:
            continue
        vec_a = pl[i]
        vecs = [None, None]
        for j, m in ((PREV, -1), (NEXT, 1)):
            if rng[i + m] < blind:
                edj[i, j] = NR_INF if rng[i] > INF_BOUND else NR_BLIND
                continue
            v = pl[i + m] - vec_a
            vecs[j] = v
            na = np.linalg.norm(vec_a)
            nv = np.linalg.norm(v)
            ang = float(vec_a @ v) / (na * nv) if na * nv > 0 else 2.0
            if ang < JUMP_UP_LIMIT:
                edj[i, j] = NR_180
            elif ang > JUMP_DOWN_LIMIT:
                edj[i, j] = NR_ZERO
        if vecs[PREV] is not None and vecs[NEXT] is not None:
            np_, nn = np.linalg.norm(vecs[PREV]), np.linalg.norm(vecs[NEXT])
            if np_ * nn > 0:
                intersect[i] = float(vecs[PREV] @ vecs[NEXT]) / (np_ * nn)
        if (edj[i, PREV] == NR_NOR and edj[i, NEXT] == NR_ZERO
                and dista[i] > 0.0225 and dista[i] > 4 * dista[i - 1]):
            if intersect[i] > COS160 and _edge_jump_judge(rng, dista, blind, i, PREV):
                ftype[i] = EDGE_JUMP
        elif (edj[i, PREV] == NR_ZERO and edj[i, NEXT] == NR_NOR
              and dista[i - 1] > 0.0225 and dista[i - 1] > 4 * dista[i]):
            if intersect[i] > COS160 and _edge_jump_judge(rng, dista, blind, i, NEXT):
                ftype[i] = EDGE_JUMP
        elif edj[i, PREV] == NR_NOR and edj[i, NEXT] == NR_INF:
            if _edge_jump_judge(rng, dista, blind, i, PREV):
                ftype[i] = EDGE_JUMP
        elif edj[i, PREV] == NR_INF and edj[i, NEXT] == NR_NOR:
            if _edge_jump_judge(rng, dista, blind, i, NEXT):
                ftype[i] = EDGE_JUMP
        elif edj[i, PREV] > NR_NOR and edj[i, NEXT] > NR_NOR:
            if ftype[i] == NOR:
                ftype[i] = WIRE

    # --- pass 3: small planes (:688-727) --------------------------------
    for i in range(head + 1, n - 1):
        if rng[i] < blind or rng[i - 1] < blind or rng[i + 1] < blind:
            continue
        if dista[i - 1] < 1e-8 or dista[i] < 1e-8:
            continue
        if ftype[i] == NOR:
            ratio = (dista[i - 1] / dista[i] if dista[i - 1] > dista[i]
                     else dista[i] / dista[i - 1])
            if intersect[i] < SMALLP_INTERSECT and ratio < SMALLP_RATIO:
                if ftype[i - 1] == NOR:
                    ftype[i - 1] = REAL_PLANE
                if ftype[i + 1] == NOR:
                    ftype[i + 1] = REAL_PLANE
                ftype[i] = REAL_PLANE

    # --- pass 4: emission (:729-782) -------------------------------------
    surf, corn = [], []
    last_surface = -1
    for j in range(head, n):
        if ftype[j] in (POSS_PLANE, REAL_PLANE):
            if last_surface == -1:
                last_surface = j
            if j == last_surface + point_filter_num - 1:
                surf.append([pl[j, 0], pl[j, 1], pl[j, 2], curvature[j]])
                last_surface = -1
        else:
            if ftype[j] in (EDGE_JUMP, EDGE_PLANE):
                corn.append([pl[j, 0], pl[j, 1], pl[j, 2], curvature[j]])
            if last_surface != -1:
                ap = pl[last_surface:j].mean(axis=0)
                ac = float(np.mean(curvature[last_surface:j]))
                surf.append([ap[0], ap[1], ap[2], ac])
            last_surface = -1
    return np.asarray(surf).reshape(-1, 4), np.asarray(corn).reshape(-1, 4)


def extract_features_rings(xyz, curvature_ms, ring, blind, point_filter_num,
                           n_scans, lidar_type):
    """Group a decoded scan by ring, apply the vendor range/dista
    conventions, run give_feature per ring (the handlers' feature
    branches, preprocess.cpp:93-135, :174-230, :300-430).

    Returns (surf (S, 4) [x y z t_ms], corn (C, 4))."""
    from .config import AVIA

    xyz = np.asarray(xyz, np.float64)
    is_avia = lidar_type == AVIA
    surf_all, corn_all = [], []
    for r in range(n_scans):
        m = np.where(np.asarray(ring) == r)[0]
        if len(m) <= 5:  # avia skips rings with <=5 pts (:118)
            continue
        pl = xyz[m]
        if is_avia:
            rng = pl[:, 0] ** 2 + pl[:, 1] ** 2  # squared (:126)
        else:
            rng = np.sqrt(pl[:, 0] ** 2 + pl[:, 1] ** 2)  # (:218/:364)
        d = np.diff(pl, axis=0)
        dista = np.concatenate([np.sum(d * d, axis=1), [0.0]])
        # the C++ ring pass (~3 orders faster than the Python loops; equal
        # to give_feature, tests/test_torch_native.py), else give_feature
        got = native.give_feature_ring_native(
            pl, np.asarray(curvature_ms)[m], rng, dista, blind,
            point_filter_num, is_avia)
        if got is None:
            got = give_feature(pl, np.asarray(curvature_ms)[m], rng, dista,
                               blind, point_filter_num, is_avia)
        s, c = got
        surf_all.append(s)
        corn_all.append(c)
    if surf_all:
        return np.concatenate(surf_all), np.concatenate(corn_all)
    return np.zeros((0, 4)), np.zeros((0, 4))
