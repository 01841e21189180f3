"""Seeded inputs of the camera frame's stage kernels, in numpy only: the CPU
tests (tests/test_torch_camera_stage_kernels.py) and the card tests
(tests/test_torch_cuda.py, which imports no JAX) share them.

keys_case(case) -> (pts (N, C) f32, valid (N,) bool, leaf, inv_leaf): the
voxel filter's key pass (leaf a float and inv_leaf None, or the reverse).
dedup_case(case) -> (pg (M, 3) f32, mask (M,) bool, max_vox): the camera
cloud's voxel dedup.
push_steps(case) -> (dict of the pool's sizes, steps): each step is (the
seed of its image, `push_image_of`, fid, ring update), the update a dict
of rows, ring positions, each entry's kind and the new point count,
applied after the push by `apply_ring_update` (torch, any device).
"""
import numpy as np

from fastlivo_tpu_torch.ops.vio_push import ONE_BARRIER_MAX_R
import torch

VOX = 0.5  # the visual map's voxel
KEYS_CASES = ["lio", "camera", "edges", "wrap", "all_invalid", "n1", "spread", "bits8",
              "bits16", "bits24"]
# the voxel ranges R (x, y, z) of the cases whose every row is valid and
# whose sort rank reaches exactly 2^bits - 1: a digit boundary
BITS_RANGES = {"bits8": (4, 8, 8), "bits16": (16, 64, 64), "bits24": (256, 256, 256)}
DEDUP_CASES = ["cloud", "small", "chain", "duplicates", "overflow", "all_masked", "odd",
               "scratch", "rows24576", "rows40000"]
PUSH_CASES = ["evict", "repush", "f32", "dead", "big"]

HASH = (73856093, 19349663, 83492791)


def keys_case(case, seed=0):
    """The LIO scan (32768 rows of 4 columns, 24000 valid, 0.5 m leaf), the
    camera cloud (the 0.2 m leaf as its f32 reciprocal), and edges:
    NaN and +-inf rows, -0.0, negative coordinates, voxels past +-2^19
    (their keys wrap in 20 bits), one row, no valid row, and a spread of
    +-700 m (2800 voxels a side: the sort's compact rank past 2^32); and
    every row valid in voxel ranges whose product is 2^8, 2^16 or 2^24
    (BITS_RANGES, both corners present: the rank's largest value is
    2^bits - 1, its bit length exactly a digit boundary)."""
    rng = np.random.default_rng(seed)
    n, c, leaf, inv = 32768, 4, 0.5, None
    if case == "camera":
        c, leaf, inv = 3, None, np.float32(1.0) / np.float32(0.2)
    p = rng.uniform(-700 if case == "spread" else -40, 700 if case == "spread" else 40,
                    (n, c)).astype(np.float32)
    valid = rng.random(n) > 0.05
    if case == "lio":
        valid[24000:] = False
    if case in ("edges", "wrap"):
        p[:64, :3] = np.float32(-0.0)
        p[64:100, 1] = np.float32(-0.0)
        p[100, 0], p[101, 1], p[102, 2], p[103] = np.nan, np.inf, -np.inf, np.nan
        p[104:110, 0] = -np.float32(0.25)  # floor to -1
        valid[:110] = True
        valid[103] = False
    if case == "wrap":  # voxels past +-2^19 and far past: 20-bit wrap
        k = np.array([(1 << 19) - 1, 1 << 19, (1 << 19) + 1, -(1 << 19), -(1 << 19) - 1,
                      (1 << 20) + 3, -(1 << 21) - 7, 1 << 40, -(1 << 41) + 5])
        m = len(k)
        p[200:200 + m, 0] = ((k + 0.25) * 0.5).astype(np.float32)
        p[300:300 + m, 1] = ((-k - 0.75) * 0.5).astype(np.float32)
        p[400:400 + m, 2] = ((k * 3) * 0.5).astype(np.float32)
        p[500, :3] = np.float32(3e15)
        valid[200:520] = True
    if case == "all_invalid":
        valid[:] = False
    if case == "n1":
        p, valid = p[:1], np.ones(1, bool)
    if case in BITS_RANGES:
        r = np.array(BITS_RANGES[case])
        k = np.stack([rng.integers(0, x, n) for x in r], 1) - r // 2
        k[0], k[1] = -(r // 2), r - 1 - r // 2  # the corners
        p[:, :3] = ((k + rng.uniform(0.05, 0.95, (n, 3))) * leaf).astype(np.float32)
        valid = np.ones(n, bool)
    return p, valid, leaf, inv


def voxel_hash(k, tb):
    """The dedup's slot of int32 keys (M, 3): wrapping int32 products."""
    k = k.astype(np.int64)
    h = (k[:, 0] * HASH[0]) ^ (k[:, 1] * HASH[1]) ^ (k[:, 2] * HASH[2])
    return (h & 0xFFFFFFFF & (tb - 1)).astype(np.int64)


def _centres(k):
    return ((k.astype(np.float64) + 0.5) * VOX).astype(np.float32)


def _chain_keys(rng, tb, n_same=12, n_next=6):
    """Distinct voxel keys of which `n_same` share one slot and `n_next`
    sit on each of the next four slots: every chain longer than four
    probes."""
    k = rng.integers(-3000, 3000, (1 << 19, 3)).astype(np.int64)
    k = np.unique(k, axis=0)
    h = voxel_hash(k, tb)
    counts = np.bincount(h, minlength=tb)
    best = int(np.argmax(counts[:tb - 4] + np.minimum(counts[1:tb - 3], n_next)))
    pick = [k[h == best][:n_same]]
    for d in range(1, 5):
        pick.append(k[h == best + d][:n_next])
    return np.concatenate(pick)


def dedup_case(case, seed=0):
    """The camera cloud after its voxel filter (M = 8192 rows, into 4096)
    and the small LIVO run's (4096 into 2048); adversarial keys: slot
    chains longer than four probes, exact duplicates and rows sharing a
    voxel, more survivors than max_vox, no masked row, M = 5000 (not a
    power of two), and M = 20000, whose arrays pass the kernel's shared
    memory (its scratch route), M = 24576 (the camera cloud tiled three
    times) and M = 40000 (past 32 rows to each of the kernel's 1024
    threads: its row states in the scratch too)."""
    rng = np.random.default_rng(seed)
    M, max_vox = 8192, 4096
    if case == "small":
        M, max_vox = 4096, 2048
    if case == "odd":
        M, max_vox = 5000, 2500
    if case == "scratch":
        M, max_vox = 20000, 10000
    if case.startswith("rows"):
        M = int(case[4:])
        max_vox = M // 2
    n = int(M * 0.7)
    p = np.zeros((M, 3), np.float32)
    p[:n] = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    p[n // 2:n] = p[:n - n // 2] + rng.normal(0, 0.2, (n - n // 2, 3)).astype(np.float32)
    mask = np.arange(M) < n
    mask[rng.integers(0, n, M // 30)] = False
    tb = 1 << M.bit_length()
    if case == "chain":
        k = _chain_keys(rng, tb)
        c = _centres(k)
        rows = rng.permutation(n)[:3 * len(c)]
        p[rows] = np.concatenate([c, c, c + np.float32(0.1)])  # each key three times
        mask[rows] = True
    if case == "duplicates":
        p[100:400] = p[50]  # exact duplicates of one row
        p[400:600] = p[60] + rng.uniform(-0.01, 0.01, (200, 3)).astype(np.float32)
        p[600:700] = p[:100]
        mask[50:700] = True
    if case == "overflow":
        max_vox = 300
    if case == "all_masked":
        mask[:] = False
    return p, mask, max_vox


def push_image_of(H, W, seed):
    """A frame of pixels below 0, above 255 and at .5 (rounded half to
    even on a u8 pool)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-30, 290, (H, W)).astype(np.float32)
    half = rng.random((H, W)) < 0.2
    img[half] = np.floor(img[half]) + np.float32(0.5)
    img[0, :4] = [0.5, 1.5, 2.5, 254.5]
    return img


def push_steps(case, seed=0, small=True):
    """A pool of R frames and rings of NP x KO entries: `small` 8 slots of
    24 x 32 images over 512 x 6 entries (R 16 over 4096 x 20 for "dead"),
    else the shipped 256 slots of 640 x 512 over 65536 x 20 (300 pushes:
    the pool fills and evicts). Each step pushes a frame
    (`push_image_of` its seed) and then lets a random set of rows observe
    it at a ring position: live entries, and dead ones (a fid whose slot
    no longer holds it, an empty -1, a slot out of range); rows past
    n_pts with live-looking entries. "repush" pushes a live fid again
    every few frames; "f32" is an f32 pool; "big" a u8 pool of
    ONE_BARRIER_MAX_R + 16 slots of 4 x 8 over 256 x 4 entries that holds a
    frame in every slot from the start (sizes["img_fid0"], the pool's
    frame ids before the first push), so that every push evicts (any
    `small`). Returns (sizes, steps), a step (image seed, fid, ring
    update)."""
    rng = np.random.default_rng(seed)
    if case == "big":  # its pool full from the start: sizes["img_fid0"]
        R, NP, KO, H, W, n = ONE_BARRIER_MAX_R + 16, 256, 4, 4, 8, 40
    elif small:
        R, NP, KO, H, W, n = (16, 4096, 20, 24, 32, 40) if case == "dead" else (
            8, 512, 6, 24, 32, 30)
    else:
        R, NP, KO, H, W, n = 256, 1 << 16, 20, 512, 640, 300
    sizes = dict(R=R, NP=NP, KO=KO, H=H, W=W, u8=case != "f32")
    f0 = 0
    if case == "big":  # frame ids 0 .. R - 1 in a random order; pushes from R
        sizes["img_fid0"] = rng.permutation(R).astype(np.int32)
        f0 = R
    steps, n_pts = [], 0
    for f in range(f0, f0 + n):
        fid = f - 3 if case == "repush" and f % 5 == 4 else f
        n_pts = min(NP, n_pts + int(rng.integers(1, max(2, 2 * NP // n))))
        k = int(rng.integers(5, max(6, min(n_pts, NP // 4))))
        rows = rng.choice(NP, size=k, replace=False)
        ring = rng.integers(0, KO, k)
        kind = rng.choice(4, size=k, p=[0.7, 0.1, 0.1, 0.1])  # live, stale, empty, off
        steps.append((seed * 1000 + f, fid, dict(rows=rows, ring=ring, kind=kind,
                                                 n_pts=n_pts)))
    return sizes, steps


def apply_ring_update(m, fid, upd):
    """Write one step's ring entries into the map `m` (in place): a live
    entry observes `fid` at the slot now holding it, a stale one `fid`
    at the next slot, an empty one fid -1, an off one a slot past the
    pool; then the point count."""
    dev = m.obs_fid.device
    R = m.img_fid.shape[0]
    slot = torch.argmax((m.img_fid == fid).to(torch.int32))
    rows = torch.as_tensor(upd["rows"], device=dev).long()
    ring = torch.as_tensor(upd["ring"], device=dev).long()
    kind = torch.as_tensor(upd["kind"], device=dev)
    f = torch.full_like(kind, int(fid), dtype=torch.int32)
    s = torch.where(kind == 1, (slot + 1) % R, slot).to(torch.int32)
    s = torch.where(kind == 3, torch.full_like(s, R + 5), s)
    f = torch.where(kind == 2, torch.full_like(f, -1), f)
    m.obs_slot[rows, ring] = s
    m.obs_fid[rows, ring] = f
    m.n_pts.fill_(int(upd["n_pts"]))
    return m
