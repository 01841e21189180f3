"""Batched image sampling: patches, gradients, Shi-Tomasi scores.

Port of the JAX package's ops/image.py (the reference's per-pixel loops):
  - `extract_patches` = LidarSelector::getpatch (lidar_selection.cpp:
    119-140): scale-strided bilinear patches; the integer anchor is
    floor(px/scale)*scale and the bilinear weights come from the
    scale-normalized remainder.
  - `patches_and_grads` = the sampling and centred-difference gradients
    of UpdateState's inner loop (lidar_selection.cpp:805-832). This is
    the plain version of the CUDA kernel (ops/patches_grads.py); it
    evaluates every product and sum in the order the kernel does.
  - `shi_tomasi` = vk::shiTomasiScore: the smaller eigenvalue of the
    8x8-box structure tensor at integer pixel positions, its box sums in
    the order of the camera-frame kernels (`halving_sum`).
  - `affine_warp_patches` = LidarSelector::warpAffine.

Every function is batched over the leading point axis and gathers with
clamped indices (callers gate with in-frame borders first).
"""
from __future__ import annotations

import torch


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    yi = torch.clamp(yi, 0, H - 1).long()
    xi = torch.clamp(xi, 0, W - 1).long()
    return img[yi, xi]


def bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at float pixel coords uv (..., 2) [u=col, v=row]."""
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    au = u - u0
    av = v - v0
    tl = _gather(img, v0, u0)
    tr = _gather(img, v0, u0 + 1)
    bl = _gather(img, v0 + 1, u0)
    br = _gather(img, v0 + 1, u0 + 1)
    return ((1 - au) * (1 - av) * tl + au * (1 - av) * tr
            + (1 - au) * av * bl + au * av * br)


def _scale_vec(scale, pc: torch.Tensor) -> torch.Tensor:
    """`scale` (int or int tensor) as a (K,) int32 tensor on pc's device."""
    scale = torch.as_tensor(scale, dtype=torch.int32, device=pc.device)
    if scale.ndim == 0:
        scale = scale.expand(pc.shape[:-1])
    return scale


def _anchor_weights(pc: torch.Tensor, scale: torch.Tensor):
    """getpatch's anchor and weights: integer anchor floor(px/scale)*scale,
    weights from the scale-normalized remainder."""
    u, v = pc[..., 0], pc[..., 1]
    sf = scale.to(pc.dtype)
    u_i = torch.floor(u / sf).to(torch.int32) * scale
    v_i = torch.floor(v / sf).to(torch.int32) * scale
    su = (u - u_i) / sf
    sv = (v - v_i) / sf
    w_tl = (1.0 - su) * (1.0 - sv)
    w_tr = su * (1.0 - sv)
    w_bl = (1.0 - su) * sv
    w_br = su * sv
    return u_i, v_i, (w_tl, w_tr, w_bl, w_br)


def _tap_grid(img, u_i, v_i, scale, n: int, origin: int):
    """(K, n, n) taps img[v_i + (e-origin)*s, u_i + (f-origin)*s], each
    index clamped to the image."""
    ext = torch.arange(n, dtype=torch.int32, device=img.device) - origin
    s = scale[:, None, None]
    rows = v_i[:, None, None] + ext[None, :, None] * s
    cols = u_i[:, None, None] + ext[None, None, :] * s
    K = u_i.shape[0]
    return _gather(img, rows.expand(K, n, n), cols.expand(K, n, n))


def extract_patches(img: torch.Tensor, pc: torch.Tensor, patch_size: int,
                    scale) -> torch.Tensor:
    """getpatch for a batch: (K, 2) centres -> (K, P, P) patches. `scale`
    is 1 << level (int or (K,) int tensor). Output[x, y]: x runs over
    rows (v), y over columns (u), the reference's layout."""
    scale = _scale_vec(scale, pc)
    u_i, v_i, (w_tl, w_tr, w_bl, w_br) = _anchor_weights(pc, scale)
    P = patch_size
    R = _tap_grid(img, u_i, v_i, scale, P + 1, P // 2)
    w = lambda a: a[:, None, None]  # noqa: E731
    return (w(w_tl) * R[:, :P, :P] + w(w_tr) * R[:, :P, 1:]
            + w(w_bl) * R[:, 1:, :P] + w(w_br) * R[:, 1:, 1:])


def patches_and_grads(img: torch.Tensor, pc: torch.Tensor, patch_size: int,
                      scale):
    """UpdateState's fused sample + gradient pass: (val, du, dv), each
    (K, P, P). du/dv are 0.5*(I(+s) - I(-s)) centred differences of the
    bilinear-weighted strided samples, divided by the scale (Jimg *=
    1/scale, :826). Every sample lies on one (P+3)x(P+3) strided tap
    grid around the anchor, gathered once."""
    scale = _scale_vec(scale, pc)
    u_i, v_i, (w_tl, w_tr, w_bl, w_br) = _anchor_weights(pc, scale)
    P = patch_size
    R = _tap_grid(img, u_i, v_i, scale, P + 3, P // 2 + 1)
    w = lambda a: a[:, None, None]  # noqa: E731

    def sample(a, b):
        # offsets in stride units, a, b in {-1, 0, 1}; grid origin at 1
        r0, c0 = 1 + a, 1 + b
        return (w(w_tl) * R[:, r0:r0 + P, c0:c0 + P]
                + w(w_tr) * R[:, r0:r0 + P, c0 + 1:c0 + P + 1]
                + w(w_bl) * R[:, r0 + 1:r0 + P + 1, c0:c0 + P]
                + w(w_br) * R[:, r0 + 1:r0 + P + 1, c0 + 1:c0 + P + 1])

    val = sample(0, 0)
    sf = scale[:, None, None].to(img.dtype)
    du = 0.5 * (sample(0, 1) - sample(0, -1)) / sf
    dv = 0.5 * (sample(1, 0) - sample(-1, 0)) / sf
    return val, du, dv


def halving_sum(x: torch.Tensor, width: int = 64) -> torch.Tensor:
    """Sum over the last axis in the camera-frame kernels' order: the
    axis padded with zeros to `width` (a power of two, at least its
    length), then halved until one is left (element i plus element
    i + width/2, then i + width/4, ...): a warp's shuffle tree over two
    elements a lane."""
    n = x.shape[-1]
    if n > width or width & (width - 1):
        raise ValueError(f"halving_sum: {n} elements in a width of {width}")
    if n < width:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], width - n))], dim=-1)
    s = width // 2
    while s:
        x = x[..., :s] + x[..., s:2 * s]
        s //= 2
    return x[..., 0]


def shi_tomasi(img: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """vk::shiTomasiScore at integer positions floor(pc): (K, 2) -> (K,).

    Per point the 8x8 window rooted at (v-4, u-4) of centred-difference
    gradients (every index clamped to the image: the JAX package's
    edge-padded gradient maps and reduce_window), its three products
    summed by `halving_sum` over the window's 64 taps in row-major order
    (the kernels' order; the JAX package's reduce_window adds in its own:
    a few ulp), over the half box area; then the smaller eigenvalue."""
    half = 4
    box = 2 * half
    area = box * box / 2.0
    H, W = img.shape
    u = torch.clamp(torch.floor(pc[..., 0]).to(torch.int32), 0, W - 1)
    v = torch.clamp(torch.floor(pc[..., 1]).to(torch.int32), 0, H - 1)
    off = torch.arange(box, dtype=torch.int32, device=img.device) - half
    r = torch.clamp(v[:, None] + off, 0, H - 1)[:, :, None].expand(-1, box, box)
    c = torch.clamp(u[:, None] + off, 0, W - 1)[:, None, :].expand(-1, box, box)
    gx = 0.5 * (_gather(img, r, c + 1) - _gather(img, r, c - 1))
    gy = 0.5 * (_gather(img, r + 1, c) - _gather(img, r - 1, c))
    K = pc.shape[0]
    flat = lambda t: t.reshape(K, box * box)  # noqa: E731
    xx = halving_sum(flat(gx * gx)) / area
    yy = halving_sum(flat(gy * gy)) / area
    xy = halving_sum(flat(gx * gy)) / area
    tr = xx + yy
    det = xx * yy - xy * xy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    return 0.5 * (tr - disc)


def affine_warp_patches(
    ref_imgs: torch.Tensor,  # (R, H, W) reference image pool (f32 or u8)
    slots: torch.Tensor,  # (K,) int32 pool slot per point
    A_ref_cur: torch.Tensor,  # (K, 2, 2) inverse warp (cur -> ref pixels)
    px_ref: torch.Tensor,  # (K, 2) reference pixel
    patch_size: int,
    search_level: torch.Tensor,  # (K,) int32
    pyramid_level: int,
) -> torch.Tensor:
    """LidarSelector::warpAffine batched over points (lidar_selection.cpp:
    258-296): for patch offset d, sample the ref image at px_ref +
    A_ref_cur @ (d * 2^(search+pyr)). Out-of-image samples are 0. The
    pool may be u8: the taps are cast to the pixel coordinates' dtype
    after the gather. -> (K, P, P)."""
    half = patch_size // 2
    cdt = px_ref.dtype
    offs = (torch.arange(patch_size, device=px_ref.device) - half).to(cdt)
    sc = (1 << pyramid_level) * torch.bitwise_left_shift(
        torch.ones_like(search_level, dtype=torch.int32),
        search_level.to(torch.int32)).to(cdt)  # (K,)
    dx = offs[None, None, :] * sc[:, None, None]  # (K, 1, P) u-offset
    dy = offs[None, :, None] * sc[:, None, None]  # (K, P, 1) v-offset
    a = A_ref_cur
    du = a[:, 0, 0][:, None, None] * dx + a[:, 0, 1][:, None, None] * dy
    dv = a[:, 1, 0][:, None, None] * dx + a[:, 1, 1][:, None, None] * dy
    u = px_ref[:, 0][:, None, None] + du  # (K, P, P)
    v = px_ref[:, 1][:, None, None] + dv
    H, W = ref_imgs.shape[1:]
    inb = (u >= 0) & (v >= 0) & (u < W - 1) & (v < H - 1)
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    au = u - u0
    av = v - v0
    sl = slots.long()[:, None, None]

    def g(rr, cc):
        rr = torch.clamp(rr, 0, H - 1).long()
        cc = torch.clamp(cc, 0, W - 1).long()
        return ref_imgs[sl, rr, cc].to(cdt)

    val = ((1 - au) * (1 - av) * g(v0, u0) + au * (1 - av) * g(v0, u0 + 1)
           + (1 - au) * av * g(v0 + 1, u0) + au * av * g(v0 + 1, u0 + 1))
    return torch.where(inb, val, torch.zeros_like(val))
