// The camera frame's selection in one launch, for Hopper: the tracked
// map points with their warped reference patches, and the new points.
//
// vio_select replaces the jitted XLA code of the JAX package's
// fastlivo_tpu/vio.py::select_tracked (:130-401, jitted at :125-129) and
// select_new_points (:408-484, jitted at :404-407); no Pallas kernel. Its
// plain version is the port's vio.select_tracked followed by
// vio.select_new_points, every expression of which this kernel evaluates
// in the same order (built with -fmad=false). Over one cooperative launch:
//   reset: the depth image's owner per pixel to -1, the per-cell keys to
//   INT64_MAX and cell_value to 0; grid barrier;
//   rows, one warp per row of the scan cloud pg (M): the camera-frame
//   point, the depth image's pinhole pixel, whose owner is the highest
//   row there (an int atomicMax; ops/voxel_map._last_wins' "the last row
//   wins"), the distorted pixel, the in-frame gate, the Shi-Tomasi score
//   (vio_common.cuh, the warp's fixed-order box sums) and the per-cell
//   minimum of (inverted score bits, row) (an int64 atomicMin);
//   one thread per scan voxel (Nv): the feat_map probe
//   (visual_map.gather_voxel_points, max_probe slots, the first hit) and
//   for each of its VC point slots the projection, the gates, the per-cell
//   minimum of (distance bits, row) and the per-cell maximum of the map
//   value as an int32 atomicMax on the f32 bits from 0 (so a value not
//   above 0 leaves the 0); grid barrier;
//   cells, one warp per image grid cell (G): the winner's geometry, the
//   (P+1)^2 depth-continuity window (the depth of a pixel is its owner
//   row's z, else 0), visual_map.close_view_obs over the KO observations
//   (a lane each, first maximum), the affine warp and its search level,
//   the warped patches at pyramid levels 0-2 from the u8 or f32 pool
//   (ops/image.affine_warp_patches), extract_patches at level 0, the
//   error and the outlier gate and, with ncc_en, the NCC gate (every sum
//   over a patch in image.halving_sum's order), and the cell's new point:
//   its winner row and whether it beats cell_value.
// Only integer atomics (a min or max is order-free), no float atomics:
// the same bits on every launch and any grid.
//
// Bound (chip_smoke.py's vio_select_bound_ms): the bytes of the scan
// cloud, the voxel set, the map rows the probes and candidates touch, the
// KO-observation rings of the G winners, the taps of the image windows
// and of the patches, and the outputs, once each, over HBM bandwidth; the
// operations are far below the f32 rate. The owner image's reset is
// scratch and not counted. What holds the launch above that: two grid
// barriers, the serial chain of a cell (eight undistortion steps three
// times, the warp and 3 x P² taps), and the reset of the 1.3 MB owner
// image. Design: one cooperative, persistent launch of as many 256-thread
// blocks as are co-resident; the depth image is never written (a pixel's
// depth is read through its owner row), and nothing is read back to the
// host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "vio_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_P = 8;  // P * P <= 64: two pixels a lane
constexpr long long KEY_NONE = 0x7FFFFFFFFFFFFFFFLL;
constexpr float DEPTH_CONT_GATE = 1.5f;  // vio.DEPTH_CONT_GATE

struct Sel {
  // the visual map
  const float* pos;          // (NP, 3)
  const float* value;        // (NP,)
  const float* obs_px;       // (NP, KO, 2)
  const float* obs_rcw;      // (NP, KO, 3, 3)
  const float* obs_pcw;      // (NP, KO, 3)
  const int32_t* obs_slot;   // (NP, KO)
  const int32_t* obs_fid;    // (NP, KO)
  const int32_t* vox_keys;   // (T,)
  const int32_t* vox_count;  // (T,)
  const int32_t* vox_idx;    // (T, VC)
  const void* imgs;          // (R, H, W) u8 or f32
  const int32_t* img_fid;    // (R,)
  // the frame
  const float *fx, *fy, *cx, *cy, *dist;
  const float* rcw;         // (3, 3)
  const float* pcw;         // (3,)
  const float* img;         // (H, W)
  const float* pg;          // (M, 3)
  const uint8_t* pg_mask;   // (M,)
  const int32_t* vox;       // (Nv, 3)
  const uint8_t* vox_mask;  // (Nv,)
  const float* out_thr;     // ()
  const float* ncc_thr;     // ()
  // scratch
  long long* tkey;  // (G,) tracked: (distance bits, candidate row)
  long long* nkey;  // (G,) new: (inverted score bits, scan row)
  int32_t* owner;    // (H * W,) the depth image's row per pixel, -1 none
  int32_t* cidx;     // (NC,) the candidates' point indices
  float* zrow;       // (M,) the rows' depth
  float* pcn;        // (M, 2) the rows' pixels
  float* score;      // (M,) the rows' Shi-Tomasi scores
  // outputs: the TrackedSet and the new points
  int32_t* idx;       // (G,)
  float* wpos;        // (G, 3)
  float* patch;       // (G, 3, P, P)
  int32_t* slevel;    // (G,)
  uint8_t* valid;     // (G,)
  float* cell_value;  // (G,)
  float* errors;      // (G,)
  float* npos;        // (G, 3)
  float* npx;         // (G, 2)
  float* nscore;      // (G,)
  uint8_t* nadd;      // (G,)
  int NP, KO, T, VC, R, H, W, M, Nv, NC, G, gh, P, border, ncc_en, max_probe, imgs_u8;
  float inv_grid, inv_half, inv_n;
};

__device__ __forceinline__ float pool_at(const Sel& s, int slot, int r, int c) {
  r = vio::clampi(r, 0, s.H - 1);
  c = vio::clampi(c, 0, s.W - 1);
  const size_t e = ((size_t)slot * s.H + r) * s.W + c;
  return s.imgs_u8 ? (float)__ldg(static_cast<const uint8_t*>(s.imgs) + e)
                   : __ldg(static_cast<const float*>(s.imgs) + e);
}

__device__ __forceinline__ float img_at(const Sel& s, int r, int c) {
  return __ldg(s.img + (size_t)vio::clampi(r, 0, s.H - 1) * s.W + vio::clampi(c, 0, s.W - 1));
}

// One row of the scan cloud, by a whole warp (the Shi-Tomasi sums).
__device__ void scan_row(const Sel& s, const vio::Cam& cam, const float* rcw, const float* pcw,
                         int r, int lane) {
  const float p[3] = {__ldg(s.pg + 3 * r), __ldg(s.pg + 3 * r + 1), __ldg(s.pg + 3 * r + 2)};
  const bool mask = __ldg(s.pg_mask + r) != 0;
  float pt[3];
  vio::rows_times_add(p, rcw, pcw, pt);
  const float z = pt[2];
  // select_tracked phase 1: the sparse depth image, plain pinhole
  const float ud = (cam.fx * pt[0]) / z + cam.cx;
  const float vd = (cam.fy * pt[1]) / z + cam.cy;
  const float lo = (float)s.border;
  const bool ok_d = mask && z > 0.0f && ud >= lo && ud < (float)(s.W - s.border) && vd >= lo &&
                    vd < (float)(s.H - s.border);
  // select_new_points: projection, gate, score, per-cell argmax key
  float pu, pv;
  vio::world2cam(cam, pt, pu, pv);
  const bool ok = mask && z > 0.0f && vio::in_frame(pu, pv, s.W, s.H, s.border);
  const float sc = vio::shi_tomasi_warp(s.img, s.H, s.W, pu, pv, lane);
  if (lane != 0) return;
  if (ok_d) {
    s.zrow[r] = z;
    atomicMax(s.owner + (size_t)(int)vd * s.W + (int)ud, r);
  }
  s.pcn[2 * r] = pu;
  s.pcn[2 * r + 1] = pv;
  s.score[r] = sc;
  if (ok) {
    const int32_t inv = (int32_t)(0x7FFFFFFFu - (uint32_t)__float_as_int(vio::clamp_min(sc, 0.0f)));
    const long long key =
        (long long)(((unsigned long long)(long long)inv << 20) | (unsigned long long)r);
    atomicMin(s.nkey + vio::cell_of(pu, pv, s.inv_grid, s.gh, s.G), key);
  }
}

// One scan voxel's feat_map lookup and its VC candidate rows.
__device__ void voxel_rows(const Sel& s, const vio::Cam& cam, const float* rcw, const float* pcw,
                           const float* campos, int v) {
  const int tmask = s.T - 1;
  int slot;
  int32_t check;
  vio::slot_check(__ldg(s.vox + 3 * v), __ldg(s.vox + 3 * v + 1), __ldg(s.vox + 3 * v + 2),
                  tmask, slot, check);
  const int32_t q = __ldg(s.vox_mask + v) ? check : vio::EMPTY + 1;
  int safe = 0;
  bool found = false;
  for (int p = 0; p < s.max_probe; ++p) {
    const int probe = (slot + p) & tmask;
    if (__ldg(s.vox_keys + probe) == q) {
      safe = probe;
      found = true;
      break;
    }
  }
  const int cnt = found ? __ldg(s.vox_count + safe) : 0;
  for (int j = 0; j < s.VC; ++j) {
    const int r = v * s.VC + j;
    const int32_t ci = __ldg(s.vox_idx + (size_t)safe * s.VC + j);
    s.cidx[r] = ci;
    if (j >= cnt) continue;
    const int sf = vio::clampi(ci, 0, s.NP - 1);
    const float cp[3] = {__ldg(s.pos + 3 * sf), __ldg(s.pos + 3 * sf + 1),
                         __ldg(s.pos + 3 * sf + 2)};
    float cc[3];
    vio::rows_times_add(cp, rcw, pcw, cc);
    if (!(cc[2] > 0.0f)) continue;
    float pu, pv;
    vio::world2cam(cam, cc, pu, pv);
    if (!vio::in_frame(pu, pv, s.W, s.H, s.border)) continue;
    const int cell = vio::cell_of(pu, pv, s.inv_grid, s.gh, s.G);
    const float d = vio::norm3(campos[0] - cp[0], campos[1] - cp[1], campos[2] - cp[2]);
    atomicMin(s.tkey + cell, ((long long)__float_as_int(d) << 20) | (long long)r);
    const float cv = __ldg(s.value + sf);
    if (cv > 0.0f) atomicMax(reinterpret_cast<int*>(s.cell_value) + cell, __float_as_int(cv));
  }
}

// One image grid cell, by a whole warp: phases 3-5 of select_tracked and
// the cell's new point.
__device__ void cell_pass(const Sel& s, const vio::Cam& cam, const float* rcw, const float* pcw,
                          const float* campos, int c, int lane) {
  const int P = s.P, PP = P * P, half = P / 2;
  const long long km = __ldcg(s.tkey + c);
  const bool has_map = km != KEY_NONE;
  const int32_t widx = __ldcg(s.cidx + vio::clampi((int)(km & 0xFFFFF), 0, s.NC - 1));
  const int sf = vio::clampi(widx, 0, s.NP - 1);
  const float wp[3] = {__ldg(s.pos + 3 * sf), __ldg(s.pos + 3 * sf + 1),
                       __ldg(s.pos + 3 * sf + 2)};
  float wc[3];
  vio::rows_times_add(wp, rcw, pcw, wc);
  float wu, wv;
  vio::world2cam(cam, wc, wu, wv);

  // phase 3: the depth-continuity window
  const int side = 2 * half + 1;
  const int r0 = (int)wv, c0 = (int)wu;
  bool broke = false;
  for (int t = lane; t < side * side; t += 32) {
    const int a = t / side - half, b = t - (t / side) * side - half;
    const int rr = vio::clampi(vio::wrap_add(r0, a), 0, s.H - 1);
    const int cc = vio::clampi(vio::wrap_add(c0, b), 0, s.W - 1);
    const int own = __ldcg(s.owner + (size_t)rr * s.W + cc);
    const float d = own >= 0 ? __ldcg(s.zrow + own) : 0.0f;
    if (d != 0.0f && !(a == 0 && b == 0) && fabsf(wc[2] - d) > DEPTH_CONT_GATE) broke = true;
  }
  const bool depth_ok = !__any_sync(vio::FULL, broke);

  // phase 4: close_view_obs, a lane per observation
  float od[3] = {campos[0] - wp[0], campos[1] - wp[1], campos[2] - wp[2]};
  const float odn = vio::norm3(od[0], od[1], od[2]) + 1e-12f;
  for (int k = 0; k < 3; ++k) od[k] = od[k] / odn;
  float bcos = -INFINITY;
  int bo = 1 << 30;
  for (int o = lane; o < s.KO; o += 32) {
    const size_t e = (size_t)sf * s.KO + o;
    float R9[9], t3[3], cp[3];
    for (int k = 0; k < 9; ++k) R9[k] = __ldg(s.obs_rcw + 9 * e + k);
    for (int k = 0; k < 3; ++k) t3[k] = __ldg(s.obs_pcw + 3 * e + k);
    vio::campos_of(R9, t3, cp);
    float d[3] = {cp[0] - wp[0], cp[1] - wp[1], cp[2] - wp[2]};
    const float dn = vio::norm3(d[0], d[1], d[2]) + 1e-12f;
    for (int k = 0; k < 3; ++k) d[k] = d[k] / dn;
    float cs = (od[0] * d[0] + od[1] * d[1]) + od[2] * d[2];
    const int32_t f = __ldg(s.obs_fid + e);
    const int32_t sl = __ldg(s.obs_slot + e);
    if (!(f >= 0 && __ldg(s.img_fid + vio::clampi(sl, 0, s.R - 1)) == f)) cs = -2.0f;
    if (vio::beats(cs, o, bcos, bo)) {
      bcos = cs;
      bo = o;
    }
  }
  vio::warp_argmax(bcos, bo);
  const size_t eb = (size_t)sf * s.KO + bo;
  float rR[9], rt[3], rc[3];
  for (int k = 0; k < 9; ++k) rR[k] = __ldg(s.obs_rcw + 9 * eb + k);
  for (int k = 0; k < 3; ++k) rt[k] = __ldg(s.obs_pcw + 3 * eb + k);
  vio::campos_of(rR, rt, rc);
  const float rpu = __ldg(s.obs_px + 2 * eb), rpv = __ldg(s.obs_px + 2 * eb + 1);
  const int slot = vio::clampi(__ldg(s.obs_slot + eb), 0, s.R - 1);
  bool t_ok = has_map && depth_ok && bcos > 0.5f;

  // the warp: bearings on the reference image, T_cur_ref, A and its inverse
  const float depth_ref = vio::norm3(rc[0] - wp[0], rc[1] - wp[1], rc[2] - wp[2]);
  float f_ref[3], f_du[3], f_dv[3];
  vio::cam2world(cam, rpu, rpv, f_ref);
  vio::cam2world(cam, rpu + (float)half, rpv + 0.0f, f_du);
  vio::cam2world(cam, rpu + 0.0f, rpv + (float)half, f_dv);
  float x_ref[3], x_du[3], x_dv[3];
  for (int k = 0; k < 3; ++k) x_ref[k] = f_ref[k] * depth_ref;
  const float sdu = x_ref[2] / f_du[2], sdv = x_ref[2] / f_dv[2];
  for (int k = 0; k < 3; ++k) {
    x_du[k] = f_du[k] * sdu;
    x_dv[k] = f_dv[k] * sdv;
  }
  float Rcr[9], tcr[3];
  for (int i = 0; i < 3; ++i)
    for (int m = 0; m < 3; ++m)
      Rcr[3 * i + m] = (rcw[3 * i] * rR[3 * m] + rcw[3 * i + 1] * rR[3 * m + 1]) +
                       rcw[3 * i + 2] * rR[3 * m + 2];
  for (int i = 0; i < 3; ++i)
    tcr[i] = pcw[i] - ((Rcr[3 * i] * rt[0] + Rcr[3 * i + 1] * rt[1]) + Rcr[3 * i + 2] * rt[2]);
  float pxc[2], pxu[2], pxv[2];
  {
    const float* xs[3] = {x_ref, x_du, x_dv};
    float* outs[3] = {pxc, pxu, pxv};
    for (int q = 0; q < 3; ++q) {
      float y[3];
      vio::rows_times_add(xs[q], Rcr, tcr, y);
      vio::world2cam(cam, y, outs[q][0], outs[q][1]);
    }
  }
  const float A00 = (pxu[0] - pxc[0]) * s.inv_half, A10 = (pxu[1] - pxc[1]) * s.inv_half;
  const float A01 = (pxv[0] - pxc[0]) * s.inv_half, A11 = (pxv[1] - pxc[1]) * s.inv_half;
  const float detA = A00 * A11 - A01 * A10;
  const int sl = (detA > 3.0f ? 1 : 0) + (detA > 12.0f ? 1 : 0);
  const float inv_det = 1.0f / (fabsf(detA) < 1e-12f ? 1e-12f : detA);
  const float a00 = A11 * inv_det, a01 = (-A01) * inv_det;
  const float a10 = (-A10) * inv_det, a11 = A00 * inv_det;

  // the warped reference patches at pyramid levels 0-2: pixel k = lane +
  // 32 h (row x = k / P over v, column y = k % P over u)
  float ref0[2] = {0.0f, 0.0f};
  for (int lvl = 0; lvl < 3; ++lvl) {
    const float scf = (float)((1 << lvl) * (1 << sl));
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      if (k >= PP) continue;
      const int x = k / P, y = k - (k / P) * P;
      const float dx = (float)(y - half) * scf;
      const float dy = (float)(x - half) * scf;
      const float u = rpu + (a00 * dx + a01 * dy);
      const float v = rpv + (a10 * dx + a11 * dy);
      const bool inb = u >= 0.0f && v >= 0.0f && u < (float)(s.W - 1) && v < (float)(s.H - 1);
      const int32_t u0 = (int32_t)floorf(u), v0 = (int32_t)floorf(v);
      const float au = u - (float)u0, av = v - (float)v0;
      const int32_t u1 = vio::wrap_add(u0, 1), v1 = vio::wrap_add(v0, 1);
      const float val = ((((1.0f - au) * (1.0f - av)) * pool_at(s, slot, v0, u0) +
                          (au * (1.0f - av)) * pool_at(s, slot, v0, u1)) +
                         ((1.0f - au) * av) * pool_at(s, slot, v1, u0)) +
                        (au * av) * pool_at(s, slot, v1, u1);
      const float out = inb ? val : 0.0f;
      s.patch[((size_t)c * 3 + lvl) * PP + k] = out;
      if (lvl == 0) ref0[h] = out;
    }
  }

  // phase 5: the current patch at level 0 (extract_patches, scale 1), the
  // error, the outlier gate and the NCC gate
  const int32_t ui = (int32_t)floorf(wu), vi = (int32_t)floorf(wv);
  const float su = wu - (float)ui, sv = wv - (float)vi;
  const float w_tl = (1.0f - su) * (1.0f - sv), w_tr = su * (1.0f - sv);
  const float w_bl = (1.0f - su) * sv, w_br = su * sv;
  float cur[2] = {0.0f, 0.0f}, e2[2] = {0.0f, 0.0f};
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    if (k >= PP) continue;
    const int x = k / P, y = k - (k / P) * P;
    const int32_t ra = vio::wrap_add(vi, x - half), rb = vio::wrap_add(vi, x + 1 - half);
    const int32_t ca = vio::wrap_add(ui, y - half), cb = vio::wrap_add(ui, y + 1 - half);
    cur[h] = ((w_tl * img_at(s, ra, ca) + w_tr * img_at(s, ra, cb)) + w_bl * img_at(s, rb, ca)) +
             w_br * img_at(s, rb, cb);
    const float d = ref0[h] - cur[h];
    e2[h] = d * d;
  }
  const float err0 = vio::warp_tree64(e2[0], e2[1]);
  t_ok = t_ok && err0 <= (__ldg(s.out_thr) * (float)P) * (float)P;
  if (s.ncc_en) {
    const float ma = vio::warp_tree64(ref0[0], ref0[1]) * s.inv_n;
    const float mb = vio::warp_tree64(cur[0], cur[1]) * s.inv_n;
    float am[2], bm[2];
    for (int h = 0; h < 2; ++h) {
      const bool in = lane + 32 * h < PP;
      am[h] = in ? ref0[h] - ma : 0.0f;
      bm[h] = in ? cur[h] - mb : 0.0f;
    }
    const float sab = vio::warp_tree64(am[0] * bm[0], am[1] * bm[1]);
    const float saa = vio::warp_tree64(am[0] * am[0], am[1] * am[1]);
    const float sbb = vio::warp_tree64(bm[0] * bm[0], bm[1] * bm[1]);
    const float ncc = sab / sqrtf(saa * sbb + 1e-10f);
    t_ok = t_ok && ncc >= __ldg(s.ncc_thr);
  }
  if (lane != 0) return;
  s.idx[c] = widx;
  for (int k = 0; k < 3; ++k) s.wpos[3 * c + k] = wp[k];
  s.slevel[c] = sl;
  s.valid[c] = t_ok ? 1 : 0;
  s.errors[c] = err0;

  // select_new_points: the cell's winner and whether it beats the map
  const long long kn = __ldcg(s.nkey + c);
  const int row = vio::clampi((int)(kn & 0xFFFFF), 0, s.M - 1);
  const float nsc = __ldcg(s.score + row);
  for (int k = 0; k < 3; ++k) s.npos[3 * c + k] = __ldg(s.pg + 3 * row + k);
  s.npx[2 * c] = __ldcg(s.pcn + 2 * row);
  s.npx[2 * c + 1] = __ldcg(s.pcn + 2 * row + 1);
  s.nscore[c] = nsc;
  s.nadd[c] = (kn != KEY_NONE && nsc > __ldcg(s.cell_value + c)) ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS) vio_select_kernel(const Sel s) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gt = blockIdx.x * THREADS + threadIdx.x, nt = gridDim.x * THREADS;
  const int gw = gt >> 5, nw = nt >> 5;
  const vio::Cam cam = vio::load_cam(s.fx, s.fy, s.cx, s.cy, s.dist);
  float rcw[9], pcw[3], campos[3];
  for (int k = 0; k < 9; ++k) rcw[k] = __ldg(s.rcw + k);
  for (int k = 0; k < 3; ++k) pcw[k] = __ldg(s.pcw + k);
  vio::campos_of(rcw, pcw, campos);

  const size_t HW = (size_t)s.H * s.W;
  for (size_t i = gt; i < HW; i += nt) s.owner[i] = -1;
  for (int c = gt; c < s.G; c += nt) {
    s.tkey[c] = KEY_NONE;
    s.nkey[c] = KEY_NONE;
    s.cell_value[c] = 0.0f;
  }
  grid.sync();
  for (int r = gw; r < s.M; r += nw) scan_row(s, cam, rcw, pcw, r, lane);
  for (int v = gt; v < s.Nv; v += nt) voxel_rows(s, cam, rcw, pcw, campos, v);
  grid.sync();
  for (int c = gw; c < s.G; c += nw) cell_pass(s, cam, rcw, pcw, campos, c, lane);
}

}  // namespace

// The selection of one camera frame. Pointers, all contiguous on the
// device: the visual map's pos (NP, 3), value (NP,), obs_px (NP, KO, 2),
// obs_rcw (NP, KO, 3, 3), obs_pcw (NP, KO, 3), obs_slot and obs_fid (NP,
// KO) int32, vox_keys and vox_count (T,) int32, vox_idx (T, VC) int32, the
// pool imgs (R, H, W) (u8 when imgs_u8, else f32) and img_fid (R,) int32;
// the camera's fx, fy, cx, cy () and d (4,) f32; rcw (3, 3), pcw (3,) and
// the frame img (H, W) f32; the scan cloud pg (M, 3) f32 and its mask
// (M,) u8; the scan voxels vox (Nv, 3) int32 and their mask (Nv,) u8; the
// outlier and NCC thresholds () f32; scratch tkey, nkey (G,) int64,
// owner (H * W,) int32, cidx (Nv * VC,) int32, zrow (M,), pcn (M, 2) and
// score (M,) f32; outputs idx (G,) int32, wpos (G, 3), patch (G, 3, P, P),
// slevel (G,) int32, valid (G,) u8, cell_value and errors (G,) f32, npos
// (G, 3), npx (G, 2), nscore (G,) f32 and nadd (G,) u8. `grid_out`
// receives the number of blocks launched. Returns the launch's
// cudaError_t (0 = cudaSuccess).
extern "C" int vio_select_launch(
    const void* pos, const void* value, const void* obs_px, const void* obs_rcw,
    const void* obs_pcw, const void* obs_slot, const void* obs_fid, const void* vox_keys,
    const void* vox_count, const void* vox_idx, const void* imgs, const void* img_fid,
    const void* fx, const void* fy, const void* cx, const void* cy, const void* dist,
    const void* rcw, const void* pcw, const void* img, const void* pg, const void* pg_mask,
    const void* vox, const void* vox_mask, const void* out_thr, const void* ncc_thr,
    void* tkey, void* nkey, void* owner, void* cidx, void* zrow, void* pcn, void* score,
    void* idx, void* wpos, void* patch, void* slevel, void* valid, void* cell_value,
    void* errors, void* npos, void* npx, void* nscore, void* nadd, int NP, int KO, int T,
    int VC, int R, int H, int W, int M, int Nv, int grid_size, int gh, int G, int P,
    int ncc_en, int max_probe, int imgs_u8, int* grid_out, void* stream) {
  if (NP < 1 || KO < 1 || T < 1 || (T & (T - 1)) || VC < 1 || R < 1 || H < 1 || W < 1 ||
      M < 1 || Nv < 1 || (long long)Nv * VC >= (1 << 20) || M >= (1 << 20) || G < 1 ||
      gh < 1 || grid_size < 1 || P < 2 || P > MAX_P || max_probe < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Sel s;
  s.pos = static_cast<const float*>(pos);
  s.value = static_cast<const float*>(value);
  s.obs_px = static_cast<const float*>(obs_px);
  s.obs_rcw = static_cast<const float*>(obs_rcw);
  s.obs_pcw = static_cast<const float*>(obs_pcw);
  s.obs_slot = static_cast<const int32_t*>(obs_slot);
  s.obs_fid = static_cast<const int32_t*>(obs_fid);
  s.vox_keys = static_cast<const int32_t*>(vox_keys);
  s.vox_count = static_cast<const int32_t*>(vox_count);
  s.vox_idx = static_cast<const int32_t*>(vox_idx);
  s.imgs = imgs;
  s.img_fid = static_cast<const int32_t*>(img_fid);
  s.fx = static_cast<const float*>(fx);
  s.fy = static_cast<const float*>(fy);
  s.cx = static_cast<const float*>(cx);
  s.cy = static_cast<const float*>(cy);
  s.dist = static_cast<const float*>(dist);
  s.rcw = static_cast<const float*>(rcw);
  s.pcw = static_cast<const float*>(pcw);
  s.img = static_cast<const float*>(img);
  s.pg = static_cast<const float*>(pg);
  s.pg_mask = static_cast<const uint8_t*>(pg_mask);
  s.vox = static_cast<const int32_t*>(vox);
  s.vox_mask = static_cast<const uint8_t*>(vox_mask);
  s.out_thr = static_cast<const float*>(out_thr);
  s.ncc_thr = static_cast<const float*>(ncc_thr);
  s.tkey = static_cast<long long*>(tkey);
  s.nkey = static_cast<long long*>(nkey);
  s.owner = static_cast<int32_t*>(owner);
  s.cidx = static_cast<int32_t*>(cidx);
  s.zrow = static_cast<float*>(zrow);
  s.pcn = static_cast<float*>(pcn);
  s.score = static_cast<float*>(score);
  s.idx = static_cast<int32_t*>(idx);
  s.wpos = static_cast<float*>(wpos);
  s.patch = static_cast<float*>(patch);
  s.slevel = static_cast<int32_t*>(slevel);
  s.valid = static_cast<uint8_t*>(valid);
  s.cell_value = static_cast<float*>(cell_value);
  s.errors = static_cast<float*>(errors);
  s.npos = static_cast<float*>(npos);
  s.npx = static_cast<float*>(npx);
  s.nscore = static_cast<float*>(nscore);
  s.nadd = static_cast<uint8_t*>(nadd);
  s.NP = NP;
  s.KO = KO;
  s.T = T;
  s.VC = VC;
  s.R = R;
  s.H = H;
  s.W = W;
  s.M = M;
  s.Nv = Nv;
  s.NC = Nv * VC;
  s.G = G;
  s.gh = gh;
  s.P = P;
  s.border = (P / 2 + 1) * 8;
  s.ncc_en = ncc_en;
  s.max_probe = max_probe;
  s.imgs_u8 = imgs_u8;
  // the f32 reciprocals the plain version multiplies by (vio._recip32)
  s.inv_grid = 1.0f / (float)grid_size;
  s.inv_half = 1.0f / (float)(P / 2);
  s.inv_n = 1.0f / (float)(P * P);

  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vio_select_kernel, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // enough warps for every scan row, or as many blocks as are co-resident
  const long long want = ((long long)M * 32 + THREADS - 1) / THREADS;
  const int grid = (int)(want < (long long)per_sm * sms ? want : (long long)per_sm * sms);
  *grid_out = grid;
  void* args[] = {&s};
  e = cudaLaunchCooperativeKernel((const void*)vio_select_kernel, dim3(grid), dim3(THREADS),
                                  args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
