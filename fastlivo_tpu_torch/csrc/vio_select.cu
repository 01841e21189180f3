// The camera frame's selection in one launch, for Hopper: the tracked
// map points with their warped reference patches, and the new points.
//
// vio_select replaces the jitted XLA code of the JAX package's
// fastlivo_tpu/vio.py::select_tracked (:130-401, jitted at :125-129) and
// select_new_points (:408-484, jitted at :404-407); no Pallas kernel. Its
// plain version is the port's vio._cam_pose of the prior state,
// vio.select_tracked and vio.select_new_points, every expression of which
// this kernel evaluates in the same order (built with -fmad=false). Over
// one cooperative launch:
//   every block: the camera pose rcw, pcw from the state's rot and pos
//   (f64, rounded to f32) and Rci, Pci in vio._cam_pose's order (an
//   output); reset: the depth image's owner per pixel to -1, the per-cell
//   keys to INT64_MAX and cell_value to 0; grid barrier;
//   a half-warp per scan voxel (Nv): the feat_map probe
//   (visual_map.gather_voxel_points: a lane per probed slot, the first hit
//   by ballot) and a lane per point slot (VC): the candidate (its index and
//   position, kept for the cells), the projection, the gates, the per-cell
//   minimum of (distance bits, row) and the per-cell maximum of the map
//   value as an int32 atomicMax on the f32 bits from 0 (so a value not
//   above 0 leaves the 0);
//   a half-warp per row of the scan cloud pg (M): the camera-frame point, the
//   depth image's pinhole pixel, whose owner is the highest row there (an
//   int atomicMax; ops/voxel_map._last_wins' "the last row wins"), the
//   distorted pixel, the in-frame gate, the Shi-Tomasi score
//   (vio_common.cuh, the half-warp's fixed-order box sums) and the per-cell
//   minimum of (inverted score bits, row) (an int64 atomicMin); grid
//   barrier;
//   four warps per image grid cell (G), the cells spread over the blocks:
//   every warp derives the winner's geometry; then at once the
//   depth-continuity window (the depth of a pixel is its owner row's z,
//   else 0), the best view (visual_map.close_view_obs, a lane per
//   observation, first maximum; the pool's image ids in shared memory)
//   with the affine warp and its search level, the current patch
//   (extract_patches at level 0) and the cell's new point (its winner row
//   and whether it beats cell_value); then the warped patches at pyramid
//   levels 0-2 (ops/image.affine_warp_patches), a warp each, from the u8
//   or f32 pool; then the error, the outlier gate and, with ncc_en, the
//   NCC gate (every sum over a patch in image.halving_sum's order at
//   vio._patch_sum's width).
// A patch of P x P pixels is held NW / 32 a lane of the cell's warps (k =
// lane + 32 h), NW the tree's width, a template parameter the launch picks
// from P: 64 for P <= 8, 128 for P 9-11, 256 for P 12-16 (vio_common.cuh's
// warp_tree). Past P = 16 (NW = 0, the wide instance) the tree's width is
// the next power of two of P * P, and the cell's current and reference
// patches and the tree's scratch live in memory, not in a lane's
// registers: in the block's shared memory up to WIDE_SMEM bytes for its
// cells, else in the launch's device scratch, a slice a cell
// (vio_common.cuh's warp_tree_wide). The pool's first STAGE_R image ids
// are staged in shared memory, the rest read from global memory in the
// same launch.
// Only integer atomics (a min or max is order-free), no float atomics:
// the same bits on every launch and any grid.
//
// Bound (chip_smoke.py's vio_select_bound_ms): the bytes of the scan
// cloud, the voxel set, the map rows the probes and candidates touch, the
// KO-observation rings of the G winners, the taps of the image windows
// and of the patches, the pose and the outputs, once each, over HBM
// bandwidth; the operations are far below the f32 rate. The owner image's
// reset is scratch and not counted. What holds the launch above that: two
// grid barriers, the reset of the 1.3 MB owner image, and a cell's chain
// of dependent loads (its key, candidate, ring, reference
// observation, pool taps) around the eight-step undistortions. Design: one
// cooperative, persistent launch of as many 512-thread blocks as are
// co-resident and the work needs; the depth image is never written (a
// pixel's depth is read through its owner row), and nothing is read back
// to the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "vio_common.cuh"
#include "phase_stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WIDE_SMEM = 128 * 1024;  // the wide instance's cells in shared memory
constexpr long long KEY_NONE = 0x7FFFFFFFFFFFFFFFLL;
constexpr float DEPTH_CONT_GATE = 1.5f;  // vio.DEPTH_CONT_GATE
constexpr int WARPS = THREADS / 32;
constexpr int CELLS = WARPS / 4;  // cells a block, four warps each
constexpr int STAGE_R = 12288;  // the pool's image ids staged in shared memory (48 KB)
constexpr int MAX_DEV = 64;

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
  const double* rot;        // (3, 3) the prior state
  const double* spos;       // (3,)
  const float* Rci;         // (3, 3)
  const float* Pci;         // (3,)
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
  float4* cand;      // (NC,) the candidates' point index (w, its int32 bits) and,
                     // where the row holds a point, its position (xyz)
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
  float* rcw_out;     // (3, 3) the camera pose
  float* pcw_out;     // (3,)
  // the wide instance: its cells' patches and tree scratch, wstride floats
  // a cell (current, reference, tree), in shared memory or in `wide` (G,
  // wstride)
  float* wide;
  int wstride, wide_smem, width;
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

// One row of the scan cloud, by a half-warp (hl its lane, hmask its lanes;
// the Shi-Tomasi sums).
__device__ void scan_row(const Sel& s, const vio::Cam& cam, const float* rcw, const float* pcw,
                         int r, int hl, unsigned hmask) {
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
  const float sc = vio::shi_tomasi_half(s.img, s.H, s.W, pu, pv, hl, hmask);
  if (hl != 0) return;
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

// One scan voxel's feat_map lookup and its VC candidate rows, by a
// half-warp (hl its lane, hmask its lanes): a lane per probed slot, then a
// lane per point slot.
__device__ void voxel_rows(const Sel& s, const vio::Cam& cam, const float* rcw, const float* pcw,
                           const float* campos, int v, int hl, unsigned hmask) {
  const int tmask = s.T - 1;
  int slot;
  int32_t check;
  vio::slot_check(__ldg(s.vox + 3 * v), __ldg(s.vox + 3 * v + 1), __ldg(s.vox + 3 * v + 2),
                  tmask, slot, check);
  const int32_t q = __ldg(s.vox_mask + v) ? check : vio::EMPTY + 1;
  int safe = 0;
  bool found = false;
  for (int base = 0; base < s.max_probe; base += 16) {  // the first hit
    const int p = base + hl;
    const bool hit = p < s.max_probe && __ldg(s.vox_keys + ((slot + p) & tmask)) == q;
    const unsigned b = __ballot_sync(hmask, hit) & hmask;
    if (b) {
      safe = (slot + base + (__ffs(b) - 1) % 16) & tmask;
      found = true;
      break;
    }
  }
  const int cnt = found ? __ldg(s.vox_count + safe) : 0;
  for (int j = hl; j < s.VC; j += 16) {
    const int r = v * s.VC + j;
    const int32_t ci = __ldg(s.vox_idx + (size_t)safe * s.VC + j);
    if (j >= cnt) {
      s.cand[r] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(ci));
      continue;
    }
    const int sf = vio::clampi(ci, 0, s.NP - 1);
    const float cp[3] = {__ldg(s.pos + 3 * sf), __ldg(s.pos + 3 * sf + 1),
                         __ldg(s.pos + 3 * sf + 2)};
    s.cand[r] = make_float4(cp[0], cp[1], cp[2], __int_as_float(ci));
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

// What a cell's warps share (CELLS cells a block); the patches at the
// tree's width NW (the wide instance's in memory, CellBuf).
template <int NW>
struct CellSh {
  float a00, a01, a10, a11, rpu, rpv;
  int sl, slot, depth_ok, view_ok;
  float cur[NW > 0 ? NW : 1], ref0[NW > 0 ? NW : 1];
};

// A cell's current and level-0 reference patches and the wide tree's
// scratch.
struct CellBuf {
  float *cur, *ref0, *tmp;
};

// A cell's tracked winner, as every warp of the cell derives it.
struct Winner {
  bool has_map;
  int32_t widx;
  int sf;
  float wp[3], wc[3], wu, wv;
};

__device__ __forceinline__ Winner winner_of(const Sel& s, const vio::Cam& cam, const float* rcw,
                                            const float* pcw, int c) {
  Winner w;
  const long long km = __ldcg(s.tkey + c);
  w.has_map = km != KEY_NONE;
  const float4 cv = __ldcg(s.cand + vio::clampi((int)(km & 0xFFFFF), 0, s.NC - 1));
  w.widx = __float_as_int(cv.w);
  w.sf = vio::clampi(w.widx, 0, s.NP - 1);
  if (w.has_map) {  // a candidate's row holds its point's position
    w.wp[0] = cv.x;
    w.wp[1] = cv.y;
    w.wp[2] = cv.z;
  } else {
    for (int k = 0; k < 3; ++k) w.wp[k] = __ldg(s.pos + 3 * w.sf + k);
  }
  vio::rows_times_add(w.wp, rcw, pcw, w.wc);
  vio::world2cam(cam, w.wc, w.wu, w.wv);
  return w;
}

// phase 3 of select_tracked: the depth-continuity window, by a warp
template <int NW>
__device__ void depth_window(const Sel& s, const Winner& w, int lane, CellSh<NW>& sh) {
  const int half = s.P / 2, side = 2 * half + 1;
  const int r0 = (int)w.wv, c0 = (int)w.wu;
  bool broke = false;
  for (int t = lane; t < side * side; t += 32) {
    const int a = t / side - half, b = t - (t / side) * side - half;
    const int rr = vio::clampi(vio::wrap_add(r0, a), 0, s.H - 1);
    const int cc = vio::clampi(vio::wrap_add(c0, b), 0, s.W - 1);
    const int own = __ldcg(s.owner + (size_t)rr * s.W + cc);
    const float d = own >= 0 ? __ldcg(s.zrow + own) : 0.0f;
    if (d != 0.0f && !(a == 0 && b == 0) && fabsf(w.wc[2] - d) > DEPTH_CONT_GATE) broke = true;
  }
  const bool ok = !__any_sync(vio::FULL, broke);
  if (lane == 0) sh.depth_ok = ok;
}

// phase 4: close_view_obs (a lane per observation), then the affine warp
// of the best view and its search level, by a warp
template <int NW>
__device__ void best_view(const Sel& s, const vio::Cam& cam, const float* rcw, const float* pcw,
                          const float* campos, const int* img_fid, const Winner& w, int lane,
                          CellSh<NW>& sh) {
  const int half = s.P / 2;
  const float* wp = w.wp;
  float od[3] = {campos[0] - wp[0], campos[1] - wp[1], campos[2] - wp[2]};
  const float odn = vio::norm3(od[0], od[1], od[2]) + 1e-12f;
  for (int k = 0; k < 3; ++k) od[k] = od[k] / odn;
  float bcos = -INFINITY;
  int bo = 1 << 30;
  for (int o = lane; o < s.KO; o += 32) {
    const size_t e = (size_t)w.sf * s.KO + o;
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
    const int r = vio::clampi(sl, 0, s.R - 1);  // staged, else in place
    if (!(f >= 0 && (r < STAGE_R ? img_fid[r] : __ldg(s.img_fid + r)) == f)) cs = -2.0f;
    if (vio::beats(cs, o, bcos, bo)) {
      bcos = cs;
      bo = o;
    }
  }
  vio::warp_argmax(bcos, bo);
  const size_t eb = (size_t)w.sf * s.KO + bo;
  float rR[9], rt[3], rc[3];
  for (int k = 0; k < 9; ++k) rR[k] = __ldg(s.obs_rcw + 9 * eb + k);
  for (int k = 0; k < 3; ++k) rt[k] = __ldg(s.obs_pcw + 3 * eb + k);
  vio::campos_of(rR, rt, rc);
  const float rpu = __ldg(s.obs_px + 2 * eb), rpv = __ldg(s.obs_px + 2 * eb + 1);
  const int slot = vio::clampi(__ldg(s.obs_slot + eb), 0, s.R - 1);

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
  if (lane == 0) {
    sh.a00 = A11 * inv_det;
    sh.a01 = (-A01) * inv_det;
    sh.a10 = (-A10) * inv_det;
    sh.a11 = A00 * inv_det;
    sh.rpu = rpu;
    sh.rpv = rpv;
    sh.sl = sl;
    sh.slot = slot;
    sh.view_ok = bcos > 0.5f;
  }
}

// The lane's share of a patch: pixels lane + 32 h for h < lane_pixels.
template <int NW>
__device__ __forceinline__ int lane_pixels(int PP) {
  return NW > 0 ? NW / 32 : (PP + 31) / 32;
}

// phase 5's current patch at level 0 (extract_patches, scale 1), by a
// warp: pixel k = lane + 32 h (row x = k / P over v, column y = k % P)
template <int NW>
__device__ void current_patch(const Sel& s, const Winner& w, int lane, float* cur) {
  const int P = s.P, PP = P * P, half = P / 2;
  const int32_t ui = (int32_t)floorf(w.wu), vi = (int32_t)floorf(w.wv);
  const float su = w.wu - (float)ui, sv = w.wv - (float)vi;
  const float w_tl = (1.0f - su) * (1.0f - sv), w_tr = su * (1.0f - sv);
  const float w_bl = (1.0f - su) * sv, w_br = su * sv;
  for (int h = 0; h < lane_pixels<NW>(PP); ++h) {
    const int k = lane + 32 * h;
    if (k >= PP) continue;
    const int x = k / P, y = k - (k / P) * P;
    const int32_t ra = vio::wrap_add(vi, x - half), rb = vio::wrap_add(vi, x + 1 - half);
    const int32_t ca = vio::wrap_add(ui, y - half), cb = vio::wrap_add(ui, y + 1 - half);
    cur[k] = ((w_tl * img_at(s, ra, ca) + w_tr * img_at(s, ra, cb)) +
                 w_bl * img_at(s, rb, ca)) +
                w_br * img_at(s, rb, cb);
  }
}

// select_new_points: the cell's winner and whether it beats the map, by
// one thread
__device__ void new_point(const Sel& s, int c) {
  const long long kn = __ldcg(s.nkey + c);
  const int row = vio::clampi((int)(kn & 0xFFFFF), 0, s.M - 1);
  const float nsc = __ldcg(s.score + row);
  for (int k = 0; k < 3; ++k) s.npos[3 * c + k] = __ldg(s.pg + 3 * row + k);
  s.npx[2 * c] = __ldcg(s.pcn + 2 * row);
  s.npx[2 * c + 1] = __ldcg(s.pcn + 2 * row + 1);
  s.nscore[c] = nsc;
  s.nadd[c] = (kn != KEY_NONE && nsc > __ldcg(s.cell_value + c)) ? 1 : 0;
}

// the warped reference patch at pyramid level lvl, by a warp (level 0
// also into ref0)
template <int NW>
__device__ void warped_patch(const Sel& s, int c, int lvl, int lane, const CellSh<NW>& sh,
                             float* ref0) {
  const int P = s.P, PP = P * P, half = P / 2;
  const float scf = (float)((1 << lvl) * (1 << sh.sl));
  const float a00 = sh.a00, a01 = sh.a01, a10 = sh.a10, a11 = sh.a11;
  const float rpu = sh.rpu, rpv = sh.rpv;
  const int slot = sh.slot;
  for (int h = 0; h < lane_pixels<NW>(PP); ++h) {
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
    if (lvl == 0) ref0[k] = out;
  }
}

// The gates' patch sums in the wide instance: every sum a warp_tree_wide
// at the launch's width over the cell's patches in memory.
__device__ __forceinline__ void wide_sums(const Sel& s, const CellBuf& b, int lane,
                                          float& err0, float& ncc) {
  const int PP = s.P * s.P;
  const float* ref0 = b.ref0;
  const float* cur = b.cur;
  err0 = vio::warp_tree_wide(b.tmp, PP, s.width, lane, [&](int k) {
    const float d = ref0[k] - cur[k];
    return d * d;
  });
  ncc = 0.0f;
  if (!s.ncc_en) return;
  const float ma = vio::warp_tree_wide(b.tmp, PP, s.width, lane, [&](int k) { return ref0[k]; })
                   * s.inv_n;
  const float mb = vio::warp_tree_wide(b.tmp, PP, s.width, lane, [&](int k) { return cur[k]; })
                   * s.inv_n;
  const float sab = vio::warp_tree_wide(b.tmp, PP, s.width, lane, [&](int k) {
    return (ref0[k] - ma) * (cur[k] - mb);
  });
  const float saa = vio::warp_tree_wide(b.tmp, PP, s.width, lane, [&](int k) {
    const float a = ref0[k] - ma;
    return a * a;
  });
  const float sbb = vio::warp_tree_wide(b.tmp, PP, s.width, lane, [&](int k) {
    const float d = cur[k] - mb;
    return d * d;
  });
  ncc = sab / sqrtf(saa * sbb + 1e-10f);
}

// The gates' patch sums at the tree's width NW <= 256, the patches in the
// lanes' registers.
template <int NW>
__device__ __forceinline__ void narrow_sums(const Sel& s, int lane, const CellSh<NW>& sh,
                                            float& err0, float& ncc) {
  constexpr int H = NW / 32;
  const int P = s.P, PP = P * P;
  float ref0[H] = {}, cur[H] = {}, e2[H] = {};
  for (int h = 0; h < H; ++h) {
    const int k = lane + 32 * h;
    if (k >= PP) continue;
    ref0[h] = sh.ref0[k];
    cur[h] = sh.cur[k];
    const float d = ref0[h] - cur[h];
    e2[h] = d * d;
  }
  err0 = vio::warp_tree<NW>(e2);
  if (s.ncc_en) {
    const float ma = vio::warp_tree<NW>(ref0) * s.inv_n;
    const float mb = vio::warp_tree<NW>(cur) * s.inv_n;
    float am[H], bm[H], t[H];
    for (int h = 0; h < H; ++h) {
      const bool in = lane + 32 * h < PP;
      am[h] = in ? ref0[h] - ma : 0.0f;
      bm[h] = in ? cur[h] - mb : 0.0f;
    }
    for (int h = 0; h < H; ++h) t[h] = am[h] * bm[h];
    const float sab = vio::warp_tree<NW>(t);
    for (int h = 0; h < H; ++h) t[h] = am[h] * am[h];
    const float saa = vio::warp_tree<NW>(t);
    for (int h = 0; h < H; ++h) t[h] = bm[h] * bm[h];
    const float sbb = vio::warp_tree<NW>(t);
    ncc = sab / sqrtf(saa * sbb + 1e-10f);
  }
}

// phase 5's error, outlier and NCC gates and the cell's outputs, by a warp
// (every patch sum a warp_tree<NW>, zeros past the patch; the wide
// instance's wide_sums)
template <int NW>
__device__ void cell_gates(const Sel& s, const Winner& w, int c, int lane, const CellSh<NW>& sh,
                           const CellBuf& b) {
  const int P = s.P;
  float err0, ncc = 0.0f;
  if constexpr (NW == 0) {
    wide_sums(s, b, lane, err0, ncc);
  } else {
    narrow_sums<NW>(s, lane, sh, err0, ncc);
  }
  bool t_ok = w.has_map && sh.depth_ok && sh.view_ok;
  t_ok = t_ok && err0 <= (__ldg(s.out_thr) * (float)P) * (float)P;
  if (s.ncc_en) t_ok = t_ok && ncc >= __ldg(s.ncc_thr);
  if (lane != 0) return;
  s.idx[c] = w.widx;
  for (int k = 0; k < 3; ++k) s.wpos[3 * c + k] = w.wp[k];
  s.slevel[c] = sh.sl;
  s.valid[c] = t_ok ? 1 : 0;
  s.errors[c] = err0;
}

template <int NW>
__global__ void __launch_bounds__(THREADS) vio_select_kernel(const Sel s) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh_rcw[9], sh_pcw[3];
  __shared__ CellSh<NW> csh[CELLS];
  // (min(R, STAGE_R),) staged ids; the wide instance's cells after them
  extern __shared__ int sh_img_fid[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gt = blockIdx.x * THREADS + threadIdx.x, nt = gridDim.x * THREADS;
  const int gw = gt >> 5, nw = nt >> 5;
  PHASE_STAMP_START();
  if (threadIdx.x == 0) vio::cam_pose(s.rot, s.spos, s.Rci, s.Pci, sh_rcw, sh_pcw);

  const size_t HW = (size_t)s.H * s.W;
  if ((reinterpret_cast<uintptr_t>(s.owner) & 15) == 0) {
    int4* o4 = reinterpret_cast<int4*>(s.owner);
    for (size_t i = gt; i < HW / 4; i += nt) o4[i] = make_int4(-1, -1, -1, -1);
    for (size_t i = HW / 4 * 4 + gt; i < HW; i += nt) s.owner[i] = -1;
  } else {
    for (size_t i = gt; i < HW; i += nt) s.owner[i] = -1;
  }
  for (int c = gt; c < s.G; c += nt) {
    s.tkey[c] = KEY_NONE;
    s.nkey[c] = KEY_NONE;
    s.cell_value[c] = 0.0f;
  }
  for (int r = threadIdx.x; r < min(s.R, STAGE_R); r += THREADS)
    sh_img_fid[r] = __ldg(s.img_fid + r);
  __syncthreads();
  PHASE_STAMP(5);
  const vio::Cam cam = vio::load_cam(s.fx, s.fy, s.cx, s.cy, s.dist);
  float rcw[9], pcw[3], campos[3];
  for (int k = 0; k < 9; ++k) rcw[k] = sh_rcw[k];
  for (int k = 0; k < 3; ++k) pcw[k] = sh_pcw[k];
  vio::campos_of(rcw, pcw, campos);
  if (blockIdx.x == 0 && threadIdx.x < 9) s.rcw_out[threadIdx.x] = rcw[threadIdx.x];
  if (blockIdx.x == 0 && threadIdx.x < 3) s.pcw_out[threadIdx.x] = pcw[threadIdx.x];
  grid.sync();
  PHASE_STAMP(1);
  // a half-warp a voxel, then a half-warp a scan row: the voxels first
  // (their chain is the longer)
  const int nvp = (s.Nv + 1) / 2, nrp = (s.M + 1) / 2;
  const int hl = lane & 15;
  const unsigned hmask = 0xFFFFu << (lane & 16);
  for (int it = gw; it < nvp + nrp; it += nw) {
    if (it < nvp) {
      const int v = 2 * it + (lane >> 4);
      if (v < s.Nv) voxel_rows(s, cam, rcw, pcw, campos, v, hl, hmask);
    } else {
      const int r = 2 * (it - nvp) + (lane >> 4);
      if (r < s.M) scan_row(s, cam, rcw, pcw, r, hl, hmask);
    }
  }
  PHASE_STAMP(2);
  grid.sync();
  PHASE_STAMP(3);
  // four warps a cell, the cells spread over the blocks
  const int role = warp & 3;
  CellSh<NW>& sh = csh[warp >> 2];
  float* wide_sh = reinterpret_cast<float*>(sh_img_fid + ((min(s.R, STAGE_R) + 3) & ~3));
  const int ppr = (s.P * s.P + 3) & ~3;
  for (int c0 = blockIdx.x; c0 < s.G; c0 += CELLS * gridDim.x) {
    const int c = c0 + (warp >> 2) * gridDim.x;
    const bool live = c < s.G;
    CellBuf b{sh.cur, sh.ref0, nullptr};
    if (NW == 0 && live) {
      float* base = s.wide_smem ? wide_sh + (warp >> 2) * s.wstride
                                : s.wide + (size_t)c * s.wstride;
      b = CellBuf{base, base + ppr, base + 2 * ppr};
    }
    Winner w;
    if (live) {
      w = winner_of(s, cam, rcw, pcw, c);
      if (role == 0) depth_window(s, w, lane, sh);
      else if (role == 1) best_view(s, cam, rcw, pcw, campos, sh_img_fid, w, lane, sh);
      else if (role == 2) current_patch<NW>(s, w, lane, b.cur);
      else if (lane == 0) new_point(s, c);
    }
    __syncthreads();
    if (live && role < 3) warped_patch(s, c, role, lane, sh, b.ref0);
    __syncthreads();
    if (live && role == 0) cell_gates(s, w, c, lane, sh, b);
    __syncthreads();
  }
  PHASE_STAMP(4);
}

struct DevInfo {
  int coop = -1, sms = 0;
  // per instance (the tree widths 64, 128, 256 and the wide one): the
  // dynamic shared memory the kernel may take, and the occupancy at the
  // last launch's
  int smem_set[4] = {0, 0, 0, 0}, occ_smem[4] = {-1, -1, -1, -1}, per_sm[4] = {0, 0, 0, 0};
};

// The wide instance's tree width (the next power of two of P * P) and
// floats a cell (current and reference patches, each rounded up to 4, and
// the tree's NW / 2), and whether its cells fit in shared memory.
struct Wide {
  int width, stride;
  bool smem;
};
Wide wide_layout(int P) {
  int width = 512;
  while (width < P * P) width *= 2;
  const int stride = 2 * ((P * P + 3) & ~3) + width / 2;
  return Wide{width, stride, (long long)CELLS * stride * 4 <= WIDE_SMEM};
}
DevInfo g_dev[MAX_DEV];

// Raise the instance's dynamic shared-memory limit when smem needs more
// than it was set to (past 48 KB with the static CellSh), and query its
// co-resident blocks per SM at smem when that changed; the grid follows.
cudaError_t prepare(const void* fn, int t, size_t smem, DevInfo& d) {
  cudaError_t e = cudaSuccess;
  if ((int)smem > d.smem_set[t]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    d.smem_set[t] = (int)smem;
  }
  if (d.occ_smem[t] != (int)smem) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
    if (e != cudaSuccess) return e;
    d.per_sm[t] = per_sm;
    d.occ_smem[t] = (int)smem;
  }
  return e;
}

}  // namespace

PHASE_STAMPS_EXPORT(vio_select)

// The device scratch (floats) vio_select_launch needs in `wide` for G
// cells at patch size P: 0 unless P * P > 256 and the cells of a block do
// not fit in shared memory.
extern "C" long long vio_select_wide_floats(int P, int G) {
  if (P * P <= 256) return 0;
  const Wide w = wide_layout(P);
  return w.smem ? 0 : (long long)G * w.stride;
}

// The selection of one camera frame. Pointers, all contiguous on the
// device: the visual map's pos (NP, 3), value (NP,), obs_px (NP, KO, 2),
// obs_rcw (NP, KO, 3, 3), obs_pcw (NP, KO, 3), obs_slot and obs_fid (NP,
// KO) int32, vox_keys and vox_count (T,) int32, vox_idx (T, VC) int32, the
// pool imgs (R, H, W) (u8 when imgs_u8, else f32) and img_fid (R,) int32;
// the camera's fx, fy, cx, cy () and d (4,) f32; the prior state's rot
// (3, 3) and pos (3,) f64, the extrinsics Rci (3, 3) and Pci (3,) f32 and
// the frame img (H, W) f32; the scan cloud pg (M, 3) f32 and its mask
// (M,) u8; the scan voxels vox (Nv, 3) int32 and their mask (Nv,) u8; the
// outlier and NCC thresholds () f32; scratch tkey, nkey (G,) int64,
// owner (H * W,) int32, cand (Nv * VC, 4) f32 (16-byte aligned), zrow
// (M,), pcn (M, 2) and score (M,) f32; outputs idx (G,) int32, wpos (G, 3), patch (G, 3, P, P),
// slevel (G,) int32, valid (G,) u8, cell_value and errors (G,) f32, npos
// (G, 3), npx (G, 2), nscore (G,) f32, nadd (G,) u8 and the camera pose
// rcw (3, 3), pcw (3,) f32; scratch wide (vio_select_wide_floats(P, G)
// floats, or null where that is 0). P is 2 or more, R any size (the first
// STAGE_R image ids staged in shared memory). `grid_out` receives the
// number of blocks launched. Returns the launch's cudaError_t (0 =
// cudaSuccess).
extern "C" int vio_select_launch(
    const void* pos, const void* value, const void* obs_px, const void* obs_rcw,
    const void* obs_pcw, const void* obs_slot, const void* obs_fid, const void* vox_keys,
    const void* vox_count, const void* vox_idx, const void* imgs, const void* img_fid,
    const void* fx, const void* fy, const void* cx, const void* cy, const void* dist,
    const void* rot, const void* spos, const void* Rci, const void* Pci, const void* img,
    const void* pg, const void* pg_mask, const void* vox, const void* vox_mask,
    const void* out_thr, const void* ncc_thr, void* tkey, void* nkey, void* owner, void* cand,
    void* zrow, void* pcn, void* score, void* idx, void* wpos, void* patch, void* slevel,
    void* valid, void* cell_value, void* errors, void* npos, void* npx, void* nscore,
    void* nadd, void* rcw_out, void* pcw_out, void* wide, int NP, int KO, int T, int VC,
    int R, int H,
    int W, int M, int Nv, int grid_size, int gh, int G, int P, int ncc_en, int max_probe,
    int imgs_u8, int* grid_out, void* stream) {
  if (NP < 1 || KO < 1 || T < 1 || (T & (T - 1)) || VC < 1 || R < 1 || H < 1 || W < 1 ||
      M < 1 || Nv < 1 || (long long)Nv * VC >= (1 << 20) || M >= (1 << 20) || G < 1 ||
      (reinterpret_cast<uintptr_t>(cand) & 15) || gh < 1 || grid_size < 1 ||
      P < 2 || max_probe < 1 || (vio_select_wide_floats(P, G) > 0 && wide == nullptr))
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
  s.rot = static_cast<const double*>(rot);
  s.spos = static_cast<const double*>(spos);
  s.Rci = static_cast<const float*>(Rci);
  s.Pci = static_cast<const float*>(Pci);
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
  s.cand = static_cast<float4*>(cand);
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
  s.rcw_out = static_cast<float*>(rcw_out);
  s.pcw_out = static_cast<float*>(pcw_out);
  const Wide wl = wide_layout(P);
  s.wide = static_cast<float*>(wide);
  s.wstride = wl.stride;
  s.wide_smem = wl.smem;
  s.width = wl.width;
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

  // the device's properties and the kernel's occupancy, queried once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
  DevInfo& d = g_dev[dev];
  if (d.coop < 0) {
    int coop = 0, sms = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    d.sms = sms;
    d.coop = coop;
  }
  if (!d.coop) return static_cast<int>(cudaErrorNotSupported);
  // the tree's width: vio._patch_sum's, the next power of two of P * P, at
  // least 64; past 256 the wide instance
  const int t = P * P <= 64 ? 0 : (P * P <= 128 ? 1 : (P * P <= 256 ? 2 : 3));
  const void* fn = t == 0   ? (const void*)vio_select_kernel<64>
                   : t == 1 ? (const void*)vio_select_kernel<128>
                   : t == 2 ? (const void*)vio_select_kernel<256>
                            : (const void*)vio_select_kernel<0>;
  // the staged ids, then the wide instance's cells where they fit
  const int staged = R < STAGE_R ? R : STAGE_R;
  size_t smem = (size_t)staged * sizeof(int);
  if (t == 3 && wl.smem) smem = (size_t)((staged + 3) & ~3) * 4 + (size_t)CELLS * wl.stride * 4;
  e = prepare(fn, t, smem, d);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (d.per_sm[t] < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // a warp for every two voxels and every two scan rows, and four for
  // every cell, or as many blocks as are co-resident
  const long long items = (long long)(Nv + 1) / 2 + (M + 1) / 2;
  long long want = (items + WARPS - 1) / WARPS;
  if (want < (G + CELLS - 1) / CELLS) want = (G + CELLS - 1) / CELLS;
  const long long cap = (long long)d.per_sm[t] * d.sms;
  const int grid = (int)(want < cap ? want : cap);
  *grid_out = grid;
  void* args[] = {&s};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
