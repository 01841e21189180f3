// The camera frame's visual-map upkeep in one launch, for Hopper: the
// observations of the tracked points and the new points, written into the
// map in place.
//
// vio_observations replaces the jitted XLA code of the JAX package's
// fastlivo_tpu/vio.py::prep_observations (jitted at :971) and
// fastlivo_tpu/visual_map.py::add_observations (jitted at :493) and
// add_points (jitted at :243) with its voxel-index insert; no Pallas
// kernel. Its plain version is the port's vio.prep_observations followed by
// visual_map.add_observations and visual_map.add_points, which read the
// count of kept rows back to the host (`_kept`); this kernel reads nothing
// back and keeps n_pts on the device. One block, in the plain version's
// order, a __syncthreads between the stages:
//   prep_observations, one warp per row: the pixel at the posterior pose,
//   the most recent observation (the first maximum of the ring's fids),
//   the Δp, Δθ and pixel-distance gates, the Shi-Tomasi score
//   (vio_common.cuh);
//   add_observations: per row the ring entry to write (the next free one,
//   or the furthest view when the ring is full, the first maximum), then
//   the writes of the rows the gates kept;
//   add_points: the rows the mask keeps within the point capacity, in
//   mask order (a serial count in one thread), their point fields and
//   creation observation;
//   _voxel_index_insert: the rows ranked by (z, y, x voxel key, row) by
//   counting (each row against every other, in shared memory: no sort),
//   the voxel groups and ranks, max_probe claim rounds (two barriers a
//   round: all reads, then the claims, where the later row in key order
//   wins a contested slot, then the read-back), the followers' slot from
//   their group, the appends up to the voxel capacity (the later row wins
//   a contested entry) and one count increment per group (an integer
//   atomicAdd: order-free).
// Integer arithmetic apart from the prep stage, whose float expressions
// follow the plain version's order (built with -fmad=false).
//
// Bound (chip_smoke.py's vio_observations_bound_ms): the bytes of the
// rows' inputs, the map rows and rings they read and write, and the probed
// voxel slots, once each, over HBM bandwidth. What holds it above: one
// block on one SM, the barriers of the claim rounds and the serial mask
// count. B is the image grid's cell count (192 at 640x512 with 40-pixel
// cells): one block does it in row order, which is what makes the claims'
// and appends' winners the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "vio_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_B = 2048;
constexpr int NARR = 25;  // int arrays of B entries in shared memory

struct Obs {
  // the visual map, written in place
  float* pos;           // (NP, 3)
  float* value;         // (NP,)
  int32_t* n_obs;       // (NP,)
  const int32_t* n_pts; // ()
  float* obs_px;        // (NP, KO, 2)
  float* obs_rcw;       // (NP, KO, 3, 3)
  float* obs_pcw;       // (NP, KO, 3)
  int32_t* obs_slot;    // (NP, KO)
  int32_t* obs_fid;     // (NP, KO)
  int32_t* obs_level;   // (NP, KO)
  int32_t* vox_keys;    // (T,)
  int32_t* vox_count;   // (T,)
  int32_t* vox_idx;     // (T, VC)
  const int32_t* img_fid;  // (R,)
  // the frame
  const float *fx, *fy, *cx, *cy, *dist;
  const float* img;       // (H, W)
  const float* rcw2;      // (3, 3) the posterior pose
  const float* pcw2;      // (3,)
  const float* rcw;       // (3, 3) the prior pose (the new points' observation)
  const float* pcw;       // (3,)
  const int32_t* fid;     // ()
  const int32_t* t_idx;   // (B,)
  const uint8_t* t_valid; // (B,)
  const int32_t* t_slevel;  // (B,)
  const float* npos;      // (B, 3)
  const float* npx;       // (B, 2)
  const float* nscore;    // (B,)
  const uint8_t* nadd;    // (B,)
  // outputs
  float* opc;        // (B, 2)
  float* oscore;     // (B,)
  int32_t* n_pts_out;  // ()
  int NP, KO, T, VC, R, H, W, B, max_probe;
};

__device__ __forceinline__ bool key_less(const int* k, int j, int i) {
  const int* a = k + 3 * j;
  const int* b = k + 3 * i;
  if (a[2] != b[2]) return a[2] < b[2];
  if (a[1] != b[1]) return a[1] < b[1];
  if (a[0] != b[0]) return a[0] < b[0];
  return j < i;
}

__global__ void __launch_bounds__(THREADS) vio_observations_kernel(const Obs o) {
  extern __shared__ int sm[];
  const int B = o.B, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* s_add = sm;          // prep's gate (row order)
  int* s_w = s_add + B;     // add_observations' ring entry
  int* s_n = s_w + B;       // its n_obs after the write
  int* s_m2 = s_n + B;      // add_points' mask within capacity
  int* s_nidx = s_m2 + B;   // its point row (NP when dropped)
  int* s_key = s_nidx + B;  // (B, 3) voxel keys, row order
  // by position in key order
  int* s_row = s_key + 3 * B;
  int* s_chk = s_row + B;
  int* s_slot = s_chk + B;
  int* s_msk = s_slot + B;
  int* s_grp = s_msk + B;
  int* s_rank = s_grp + B;
  int* s_lead = s_rank + B;
  int* s_done = s_lead + B;
  int* s_res = s_done + B;
  int* s_claim = s_res + B;
  int* s_mine = s_claim + B;
  int* s_resall = s_mine + B;
  int* s_ok = s_resall + B;
  int* s_wp = s_ok + B;
  int* s_inc = s_wp + B;   // by group
  int* s_gres = s_inc + B;  // by group: the lowest resolved slot
  __shared__ int sh_first, sh_ngrp;
  __shared__ float rcw2[9], pcw2[3], campos2[3], rcw[9], pcw[3];

  const vio::Cam cam = vio::load_cam(o.fx, o.fy, o.cx, o.cy, o.dist);
  const int32_t fid = __ldg(o.fid);
  if (tid < 9) {
    rcw2[tid] = __ldg(o.rcw2 + tid);
    rcw[tid] = __ldg(o.rcw + tid);
  }
  if (tid < 3) {
    pcw2[tid] = __ldg(o.pcw2 + tid);
    pcw[tid] = __ldg(o.pcw + tid);
  }
  if (tid == 0) sh_first = o.R;
  __syncthreads();
  if (tid == 0) vio::campos_of(rcw2, pcw2, campos2);
  // visual_map._slot_of_fid: the first pool slot holding fid, else 0
  for (int r = tid; r < o.R; r += THREADS)
    if (o.img_fid[r] == fid) atomicMin(&sh_first, r);
  __syncthreads();
  const int slot = sh_first < o.R ? sh_first : 0;

  // prep_observations, one warp per row
  for (int k = warp; k < B; k += THREADS / 32) {
    const int safe = vio::clampi(__ldg(o.t_idx + k), 0, o.NP - 1);
    const float p[3] = {o.pos[3 * safe], o.pos[3 * safe + 1], o.pos[3 * safe + 2]};
    float pf[3], pu, pv;
    vio::rows_times_add(p, rcw2, pcw2, pf);
    vio::world2cam(cam, pf, pu, pv);
    int bf = -2147483647 - 1, bo = 1 << 30;  // the most recent: first maximum of the fids
    for (int q = lane; q < o.KO; q += 32) {
      const int f = o.obs_fid[(size_t)safe * o.KO + q];
      if (f > bf) {
        bf = f;
        bo = q;
      }
    }
    for (int off = 16; off >= 1; off >>= 1) {
      const int of = __shfl_xor_sync(vio::FULL, bf, off);
      const int oo = __shfl_xor_sync(vio::FULL, bo, off);
      if (of > bf || (of == bf && oo < bo)) {
        bf = of;
        bo = oo;
      }
    }
    const size_t e = (size_t)safe * o.KO + bo;
    float rR[9], rt[3], Rd[9], td[3];
    for (int k9 = 0; k9 < 9; ++k9) rR[k9] = o.obs_rcw[9 * e + k9];
    for (int k3 = 0; k3 < 3; ++k3) rt[k3] = o.obs_pcw[3 * e + k3];
    const float rpu = o.obs_px[2 * e], rpv = o.obs_px[2 * e + 1];
    // Rd = ref_rcw @ rcw, td = ref_pcw - Rd @ pcw
    for (int i = 0; i < 3; ++i)
      for (int m = 0; m < 3; ++m)
        Rd[3 * i + m] = (rR[3 * i] * rcw2[m] + rR[3 * i + 1] * rcw2[3 + m]) +
                        rR[3 * i + 2] * rcw2[6 + m];
    for (int i = 0; i < 3; ++i)
      td[i] = rt[i] - ((Rd[3 * i] * pcw2[0] + Rd[3 * i + 1] * pcw2[1]) + Rd[3 * i + 2] * pcw2[2]);
    const float dp = vio::norm3(td[0], td[1], td[2]);
    const float tr = (Rd[0] + Rd[4]) + Rd[8];
    float cth = 0.5f * (tr - 1.0f);
    if (!isnan(cth)) cth = fminf(fmaxf(cth, -1.0f), 1.0f);
    const float dth = tr > (float)(3.0 - 1e-6) ? 0.0f : acosf(cth);
    const float dx = pu - rpu, dy = pv - rpv;
    const float pix = sqrtf(dx * dx + dy * dy);
    const bool add = __ldg(o.t_valid + k) && (dp > 0.5f || dth > 10.0f || pix > 40.0f);
    const float sc = vio::shi_tomasi_warp(o.img, o.H, o.W, pu, pv, lane);
    if (lane == 0) {
      o.opc[2 * k] = pu;
      o.opc[2 * k + 1] = pv;
      o.oscore[k] = sc;
      s_add[k] = add ? 1 : 0;
    }
  }
  __syncthreads();

  // add_observations: the ring entry of each row, then the kept rows' writes
  for (int k = tid; k < B; k += THREADS) {
    const int safe = vio::clampi(o.t_idx[k], 0, o.NP - 1);
    const int n = o.n_obs[safe];
    float best = -INFINITY;
    int ev = 1 << 30;
    for (int q = 0; q < o.KO; ++q) {
      const size_t e = (size_t)safe * o.KO + q;
      float R9[9], t3[3], cp[3];
      for (int k9 = 0; k9 < 9; ++k9) R9[k9] = o.obs_rcw[9 * e + k9];
      for (int k3 = 0; k3 < 3; ++k3) t3[k3] = o.obs_pcw[3 * e + k3];
      vio::campos_of(R9, t3, cp);
      float d = vio::norm3(cp[0] - campos2[0], cp[1] - campos2[1], cp[2] - campos2[2]);
      if (!(o.obs_fid[e] >= 0)) d = -1.0f;
      if (vio::beats(d, q, best, ev)) {
        best = d;
        ev = q;
      }
    }
    s_w[k] = n >= o.KO ? ev : min(n, o.KO - 1);
    s_n[k] = min(n + 1, o.KO);
  }
  __syncthreads();
  for (int k = tid; k < B; k += THREADS) {
    if (!s_add[k]) continue;
    const int safe = vio::clampi(o.t_idx[k], 0, o.NP - 1);
    const size_t e = (size_t)safe * o.KO + s_w[k];
    o.value[safe] = o.oscore[k];
    o.n_obs[safe] = s_n[k];
    o.obs_px[2 * e] = o.opc[2 * k];
    o.obs_px[2 * e + 1] = o.opc[2 * k + 1];
    for (int k9 = 0; k9 < 9; ++k9) o.obs_rcw[9 * e + k9] = rcw2[k9];
    for (int k3 = 0; k3 < 3; ++k3) o.obs_pcw[3 * e + k3] = pcw2[k3];
    o.obs_slot[e] = slot;
    o.obs_fid[e] = fid;
    o.obs_level[e] = __ldg(o.t_slevel + k);
  }

  // add_points: the mask within capacity, in mask order
  if (tid == 0) {
    const int np0 = *o.n_pts;
    int c1 = 0, c2 = 0;
    for (int i = 0; i < B; ++i) {
      const int m = __ldg(o.nadd + i) ? 1 : 0;
      c1 += m;
      const int m2 = m && np0 + c1 <= o.NP;
      s_m2[i] = m2;
      s_nidx[i] = m2 ? np0 + c2 : o.NP;
      c2 += m2;
    }
    *o.n_pts_out = np0 + c2;
  }
  __syncthreads();
  for (int i = tid; i < B; i += THREADS) {
    const int m2 = s_m2[i];
    for (int k3 = 0; k3 < 3; ++k3)
      s_key[3 * i + k3] = m2 ? (int32_t)floorf(__ldg(o.npos + 3 * i + k3) * 2.0f)
                             : vio::EMPTY + 1;
    if (!m2) continue;
    const int r = s_nidx[i];
    const size_t e = (size_t)r * o.KO;
    for (int k3 = 0; k3 < 3; ++k3) o.pos[3 * r + k3] = __ldg(o.npos + 3 * i + k3);
    o.value[r] = __ldg(o.nscore + i);
    o.n_obs[r] = 1;
    o.obs_px[2 * e] = __ldg(o.npx + 2 * i);
    o.obs_px[2 * e + 1] = __ldg(o.npx + 2 * i + 1);
    for (int k9 = 0; k9 < 9; ++k9) o.obs_rcw[9 * e + k9] = rcw[k9];
    for (int k3 = 0; k3 < 3; ++k3) o.obs_pcw[3 * e + k3] = pcw[k3];
    o.obs_slot[e] = slot;
    o.obs_fid[e] = fid;
    o.obs_level[e] = 0;
  }
  __syncthreads();

  // _voxel_index_insert: the rows in (z, y, x, row) order, by counting
  for (int i = tid; i < B; i += THREADS) {
    int pos = 0;
    for (int j = 0; j < B; ++j) pos += key_less(s_key, j, i);
    s_row[pos] = i;
  }
  __syncthreads();
  const int tmask = o.T - 1;
  for (int p = tid; p < B; p += THREADS) {
    const int i = s_row[p];
    const int* k = s_key + 3 * i;
    int sl;
    int32_t chk;
    vio::slot_check(k[0], k[1], k[2], tmask, sl, chk);
    s_chk[p] = chk;
    s_slot[p] = sl;
    s_msk[p] = s_m2[i];
    const int* kp = p > 0 ? s_key + 3 * s_row[p - 1] : nullptr;
    s_lead[p] = p == 0 || kp[0] != k[0] || kp[1] != k[1] || kp[2] != k[2];  // a group's start
    s_done[p] = !s_m2[i];
    s_res[p] = o.T;
  }
  __syncthreads();
  if (tid == 0) {
    int g = -1, first = 0;
    for (int p = 0; p < B; ++p) {
      if (s_lead[p]) {
        ++g;
        first = p;
      }
      s_grp[p] = g;
      s_rank[p] = p - first;
      s_lead[p] = s_lead[p] && s_msk[p];
    }
    sh_ngrp = g + 1;
  }
  __syncthreads();
  for (int round = 0; round < o.max_probe; ++round) {
    for (int p = tid; p < B; p += THREADS) {
      const int32_t cur = o.vox_keys[s_slot[p]];
      s_mine[p] = cur == s_chk[p] && !s_done[p];
      s_claim[p] = cur == vio::EMPTY && s_lead[p] && !s_done[p];
    }
    __syncthreads();
    for (int p = tid; p < B; p += THREADS) {
      if (!s_claim[p]) continue;
      bool win = true;  // the later row in key order keeps a contested slot
      for (int q = p + 1; q < B && win; ++q) win = !(s_claim[q] && s_slot[q] == s_slot[p]);
      if (win) o.vox_keys[s_slot[p]] = s_chk[p];
    }
    __syncthreads();
    for (int p = tid; p < B; p += THREADS) {
      const bool won = s_claim[p] && o.vox_keys[s_slot[p]] == s_chk[p];
      if ((s_mine[p] || won) && s_res[p] == o.T) s_res[p] = s_slot[p];
      s_done[p] = s_done[p] || s_mine[p] || won;
      s_slot[p] = (s_slot[p] + 1) & tmask;
    }
    __syncthreads();
  }
  for (int g = tid; g < sh_ngrp; g += THREADS) {
    s_gres[g] = o.T;
    s_inc[g] = 0;
  }
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) atomicMin(&s_gres[s_grp[p]], s_res[p]);
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) {
    const int ra = s_gres[s_grp[p]];
    const int wpos = o.vox_count[min(ra, o.T - 1)] + s_rank[p];
    const int ok = ra < o.T && s_msk[p] && wpos < o.VC;
    s_resall[p] = ra;
    s_ok[p] = ok;
    s_wp[p] = min(wpos, o.VC - 1);
    if (ok) atomicAdd(&s_inc[s_grp[p]], 1);
  }
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) {
    const int ra = s_resall[p];
    if (s_ok[p]) {
      bool win = true;  // the later row keeps a contested entry
      for (int q = p + 1; q < B && win; ++q)
        win = !(s_ok[q] && s_resall[q] == ra && s_wp[q] == s_wp[p]);
      if (win) o.vox_idx[(size_t)ra * o.VC + s_wp[p]] = s_nidx[s_row[p]];
    }
    if (s_lead[p] && ra < o.T) atomicAdd(o.vox_count + ra, s_inc[s_grp[p]]);
  }
}

}  // namespace

// The map upkeep of one camera frame over B rows (the grid cells), in
// place. Pointers, all contiguous on the device: the visual map's pos (NP,
// 3), value (NP,), n_obs (NP,) int32, n_pts () int32 (read), obs_px (NP,
// KO, 2), obs_rcw (NP, KO, 3, 3), obs_pcw (NP, KO, 3), obs_slot, obs_fid,
// obs_level (NP, KO) int32, vox_keys, vox_count (T,) int32, vox_idx (T,
// VC) int32 and img_fid (R,) int32; the camera's fx, fy, cx, cy () and d
// (4,) f32; the frame img (H, W) f32, the posterior pose rcw2 (3, 3), pcw2
// (3,), the prior pose rcw (3, 3), pcw (3,), the frame id () int32; the
// tracked rows idx (B,) int32, valid (B,) u8 and search level (B,) int32;
// the new points pos (B, 3), px (B, 2), score (B,) f32 and mask (B,) u8;
// outputs opc (B, 2), oscore (B,) f32 and n_pts' () int32. Returns the
// launch's cudaError_t (0 = cudaSuccess).
extern "C" int vio_observations_launch(
    void* pos, void* value, void* n_obs, const void* n_pts, void* obs_px, void* obs_rcw,
    void* obs_pcw, void* obs_slot, void* obs_fid, void* obs_level, void* vox_keys,
    void* vox_count, void* vox_idx, const void* img_fid, const void* fx, const void* fy,
    const void* cx, const void* cy, const void* dist, const void* img, const void* rcw2,
    const void* pcw2, const void* rcw, const void* pcw, const void* fid, const void* t_idx,
    const void* t_valid, const void* t_slevel, const void* npos, const void* npx,
    const void* nscore, const void* nadd, void* opc, void* oscore, void* n_pts_out, int NP,
    int KO, int T, int VC, int R, int H, int W, int B, int max_probe, void* stream) {
  if (NP < 1 || KO < 1 || T < 1 || (T & (T - 1)) || VC < 1 || R < 1 || H < 1 || W < 1 ||
      B < 1 || B > MAX_B || max_probe < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Obs o;
  o.pos = static_cast<float*>(pos);
  o.value = static_cast<float*>(value);
  o.n_obs = static_cast<int32_t*>(n_obs);
  o.n_pts = static_cast<const int32_t*>(n_pts);
  o.obs_px = static_cast<float*>(obs_px);
  o.obs_rcw = static_cast<float*>(obs_rcw);
  o.obs_pcw = static_cast<float*>(obs_pcw);
  o.obs_slot = static_cast<int32_t*>(obs_slot);
  o.obs_fid = static_cast<int32_t*>(obs_fid);
  o.obs_level = static_cast<int32_t*>(obs_level);
  o.vox_keys = static_cast<int32_t*>(vox_keys);
  o.vox_count = static_cast<int32_t*>(vox_count);
  o.vox_idx = static_cast<int32_t*>(vox_idx);
  o.img_fid = static_cast<const int32_t*>(img_fid);
  o.fx = static_cast<const float*>(fx);
  o.fy = static_cast<const float*>(fy);
  o.cx = static_cast<const float*>(cx);
  o.cy = static_cast<const float*>(cy);
  o.dist = static_cast<const float*>(dist);
  o.img = static_cast<const float*>(img);
  o.rcw2 = static_cast<const float*>(rcw2);
  o.pcw2 = static_cast<const float*>(pcw2);
  o.rcw = static_cast<const float*>(rcw);
  o.pcw = static_cast<const float*>(pcw);
  o.fid = static_cast<const int32_t*>(fid);
  o.t_idx = static_cast<const int32_t*>(t_idx);
  o.t_valid = static_cast<const uint8_t*>(t_valid);
  o.t_slevel = static_cast<const int32_t*>(t_slevel);
  o.npos = static_cast<const float*>(npos);
  o.npx = static_cast<const float*>(npx);
  o.nscore = static_cast<const float*>(nscore);
  o.nadd = static_cast<const uint8_t*>(nadd);
  o.opc = static_cast<float*>(opc);
  o.oscore = static_cast<float*>(oscore);
  o.n_pts_out = static_cast<int32_t*>(n_pts_out);
  o.NP = NP;
  o.KO = KO;
  o.T = T;
  o.VC = VC;
  o.R = R;
  o.H = H;
  o.W = W;
  o.B = B;
  o.max_probe = max_probe;
  const size_t smem = (size_t)NARR * B * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(vio_observations_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  vio_observations_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(o);
  return static_cast<int>(cudaGetLastError());
}
