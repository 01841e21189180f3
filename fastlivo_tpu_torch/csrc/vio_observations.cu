// The camera frame's visual-map upkeep in one launch, for Hopper: the
// observations of the tracked points and the new points, written into the
// map in place.
//
// vio_observations replaces the jitted XLA code of the JAX package's
// fastlivo_tpu/vio.py::prep_observations (jitted at :971) and
// fastlivo_tpu/visual_map.py::add_observations (jitted at :493) and
// add_points (jitted at :243) with its voxel-index insert; no Pallas
// kernel. Its plain version is the port's vio._cam_pose of the posterior
// state, vio.prep_observations, visual_map.add_observations and
// visual_map.add_points, which read the count of kept rows back to the
// host (`_kept`); this kernel reads nothing back and keeps n_pts on the
// device. One cooperative launch of NT row blocks and one insert block,
// with one grid barrier between the reads and the writes:
//   every block: the posterior camera pose rcw2, pcw2 from the state's rot
//   and pos (f64, rounded to f32) and Rci, Pci in vio._cam_pose's order,
//   and the frame's pool slot (visual_map._slot_of_fid);
//   row blocks, one warp per row (prep_observations and the write plan of
//   add_observations): the pixel at the posterior pose, the most recent
//   observation (the first maximum of the ring's fids) and the ring entry
//   to write (the next free one, or the furthest view when the ring is
//   full: the first maximum of the camera-centre distances), a lane per
//   ring entry; the Δp, Δθ and pixel-distance gates and the Shi-Tomasi
//   score (vio_common.cuh); the pixels and scores are outputs;
//   the insert block at the same time (add_points and
//   _voxel_index_insert, which touch only rows from n_pts on and the voxel
//   hash): the capacity mask and the new rows by one block scan, the rows
//   ranked by (z, y, x voxel key, row) by counting against the masked rows
//   only, the groups by a scan of their starts, the claim rounds (a round
//   reads the probed slots of the pending rows; the claims of a round are
//   compacted by a scan, and the later row in key order keeps a contested
//   slot) until no group leader is pending, then the followers' remaining
//   probes on the now fixed table, the appends up to the voxel capacity
//   (the later row keeps a contested entry) and one count increment per
//   group (an integer atomicAdd: order-free);
//   grid barrier: every read of the map's rows is done;
//   row blocks: the kept rows' ring writes; the insert block: the new
//   rows' point fields and creation observation. A kept row that is also
//   a new row (possible only for a row at or past n_pts) writes only its
//   ring entry when that is not entry 0, which is exactly what the plain
//   version's later add_points leaves of it; the writes are then disjoint.
// Integer arithmetic apart from the pose and the prep stage, whose float
// expressions follow the plain version's order (built with -fmad=false).
// Up to STAGE_B rows the insert block keeps its NARR words a row in
// dynamic shared memory (and each row block its warps' plans); past that
// the same code keeps them, and the rows' plans, in a global scratch of
// vio_observations_scratch_ints(B) ints, zero on entry, which the kernel
// writes back to zero after its last read of them, so that any number of
// rows runs in the same one launch. The layout is a template parameter
// the launch picks by B (so that the staged instance's accesses stay
// shared-memory ones).
//
// Bound (chip_smoke.py's vio_observations_bound_ms): the bytes of the
// rows' inputs, the map rows and rings they read and write, the probed
// voxel slots and the pose, once each, over HBM bandwidth. What holds it
// above: the chain of dependent loads of a row (its index, its point and
// ring, the image taps) and of the insert (the table's slots, the counts),
// and the grid barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "vio_common.cuh"
#include "phase_stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;  // a warp a row: 32 rows a row block
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_B = 2048;  // rows whose insert arrays fit shared memory (224 KB)
constexpr int NARR = 28;  // the insert block's words a row (4 packed keys, 20 ints)
constexpr int MAX_DEV = 64;

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
  const double* rot;      // (3, 3) the posterior state
  const double* spos;     // (3,)
  const float* Rci;       // (3, 3)
  const float* Pci;       // (3,)
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
  int32_t* nrow;     // (B,) scratch: a new point's map row, -1 where dropped
  int* ws;           // past STAGE_B rows: (NARR + 1) B ints, the insert block's
                     // arrays and the rows' plans (the global layout's)
  float* rcw2_out;   // (3, 3)
  float* pcw2_out;   // (3,)
  int NP, KO, T, VC, R, H, W, B, max_probe;
};

// A row's voxel key (x, y, z) and row number packed so that two unsigned
// comparisons give the (z, y, x, row) order: zy = z' << 32 | y', xr = x'
// << 32 | row, where v' = v ^ 0x80000000 orders int32 as uint32.
__device__ __forceinline__ unsigned long long pack_zy(int32_t y, int32_t z) {
  return (unsigned long long)((uint32_t)z ^ 0x80000000u) << 32 | ((uint32_t)y ^ 0x80000000u);
}
__device__ __forceinline__ unsigned long long pack_xr(int32_t x, int row) {
  return (unsigned long long)((uint32_t)x ^ 0x80000000u) << 32 | (unsigned)row;
}
__device__ __forceinline__ int32_t unpack(unsigned long long v) {
  return (int32_t)((uint32_t)v ^ 0x80000000u);
}

// In-place exclusive prefix sum of a[0, n) over the block (each thread a
// contiguous chunk); returns the total to every thread. s_w: WARPS ints.
__device__ int block_excl_scan(int* a, int n, int* s_w) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = (n + THREADS - 1) / THREADS;
  const int lo = min(tid * C, n), hi = min(lo + C, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int x = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(vio::FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_w[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? s_w[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(vio::FULL, w, off);
      if (lane >= off) w += y;
    }
    if (lane < WARPS) s_w[lane] = w;
  }
  __syncthreads();
  int base = (warp > 0 ? s_w[warp - 1] : 0) + x - sum;
  const int total = s_w[WARPS - 1];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = base;
    base += v;
  }
  __syncthreads();
  return total;
}

// prep_observations of row k and its add_observations write plan, by one
// warp; returns the plan packed (kept | entry << 1 | n_obs' << 16) to
// every lane and writes the row's pixel and score.
__device__ int prep_row(const Obs& o, const vio::Cam& cam, const float* rcw2,
                        const float* pcw2, const float* campos2, int k, int lane) {
  const int safe = vio::clampi(__ldg(o.t_idx + k), 0, o.NP - 1);
  const float p[3] = {o.pos[3 * safe], o.pos[3 * safe + 1], o.pos[3 * safe + 2]};
  const int n = o.n_obs[safe];
  float pf[3], pu, pv;
  vio::rows_times_add(p, rcw2, pcw2, pf);
  vio::world2cam(cam, pf, pu, pv);
  // a lane per ring entry: the most recent (first maximum of the fids) and
  // the furthest view (first maximum of the distances, -1 where empty)
  int bf = -2147483647 - 1, bo = 1 << 30;
  float best = -INFINITY;
  int ev = 1 << 30;
  for (int q = lane; q < o.KO; q += 32) {
    const size_t e = (size_t)safe * o.KO + q;
    const int f = o.obs_fid[e];
    if (f > bf) {
      bf = f;
      bo = q;
    }
    float R9[9], t3[3], cp[3];
    for (int k9 = 0; k9 < 9; ++k9) R9[k9] = o.obs_rcw[9 * e + k9];
    for (int k3 = 0; k3 < 3; ++k3) t3[k3] = o.obs_pcw[3 * e + k3];
    vio::campos_of(R9, t3, cp);
    float d = vio::norm3(cp[0] - campos2[0], cp[1] - campos2[1], cp[2] - campos2[2]);
    if (!(f >= 0)) d = -1.0f;
    if (vio::beats(d, q, best, ev)) {
      best = d;
      ev = q;
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const int of = __shfl_xor_sync(vio::FULL, bf, off);
    const int oo = __shfl_xor_sync(vio::FULL, bo, off);
    if (of > bf || (of == bf && oo < bo)) {
      bf = of;
      bo = oo;
    }
  }
  vio::warp_argmax(best, ev);
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
  const float sc = vio::shi_tomasi_half(o.img, o.H, o.W, pu, pv, lane & 15,
                                        0xFFFFu << (lane & 16));  // both halves alike
  if (lane == 0) {
    o.opc[2 * k] = pu;
    o.opc[2 * k + 1] = pv;
    o.oscore[k] = sc;
  }
  const int w = n >= o.KO ? ev : min(n, o.KO - 1);
  return (add ? 1 : 0) | (w << 1) | (min(n + 1, o.KO) << 16);
}

// The kept row k's ring write (add_observations), lanes over its fields.
// A row that add_points writes after (np0 <= safe < np0 + n_new) keeps
// only an entry other than 0: the plain version's add_points overwrites
// its value, n_obs and entry 0.
__device__ void write_row(const Obs& o, const float* rcw2, const float* pcw2, int slot,
                          int32_t fid, int np0, int n_new, int k, int pack, int lane) {
  if (!(pack & 1)) return;
  const int safe = vio::clampi(__ldg(o.t_idx + k), 0, o.NP - 1);
  const int w = (pack >> 1) & 0x7FFF;
  const bool renewed = safe >= np0 && safe - np0 < n_new;
  if (renewed && w == 0) return;
  const size_t e = (size_t)safe * o.KO + w;
  if (lane < 9) o.obs_rcw[9 * e + lane] = rcw2[lane];
  else if (lane < 12) o.obs_pcw[3 * e + lane - 9] = pcw2[lane - 9];
  else if (lane < 14) o.obs_px[2 * e + lane - 12] = o.opc[2 * k + lane - 12];
  else if (lane == 14) o.obs_slot[e] = slot;
  else if (lane == 15) o.obs_fid[e] = fid;
  else if (lane == 16) o.obs_level[e] = __ldg(o.t_slevel + k);
  else if (lane == 17 && !renewed) o.value[safe] = o.oscore[k];
  else if (lane == 18 && !renewed) o.n_obs[safe] = pack >> 16;
}

struct Ins {  // the insert block's shared arrays
  unsigned long long *kzy, *kxr;  // the packed keys (pack_zy, pack_xr)
  unsigned long long *czy, *cxr;  // the kept rows' packed keys, in row order
  int *m2, *cx, *row, *chk, *slot, *msk, *lead, *grp, *rank, *done, *res, *mine,
      *claim, *flag, *list, *first, *gres, *inc, *ok, *wp;
};

// add_points' masks and _voxel_index_insert, by the insert block, before
// the grid barrier: writes n_pts' and the voxel hash; the new rows' point
// fields wait for the barrier (their row numbers go to o.nrow).
__device__ void insert_hash(const Obs& o, const Ins& s, int* s_w, int np0) {
  const int B = o.B, tid = threadIdx.x;
  for (int i = tid; i < B; i += THREADS) {  // the keys loaded with the mask
    const int m = __ldg(o.nadd + i) ? 1 : 0;
    s.m2[i] = m;
    s.cx[i] = m;
    int32_t k[3];
    for (int k3 = 0; k3 < 3; ++k3) k[k3] = (int32_t)floorf(__ldg(o.npos + 3 * i + k3) * 2.0f);
    s.kzy[i] = pack_zy(k[1], k[2]);
    s.kxr[i] = pack_xr(k[0], i);
  }
  __syncthreads();
  // the mask's running count c1; a row is kept while np0 + c1 <= NP, so
  // the kept rows are the first max(NP - np0, 0) masked rows, each at
  // np0 + (its exclusive count)
  const int n_mask = block_excl_scan(s.cx, B, s_w);
  const int cap = max(o.NP - np0, 0);
  const int n_new = min(n_mask, cap);
  constexpr int32_t E = vio::EMPTY + 1;  // the key of every row not kept
  for (int i = tid; i < B; i += THREADS) {
    const int m2 = s.m2[i] && s.cx[i] < cap;
    s.m2[i] = m2;
    s.cx[i] = min(s.cx[i], cap);  // the kept rows' exclusive count
    if (!m2) {
      s.kzy[i] = pack_zy(E, E);
      s.kxr[i] = pack_xr(E, i);
    } else {
      s.czy[s.cx[i]] = s.kzy[i];
      s.cxr[s.cx[i]] = s.kxr[i];
    }
    o.nrow[i] = m2 ? np0 + s.cx[i] : -1;
  }
  if (tid == 0) *o.n_pts_out = np0 + n_new;
  __syncthreads();
  PHASE_STAMP(7);
  // (z, y, x, row) order by counting: against the kept rows, S threads a
  // row (a power of two, adjacent lanes, each a share of the kept rows,
  // their counts summed by shuffles), and against the others at once
  // (they share the key E)
  const unsigned long long ezy = pack_zy(E, E), ex = pack_xr(E, 0) >> 32;
  const int S = B >= THREADS ? 1 : min(32, 1 << (31 - __clz(THREADS / B)));
  for (int base = 0; base < B * S; base += THREADS) {  // block-uniform
    const int u = base + tid, i = u / S, q = u % S;
    const bool live = i < B;
    int pos = 0;
    unsigned long long zy = 0, xr = 0;
    if (live) {
      zy = s.kzy[i];
      xr = s.kxr[i];
#pragma unroll 4
      for (int t = q; t < n_new; t += S) {
        const unsigned long long zj = s.czy[t], xj = s.cxr[t];
        pos += zj < zy || (zj == zy && xj < xr);
      }
    }
    for (int off = 1; off < S; off <<= 1) pos += __shfl_xor_sync(vio::FULL, pos, off);
    if (live && q == 0) {
      const unsigned long long x = xr >> 32;
      pos += ezy < zy || (ezy == zy && ex < x) ? B - n_new
             : ezy == zy && ex == x            ? i - s.cx[i]
                                               : 0;
      s.row[pos] = i;
    }
  }
  __syncthreads();
  PHASE_STAMP(8);
  const int tmask = o.T - 1;
  for (int p = tid; p < B; p += THREADS) {
    const int i = s.row[p];
    const unsigned long long zy = s.kzy[i], x = s.kxr[i] >> 32;
    int sl;
    int32_t chk;
    vio::slot_check(unpack(x), unpack(zy), unpack(zy >> 32), tmask, sl, chk);
    s.chk[p] = chk;
    s.slot[p] = sl;
    s.msk[p] = s.m2[i];
    const int start = p == 0 || zy != s.kzy[s.row[p - 1]] || x != s.kxr[s.row[p - 1]] >> 32;
    s.lead[p] = start;
    s.grp[p] = start;
    s.done[p] = !s.m2[i];
    s.res[p] = o.T;
  }
  __syncthreads();
  // groups: the inclusive count of starts - 1; ranks from the group's first
  const int n_grp = block_excl_scan(s.grp, B, s_w);
  for (int p = tid; p < B; p += THREADS) {
    const int g = s.grp[p] + s.lead[p] - 1;
    s.grp[p] = g;
    if (s.lead[p]) {
      s.first[g] = p;
      s.gres[g] = o.T;
      s.inc[g] = 0;
    }
    s.lead[p] = s.lead[p] && s.msk[p];  // a group's leader: its start, if kept
  }
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) s.rank[p] = p - s.first[s.grp[p]];
  PHASE_STAMP(9);
  // claim rounds while a leader is pending (a follower never claims)
  int round = 0;
  for (;;) {
    for (int p = tid; p < B; p += THREADS) {
      int mine = 0, claim = 0;
      if (!s.done[p]) {
        const int32_t cur = o.vox_keys[s.slot[p]];
        mine = cur == s.chk[p];
        claim = cur == vio::EMPTY && s.lead[p];
      }
      s.mine[p] = mine;
      s.claim[p] = claim;
      s.flag[p] = claim;
    }
    __syncthreads();
    const int nc = block_excl_scan(s.flag, B, s_w);
    for (int p = tid; p < B; p += THREADS)
      if (s.claim[p]) s.list[s.flag[p]] = p;
    __syncthreads();
    for (int t = tid; t < nc; t += THREADS) {
      const int p = s.list[t];
      int win = p;  // the last claimant of this slot in key order keeps it
      for (int u = t + 1; u < nc; ++u)
        if (s.slot[s.list[u]] == s.slot[p]) win = s.list[u];
      if (win == p) o.vox_keys[s.slot[p]] = s.chk[p];
      s.claim[p] = s.chk[win] == s.chk[p];  // won: the slot holds its check after
    }
    __syncthreads();
    int pending = 0;
    for (int p = tid; p < B; p += THREADS) {
      const bool hit = s.mine[p] || s.claim[p];
      if (hit && s.res[p] == o.T) s.res[p] = s.slot[p];
      s.done[p] = s.done[p] || hit;
      s.slot[p] = (s.slot[p] + 1) & tmask;
      pending |= s.lead[p] && !s.done[p];
    }
    ++round;
    if (!__syncthreads_or(pending) || round == o.max_probe) break;
  }
  PHASE_STAMP(10);
  // the followers still pending probe on: no claim changes the table now
  for (int p = tid; p < B; p += THREADS) {
    if (s.done[p]) continue;
    int sl = s.slot[p];
    for (int r = round; r < o.max_probe; ++r) {
      if (o.vox_keys[sl] == s.chk[p]) {
        s.res[p] = sl;
        break;
      }
      sl = (sl + 1) & tmask;
    }
  }
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) atomicMin(&s.gres[s.grp[p]], s.res[p]);
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) {
    const int ra = s.gres[s.grp[p]];
    const int wpos = o.vox_count[min(ra, o.T - 1)] + s.rank[p];
    const int ok = ra < o.T && s.msk[p] && wpos < o.VC;
    s.ok[p] = ok;
    s.wp[p] = min(wpos, o.VC - 1);
    if (ok) atomicAdd(&s.inc[s.grp[p]], 1);
  }
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) {
    const int g = s.grp[p], ra = s.gres[g];
    if (s.ok[p]) {
      // the later row keeps a contested entry: a later group resolved to
      // the same slot, its row of the same rank (the same count base)
      bool win = true;
      for (int g2 = g + 1; g2 < n_grp && win; ++g2) {
        if (s.gres[g2] != ra) continue;
        const int q = s.first[g2] + s.rank[p];
        win = !(q < B && s.grp[q] == g2 && s.ok[q]);
      }
      if (win) o.vox_idx[(size_t)ra * o.VC + s.wp[p]] = np0 + s.cx[s.row[p]];
    }
    if (s.lead[p] && ra < o.T) atomicAdd(o.vox_count + ra, s.inc[g]);
  }
}

// add_points' point fields and creation observation of new point i at
// map row r, after the grid barrier, lanes over its fields.
__device__ void write_new_row(const Obs& o, const float* rcw, const float* pcw, int slot,
                              int32_t fid, int i, int r, int lane) {
  const size_t e = (size_t)r * o.KO;
  if (lane < 9) o.obs_rcw[9 * e + lane] = rcw[lane];
  else if (lane < 12) o.obs_pcw[3 * e + lane - 9] = pcw[lane - 9];
  else if (lane < 14) o.obs_px[2 * e + lane - 12] = __ldg(o.npx + 2 * i + lane - 12);
  else if (lane == 14) o.obs_slot[e] = slot;
  else if (lane == 15) o.obs_fid[e] = fid;
  else if (lane == 16) o.obs_level[e] = 0;
  else if (lane < 20) o.pos[3 * r + lane - 17] = __ldg(o.npos + 3 * i + lane - 17);
  else if (lane == 20) o.value[r] = __ldg(o.nscore + i);
  else if (lane == 21) o.n_obs[r] = 1;
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS) vio_observations_kernel(const Obs o) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(8) int sm[];
  __shared__ int sh_first, s_w[WARPS];
  __shared__ float rcw2[9], pcw2[3], campos2[3], rcw[9], pcw[3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool inserter = blockIdx.x == gridDim.x - 1;
  PHASE_STAMP_START();
  if (tid == 0) sh_first = o.R;
  if (tid == 0) vio::cam_pose(o.rot, o.spos, o.Rci, o.Pci, rcw2, pcw2);
  if (tid < 9) rcw[tid] = __ldg(o.rcw + tid);
  if (tid < 3) pcw[tid] = __ldg(o.pcw + tid);
  __syncthreads();
  if (tid == 0) vio::campos_of(rcw2, pcw2, campos2);
  if (blockIdx.x == 0 && tid < 9) o.rcw2_out[tid] = rcw2[tid];
  if (blockIdx.x == 0 && tid < 3) o.pcw2_out[tid] = pcw2[tid];
  const int32_t fid = __ldg(o.fid);
  for (int r = tid; r < o.R; r += THREADS)
    if (__ldg(o.img_fid + r) == fid) atomicMin(&sh_first, r);
  const int np0 = __ldg(o.n_pts);
  __syncthreads();
  const int slot = sh_first < o.R ? sh_first : 0;  // visual_map._slot_of_fid
  PHASE_STAMP(1);

  const int nwarps = (gridDim.x - 1) * WARPS;
  const int gw = blockIdx.x * WARPS + warp;
  // the rows' plans: a row block's in its shared memory, or the scratch's
  // last B ints (a row's at its index)
  const auto plan_at = [&](int k, int j) -> int* {
    return STAGED ? sm + j * WARPS + warp : o.ws + (size_t)NARR * o.B + k;
  };
  Ins s;
  if (inserter) {  // its warps take rows after the barrier too
    int* base = STAGED ? sm : o.ws;
    s.kzy = reinterpret_cast<unsigned long long*>(base);  // 8-byte aligned first
    s.kxr = s.kzy + o.B;
    s.czy = s.kxr + o.B;
    s.cxr = s.czy + o.B;
    int* a = reinterpret_cast<int*>(s.cxr + o.B);
    int** f[] = {&s.m2, &s.cx, &s.row, &s.chk, &s.slot, &s.msk, &s.lead, &s.grp,
                 &s.rank, &s.done, &s.res, &s.mine, &s.claim, &s.flag, &s.list, &s.first,
                 &s.gres, &s.inc, &s.ok, &s.wp};
    for (int** p : f) {
      *p = a;
      a += o.B;
    }
    insert_hash(o, s, s_w, np0);
    PHASE_STAMP(5);
  } else {
    const vio::Cam cam = vio::load_cam(o.fx, o.fy, o.cx, o.cy, o.dist);
    for (int k = gw, j = 0; k < o.B; k += nwarps, ++j) {
      const int pack = prep_row(o, cam, rcw2, pcw2, campos2, k, lane);
      if (lane == 0) *plan_at(k, j) = pack;
    }
    PHASE_STAMP(6);
  }
  PHASE_STAMP(2);
  grid.sync();
  PHASE_STAMP(3);
  // the writes, the new rows spread over every warp of the grid
  if (!inserter) {
    const int n_new = __ldcg(o.n_pts_out) - np0;
    __syncwarp();
    for (int k = gw, j = 0; k < o.B; k += nwarps, ++j) {
      int* pl = plan_at(k, j);
      const int pack = STAGED ? *pl : __shfl_sync(vio::FULL, lane == 0 ? __ldcg(pl) : 0, 0);
      if (!STAGED && lane == 0) *pl = 0;  // the scratch back at 0
      write_row(o, rcw2, pcw2, slot, fid, np0, n_new, k, pack, lane);
    }
  } else if (!STAGED) {  // the insert arrays back at 0 (read no more after the barrier)
    const size_t n = (size_t)NARR * o.B;
    int4* w4 = reinterpret_cast<int4*>(o.ws);
    for (size_t i = tid; i < n / 4; i += THREADS) w4[i] = make_int4(0, 0, 0, 0);
    for (size_t i = n / 4 * 4 + tid; i < n; i += THREADS) o.ws[i] = 0;
  }
  for (int i = gw; i < o.B; i += gridDim.x * WARPS) {
    const int r = __ldcg(o.nrow + i);
    if (r >= 0) write_new_row(o, rcw, pcw, slot, fid, i, r, lane);
  }
  PHASE_STAMP(4);
}

struct DevInfo {  // per layout (staged, global): the limit set, the occupancy
  int coop = -1, sms = 0, smem_set[2] = {0, 0}, occ_smem[2] = {-1, -1}, per_sm[2] = {0, 0};
};
DevInfo g_dev[MAX_DEV];

}  // namespace

PHASE_STAMPS_EXPORT(vio_observations)

// The global scratch a launch of B rows takes, in int32: none up to
// STAGE_B rows, else the insert block's NARR words a row and a plan a
// row; -1 for a B the kernel's int indices do not hold.
extern "C" int vio_observations_scratch_ints(int B) {
  if (B < 1 || (long long)(NARR + 1) * B >= (1LL << 31)) return -1;
  return B > STAGE_B ? (NARR + 1) * B : 0;
}

// The map upkeep of one camera frame over B rows (the grid cells), in
// place. Pointers, all contiguous on the device: the visual map's pos (NP,
// 3), value (NP,), n_obs (NP,) int32, n_pts () int32 (read), obs_px (NP,
// KO, 2), obs_rcw (NP, KO, 3, 3), obs_pcw (NP, KO, 3), obs_slot, obs_fid,
// obs_level (NP, KO) int32, vox_keys, vox_count (T,) int32, vox_idx (T,
// VC) int32 and img_fid (R,) int32; the camera's fx, fy, cx, cy () and d
// (4,) f32; the frame img (H, W) f32; the posterior state's rot (3, 3) and
// pos (3,) f64 and the extrinsics Rci (3, 3), Pci (3,) f32; the prior pose
// rcw (3, 3), pcw (3,) f32, the frame id () int32; the tracked rows idx
// (B,) int32, valid (B,) u8 and search level (B,) int32; the new points
// pos (B, 3), px (B, 2), score (B,) f32 and mask (B,) u8; outputs opc (B,
// 2), oscore (B,) f32, n_pts' () int32 and the posterior pose rcw2 (3, 3),
// pcw2 (3,) f32; scratch nrow (B,) int32 and ws,
// vio_observations_scratch_ints(B) int32 zeros (16-byte aligned; left at
// 0; none up to STAGE_B rows). `grid_out` receives the number of blocks
// launched.
// Returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int vio_observations_launch(
    void* pos, void* value, void* n_obs, const void* n_pts, void* obs_px, void* obs_rcw,
    void* obs_pcw, void* obs_slot, void* obs_fid, void* obs_level, void* vox_keys,
    void* vox_count, void* vox_idx, const void* img_fid, const void* fx, const void* fy,
    const void* cx, const void* cy, const void* dist, const void* img, const void* rot,
    const void* spos, const void* Rci, const void* Pci, const void* rcw, const void* pcw,
    const void* fid, const void* t_idx, const void* t_valid, const void* t_slevel,
    const void* npos, const void* npx, const void* nscore, const void* nadd, void* opc,
    void* oscore, void* n_pts_out, void* rcw2, void* pcw2, void* nrow, void* ws, int NP, int KO,
    int T, int VC, int R, int H, int W, int B, int max_probe, int* grid_out, void* stream) {
  if (NP < 1 || KO < 1 || KO > 0x7FFF || T < 1 || (T & (T - 1)) || VC < 1 || R < 1 || H < 1 ||
      W < 1 || vio_observations_scratch_ints(B) < 0 || max_probe < 1 ||
      (B > STAGE_B && (ws == nullptr || (reinterpret_cast<uintptr_t>(ws) & 15))))
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
  o.rot = static_cast<const double*>(rot);
  o.spos = static_cast<const double*>(spos);
  o.Rci = static_cast<const float*>(Rci);
  o.Pci = static_cast<const float*>(Pci);
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
  o.rcw2_out = static_cast<float*>(rcw2);
  o.pcw2_out = static_cast<float*>(pcw2);
  o.nrow = static_cast<int32_t*>(nrow);
  o.ws = static_cast<int*>(ws);
  o.NP = NP;
  o.KO = KO;
  o.T = T;
  o.VC = VC;
  o.R = R;
  o.H = H;
  o.W = W;
  o.B = B;
  o.max_probe = max_probe;

  // the device's properties, queried once; the shared-memory attribute
  // raised only when a launch needs more than it was set to
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
  // the insert block's arrays (a row block keeps one plan per row of its
  // warps in the same space), or none past STAGE_B rows
  const size_t smem = B > STAGE_B ? 0 : (size_t)NARR * B * sizeof(int);
  const int t = B > STAGE_B ? 1 : 0;
  const void* fn = t ? (const void*)vio_observations_kernel<false>
                     : (const void*)vio_observations_kernel<true>;
  if ((int)smem > d.smem_set[t]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    d.smem_set[t] = (int)smem;
  }
  if (d.occ_smem[t] != (int)smem) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    d.per_sm[t] = per_sm;
    d.occ_smem[t] = (int)smem;
  }
  const int per_sm = d.per_sm[t];
  if ((long long)per_sm * d.sms < 2) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // a warp per row, as many row blocks as are co-resident, and the insert block
  const int want = (B + WARPS - 1) / WARPS + 1;
  const int grid = want < per_sm * d.sms ? want : per_sm * d.sms;
  *grid_out = grid;
  void* args[] = {&o};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid),
                                  dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
