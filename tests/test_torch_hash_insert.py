"""The hash map's insert without a sort: its heads pass and its probe
rounds over the heads, on the CPU.

On the card `voxel_map.insert` is two launches of csrc/hash_insert.cu:
hash_insert_keys picks each voxel's head (the least (d2c bits, row) of
its rows, through a scratch table and integer atomics) and writes the
heads compactly in row order; hash_insert_probe runs every round over
them, a contested slot kept by the head last in (k2, k1, k0) order, the
claim's read-back folded into the next round's reads (one grid barrier a
round). Here, on seeded numpy inputs:
  - `insert_heads_plain` (the keys kernel's oracle) against the heads the
    JAX package's jnp.lexsort((d2c, k0, k1, k2)) implies, every column;
  - `insert_heads_probe_plain` after it (the probe kernel's plain version)
    against `insert_plain` and the JAX package's insert, every array;
  - a numpy model of the two kernels' rules (the table's atomic minimum
    taken in a random order of the rows; each round's phase run over the
    heads in a random order, a holder's writes landing before or after
    the next round's reads of the same slot) against `insert_plain`, on
    several interleavings;
on batches with voxels near +-2^31, 31-bit check collisions, many voxels
contesting one slot that differ only in k0, only in k1 or only in k2,
rows at one distance from the centre, voxels whose rows are all invalid,
probe overflow and no row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flat_map_kernels import colliding_checks, extreme_points, hash_equal, surface
from torch_hash_cases import contested, ties_and_invalid

from fastlivo_tpu.ops import voxel_map as jvm
from fastlivo_tpu_torch.ops import voxel_map as tvm

VOX = 0.5
EMPTY = tvm.EMPTY_CHECK


def batches(case):
    """(T, [(pts, valid, max_probe), ...]) of a case, made from a seed."""
    rng = np.random.default_rng(len(case))
    if case == "surface":
        return 1 << 12, [(*surface(rng, 2500), 12) for _ in range(3)]
    if case == "extreme":
        return 1 << 12, [(*extreme_points(rng), 12)]
    if case.startswith("contested"):
        axis = "k0 k1 k2".split().index(case[-2:])
        p, v = contested(axis)
        return 64, [(p, v, 12), (np.ascontiguousarray(p[::-1] + 0.01), v[::-1].copy(), 12)]
    if case == "collision":
        steps = []
        for a, b in colliding_checks():
            p = (np.stack([a, b]).astype(np.float32) + 0.3) * VOX
            steps += [(p, np.ones(2, bool), 12),
                      (np.ascontiguousarray(p[::-1] + 0.05), np.ones(2, bool), 12)]
        return 64, steps
    if case == "ties":
        p, v = ties_and_invalid()
        return 1 << 10, [(p, v, 12), (p[::-1].copy(), v[::-1].copy(), 12)]
    if case == "overflow":
        k = np.stack(np.meshgrid(*[np.arange(-4, 4)] * 3, indexing="ij"), -1).reshape(-1, 3)
        p = ((rng.permutation(k)[:40] + rng.uniform(0.1, 0.9, (40, 3))) * VOX).astype(
            np.float32)
        return 16, [(p[:20], np.ones(20, bool), 12), (p[20:], np.ones(20, bool), 3),
                    (p[:0], np.ones(0, bool), 12)]
    raise ValueError(case)


CASES = ["surface", "extreme", "contested_k0", "contested_k1", "contested_k2", "collision",
         "ties", "overflow"]


def jax_heads(p, v):
    """The heads jnp.lexsort((d2c, k0, k1, k2)) implies: the rows that lead
    their voxel's run in sorted order and are valid, in row order."""
    vs = jnp.float32(VOX)
    keys = jvm.voxel_of(jnp.asarray(p), vs)
    centre = (keys.astype(jnp.float32) + 0.5) * vs
    d2c = jnp.where(jnp.asarray(v), jnp.sum((jnp.asarray(p) - centre) ** 2, axis=-1), jvm.BIG)
    order = np.array(jnp.lexsort((d2c, keys[:, 0], keys[:, 1], keys[:, 2])))
    ks = np.array(keys)[order]
    same = np.all(ks == np.roll(ks, 1, axis=0), axis=-1)
    if len(same):
        same[0] = False
    return np.sort(order[v[order] & ~same])


@pytest.mark.parametrize("case", CASES)
def test_heads_plain_are_the_lexsort_heads(case):
    """insert_heads_plain's heads are the rows jnp.lexsort's order makes
    heads, in row order, with their voxel, probe slot, check and distance
    bits as insert_keys_plain has them; zeros after the count."""
    T, steps = batches(case)
    m = tvm.empty_map(T, VOX, device="cpu")
    for p, v, _ in steps:
        heads, nh = tvm.insert_heads_plain(m, torch.from_numpy(p), torch.from_numpy(v))
        want = jax_heads(p, v)
        assert heads.dtype == torch.int32 and heads.shape == (7, len(p))
        assert int(nh) == len(want)
        np.testing.assert_array_equal(heads[0, :len(want)].numpy(), want)
        rows, _ = tvm.insert_keys_plain(m, torch.from_numpy(p), torch.from_numpy(v))
        np.testing.assert_array_equal(heads[1:, :len(want)].numpy(), rows[:, want].numpy())
        assert not heads[:, len(want):].any()
        if case == "ties":  # duplicate and mirrored rows: the lowest row heads
            assert len(want) < len(np.unique(rows[:3].numpy(), axis=1)[0])


@pytest.mark.parametrize("case", CASES)
def test_heads_probe_plain_is_insert_plain(case):
    """The heads, then the probe rounds over them in (k2, k1, k0) order,
    give insert_plain's table and count, and the JAX package's, over the
    case's inserts in turn."""
    T, steps = batches(case)
    mh = tvm.empty_map(T, VOX, device="cpu")
    mp = tvm.empty_map(T, VOX, device="cpu")
    mj = jvm.empty_map(T, VOX)
    for p, v, probe in steps:
        pt, vt = torch.from_numpy(p), torch.from_numpy(v)
        heads, nh = tvm.insert_heads_plain(mh, pt, vt)
        mh = mh._replace(count=tvm.insert_heads_probe_plain(mh, pt, heads, nh, probe))
        mp = tvm.insert_plain(mp, pt, vt, probe)
        if len(p):  # the JAX package's insert refuses B = 0: the table stands
            mj = jvm.insert(mj, jnp.asarray(p), jnp.asarray(v), probe)
        for a, b in zip(mh, mp):
            assert torch.equal(a, b)
        hash_equal(mh, mj)
    if case == "collision":  # both voxels of a pair won: the count runs ahead
        assert int(mh.count) > int((mh.check != EMPTY).sum())
    if case == "overflow":  # probes ran out: rows were dropped
        assert int(mh.count) < 40


def model_heads(p, v, rng):
    """The keys kernel's rule: each row, in a random order, takes the
    maximum of ~((bits << 32) | row) at its voxel's entry (the least
    (bits, row)); a valid row its entry names is a head. Returns the
    heads' rows in row order."""
    rows, _ = tvm.insert_keys_plain(tvm.empty_map(64, VOX, device="cpu"), torch.from_numpy(p),
                                    torch.from_numpy(v))
    rows = rows.numpy()
    best = {}
    for i in rng.permutation(len(p)):
        key = tuple(rows[:3, i])
        val = ~((int(np.uint32(rows[5, i])) << 32) | int(i)) & (2 ** 64 - 1)
        best[key] = max(best.get(key, 0), val)
    return np.array(sorted(i for i in range(len(p)) if v[i] and (
        ~best[tuple(rows[:3, i])] & 0xFFFFFFFF) == i), np.int64)


def model_probe(m, p, heads, max_probe, rng):
    """The probe kernel's rounds on the table m (numpy, in place): in each
    round's phase the heads run in a random order, each settling the last
    round (a holder writes at once, so a later head of the same phase sees
    its writes) and then playing this round against the slot as the last
    round left it (a slot with a last-round ticket: the holder's point,
    and its check where the slot still reads empty); the tickets keep the
    head last in (k2, k1, k0) order. Returns the count."""
    check, mpts = m.check.numpy(), m.pts.numpy()
    T = len(check)
    vs = np.float32(VOX)
    H = heads.shape[1]
    row, k, slot0, chk = heads[0], heads[1:4], heads[4], heads[5]
    d2c = heads[6].view(np.float32)
    key = lambda h: (k[2, h], k[1, h], k[0, h])  # noqa: E731
    sq3 = lambda e: (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]  # noqa: E731
    state = [0] * H  # 0 live, else "done", or the round's role
    tickets = [{}, {}]
    count = int(m.count)
    for r in range(max_probe + 1):
        live = 0
        for h in rng.permutation(H):
            st = state[h]
            if st == "done":
                continue
            if r > 0 and st == "mine":
                state[h] = "done"
                continue
            if r > 0 and st:
                s = (slot0[h] + r - 1) & (T - 1)
                holder = tickets[(r - 1) & 1][s][1]
                won = False
                if holder == h:
                    if st == "claim":
                        check[s] = chk[h]
                    mpts[s] = p[row[h]]
                    won = st == "claim"
                else:
                    won = st == "claim" and chk[holder] == chk[h]
                count += won
                if won or st == "write":
                    state[h] = "done"
                    continue
            if r == max_probe:
                state[h] = "done"
                continue
            s = (slot0[h] + r) & (T - 1)
            pend = tickets[(r - 1) & 1].get(s) if r > 0 else None
            pend = pend[1] if pend is not None and pend[0] == r else None
            cur = check[s]
            if pend is not None and cur == EMPTY:
                cur = chk[pend]
            role = 0
            if cur == EMPTY:
                role = "claim"
            elif cur == chk[h]:
                role = "mine"
                sp = p[row[pend]] if pend is not None else mpts[s]
                centre = (k[:, h].astype(np.float32) + np.float32(0.5)) * vs
                if d2c[h] < sq3((sp - centre).astype(np.float32)):
                    role = "write"
            if role in ("claim", "write"):
                t = tickets[r & 1].get(s)
                if t is None or t[0] != r + 1 or key(h) > key(t[1]):
                    tickets[r & 1][s] = (r + 1, h)
            state[h] = role
            live += 1
        if live == 0:
            break
    return count


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", CASES)
def test_kernel_rules_in_numpy_are_insert_plain(case, seed):
    """The two kernels' rules, run in numpy on random interleavings, give
    insert_plain's table and count: the heads equal insert_heads_plain's,
    and the one-barrier rounds equal the sorted rounds."""
    rng = np.random.default_rng(seed)
    T, steps = batches(case)
    mk = tvm.empty_map(T, VOX, device="cpu")
    mp = tvm.empty_map(T, VOX, device="cpu")
    for p, v, probe in steps:
        pt, vt = torch.from_numpy(p), torch.from_numpy(v)
        heads, nh = tvm.insert_heads_plain(mk, pt, vt)
        got = model_heads(p, v, rng)
        np.testing.assert_array_equal(got, heads[0, :int(nh)].numpy())
        hs = heads[:, :int(nh)].numpy()
        mk = mk._replace(count=torch.tensor(model_probe(mk, p, hs, probe, rng),
                                            dtype=torch.int32))
        mp = tvm.insert_plain(mp, pt, vt, probe)
        for f, a, b in zip(mk._fields, mk, mp):
            assert torch.equal(a, b), (case, f)
