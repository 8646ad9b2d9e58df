"""Fixed-capacity keyframe store + local map as NamedTuples of tensors.

The port of ``pislam_tpu/backend/keyframes.py``, field for field:

* keyframes: poses + per-keyframe feature block (codes/pts/desc/valid)
* landmarks: world positions + the descriptor of their anchor observation
* observations: a flat (keyframe slot, landmark slot, uv) table feeding
  windowed bundle adjustment

Every update is functional, as in the JAX package: a function returns new
tensors and leaves its inputs alone, so a ``SlamState`` held by the caller
(a snapshot, a checkpoint) never changes under it. Nothing here reads a
value back to the host. Dtypes follow the port's conventions: codes int64
(the u32 value), descriptor words int32 (the u32 bit pattern).

JAX's out-of-range scatters (``mode="drop"``) become writes into a buffer one
row longer whose extra row is sliced off (``set_drop``, ``add_drop``): the
dropped rows all aim at that extra row, and nothing reads it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT32_MAX = 2 ** 31 - 1


class KeyframeStore(NamedTuple):
    R: torch.Tensor            # (F, 3, 3) float32 world->cam
    t: torch.Tensor            # (F, 3)
    codes: torch.Tensor        # (F, K) int64 packed keypoint codes
    kp_valid: torch.Tensor     # (F, K) bool
    descriptors: torch.Tensor  # (F, K, words) int32
    pts: torch.Tensor          # (F, K, 2) float32 normalised keypoint coords
    frame_id: torch.Tensor     # (F,) int32 source frame index (-1 = empty)
    ordinal: torch.Tensor      # (F,) int32 insertion ordinal (-1 = empty)
    valid: torch.Tensor        # (F,) bool

    @property
    def capacity(self):
        return self.R.shape[0]


class LandmarkMap(NamedTuple):
    xyz: torch.Tensor          # (L, 3) world positions
    descriptors: torch.Tensor  # (L, words) int32 anchor descriptors
    obs_count: torch.Tensor    # (L,) int32
    valid: torch.Tensor        # (L,) bool

    @property
    def capacity(self):
        return self.xyz.shape[0]


class ObservationTable(NamedTuple):
    """Flat keypoint-observation table: which keyframe saw which landmark
    where (normalised coords). Fixed capacity O with a validity mask."""
    kf: torch.Tensor           # (O,) int32 keyframe SLOT
    lm: torch.Tensor           # (O,) int32 landmark SLOT
    uv: torch.Tensor           # (O, 2) float32
    valid: torch.Tensor        # (O,) bool

    @property
    def capacity(self):
        return self.kf.shape[0]


def set_drop(x, idx, src):
    """``x.at[idx].set(src, mode="drop")``: rows of ``idx`` at or past
    ``len(x)`` are dropped. ``src`` broadcasts to (len(idx),) + x.shape[1:];
    the kept indices must be distinct."""
    n = x.shape[0]
    buf = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    idx = torch.clamp(idx.long(), max=n)
    src = _like(x, src)
    return buf.index_copy(0, idx, src.expand((idx.shape[0],) + x.shape[1:]))[:n]


def add_drop(x, idx, src):
    """``x.at[idx].add(src, mode="drop")``: duplicates sum, rows of ``idx``
    at or past ``len(x)`` are dropped."""
    n = x.shape[0]
    buf = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    idx = torch.clamp(idx.long(), max=n)
    src = _like(x, src)
    return buf.index_add(0, idx, src.expand((idx.shape[0],) + x.shape[1:]))[:n]


def _like(x, src):
    """``src`` as a tensor of ``x``'s dtype on its device. A Python number
    becomes a fill: copying it from the host would wait on the card."""
    if isinstance(src, (bool, int, float)):
        return torch.full((), src, dtype=x.dtype, device=x.device)
    return torch.as_tensor(src, dtype=x.dtype, device=x.device)


def _rows(slot, device):
    """A slot (int or 0-dim tensor) as a (1,) int64 index: indexing by a
    0-dim CUDA tensor would read it back to the host."""
    if torch.is_tensor(slot):
        return slot.to(device).reshape(1).long()
    return torch.full((1,), int(slot), dtype=torch.int64, device=device)


def row(x, slot):
    """``x[slot]`` for an int or a 0-dim tensor slot, which is not read back."""
    return x.index_select(0, _rows(slot, x.device))[0] if torch.is_tensor(slot) else x[slot]


def empty_store(capacity: int, max_kp: int, words: int = 8, device="cuda") -> KeyframeStore:
    return KeyframeStore(
        R=torch.eye(3, device=device).expand(capacity, 3, 3).contiguous(),
        t=torch.zeros((capacity, 3), device=device),
        codes=torch.zeros((capacity, max_kp), dtype=torch.int64, device=device),
        kp_valid=torch.zeros((capacity, max_kp), dtype=torch.bool, device=device),
        descriptors=torch.zeros((capacity, max_kp, words), dtype=torch.int32, device=device),
        pts=torch.zeros((capacity, max_kp, 2), device=device),
        frame_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        ordinal=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def empty_map(capacity: int, words: int = 8, device="cuda") -> LandmarkMap:
    return LandmarkMap(
        xyz=torch.zeros((capacity, 3), device=device),
        descriptors=torch.zeros((capacity, words), dtype=torch.int32, device=device),
        obs_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def empty_obs(capacity: int, device="cuda") -> ObservationTable:
    return ObservationTable(
        kf=torch.zeros((capacity,), dtype=torch.int32, device=device),
        lm=torch.zeros((capacity,), dtype=torch.int32, device=device),
        uv=torch.zeros((capacity, 2), device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def insert_keyframe(store: KeyframeStore, slot, R, t, feats, frame_id,
                    pts=None, ordinal=None):
    """Functional slot write (``slot`` an int or a 0-dim tensor). feats:
    frontend.Features.

    ``pts`` (K, 2) are the normalised keypoint coordinates (zeros if
    omitted); ``ordinal`` is the insertion ordinal (defaults to frame_id so
    pure-store users keep a valid ordering)."""
    if pts is None:
        pts = torch.zeros_like(store.pts[0])
    if ordinal is None:
        ordinal = frame_id
    i = _rows(slot, store.R.device)

    def put(x, v):
        v = _like(x, v)
        return x.index_copy(0, i, v.reshape((1,) + x.shape[1:]))

    return KeyframeStore(
        R=put(store.R, R), t=put(store.t, t), codes=put(store.codes, feats.codes),
        kp_valid=put(store.kp_valid, feats.valid),
        descriptors=put(store.descriptors, feats.descriptors),
        pts=put(store.pts, pts), frame_id=put(store.frame_id, frame_id),
        ordinal=put(store.ordinal, ordinal), valid=put(store.valid, True),
    )


def next_slot(store: KeyframeStore):
    """First free slot, else the oldest frame (ring eviction)."""
    free = torch.argmin(store.valid.to(torch.int8))      # first False if any
    any_free = ~torch.all(store.valid)
    oldest = torch.argmin(torch.where(store.valid, store.frame_id, INT32_MAX))
    return torch.where(any_free, free, oldest)


def add_landmarks(lmap: LandmarkMap, obs: ObservationTable, lm_cursor, obs_cursor,
                  xyz, desc, mask, slot_a, slot_b, uv_a, uv_b):
    """Append up to K landmarks (two observations each) functionally.

    xyz (K, 3) world points, desc (K, words) anchor descriptors, mask (K,)
    selects real entries; slot_a/slot_b are the two observing keyframe slots
    with normalised coords uv_a/uv_b (K, 2). Entries past capacity are
    dropped; the returned cursors saturate at capacity. Dropping newest (not
    ring-evicting) keeps every live observation row consistent.
    """
    L = lmap.capacity
    O = obs.capacity
    pos = lm_cursor + torch.cumsum(mask, 0, dtype=torch.int32) - 1
    placed = mask & (pos < L)
    lm_slot = torch.where(placed, pos, L)             # L = out of range -> drop
    new_map = LandmarkMap(
        xyz=set_drop(lmap.xyz, lm_slot, xyz),
        descriptors=set_drop(lmap.descriptors, lm_slot, desc),
        obs_count=set_drop(lmap.obs_count, lm_slot, 2),
        valid=set_drop(lmap.valid, lm_slot, True),
    )
    # two observation rows per placed landmark, interleaved [a0, b0, a1, ...]
    opos = obs_cursor + 2 * (pos - lm_cursor)
    oa = torch.where(placed & (opos < O), opos, O)
    ob = torch.where(placed & (opos + 1 < O), opos + 1, O)
    new_obs = ObservationTable(
        kf=set_drop(set_drop(obs.kf, oa, slot_a), ob, slot_b),
        lm=set_drop(set_drop(obs.lm, oa, lm_slot), ob, lm_slot),
        uv=set_drop(set_drop(obs.uv, oa, uv_a), ob, uv_b),
        valid=set_drop(set_drop(obs.valid, oa, True), ob, True),
    )
    n_placed = placed.sum(dtype=torch.int32)
    new_lm_cursor = torch.clamp(lm_cursor + n_placed, max=L)
    new_obs_cursor = torch.clamp(obs_cursor + 2 * n_placed, max=O)
    return new_map, new_obs, new_lm_cursor, new_obs_cursor


def add_observations(lmap: LandmarkMap, obs: ObservationTable, obs_cursor,
                     kf_slot, lm_slot, uv, mask):
    """Append observation rows of EXISTING landmarks (data association).

    lm_slot (K,) landmark slots, uv (K, 2) normalised coords seen from
    keyframe ``kf_slot``, mask (K,) selects real rows. Increments the
    landmarks' obs_count. Rows past capacity are dropped (cursor saturates).
    """
    O = obs.capacity
    pos = obs_cursor + torch.cumsum(mask, 0, dtype=torch.int32) - 1
    placed = mask & (pos < O)
    row = torch.where(placed, pos, O)
    new_obs = ObservationTable(
        kf=set_drop(obs.kf, row, kf_slot),
        lm=set_drop(obs.lm, row, lm_slot),
        uv=set_drop(obs.uv, row, uv),
        valid=set_drop(obs.valid, row, True),
    )
    counted = torch.where(placed, lm_slot, lmap.capacity)
    new_map = lmap._replace(obs_count=add_drop(lmap.obs_count, counted, 1))
    n_placed = placed.sum(dtype=torch.int32)
    return new_map, new_obs, torch.clamp(obs_cursor + n_placed, max=O)


def cull_landmarks(store: KeyframeStore, lmap: LandmarkMap, obs: ObservationTable,
                   max_residual: float, min_obs: int = 2, bad_fraction: float = 0.5):
    """Invalidate unreliable landmarks + their observation rows.

    A landmark is culled when the majority of its observations reproject
    badly against the CURRENT keyframe poses, or when fewer than ``min_obs``
    observations support it. Residuals are normalised-coordinate distances;
    behind-camera projections count as bad. Returns (lmap, obs).
    """
    kf, lm = obs.kf.long(), obs.lm.long()
    Rk = store.R[kf]                              # (O, 3, 3)
    X = lmap.xyz[lm]                              # (O, 3)
    xc = torch.einsum("oij,oj->oi", Rk, X) + store.t[kf]
    z = xc[:, 2]
    proj = xc[:, :2] / torch.where(z == 0, 1.0, z)[:, None]
    err = torch.linalg.vector_norm(proj - obs.uv, dim=1)
    row_bad = obs.valid & ((err > max_residual) | (z <= 1e-6))

    L = lmap.capacity
    seg = torch.where(obs.valid, obs.lm, L)       # invalid rows -> dropped
    zeros = torch.zeros(L, dtype=torch.int32, device=lm.device)
    n_bad = add_drop(zeros, seg, row_bad.to(torch.int32))
    n_tot = add_drop(zeros, seg, obs.valid.to(torch.int32))
    bar = torch.tensor(bad_fraction, dtype=torch.float32, device=lm.device)
    cull = lmap.valid & ((n_bad.to(torch.float32) > bar * n_tot.to(torch.float32))
                         | (n_tot < min_obs))
    new_map = lmap._replace(valid=lmap.valid & ~cull,
                            obs_count=torch.where(cull, 0, n_tot))
    new_obs = obs._replace(valid=obs.valid & ~cull[lm])
    return new_map, new_obs


def drop_observations_behind(store: KeyframeStore, lmap: LandmarkMap, obs: ObservationTable):
    """Invalidate the observation rows of valid keyframes and landmarks whose
    landmark lies at depth <= 1e-6 in the keyframe at the CURRENT poses.
    Such a row measures nothing: its projection divides by the depth that BA
    clamps to 1e-6. Returns (obs, the number of rows dropped)."""
    kf, lm = obs.kf.long(), obs.lm.long()
    z = torch.einsum("oj,oj->o", store.R[kf][:, 2], lmap.xyz[lm]) + store.t[kf][:, 2]
    behind = obs.valid & store.valid[kf] & lmap.valid[lm] & (z <= 1e-6)
    return obs._replace(valid=obs.valid & ~behind), behind.sum()


def covisibility(store: KeyframeStore, lmap: LandmarkMap, obs: ObservationTable):
    """(F, F) int32 covisibility weights: shared-landmark counts between
    keyframe slots, from a dense (F, L) incidence matrix and one product
    (float32 is exact for counts below 2^24). The diagonal and the rows and
    columns of invalid keyframes are zero."""
    F, L = store.capacity, lmap.capacity
    kf, lm = obs.kf.long(), obs.lm.long()
    ok = obs.valid & store.valid[kf] & lmap.valid[lm]
    inc = torch.zeros(F * L, device=lm.device).scatter_reduce(
        0, kf * L + lm, ok.to(torch.float32), "amax").reshape(F, L)
    w = torch.round(inc @ inc.T).to(torch.int32)
    return w * (1 - torch.eye(F, dtype=torch.int32, device=lm.device))


def keyframe_redundancy(store: KeyframeStore, lmap: LandmarkMap, obs: ObservationTable,
                        min_other_obs: int = 3):
    """Per-slot redundancy: fraction of a keyframe's observed landmarks that
    are also observed by >= ``min_other_obs`` OTHER keyframes. Returns
    (frac (F,) float32, n_seen (F,) int32)."""
    F, L = store.capacity, lmap.capacity
    kf, lm = obs.kf.long(), obs.lm.long()
    ok = obs.valid & store.valid[kf] & lmap.valid[lm]
    n_tot = add_drop(torch.zeros(L, dtype=torch.int32, device=lm.device),
                     torch.where(ok, lm, L), 1)
    well = ok & (n_tot[torch.clamp(lm, 0, L - 1)] >= min_other_obs + 1)
    kfseg = torch.where(ok, kf, F)
    zeros = torch.zeros(F, dtype=torch.int32, device=lm.device)
    n_seen = add_drop(zeros, kfseg, 1)
    n_red = add_drop(zeros, kfseg, well.to(torch.int32))
    frac = n_red.to(torch.float32) / torch.clamp(n_seen, min=1)
    return frac, n_seen


def cull_one_keyframe(store: KeyframeStore, lmap: LandmarkMap, obs: ObservationTable,
                      eligible, min_other_obs: int = 3, redundant_fraction: float = 0.9):
    """Cull the single most redundant eligible keyframe.

    ORB-SLAM's keyframe-culling rule: a keyframe whose landmarks are almost
    all (>= ``redundant_fraction``) seen by >= ``min_other_obs`` other
    keyframes adds nothing to the map. One keyframe per call; the host loop
    iterates. ``eligible`` (F,) bool masks the slots the caller protects. The
    culled slot keeps its ordinal but turns invalid; its observation rows are
    invalidated and the landmarks' obs_count decremented. Returns (store,
    lmap, obs, slot) with slot == -1 (a 0-dim int32 tensor) when nothing was
    culled.
    """
    frac, n_seen = keyframe_redundancy(store, lmap, obs, min_other_obs)
    bar = torch.tensor(redundant_fraction, dtype=torch.float32, device=frac.device)
    cand = store.valid & eligible & (n_seen > 0) & (frac >= bar)
    slot = torch.argmax(torch.where(cand, frac, -1.0))
    found = torch.any(cand)
    slot_or = torch.where(found, slot, store.capacity)   # capacity = no-op
    rows = obs.valid & (obs.kf == slot_or)
    dec = torch.where(rows, obs.lm, lmap.capacity)
    lmap2 = lmap._replace(obs_count=add_drop(lmap.obs_count, dec, -1))
    obs2 = obs._replace(valid=obs.valid & ~rows)
    store2 = store._replace(valid=set_drop(store.valid, slot_or.reshape(1), False))
    return store2, lmap2, obs2, torch.where(found, slot, -1).to(torch.int32)


def evict_stale_landmarks(store: KeyframeStore, lmap: LandmarkMap, obs: ObservationTable,
                          need):
    """Invalidate the ``need`` landmarks with the OLDEST last observation:
    staleness = the highest insertion ordinal among a landmark's observing
    keyframes. need <= 0 is a no-op; follow with ``compact_map`` to reclaim
    the rows for the cursors. Returns (lmap, obs, n_dropped)."""
    L = lmap.capacity
    rows = obs.valid
    dev = rows.device
    seen = torch.where(rows, store.ordinal[obs.kf.long()], -1)
    last = torch.full((L + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.where(rows, obs.lm, L).long(), seen, "amax")[:L]
    # oldest-first rank among VALID landmarks (invalid sort last)
    key = torch.where(lmap.valid, last, INT32_MAX)
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(L, device=dev))
    drop = lmap.valid & (rank < torch.clamp(torch.as_tensor(need, device=dev), min=0))
    lmap2 = lmap._replace(valid=lmap.valid & ~drop)
    obs2 = obs._replace(valid=obs.valid & ~drop[obs.lm.long()])
    return lmap2, obs2, drop.sum(dtype=torch.int32)


def compact_map(lmap: LandmarkMap, obs: ObservationTable):
    """Re-pack live landmarks and observation rows to the front.

    A stable sort moves valid rows to the front preserving order,
    observation landmark indices are remapped through the permutation, and
    the returned (n_lm, n_obs) are the new cursors.
    """
    L = lmap.capacity
    dev = lmap.valid.device
    order = torch.argsort((~lmap.valid).to(torch.uint8), stable=True)
    new_pos = torch.empty_like(order).scatter_(0, order, torch.arange(L, device=dev))
    lmap2 = LandmarkMap(xyz=lmap.xyz[order], descriptors=lmap.descriptors[order],
                        obs_count=lmap.obs_count[order], valid=lmap.valid[order])
    oorder = torch.argsort((~obs.valid).to(torch.uint8), stable=True)
    obs2 = ObservationTable(
        kf=obs.kf[oorder],
        lm=new_pos[obs.lm.long()][oorder].to(torch.int32),
        uv=obs.uv[oorder],
        valid=obs.valid[oorder],
    )
    return lmap2, obs2, lmap.valid.sum(dtype=torch.int32), obs.valid.sum(dtype=torch.int32)
