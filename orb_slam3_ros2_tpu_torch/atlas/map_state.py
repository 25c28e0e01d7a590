"""Fixed-capacity map state (keyframes + landmarks + associations).

Port of `orb_slam3_ros2_tpu/atlas/map_state.py`: the map is a NamedTuple
of fixed-capacity tensors with validity masks, and each mutation returns a
new state (the tensors it changes are copies), as in the JAX package.
Packed descriptors are int32 tensors holding the uint32 words. `from_numpy`
carries a JAX `MapState` across (its fields through `np.asarray`) and
`to_numpy` carries a port map back.

Keyframe ids may be 0-dim device tensors: rows are read and written with
`index_select` / `index_copy_`, never by converting an id to a Python int,
so a keyframe insertion makes no device-to-host transfer. Scatters follow
JAX's `mode="drop"` with an out-of-range sentinel index. Where two writes
can land on one slot with different values, the winner is chosen
explicitly (documented at each site): `index_put_` on CUDA makes no promise
which of two duplicate writes wins.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_kf: int = 64  # keyframe capacity
    max_lm: int = 4096  # landmark capacity
    n_feat: int = 1024  # per-keyframe feature capacity (extractor output size)


class MapState(NamedTuple):
    # keyframes
    kf_R: torch.Tensor  # (K, 3, 3) T_cw
    kf_t: torch.Tensor  # (K, 3)
    kf_valid: torch.Tensor  # (K,) bool
    kf_time: torch.Tensor  # (K,) f32 seconds
    # per-keyframe features
    kf_uv: torch.Tensor  # (K, N, 2) undistorted pixels
    kf_level: torch.Tensor  # (K, N) int32
    kf_bits: torch.Tensor  # (K, N, 8) int32 packed descriptors
    kf_feat_valid: torch.Tensor  # (K, N) bool
    kf_obs_lm: torch.Tensor  # (K, N) int32 landmark id or -1
    # landmarks
    lm_X: torch.Tensor  # (L, 3) world positions
    lm_valid: torch.Tensor  # (L,) bool
    lm_bits: torch.Tensor  # (L, 8) int32 representative descriptor
    lm_ref_kf: torch.Tensor  # (L,) int32 creating keyframe
    lm_n_obs: torch.Tensor  # (L,) int32 observation count
    lm_found: torch.Tensor  # (L,) int32 times matched in tracking
    lm_visible: torch.Tensor  # (L,) int32 times predicted visible
    # counters
    n_kf: torch.Tensor  # () int32
    n_lm: torch.Tensor  # () int32


def empty_map(cfg: MapConfig, device="cpu") -> MapState:
    K, L, N = cfg.max_kf, cfg.max_lm, cfg.n_feat
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MapState(
        kf_R=torch.eye(3, dtype=f32, device=device).repeat(K, 1, 1),
        kf_t=z((K, 3)),
        kf_valid=z((K,), torch.bool),
        kf_time=z((K,)),
        kf_uv=z((K, N, 2)),
        kf_level=z((K, N), i32),
        kf_bits=z((K, N, 8), i32),
        kf_feat_valid=z((K, N), torch.bool),
        kf_obs_lm=torch.full((K, N), -1, dtype=i32, device=device),
        lm_X=z((L, 3)),
        lm_valid=z((L,), torch.bool),
        lm_bits=z((L, 8), i32),
        lm_ref_kf=z((L,), i32),
        lm_n_obs=z((L,), i32),
        lm_found=torch.ones((L,), dtype=i32, device=device),
        lm_visible=torch.ones((L,), dtype=i32, device=device),
        n_kf=z((), i32),
        n_lm=z((), i32),
    )


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> MapState:
    """MapState from a mapping of field name -> array (e.g. a JAX MapState's
    `_asdict()`); uint32 descriptor words are reinterpreted as int32."""
    return MapState(**{k: _to_tensor(fields[k], device)
                       for k in MapState._fields})


_BITS_FIELDS = ("kf_bits", "lm_bits")


def to_numpy(m: MapState) -> dict:
    """Field name -> numpy array in the JAX package's dtypes (descriptor
    words as uint32), so that `MapState(**{k: jnp.asarray(v)})` rebuilds
    the map on the JAX side."""
    out = {}
    for k in MapState._fields:
        a = getattr(m, k).detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in _BITS_FIELDS else a
    return out


def row(arr: torch.Tensor, k) -> torch.Tensor:
    """arr[k] for an id that may be a 0-dim device tensor (no host sync)."""
    k = torch.as_tensor(k, device=arr.device).reshape(1).long()
    return arr.index_select(0, k)[0]


def put_row(arr: torch.Tensor, k, val) -> torch.Tensor:
    """A copy of arr with arr[k] = val (k as in `row`)."""
    k = torch.as_tensor(k, device=arr.device).reshape(1).long()
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    return arr.clone().index_copy_(0, k, val.expand(arr.shape[1:])[None])


def insert_keyframe(m: MapState, R, t, time, uv, level, bits, feat_valid,
                    obs_lm) -> MapState:
    """Append a keyframe at slot n_kf (no-op if capacity is full).

    obs_lm: (N,) landmark id matched to each feature (-1 = none); the
    observation counters of the landmarks present are incremented."""
    K = m.kf_valid.shape[0]
    k = m.n_kf.long()
    ok = k < K
    k_safe = torch.clamp(k, max=K - 1)

    has = (obs_lm >= 0) & feat_valid & ok
    obs_inc = torch.zeros_like(m.lm_n_obs).index_add_(
        0, torch.where(obs_lm >= 0, obs_lm, 0).long(), has.to(torch.int32))

    def put(arr, val):
        val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
        return put_row(arr, k_safe, torch.where(ok, val, row(arr, k_safe)))

    return m._replace(
        kf_R=put(m.kf_R, R),
        kf_t=put(m.kf_t, t),
        kf_valid=put(m.kf_valid, row(m.kf_valid, k_safe) | ok),
        kf_time=put(m.kf_time, time),
        kf_uv=put(m.kf_uv, uv),
        kf_level=put(m.kf_level, level),
        kf_bits=put(m.kf_bits, bits),
        kf_feat_valid=put(m.kf_feat_valid, feat_valid),
        kf_obs_lm=put(m.kf_obs_lm, obs_lm),
        lm_n_obs=m.lm_n_obs + obs_inc,
        n_kf=m.n_kf + ok.to(torch.int32),
    )


def _scatter_drop(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """arr with arr[idx] = val, where idx == len(arr) drops the write (the
    JAX `.at[].set(mode="drop")` with a sentinel index). Only for writes
    whose kept indices are distinct, or whose duplicates carry one value."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]], dim=0)
    ext[idx.long()] = val if torch.is_tensor(val) else torch.as_tensor(
        val, dtype=arr.dtype, device=arr.device)
    return ext[:n]


def scatter_last(arr: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """arr with arr[idx[i]] = val[i], sentinel idx == len(arr) dropped, and
    the LAST i winning among duplicate indices: the order in which XLA's
    CPU scatter applies updates, made explicit so that every device agrees."""
    n = arr.shape[0]
    pos = torch.arange(idx.shape[0], device=arr.device)
    win = torch.full((n + 1,), -1, dtype=torch.long, device=arr.device)
    win.scatter_reduce_(0, idx.long(), pos, reduce="amax")
    win = win[:n]
    picked = val[win.clamp(min=0)].to(arr.dtype)
    hit = (win >= 0).reshape((n,) + (1,) * (arr.dim() - 1))
    return torch.where(hit, picked, arr)


def add_landmarks(m: MapState, X, bits, accept, ref_kf, kf_a, feat_a, kf_b,
                  feat_b) -> MapState:
    """Append accepted candidates; wire observations in both keyframes.

    The accepted slots are distinct (a cumsum), and so are the accepted
    features of each keyframe (the matches are mutual), so no two kept
    writes compete."""
    L = m.lm_valid.shape[0]
    K, N = m.kf_obs_lm.shape
    dev = m.lm_X.device
    order = torch.cumsum(accept.to(torch.int32), dim=0) - 1
    slots = m.n_lm + order
    ok = accept & (slots < L)
    # rejected candidates share slot numbers with accepted ones; route them
    # to the dropped sentinel slot
    slots_w = torch.where(ok, slots, L)
    ref = torch.as_tensor(ref_kf, dtype=torch.int32, device=dev)

    lm_X = _scatter_drop(m.lm_X, slots_w, X.to(torch.float32))
    lm_valid = _scatter_drop(m.lm_valid, slots_w, True)
    lm_bits = _scatter_drop(m.lm_bits, slots_w, bits)
    lm_ref = _scatter_drop(m.lm_ref_kf, slots_w, ref)
    lm_n_obs = _scatter_drop(m.lm_n_obs, slots_w, 2)

    ids = torch.where(ok, slots, -1).to(torch.int32)
    obs = m.kf_obs_lm.reshape(-1)
    for kf, feat in ((kf_a, feat_a), (kf_b, feat_b)):
        kf = torch.as_tensor(kf, device=dev).long()
        obs = _scatter_drop(obs, torch.where(ok, kf * N + feat.long(), K * N),
                            ids)
    return m._replace(
        lm_X=lm_X, lm_valid=lm_valid, lm_bits=lm_bits, lm_ref_kf=lm_ref,
        lm_n_obs=lm_n_obs, kf_obs_lm=obs.reshape(K, N),
        n_lm=m.n_lm + ok.sum().to(torch.int32),
    )


def _observed(m: MapState) -> torch.Tensor:
    """(K, N) True where a valid feature of a valid keyframe has a landmark."""
    return (m.kf_obs_lm >= 0) & m.kf_feat_valid & m.kf_valid[:, None]


def recount_observations(m: MapState) -> MapState:
    """Recompute lm_n_obs exactly from the association table."""
    L = m.lm_valid.shape[0]
    obs_safe = torch.where(_observed(m), m.kf_obs_lm, L).reshape(-1).long()
    n_obs = torch.zeros((L + 1,), dtype=torch.int32,
                        device=obs_safe.device).index_add_(
        0, obs_safe, torch.ones_like(obs_safe, dtype=torch.int32))[:L]
    return m._replace(lm_n_obs=n_obs)


def _first_feature(obs_safe: torch.Tensor, L: int) -> torch.Tensor:
    """(rows, N): for each entry, the lowest feature index of its row that
    points at the same slot (`obs_safe` in [0, L])."""
    K, N = obs_safe.shape
    feat = torch.arange(N, device=obs_safe.device).expand(K, N)
    winner = torch.full((K, L + 1), N, dtype=torch.long,
                        device=obs_safe.device)
    winner.scatter_reduce_(1, obs_safe, feat, reduce="amin")
    return torch.gather(winner, 1, obs_safe)


def dedupe_observations(m: MapState) -> MapState:
    """One observation per (keyframe, landmark): where several features of a
    keyframe point at the same landmark, keep the lowest feature index and
    null the rest; then recount."""
    N = m.kf_obs_lm.shape[1]
    L = m.lm_valid.shape[0]
    has = _observed(m)
    obs_safe = torch.where(has, m.kf_obs_lm, L).long()
    feat = torch.arange(N, device=has.device)[None, :]
    keep = has & (_first_feature(obs_safe, L) == feat)
    obs = torch.where(keep, m.kf_obs_lm, -1)
    return recount_observations(m._replace(kf_obs_lm=obs))


def _stable_front(keep: torch.Tensor):
    """(perm, n_keep, new_valid, remap): kept slots first in their order
    (a stable sort, as `jnp.argsort(~keep, stable=True)`), and remap old
    slot -> new slot (-1 dropped)."""
    n = keep.shape[0]
    dev = keep.device
    perm = torch.sort((~keep).to(torch.int8), stable=True).indices
    n_keep = keep.sum().to(torch.int32)
    new_valid = torch.arange(n, device=dev) < n_keep
    remap = torch.full((n,), -1, dtype=torch.int32, device=dev)
    remap[perm] = torch.where(new_valid,
                              torch.arange(n, dtype=torch.int32, device=dev),
                              -1)
    return perm, n_keep, new_valid, remap


def compact_landmarks(m: MapState):
    """Move valid landmarks to the front, in order, and rewrite every
    association through the remap. Returns (m2, remap (L,) old -> new, -1
    dropped)."""
    perm, n_keep, new_valid, remap = _stable_front(m.lm_valid)
    obs = m.kf_obs_lm
    obs_new = torch.where(
        obs >= 0, remap[torch.where(obs >= 0, obs, 0).long()], -1)
    one = torch.ones_like(m.lm_found)
    m2 = m._replace(
        lm_X=m.lm_X[perm],
        lm_valid=new_valid,
        lm_bits=m.lm_bits[perm],
        lm_ref_kf=m.lm_ref_kf[perm],
        lm_n_obs=torch.where(new_valid, m.lm_n_obs[perm], 0),
        lm_found=torch.where(new_valid, m.lm_found[perm], one),
        lm_visible=torch.where(new_valid, m.lm_visible[perm], one),
        kf_obs_lm=obs_new,
        n_lm=n_keep,
    )
    return m2, remap


def compact_keyframes(m: MapState, keep: torch.Tensor):
    """Drop keyframes where `keep` is False and compact the survivors to the
    front; landmark observation counts are recomputed, landmarks are not
    invalidated. Returns (m2, remap (K,) old -> new, -1 dropped)."""
    K = m.kf_valid.shape[0]
    perm, n_keep, new_valid, remap = _stable_front(keep & m.kf_valid)
    ref_new = remap[m.lm_ref_kf.clamp(0, K - 1).long()]
    m2 = m._replace(
        kf_R=m.kf_R[perm],
        kf_t=m.kf_t[perm],
        kf_valid=new_valid,
        kf_time=torch.where(new_valid, m.kf_time[perm], 0.0),
        kf_uv=m.kf_uv[perm],
        kf_level=m.kf_level[perm],
        kf_bits=m.kf_bits[perm],
        kf_feat_valid=m.kf_feat_valid[perm] & new_valid[:, None],
        kf_obs_lm=torch.where(new_valid[:, None], m.kf_obs_lm[perm], -1),
        # a culled reference keyframe degrades to "oldest survivor" (id 0)
        lm_ref_kf=torch.where(ref_new >= 0, ref_new, 0),
        n_kf=n_keep,
    )
    return recount_observations(m2), remap


def keyframe_redundancy(m: MapState, min_obs: int = 4) -> torch.Tensor:
    """(K,) f32 fraction of each keyframe's associated valid landmarks that
    at least `min_obs` keyframes observe."""
    has = _observed(m)
    obs_safe = torch.where(has, m.kf_obs_lm, 0).long()
    lm_ok = m.lm_valid[obs_safe] & has
    covered = ((m.lm_n_obs[obs_safe] >= min_obs) & lm_ok).sum(dim=1)
    total = lm_ok.sum(dim=1)
    return covered.to(torch.float32) / total.to(torch.float32).clamp(min=1.0)


def observation_matrix(m: MapState) -> torch.Tensor:
    """Dense (K, L) 0/1 keyframe-observes-landmark indicator in float32 (the
    JAX default is bf16, for the TPU's matrix unit); 0/1 entries are exact
    in either, and duplicate writes all carry 1."""
    L = m.lm_valid.shape[0]
    obs_safe = torch.where(_observed(m), m.kf_obs_lm, L).long()
    O = torch.zeros((obs_safe.shape[0], L + 1), dtype=torch.float32,
                    device=obs_safe.device)
    O.scatter_(1, obs_safe, 1.0)
    return O[:, :L] * m.lm_valid[None, :].to(torch.float32)


def covisibility_matrix(m: MapState) -> torch.Tensor:
    """(K, K) int32 number of landmarks two keyframes share (zero diagonal):
    O @ O.T over the observation indicator, exact in f32 (TF32 is off)."""
    O = observation_matrix(m)
    C = O @ O.T
    K = C.shape[0]
    C = C * (1.0 - torch.eye(K, dtype=C.dtype, device=C.device))
    return C.to(torch.int32)


def observation_table(m: MapState, kf_ids: torch.Tensor):
    """Dense BA observation layout for a set of keyframes.

    kf_ids: (W,) (may repeat an id for padding). Returns (uv (W, L, 2),
    w (W, L) 0/1, kf_sel_valid (W,)) with L = landmark capacity. A keyframe
    holds at most one observation per landmark once `dedupe_observations`
    has run; should two features still share one, the lowest feature index
    is the one written."""
    L = m.lm_valid.shape[0]
    ids = kf_ids.long()
    uv_f = m.kf_uv[ids]
    obs = m.kf_obs_lm[ids]
    kf_sel_valid = m.kf_valid[ids]
    has = (obs >= 0) & m.kf_feat_valid[ids] & kf_sel_valid[:, None]
    # invalid features scatter into the dropped slot L — never slot 0
    obs_safe = torch.where(has, obs, L).long()
    W, N = obs.shape
    first = _first_feature(obs_safe, L) == torch.arange(N, device=ids.device)
    obs_safe = torch.where(first, obs_safe, L)
    uv_t = torch.zeros((W, L + 1, 2), dtype=torch.float32, device=ids.device)
    uv_t.scatter_(1, obs_safe[..., None].expand(W, N, 2), uv_f)
    w_t = torch.zeros((W, L + 1), dtype=torch.float32, device=ids.device)
    w_t.scatter_(1, obs_safe, 1.0)
    w_t = w_t[:, :L] * m.lm_valid[None, :].to(torch.float32)
    return uv_t[:, :L], w_t, kf_sel_valid
