"""Fixed-capacity map state (keyframes + landmarks + associations).

Port of `orb_slam3_ros2_tpu/atlas/map_state.py:30-170`: the map is a
NamedTuple of fixed-capacity tensors with validity masks, and each mutation
returns a new state (the tensors it changes are copies), as in the JAX
package. Packed descriptors are int32 tensors holding the uint32 words.
`from_numpy` carries a JAX `MapState` across (its fields through
`np.asarray`).
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
        out = arr.clone()
        out[k_safe] = torch.where(ok, val.to(arr.dtype), arr[k_safe])
        return out

    time = torch.as_tensor(time, dtype=torch.float32, device=m.kf_time.device)
    return m._replace(
        kf_R=put(m.kf_R, R),
        kf_t=put(m.kf_t, t),
        kf_valid=put(m.kf_valid, m.kf_valid[k_safe] | ok),
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
    JAX `.at[].set(mode="drop")` with a sentinel index)."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]], dim=0)
    ext[idx.long()] = val if torch.is_tensor(val) else torch.as_tensor(
        val, dtype=arr.dtype, device=arr.device)
    return ext[:n]


def add_landmarks(m: MapState, X, bits, accept, ref_kf, kf_a, feat_a, kf_b,
                  feat_b) -> MapState:
    """Append accepted candidates; wire observations in both keyframes."""
    L = m.lm_valid.shape[0]
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
    N = m.kf_obs_lm.shape[1]
    obs = m.kf_obs_lm.clone()
    for kf, feat in ((kf_a, feat_a), (kf_b, feat_b)):
        kf = int(kf)
        obs[kf] = _scatter_drop(obs[kf], torch.where(ok, feat, N), ids)
    return m._replace(
        lm_X=lm_X, lm_valid=lm_valid, lm_bits=lm_bits, lm_ref_kf=lm_ref,
        lm_n_obs=lm_n_obs, kf_obs_lm=obs,
        n_lm=m.n_lm + ok.sum().to(torch.int32),
    )
