"""Atlas: the active map, the frozen previous maps, and one BoW database
per map.

Port of `orb_slam3_ros2_tpu/atlas/atlas.py`, with the same `.npz` file:
`__version__`, `__n_maps__`, `__active__`, `__cfg__` ([max_kf, max_lm,
n_feat]), `map{i}_leaf{j}` in `MapState` field order (descriptor words as
uint32, through `map_state.to_numpy`) and `bow{i}_leaf{j}` in the order
vecs, valid, doc_freq, n. Each package loads the other's files.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.loop import vocab

FORMAT_VERSION = 1


class Atlas:
    """Active map + frozen previous maps (+ per-map BoW databases), all on
    `device`; the databases have `n_words` columns."""

    def __init__(self, cfg: ms.MapConfig, n_words: int = vocab.N_WORDS,
                 device="cpu"):
        self.cfg = cfg
        self.n_words = n_words
        self.device = torch.device(device)
        self.maps: List[ms.MapState] = [ms.empty_map(cfg, self.device)]
        self.bow_dbs: List[vocab.BowDatabase] = [self._empty_db()]
        self.active = 0

    def _empty_db(self) -> vocab.BowDatabase:
        return vocab.empty_database(self.cfg.max_kf, self.n_words,
                                    self.device)

    @property
    def current_map(self) -> ms.MapState:
        return self.maps[self.active]

    @current_map.setter
    def current_map(self, m: ms.MapState) -> None:
        self.maps[self.active] = m

    @property
    def current_bow(self) -> vocab.BowDatabase:
        return self.bow_dbs[self.active]

    @current_bow.setter
    def current_bow(self, db: vocab.BowDatabase) -> None:
        self.bow_dbs[self.active] = db

    def create_new_map(self) -> int:
        """Spawn a fresh active map (the tracking-loss path)."""
        self.maps.append(ms.empty_map(self.cfg, self.device))
        self.bow_dbs.append(self._empty_db())
        self.active = len(self.maps) - 1
        return self.active

    def reset_current(self) -> None:
        """Restart the active map in place (empty map and database)."""
        self.current_map = ms.empty_map(self.cfg, self.device)
        self.current_bow = self._empty_db()

    def n_maps(self) -> int:
        return len(self.maps)

    def total_landmarks(self) -> int:
        return int(sum(int(m.lm_valid.sum()) for m in self.maps))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        blob = {"__version__": np.asarray(FORMAT_VERSION),
                "__n_maps__": np.asarray(len(self.maps)),
                "__active__": np.asarray(self.active),
                "__cfg__": np.asarray([self.cfg.max_kf, self.cfg.max_lm,
                                       self.cfg.n_feat])}
        for mi, (m, db) in enumerate(zip(self.maps, self.bow_dbs)):
            fields = ms.to_numpy(m)
            for li, name in enumerate(ms.MapState._fields):
                blob[f"map{mi}_leaf{li}"] = fields[name]
            for li, leaf in enumerate(db):
                blob[f"bow{mi}_leaf{li}"] = leaf.detach().cpu().numpy()
        np.savez_compressed(path, **blob)

    @classmethod
    def load(cls, path: str, device="cpu") -> "Atlas":
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        version = int(data["__version__"])
        if version != FORMAT_VERSION:
            raise ValueError(f"atlas format {version} != {FORMAT_VERSION}")
        mk, ml, nf = (int(x) for x in data["__cfg__"])
        n_maps = int(data["__n_maps__"])
        n_words = int(data["bow0_leaf0"].shape[1])
        atlas = cls(ms.MapConfig(max_kf=mk, max_lm=ml, n_feat=nf), n_words,
                    device)
        atlas.maps, atlas.bow_dbs = [], []
        for mi in range(n_maps):
            atlas.maps.append(ms.from_numpy(
                {name: data[f"map{mi}_leaf{li}"]
                 for li, name in enumerate(ms.MapState._fields)}, device))
            atlas.bow_dbs.append(vocab.BowDatabase(*(
                torch.from_numpy(np.array(data[f"bow{mi}_leaf{li}"])).to(
                    device)
                for li in range(len(vocab.BowDatabase._fields)))))
        atlas.active = int(data["__active__"])
        return atlas
