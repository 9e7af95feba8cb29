"""Plain reference of the two-stage tgnet scan pipeline (Lim et al., the
ToothGroupNetwork two-stage inference): the served program's stated steps,
written out in plain torch and numpy from the ``.obj`` and the two ``.npz``
weight files alone.

  1. mesh prep (``mesh.py``) and exact FPS to ``n_sample`` points,
  2. fps model stage 1: half-arch classes and offsets,
  3. DBSCAN/PCA/MeanShift instancing of the offset-moved points (rounded
     through float16) -> crop centroids (``clustering.py``),
  4. stage 2 over the nearest-3072 crop of each centroid (16 slots at
     most), FG/BG logits summed onto the points crop by crop,
  5. refined instancing from that mask,
  6. the boundary cloud: each vertex's 40 nearest sampled points (exact
     selection by the expansion, re-scored by subtraction), label purity
     under 0.7 marks a boundary vertex, 20000 boundary vertices drawn by
     ``default_rng(0)``, the rest by exact FPS of the others,
  7. the bdl model's two stages on it, KMeans of its foreground,
  8. arch disambiguation and the boundary merge (``fusion.py``),
  9. each vertex takes the label of its nearest sampled or (strictly
     nearer) boundary point, then the FDI numbers.

The model stages also run on inputs handed in (``stage_outputs``), so that
what the program's models made of its own inputs can be judged apart from
the host stages that chose them.
"""

from __future__ import annotations

import numpy as np
import torch

from .clustering import clustering_points, get_clustering_labels
from .fusion import disambiguate_arch_labels, merge_boundary_clusters
from .mesh import prep_scan
from .ops import Precision, fps, nearest_rescored, smallest_k, square_distance
from .pointtransformer import Backbone, load_npz

K_MAX = 16
# normalised coordinates are O(1); a crop's mean of 3072 rows summed in
# another order moves its recentred rows by a few float32 ulps
CROP_ATOL = 1e-5


class TgnetReference:
    """``config``: the benchmark's ``tgnet`` configuration (arches, sizes,
    boundary sampling). ``device``: where the plain torch runs."""

    def __init__(self, config: dict, fps_npz: str, bdl_npz: str, device,
                 prec: Precision = Precision()):
        self.cfg, self.device, self.prec = config, torch.device(device), prec
        self.n_sample = config["n_sample"]
        self.crop = config["crop_sample_size"]
        self.bi = config["boundary_info"]
        self.models = {}
        mp = config["model_parameter"]
        fps_arch = {k: mp[k] for k in ("planes", "stride", "nsample", "blocks", "block_num")}
        for name, path, arch in (("fps", fps_npz, fps_arch),
                                 ("bdl", bdl_npz, config["bdl_arch"])):
            w = load_npz(path, self.device)
            self.models[name] = (Backbone(w, "first", arch, prec),
                                 Backbone(w, "second", arch, prec))

    def crops(self, feats: torch.Tensor, cents: np.ndarray):
        """Nearest-``crop`` crops ``[K, S, 6]`` (xyz recentred) around
        ``cents`` ``[K, 3]`` of ``feats`` ``[N, 6]``, and their rows."""
        c = torch.from_numpy(np.asarray(cents, np.float32).reshape(-1, 3)).to(self.device)
        d2 = square_distance(c[None], feats[None, :, :3].float())
        idx = smallest_k(d2, self.crop)[0][0]
        crop = feats[idx]
        xyz = crop[..., :3] - crop[..., :3].mean(dim=1, keepdim=True)
        return torch.cat([xyz, crop[..., 3:]], dim=-1), idx

    def stage2(self, model: str, crops: torch.Tensor) -> torch.Tensor:
        mask = torch.ones(crops.shape[:2], dtype=torch.bool, device=self.device)
        return self.models[model][1](crops, mask)["sem_1"]

    def votes(self, model: str, feats: torch.Tensor, cents, given):
        """The FG mask of the crops around the first 16 ``cents``, and the
        crops: each crop's stage 2 (the given ``crop_sem`` of a given crop
        that is this crop, else the model's own), its logits summed onto its
        points in crop order, argmax."""
        cents = list(cents)[:K_MAX]
        out = torch.zeros((feats.shape[0], 2), dtype=torch.float32, device=self.device)
        if not cents:
            return (torch.argmax(out, dim=1).to(torch.uint8).cpu().numpy(),
                    feats.new_zeros((0, self.crop, feats.shape[1])))
        crops, idx = self.crops(feats, np.stack(cents))
        # a crop's xyz is recentred on its mean, a float32 sum whose order
        # the two sides choose apart: rows match to CROP_ATOL
        same = same_crops(given["crops"] if given else None, crops)
        usable = given is not None and given["crops"].shape == crops.shape
        if bool(same.all()):
            sem = given["crop_sem"].float()
        else:
            sem = self.stage2(model, crops)
            if usable:
                sem = torch.where(same[:, None, None], given["crop_sem"].float(), sem)
        for c in range(len(cents)):
            out.index_add_(0, idx[c], sem[c])
        return torch.argmax(out, dim=1).to(torch.uint8).cpu().numpy(), crops

    def stage_outputs(self, model: str, feats: torch.Tensor,
                      crops: torch.Tensor | None) -> dict:
        """Stage 1 of ``feats`` ``[1, N, 6]`` and stage 2 of ``crops``
        ``[K, S, 6]`` (given, not chosen here)."""
        out = self.models[model][0](feats.float())
        res = {"sem_1": out["sem_1"], "offset_1": out["offset_1"]}
        if crops is not None and crops.shape[0]:
            res["crop_sem"] = self.stage2(model, crops.float())
        return res

    @torch.no_grad()
    def __call__(self, path: str, given: dict | None = None) -> dict:
        """One scan: ``{"sem", "ins"}`` per vertex, and what the stages
        hand on: the ``sample`` rows ``[n_sample, 6]``, the ``boundary``
        cloud's rows and each model's ``crops``. With ``given`` (each
        model's ``sem_1`` and ``offset_1``, valid ``crops`` and their
        ``crop_sem``, as a served scan made them) the host stages run on the
        given model outputs, and on the given crop outputs where the crops
        they choose are the given ones; the sample, the crops and the
        boundary cloud are the ones worked out here."""
        dev = self.device
        given = given or {}
        feats_np = prep_scan(path, self.n_sample)
        src = torch.from_numpy(feats_np).to(dev)
        sample = fps(src[None, :, :3], self.n_sample)[0]
        feats = src[sample]
        sampled = feats_np[sample.cpu().numpy()]

        out = given.get("fps") or self.models["fps"][0](feats[None])
        cls_1 = torch.argmax(out["sem_1"][0], dim=-1).cpu().numpy().astype(np.int32)
        moved = (feats[:, :3] + out["offset_1"][0]).to(torch.float16).float().cpu().numpy()
        fg_labels = get_clustering_labels(moved, cls_1)
        fg_moved = moved[cls_1 != 0]
        cents = [fg_moved[fg_labels == i].mean(axis=0) for i in np.unique(fg_labels)]
        whole_mask, crops_fps = self.votes("fps", feats, cents, given.get("fps"))
        ins_labels = np.full(len(sampled), -1.0)
        if whole_mask.any():
            ins_labels[whole_mask != 0] = get_clustering_labels(moved, whole_mask)
        ins_labels = (ins_labels + 1).astype(np.int64)

        # boundary cloud
        org = src[:, :3].contiguous()
        k = min(40, feats.shape[0])
        idx40, nn1_d2 = nearest_rescored(org, feats[:, :3].contiguous(), k)
        lab = torch.from_numpy(ins_labels).to(dev)[idx40]
        ratio = (lab == lab[:, :1]).sum(dim=1).to(torch.float64) / k
        bd = (ratio < self.bi["bdl_ratio"]).cpu().numpy()
        ps_labels = lab[:, 0].cpu().numpy()
        nn1_idx = idx40[:, 0]
        rng = np.random.default_rng(0)
        bd_rows = np.flatnonzero(bd)
        bd_rows = bd_rows[rng.permutation(bd_rows.shape[0])[:self.bi["num_of_bdl_points"]]]
        need = self.bi["num_of_all_points"] - bd_rows.shape[0]
        non_bd = np.flatnonzero(~bd)
        if non_bd.shape[0] <= need:
            reps = rng.integers(0, max(non_bd.shape[0], 1), need - non_bd.shape[0])
            nb_rows = non_bd[np.concatenate([np.arange(non_bd.shape[0]), reps])]
        elif need:
            sub = src[torch.from_numpy(non_bd).to(dev), :3]
            nb_rows = non_bd[fps(sub[None], need)[0].cpu().numpy()]
        else:
            nb_rows = non_bd[:0]
        rows = np.concatenate([bd_rows, nb_rows])
        n_bd = bd_rows.shape[0]
        bdl_sampled = feats_np[rows]
        pseudo_in = ps_labels[rows].astype(np.int64) - 1

        xyz_b = bdl_sampled[:, :3]
        bdl_cents = [xyz_b[pseudo_in == i].mean(axis=0)
                     for i in np.unique(pseudo_in) if i != -1]
        feats_b = src[torch.from_numpy(rows).to(dev)]
        out_b = given.get("bdl") or self.models["bdl"][0](feats_b[None])
        moved_b = (feats_b[:, :3] + out_b["offset_1"][0]).to(torch.float16).float().cpu().numpy()
        whole_mask_b, crops_bdl = self.votes("bdl", feats_b, bdl_cents, given.get("bdl"))
        n_clusters = len(np.unique(pseudo_in)) - 1
        bdl_ins = np.zeros(len(bdl_sampled)) - 1
        fg_b = whole_mask_b != 0
        if fg_b.any() and n_clusters >= 1:
            _, _, labels_ls = clustering_points([moved_b[fg_b]], "kmeans", [n_clusters])
            bdl_ins[fg_b] = labels_ls[0]
        bdl_ins = (bdl_ins + 1).astype(np.int64)

        first_xyz = sampled[:, :3]
        new_sem = disambiguate_arch_labels(first_xyz, ins_labels, cls_1)
        mod_ps, mod_sem = merge_boundary_clusters(first_xyz, ins_labels, new_sem,
                                                  bdl_sampled[:n_bd, :3], bdl_ins[:n_bd])
        final_ins = np.concatenate([ins_labels, mod_ps], axis=0)
        final_sem = np.concatenate([new_sem, mod_sem], axis=0)

        nn = nn1_idx
        if n_bd:
            nn_b, d_b2 = nearest_rescored(org, src[torch.from_numpy(rows[:n_bd]).to(dev), :3]
                                          .contiguous(), min(4, n_bd))
            nn = torch.where(d_b2 < nn1_d2, len(first_xyz) + nn_b[:, 0], nn1_idx)
        nn = nn.cpu().numpy()
        sem = final_sem[nn].astype(np.int64)
        sem[sem >= 9] += 2
        sem[sem > 0] += 10
        return {"sem": sem, "ins": final_ins[nn].astype(np.int64), "sample": feats,
                "boundary": feats_b, "crops": {"fps": crops_fps, "bdl": crops_bdl},
                "src": org, "sample_idx": sample,
                "boundary_idx": torch.from_numpy(rows).to(dev)}


def same_crops(a: torch.Tensor | None, b: torch.Tensor) -> torch.Tensor:
    """Per crop of ``b`` ``[K, S, 6]``: whether ``a`` holds the same crop
    there (rows equal to ``CROP_ATOL``); none, where the two differ in
    shape."""
    if a is None or a.shape != b.shape:
        return torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    return ((a.float() - b.float()).abs() <= CROP_ATOL).flatten(1).all(dim=1)


def source_rows(rows: torch.Tensor, src: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """The row of ``src`` ``[N, 3]`` nearest each of ``rows`` ``[M, >=3]``
    (xyz): which vertex each handed-on row is. The program parses the
    ``.obj`` with a parser of its own, which rounds some coordinates a
    float64 ulp away from the correctly rounded value, so that a row's
    normal can differ from the reference's in its last float32 bit; the
    vertex it holds is what the stages chose."""
    s = src.double()
    sn = (s * s).sum(dim=1)
    return torch.cat([(sn[None] - 2.0 * q @ s.T).argmin(dim=1)
                      for q in rows[:, :3].double().split(chunk)])


def handoff(made: dict, want: dict) -> dict:
    """The exact comparison of what the stages handed on, ``made`` against
    the reference's ``want``: the share of the sample's rows and of the
    boundary cloud's rows that hold another vertex than the reference's
    (by index, ``source_rows``), and the share of each model's crops that
    are not the reference's (all of them where the counts differ)."""
    def rows(a, b):
        if a.shape[0] != b.shape[0]:
            return 1.0
        return float((source_rows(a, want["src"]) != b).float().mean())

    def crops(a, b):
        if a.shape[0] == 0 and b.shape[0] == 0:
            return 0.0
        if a.shape[0] != b.shape[0]:
            return 1.0
        return float(1.0 - same_crops(a, b).float().mean())

    return {"sample_rows_differ": rows(made["sample"], want["sample_idx"]),
            "fps_crops_differ": crops(made["crops"]["fps"], want["crops"]["fps"]),
            "bdl_rows_differ": rows(made["boundary"], want["boundary_idx"]),
            "bdl_crops_differ": crops(made["crops"]["bdl"], want["crops"]["bdl"])}

