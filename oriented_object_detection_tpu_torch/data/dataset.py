"""Tile dataset build: two-pass train tiling, empty-tile budgeting,
class-balancing augmentation, val tiling and the 4-channel TIFF conversion,
the port of the JAX package's ``data/dataset.py`` (`Train_OBB.py:44-429,
513-613`), with the same files on disk: tile names ``{stem}_tile_{id}.jpg``
and ``.txt``, list files, the empty ``.txt`` convention, the
``RandomState(42)`` empty-tile selection, ``_aug_{type}_{n}`` names and the
R_TARGET keep fraction. cv2 is imported inside the functions that read or
write files; the 4-channel core ``tiles_to_4ch`` needs none.
"""

from __future__ import annotations

import json
import os
import random
from typing import Optional

import numpy as np

import torch

from ..config import DTEdgeConfig
from ..ops import dtedge as DTE
from ..ops import tiling as T
from ..utils.runtime import resolve_device
from . import labels as L

IMG_EXTS = (".jpg", ".jpeg", ".png")


def _list_images(d: str) -> list[str]:
    return sorted(f for f in os.listdir(d)
                  if f.lower().endswith(IMG_EXTS))


def update_list_file(path: str, paths: list[str], append: bool = False):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a" if append else "w") as f:
        for p in paths:
            f.write(p + "\n")


def build_train_tiles(
    image_dir: str, label_dir: str,
    output_image_dir: str, output_label_dir: str,
    out_list_txt: str, tile_size: int, overlap: int,
    boundary_threshold: float = 0.1,
    empty_meta_path: Optional[str] = None,
    split_name: str = "train",
) -> dict:
    """Pass 1 (`Train_OBB.py:44-146`): enumerate full tiles, save only
    non-empty ones (midpoint ownership + coverage filter), record empty
    tile metadata for later budgeted sampling."""
    import cv2

    os.makedirs(output_image_dir, exist_ok=True)
    os.makedirs(output_label_dir, exist_ok=True)
    empty_meta_path = empty_meta_path or os.path.join(
        os.path.dirname(out_list_txt) or ".", f"_empty_meta_{split_name}.json")

    new_paths, empty_meta = [], []
    P_total = E_total = 0

    for image_file in _list_images(image_dir):
        img = cv2.imread(os.path.join(image_dir, image_file))
        if img is None:
            print(f"[WARN] cannot read: {image_file}")
            continue
        H, W = img.shape[:2]
        stem = os.path.splitext(image_file)[0]
        lab = L.read_labels(
            os.path.join(label_dir, stem + ".txt"), img_w=W, img_h=H)

        grid = T.train_tile_grid(H, W, tile_size, overlap)
        per_tile = T.assign_labels_to_tiles(
            lab, grid, tile_size, boundary_threshold)

        pos = emp = 0
        for tid, ((x, y), tl) in enumerate(zip(grid, per_tile)):
            if len(tl):
                crop = img[y:y + tile_size, x:x + tile_size]
                ip = os.path.join(output_image_dir,
                                  f"{stem}_tile_{tid}.jpg")
                cv2.imwrite(ip, crop)
                L.write_labels(os.path.join(
                    output_label_dir, f"{stem}_tile_{tid}.txt"), tl)
                new_paths.append(ip)
                P_total += 1
                pos += 1
            else:
                empty_meta.append({
                    "image_file": image_file, "tile_id": int(tid),
                    "x": int(x), "y": int(y),
                    "tile_size": int(tile_size)})
                E_total += 1
                emp += 1
        print(f"[TILED] {image_file} -> tiles: {pos + emp} "
              f"(positives saved: {pos}, empties enumerated: {emp})")

    update_list_file(out_list_txt, new_paths)
    with open(empty_meta_path, "w") as f:
        json.dump({"image_dir": image_dir,
                   "output_image_dir": output_image_dir,
                   "output_label_dir": output_label_dir,
                   "empty": empty_meta}, f)
    print(f"[{split_name}] PASS-1 done. Positives saved: {P_total:,} | "
          f"Empty enumerated: {E_total:,}")
    return {"P_total": P_total, "E_total": E_total,
            "empty_meta_path": empty_meta_path}


def count_positives(label_dir: str) -> int:
    """Non-empty label files (`Train_OBB.py:149-165`)."""
    cnt = 0
    for fn in os.listdir(label_dir):
        if not fn.endswith(".txt"):
            continue
        p = os.path.join(label_dir, fn)
        try:
            if os.path.getsize(p) > 0:
                with open(p) as f:
                    if any(line.strip() for line in f):
                        cnt += 1
        except OSError:
            pass
    return cnt


def save_selected_empty_tiles(empty_meta_path: str, keep_fraction: float,
                              out_list_txt: str, rng_seed: int = 42) -> dict:
    """Pass 2 (`Train_OBB.py:167-226`): keep a seeded random fraction of the
    enumerated empty tiles, write them with empty label files, append to the
    list file. Selection reproduces RandomState(seed).shuffle exactly."""
    import cv2

    assert 0.0 <= keep_fraction <= 1.0
    with open(empty_meta_path) as f:
        meta = json.load(f)
    empties = meta["empty"]
    if not empties:
        print("[INFO] No empty tiles to save.")
        return {"E_kept": 0}

    k = int(round(keep_fraction * len(empties)))
    rng = np.random.RandomState(rng_seed)
    idx = np.arange(len(empties))
    rng.shuffle(idx)
    chosen = [empties[i] for i in idx[:k]]

    cache: dict[str, np.ndarray] = {}
    kept = []
    for rec in chosen:
        base = rec["image_file"]
        if base not in cache:
            cache[base] = cv2.imread(
                os.path.join(meta["image_dir"], base))
            if cache[base] is None:
                print(f"[WARN] cannot read: {base}")
                continue
        img = cache[base]
        x, y, ts = rec["x"], rec["y"], rec["tile_size"]
        stem = os.path.splitext(base)[0]
        ip = os.path.join(meta["output_image_dir"],
                          f"{stem}_tile_{rec['tile_id']}.jpg")
        cv2.imwrite(ip, img[y:y + ts, x:x + ts])
        open(os.path.join(meta["output_label_dir"],
                          f"{stem}_tile_{rec['tile_id']}.txt"), "w").close()
        kept.append(ip)

    update_list_file(out_list_txt, kept, append=True)
    print(f"[TRAIN] Empty kept: {len(kept):,} of {len(empties):,} "
          f"(fraction={keep_fraction:.3f})")
    return {"E_kept": len(kept), "E_total": len(empties)}


def build_val_tiles(
    image_dir: str, label_dir: str,
    output_image_dir: str, output_label_dir: str,
    cropped_txt_file: str, tile_size: int, overlap: int,
    keep_empty_fraction: Optional[float] = None,
    rng_seed: int = 42, split_name: str = "val",
    boundary_threshold: float = 0.1, r_target: int = 4,
):
    """One-pass val tiler (`Train_OBB.py:290-428`): enumerate in memory,
    keep all non-empty + auto R_TARGET fraction of empties."""
    import cv2

    os.makedirs(output_image_dir, exist_ok=True)
    os.makedirs(output_label_dir, exist_ok=True)

    all_tiles = []
    for image_file in _list_images(image_dir):
        img = cv2.imread(os.path.join(image_dir, image_file))
        if img is None:
            print(f"[WARN] cannot read image: {image_file}")
            continue
        h, w = img.shape[:2]
        stem = os.path.splitext(image_file)[0]
        lab = L.read_labels(
            os.path.join(label_dir, stem + ".txt"), img_w=w, img_h=h)
        grid = T.train_tile_grid(h, w, tile_size, overlap)
        per_tile = T.assign_labels_to_tiles(
            lab, grid, tile_size, boundary_threshold)
        for tid, ((x, y), tl) in enumerate(zip(grid, per_tile)):
            all_tiles.append({
                "image_file": image_file, "tile_id": tid,
                "x": int(x), "y": int(y),
                "is_empty": len(tl) == 0, "tile_labels": tl})
        print(f"[ENUM] {split_name}:{image_file} -> tiles: {len(grid)}")

    total = len(all_tiles)
    n_empty = sum(t["is_empty"] for t in all_tiles)
    n_pos = total - n_empty
    if keep_empty_fraction is None or keep_empty_fraction == -1:
        keep_empty_fraction = (min(1.0, r_target * n_pos / n_empty)
                               if n_empty > 0 else 0.0)

    print(f"\n[{split_name.upper()}] SUMMARY BEFORE EMPTY REMOVAL:")
    print(f"  Total tiles:        {total:,}")
    print(f"  Non-empty tiles:    {n_pos:,}")
    print(f"  Empty tiles:        {n_empty:,}")
    print(f"  -> keep_empty_fraction = {keep_empty_fraction:.3f}\n")

    empty_idxs = [i for i, t in enumerate(all_tiles) if t["is_empty"]]
    nonempty_idxs = [i for i, t in enumerate(all_tiles)
                     if not t["is_empty"]]
    rng = np.random.RandomState(rng_seed)
    k = int(round(keep_empty_fraction * len(empty_idxs))) if empty_idxs \
        else 0
    if 0 <= k < len(empty_idxs):
        rng.shuffle(empty_idxs)
        empty_idxs = empty_idxs[:k]
    keep_set = set(nonempty_idxs + empty_idxs)

    cache: dict[str, np.ndarray] = {}
    new_paths = []
    for i, t in enumerate(all_tiles):
        if i not in keep_set:
            continue
        base = t["image_file"]
        if base not in cache:
            cache[base] = cv2.imread(os.path.join(image_dir, base))
            if cache[base] is None:
                print(f"[WARN] cannot read (late): {base}")
                continue
        stem = os.path.splitext(base)[0]
        crop = cache[base][t["y"]:t["y"] + tile_size,
                           t["x"]:t["x"] + tile_size]
        ip = os.path.join(output_image_dir,
                          f"{stem}_tile_{t['tile_id']}.jpg")
        cv2.imwrite(ip, crop)
        lp = os.path.join(output_label_dir,
                          f"{stem}_tile_{t['tile_id']}.txt")
        if t["is_empty"]:
            open(lp, "w").close()
        else:
            L.write_labels(lp, t["tile_labels"])
        new_paths.append(ip)

    update_list_file(cropped_txt_file, new_paths)
    print(f"[{split_name}] saved tiles: {len(new_paths)} | "
          f"non-empty kept: {len(nonempty_idxs)} | "
          f"empty kept: {len(empty_idxs)} "
          f"(keep_empty_fraction={keep_empty_fraction:.3f})")


# ---------------------------------------------------------------------------
# Class balancing (`Train_OBB.py:513-576`)
# ---------------------------------------------------------------------------

def class_distribution(label_dir: str) -> dict[int, int]:
    counts: dict[int, int] = {}
    for fn in sorted(os.listdir(label_dir)):
        if not fn.endswith(".txt"):
            continue
        lab = L.read_labels(os.path.join(label_dir, fn))
        for c in lab[:, 0].astype(int):
            counts[c] = counts.get(c, 0) + 1
    return counts


def _augment_tile(img: np.ndarray, lab: np.ndarray, rng: random.Random):
    """The three offline augmentations (`Train_OBB.py:446-510`) on HOST.

    This is disk-to-disk dataset prep (read jpg -> augment -> write jpg),
    exactly like the reference's cv2 path, not the training loop (whose
    augmentations run on the device in data/loader.py). Returns
    [(name, img, labels_norm)]."""
    import cv2

    h, w = img.shape[:2]
    out = []

    # 1. scale x1.2 (`Train_OBB.py:462-471`: normalized labels shift by
    # w*f/int(w*f) because the scaled size is int-rounded)
    nw, nh = int(w * 1.2), int(h * 1.2)
    scaled = cv2.resize(img, (nw, nh))
    slab = lab.astype(np.float64).copy()
    if len(slab):
        slab[:, 1::2] = np.clip(slab[:, 1::2] * (w * 1.2 / nw), 0.0, 1.0)
        slab[:, 2::2] = np.clip(slab[:, 2::2] * (h * 1.2 / nh), 0.0, 1.0)
        slab[:, 0] = lab[:, 0]
    out.append(("scale", scaled, _dedup4(slab)))

    # 2. shift +-30 px (integer translation == exact slice paste, zero
    # fill — identical to the reference's warpAffine translate)
    dx, dy = rng.randint(-30, 30), rng.randint(-30, 30)
    shifted = np.zeros_like(img)
    ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else \
        (slice(-dy, h), slice(0, h + dy))
    xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else \
        (slice(-dx, w), slice(0, w + dx))
    shifted[yd, xd] = img[ys, xs]
    shlab = lab.astype(np.float64).copy()
    if len(shlab):
        shlab[:, 1::2] = np.clip((shlab[:, 1::2] * w + dx) / w, 0.0, 1.0)
        shlab[:, 2::2] = np.clip((shlab[:, 2::2] * h + dy) / h, 0.0, 1.0)
        shlab[:, 0] = lab[:, 0]
    out.append(("shift", shifted, _dedup4(shlab)))

    # 3. HSV jitter (S, V x gain; `Train_OBB.py:492-500`)
    sg, vg = rng.uniform(0.6, 1.4), rng.uniform(0.6, 1.4)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * sg, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * vg, 0, 255)
    hsvd = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
    out.append(("hsv", hsvd, _dedup4(lab.copy())))
    return out


def _dedup4(lab: np.ndarray) -> np.ndarray:
    """Duplicate-label removal by 4-decimal rounding
    (`Train_OBB.py:456-459`)."""
    if not len(lab):
        return lab
    r = lab.copy()
    r[:, 1:] = np.round(r[:, 1:], 4)
    _, keep = np.unique(r, axis=0, return_index=True)
    return lab[np.sort(keep)]


def balance_classes(image_dir: str, label_dir: str, txt_file: str,
                    class_balance_threshold: int = 800,
                    augmentation_repeats: int = 2, seed: int | None = None):
    """Oversample underrepresented classes with the offline augmentations
    (`Train_OBB.py:521-576`)."""
    import cv2

    counts = class_distribution(label_dir)
    print(f"Initial class distribution: {counts}")

    rng = random.Random(seed)
    label_files = sorted(f for f in os.listdir(label_dir)
                         if f.endswith(".txt"))
    new_paths = []
    counter = 0
    for class_id, count in counts.items():
        if count >= class_balance_threshold:
            continue
        print(f"Balancing class {class_id} (current count: {count})")
        with_class = [
            lf for lf in label_files
            if class_id in L.read_labels(
                os.path.join(label_dir, lf))[:, 0].astype(int)]
        for _ in range(augmentation_repeats):
            for lf in with_class:
                ip = os.path.join(image_dir, lf.replace(".txt", ".jpg"))
                img = cv2.imread(ip)
                if img is None:
                    continue
                lab = L.read_labels(os.path.join(label_dir, lf))
                for name, aimg, alab in _augment_tile(img, lab, rng):
                    stem = os.path.splitext(lf)[0]
                    fn = f"{stem}_aug_{name}_{counter}"
                    aip = os.path.join(image_dir, fn + ".jpg")
                    cv2.imwrite(aip, aimg)
                    L.write_labels(
                        os.path.join(label_dir, fn + ".txt"), alab)
                    new_paths.append(aip)
                    counter += 1

    update_list_file(txt_file, new_paths, append=True)
    print(f"Balanced class distribution: {class_distribution(label_dir)}")


# ---------------------------------------------------------------------------
# 4-channel TIFF conversion (`Train_OBB.py:598-613`)
# ---------------------------------------------------------------------------

def tiles_to_4ch(bgr: torch.Tensor, cfg: DTEdgeConfig = DTEdgeConfig()
                 ) -> torch.Tensor:
    """BGR uint8 tiles [N, H, W, 3] -> [R, G, B, DT] uint8 [N, 4, H, W] on
    the tiles' device: the cv2-free core of the 4-channel build. The DT
    channel is ``ops.dtedge.dt_edge_channel``, so on a CUDA tensor both EDT
    kernels run."""
    dt = DTE.dt_edge_channel(bgr, cfg)
    return torch.cat([bgr.flip(-1).permute(0, 3, 1, 2), dt[:, None]], dim=1)


def convert_folder_to_4ch_tiff(src_img_dir: str, dst_img_dir: str,
                               cfg: DTEdgeConfig = DTEdgeConfig(),
                               batch: int = 16, device=None) -> list[str]:
    """BGR tiles -> (4, H, W) [R, G, B, DT] multipage TIFFs, the DT-Edge
    channel computed in batches of one shape on ``device`` (the CUDA card
    unless ``device="cpu"``)."""
    import cv2

    dev = resolve_device(device)
    os.makedirs(dst_img_dir, exist_ok=True)
    out_paths: list[str] = []
    by_shape: dict[tuple, list[tuple[str, np.ndarray]]] = {}
    for fn in _list_images(src_img_dir):
        img = cv2.imread(os.path.join(src_img_dir, fn), cv2.IMREAD_COLOR)
        if img is None:
            print(f"[WARN] cannot read: {fn}")
            continue
        by_shape.setdefault(img.shape, []).append((fn, img))

    for items in by_shape.values():
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            imgs = torch.from_numpy(np.stack([im for _, im in chunk]))
            chw = tiles_to_4ch(imgs.to(dev), cfg).cpu().numpy()
            for (fn, _), pages in zip(chunk, chw):
                op = os.path.join(dst_img_dir,
                                  os.path.splitext(fn)[0] + ".tiff")
                if not cv2.imwritemulti(
                        op, [np.ascontiguousarray(c) for c in pages]):
                    raise RuntimeError(f"imwritemulti failed: {op}")
                out_paths.append(os.path.abspath(op))
    return out_paths


def mirror_labels_by_stem(src_lbl_dir: str, dst_lbl_dir: str,
                          stems: list[str]):
    """`Train_OBB.py:581-594`."""
    import shutil

    os.makedirs(dst_lbl_dir, exist_ok=True)
    copied = missing = 0
    for s in stems:
        src = os.path.join(src_lbl_dir, f"{s}.txt")
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(dst_lbl_dir, f"{s}.txt"))
            copied += 1
        else:
            missing += 1
    print(f"[INFO] labels copied={copied}, missing={missing} "
          f"-> {dst_lbl_dir}")
