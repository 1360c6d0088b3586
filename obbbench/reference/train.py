"""Plain reference of the `Train_OBB.py` step: the loader's batch (mosaic-4,
the fixed-point warp, horizontal flip, HSV jitter) drawn from a seeded
``RandomState`` in the engine's order, the rotated task-aligned assigner,
the OBB loss (BCE, 1 - ProbIoU, DFL; gains 7.5 / 0.5 / 1.5 and the batch
factor), the nesterov SGD in three groups with the warmup schedule and
the EMA. Float32; the pixel path on the host in numpy and integers."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M

BORDER = 114
FRAC_BITS, FRAC_ONE = 10, 1 << 10
INV_255 = float(np.float32(1.0 / 255.0))
INV_60 = float(np.float32(1.0 / 60.0))


# ---------------------------------------------------------------------------
# The loader's batch
# ---------------------------------------------------------------------------

def invert_affine(m):
    D = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    D = 1.0 / D if D != 0.0 else 0.0
    a00, a01, a10, a11 = m[1, 1] * D, -m[0, 1] * D, -m[1, 0] * D, m[0, 0] * D
    return np.array([[a00, a01, -a00 * m[0, 2] - a01 * m[1, 2]],
                     [a10, a11, -a10 * m[0, 2] - a11 * m[1, 2]]])


def warp_u8(img, minv, out_h, out_w):
    """cv2.warpAffine INTER_LINEAR, constant border 114, in fixed point:
    source coordinates quantized to 1/1024 px, weights summing to 2^20."""
    x, y = np.arange(out_w, dtype=np.float64), np.arange(out_h, dtype=np.float64)
    X = (np.rint((minv[0, 1] * y + minv[0, 2]) * FRAC_ONE).astype(np.int32)[:, None]
         + np.rint(minv[0, 0] * x * FRAC_ONE).astype(np.int32)[None])
    Y = (np.rint((minv[1, 1] * y + minv[1, 2]) * FRAC_ONE).astype(np.int32)[:, None]
         + np.rint(minv[1, 0] * x * FRAC_ONE).astype(np.int32)[None])
    im = img.astype(np.int32)
    H, W = im.shape[:2]
    ix, iy, fx, fy = X >> FRAC_BITS, Y >> FRAC_BITS, X & 1023, Y & 1023

    def tap(a, b):
        ok = (a >= 0) & (a < H) & (b >= 0) & (b < W)
        return np.where(ok[..., None], im[np.clip(a, 0, H - 1),
                                          np.clip(b, 0, W - 1)], BORDER)

    gx, gy = FRAC_ONE - fx, FRAC_ONE - fy
    acc = ((gy * gx)[..., None] * tap(iy, ix) + (gy * fx)[..., None]
           * tap(iy, ix + 1) + (fy * gx)[..., None] * tap(iy + 1, ix)
           + (fy * fx)[..., None] * tap(iy + 1, ix + 1))
    return np.clip((acc + (1 << 19)) >> 20, 0, 255).astype(np.uint8)


def xywhr_np(c8):
    pts = np.asarray(c8, np.float64).reshape(-1, 4, 2)
    c = pts.mean(1)
    e_w, e_h = pts[:, 0] - pts[:, 3], pts[:, 0] - pts[:, 1]
    return np.stack([c[:, 0], c[:, 1], np.linalg.norm(e_w, axis=-1),
                     np.linalg.norm(e_h, axis=-1),
                     np.arctan2(e_w[:, 1], e_w[:, 0])], -1)


def bgr_to_hsv(bgr):
    b, g, r = (bgr[..., i] for i in range(3))
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    zero = torch.zeros_like(v)
    s = torch.where(v > 0, diff / torch.clamp_min(v, 1e-9) * 255.0, zero)
    safe = torch.clamp_min(diff, 1e-9)
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, zero, h)
    return torch.stack([torch.where(h < 0, h + 360.0, h) / 2.0, s, v], -1)


def hsv_to_bgr(hsv):
    h, s, v = hsv[..., 0] * 2.0, hsv[..., 1] * INV_255, hsv[..., 2]
    c = v * s
    hp = h * INV_60
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    idx = torch.floor(hp).to(torch.int32) % 6

    def pick(*vals):
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(idx == k, vals[k], out)
        return out

    m = v - c
    return torch.stack([pick(z, z, x, c, c, x) + m, pick(x, c, c, x, z, z) + m,
                        pick(c, x, z, z, x, c) + m], -1)


class Loader:
    """The batches of tiles [N, ts, ts, 3] uint8 (network channel order)
    with normalized labels (one [K, 9] array a tile)."""

    def __init__(self, tiles: np.ndarray, labels: list, max_labels: int = 64):
        self.tiles, self.ts, self.M = tiles, tiles.shape[1], max_labels
        self.labels = []
        for lab in labels:
            lab = np.asarray(lab, np.float64).reshape(-1, 9)
            self.labels.append((lab[:, 0], lab[:, 1:] * self.ts))

    def _mosaic(self, i, rng):
        ts = self.ts
        idxs = [i] + list(rng.randint(0, len(self.tiles), 3))
        yc = int(rng.uniform(0.5 * ts, 1.5 * ts))
        xc = int(rng.uniform(0.5 * ts, 1.5 * ts))
        s = rng.uniform(0.5, 1.5)
        tx = ts * (0.5 + rng.uniform(-0.1, 0.1)) - s * ts
        ty = ts * (0.5 + rng.uniform(-0.1, 0.1)) - s * ts
        canvas = np.full((2 * ts, 2 * ts, 3), BORDER, np.uint8)
        cls_all, c8_all = [], []
        for k, idx in enumerate(idxs):
            x1a, y1a = (max(xc - ts, 0) if k in (0, 2) else xc,
                        max(yc - ts, 0) if k in (0, 1) else yc)
            x2a, y2a = (xc if k in (0, 2) else min(xc + ts, 2 * ts),
                        yc if k in (0, 1) else min(yc + ts, 2 * ts))
            x1b = ts - (x2a - x1a) if k in (0, 2) else 0
            y1b = ts - (y2a - y1a) if k in (0, 1) else 0
            canvas[y1a:y2a, x1a:x2a] = self.tiles[idx][
                y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
            cls, c8 = self.labels[idx]
            if len(c8):
                sh = c8.copy()
                sh[:, 0::2] += (xc - ts) if k in (0, 2) else xc
                sh[:, 1::2] += (yc - ts) if k in (0, 1) else yc
                cls_all.append(cls)
                c8_all.append(sh)
        cls = np.concatenate(cls_all) if cls_all else np.zeros((0,))
        c8 = np.concatenate(c8_all) if c8_all else np.zeros((0, 8))
        if len(c8):
            c8 = (c8.reshape(-1, 4, 2) * s + np.array([tx, ty])).reshape(-1, 8)
            cx, cy = c8[:, 0::2].mean(1), c8[:, 1::2].mean(1)
            ok = ((cx >= 0) & (cx < ts) & (cy >= 0) & (cy < ts)
                  & (np.ptp(c8[:, 0::2], axis=1) > 2)
                  & (np.ptp(c8[:, 1::2], axis=1) > 2))
            cls, c8 = cls[ok], c8[ok]
        img = warp_u8(canvas, invert_affine(np.array([[s, 0, tx], [0, s, ty]])),
                      ts, ts)
        return img, cls, c8

    def batches(self, batch_size, rng, device, mosaic_p=1.0, fliplr_p=0.5,
                hsv_s=0.7, hsv_v=0.4, half: bool = False):
        """Batches in the engine's draw order: the shuffle, then per sample
        the mosaic coin and its draws, then per batch the flips and the S
        and V gains. ``half`` keeps the first half of each batch's rows
        after every draw (a fault for the controls)."""
        ts, M_ = self.ts, self.M
        order = np.arange(len(self.tiles))
        rng.shuffle(order)
        end = len(order) - len(order) % batch_size
        for s0 in range(0, end, batch_size):
            idx = order[s0:s0 + batch_size]
            B = len(idx)
            imgs = np.zeros((B, ts, ts, 3), np.uint8)
            gl, gb, gm = (np.zeros((B, M_), np.int64),
                          np.zeros((B, M_, 5), np.float32),
                          np.zeros((B, M_), bool))
            for j, i in enumerate(idx):
                if rng.rand() < mosaic_p:
                    imgs[j], cls, c8 = self._mosaic(i, rng)
                else:
                    imgs[j] = self.tiles[i]
                    cls, c8 = self.labels[i]
                if len(cls):
                    k = min(len(cls), M_)
                    gl[j, :k] = cls[:k].astype(np.int64)
                    gb[j, :k] = xywhr_np(c8[:k])
                    gm[j, :k] = True
            flips = rng.rand(B) < fliplr_p
            sg = np.maximum(1.0 + rng.uniform(-1, 1, B) * hsv_s, 0.0)
            vg = np.maximum(1.0 + rng.uniform(-1, 1, B) * hsv_v, 0.0)
            x = torch.from_numpy(imgs).to(device).to(torch.float32)
            fl = torch.from_numpy(flips).to(device)
            x = torch.where(fl[:, None, None, None], x.flip(-2), x)
            hsv = bgr_to_hsv(x)
            hsv = torch.stack([
                hsv[..., 0],
                hsv[..., 1] * torch.from_numpy(sg.astype(np.float32)).to(
                    device)[:, None, None],
                hsv[..., 2] * torch.from_numpy(vg.astype(np.float32)).to(
                    device)[:, None, None]], -1)
            x = torch.clamp(torch.round(hsv_to_bgr(torch.floor(
                torch.clamp(hsv, 0.0, 255.0)))), 0, 255) * INV_255
            gbt = torch.from_numpy(gb).to(device)
            flipped = gbt.clone()
            flipped[..., 0] = float(ts) - gbt[..., 0]
            flipped[..., 4] = -gbt[..., 4]
            gbt = torch.where(fl[:, None, None], flipped, gbt)
            batch = {"images": x.permute(0, 3, 1, 2).contiguous(),
                     "gt_labels": torch.from_numpy(gl).to(device),
                     "gt_xywhr": gbt, "gt_mask": torch.from_numpy(gm).to(device)}
            if half:
                batch = {k: v[:B // 2] for k, v in batch.items()}
            yield batch


# ---------------------------------------------------------------------------
# Assigner and loss
# ---------------------------------------------------------------------------

@torch.no_grad()
def assign(pd_scores, pd_bboxes, anchor_pts, gt_labels, gt_bboxes, gt_mask,
           topk=10, alpha=0.5, beta=6.0, nc=12, eps=1e-9):
    B, Mg = gt_labels.shape
    labels = gt_labels.long()
    pts = M.xywhr_to_corners8(gt_bboxes).reshape(B, Mg, 4, 2)
    a, b, d = pts[..., 1, :], pts[..., 0, :], pts[..., 2, :]
    ab, ad = b - a, d - a
    ap = anchor_pts - a[..., None, :]
    dab, dad = (ap * ab[..., None, :]).sum(-1), (ap * ad[..., None, :]).sum(-1)
    in_gts = ((dab >= 0) & (dab <= (ab * ab).sum(-1)[..., None])
              & (dad >= 0) & (dad <= (ad * ad).sum(-1)[..., None]))
    iou = torch.clamp_min(M.probiou(gt_bboxes[:, :, None, :],
                                    pd_bboxes[:, None, :, :]), 0.0)
    cls_score = torch.gather(pd_scores, 2, labels[:, None, :].expand(
        -1, pd_scores.shape[1], -1)).transpose(1, 2)
    align = cls_score ** alpha * iou ** beta
    cand = in_gts & gt_mask[:, :, None]
    metric = torch.where(cand, align, torch.zeros_like(align))
    kth = torch.topk(metric, topk, dim=-1).values[..., -1:]
    topk_mask = cand & (metric >= torch.clamp_min(kth, eps)) & (metric > 0)
    claimed = topk_mask.sum(1)
    best = torch.where(topk_mask, iou, torch.full_like(iou, -1.0)).argmax(1)
    onehot = F.one_hot(best, Mg).transpose(1, 2).bool()
    final = torch.where(claimed[:, None, :] > 1, topk_mask & onehot, topk_mask)
    fg = final.any(1)
    gi = final.to(torch.uint8).argmax(1)
    t_labels = torch.gather(labels, 1, gi)
    t_boxes = torch.gather(gt_bboxes, 1, gi[..., None].expand(-1, -1, 5))
    zero = torch.zeros_like(align)
    mf, iof = torch.where(final, align, zero), torch.where(final, iou, zero)
    sv = (mf * iof.amax(2, keepdim=True)
          / (mf.amax(2, keepdim=True) + eps)).amax(1)
    ts_ = F.one_hot(t_labels, nc).to(align.dtype) * sv[..., None]
    return {"bboxes": t_boxes, "fg": fg,
            "scores": torch.where(fg[..., None], ts_, torch.zeros_like(ts_))}


def obb_loss(raw, gt_labels, gt_xywhr, gt_mask, nc=12, img_size=416,
             reg_max=16, gains=(7.5, 0.5, 1.5)):
    box = M.flatten_levels(raw["box"])
    cls = M.flatten_levels(raw["cls"])
    ang = M.flatten_levels(raw["ang"])[..., 0]
    B, A = ang.shape
    pts, strides = M.make_anchors(img_size, ang.device)
    pred = M.dist2rbox(M.dfl_expectation(box, reg_max), M.decode_angle(ang),
                       pts[None])
    pred_px = torch.cat([pred[..., :4] * strides[None, :, None],
                         pred[..., 4:]], -1).detach()
    tgt = assign(torch.sigmoid(cls).detach(), pred_px, pts * strides[:, None],
                 gt_labels, gt_xywhr, gt_mask, nc=nc)
    fg, t_scores = tgt["fg"], tgt["scores"]
    score_sum = torch.clamp_min(t_scores.sum(), 1.0)
    loss_cls = (-t_scores * F.logsigmoid(cls)
                - (1.0 - t_scores) * F.logsigmoid(-cls)).sum() / score_sum
    tb = torch.cat([tgt["bboxes"][..., :4] / strides[None, :, None],
                    tgt["bboxes"][..., 4:]], -1)
    dummy = torch.cat([pts.expand(B, A, 2), torch.ones((B, A, 2),
                                                       device=fg.device),
                       torch.zeros((B, A, 1), device=fg.device)], -1)
    tb = torch.where(fg[..., None], tb, dummy)
    weight = t_scores.sum(-1)
    iou = M.probiou(torch.where(fg[..., None], pred, dummy), tb)
    zero = torch.zeros_like(weight)
    loss_box = torch.where(fg, (1.0 - iou) * weight, zero).sum() / score_sum
    half = tb[..., 2:4] / 2.0
    t_ltrb = torch.clamp(torch.cat([pts[None] - (tb[..., :2] - half),
                                    (tb[..., :2] + half) - pts[None]], -1),
                         0.0, reg_max - 1 - 0.01)
    tl = torch.floor(t_ltrb).long()
    tr = torch.clamp_max(tl + 1, reg_max - 1)
    wl = tr.to(t_ltrb.dtype) - t_ltrb
    logp = F.log_softmax(box.reshape(B, A, 4, reg_max), dim=-1)
    dfl = (-torch.gather(logp, -1, tl[..., None])[..., 0] * wl
           - torch.gather(logp, -1, tr[..., None])[..., 0] * (1.0 - wl)).mean(-1)
    loss_dfl = torch.where(fg, dfl * weight, zero).sum() / score_sum
    return (gains[0] * loss_box + gains[1] * loss_cls
            + gains[2] * loss_dfl) * B


# ---------------------------------------------------------------------------
# Optimizer, schedule, EMA
# ---------------------------------------------------------------------------

def hypers(cfg: dict, steps_per_epoch: int, step: int) -> dict:
    """The engine's schedule in float32: linear decay lr0 -> lr0 * lrf over
    the run; over the warmup the momentum ramps, the bias lr falls from
    warmup_bias_lr and the other lrs rise from 0."""
    f = np.float32
    total = f(cfg["epochs"] * steps_per_epoch)
    warm = f(max(1, int(cfg["warmup_epochs"] * steps_per_epoch)))
    lr0, lrf = f(cfg["lr0"]), f(cfg["lrf"])
    frac = np.minimum(f(step), total - f(1)) / total
    base = lr0 * (f(1) - frac) + (lr0 * lrf) * frac
    w = np.clip(f(step) / warm, f(0), f(1))
    return {"lr": base * w,
            "lr_bias": f(cfg["warmup_bias_lr"]) * (f(1) - w) + base * w,
            "momentum": f(cfg["warmup_momentum"]) * (f(1) - w)
            + f(cfg["momentum"]) * w}


def group_of(name: str, p: torch.Tensor) -> str:
    if name.endswith(".bias"):
        return "bias"
    return "decay" if p.ndim >= 2 else "no_decay"


class Trainer:
    """The model in training mode, its SGD momentum and its EMA."""

    def __init__(self, model, cfg: dict, steps_per_epoch: int):
        self.model, self.cfg, self.spe = model.train(), cfg, steps_per_epoch
        self.named = list(model.named_parameters())
        self.mom = [torch.zeros_like(p) for _, p in self.named]
        self.ema = [p.detach().clone() for _, p in self.named]
        self.step = 0

    def train_step(self, batch) -> float:
        cfg = self.cfg
        h = hypers(cfg, self.spe, self.step)
        total = obb_loss(self.model(batch["images"]), batch["gt_labels"],
                         batch["gt_xywhr"], batch["gt_mask"], cfg["nc"],
                         cfg["tile_size"], gains=(cfg["box_gain"],
                                                  cfg["cls_gain"],
                                                  cfg["dfl_gain"]))
        grads = torch.autograd.grad(total, [p for _, p in self.named])
        mu = float(h["momentum"])
        with torch.no_grad():
            for k, ((name, p), g) in enumerate(zip(self.named, grads)):
                grp = group_of(name, p)
                if grp == "decay":
                    g = g + cfg["weight_decay"] * p
                self.mom[k] = g + mu * self.mom[k]
                lr = float(h["lr_bias" if grp == "bias" else "lr"])
                p -= lr * (g + mu * self.mom[k])
            s = np.float32(self.step + 1) * np.float32(1.0 / cfg["ema_tau"])
            d = float(np.float32(cfg["ema_decay"]) * (np.float32(1) - np.exp(-s)))
            for e, (_, p) in zip(self.ema, self.named):
                e.mul_(d).add_(p * (1.0 - d))
        self.step += 1
        return float(total.detach())
