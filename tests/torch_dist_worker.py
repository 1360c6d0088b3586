"""One process of the port's data-parallel checks on the CPU (gloo): run by
``tests/test_torch_dist.py`` as

    python tests/torch_dist_worker.py COORDINATOR WORLD RANK INPUT OUTPUT

``INPUT`` is a pickle the test wrote (weights, momentum, batches, tiles,
maps, directories). The process joins the group through the port's
``parallel/distributed.py``, runs each case on its share of the work and
pickles {case: result} to ``OUTPUT``. It imports the port and torch only;
any failure exits non-zero."""

import os
import pickle
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from oriented_object_detection_tpu_torch.config import TrainConfig  # noqa
from oriented_object_detection_tpu_torch.data.loader import TileDataset  # noqa
from oriented_object_detection_tpu_torch.eval.val import validate_tiles  # noqa
from oriented_object_detection_tpu_torch.infer.pipeline import (  # noqa
    build_detector)
from oriented_object_detection_tpu_torch.models import layers as LY  # noqa
from oriented_object_detection_tpu_torch.models import weights as W  # noqa
from oriented_object_detection_tpu_torch.parallel import distributed as PD  # noqa
from oriented_object_detection_tpu_torch.parallel import mesh as PM  # noqa
from oriented_object_detection_tpu_torch.train import trainer as TR  # noqa


def bn_case(d: dict) -> dict:
    """A training-mode BatchNorm on this process's rows of ``d['x']``: its
    output, the input's gradient, the summed parameter gradients and the
    running statistics."""
    lo, hi = PM.batch_rows(len(d["x"]), PD.rank(), PD.world())
    layer = LY.BatchNorm(d["x"].shape[1])
    with torch.no_grad():
        for t, k in ((layer.weight, "scale"), (layer.bias, "bias"),
                     (layer.running_mean, "mean"), (layer.running_var, "var")):
            t.copy_(torch.from_numpy(d[k]))
    x = torch.from_numpy(d["x"][lo:hi]).requires_grad_(True)
    before = dict(PD.COLLECTIVES)
    y = layer.train()(x)
    (y * torch.from_numpy(d["w"][lo:hi])).sum().backward()
    calls = PD.COLLECTIVES["all_reduce"] - before["all_reduce"]
    PD.all_reduce_grads(layer.parameters())
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": layer.weight.grad.numpy(),
            "bias_grad": layer.bias.grad.numpy(),
            "running_mean": layer.running_mean.numpy(),
            "running_var": layer.running_var.numpy(), "all_reduces": calls}


def step_case(d: dict) -> dict:
    """One train step on this process's rows of the global batch, from the
    test's weights, momentum and step: the metrics and the payload."""
    cfg = TrainConfig(**d["cfg"])
    st = TR.create_train_state(cfg, steps_per_epoch=4, device="cpu")
    W.load_state(st.model, W.torch_state_from_jax(d["weights"]))
    st.reset_ema()
    st.step = 2
    mt = W.torch_state_from_jax({"params": d["mom"]})
    for n, p in st.model.named_parameters():
        st.opt.state[p]["momentum_buffer"] = torch.from_numpy(mt[n].copy())
    lo, hi = PM.batch_rows(cfg.batch_size, PD.rank(), PD.world())
    batch = {k: torch.from_numpy(v[lo:hi]) for k, v in d["batch"].items()}
    before = sum(PD.COLLECTIVES.values())
    m = TR.train_step(st, batch, cfg).numpy()
    return {"metrics": m, "payload": TR.checkpoint_payload(st),
            "collectives": sum(PD.COLLECTIVES.values()) - before}


def fit_case(d: dict) -> dict:
    """``fit`` for one epoch on this process's rows of each global batch,
    warm-started, with the sharded validation as its fitness; each process
    is given its own run directory."""
    cfg = TrainConfig(**d["fit_cfg"])
    ds = TileDataset(d["list"], cfg.tile_size, device="cpu",
                     reader=d["pixels"].__getitem__)
    rows = PM.batch_rows(cfg.batch_size, PD.rank(), PD.world())
    st = TR.create_train_state(cfg, len(ds) // cfg.batch_size, device="cpu")
    rng = np.random.RandomState(cfg.seed)
    fits = []

    def val_fn(s):
        fits.append(validate_tiles(s.eval_model(), ds, cfg,
                                   shard_across_processes=True))
        return fits[-1]

    run_dir = os.path.join(d["run_root"], f"rank{PD.rank()}")
    TR.fit(st, cfg, lambda e: ds.batches(cfg.batch_size, rng, rows=rows),
           val_fn=val_fn, ckpt_dir=run_dir, init_ckpt=d["ckpt128"])
    # the same fresh state on every process passes the start's check; a
    # state that differs on one process fails it
    bad = TR.create_train_state(cfg, 1, device="cpu")
    if PD.rank() == 1:
        with torch.no_grad():
            next(bad.model.parameters()).view(-1)[0] += 1.0
    try:
        TR.fit(bad, cfg, lambda e: iter(()), ckpt_dir=run_dir + "_bad")
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    sums = PD.tensor_checksums(list(TR.state_tensors(st).values()))
    return {"fitness": fits, "checksums": sums.numpy(), "refused": refused,
            "payload": TR.checkpoint_payload(st)}


def val_case(d: dict) -> dict:
    cfg = TrainConfig(**d["fit_cfg"])
    ds = TileDataset(d["list"], cfg.tile_size, device="cpu",
                     reader=d["pixels"].__getitem__)
    model = TR.create_train_state(cfg, 1, device="cpu")
    TR.warm_start_state(d["ckpt128"], model)
    return validate_tiles(model.eval_model(), ds, cfg, batch_size=3,
                          return_components=True,
                          shard_across_processes=True)


def detect_case(d: dict) -> dict:
    """detect_images and detect_stream of the 3ch and 4ch detectors."""
    out = {}
    for name, triples, ch in (("3ch", [(128, 30, d["ckpt128"])], 3),
                              ("4ch", [(416, 100, d["ckpt4ch"])], 4)):
        det = build_detector(triples, channels=ch, device="cpu",
                             compute_dtype="float32")
        out[name] = {"images": det.detect_images(d["maps"]),
                     "stream": list(det.detect_stream(d["maps"], chunk=1))}
    return out


def batch_case(d: dict) -> str:
    try:
        PM.batch_rows(d["odd_batch"], PD.rank(), PD.world())
    except SystemExit as e:
        return str(e)
    return ""


def main() -> None:
    coordinator, world, rank, inp, outp = sys.argv[1:]
    torch.set_num_threads(1)
    dev = PD.initialize(coordinator, int(world), int(rank), device="cpu")
    with open(inp, "rb") as f:
        d = pickle.load(f)
    res = {"device": str(dev), "rank": PD.rank(), "world": PD.world(),
           "backend": torch.distributed.get_backend()}
    for name, case in (("bn", bn_case), ("step", step_case),
                       ("val", val_case), ("fit", fit_case),
                       ("detect", detect_case), ("odd_batch", batch_case)):
        res[name] = case(d)
    PD.shutdown()
    with open(outp, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
