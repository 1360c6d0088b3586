"""One process of the port's data-parallel and model-axis checks on the CPU
(gloo): run by ``tests/test_torch_dist.py`` and
``tests/test_torch_model_axis.py`` as

    python tests/torch_dist_worker.py COORDINATOR WORLD RANK INPUT OUTPUT \
        [CASE,CASE,...]

``INPUT`` is a pickle the test wrote (weights, momentum, batches, tiles,
maps, directories). The process joins the group through the port's
``parallel/distributed.py``, runs each case (by default the data-parallel
ones, ``DIST_CASES``) on its share of the work and pickles {case: result}
to ``OUTPUT``; the case ``one_process`` runs on process 0 before it joins
the group. It imports the port and torch only; any failure exits
non-zero."""

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
    before = PD.collective_counts()["all_reduce"]
    y = layer.train()(x)
    (y * torch.from_numpy(d["w"][lo:hi])).sum().backward()
    calls = PD.collective_counts()["all_reduce"] - before
    PD.all_reduce_grads(layer.parameters())
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": layer.weight.grad.numpy(),
            "bias_grad": layer.bias.grad.numpy(),
            "running_mean": layer.running_mean.numpy(),
            "running_var": layer.running_var.numpy(), "all_reduces": calls}


def start_state(d: dict, dtype: str = "float32") -> tuple:
    """(config, state) at the test's start: its weights and momentum, step
    2, in ``dtype``."""
    cfg = TrainConfig(**{**d["cfg"], "compute_dtype": dtype})
    st = TR.create_train_state(cfg, steps_per_epoch=4, device="cpu")
    W.load_state(st.model, W.torch_state_from_jax(d["weights"]))
    st.reset_ema()
    st.step = 2
    mt = W.torch_state_from_jax({"params": d["mom"]})
    for n, p in st.model.named_parameters():
        st.opt.state[p]["momentum_buffer"] = torch.from_numpy(mt[n].copy())
    return cfg, st


def rows_of(d: dict, lo: int, hi: int) -> dict:
    return {k: torch.from_numpy(v[lo:hi]) for k, v in d["batch"].items()}


def step_case(d: dict, dtype: str = "float32") -> dict:
    """One train step on this process's rows of the global batch, from the
    test's weights, momentum and step: the metrics and the payload; the
    dtypes of the state after it."""
    cfg, st = start_state(d, dtype)
    batch = rows_of(d, *PM.batch_rows(cfg.batch_size, PD.rank(), PD.world()))
    before = sum(PD.COLLECTIVES.values())
    m = TR.train_step(st, batch, cfg).numpy()
    params = list(st.model.parameters())
    return {"metrics": m, "payload": TR.checkpoint_payload(st),
            "collectives": sum(PD.COLLECTIVES.values()) - before,
            "dtypes": {
                "params": {str(p.dtype) for p in params},
                "grads": {str(p.grad.dtype) for p in params},
                "momentum": {str(st.opt.state[p]["momentum_buffer"].dtype)
                             for p in params},
                "ema": {str(p.dtype) for p in st.ema_tensors()},
                "stats": {str(b.dtype) for b in st.model.buffers()
                          if b.is_floating_point()}}}


def step_bf16_case(d: dict) -> dict:
    """``step_case`` in bf16, the port's default compute dtype."""
    return step_case(d, "bfloat16")


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


DETECTORS = (("3ch", 128, 30, "ckpt128", 3), ("4ch", 416, 100, "ckpt4ch", 4))


def detect_case(d: dict) -> dict:
    """detect_images and detect_stream of the 3ch and 4ch detectors."""
    out = {}
    for name, ts, ov, ckpt, ch in DETECTORS:
        det = build_detector([(ts, ov, d[ckpt])], channels=ch, device="cpu",
                             compute_dtype="float32")
        out[name] = {"images": det.detect_images(d["maps"]),
                     "stream": list(det.detect_stream(d["maps"], chunk=1))}
    return out


def detect_bf16_case(d: dict) -> dict:
    """detect_images of the 3ch and 4ch detectors in bf16, the default."""
    return {name: build_detector([(ts, ov, d[ckpt])], channels=ch,
                                 device="cpu").detect_images(d["maps"])
            for name, ts, ov, ckpt, ch in DETECTORS}


def batch_case(d: dict) -> str:
    try:
        PM.batch_rows(d["odd_batch"], PD.rank(), PD.world())
    except SystemExit as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# The model axis (``parallel/mesh.py``): the test's start, stepped
# ``AXIS_STEPS`` times on the same global batch
# ---------------------------------------------------------------------------

AXIS_STEPS = 3


def axis_steps(d: dict, mesh, steps: int = AXIS_STEPS) -> dict:
    """``steps`` train steps of the start state laid out over ``mesh``
    (none: the world's data parallelism), on the rows of the mesh's data
    index: the metrics and the gathered payload after each step, the
    collectives of each step and of each payload by group, the state's
    parts and owned bytes."""
    cfg, st = start_state(d)
    if mesh is not None:
        st = PM.shard_train_state(st, mesh)
        lo, hi = PM.batch_rows(cfg.batch_size, mesh.data_index, mesh.n_data)
    else:
        lo, hi = PM.batch_rows(cfg.batch_size, PD.rank(), PD.world())
    out = {"metrics": [], "payloads": [], "collectives": [],
           "payload_collectives": []}

    def since(before: dict) -> dict:
        return dict(PD.collective_counts("group") - before)

    for _ in range(steps):
        before = PD.collective_counts("group")
        m = TR.train_step(st, rows_of(d, lo, hi), cfg).numpy()
        out["collectives"].append(since(before))
        out["metrics"].append(m)
        before = PD.collective_counts("group")
        out["payloads"].append(TR.checkpoint_payload(st))
        out["payload_collectives"].append(since(before))
    names = [n for n, _ in st.model.named_parameters()]
    out.update(
        sharded=bool(st.layout.split), bytes=TR.owned_state_bytes(st),
        master={n: t.detach().numpy().copy()
                for n, t in zip(names, st.master)},
        ema={n: t.detach().numpy().copy()
             for n, t in zip(names, st.ema_shards)},
        momentum={n: st.opt.state[t]["momentum_buffer"].numpy().copy()
                  for n, t in zip(names, st.master)})
    return out, cfg


def one_process_case(d: dict) -> dict:
    """Process 0 alone, before it joins the group: the global batch."""
    return axis_steps(d, None)[0]


# buckets of 2^18 elements: the n model's shards then take several gathers
# a tree, as the x model's take two at the default 2^24
SMALL_BUCKET_NUMEL = 1 << 18


def mesh_1x2_case(d: dict) -> dict:
    """(data 1, model 2) with small buckets: both processes on the whole
    batch; then the gathered payload written by process 0 and restored
    into a fresh sharded state, whose payload must come back the same."""
    PD.GRAD_BUCKET_NUMEL, default = SMALL_BUCKET_NUMEL, PD.GRAD_BUCKET_NUMEL
    mesh = PM.make_mesh(1, 2)
    out, cfg = axis_steps(d, mesh)
    path = os.path.join(d["run_root"], "axis_last.ckpt")
    if PD.is_main():
        TR.write_checkpoint(path, out["payloads"][-1], {})
    PD.barrier()
    fresh = PM.shard_train_state(TR.create_train_state(cfg, 4, "cpu"), mesh)
    out["restored"] = TR.checkpoint_payload(
        TR.restore_train_state(path, fresh))
    out["mesh"] = (mesh.n_data, mesh.n_model, mesh.data_index,
                   mesh.model_index)
    PD.GRAD_BUCKET_NUMEL = default
    return out


def plain_2_case(d: dict) -> dict:
    """No mesh: the world's data parallelism, one row a process."""
    return axis_steps(d, None, 1)[0]


def mesh_2x1_case(d: dict) -> dict:
    """(data 2, model 1): the mesh degenerates to replication."""
    mesh = PM.make_mesh(2, 1)
    out = axis_steps(d, mesh, 1)[0]
    out["groups"] = (mesh.data_group, mesh.model_group)
    return out


def mesh_2x2_case(d: dict) -> dict:
    """(data 2, model 2): one row a data index, the parameters sharded."""
    mesh = PM.make_mesh(2, 2)
    out = axis_steps(d, mesh, 1)[0]
    out["mesh"] = (mesh.n_data, mesh.n_model, mesh.data_index,
                   mesh.model_index)
    return out


DIST_CASES = {"bn": bn_case, "step": step_case, "val": val_case,
              "fit": fit_case, "detect": detect_case,
              "odd_batch": batch_case, "step_bf16": step_bf16_case,
              "detect_bf16": detect_bf16_case}
AXIS_CASES = {"mesh_1x2": mesh_1x2_case, "plain_2": plain_2_case,
              "mesh_2x1": mesh_2x1_case, "mesh_2x2": mesh_2x2_case}


def main() -> None:
    coordinator, world, rank, inp, outp = sys.argv[1:6]
    names = sys.argv[6].split(",") if len(sys.argv) > 6 else list(DIST_CASES)
    torch.set_num_threads(1)
    with open(inp, "rb") as f:
        d = pickle.load(f)
    res = {}
    if "one_process" in names and int(rank) == 0:
        res["one_process"] = one_process_case(d)
    dev = PD.initialize(coordinator, int(world), int(rank), device="cpu")
    res.update(device=str(dev), rank=PD.rank(), world=PD.world(),
               backend=torch.distributed.get_backend())
    cases = {**DIST_CASES, **AXIS_CASES}
    for name in names:
        if name != "one_process":
            res[name] = cases[name](d)
    PD.shutdown()
    with open(outp, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
