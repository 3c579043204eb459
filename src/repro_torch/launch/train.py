"""End-to-end training driver; port of ``repro.launch.train``.

Runs any registered arch (full or --reduced) with the real substrate:
sharded params/optimizer, microbatching, checkpoint/restart (resumes from
the newest checkpoint automatically — the node-failure recovery path),
periodic-sync local SGD (--sync-every, the paper's eta rule as a training
feature), and the synthetic-but-learnable Markov data pipeline.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --reduced --steps 100 --batch 8 --seq 128 --ckpt /tmp/ck [--device cpu]

``--mesh`` is built over the process group: started as N processes with
``torch.distributed`` set up (``torchrun``'s environment), a mesh of N
devices is a ``DeviceMesh`` and the state is laid out on it by
``sharding.rules`` (DTensors).  A mesh of one device holds every
placement whole, so there the state stays plain tensors on ``--device``.
With ``--sync-every`` and no process group, the replicas of the 'data'
axis run in this process (``core.mesh.make_mesh``, as the port's other
mesh engines do).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.mesh import make_mesh
from repro_torch.models.layers import set_mesh
from repro_torch.models.lm import build_model
from repro_torch.sharding.rules import (P, NamedSharding, batch_shardings,
                                        device_put, mesh_sizes,
                                        train_state_shardings)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import MarkovLM, prefetch
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import (TrainState, make_local_sgd_step,
                                          make_train_step)
from repro_torch.train.tree import tree_leaves, tree_map


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        dist.init_process_group()           # torchrun's environment
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh_from_arg(spec: str, device):
    """--mesh 'data=4,model=2' (or 'single'/'multi' for production): a
    ``DeviceMesh`` when the process group has that many ranks, else the
    port's one-process mesh (``core.mesh.make_mesh``)."""
    if spec in ("single", "multi"):
        from repro_torch.launch.mesh import make_production_mesh
        return make_production_mesh(multi_pod=(spec == "multi"),
                                    device=device)
    axes, sizes = [], []
    for part in spec.split(","):
        if not part:
            continue
        k, v = part.split("=")
        axes.append(k)
        sizes.append(int(v))
    n, world = int(np.prod(sizes)), _world()
    if world > 1:
        if n != world:
            raise SystemExit(f"--mesh {spec} has {n} devices, the process "
                             f"group {world} ranks")
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device.type, tuple(sizes),
                                mesh_dim_names=tuple(axes))
    return make_mesh(tuple(sizes), tuple(axes))


def _on_ranks(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def _rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--sync-every", type=int, default=0,
                    help=">0: eta-style local SGD with this sync period")
    ap.add_argument("--mesh", default="data=1,model=1")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch operations)")
    args = ap.parse_args(argv)
    say = print if _rank0() else (lambda *a, **k: None)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encdec:
        raise SystemExit("use the seq2seq example for enc-dec archs")
    device = resolve_device(args.device)
    mesh = make_mesh_from_arg(args.mesh, device)
    sizes = mesh_sizes(mesh)
    if not _on_ranks(mesh) and int(np.prod(list(sizes.values()))) > 1 \
            and args.sync_every <= 0:
        raise SystemExit(f"--mesh {args.mesh} needs one rank per device "
                         f"(or --sync-every for replicas in one process)")
    model = build_model(cfg, device)
    say(f"arch={cfg.name} reduced={args.reduced} mesh={sizes}")

    opt = AdamW(lr=args.lr, warmup=min(100, args.steps // 10 + 1),
                int8_state=cfg.opt_8bit)
    params = model.init(args.seed)
    n_params = sum(int(p.numel()) for p in tree_leaves(params))
    say(f"params: {n_params/1e6:.2f}M")
    state = TrainState(params=params, opt=opt.init(params))

    # shard the state onto the mesh
    sshard = None
    if _on_ranks(mesh):
        sshard = train_state_shardings(state, mesh, cfg.fsdp, cfg.opt_8bit)
        state = tree_map(device_put, state, sshard)

    start = 0
    if args.ckpt and ckpt.latest_step(args.ckpt) is not None:
        start = ckpt.latest_step(args.ckpt)
        state = ckpt.restore(args.ckpt, state, shardings=sshard)
        say(f"restored checkpoint at step {start} (elastic reshard ok)")

    data = MarkovLM(cfg.vocab, seed=args.seed + 1)
    to_dev = lambda b: {k: torch.from_numpy(v).to(device)  # noqa: E731
                        for k, v in b.items()}

    if args.sync_every > 0:
        outer, replicate = make_local_sgd_step(model, opt, mesh, "data",
                                               sync_every=args.sync_every)
        # the replicas start from the whole state (the reference gathers
        # it to the host first)
        state = replicate(tree_map(
            lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x,
            state))
        R = sizes["data"]
        mine = slice(None) if not _on_ranks(mesh) else slice(
            mesh.get_local_rank("data"), mesh.get_local_rank("data") + 1)
        say(f"local SGD: R={R} replicas, sync every {args.sync_every}")

        def batches():
            while True:
                t = data.sample(R * args.sync_every * args.batch, args.seq)
                t = t.reshape(R, args.sync_every, args.batch, args.seq)[mine]
                yield {"tokens": t, "targets": t, "mask": np.ones_like(t)}

        step_fn = lambda st, b: outer(st, to_dev(b))  # noqa: E731
    else:
        step = make_train_step(model, opt, grad_accum=args.grad_accum)

        def batches():
            while True:
                t = data.sample(args.batch * max(args.grad_accum, 1),
                                args.seq)
                if args.grad_accum > 1:
                    t = t.reshape(args.grad_accum, args.batch, args.seq)
                yield {"tokens": t, "targets": t, "mask": np.ones_like(t)}

        def step_fn(st, b):
            bb = to_dev(b)
            if not _on_ranks(mesh):
                return step(st, bb)
            if args.grad_accum > 1:   # pre-split: the batch on dim 1
                bsh = tree_map(lambda s: NamedSharding(mesh, P(None, *s.spec)),
                               batch_shardings({k: v[0] for k, v in
                                                bb.items()}, mesh))
            else:
                bsh = batch_shardings(bb, mesh)
            with set_mesh(mesh):
                return step(st, tree_map(device_put, bb, bsh))

    t0 = time.time()
    losses = []
    it = prefetch(batches(), depth=2)
    for i in range(start + 1, args.steps + 1):
        state, metrics = step_fn(state, next(it))
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps:
            dt = time.time() - t0
            tok_s = args.log_every * args.batch * args.seq * \
                max(args.grad_accum, 1) / max(dt, 1e-9)
            say(f"step {i:6d} loss {losses[-1]:.4f} "
                f"({tok_s:,.0f} tok/s)")
            t0 = time.time()
        if args.ckpt and (i % args.ckpt_every == 0 or i == args.steps):
            ckpt.save(args.ckpt, i, state, meta={"arch": cfg.name},
                      blocking=False)
    ckpt.wait_pending()
    say(f"final loss {np.mean(losses[-10:]):.4f} "
        f"(start {np.mean(losses[:10]):.4f})")
    return {"arch": cfg.name, "start_step": start, "losses": losses}


if __name__ == "__main__":
    main()
