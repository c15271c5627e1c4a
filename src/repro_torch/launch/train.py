"""Training launcher: the train loop with sharded state, checkpoints and
a failure path (the port of the JAX package's ``launch/train.py``).

  python -m repro_torch.launch.train --arch qwen3-0.6b --seq-len 512 \\
      --batch 8 --steps 4 --ckpt /path/to/ckpt --ckpt-every 2
  python -m repro_torch.launch.train --device cpu --arch qwen3-0.6b \\
      --smoke --steps 6 --ckpt /path/to/ckpt --ckpt-every 3
  python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
      --mesh 2,4 --mesh-devices cpu,cpu,cpu,cpu,cpu,cpu,cpu,cpu

The flags are the JAX launcher's, with its defaults, plus ``--device``
(default ``cuda``; without a card it raises and never falls back to the
CPU), ``--mesh-devices``, ``--accum`` and ``--layers`` (the config's depth
cut to that many layers, its widths kept; default: the config's). ``--mesh D,M`` places the state
on a ``(data, model)`` mesh (``param_shardings``; the train step's
docstring says how it runs there) over ``--mesh-devices``, a comma list in
which entries may repeat (default: the visible devices of ``--device``'s
type); with fewer devices than ``D * M`` it raises. ``--accum`` is the
microbatches a step (default: the config's ``train_accum``, as JAX's step
takes it); a mesh step whose ``D'`` data rows compute (the train step's
``microbatch_rows``) is the one-device step at ``accum * D'`` within
rounding where its products split over ``model`` (every family, where
``model`` divides them), bitwise where they stay whole. Parameters come from ``torch.Generator`` seed 0 on the
device (as ``launch/serve.py --arch`` makes them), data from the stateless
``batch_at(DataConfig(seed=0), step)``. With ``--ckpt`` the state is
restored from the newest checkpoint there (``resumed from step N``) and
saved every ``--ckpt-every`` steps (``checkpointed → path``); a resumed
run is bitwise the uninterrupted one. A checkpoint holds the whole state
whatever the mesh, so a sharded run resumes an unsharded one and the
reverse. It prints ``step k: loss=… gnorm=… (…s)`` every 5th step and at
the last. A step that raises is reported, the newest checkpoint restored,
and the loop goes on with the next step, as JAX's launcher does: the steps
between that checkpoint and the failure are not re-run (its docstring
promises a replay its code does not make).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="", help="e.g. 2,4 → (data,model)")
    ap.add_argument("--mesh-devices", default=None,
                    help="--mesh: comma list of the positions' devices, "
                         "repeats allowed (e.g. cuda:0 eight times, or "
                         "cpu,cpu,...); default: the visible devices of "
                         "--device's type")
    ap.add_argument("--accum", type=int, default=None,
                    help="microbatches a step (default: the config's "
                         "train_accum)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers "
                         "(default: the config's)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    return ap


def main(argv=None, log=print) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    import torch

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.env import resolve_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import validate
    from repro_torch.models.sharding import set_activation_mesh
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import (init_state, make_train_step,
                                                 shard_state)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = validate(dataclasses.replace(cfg, n_layers=args.layers))
    opt = AdamW(lr=args.lr)

    mesh = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        names = ("data", "model")[:len(shape)]
        devices = None
        if args.mesh_devices:
            devices = [resolve_device(d) for d in args.mesh_devices.split(",")]
        mesh = make_mesh(shape, names, devices, device_type=dev.type)
        set_activation_mesh(mesh)
        dev = mesh.device_list()[0]
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch,
                      frontend_len=cfg.frontend_len if cfg.frontend else 0,
                      d_model=cfg.d_model)

    state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0),
                       compress=args.compress_grads)
    start_step = 0
    if args.ckpt:
        restored, step = ckpt_lib.restore(args.ckpt, state)
        if restored is not None:
            state, start_step = restored, step
            log(f"resumed from step {step}")

    if mesh is not None:
        state = shard_state(state, mesh)

    step_fn = make_train_step(cfg, opt, compress=args.compress_grads,
                              accum=args.accum)

    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = batch_at(dcfg, step, device=dev)
        try:
            state, metrics = step_fn(state, batch)
        except Exception as e:  # noqa: BLE001 — node failure path
            log(f"step {step} failed ({e}); restoring last checkpoint")
            restored, rstep = ckpt_lib.restore(args.ckpt, state)
            if restored is None:
                raise
            state = restored
            continue
        if step % 5 == 0 or step == args.steps - 1:
            log(f"step {step}: loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({time.time() - t0:.1f}s)")
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            path = ckpt_lib.save(args.ckpt, step + 1, state)
            log(f"checkpointed → {path}")
    log("done")


if __name__ == "__main__":
    main()
